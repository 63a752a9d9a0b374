"""The PBS key switch's key and twin against the JAX package.

- ``bootstrap.prepare_ksk``'s int8 limbs, in the key switch kernel's tiled
  order, recombine to the int32 key-switching key word for word, and
  ``kernels.ksk_limbs_plain`` undoes the tiling.
- ``kernels.key_switch_plain`` (the kernel's twin; on a CPU tensor the
  wrapper is the twin) equals the JAX package's ``RoundOps.key_switch`` on
  its ``ksk_limbs`` and the formula the port ran before (digits and
  ``device.int32_matmul`` over the int32 key), bit for bit.

Shapes: the ``small_v2_tpu`` key (9,216 x 351, base 8), and keys with
``medium_v2``'s base 4 and t 16 and ``small``'s base 2 and t 18 cut to fewer
coefficients and columns (ragged column groups, an even and an odd t).  Key
words include INT32_MIN, INT32_MAX and words whose limbs sit at -128 and
127; mask words include ones whose every digit is base - 1.

Tolerance: exact equality (integer arithmetic mod 2^32).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redsec_tpu.crypto import bootstrap as jbs
from redsec_tpu.crypto import params as jparams
from redsec_tpu_torch.crypto import bootstrap as bs
from redsec_tpu_torch.crypto import kernels
from redsec_tpu_torch.crypto.params import get_params
from redsec_tpu_torch.device import int32_matmul

torch.set_num_threads(2)

# (set, N, n): the full small_v2_tpu key, and cut keys of the other digit plans
SHAPES = [("small_v2_tpu", None, None), ("medium_v2", 256, 76), ("small", 64, 20)]
IDS = ["small_v2_tpu", "medium_v2-cut", "small-cut"]
# words at the ends of int32, and with limbs at -128 and 127
EXTREMES = [-2**31, 2**31 - 1, -1, 0, 1, 0x7F7F7F7F, 0x80808080 - 2**32, 0x7F807F80,
            0x00800080, -0x00800080]


def _params(name, N, n):
    P, JP = get_params(name), jparams.get_params(name)
    if N is None:
        return P, JP
    return dataclasses.replace(P, N=N, n=n), dataclasses.replace(JP, N=N, n=n)


def _key(P, seed):
    rng = np.random.default_rng(seed)
    ksk = rng.integers(-2**31, 2**31, size=(P.N, P.ks_t, P.n + 1), dtype=np.int64)
    ksk.reshape(-1)[:len(EXTREMES)] = EXTREMES
    ksk[-1, -1, -len(EXTREMES):] = EXTREMES  # the last rows' and columns' corner
    return ksk.astype(np.int32)


def _inputs(P, B, seed):
    """Mask words (the first row: every digit base - 1, then the extremes),
    and b_n."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-2**31, 2**31, size=(B, P.N), dtype=np.int64)
    kbits = P.ks_basebit * P.ks_t
    prec = (1 << (31 - kbits)) if kbits < 32 else 0
    a[0] = (2**32 - 1 - prec) % 2**32  # u = a + prec: all ones
    a[-1, :len(EXTREMES)] = EXTREMES
    a = (a % 2**32).astype(np.uint32).view(np.int32)
    b = rng.integers(-2**31, 2**31, size=B, dtype=np.int64).astype(np.int32)
    b[0] = -2**31
    return a, b


@pytest.mark.parametrize("name,N,n", SHAPES, ids=IDS)
def test_prepared_limbs_recombine_to_the_key(name, N, n):
    P, _ = _params(name, N, n)
    ksk = _key(P, 1)
    tiles = bs.prepare_ksk(ksk, P, torch.device("cpu"))  # the full key: three slabs
    assert tiles.dtype == torch.int8 and tuple(tiles.shape) == kernels.ksk_shape(P.N, P)
    limbs = kernels.ksk_limbs_plain(tiles, P.N, P.ks_t, P.n + 1).to(torch.int64)
    assert int(limbs.min()) >= -128 and int(limbs.max()) <= 127
    words = kernels._wrap_int32(sum(limbs[i] << (8 * i) for i in range(4)))
    np.testing.assert_array_equal(words.numpy(), ksk.reshape(-1, P.n + 1))
    # the tiling is a permutation: the tiles are the limbs and zeros, and the
    # limbs tile back to the same bytes
    assert torch.equal(kernels.ksk_tiles(limbs.to(torch.int8), P.ks_t), tiles)
    nonzero = int((tiles != 0).sum())
    assert nonzero == int((limbs != 0).sum())


@pytest.mark.parametrize("name,N,n", SHAPES, ids=IDS)
def test_twin_equals_jax_and_the_int32_matmul_formula(name, N, n):
    P, JP = _params(name, N, n)
    ksk = _key(P, 2)
    tiles = bs.prepare_ksk(ksk, P, torch.device("cpu"))
    a, b = _inputs(P, 5, 3)
    got = bs.RoundOps(P).key_switch(torch.as_tensor(a), torch.as_tensor(b), tiles).numpy()
    np.testing.assert_array_equal(
        got, kernels.key_switch_plain(torch.as_tensor(a), torch.as_tensor(b), tiles, P).numpy())
    jlimbs = jnp.asarray(jbs._int8_limbs_np(ksk.reshape(-1, P.n + 1)))
    want = np.asarray(jbs.RoundOps(JP).key_switch(jnp.asarray(a), jnp.asarray(b), jlimbs))
    np.testing.assert_array_equal(got, want)
    # the port's earlier formula: digits, then int32_matmul over the int32 key
    dig = bs.RoundOps(P).ks_digits(torch.as_tensor(a))
    assert int(dig[0].min()) == int(dig[0].max()) == P.ks_base - 1
    old = -int32_matmul(torch.as_tensor(ksk.reshape(-1, P.n + 1)).T, dig.T, P.ks_base - 1).T
    old[:, P.n] += torch.as_tensor(b)
    np.testing.assert_array_equal(got, old.numpy())


def test_twin_takes_a_block_of_coefficients():
    """A poly-sharded rank's block of coefficients against its block of the
    key's k-steps: the blocks' sums add up to the whole key switch."""
    P, _ = _params("medium_v2", 256, 20)
    ksk = _key(P, 4)
    tiles = bs.prepare_ksk(ksk, P, torch.device("cpu"))
    a, b = (torch.as_tensor(x) for x in _inputs(P, 3, 5))
    steps = tiles.shape[1] // 2
    parts = [kernels.key_switch(a[:, h * 128:(h + 1) * 128].contiguous(), torch.zeros_like(b),
                                tiles[:, h * steps:(h + 1) * steps].contiguous(), P)
             for h in range(2)]
    whole = parts[0].to(torch.int64) + parts[1]
    whole[:, P.n] += b
    assert torch.equal(kernels._wrap_int32(whole), kernels.key_switch(a, b, tiles, P))


@pytest.mark.parametrize("B,N,mt,groups,splits", [
    (512, 4096, 4, 2, 2), (196, 4096, 2, 4, 4), (512, 1024, 4, 2, 6), (196, 1024, 2, 4, 11),
    (1, 4096, 2, 4, 4), (513, 1024, 4, 2, 3)])
def test_layout_fills_the_card(B, N, mt, groups, splits):
    """The layout rule at the cells' shapes (medium_v2: 385 column groups;
    small_v2_tpu: 44) on 132 SMs: one tile of 512 (or 256) rows, the split
    with the fewest wasted waves."""
    P = get_params("medium_v2" if N == 4096 else "small_v2_tpu")
    lay = kernels.key_switch_layout(B, N, P, 132)
    assert (lay["mt"], lay["groups"], lay["splits"]) == (mt, groups, splits)
    tiles = -(-kernels.ksk_shape(N, P)[0] // groups)
    assert lay["grid"] == (tiles, splits, -(-B // lay["rows"]))
    assert lay["chunks_per_split"] * splits >= N // 16 > lay["chunks_per_split"] * (splits - 1)


def test_key_switch_rejects_what_the_kernel_does_not_take():
    P = dataclasses.replace(get_params("small_v2_tpu"), N=64, n=20)
    tiles = bs.prepare_ksk(_key(P, 6), P, torch.device("cpu"))
    a, b = (torch.as_tensor(x) for x in _inputs(P, 2, 7))
    with pytest.raises(ValueError, match="multiple of 16"):
        kernels.key_switch(a[:, :40].contiguous(), b, tiles, P)
    wide = dataclasses.replace(P, ks_basebit=8, ks_t=4)
    with pytest.raises(ValueError, match="do not fit"):
        kernels.key_switch_plain(a, b, tiles, wide)
    deep = dataclasses.replace(P, N=2**19, ks_basebit=3, ks_t=9)  # 2^19 x 9 x 7 x 128
    with pytest.raises(ValueError, match="2\\^31"):
        kernels.key_switch_layout(512, deep.N, deep, 132)
