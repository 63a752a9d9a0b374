"""The lazy arithmetic of the blind-rotation kernels, modelled in numpy.

``csrc/pbs.cu`` cannot run without a card, so this file repeats exactly the
arithmetic its device functions do (Shoup products with the tables of
``kernels.shoup_tables``, forward butterflies whose sums are never reduced,
inverse butterflies that grow by 2p a stage, the products skipped where a
twiddle is 1, the MAC that reduces before the product that would not fit,
the final reductions, the two-prime CRT in uint32 and the three-prime one
with its 64-bit sign decision) on ``uint64`` arrays, asserts that every
intermediate stays inside the range the kernel's comments claim (and so
inside a ``uint32_t``), and holds the results against the plain twins: at
N = 256 to 2048, at every prime of the plans (40961 included: two products
a uint32, sums reduced below p to fit 16 bits), and for the 3 * rows
contraction of a bundled round.  Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from redsec_tpu_torch.crypto import bootstrap as bs
from redsec_tpu_torch.crypto import kernels as K
from redsec_tpu_torch.crypto import ntt as ntt_mod
from redsec_tpu_torch.crypto.params import (
    SMALL, SMALL_V2, SMALL_V2_N2048, SMALL_V2_TPU, SMALL_V2_TPU2, TEST_NOISELESS,
)

U32 = np.uint64(0xFFFFFFFF)
LIMIT = np.uint64(1) << np.uint64(32)


def _plan(N):
    if N == 256:
        return bs.bootstrap_plan(TEST_NOISELESS)
    if N == 1024:
        return bs.bootstrap_plan(SMALL_V2_TPU)
    if N == 2048:
        return bs.bootstrap_plan(SMALL_V2_N2048)  # 12289 and 40961
    return ntt_mod.make_plan(N, 16, 8, 12, True)


def _u64(a):
    return np.asarray(a).astype(np.uint64)


def shoup(x, tw, p):
    """x * w mod p in [0, 2p) for any x < 2^32, as ``shoup`` in pbs.cu:
    three 32-bit products, the difference taken mod 2^32."""
    if x.size == 0:
        return x
    assert x.max() < LIMIT
    w, ws = _u64(tw[..., 0]), _u64(tw[..., 1])
    q = (x * ws) >> np.uint64(32)
    r = ((x * w) & U32) - ((q * np.uint64(p)) & U32) & U32
    assert r.max() < 2 * p
    assert np.array_equal(r % np.uint64(p), x * w % np.uint64(p))
    return r


def reduce_2p(x, p):
    assert x.max() < LIMIT
    m = np.uint64((1 << 32) // p)
    r = (x - (((x * m) >> np.uint64(32)) * np.uint64(p))) & U32
    assert r.max() < 2 * p
    return r


def csub(x, p):
    return np.where(x >= p, x - np.uint64(p), x)


def _product_free(N, h):
    """Twiddle indices of the stage of half-span h that the kernel takes as
    1 without a product: the stages of its last register pass (half-spans
    below N/256), first twiddle only."""
    return 1 if h < N // 256 else 0


def model_ntt_fwd(x, tab, p, half_bg=None):
    """tab = shoup_tables(plan)[pi].  The stages of ``ntt_fwd``: no sum is
    reduced, the difference gets M = B0 * 2^s and, where its twiddle is 1 and
    the kernel skips the product, stays below 2M like the sums.  x is uint64
    [..., N] in [0, p) and the twist a Shoup product (B0 = 2p), or, with
    ``half_bg``, int64 digits in [-half_bg, half_bg) and the twist one
    multiply-add without reduction (B0 = 2 * half_bg * p)."""
    N = x.shape[-1]
    if half_bg is None:
        v, B0 = shoup(x, tab[0], p), 2 * p
    else:
        assert x.min() >= -half_bg and x.max() < half_bg
        B0 = 2 * half_bg * p
        assert B0 * N < 1 << 32, "what make_gadget checks before it sets `small`"
        # as the kernel: the digit's two's complement times w, plus the bias, mod 2^32
        v = ((_u64(x & 0xFFFFFFFF) * _u64(tab[0][:, 0]) & U32) + np.uint64(half_bg * p)) & U32
        assert np.array_equal(v.astype(np.int64), x * tab[0][:, 0].astype(np.int64) + half_bg * p)
    assert v.max() < B0
    lead = v.shape[:-1]
    for s in range(N.bit_length() - 1):
        h = N >> (s + 1)
        M = np.uint64(B0 << s)
        assert v.max() < M, f"a value entering stage {s} must be < B0 * 2^s"
        a = v.reshape(*lead, 1 << s, 2, h)
        lo, hi = a[..., 0, :], a[..., 1, :]
        d = lo + M - hi  # uint64: a negative value would wrap to ~2^64
        assert d.max() < 2 * M and d.min() > 0
        w = tab[1, N - 2 * h:N - h]
        free = _product_free(N, h)
        assert np.all(w[:free, 0] == 1)
        prod = np.concatenate([d[..., :free], shoup(d[..., free:], w[free:], p)], axis=-1)
        v = np.stack([lo + hi, prod], axis=-2).reshape(*lead, N)
    assert v.max() < B0 * N <= 1 << 32
    return csub(reduce_2p(v, p), p)


def _inv_bound(N, p, s):
    """What a value entering inverse stage s stays below: inputs < 2p, a
    stage without a product (twiddle 1, the first log2(N/256) stages' first
    butterfly) doubles the bound, every other stage adds 2p."""
    free = (N // 256).bit_length() - 1
    return 2 * p * (1 << min(s, free)) + 2 * p * max(0, s - free)


def model_ntt_inv(y, tab, p):
    """y uint64 [..., N] below 2p; the stages of ``ntt_inv``."""
    N = y.shape[-1]
    assert y.max() < 2 * p
    v = y
    lead = v.shape[:-1]
    for s in range(N.bit_length() - 1):
        h = 1 << s
        assert v.max() < _inv_bound(N, p, s)
        a = v.reshape(*lead, N >> (s + 1), 2, h)
        lo, hi = a[..., 0, :], a[..., 1, :]
        w = tab[3, h - 1:2 * h - 1]
        free = _product_free(N, h)  # twiddle 1: t = hi as it is, below 2p * 2^s
        assert np.all(w[:free, 0] == 1) and (not free or hi.max() < (2 * p) << s)
        t = np.concatenate([hi[..., :free], shoup(hi[..., free:], w[free:], p)], axis=-1)
        back = np.full(h, 2 * p, np.uint64)
        back[:free] = (2 * p) << s
        assert np.all(lo + back >= t)
        v = np.concatenate([lo + t, lo + back - t], axis=-1).reshape(*lead, N)
    assert v.max() < _inv_bound(N, p, N.bit_length() - 1) <= 32 * p < 1 << 21
    return csub(shoup(v, tab[2], p), p)


def crt2(c0, c1, p0, p1):
    """``crt2`` of pbs.cu: Garner in uint32, the sign from 2v >= p0*p1."""
    inv01 = pow(p0 % p1, p1 - 2, p1)
    assert p0 < p1  # so c0 < p1 as it is
    diff = c1 + np.uint64(p1) - c0  # in (0, 2 p1)
    t1 = csub(shoup(diff, np.array([inv01, (inv01 << 32) // p1], np.uint64), p1), p1)
    v = c0 + t1 * np.uint64(p0)
    P = np.uint64(p0 * p1)
    assert v.max() < P < 1 << 30
    return np.where(2 * v >= P, (v + LIMIT - P) & U32, v)


def crt3(c0, c1, c2, primes):
    """``crt3`` of pbs.cu: Garner's digits below their primes, the value in
    [0, P) with P = p0 p1 p2 ~ 9.3e12, and the sign decided exactly (64
    bits) against P/2."""
    p0, p1, p2 = primes
    inv01 = pow(p0 % p1, p1 - 2, p1)
    t1 = csub(shoup(c1 + np.uint64(p1) - c0, np.array([inv01, (inv01 << 32) // p1], np.uint64),
                    p1), p1)
    v01 = c0 + t1 * np.uint64(p0)
    assert v01.max() < p0 * p1 < 1 << 30
    r = csub(reduce_2p(v01, p2), p2)
    inv012 = pow((p0 * p1) % p2, p2 - 2, p2)
    t2 = csub(shoup(c2 + np.uint64(p2) - r, np.array([inv012, (inv012 << 32) // p2], np.uint64),
                    p2), p2)
    v = v01 + t2 * np.uint64(p0 * p1)
    P = np.uint64(p0 * p1 * p2)
    assert v.max() < P < 1 << 44
    return np.where(2 * v >= P, v + (np.uint64(1) << np.uint64(44)) - P, v) & U32


def model_external_product(digits, bk_round, plan, half_bg=None):
    """``external_product_block`` of pbs.cu: digits int32 [M, R, N], BK round
    slice int16 [P, R, 8, N] (residues as 16-bit patterns) -> torus delta
    int32 [M, 2, N].  R is 2l, or 3 * 2l for a bundled round.  With
    ``half_bg`` the forward transforms are also taken the way the CMUX and
    blind-rotation kernels take gadget digits."""
    M, rows, N = digits.shape
    tabs = K.shoup_tables(plan)
    res = []
    for pi, p in enumerate(plan.primes):
        d = digits.astype(np.int64)
        dn = model_ntt_fwd(_u64(np.where(d < 0, d + p, d)), tabs[pi], p)  # [M, rows, N]
        assert dn.max() < p
        # the round kernels' twist of gadget digits where make_gadget sets
        # `small` (Bg * p * N < 2^32 for every prime): the same residues
        if half_bg is not None and 2 * half_bg * max(plan.primes) * N < 1 << 32:
            assert np.array_equal(dn, model_ntt_fwd(d, tabs[pi], p, half_bg))
        b = _u64(bk_round[pi].astype(np.uint16))  # [rows, 8, N], zero-extended
        assert b.max() < p
        acc = np.zeros((M, 8, N), np.uint64)
        lazy = ((1 << 32) - 2 * p) // (p - 1) ** 2  # products that fit beside a carry < 2p
        assert lazy >= 2
        pending = 0
        for j in range(rows):
            if pending == lazy:  # the next product would not fit
                acc, pending = reduce_2p(acc, p), 0
            pending += 1
            acc = acc + dn[:, j, None, :] * b[j][None]
            assert acc.max() < LIMIT, "the products and the carried value fit a uint32"
        acc = reduce_2p(acc, p)
        if p >= 1 << 15:  # 2p would not fit 16 bits: reduced below p
            acc = csub(acc, p)
        assert acc.max() < 1 << 16  # stored as uint16
        res.append(model_ntt_inv(acc, tabs[pi], p))
    if len(plan.primes) == 2:
        v = crt2(res[0], res[1], *plan.primes).reshape(M, 2, 4, N)
    else:
        v = crt3(res[0], res[1], res[2], plan.primes).reshape(M, 2, 4, N)
    out = sum(v[:, :, limb] << np.uint64(8 * limb) for limb in range(4)) & U32
    return out.astype(np.uint32).view(np.int32)


def _inputs(pattern, shape, p):
    if pattern == "all_p_minus_1":
        return np.full(shape, p - 1, np.int64)
    if pattern == "alternating":
        x = np.zeros(shape, np.int64)
        x[..., ::2] = p - 1
        return x
    return np.random.default_rng(11).integers(0, p, size=shape, dtype=np.int64)


@pytest.mark.parametrize("pattern", ["all_p_minus_1", "alternating", "random"])
@pytest.mark.parametrize("pi", [0, 1])
@pytest.mark.parametrize("N", K.KERNEL_N)
def test_lazy_forward_transform_stays_in_range_and_equals_ntt_device(N, pi, pattern):
    plan = _plan(N)
    p = plan.primes[pi]
    x = _inputs(pattern, (3, N), p)
    got = model_ntt_fwd(_u64(x), K.shoup_tables(plan)[pi], p)
    want = ntt_mod.ntt_device(torch.as_tensor(x.astype(np.int32)), plan, pi).numpy()
    np.testing.assert_array_equal(got.astype(np.int64), want)


@pytest.mark.parametrize("pattern", ["all_p_minus_1", "alternating", "random"])
@pytest.mark.parametrize("pi", [0, 1])
@pytest.mark.parametrize("N", K.KERNEL_N)
def test_lazy_inverse_transform_stays_in_range_and_equals_intt_device(N, pi, pattern):
    plan = _plan(N)
    p = plan.primes[pi]
    y = _inputs(pattern, (3, N), p)
    tab = K.shoup_tables(plan)[pi]
    want = ntt_mod.intt_device(torch.as_tensor(y.astype(np.int32)), plan, pi).numpy()
    np.testing.assert_array_equal(model_ntt_inv(_u64(y), tab, p).astype(np.int64), want)
    # the MAC hands over sums in [0, 2p): the same residues, not yet reduced
    lazy = _u64(y) + np.uint64(p) * _u64(np.arange(N) % 2)
    np.testing.assert_array_equal(model_ntt_inv(lazy, tab, p).astype(np.int64), want)


@pytest.mark.parametrize("P", [TEST_NOISELESS, SMALL_V2_TPU, SMALL_V2, SMALL_V2_N2048, SMALL],
                         ids=lambda P: P.name)
def test_modelled_external_product_equals_plain_twin(P):
    _modelled_equals_twin(P, bundled=False)


# a bundled round: one contraction over 3 * rows (36 rows, two primes; 30
# rows, three primes; 60 rows at (12289, 40961), N = 2048, where the MAC
# reduces every second product at 40961)
@pytest.mark.parametrize("P", [SMALL_V2_TPU, SMALL_V2_TPU2, SMALL_V2_N2048],
                         ids=lambda P: P.name)
def test_modelled_bundled_contraction_equals_plain_twin(P):
    _modelled_equals_twin(P, bundled=True)


def _modelled_equals_twin(P, bundled):
    plan = bs.bootstrap_plan(P, bundled)
    rng = np.random.default_rng(5)
    rows, N = P.decomp_rows * (3 if bundled else 1), P.N
    digits = rng.integers(-P.half_bg, P.half_bg, size=(3, rows, N)).astype(np.int32)
    digits[0] = -P.half_bg  # the largest digits, every coefficient
    digits[1, :, ::2] = P.half_bg - 1
    bk = np.stack([rng.integers(0, p, size=(rows, 8, N)) for p in plan.primes])
    bk[:, 0] = np.asarray(plan.primes)[:, None, None] - 1
    bk = bk.astype(np.uint16).view(np.int16)  # 40961 keeps its 16-bit pattern
    want = K.external_product_plain(torch.as_tensor(digits), torch.as_tensor(bk), plan).numpy()
    np.testing.assert_array_equal(model_external_product(digits, bk, plan, P.half_bg), want)


def test_mac_of_four_largest_products_fits_uint32():
    p = (1 << 15) - 1  # any p < 2^15 takes four products a reduction
    assert 4 * (p - 1) ** 2 + 2 * p - 1 < 1 << 32
    assert 5 * (p - 1) ** 2 + 2 * p - 1 >= 1 << 32  # and not five


def test_bounds_at_40961_and_n2048():
    """What pbs.cu's comments claim for the prime 40961 and N = 2048."""
    p = 40961
    lazy = ((1 << 32) - 2 * p) // (p - 1) ** 2
    assert lazy == 2 and 2 * (p - 1) ** 2 + 2 * p - 1 < 1 << 32  # two products a uint32
    assert 3 * (p - 1) ** 2 >= 1 << 32  # and not three
    assert 2 * p >= 1 << 16 > p  # sums reduced below p to fit 16 bits
    # forward growth of the lazy transform at N = 2048 (11 stages): B0 * N
    assert 2 * p * 2048 < 1 << 32
    # the gadget twist without reduction at small_v2_n2048 (Bg 8), not at small (Bg 1024)
    for P, small in ((SMALL_V2_N2048, True), (SMALL, False)):
        pmax = max(bs.bootstrap_plan(P).primes)
        assert ((P.bg * pmax * P.N) < (1 << 32)) is small
    # the inverse transform's growth at N = 2048: 32p
    assert _inv_bound(2048, p, 11) == 32 * p < 1 << 21
    # the CRT ranges: two primes below 2^30, three below 2^44
    assert 12289 * 40961 < 1 << 30 and 12289 * 18433 * 40961 < 1 << 44
    # every plan's accumulated product stays below P/2: the exact sign
    # decision agrees with the fp32 one of the JAX package
    for P, bundled in ((SMALL_V2_N2048, False), (SMALL, False), (SMALL_V2_TPU, True),
                       (SMALL_V2_TPU2, True), (SMALL_V2, False), (SMALL_V2_N2048, True)):
        plan = bs.bootstrap_plan(P, bundled)
        bound = (3 if bundled else 1) * P.decomp_rows * P.N * P.half_bg * 128
        assert 2 * bound < int(np.prod([int(q) for q in plan.primes], dtype=object))


@pytest.mark.parametrize("inverse", [False, True])
def test_lazy_transforms_at_the_third_prime_of_small(inverse):
    plan = bs.bootstrap_plan(SMALL)
    p = plan.primes[2]
    tab = K.shoup_tables(plan)[2]
    x = _inputs("random", (3, 1024), p)
    x[0] = p - 1
    if inverse:
        got = model_ntt_inv(_u64(x), tab, p)
        want = ntt_mod.intt_device(torch.as_tensor(x.astype(np.int32)), plan, 2).numpy()
    else:
        got = model_ntt_fwd(_u64(x), tab, p)
        want = ntt_mod.ntt_device(torch.as_tensor(x.astype(np.int32)), plan, 2).numpy()
    np.testing.assert_array_equal(got.astype(np.int64), want)


def test_three_prime_crt_equals_the_plain_twin():
    """crt3 against ntt.crt_to_torus32 (the twin's fp32 sign estimate) on
    values across the reachable range, the edges included."""
    plan = bs.bootstrap_plan(SMALL)
    P = int(np.prod([int(q) for q in plan.primes], dtype=object))
    half = (3 * 30 * 1024 * 512 * 128) // 2  # beyond any shipped set's bound
    rng = np.random.default_rng(12)
    v = [int(a) for a in rng.integers(-half, half, size=4096)] + [0, -1, 1, half, -half]
    res = [np.array([a % q for a in v], np.uint64) for q in plan.primes]
    got = crt3(*res, plan.primes).astype(np.uint32).view(np.int32)
    want = ntt_mod.crt_to_torus32([torch.as_tensor(r.astype(np.int32)) for r in res], plan).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.array([((a + 2**31) % 2**32) - 2**31 for a in v],
                                                np.int32))
    assert half < P // 2


@pytest.mark.parametrize("N", K.KERNEL_N)
def test_kernel_tables_layout_follows_the_plan(N):
    plan = _plan(N)
    tabs = K.shoup_tables(plan)
    assert tabs.shape == (len(plan.primes), 4, N, 2) and tabs.dtype == np.uint32
    for pi, p in enumerate(plan.primes):
        w = tabs[pi, :, :, 0].astype(np.int64)
        np.testing.assert_array_equal(w[0], plan.twist[pi])
        np.testing.assert_array_equal(w[2], plan.untwist[pi])
        for s in range(N.bit_length() - 1):
            h = N >> (s + 1)  # forward stage s, half-span h, at offset N - 2h
            np.testing.assert_array_equal(w[1, N - 2 * h:N - h], plan.fwd_tabs[pi][s])
            h = 1 << s  # inverse stage s, half-span h, at offset h - 1
            np.testing.assert_array_equal(w[3, h - 1:2 * h - 1], plan.inv_tabs[pi][s])
        assert w[1, N - 1] == 0 and w[3, N - 1] == 0
        ws = [[(int(v) << 32) // p for v in row] for row in w]
        np.testing.assert_array_equal(tabs[pi, :, :, 1].astype(np.int64), np.asarray(ws))
    dev = K.kernel_tables(plan, torch.device("cpu"))
    assert dev.dtype == torch.int32 and tuple(dev.shape) == tabs.shape
    np.testing.assert_array_equal(dev.numpy().view(np.uint32), tabs)
    assert K.kernel_tables(plan, torch.device("cpu")) is dev  # built once
