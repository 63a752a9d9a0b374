"""The port's programmable bootstrap against the JAX package.

- The whole PBS ``[B, n+1]`` equals JAX ``make_batched_bootstrap`` (its XLA
  path, the plain reference of the Pallas kernels) at ``test_noiseless`` and
  at ``small_v2_tpu`` with real noise, and equals the numpy ``bootstrap_host``.
- The twins of the external-product and CMUX-round kernels equal an int64
  schoolbook of the same digits and raw BK.
- Slow: the twins against the JAX Pallas kernels in interpret mode, each
  side preparing the same raw BK in its own NTT order.

Tolerance everywhere: exact equality of int32 arrays (a PBS is
deterministic).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redsec_tpu.crypto import bootstrap as jbs
from redsec_tpu.crypto import keygen as jkg
from redsec_tpu.crypto import params as jparams
from redsec_tpu_torch.crypto import bootstrap as bs
from redsec_tpu_torch.crypto import keygen as kg
from redsec_tpu_torch.crypto import kernels, lwe
from redsec_tpu_torch.crypto.ntt import negacyclic_mul_host
from redsec_tpu_torch.crypto.params import get_params

torch.set_num_threads(2)


def _setup(name, seed):
    P = get_params(name)
    sk, cloud = kg.keygen(P, seed=seed)
    return P, sk, cloud, bs.prepare_cloud_key(cloud, device="cpu")


def _jax_pbs(name, seed, ct, tv):
    _, jcloud = jkg.keygen(jparams.get_params(name), seed=seed)
    return np.asarray(jbs.make_batched_bootstrap(jbs.prepare_cloud_key(jcloud))(
        jnp.asarray(ct), jnp.asarray(tv)))


@pytest.mark.parametrize("name,B", [("test_noiseless", 6), ("small_v2_tpu", 4)])
def test_pbs_bit_identical_to_jax(name, B, monkeypatch):
    for var in ("REDSEC_BLIND_KERNEL", "REDSEC_ROUND_KERNEL", "REDSEC_NTT"):
        monkeypatch.delenv(var, raising=False)
    P, sk, cloud, dkey = _setup(name, 3)
    rng = np.random.default_rng(1)
    vals = rng.integers(-300, 300, size=B)
    ct = lwe.encrypt_integers(sk.lwe_key, vals, P, rng)
    tv = bs.const_test_vector(P, 1, P.msg_space)
    got = bs.make_batched_bootstrap(dkey)(ct, tv).numpy()
    assert got.shape == (B, P.n + 1) and got.dtype == np.int32
    np.testing.assert_array_equal(got, _jax_pbs(name, 3, ct, tv))
    if name == "test_noiseless":
        np.testing.assert_array_equal(lwe.decrypt_integers(sk.lwe_key, got, P),
                                      np.where(vals >= 0, 1, -1))


def test_pbs_equals_host_oracle_and_chunking_changes_nothing():
    P, sk, cloud, dkey = _setup("test_noiseless", 5)
    rng = np.random.default_rng(2)
    ct = lwe.encrypt_integers(sk.lwe_key, rng.integers(-300, 300, size=5), P, rng)
    tv = bs.function_test_vector(P, lambda v: np.where(v < P.msg_space // 4, v // 2, 0),
                                 P.msg_space)
    got = bs.make_batched_bootstrap(dkey)(ct, tv).numpy()
    np.testing.assert_array_equal(got[0], bs.bootstrap_host(cloud, ct[0], tv))
    np.testing.assert_array_equal(bs.make_chunked_bootstrap(dkey, chunk=2)(ct, tv).numpy(), got)


def _schoolbook_delta(digits, bk_raw_round):
    """sum_rows digits[m, row] x bk_raw[row, u] mod (X^N + 1, 2^32), int64."""
    M, rows, N = digits.shape
    out = np.zeros((M, 2, N), np.int64)
    for m in range(M):
        for r in range(rows):
            for u in range(2):
                out[m, u] += negacyclic_mul_host(digits[m, r], bk_raw_round[r, u], N)
    return out.astype(np.uint64).astype(np.uint32).astype(np.int32)


def test_external_product_twin_equals_schoolbook():
    P, _, cloud, dkey = _setup("test_noiseless", 8)
    rng = np.random.default_rng(4)
    digits = rng.integers(-P.half_bg, P.half_bg, size=(3, P.decomp_rows, P.N)).astype(np.int32)
    got = kernels.external_product(torch.as_tensor(digits), dkey.bk[:, 5], dkey.plan).numpy()
    np.testing.assert_array_equal(got, _schoolbook_delta(digits, cloud.bk[5]))


def test_cmux_round_twin_equals_schoolbook():
    P, _, cloud, dkey = _setup("test_noiseless", 8)
    rng = np.random.default_rng(6)
    M, N = 3, P.N
    acc = rng.integers(-2**31, 2**31, size=(M, 2, N)).astype(np.int32)
    acc[0, 0, :2] = [2**31 - 1, -2**31]
    t = np.array([0, 1, 2 * N - 1], np.int32)
    got = kernels.cmux_round(torch.as_tensor(acc), torch.as_tensor(t), dkey.bk[:, 2],
                             P, dkey.plan).numpy()
    rot = np.stack([jbs._rotate_host(acc[m], int(t[m]), N) for m in range(M)])
    diff = (rot.astype(np.int64) - acc).astype(np.int32)
    digits = np.moveaxis(jbs.gadget_decompose_np(P, diff), -1, 2).reshape(M, P.decomp_rows, N)
    want = (acc.astype(np.int64) + _schoolbook_delta(digits, cloud.bk[2])).astype(np.int32)
    np.testing.assert_array_equal(got, want)


def test_blind_rotate_twin_runs_every_round():
    """The plain blind rotation equals n CMUX rounds applied one by one."""
    P, _, _, dkey = _setup("test_noiseless", 9)
    rng = np.random.default_rng(7)
    acc0 = torch.as_tensor(rng.integers(-2**31, 2**31, size=(2, 2, P.N)).astype(np.int32))
    abar = torch.as_tensor(rng.integers(0, 2 * P.N, size=(2, P.n)).astype(np.int32))
    got = kernels.blind_rotate(acc0, abar, dkey.bk, P, dkey.plan)
    acc = acc0
    for i in range(P.n):
        acc = kernels.cmux_round(acc, abar[:, i].contiguous(), dkey.bk[:, i], P, dkey.plan)
    assert torch.equal(got, acc)


def test_device_path_rejects_what_the_kernels_do_not_take():
    P = get_params("test_noiseless")
    _, cloud = kg.keygen(P, seed=0, bundle=2)
    with pytest.raises(ValueError, match="bundle"):
        bs.prepare_cloud_key(cloud, device="cpu")
    with pytest.raises(ValueError, match="schoolbook"):
        bs.prepare_cloud_key(kg.CloudKey(get_params("medium"), np.zeros((1, 6, 2, 8), np.int32),
                                         np.zeros((1, 1, 1), np.int32)), device="cpu")
    small = bs.bootstrap_plan(get_params("small"))  # three primes
    assert not kernels.supported(get_params("small"), small)
    assert kernels.supported(get_params("small_v2_tpu"), bs.bootstrap_plan(get_params("small_v2_tpu")))
    _, _, _, dkey = _setup("test_noiseless", 0)
    with pytest.raises(ValueError, match="flavour"):
        bs.make_batched_bootstrap(dataclasses.replace(dkey, ntt_flavor="matmul"))


# --------------------------------------------------------------------------- #
# Slow: the JAX Pallas kernels in interpret mode                              #
# --------------------------------------------------------------------------- #


def _jax_matmul_key(name, seed, monkeypatch):
    monkeypatch.setenv("REDSEC_NTT", "matmul")  # the kernels' table order
    _, jcloud = jkg.keygen(jparams.get_params(name), seed=seed)
    jdkey = jbs.prepare_cloud_key(jcloud)
    assert jdkey.ntt_flavor == "matmul"
    return jdkey


def _jax_round_slice(jdkey, i, rows, N):
    return jnp.stack([b[i].astype(jnp.int32).reshape(rows, 8, N) for b in jdkey.bk_ntt])


@pytest.mark.slow
def test_round_twins_equal_jax_pallas_round_kernels(monkeypatch):
    from redsec_tpu.crypto.pallas_round import make_full_round_kernel, make_round_kernel

    name = "small_v2_noiseless"  # N=1024: the kernels' 8x128 four-step split
    P, _, _, dkey = _setup(name, 1)
    jdkey = _jax_matmul_key(name, 1, monkeypatch)
    rows, N, M = P.decomp_rows, P.N, 3
    rng = np.random.default_rng(0)
    digits = rng.integers(-P.half_bg, P.half_bg, size=(M, rows, N)).astype(np.int32)
    acc = rng.integers(-2**31, 2**31, size=(M, 2, N)).astype(np.int32)
    t = rng.integers(0, 2 * N, size=(M,)).astype(np.int32)
    jbk = _jax_round_slice(jdkey, 4, rows, N)
    jP, jplan = jdkey.params, jdkey.plan

    want = np.asarray(make_round_kernel(jP, jplan, tile=4, interpret=True)(jnp.asarray(digits), jbk))
    got = kernels.external_product(torch.as_tensor(digits), dkey.bk[:, 4], dkey.plan).numpy()
    np.testing.assert_array_equal(got, want)

    want = np.asarray(make_full_round_kernel(jP, jplan, tile=4, interpret=True)(
        jnp.asarray(acc), jnp.asarray(t), jbk))
    got = kernels.cmux_round(torch.as_tensor(acc), torch.as_tensor(t), dkey.bk[:, 4], P,
                             dkey.plan).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_pbs_equals_jax_blind_rotate_kernel(monkeypatch):
    name = "test_noiseless"
    P, sk, _, dkey = _setup(name, 7)
    jdkey = _jax_matmul_key(name, 7, monkeypatch)
    monkeypatch.setenv("REDSEC_BLIND_KERNEL", "1")
    monkeypatch.setenv("REDSEC_BLIND_TILE", "4")
    rng = np.random.default_rng(3)
    ct = lwe.encrypt_integers(sk.lwe_key, rng.integers(-300, 300, size=6), P, rng)
    tv = bs.const_test_vector(P, 1, P.msg_space)
    want = np.asarray(jbs.make_batched_bootstrap(jdkey)(jnp.asarray(ct), jnp.asarray(tv)))
    np.testing.assert_array_equal(bs.make_batched_bootstrap(dkey)(ct, tv).numpy(), want)
