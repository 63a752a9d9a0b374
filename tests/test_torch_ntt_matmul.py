"""The four-step NTT (``crypto/ntt_matmul.py``) and the "matmul" key flavour
against the JAX package's ``ntt_matmul`` and its ``REDSEC_NTT=matmul`` PBS
(mirroring tests/test_ntt_matmul.py).  Both packages emit the four-step
[k1, k2] order, so the NTT-domain tensors compare too.  Tolerance: exact
equality (residues mod p, torus values mod 2^32)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redsec_tpu.crypto import bootstrap as jbs
from redsec_tpu.crypto import keygen as jkg
from redsec_tpu.crypto import ntt as jntt
from redsec_tpu.crypto import ntt_matmul as jmm
from redsec_tpu.crypto import params as jparams
from redsec_tpu_torch.crypto import bootstrap as bs
from redsec_tpu_torch.crypto import kernels
from redsec_tpu_torch.crypto import keygen as kg
from redsec_tpu_torch.crypto import lwe
from redsec_tpu_torch.crypto import ntt
from redsec_tpu_torch.crypto import ntt_matmul as mm
from redsec_tpu_torch.crypto.params import TEST_NOISELESS, get_params

torch.set_num_threads(2)


def test_split_rc():
    assert mm._split_rc(1024) == (8, 128)
    assert mm._split_rc(2048) == (16, 128)
    assert mm._split_rc(256) == (2, 128)
    assert mm.supported(1024) and mm.supported(2048) and mm.supported(256)
    for N in (64, 128, 256, 512, 1024, 2048, 4096, 8192):
        assert mm._split_rc(N) == jmm._split_rc(N)
        assert mm.supported(N) == jmm.supported(N)


@pytest.mark.parametrize("N", [256, 1024, 2048])
def test_roundtrip_and_convolution(N):
    """Forward equals the JAX package's (same four-step order), the inverse
    undoes it, and a pointwise product is the negacyclic product of the host
    radix-2 oracle, at each prime of the plan."""
    plan = ntt.make_plan(N, max_operand=4, limb_bits=8, accum=20)
    jplan = jntt.make_plan(N, max_operand=4, limb_bits=8, accum=20)
    assert plan.primes == jplan.primes
    rng = np.random.default_rng(0)
    for pi, p in enumerate(plan.primes):
        t = mm._mm_tables(N, p, int(plan.twist[pi][1]))
        jt = jmm._tables_for(jplan, pi)
        for k in t:
            np.testing.assert_array_equal(t[k], jt[k], err_msg=k)
        x = rng.integers(0, p, size=(3, N)).astype(np.int32)
        y = mm.ntt_device_mm(torch.as_tensor(x), plan, pi)
        np.testing.assert_array_equal(y.numpy(),
                                      np.asarray(jmm.ntt_device_mm(jnp.asarray(x), jplan, pi)))
        np.testing.assert_array_equal(mm.intt_device_mm(y, plan, pi).numpy(), x)
        np.testing.assert_array_equal(
            mm.intt_device_mm(y, plan, pi).numpy(),
            np.asarray(jmm.intt_device_mm(jnp.asarray(y.numpy()), jplan, pi)))

        a = rng.integers(-4, 4, size=N).astype(np.int64)
        b = rng.integers(0, 256, size=N).astype(np.int64)
        want = ntt.intt_host(ntt.ntt_host(a % p, plan, pi) * ntt.ntt_host(b, plan, pi) % p,
                             plan, pi)
        ya = mm.ntt_device_mm(torch.as_tensor((a % p).astype(np.int32)), plan, pi)
        yb = mm.ntt_device_mm(torch.as_tensor(b.astype(np.int32)), plan, pi)
        got = mm.intt_device_mm(ntt._mulmod_device(ya, yb, p), plan, pi)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("N", [1024, 2048])
def test_full_value_range(N):
    """Residues at p - 1 everywhere (every limb product at its largest) and
    the largest and smallest residues mixed stay exact through both
    directions."""
    plan = ntt.make_plan(N, max_operand=4, limb_bits=8, accum=20)
    jplan = jntt.make_plan(N, max_operand=4, limb_bits=8, accum=20)
    rng = np.random.default_rng(1)
    for pi, p in enumerate(plan.primes):
        edge = np.full((2, N), p - 1, dtype=np.int32)
        edge[1] = rng.choice([0, 1, p - 2, p - 1], size=N)
        y = mm.ntt_device_mm(torch.as_tensor(edge), plan, pi)
        np.testing.assert_array_equal(mm.intt_device_mm(y, plan, pi).numpy(), edge)
        np.testing.assert_array_equal(
            y.numpy(), np.asarray(jmm.ntt_device_mm(jnp.asarray(edge), jplan, pi)))


@pytest.fixture(scope="module")
def keys():
    """A noiseless key of each package from seed 13 (n cut to 24 for the
    CPU), the port's prepared both ways, and the JAX package's under
    ``REDSEC_NTT=matmul``."""
    P = dataclasses.replace(TEST_NOISELESS, n=24)
    JP = dataclasses.replace(jparams.TEST_NOISELESS, n=24)
    sk, cloud = kg.keygen(P, seed=13)
    _, jcloud = jkg.keygen(JP, seed=13)
    mk = bs.prepare_cloud_key(cloud, device="cpu", ntt_flavor="matmul")
    rk = bs.prepare_cloud_key(cloud, device="cpu")
    return P, sk, cloud, jcloud, mk, rk


def _jax_matmul(jcloud, ct, tv, monkeypatch):
    monkeypatch.setenv("REDSEC_NTT", "matmul")
    jdkey = jbs.prepare_cloud_key(jcloud)
    assert jdkey.ntt_flavor == "matmul"
    return jdkey, np.asarray(jbs.make_batched_bootstrap(jdkey)(jnp.asarray(ct),
                                                               jnp.asarray(tv)))


def test_matmul_key_and_pbs_equal_jax_and_the_radix2_pbs(keys, monkeypatch):
    """The "matmul" key holds the JAX package's NTT-domain residues (same
    order); its PBS equals JAX's under REDSEC_NTT=matmul and the port's
    radix-2 PBS on the same raw key; the decrypted signs are the inputs'."""
    P, sk, cloud, jcloud, mk, rk = keys
    assert mk.ntt_flavor == "matmul" and rk.ntt_flavor == "radix2"
    R, C = mm._split_rc(P.N)
    assert mk.bk.shape == rk.bk.shape[:-1] + (R, C)
    rng = np.random.default_rng(3)
    vals = rng.integers(-400, 400, size=16)
    ct = lwe.encrypt_integers(sk.lwe_key, vals, P, rng)
    tv = bs.const_test_vector(P, 1, P.msg_space)
    jdkey, want = _jax_matmul(jcloud, ct, tv, monkeypatch)
    jbk = np.stack([np.asarray(b).astype(np.int32) for b in jdkey.bk_ntt])
    np.testing.assert_array_equal(kernels.residues(mk.bk).numpy(), jbk.reshape(mk.bk.shape))

    got = bs.make_batched_bootstrap(mk)(torch.as_tensor(ct), tv).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, bs.make_batched_bootstrap(rk)(torch.as_tensor(ct),
                                                                     tv).numpy())
    np.testing.assert_array_equal(np.sign(lwe.decrypt_integers(sk.lwe_key, got, P)),
                                  np.sign(vals))
    # per-ciphertext test vectors through the chunked PBS
    tvs = np.stack([bs.const_test_vector(P, 1 + i % 3, P.msg_space) for i in range(16)])
    np.testing.assert_array_equal(
        bs.make_chunked_bootstrap(mk, chunk=5)(torch.as_tensor(ct), tvs).numpy(),
        bs.make_chunked_bootstrap(rk, chunk=16)(torch.as_tensor(ct), tvs).numpy())


def test_bundled_matmul_key_equals_jax(monkeypatch):
    P = dataclasses.replace(TEST_NOISELESS, n=8)
    JP = dataclasses.replace(jparams.TEST_NOISELESS, n=8)
    sk, cloud = kg.keygen(P, seed=5, bundle=2)
    _, jcloud = jkg.keygen(JP, seed=5, bundle=2)
    mk = bs.prepare_cloud_key(cloud, device="cpu", ntt_flavor="matmul")
    assert (mk.bundle, mk.ntt_flavor) == (2, "matmul")
    rng = np.random.default_rng(4)
    ct = lwe.encrypt_integers(sk.lwe_key, rng.integers(-400, 400, size=8), P, rng)
    tv = bs.const_test_vector(P, 1, P.msg_space)
    _, want = _jax_matmul(jcloud, ct, tv, monkeypatch)
    np.testing.assert_array_equal(
        bs.make_batched_bootstrap(mk)(torch.as_tensor(ct), tv).numpy(), want)


def test_k4_and_a_radix2_check_raise_on_a_matmul_key(keys):
    P, _, cloud, _, mk, rk = keys
    plan = mk.plan
    acc = torch.zeros((2, 2, P.N), dtype=torch.int32)
    abar = torch.zeros((2, P.n), dtype=torch.int32)
    with pytest.raises(ValueError, match="radix-2"):
        kernels.blind_rotate(acc, abar, mk.bk, P, plan)
    with pytest.raises(ValueError, match="radix-2"):
        kernels.blind_rotate_plain(acc, abar, mk.bk, P, plan)
    with pytest.raises(ValueError, match="'radix2'"):
        bs._check_key(mk, "radix2")
    bs._check_key(rk, "radix2")
    ct = torch.zeros((2, P.n + 1), dtype=torch.int32)
    tv = bs.const_test_vector(P, 1, P.msg_space)
    with pytest.raises(ValueError, match="flavour"):
        bs.make_bootstrap_impl(P, plan, "radix2")(mk, ct, tv)
    with pytest.raises(ValueError, match="flavour"):
        bs.make_bootstrap_impl(P, plan, "matmul")(rk, ct, tv)
    with pytest.raises(ValueError, match="flavour"):  # a mislabelled key
        bs.make_batched_bootstrap(dataclasses.replace(rk, ntt_flavor="matmul"))
    with pytest.raises(ValueError, match="flavour"):
        bs.make_batched_bootstrap(dataclasses.replace(mk, ntt_flavor="radix2"))
    with pytest.raises(ValueError, match="ntt_flavor"):
        bs.prepare_cloud_key(cloud, device="cpu", ntt_flavor="fft")
    with pytest.raises(ValueError, match="schoolbook"):
        bs.prepare_cloud_key(cloud, device="cpu", schoolbook=True, ntt_flavor="matmul")


def test_matmul_key_defaults_to_cuda_and_raises_without_it(keys):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        bs.prepare_cloud_key(keys[2], ntt_flavor="matmul")


def test_matmul_key_at_small_v2_tpu_shape():
    """``small_v2_tpu``'s geometry (N 1024, 12 digit rows, two primes) with n
    cut to 2: the "matmul" PBS equals the radix-2 one on the same raw key."""
    P = dataclasses.replace(get_params("small_v2_tpu"), n=2)
    sk, cloud = kg.keygen(P, seed=2)
    mk = bs.prepare_cloud_key(cloud, device="cpu", ntt_flavor="matmul")
    rk = bs.prepare_cloud_key(cloud, device="cpu")
    rng = np.random.default_rng(5)
    ct = lwe.encrypt_integers(sk.lwe_key, rng.integers(-1500, 1500, size=4), P, rng)
    tv = bs.const_test_vector(P, 1, P.msg_space)
    np.testing.assert_array_equal(
        bs.make_batched_bootstrap(mk)(torch.as_tensor(ct), tv).numpy(),
        bs.make_batched_bootstrap(rk)(torch.as_tensor(ct), tv).numpy())
