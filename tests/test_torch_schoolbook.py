"""The port's schoolbook PBS (the parameter sets without NTT primes) against
the JAX package, mirroring ``tests/test_schoolbook.py``.

- Forced schoolbook at ``test_noiseless`` equals the NTT path, and JAX's
  NTT and forced-schoolbook paths.
- ``medium`` (Bg 2^10: two digit limbs in JAX's int8 convolution) and
  ``medium_v2`` (its key switch past the old 2^24 limit of one fp32
  contraction) at n = 6 equal the JAX package's exact oracle
  ``bootstrap_host`` and decrypt to the signs; ``medium`` equals JAX's
  ``make_batched_bootstrap``.  At ``medium_v2`` JAX's device path is not
  exact: its convolution holds the negated digits [-d | d] as int8, where
  -(-128) wraps to -128 (Bg/2 = 128), so it differs from its own oracle and
  does not decrypt.  The port, with that one wrap emulated, equals it bit
  for bit, which pins the difference to the wrap.
- Every schoolbook set prepares and bootstraps on the CPU at n = 2.
- The chunked PBS equals the batched one; ``int32_matmul`` is exact at any
  K; the kernel's twin equals the int64 schoolbook at N = 4096.

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
from redsec_tpu.crypto import lwe as jlwe
from redsec_tpu.crypto import params as jparams
from redsec_tpu_torch.crypto import bootstrap as bs
from redsec_tpu_torch.crypto import keygen as kg
from redsec_tpu_torch.crypto import kernels, lwe
from redsec_tpu_torch.crypto.ntt import negacyclic_mul_host
from redsec_tpu_torch.crypto.params import MEDIUM, TEST_NOISELESS, get_params
from redsec_tpu_torch.device import int32_matmul

torch.set_num_threads(2)


def _noiseless(P, n):
    return dataclasses.replace(P, name=f"{P.name}_tiny", n=n, alpha_ks=0.0, alpha_bk=0.0,
                               alpha_enc=0.0)


def _jax_pbs(P, seed, ct, tv, chunk=None):
    """JAX's PBS on its own keygen of ``P`` (the same key bytes for a seed):
    its device key, the output, and its cloud key."""
    _, jcloud = jkg.keygen(jparams.TfheParams(**dataclasses.asdict(P)), seed=seed)
    jkey = jbs.prepare_cloud_key(jcloud)
    fn = jbs.make_batched_bootstrap(jkey) if chunk is None else \
        jbs.make_chunked_bootstrap(jkey, chunk=chunk)
    return jkey, np.asarray(fn(jnp.asarray(ct), jnp.asarray(tv))), jcloud


def _with_int8_wrap(product):
    """``product`` as JAX's int8 convolution computes it when Bg/2 = 128: a
    digit -128 enters the wrapped (negated) half of [-d | d] as -128, not
    128.  The difference is c = -256 at those digits, in the products that
    wrap: delta[k] += sum_{j + s = k + N} c[j] bk[s]."""
    def wrapped(digits, bk_round, half_bg):
        out = product(digits, bk_round, half_bg).numpy().astype(np.int64)
        d, bk = digits.numpy(), bk_round.numpy().astype(np.int64)
        N = d.shape[-1]
        c = np.where(d == -128, -256, 0)
        for b, r in zip(*np.nonzero(c.any(axis=-1))):
            for u in range(2):
                out[b, u, :N - 1] += np.convolve(c[b, r], bk[r, u])[N:]
        return torch.as_tensor(out.astype(np.uint64).astype(np.uint32).astype(np.int32))
    return wrapped


def _bk_of_spectra(spectra_round):
    """The raw round int32 [rows, 2, N] that a round's key spectra
    [rows, 2, 2, N / 2] encode: each half's inverse twisted transform,
    rounded, recombined lo + 2^16 hi mod 2^32."""
    M = spectra_round.shape[-1]
    twist = kernels.fft_tables(2 * M, spectra_round.device)[1]
    z = torch.fft.ifft(spectra_round) * twist.conj()
    h = torch.round(torch.cat([z.real, z.imag], dim=-1)).to(torch.int64)
    b = h[:, :, 0] + (h[:, :, 1] << 16)
    return (((b + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def _spectra_product_with_int8_wrap():
    """``kernels.schoolbook_fft_product_plain``, the product of every
    schoolbook round on a CPU tensor, with JAX's int8 wrap emulated
    (``_with_int8_wrap`` on the raw round that its spectra encode)."""
    plain = kernels.schoolbook_fft_product_plain

    def wrapped(digits, spectra_round, half_bg):
        return _with_int8_wrap(lambda d, _bk, h: plain(d, spectra_round, h))(
            digits, _bk_of_spectra(spectra_round), half_bg)
    return wrapped


def _encrypt_signs(sk, P, seed, size):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-300, 300, size=(size,))
    vals[vals == 0] = 1
    return vals, lwe.encrypt_integers(sk.lwe_key, vals, P, rng)


def test_schoolbook_matches_ntt_path(monkeypatch):
    """Forcing the schoolbook path on an NTT-capable set is bit-identical to
    the NTT path, in the port and in JAX (both are exact mod 2^32)."""
    P = TEST_NOISELESS
    sk, cloud = kg.keygen(P, seed=11)
    _, ct = _encrypt_signs(sk, P, 5, 5)
    tv = bs.const_test_vector(P, 1, P.msg_space)

    dkey = bs.prepare_cloud_key(cloud, device="cpu")
    assert dkey.plan is not None and dkey.ntt_flavor == "radix2"
    want = bs.make_batched_bootstrap(dkey)(ct, tv).numpy()
    dkey_sb = bs.prepare_cloud_key(cloud, device="cpu", schoolbook=True)
    assert (dkey_sb.plan, dkey_sb.ntt_flavor) == (None, "schoolbook")
    assert tuple(dkey_sb.bk.shape) == (P.n, P.decomp_rows, 2, P.N)
    got = bs.make_batched_bootstrap(dkey_sb)(ct, tv).numpy()
    np.testing.assert_array_equal(got, want)

    monkeypatch.delenv("REDSEC_FORCE_SCHOOLBOOK", raising=False)
    jkey, jwant, _ = _jax_pbs(P, 11, ct, tv)
    assert jkey.plan is not None
    np.testing.assert_array_equal(got, jwant)
    monkeypatch.setenv("REDSEC_FORCE_SCHOOLBOOK", "1")
    jkey, jgot, _ = _jax_pbs(P, 11, ct, tv)
    assert jkey.plan is None
    np.testing.assert_array_equal(got, jgot)


@pytest.mark.parametrize("name", ["medium", "medium_v2"])
def test_medium_geometry_bootstrap_vs_jax_and_host_oracle(name, monkeypatch):
    """The schoolbook PBS at the medium sets' geometry (N = 4096; medium:
    Bg 2^10, l 3; medium_v2: Bg 2^8, l 4 and a 2 x 16 key switch whose
    contraction, 65,536 x 3 x 128, is past 2^24) on a reduced round count,
    against the JAX package's int64 host oracle and its device path (at
    medium_v2 with its int8 wrap emulated, see the module's note)."""
    monkeypatch.delenv("REDSEC_FORCE_SCHOOLBOOK", raising=False)
    P = _noiseless(get_params(name), 6)
    sk, cloud = kg.keygen(P, seed=3)
    dkey = bs.prepare_cloud_key(cloud, device="cpu")
    assert dkey.plan is None and dkey.ntt_flavor == "schoolbook"
    if name == "medium_v2":
        assert P.N * P.ks_t * (P.ks_base - 1) * 128 >= 1 << 24

    rng = np.random.default_rng(9)
    vals = np.array([37, -1200])
    ct = np.stack([lwe.encrypt_integers(sk.lwe_key, np.array([v]), P, rng)[0] for v in vals])
    tv = bs.const_test_vector(P, 1, P.msg_space)

    got = bs.make_batched_bootstrap(dkey)(ct, tv).numpy()
    jkey, want, jcloud = _jax_pbs(P, 3, ct, tv)
    assert jkey.plan is None
    np.testing.assert_array_equal(got[1], jbs.bootstrap_host(jcloud, ct[1], tv))
    np.testing.assert_array_equal(lwe.decrypt_integers(sk.lwe_key, got, P),
                                  np.where(vals >= 0, 1, -1))
    if name == "medium":
        np.testing.assert_array_equal(got, want)
    else:
        assert torch.equal(_bk_of_spectra(dkey.spectra[2]), dkey.bk[2])
        monkeypatch.setattr(kernels, "schoolbook_fft_product_plain",
                            _spectra_product_with_int8_wrap())
        np.testing.assert_array_equal(bs.make_batched_bootstrap(dkey)(ct, tv).numpy(), want)


@pytest.mark.parametrize("name", ["medium", "large", "medium_v2", "large_v2"])
def test_every_schoolbook_set_prepares_and_bootstraps(name):
    """No NTT plan at any of the four sets; the key prepares (raw BK, flavour
    "schoolbook") and the PBS decrypts to the signs, at n = 2."""
    P = _noiseless(get_params(name), 2)
    assert bs.bootstrap_plan(get_params(name)) is None
    sk, cloud = kg.keygen(P, seed=1)
    dkey = bs.prepare_cloud_key(cloud, device="cpu", chunk=1)
    assert (dkey.plan, dkey.ntt_flavor, dkey.bundle) == (None, "schoolbook", 1)
    assert dkey.bk.dtype == torch.int32 and torch.equal(dkey.bk, torch.as_tensor(cloud.bk))
    assert dkey.ksk_limbs.dtype == torch.int8
    assert tuple(dkey.ksk_limbs.shape) == ((P.n + 8) // 8, P.N // 16 * ((P.ks_t + 1) // 2), 1024)
    vals, ct = _encrypt_signs(sk, P, 2, 3)
    out = bs.make_batched_bootstrap(dkey)(ct, bs.const_test_vector(P, 1, P.msg_space))
    np.testing.assert_array_equal(lwe.decrypt_integers(sk.lwe_key, out.numpy(), P),
                                  np.where(vals >= 0, 1, -1))


def test_medium_keygen_roundtrip():
    """Full-size medium LWE keys: the LWE layer round-trips, and the port
    draws the same key and ciphertexts as JAX from the same seed."""
    P = MEDIUM
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    key, jkey = lwe.lwe_key_gen(rng, P.n), jlwe.lwe_key_gen(jrng, P.n)
    np.testing.assert_array_equal(key, jkey)
    vals = rng.integers(-2000, 2000, size=(32,))
    np.testing.assert_array_equal(vals, jrng.integers(-2000, 2000, size=(32,)))
    ct = lwe.encrypt_integers(key, vals, P, rng)
    np.testing.assert_array_equal(ct, jlwe.encrypt_integers(jkey, vals, jparams.MEDIUM, jrng))
    np.testing.assert_array_equal(lwe.decrypt_integers(key, ct, P), vals)


def test_schoolbook_chunked_matches_batched(monkeypatch):
    """The chunked PBS (the forward's path) over the schoolbook product
    equals the batched one, and JAX's chunked one."""
    P = TEST_NOISELESS
    sk, cloud = kg.keygen(P, seed=13)
    dkey = bs.prepare_cloud_key(cloud, device="cpu", schoolbook=True)
    _, ct = _encrypt_signs(sk, P, 8, 7)
    tv = bs.const_test_vector(P, 1, P.msg_space)
    want = bs.make_batched_bootstrap(dkey)(ct, tv).numpy()
    got = bs.make_chunked_bootstrap(dkey, chunk=3)(ct, tv).numpy()
    np.testing.assert_array_equal(got, want)
    monkeypatch.setenv("REDSEC_FORCE_SCHOOLBOOK", "1")
    _, jgot, _ = _jax_pbs(P, 13, ct, tv, chunk=3)
    np.testing.assert_array_equal(got, jgot)


@pytest.mark.parametrize("K", [65536, 131072])
def test_int32_matmul_is_exact_past_one_fp32_contraction(K):
    """K x 128 x w_max >= 2^24 (K as large as medium_v2's and large_v2's
    key-switching keys have rows): exact mod 2^32 against numpy int64."""
    rng = np.random.default_rng(K)
    x = rng.integers(-2**31, 2**31, size=(3, K), dtype=np.int64).astype(np.int32)
    x[:, :8] = -2**31
    w = rng.integers(0, 4, size=(K, 2)).astype(np.int32)
    w[:8] = 3
    assert K * 128 * 3 >= 1 << 24
    got = int32_matmul(torch.as_tensor(x), torch.as_tensor(w), 3).numpy()
    want = (x.astype(np.int64) @ w.astype(np.int64)).astype(np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(got, want.astype(np.int32))


def test_schoolbook_twin_equals_int64_schoolbook_at_n4096():
    """The kernel's twin (float64 FFT, key in 16-bit halves) against the
    int64 schoolbook product, at N = 4096 with the widest digits of the sets
    (medium's Bg 2^10) and key words at both ends of int32; on a CPU tensor
    the wrapper is the twin."""
    N, rows = 4096, 3
    rng = np.random.default_rng(4)
    digits = rng.integers(-512, 512, size=(2, rows, N)).astype(np.int32)
    digits[0, 0, :4] = -512
    bk = rng.integers(-2**31, 2**31, size=(rows, 2, N), dtype=np.int64).astype(np.int32)
    bk[0, 0, :4] = [-2**31, 2**31 - 1, -2**31, -1]
    got = kernels.schoolbook_product(torch.as_tensor(digits), torch.as_tensor(bk), 512).numpy()
    assert got.shape == (2, 2, N) and got.dtype == np.int32
    for b, u in ((0, 0), (1, 1)):
        want = sum(negacyclic_mul_host(digits[b, r], bk[r, u], N).astype(np.int64)
                   for r in range(rows))
        np.testing.assert_array_equal(got[b, u], want.astype(np.uint64).astype(np.uint32)
                                      .astype(np.int32))
    with pytest.raises(ValueError, match="round wrongly"):  # digits past the exact range
        kernels.schoolbook_product_plain(torch.full((1, 8, 8192), 2**20, dtype=torch.int32),
                                         torch.as_tensor(np.resize(bk, (8, 2, 8192))), 2**21)
