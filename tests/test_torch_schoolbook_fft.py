"""The schoolbook round on the key's spectra (``csrc/schoolbook_fft.cu``'s
arithmetic, in torch) against the exact products and against the JAX
package.

- The product twin on prepared spectra (``kernels.schoolbook_fft_product_plain``)
  equals the int64 schoolbook product and S1's twin
  (``schoolbook_product_plain``), with digits at their worst-case norm.
- The round twin (``schoolbook_round_plain``) equals one round of S1's
  formulation: rotate, difference, decompose around S1's twin, and the add;
  written into ``out``, ``acc`` itself included.
- The a-priori rounding bound is below 1/2 at every schoolbook set and the
  forced ``small_v2_tpu``, and key preparation raises where it is not.
- The PBS at n = 6, whose every round is one call of
  ``kernels.schoolbook_round`` on the key's spectra (the twin, on the CPU),
  equals the loop of S1's formulation on the raw BK, JAX's ``bootstrap_host``,
  and JAX's schoolbook PBS: at ``medium`` as it is, at ``medium_v2`` with
  JAX's int8 wrap emulated.
- A schoolbook key without spectra raises.

Tolerance everywhere: exact equality of int32 arrays (a PBS is
deterministic); the bounds are computed, not measured.
"""

import dataclasses
import fractions
import math

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
from redsec_tpu_torch.crypto.params import get_params
from test_torch_schoolbook import _noiseless, _spectra_product_with_int8_wrap

torch.set_num_threads(2)


def _int64_product(digits, bk):
    """sum_r digits[r] * bk[r, u] negacyclic in int64, mod 2^32: [2, N]."""
    N = digits.shape[-1]
    out = np.zeros((2, N), dtype=np.int64)
    for r in range(digits.shape[0]):
        for u in range(2):
            c = np.convolve(digits[r].astype(np.int64), bk[r, u].astype(np.int64))
            out[u] += c[:N]
            out[u, :N - 1] -= c[N:]
    return out.astype(np.uint64).astype(np.uint32).astype(np.int32)


@pytest.mark.parametrize("N,rows,half", [(4096, 8, 128), (8192, 6, 512)])
def test_fft_twin_equals_int64_schoolbook_and_s1_twin(N, rows, half):
    rng = np.random.default_rng(N + rows)
    B = 3
    digits = rng.integers(-half, half, size=(B, rows, N)).astype(np.int32)
    digits[0] = -half  # the worst-case norm, half sqrt(N) a row
    digits[1, 0, :8] = half - 1
    bk = rng.integers(-2**31, 2**31, size=(rows, 2, N), dtype=np.int64).astype(np.int32)
    bk[0, 0, :4] = [-2**31, 2**31 - 1, -1, 0]
    spectra = kernels.key_spectra(torch.as_tensor(bk))
    assert spectra.shape == (rows, 2, 2, N // 2) and spectra.dtype == torch.complex128
    got = kernels.schoolbook_fft_product_plain(torch.as_tensor(digits), spectra, half).numpy()
    assert got.shape == (B, 2, N) and got.dtype == np.int32
    np.testing.assert_array_equal(
        got, kernels.schoolbook_product_plain(torch.as_tensor(digits), torch.as_tensor(bk),
                                              half).numpy())
    for b in (0, 2):
        np.testing.assert_array_equal(got[b], _int64_product(digits[b], bk))
    with pytest.raises(ValueError, match="outside"):
        kernels.schoolbook_fft_product_plain(torch.as_tensor(digits), spectra, half // 2)


@pytest.mark.parametrize("name", ["medium_v2", "large", "small_v2_tpu"])
def test_round_twin_equals_one_round_of_the_loop(name):
    """acc + S1's twin on decompose(X^t acc - acc), with t at 0, N and the
    ends of [0, 2N); into a new tensor, into ``out`` and into ``acc``."""
    P = get_params(name)
    N = P.N
    rng = np.random.default_rng(5)
    acc = torch.as_tensor(rng.integers(-2**31, 2**31, size=(4, 2, N), dtype=np.int64)
                          .astype(np.int32))
    t = torch.as_tensor(np.array([0, N, 2 * N - 1, 37], dtype=np.int32))
    bk = torch.as_tensor(rng.integers(-2**31, 2**31, size=(P.decomp_rows, 2, N), dtype=np.int64)
                         .astype(np.int32))
    ops = bs.RoundOps(P)
    want = acc + kernels.schoolbook_product_plain(ops.decompose(ops.rotate(acc, t) - acc), bk,
                                                  P.half_bg)
    spectra = kernels.key_spectra(bk)
    got = kernels.schoolbook_round(acc, t, spectra, P)  # a CPU tensor: the twin
    assert torch.equal(got, want)
    out = torch.empty_like(acc)
    assert kernels.schoolbook_round_plain(acc, t, spectra, P, out=out) is out
    assert torch.equal(out, want)
    assert torch.equal(kernels.schoolbook_round(acc, t, spectra, P, out=acc), want)
    assert torch.equal(acc, want)


@pytest.mark.parametrize("name", ["medium", "large", "medium_v2", "large_v2", "small_v2_tpu"])
def test_a_priori_bound_is_below_half(name):
    """At the worst-case digits and the largest halves any key can have
    (2^15 sqrt(N) a row), the bound is below 1/2 at every schoolbook set and
    at forced small_v2_tpu (the values the round kernel's docstring
    records); a prepared key (n 2) gives no more than that."""
    P = get_params(name)
    worst = kernels.schoolbook_fft_error_bound(P.N, P.decomp_rows, P.half_bg,
                                               P.decomp_rows * 2**15 * math.sqrt(P.N))
    recorded = {"medium": 0.01212, "large": 0.02622, "medium_v2": 0.00407,
                "large_v2": 0.008803, "small_v2_tpu": 0.0001626}[name]
    assert worst < 0.5 and abs(worst - recorded) < 1e-3 * recorded + 1e-7
    assert kernels.fft_twiddle_error(P.N) < 2**-53
    bk = torch.as_tensor(np.random.default_rng(1).integers(
        -2**31, 2**31, size=(2, P.decomp_rows, 2, P.N), dtype=np.int64).astype(np.int32))
    assert 0.5 * worst < kernels.schoolbook_key_bound(bk, P) <= worst


def test_key_preparation_raises_where_the_bound_is_not_below_half():
    """Digits of 24 bits (Bg/2 = 2^23, one level) at N = 1024: the bound is
    far above 1/2, and a forced-schoolbook key refuses to prepare."""
    P = dataclasses.replace(get_params("small_v2_tpu"), name="wide_digits", n=2, bg_bit=24, l=1)
    _, cloud = kg.keygen(P, seed=0)
    with pytest.raises(ValueError, match="round wrongly"):
        bs.prepare_cloud_key(cloud, device="cpu", schoolbook=True)


def test_s1_twin_bound_counts_every_rounding():
    """S1's twin's bound (``_fft_error_bound``) keeps its (1 + 2^-53)^3k
    factor: against the same product of powers in exact rationals."""
    N, rows = 8192, 8
    digits = torch.full((1, rows, N), -512, dtype=torch.int32)
    halves = torch.full((rows, 2, 2, N), 2.0**15, dtype=torch.float64)
    got = kernels._fft_error_bound(digits, halves)
    k = (2 * N).bit_length() - 1
    e = fractions.Fraction(1, 2**53)
    s5 = fractions.Fraction(5 ** 0.5) * (1 + fractions.Fraction(1, 2**50))  # above sqrt(5)
    factor = (1 + e) ** (3 * k) * (1 + s5 * e) ** (3 * k + 1) * (1 + 4 * e) ** (3 * k) - 1
    norms = rows * 512 * math.sqrt(N) * 2.0**15 * math.sqrt(N)
    assert abs(got / (2 * norms * float(factor)) - 1) < 1e-9
    without = (1 + s5 * e) ** (3 * k + 1) * (1 + 4 * e) ** (3 * k) - 1
    assert float(factor) > 1.1 * float(without)


@pytest.mark.parametrize("name", ["medium", "medium_v2"])
def test_pbs_on_the_key_spectra_vs_jax(name, monkeypatch):
    """The PBS at n = 6 takes round i as one call of
    ``kernels.schoolbook_round`` on ``dkey.spectra[i]``; bit-identical to
    the loop of S1's formulation (acc + ``schoolbook_product`` of the
    round's digits on the raw ``bk[i]``), to JAX's ``bootstrap_host``, and
    to JAX's schoolbook PBS (at medium_v2 with its int8 wrap emulated)."""
    monkeypatch.delenv("REDSEC_FORCE_SCHOOLBOOK", raising=False)
    P = _noiseless(get_params(name), 6)
    sk, cloud = kg.keygen(P, seed=3)
    dkey = bs.prepare_cloud_key(cloud, device="cpu")
    assert dkey.spectra.shape == (P.n, P.decomp_rows, 2, 2, P.N // 2)
    assert torch.equal(dkey.spectra[4], kernels.key_spectra(dkey.bk[4]))
    rng = np.random.default_rng(9)
    vals = np.array([37, -1200])
    ct = np.stack([lwe.encrypt_integers(sk.lwe_key, np.array([v]), P, rng)[0] for v in vals])
    tv = bs.const_test_vector(P, 1, P.msg_space)

    seen = []
    the_round = kernels.schoolbook_round

    def spy(acc, t, spectra_round, params, out=None):
        seen.append(spectra_round)
        return the_round(acc, t, spectra_round, params, out=out)

    monkeypatch.setattr(kernels, "schoolbook_round", spy)
    got = bs.make_batched_bootstrap(dkey)(ct, tv).numpy()
    assert len(seen) == P.n and all(torch.equal(s, dkey.spectra[i]) for i, s in enumerate(seen))

    ops = bs.RoundOps(P)

    def s1_round(acc, t, spectra_round, params, out=None):
        i = len(seen)  # the rounds run in order (asserted above)
        seen.append(spectra_round)
        digits = ops.decompose(ops.rotate(acc, t) - acc)
        return out.copy_(acc + kernels.schoolbook_product(digits, dkey.bk[i], params.half_bg))

    seen.clear()
    monkeypatch.setattr(kernels, "schoolbook_round", s1_round)
    np.testing.assert_array_equal(bs.make_batched_bootstrap(dkey)(ct, tv).numpy(), got)
    monkeypatch.setattr(kernels, "schoolbook_round", the_round)

    _, jcloud = jkg.keygen(jparams.TfheParams(**dataclasses.asdict(P)), seed=3)
    jkey = jbs.prepare_cloud_key(jcloud)
    want = np.asarray(jbs.make_batched_bootstrap(jkey)(jnp.asarray(ct), jnp.asarray(tv)))
    for i in range(len(vals)):
        np.testing.assert_array_equal(got[i], jbs.bootstrap_host(jcloud, ct[i], tv))
    np.testing.assert_array_equal(lwe.decrypt_integers(sk.lwe_key, got, P),
                                  np.where(vals >= 0, 1, -1))
    if name == "medium":
        np.testing.assert_array_equal(got, want)
    else:
        monkeypatch.setattr(kernels, "schoolbook_fft_product_plain",
                            _spectra_product_with_int8_wrap())
        np.testing.assert_array_equal(bs.make_batched_bootstrap(dkey)(ct, tv).numpy(), want)


def test_a_schoolbook_key_without_spectra_raises():
    P = _noiseless(get_params("test_noiseless"), 2)
    _, cloud = kg.keygen(P, seed=0)
    dkey = bs.prepare_cloud_key(cloud, device="cpu", schoolbook=True)
    assert dkey.spectra.shape == (2, P.decomp_rows, 2, 2, P.N // 2)
    bare = dataclasses.replace(dkey, spectra=None)
    with pytest.raises(ValueError, match="spectra"):
        bs.make_batched_bootstrap(bare)
    acc = torch.zeros((1, 2, P.N), dtype=torch.int32)
    with pytest.raises(ValueError, match="spectra"):
        kernels.schoolbook_round(acc, torch.zeros(1, dtype=torch.int32), None, P)


@pytest.mark.parametrize("N", kernels.SBFFT_N)
def test_round_layout(N):
    """The kernel's layout rule (mirrored from schoolbook_fft.cu): a cluster
    pair a ciphertext, one output polynomial a block, N / 16 threads (at
    least a warp), a transform buffer and two exchange buffers of N / 2
    complex128 each, within a block's shared memory; every pass's
    butterflies cover the block's threads."""
    lay = kernels.schoolbook_round_layout(N)
    M = N // 2
    assert lay["threads"] == max(32, M // 8) and M % lay["threads"] == 0
    assert lay["shared_bytes"] == 3 * 16 * M <= 227 * 1024
    assert M // 4 >= lay["threads"]  # the first pass: whole radix-4 butterflies a thread
