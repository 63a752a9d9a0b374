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
- The kernel's layout rule (``kernels.schoolbook_round_layout``) at every N
  it takes, a torch model of the cluster's data movement built from it (each
  row transformed by one block, its slices sent to the blocks owning the
  bins, each key value read once for the cluster's two ciphertexts, the sums
  sent to the block that inverts them, the halves swapped) equal to the
  twin, the twiddle table in the passes' order (a numpy model of the
  kernel's passes reading it), the padded buffers' bank groups, and the
  rounding bound below 1/2 at every parameter set.

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
from redsec_tpu_torch.crypto.params import PARAM_SETS, get_params
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
    of at most 8 blocks, 4 for each of its ciphertexts, N / 16 threads (at
    least a warp), a padded transform buffer of N / 2 complex128 and an
    inbox of N, within a block's shared memory; at every row count of the
    sets (and 2, 4, 64), each digit row of a ciphertext transformed once, by
    one block, at most 2 a block a chunk, each spectrum bin of every ciphertext of the
    cluster accumulated by one block, each accumulated spectrum (ciphertext,
    u, half) inverted by one block, and each coefficient stored by one block
    of the pair that inverted its polynomial's two halves."""
    M = N // 2
    for rows in sorted({2, 4, 64} | {p.decomp_rows for p in PARAM_SETS.values()}):
        lay = kernels.schoolbook_round_layout(N, rows)
        C, CT, T = lay["cluster"], lay["ciphertexts"], lay["threads"]
        S = lay["rows_a_chunk"] // 4
        assert C == 4 * CT <= 8 and T == max(32, M // 8) and M % T == 0
        assert lay["shared_bytes"] == 16 * (M + M // 8 + 2 * M) <= 227 * 1024
        assert lay["instance"].endswith(f"Lb{int(rows > 8)}E")
        assert M // 4 >= T and (M // C) % T == 0  # whole butterflies, whole bin rows a thread
        seen = [r for chunk in lay["chunks"] for rws in chunk for r in rws]
        assert sorted(seen) == list(range(rows))
        for chunk in lay["chunks"]:
            assert len(chunk) == 4 and all(len(rws) <= S for rws in chunk)
            r0 = min(r for rws in chunk for r in rws)
            assert all(r - r0 == role + 4 * s for role, rws in enumerate(chunk)
                       for s, r in enumerate(rws))  # the kernel's r0 + role + 4 s
        cover = np.zeros(M, dtype=int)
        for lo, hi in lay["bins"]:
            cover[lo:hi] += 1
        assert (cover == 1).all() and len(lay["bins"]) == C
        assert sorted(lay["inverts"]) == [(e, u, h) for e in range(CT) for u in (0, 1)
                                          for h in (0, 1)]
        stored = np.zeros((CT, 2, N), dtype=int)
        for a_c, b_c in lay["swap"]:
            (ea, ua, ha), (eb, ub, hb) = lay["inverts"][a_c], lay["inverts"][b_c]
            assert (ea, ua) == (eb, ub) and {ha, hb} == {0, 1}
            for c in (a_c, b_c):
                e, u, lo, hi = lay["stores"][c]
                assert (e, u) == lay["inverts"][c][:2]
                stored[e, u, lo:hi] += 1
        assert (stored == 1).all()


def _cluster_model_round(acc, t, spectra, P):
    """One schoolbook round as the round kernel moves its data, in torch,
    cluster by cluster (``schoolbook_round_layout``): each block transforms
    the rows its role gives it, a chunk at a time, and sends each slice of
    bins to the inbox of the block that owns them; for its bins each block
    reads each row's key slice once and every ciphertext's row slice from
    its inbox, in row order, and accumulates the 4 products (u, half) of
    each ciphertext, and sends each sum to the block that inverts it; each
    block inverts and rounds one accumulated spectrum of its ciphertext,
    assembled from the cluster's slices; the two blocks of a polynomial swap the uint32
    values of the half each does not store, and each recombines lo + 2^16 hi
    on its half and adds acc.  The batch's last cluster may hold fewer
    ciphertexts."""
    N, rows, B = P.N, P.decomp_rows, acc.shape[0]
    M = N // 2
    lay = kernels.schoolbook_round_layout(N, rows)
    C, CT = lay["cluster"], lay["ciphertexts"]
    ops = bs.RoundOps(P)
    digits = ops.decompose(ops.rotate(acc, t) - acc).to(torch.float64)
    twist = kernels.fft_tables(N, "cpu")[1]
    key = spectra.reshape(rows, 4, M)  # [r][(u, half)][bin]
    out = torch.empty_like(acc)
    for b0 in range(0, B, CT):
        cts = list(range(b0, min(b0 + CT, B)))
        blocks = [c for c in range(C) if c // 4 < len(cts)]
        sums = {c: torch.zeros((len(cts), 4, hi - lo), dtype=torch.complex128)
                for c, (lo, hi) in enumerate(lay["bins"])}
        for chunk in lay["chunks"]:
            inbox = {}  # (block, ciphertext, row) -> the row spectrum's slice of its bins
            for c in blocks:
                for r in chunk[c % 4]:
                    d = digits[cts[c // 4], r]
                    y = torch.fft.fft(torch.complex(d[:M], d[M:]) * twist)
                    for o, (lo, hi) in enumerate(lay["bins"]):
                        assert (o, c // 4, r) not in inbox
                        inbox[o, c // 4, r] = y[lo:hi]
            for c, (lo, hi) in enumerate(lay["bins"]):
                for r in sorted(r for rws in chunk for r in rws):
                    k = key[r, :, lo:hi]  # read once for the cluster's ciphertexts
                    for e in range(len(cts)):
                        sums[c][e] = sums[c][e] + inbox[c, e, r] * k
        vals = {}
        for c in blocks:
            e, u, h = lay["inverts"][c]
            spec = torch.cat([sums[o][e, 2 * u + h] for o in range(C)])
            z = torch.fft.ifft(spec) * twist.conj()
            vals[c] = torch.round(torch.cat([z.real, z.imag])).to(torch.int64) & 0xFFFFFFFF
        for a_c, b_c in lay["swap"]:
            if a_c not in blocks:
                continue
            for c, partner in ((a_c, b_c), (b_c, a_c)):
                e, u, lo, hi = lay["stores"][c]
                own, got = vals[c][lo:hi], vals[partner][lo:hi]  # got: the swapped half
                low, high = (got, own) if lay["inverts"][c][2] else (own, got)
                res = (acc[cts[e], u, lo:hi].to(torch.int64) + low + (high << 16)) & 0xFFFFFFFF
                out[cts[e], u, lo:hi] = (res - ((res >> 31) << 32)).to(torch.int32)
    return out


@pytest.mark.parametrize("name,N,batch", [("test_noiseless", 256, 3), ("medium", 512, 2),
                                          ("medium_v2", 4096, 3), ("large_v2", 8192, 1)])
def test_cluster_data_movement_equals_the_twin(name, N, batch):
    """The torch model of the kernel's data movement (three chunks of rows
    at test_noiseless, uneven shares of 6 rows at medium's gadget, one chunk
    of 8 at medium_v2 and large_v2; odd batches leave the last cluster one
    ciphertext) is bit-identical to ``schoolbook_round_plain``, with the
    first ciphertext's digits at their worst-case norm."""
    P = dataclasses.replace(get_params(name), N=N)
    rng = np.random.default_rng(N + batch)
    acc = torch.as_tensor(rng.integers(-2**31, 2**31, size=(batch, 2, N), dtype=np.int64)
                          .astype(np.int32))
    t = torch.as_tensor(rng.integers(0, 2 * N, size=batch).astype(np.int32))
    fill = bs.gadget_offset(P) // 2
    acc[0] = fill - 2**32 if fill >= 2**31 else fill
    t[0] = N
    bk = torch.as_tensor(rng.integers(-2**31, 2**31, size=(P.decomp_rows, 2, N), dtype=np.int64)
                         .astype(np.int32))
    bk[0, 0, :4] = -2**31
    spectra = kernels.key_spectra(bk)
    ops = bs.RoundOps(P)
    assert int(ops.decompose(ops.rotate(acc, t) - acc)[0].max()) == -P.half_bg
    want = kernels.schoolbook_round_plain(acc, t, spectra, P)
    assert torch.equal(_cluster_model_round(acc, t, spectra, P), want)


@pytest.mark.parametrize("name", sorted(PARAM_SETS))
def test_bound_below_half_at_every_set(name):
    """The kernel's rounding bound (the same transforms, twists and row-order
    sum whichever block computes a bin) at the
    worst-case digits and the largest halves any key can have is below 1/2
    at every parameter set (each N is one the kernel takes), forced
    schoolbook included."""
    P = PARAM_SETS[name]
    assert P.N in kernels.SBFFT_N
    worst = kernels.schoolbook_fft_error_bound(P.N, P.decomp_rows, P.half_bg,
                                               P.decomp_rows * 2**15 * math.sqrt(P.N))
    assert 0 < worst < 0.5


def _kernel_dft(x, tw):
    """The round kernel's forward DFT of x [M] in numpy, pass by pass as its
    first_pass, pass and last_pass index their operands and read the
    twiddle table ``tw`` (``fft_tables``' first element)."""
    M = x.shape[0]
    RL = {0: 8, 1: 2, 2: 4}[(M.bit_length() - 3) % 3]

    def small(v):  # the R-point DFT of v [R, J] along the first axis
        R = v.shape[0]
        w = np.exp(-2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R)
        return w @ v

    buf = np.empty(M, dtype=np.complex128)
    j = np.arange(M // 4)
    v = small(np.stack([x[j + r * (M // 4)] for r in range(4)]))
    for r in range(4):
        buf[4 * j + r] = v[r]
    Ns = 4
    while Ns < M // RL:
        j = np.arange(M // 8)
        k = j & (Ns - 1)
        v = np.stack([buf[j + r * (M // 8)] for r in range(8)])
        for r in range(1, 8):
            v[r] *= tw[Ns - 4 + (r - 1) * Ns + k]
        v = small(v)
        nbuf = np.empty_like(buf)
        for r in range(8):
            nbuf[(j - k) * 8 + k + r * Ns] = v[r]
        buf = nbuf
        Ns *= 8
    J = M // RL
    j = np.arange(J)
    v = np.stack([buf[j + r * J] for r in range(RL)])
    for r in range(1, RL):
        v[r] *= tw[J - 4 + (r - 1) * J + j]
    v = small(v)
    out = np.empty_like(x)
    for r in range(RL):
        out[j + r * J] = v[r]
    return out


@pytest.mark.parametrize("N", kernels.SBFFT_N)
def test_pass_twiddle_table_follows_the_kernels_passes(N):
    """The twiddle table the kernel reads (``fft_tables``, laid out by
    ``fft_pass_index``) holds the same rounded values W_M^m, and the
    kernel's passes reading it at their indices compute the DFT."""
    M = N // 2
    tw, _ = kernels.fft_tables(N, "cpu")
    idx = kernels.fft_pass_index(N)
    assert tuple(tw.shape) == (M - 4,) and 0 <= idx.min() and idx.max() < M
    assert torch.equal(tw, torch.as_tensor(kernels._fft_tables_host(N)[0][idx]))
    x = np.random.default_rng(N).standard_normal((M, 2)) @ np.array([1, 1j])
    got = _kernel_dft(x, tw.numpy())
    np.testing.assert_allclose(got, np.fft.fft(x), rtol=0, atol=1e-12 * np.abs(x).sum())


@pytest.mark.parametrize("N", kernels.SBFFT_N)
def test_padded_buffer_is_conflict_free(N):
    """With ``sbfft_pad``, the 8 threads of every quarter warp (one 128-byte
    shared-memory wavefront of 16-byte values) reach 8 different bank
    groups in the first pass's stores, every radix-8 pass's loads and
    stores, the last pass's loads and the row slots' stores and reads."""
    M = N // 2
    T = max(32, M // 8)
    RL = {0: 8, 1: 2, 2: 4}[(M.bit_length() - 3) % 3]
    pad = kernels.sbfft_pad

    def free(index):  # index(tid) for one access, over a block's threads
        for q0 in range(0, T, 8):
            banks = {pad(index(tid)) % 8 for tid in range(q0, q0 + 8)}
            assert len(banks) == 8, (N, q0)

    for q in range(M // 4 // T):
        for r in range(4):
            free(lambda tid: 4 * (tid + q * T) + r)
    Ns = 4
    while Ns < M // RL:
        for r in range(8):
            free(lambda tid: tid % (M // 8) + r * (M // 8))
            free(lambda tid: (tid % (M // 8) - tid % Ns) * 8 + tid % Ns + r * Ns)
        Ns *= 8
    J = M // RL
    for q in range(J // T):
        for r in range(RL):
            free(lambda tid: tid + q * T + r * J)
    for q in range(M // T):
        free(lambda tid: tid + q * T)
