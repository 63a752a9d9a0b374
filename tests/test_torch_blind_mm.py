"""The four-step ("matmul") blind-rotation kernels against the JAX package.

``csrc/blind_mm.cu`` cannot run without a card, so the first part of this
file repeats its arithmetic in numpy on ``uint64`` arrays, with the tables
``ntt_matmul.kernel_tables_mm_host`` gives it, and asserts every bound its
comments claim (so every value fits the ``uint32_t`` or the ``s32``
accumulator it lives in): the forward R-point negacyclic NTT (Cooley-Tukey,
+2p a stage), the twiddle, the u8 limb split, the three tensor-core
accumulators and their Shoup recombination, the MAC that reduces before the
product that would not fit, the reversed columns of the inverse C-step, the
inverse R-point NTT (Gentleman-Sande, doubling a stage) and the CRT.  The
transforms equal the JAX package's ``ntt_device_mm`` / ``intt_device_mm``
element for element at 12289 and 18433 and at N = 256 and 1024, which pins
the [k1, k2] order; the modelled external product equals the port's twin.

Then: the twins and the PBS of a "matmul" key against the JAX package's
``REDSEC_NTT=matmul`` (and, slow, its Pallas kernels in interpret mode);
``supported_mm`` against ``pallas_blind.supported`` at every set; the
routing of ``make_bootstrap_impl``; ``run-encrypted --ntt-flavor matmul``
against the radix-2 run and the JAX CLI.  Tolerance everywhere: exact
equality (residues mod p, torus values mod 2^32).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redsec_tpu import cli as jcli
from redsec_tpu.crypto import bootstrap as jbs
from redsec_tpu.crypto import keygen as jkg
from redsec_tpu.crypto import ntt as jntt
from redsec_tpu.crypto import ntt_matmul as jmm
from redsec_tpu.crypto import pallas_blind
from redsec_tpu.crypto import params as jparams
from redsec_tpu_torch import cli
from redsec_tpu_torch.crypto import bootstrap as bs
from redsec_tpu_torch.crypto import kernels as K
from redsec_tpu_torch.crypto import keygen as kg
from redsec_tpu_torch.crypto import lwe
from redsec_tpu_torch.crypto import ntt_matmul as mm
from redsec_tpu_torch.crypto.params import (
    PARAM_SETS, SMALL_V2, SMALL_V2_TPU, SMALL_V2_TPU2, TEST_NOISELESS, get_params,
)
from test_torch_cli import _run, work  # noqa: F401  (the CLI fixture)

torch.set_num_threads(2)

U32 = np.uint64(0xFFFFFFFF)
LIMIT = np.uint64(1) << np.uint64(32)
S32 = 1 << 31


def _u64(a):
    return np.asarray(a).astype(np.uint64)


def shoup(x, tw, p):
    """x * w mod p in [0, 2p) for any x < 2^32, as ``shoup`` in blind_mm.cu,
    with the companion the table holds."""
    x = _u64(x)
    assert x.max() < LIMIT
    w, ws = _u64(tw[..., 0]), _u64(tw[..., 1])
    q = (x * ws) >> np.uint64(32)
    r = ((x * w) & U32) - ((q * np.uint64(p)) & U32) & U32
    assert r.max() < 2 * p
    assert np.array_equal(r % np.uint64(p), x * w % np.uint64(p))
    return r


def reduce(x, p):
    """Barrett to [0, p) for any uint32, as ``reduce``."""
    assert x.max() < LIMIT
    m = np.uint64((1 << 32) // p)
    r = (x - (((x * m) >> np.uint64(32)) * np.uint64(p))) & U32
    assert r.max() < 2 * p
    return np.where(r >= p, r - np.uint64(p), r)


def pair(w, p):
    """``shoup_pair(w, p)`` of blind_mm.cu."""
    w = w % p
    return np.array([w, (w << 32) // p], np.uint64)


def _brv(k, bits):
    return int(format(k, f"0{bits}b")[::-1], 2) if bits else 0


def _tables(plan, pi):
    return mm.kernel_tables_mm_host(plan.N, plan.primes[pi], int(plan.twist[pi][1]))


def model_mma(a, wc, p):
    """The C-step out[.., n] = sum_k a[.., k] W[k, n] mod p of ``mma_mod``:
    a < 2^16 as u8 limbs, W's limbs ``wc`` [2, C, C] (hi 7 bits); the three
    s32 accumulators (lo*lo, lo*hi + hi*lo, hi*hi) and their recombination."""
    a = _u64(a)
    assert a.max() < 1 << 16
    lo, hi = a & np.uint64(255), a >> np.uint64(8)
    wl, wh = _u64(wc[0]), _u64(wc[1])
    assert wl.max() <= 255 and wh.max() <= 127
    c00, cmid, c11 = lo @ wl, lo @ wh + hi @ wl, hi @ wh
    for c in (c00, cmid, c11):
        assert c.max() < S32, "an s32 accumulator overflows"
    v = c00 + shoup(cmid, pair(256, p), p) + shoup(c11, pair(65536, p), p)
    assert v.max() < 1 << 24
    return reduce(v, p)


def model_forward(x, plan, pi):
    """``forward_pre`` + the forward ``mma_mod``: x [.., N] in [0, p) ->
    the four-step NTT in [k1, k2] order, in [0, p)."""
    p, N = plan.primes[pi], plan.N
    t = _tables(plan, pi)
    R, C = t["R"], mm.MM_C
    lg = R.bit_length() - 1
    tw = t["tw"]
    v = _u64(x).reshape(-1, R, C)
    assert v.max() < p
    a = [v[:, j] for j in range(R)]
    m, span, bound = 1, R // 2, p
    while m < R:  # Cooley-Tukey, psi_R^brv(m + i); + 2p a stage
        for i in range(m):
            s = tw[2 * R * C + m + i]
            for j in range(2 * i * span, 2 * i * span + span):
                u, w = a[j], shoup(a[j + span], s, p)
                assert u.max() < bound
                a[j], a[j + span] = u + w, u - w + np.uint64(2 * p)
        m, span, bound = 2 * m, span // 2, bound + 2 * p
    assert max(b.max() for b in a) < (2 * lg + 1) * p
    A = np.stack([a[_brv(k1, lg)] for k1 in range(R)], axis=1)  # [.., k1, j2]
    A = shoup(A, tw[:R * C].reshape(R, C, 2)[None], p)
    A = np.where(A >= p, A - np.uint64(p), A)
    assert A.max() < 1 << 15, "the limb split takes values below 2^15"
    return model_mma(A, t["wc"], p).reshape(x.shape)


def model_inverse(y, plan, pi):
    """The inverse ``mma_mod`` on the reversed columns + ``inverse_post``:
    y [.., N] in [k1, k2] order, below 2^16 -> natural order in [0, p)."""
    p, N = plan.primes[pi], plan.N
    t = _tables(plan, pi)
    R, C = t["R"], mm.MM_C
    lg = R.bit_length() - 1
    tw = t["tw"]
    Y = _u64(y).reshape(-1, R, C)
    c = np.arange(C)
    b = model_mma(Y[..., (C - c) % C], t["wc"], p)  # WCi[k2] = WC[-k2 mod C]
    b = shoup(b, tw[R * C:2 * R * C].reshape(R, C, 2)[None], p)
    a = [b[:, _brv(i, lg)] for i in range(R)]
    m, span, bound = R, 1, 2 * p
    while m > 1:  # Gentleman-Sande, psi_R^-brv(h + i); doubling a stage
        h = m // 2
        for i in range(h):
            s = tw[2 * R * C + R + h + i]
            for j in range(2 * i * span, 2 * i * span + span):
                u, w = a[j], a[j + span]
                assert u.max() < bound and w.max() < bound
                a[j], a[j + span] = u + w, shoup(u - w + np.uint64(bound), s, p)
        m, span, bound = h, 2 * span, 2 * bound
    assert max(v.max() for v in a) < 2 * R * p
    return reduce(np.stack(a, axis=1), p).reshape(y.shape)


def model_mac(dn, bk, p):
    """The MAC: dn [M, rows, N], residues bk [rows, 8, N], both below p;
    products added without reduction while ``lazy`` of them fit a uint32
    beside a carried value below 2p; the sums in [0, p)."""
    lazy = ((1 << 32) - 2 * p) // ((p - 1) ** 2)
    acc = np.zeros((dn.shape[0], 8, dn.shape[-1]), np.uint64)
    pending = 0
    for j in range(dn.shape[1]):
        if pending == lazy:
            acc = reduce(acc, p)  # (reduce_2p in the kernel; < 2p either way)
            pending = 0
        pending += 1
        acc = acc + _u64(dn[:, j, None]) * _u64(bk[j][None])
        assert acc.max() < LIMIT
    return reduce(acc, p)


def model_crt(c0, c1, p0, p1):
    """``crt2``: Garner's digit below p1, v < p0 p1, the upper half negative."""
    inv01 = pair(pow(p0 % p1, p1 - 2, p1), p1)
    t1 = shoup(_u64(c1) + np.uint64(p1) - _u64(c0), inv01, p1)
    t1 = np.where(t1 >= p1, t1 - np.uint64(p1), t1)
    v = _u64(c0) + t1 * np.uint64(p0)
    assert v.max() < p0 * p1 < 1 << 30
    return np.where(2 * v >= p0 * p1, v - np.uint64(p0 * p1), v) & U32


def model_external_product(digits, bk_round, plan):
    """``external_product_mm``: signed digits [M, rows, N], the round slice
    int16 [2, rows, 8, R, C] -> delta int32 [M, 2, N]."""
    M, rows, N = digits.shape
    res = []
    for pi, p in enumerate(plan.primes):
        dn = model_forward(np.where(digits < 0, digits + p, digits), plan, pi)
        s = model_mac(dn, kernel_residues(bk_round[pi]).reshape(rows, 8, N), p)
        res.append(model_inverse(s, plan, pi))
    v = model_crt(res[0], res[1], *plan.primes)  # [M, 8, N]
    delta = np.zeros((M, 2, N), np.uint64)
    for o in range(8):
        delta[:, o // 4] = (delta[:, o // 4] + (v[:, o] << np.uint64(8 * (o % 4)))) & U32
    return delta.astype(np.uint32).view(np.int32)


def kernel_residues(bk):
    return np.asarray(bk).astype(np.int64) & 0xFFFF


def _plans():
    return {256: bs.bootstrap_plan(TEST_NOISELESS), 1024: bs.bootstrap_plan(SMALL_V2_TPU)}


def _jax_plan(P):
    return jntt.make_plan(P.N, max_operand=P.half_bg, limb_bits=8, accum=P.decomp_rows,
                          balanced=True)


# --------------------------------------------------------------------------- #
# (a) The kernel's arithmetic, modelled                                       #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("N", [256, 1024])
@pytest.mark.parametrize("pi", [0, 1])
def test_modelled_transforms_equal_jax_ntt_mm(N, pi):
    P = TEST_NOISELESS if N == 256 else SMALL_V2_TPU
    plan, jplan = _plans()[N], _jax_plan(P)
    p = plan.primes[pi]
    assert p == (12289, 18433)[pi] and plan.primes == jplan.primes
    rng = np.random.default_rng(N + pi)
    x = rng.integers(0, p, size=(5, N))
    x[0] = p - 1  # every product at its largest
    x[1] = 0
    want = np.asarray(jmm.ntt_device_mm(jnp.asarray(x.astype(np.int32)), jplan, pi))
    np.testing.assert_array_equal(model_forward(x, plan, pi), want)
    # digits as the kernel takes them: signed, plus p below 0
    d = rng.integers(-P.half_bg, P.half_bg, size=(3, N))
    dm = np.where(d < 0, d + p, d)
    np.testing.assert_array_equal(
        model_forward(dm, plan, pi),
        np.asarray(jmm.ntt_device_mm(jnp.asarray(dm.astype(np.int32)), jplan, pi)))
    want = np.asarray(jmm.intt_device_mm(jnp.asarray(x.astype(np.int32)), jplan, pi))
    np.testing.assert_array_equal(model_inverse(x, plan, pi), want)
    # inputs up to 2^16 - 1 (what 16 bits hold) are within the inverse's bounds
    y = rng.integers(0, 1 << 16, size=(2, N))
    np.testing.assert_array_equal(
        model_inverse(y, plan, pi),
        np.asarray(jmm.intt_device_mm(jnp.asarray((y % p).astype(np.int32)), jplan, pi)))


@pytest.mark.parametrize("name", ["test_noiseless", "small_v2_tpu", "small_v2_tpu2"])
def test_modelled_external_product_equals_the_twin(name):
    P = dataclasses.replace(get_params(name), n=2)
    _, cloud = kg.keygen(P, seed=3)
    mk = bs.prepare_cloud_key(cloud, device="cpu", ntt_flavor="matmul")
    rng = np.random.default_rng(11)
    digits = rng.integers(-P.half_bg, P.half_bg, size=(2, P.decomp_rows, P.N)).astype(np.int32)
    digits[0, :, :7] = -P.half_bg
    bk = mk.bk[:, 1]
    want = K.external_product_mm_plain(torch.as_tensor(digits), bk, mk.plan).numpy()
    np.testing.assert_array_equal(model_external_product(digits, bk.numpy(), mk.plan), want)
    # the largest residues: every MAC product at (p - 1)^2
    top = np.stack([np.full(bk.shape[1:], p - 1, np.int16) for p in mk.plan.primes])
    m = K.external_product_mm_plain(torch.as_tensor(digits), torch.as_tensor(top),
                                    mk.plan).numpy()
    np.testing.assert_array_equal(model_external_product(digits, top, mk.plan), m)


@pytest.mark.parametrize("N", [256, 1024])
def test_kernel_tables_are_the_jax_round_tables_folded(N):
    """WC's limbs are JAX's ``_round_tables`` limbs; TWf, TWi' and the
    R-point twiddles are its twist, TW, WR and untwist folded as the kernel
    folds them."""
    from redsec_tpu.crypto.pallas_round import _round_tables

    P = TEST_NOISELESS if N == 256 else SMALL_V2_TPU
    jP = jparams.get_params(P.name)
    plan, jplan = _plans()[N], _jax_plan(P)
    for pi, (p, jt) in enumerate(zip(plan.primes, _round_tables(jP, jplan))):
        t = _tables(plan, pi)
        R, C = t["R"], 128
        np.testing.assert_array_equal(t["wc"][0], jt["WC"][0].astype(np.uint8))
        np.testing.assert_array_equal(t["wc"][1], jt["WC"][1].astype(np.uint8))
        tw = t["tw"].astype(np.int64)
        np.testing.assert_array_equal(tw[..., 1], (tw[..., 0] << 32) // p)
        psi = int(plan.twist[pi][1])
        pj = np.array([pow(psi, j, p) for j in range(C)])
        np.testing.assert_array_equal(tw[:R * C, 0].reshape(R, C), jt["TW"] * pj[None] % p)
        # untwist[j1, j2] = psi^-(C j1) psi^-j2 / N: its row 0 rides on TWi'
        np.testing.assert_array_equal(tw[R * C:2 * R * C, 0].reshape(R, C),
                                      jt["TWi"] * jt["untwist"][0][None, :] % p)
        # the forward R-point NTT with the pre-twist psi^(C j1) is WR . diag(twist[:, 0])
        psf = tw[2 * R * C:2 * R * C + R, 0]
        lg = R.bit_length() - 1
        psi_r = pow(psi, C, p)
        for k in range(1, R):
            assert psf[k] == pow(psi_r, _brv(k, lg), p)
        for k1 in range(R):
            for j1 in range(R):
                assert jt["WR"][k1, j1] * jt["twist"][j1, 0] % p == pow(psi_r, j1 * (2 * k1 + 1), p)


# --------------------------------------------------------------------------- #
# (b) The twins and the PBS of a "matmul" key against JAX                     #
# --------------------------------------------------------------------------- #


def _jax_matmul_key(jcloud, monkeypatch):
    monkeypatch.setenv("REDSEC_NTT", "matmul")
    jdkey = jbs.prepare_cloud_key(jcloud)
    assert jdkey.ntt_flavor == "matmul"
    return jdkey


def test_blind_rotate_mm_plain_pbs_equals_jax_matmul_at_small_v2_tpu(monkeypatch):
    """small_v2_tpu with n cut to 4: the port's "matmul" key through
    ``make_batched_bootstrap`` (routed to ``blind_rotate_mm``, on the CPU its
    twin) equals the JAX package's PBS under REDSEC_NTT=matmul, and
    ``blind_rotate_mm_plain`` equals the radix-2 twin on the same raw key."""
    P = dataclasses.replace(SMALL_V2_TPU, n=4)
    JP = dataclasses.replace(jparams.SMALL_V2_TPU, n=4)
    sk, cloud = kg.keygen(P, seed=21)
    _, jcloud = jkg.keygen(JP, seed=21)
    mk = bs.prepare_cloud_key(cloud, device="cpu", ntt_flavor="matmul")
    rk = bs.prepare_cloud_key(cloud, device="cpu")
    rng = np.random.default_rng(5)
    ct = lwe.encrypt_integers(sk.lwe_key, rng.integers(-400, 400, size=6), P, rng)
    tv = bs.const_test_vector(P, 1, P.msg_space)
    jdkey = _jax_matmul_key(jcloud, monkeypatch)
    want = np.asarray(jbs.make_batched_bootstrap(jdkey)(jnp.asarray(ct), jnp.asarray(tv)))
    got = bs.make_batched_bootstrap(mk)(torch.as_tensor(ct), tv).numpy()
    np.testing.assert_array_equal(got, want)
    acc = torch.as_tensor(rng.integers(-2**31, 2**31, size=(3, 2, P.N)).astype(np.int32))
    abar = torch.as_tensor(rng.integers(0, 2 * P.N, size=(3, P.n)).astype(np.int32))
    out = K.blind_rotate_mm_plain(acc, abar, mk.bk, P, mk.plan)
    assert torch.equal(out, K.blind_rotate_mm(acc, abar, mk.bk, P, mk.plan))
    assert torch.equal(out, K.blind_rotate_plain(acc, abar, rk.bk, P, rk.plan))


def test_mm_wrappers_refuse_radix2_keys_by_shape():
    P = dataclasses.replace(TEST_NOISELESS, n=2)
    _, cloud = kg.keygen(P, seed=1)
    rk = bs.prepare_cloud_key(cloud, device="cpu")
    mk = bs.prepare_cloud_key(cloud, device="cpu", ntt_flavor="matmul")
    acc = torch.zeros((2, 2, P.N), dtype=torch.int32)
    abar = torch.zeros((2, P.n), dtype=torch.int32)
    digits = torch.zeros((2, P.decomp_rows, P.N), dtype=torch.int32)
    t = torch.zeros((2,), dtype=torch.int32)
    for fn in (lambda: K.blind_rotate_mm(acc, abar, rk.bk, P, rk.plan),
               lambda: K.blind_rotate_mm_plain(acc, abar, rk.bk, P, rk.plan),
               lambda: K.external_product_mm(digits, rk.bk[:, 0], rk.plan),
               lambda: K.cmux_round_mm(acc, t, rk.bk[:, 0], P, rk.plan),
               lambda: K.cmux_round_mm_plain(acc, t, rk.bk[:, 0], P, rk.plan)):
        with pytest.raises(ValueError, match="four-step"):
            fn()
    with pytest.raises(ValueError, match="radix-2"):  # and the radix-2 K4 a four-step one
        K.blind_rotate(acc, abar, mk.bk, P, mk.plan)


@pytest.mark.parametrize("bundle,name,kernel", [(1, "test_noiseless", True),
                                                (2, "test_noiseless", False),
                                                (1, "small_v2_n2048", False)])
def test_bootstrap_routes_matmul_keys_by_shape(monkeypatch, bundle, name, kernel):
    """A "matmul" key that ``supported_mm`` takes goes to
    ``kernels.blind_rotate_mm``; a bundled one, or N = 2048 (40961), to the
    torch loop ``blind_rotate_mm_plain``."""
    P = dataclasses.replace(get_params(name), n=4)
    sk, cloud = kg.keygen(P, seed=2, bundle=bundle)
    mk = bs.prepare_cloud_key(cloud, device="cpu", ntt_flavor="matmul")
    calls = []
    for fn in ("blind_rotate_mm", "blind_rotate_mm_plain"):
        real = getattr(K, fn)
        monkeypatch.setattr(K, fn, lambda *a, _f=fn, _r=real: calls.append(_f) or _r(*a))
    rng = np.random.default_rng(9)
    ct = lwe.encrypt_integers(sk.lwe_key, rng.integers(-50, 50, size=2), P, rng)
    bs.make_batched_bootstrap(mk)(torch.as_tensor(ct), bs.const_test_vector(P, 1, P.msg_space))
    assert calls[0] == ("blind_rotate_mm" if kernel else "blind_rotate_mm_plain")
    assert K.supported_mm(P, mk.plan, mk.bundle) == kernel


# --------------------------------------------------------------------------- #
# (c) Slow: the JAX Pallas kernels in interpret mode                          #
# --------------------------------------------------------------------------- #


@pytest.mark.slow
def test_blind_rotate_mm_equals_jax_pallas_blind_kernel(monkeypatch):
    P = TEST_NOISELESS
    sk, cloud = kg.keygen(P, seed=7)
    _, jcloud = jkg.keygen(jparams.TEST_NOISELESS, seed=7)
    mk = bs.prepare_cloud_key(cloud, device="cpu", ntt_flavor="matmul")
    jdkey = _jax_matmul_key(jcloud, monkeypatch)
    monkeypatch.setenv("REDSEC_BLIND_KERNEL", "1")
    monkeypatch.setenv("REDSEC_BLIND_TILE", "4")
    rng = np.random.default_rng(3)
    ct = lwe.encrypt_integers(sk.lwe_key, rng.integers(-300, 300, size=6), P, rng)
    tv = bs.const_test_vector(P, 1, P.msg_space)
    want = np.asarray(jbs.make_batched_bootstrap(jdkey)(jnp.asarray(ct), jnp.asarray(tv)))
    got = bs.make_batched_bootstrap(mk)(torch.as_tensor(ct), tv).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_round_mm_twins_equal_jax_pallas_round_kernels(monkeypatch):
    from redsec_tpu.crypto.pallas_round import make_full_round_kernel, make_round_kernel

    name = "small_v2_noiseless"
    P = get_params(name)
    _, cloud = kg.keygen(P, seed=1)
    _, jcloud = jkg.keygen(jparams.get_params(name), seed=1)
    mk = bs.prepare_cloud_key(cloud, device="cpu", ntt_flavor="matmul")
    jdkey = _jax_matmul_key(jcloud, monkeypatch)
    rows, N, M = P.decomp_rows, P.N, 3
    rng = np.random.default_rng(0)
    digits = rng.integers(-P.half_bg, P.half_bg, size=(M, rows, N)).astype(np.int32)
    acc = rng.integers(-2**31, 2**31, size=(M, 2, N)).astype(np.int32)
    t = rng.integers(0, 2 * N, size=(M,)).astype(np.int32)
    jbk = jnp.stack([b[4].astype(jnp.int32).reshape(rows, 8, N) for b in jdkey.bk_ntt])
    jP, jplan = jdkey.params, jdkey.plan
    want = np.asarray(make_round_kernel(jP, jplan, tile=4, interpret=True)(jnp.asarray(digits),
                                                                           jbk))
    got = K.external_product_mm(torch.as_tensor(digits), mk.bk[:, 4], mk.plan).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(make_full_round_kernel(jP, jplan, tile=4, interpret=True)(
        jnp.asarray(acc), jnp.asarray(t), jbk))
    got = K.cmux_round_mm(torch.as_tensor(acc), torch.as_tensor(t), mk.bk[:, 4], P,
                          mk.plan).numpy()
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------- #
# (d) The envelope and the layout                                             #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", sorted(PARAM_SETS))
@pytest.mark.parametrize("bundle", [1, 2])
def test_supported_mm_is_jax_pallas_blind_supported(name, bundle):
    P, jP = get_params(name), jparams.get_params(name)
    plan = bs.bootstrap_plan(P, bundle == 2)
    jplan = jbs._bootstrap_plan(jP, bundle == 2)
    if plan is None:
        assert jplan is None
        return
    want = pallas_blind.supported(jP, jplan) and bundle == 1
    assert K.supported_mm(P, plan, bundle) == want
    if want:
        lay = K.k4mm_layout(P, plan)
        assert lay["shared_bytes"] <= K.K4_MAX_SHARED == 232448
        assert lay["threads"] == P.N // 2
    elif bundle == 1:  # (a bundled key's set may have a plain instance)
        with pytest.raises(ValueError):
            K.k4mm_layout(P, plan)


def test_k4mm_layout_bytes():
    """The byte counts blind_mm.cu's header states, and the digit rows
    beyond which a block has no room."""
    assert K.k4mm_layout(SMALL_V2_TPU)["shared_bytes"] == 181760
    assert K.k4mm_layout(SMALL_V2)["shared_bytes"] == 212480
    assert K.k4mm_layout(SMALL_V2_TPU2)["shared_bytes"] == 177408
    assert K.k4mm_layout(TEST_NOISELESS)["shared_bytes"] == 112896
    assert K.k4mm_shared_bytes(1024, 24) <= 232448 < K.k4mm_shared_bytes(1024, 25)
    big = dataclasses.replace(SMALL_V2, l=13, bg_bit=2)  # 26 digit rows
    assert not K.supported_mm(big, bs.bootstrap_plan(SMALL_V2))


# --------------------------------------------------------------------------- #
# (e) The command line                                                        #
# --------------------------------------------------------------------------- #


def test_run_encrypted_ntt_flavor_matmul_equals_radix2_and_jax(work, capsys,  # noqa: F811
                                                               monkeypatch):
    d = work[0]
    common = ["--model", d / "mini_spec.json", "--weights", d / "weights.dat",
              "--eval", d / "j" / "eval.key.npz"]
    _run(jcli.main, capsys, "encrypt-image", "--secret", d / "j" / "secret.key.npz",
         "--image-ptxt", d / "img.ptxt", "--seed", "4", "--out", d / "mm_batch.npz")
    recs = {}
    for flavor in ("radix2", "matmul"):
        out, recs[flavor] = _run(cli.main, capsys, "run-encrypted", *common, "--image",
                                 d / "mm_batch.npz", "--out", d / f"mm_{flavor}.npz",
                                 "--device", "cpu", "--ntt-flavor", flavor)
    monkeypatch.setenv("REDSEC_NTT", "matmul")
    _run(jcli.main, capsys, "run-encrypted", *common, "--image", d / "mm_batch.npz",
         "--out", d / "mm_jax.npz")
    a = np.load(d / "mm_matmul.npz")
    for other in ("mm_radix2.npz", "mm_jax.npz"):
        b = np.load(d / other)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{other}:{k}")
    assert recs["matmul"]["pbs"] == recs["radix2"]["pbs"] == 16 + 64 + 16 + 6
    assert recs["matmul"]["k4mm_launches"] == recs["matmul"]["k4_launches"] == 0  # the CPU
