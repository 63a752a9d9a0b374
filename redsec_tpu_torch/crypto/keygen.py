"""Key generation: secret keys, bootstrapping key (TGSW), key-switching key.

Host-side (numpy), a copy of the JAX package's keygen: the same seed draws the
same keys, byte for byte.  ``bootstrap.prepare_cloud_key`` uploads them to the
device (BK pre-transformed into the CRT-NTT domain).

Structures follow TFHE v1.1 with k=1:

- bootstrapping key: for each LWE key bit ``s_i`` a TGSW sample — a
  ``(k+1)*l x (k+1)`` matrix of torus polynomials: TLWE encryptions of zero
  plus ``s_i * H`` with gadget ``H[bloc*l + j][bloc] = 2^(32-(j+1)*bg_bit)``.
- key-switching key: for every coefficient ``i`` of the extracted RLWE key,
  level ``j < t`` and digit value ``v < base``, an LWE_n encryption of
  ``v * K_i * 2^(32-(j+1)*basebit)`` at noise ``alpha_ks``
  (the reference's keygen builds the same via TFHE,
  client/gen_secure_keyset.cpp:94-115).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import ntt as ntt_mod
from .lwe import gaussian_torus32, lwe_key_gen
from .params import TfheParams


# re-randomization pool size: boundaries cycle through (boundary*k + copy)
# mod RERAND_POOL, so 64 covers k=3 voting over 21 distinct boundaries
# before reuse (reuse is harmless for decorrelation: the phase differs)
RERAND_POOL = 64


@dataclasses.dataclass
class SecretKey:
    params: TfheParams
    lwe_key: np.ndarray  # int32 [n] in {0,1}
    rlwe_key: np.ndarray  # int32 [N] in {0,1} (k=1)

    @property
    def extracted_key(self) -> np.ndarray:
        """LWE key of dimension N obtained by sample-extracting under the RLWE
        key: equals the RLWE key coefficients in order."""
        return self.rlwe_key


@dataclasses.dataclass
class CloudKey:
    params: TfheParams
    bk: np.ndarray  # int32 [n, (k+1)l, k+1, N] — TGSW(s_i) coefficient domain
    ksk: np.ndarray  # int32 [N, t, n+1] (multiply-form, v=1 plane)
    # Optional 2-bit-bundled blind-rotation extension: TGSW(s_{2p} * s_{2p+1})
    # for each of the n/2 adjacent key-bit pairs ([n/2, (k+1)l, k+1, N]).
    # Halves the number of sequential CMUX rounds (the latency-bound part of
    # the bootstrap) at +50% evaluation-key size; produced by
    # ``keygen(..., bundle=2)``.  The TPU-native analogue of trading HBM for
    # fewer dependent loop stages; no reference counterpart (its TFHE backend
    # is fixed at one key bit per round).  The port's device path rejects it
    # (bootstrap.prepare_cloud_key).
    #
    # SECURITY NOTE: bk_pair publishes TGSW encryptions of PRODUCTS of secret
    # key bits (s_2p * s_2p+1) under the RLWE key — a strictly stronger
    # circular-security-style assumption than the baseline bootstrapping key
    # (which encrypts single bits).  This is the standard assumption of the
    # multi-bit blind-rotation literature (e.g. "bootstrapping in less than
    # 0.1 seconds"-family batched-CMUX schemes); opt into bundle=2 only if
    # that assumption is acceptable.  See the JAX package's docs/TFHE_COMPAT.md "Bundled keys".
    bk_pair: np.ndarray | None = None
    # Re-randomization pool: LWE encryptions of ZERO at alpha_enc
    # ([E, n+1]).  Adding a pool element to a ciphertext re-randomizes its
    # mask without changing the message — standard Regev public-key material
    # (no assumption beyond the LWE already made).  Used by the
    # majority-voted PBS (ops/encrypted.py:majority_pbs) to manufacture
    # vote copies whose mod-switch roundings are decorrelated.
    rerand: np.ndarray | None = None


def negacyclic_mul_binary_host(a: np.ndarray, key: np.ndarray, N: int) -> np.ndarray:
    """Exact ``a(X) * K(X) mod (X^N+1, 2^32)`` for binary K, batched over
    leading dims of ``a``.

    16-bit limb split keeps exact convolution values below 2^27, so a float64
    FFT (2N zero-padded cyclic, then negacyclic fold) rounds exactly — the
    same argument SPQLIOS-FMA relies on, but with 2^16 headroom to spare.
    """
    a_u = a.astype(np.uint32)
    kf = np.zeros(2 * N)
    kf[:N] = key.astype(np.float64)
    kfft = np.fft.rfft(kf)
    out = np.zeros(a.shape, dtype=np.int64)
    for limb_shift in (0, 16):
        limb = ((a_u >> np.uint32(limb_shift)) & np.uint32(0xFFFF)).astype(np.float64)
        buf = np.zeros(a.shape[:-1] + (2 * N,))
        buf[..., :N] = limb
        conv = np.fft.irfft(np.fft.rfft(buf, axis=-1) * kfft, axis=-1)
        vals = np.round(conv[..., :N] - conv[..., N:]).astype(np.int64)
        out += vals << limb_shift
    return out.astype(np.uint64).astype(np.uint32).astype(np.int32)


def _crt_host(residues, plan: ntt_mod.NttPlan) -> np.ndarray:
    """Exact signed CRT reconstruction in int64 (product of primes < 2^44)."""
    primes = plan.primes
    P = 1
    for p in primes:
        P *= p
    x = residues[0].astype(np.int64)
    mod_prod = primes[0]
    for i in range(1, len(primes)):
        p = primes[i]
        t = (residues[i] - x) % p * pow(mod_prod % p, p - 2, p) % p
        x = x + mod_prod * t
        mod_prod *= p
    return np.where(x >= P // 2, x - P, x)


def make_bootstrap_key(
    params: TfheParams, lwe_key: np.ndarray, rlwe_key: np.ndarray,
    rng: np.random.Generator,
) -> np.ndarray:
    """TGSW encryptions of the given bit vector (``lwe_key`` for the standard
    BK; pair products s_{2p}*s_{2p+1} for the bundled extension)."""
    N, l, k = params.N, params.l, params.k
    n = int(lwe_key.shape[0])
    assert k == 1
    rows = params.decomp_rows
    # TLWE encryptions of zero: uniform a, b = a*K + e
    a = rng.integers(0, 1 << 32, size=(n, rows, N), dtype=np.uint64)
    a = a.astype(np.uint32).astype(np.int32)
    e = gaussian_torus32(rng, params.alpha_bk, (n, rows, N))
    b = (negacyclic_mul_binary_host(a, rlwe_key, N) + e).astype(np.int32)
    bk = np.stack([a, b], axis=2)  # [n, rows, k+1, N]
    # add s_i * H
    h = (1 << (32 - (np.arange(1, l + 1)) * params.bg_bit)).astype(np.uint64)
    h = h.astype(np.uint32).astype(np.int32)  # [l]
    for bloc in range(k + 1):
        r0 = bloc * l
        bk[:, r0 : r0 + l, bloc, 0] = (
            bk[:, r0 : r0 + l, bloc, 0] + lwe_key[:, None] * h[None, :]
        ).astype(np.int32)
    return bk


def make_keyswitch_key(
    params: TfheParams, extracted_key: np.ndarray, lwe_key: np.ndarray,
    rng: np.random.Generator,
) -> np.ndarray:
    """Multiply-form key-switching key: ``ksk[i, j] = LWE_n(K_i * 2^(32-(j+1)*basebit))``.

    TFHE v1.1 tabulates all ``base`` digit values per (i, j) to avoid
    scalar-ciphertext multiplies; we store only the v=1 plane and multiply by
    the digit during switching — 8x smaller key and an MXU-friendly digit
    matmul, at the cost of noise scaled by E[digit] (still ~2^-16, far under
    the message slot; the mod-switch rounding noise dominates regardless).
    """
    N, t, n = params.N, params.ks_t, params.n
    shifts = (32 - (np.arange(1, t + 1)) * params.ks_basebit).astype(np.uint64)
    # messages [N, t] = K_i * 2^(32-(j+1)*basebit) mod 2^32
    msg = (extracted_key.astype(np.uint64)[:, None] << shifts[None, :])
    msg = msg.astype(np.uint32).astype(np.int32)
    a = rng.integers(0, 1 << 32, size=(N, t, n), dtype=np.uint64)
    a = a.astype(np.uint32).astype(np.int32)
    e = gaussian_torus32(rng, params.alpha_ks, (N, t))
    b = (a.astype(np.int64) * lwe_key.astype(np.int64)).sum(-1).astype(np.int32)
    b = (b + msg + e).astype(np.int32)
    return np.concatenate([a, b[..., None]], axis=-1)


def keygen(params: TfheParams, seed: int = 0, bundle: int = 1):
    """Generate (SecretKey, CloudKey) — the analogue of ``make keygen``
    (client/gen_secure_keyset.cpp:94-115, fixed seed there too).

    ``bundle=2`` additionally emits TGSW(s_{2p} * s_{2p+1}) pair entries
    (CloudKey.bk_pair) enabling the 2-bit bundled blind rotation.  The pair
    draws happen AFTER the standard material, so the base keys under a given
    seed are identical with or without bundling."""
    rng = np.random.default_rng(seed)
    lwe_key = lwe_key_gen(rng, params.n)
    rlwe_key = lwe_key_gen(rng, params.N)
    bk = make_bootstrap_key(params, lwe_key, rlwe_key, rng)
    ksk = make_keyswitch_key(params, rlwe_key, lwe_key, rng)
    bk_pair = None
    if bundle == 2:
        if params.n % 2:
            raise ValueError(f"bundle=2 needs even n, got {params.n}")
        pair_bits = (lwe_key[0::2] * lwe_key[1::2]).astype(lwe_key.dtype)
        bk_pair = make_bootstrap_key(params, pair_bits, rlwe_key, rng)
    elif bundle != 1:
        raise ValueError(f"unsupported bundle factor {bundle}")
    # re-randomization pool (drawn LAST so base material is seed-stable):
    # E encryptions of 0 — ~90 KB at small_v2 geometry, always included
    from .lwe import lwe_encrypt

    rerand = lwe_encrypt(
        lwe_key, np.zeros(RERAND_POOL, np.int32), params.alpha_enc, rng)
    return SecretKey(params, lwe_key, rlwe_key), CloudKey(
        params, bk, ksk, bk_pair, rerand=rerand)
