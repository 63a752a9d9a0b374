"""Analytic per-source bootstrap output-noise budget (VERDICT r4 #4).

Round 4 MEASURED that the reference's medium/large recipes
(client/gen_secure_keyset.cpp:9-45) decode the 4096-slot message space at
only 2.0 / 1.22 sigma (large: 8/32 real decode errors) — but the claim
"marginal-by-design in any implementation" was prose.  This module makes it
arithmetic: it derives the output-noise standard deviation of one gate
bootstrap, per source, from the parameter set and the engine's exact
discretization conventions (native/cggi_core.cpp; the JAX engine shares
them), so the measured sigmas are *predicted*, not just observed — and so
repaired recipes (medium_v2/large_v2) can be designed to a stated budget
instead of by trial.

Noise sources of one bootstrap output (an LWE sample whose phase is read
at msg_space granularity; "lsb" = 2^-32 of the torus):

1. **BK sample noise** (the only alpha-driven blind-rotation term): each
   CMUX accumulates (k+1)*l*N products digit*Z where Z has per-coefficient
   noise alpha_bk.  Balanced signed digits are ~uniform on [-Bg/2, Bg/2):
   E[d^2] = (Bg^2 - 1)/12.  Crucially the engine stores keys as torus32,
   so the EFFECTIVE variance is that of round(N(0, alpha*2^32)) in lsb —
   for alpha*2^32 << 1 (medium/large: alpha_bk = 2^-45/2^-46, i.e.
   2^-13/2^-14 lsb) the rounded samples are exactly zero and the term
   vanishes; a double-precision-FFT implementation (TFHE/SPQLIOS) keeps
   the continuous value.  Both conventions are reported.
2. **Gadget truncation**: the accumulator decomposition keeps l*bg_bit of
   32 bits via the dec_offset trick, leaving a reconstruction residue
   eps = -((a + offset) mod 2^(32-l*bg)) — one-sided, so its nonzero MEAN
   is shared by every coefficient of the error polynomial, and that
   correlated component convolves with the FULL secret key.  The
   per-round variance is therefore E[s_i] * (1 + k*N*E[s^2])^2 * Var(eps)
   — note the SQUARED key factor, (N/2)x the textbook independent-
   coefficient bound.  This is an empirically pinned form, not just
   theory: the r5 isolation sweep (results/noise_budget_validation.log)
   measured variance linear in n (175/350/700), exactly x64 per dropped
   3 precision bits (21/24/27), and the (1+N/2)^2 constant within 13%.
3. **KS decomposition truncation**: the extracted a-coefficients keep
   t*ks_basebit of 32 bits (rounded via the prec offset,
   cggi_core.cpp:288,403); the per-coefficient error multiplies the
   binary extracted key: N * E[K^2] * Var(eps_ks).  At the reference's
   t*basebit = 18 bits this is the DOMINANT medium/large term:
   2^14-lsb steps against a 2^20-lsb message slot.
4. **KS key noise**: multiply-form switching uses N*t key samples scaled
   by unsigned digits d in [0, base): the per-sample variance term is
   N * t * Var(d) * alphaeff(alpha_ks) with Var(d) = (base^2-1)/12 — the
   E[d]*e mean component is a PER-KEY constant shift, reported separately
   as ``ks_bias_sigma`` (it moves every output of a keyset equally; the
   isolation experiment resolves it as the run's mean, not its sigma).

The mod-switch rounding term (sqrt(n/24) rotation slots) is deliberately
NOT part of this budget: it perturbs which test-vector slot is read (a
*decision* error on the input), not the output amplitude; it is modeled
separately in TfheParams.mod_switch_sigma_units and runtime/ranges.py.

Validation: scripts/validate_noise_budget.py measures each source in
isolation on the native engine (KS-precision sweep, gadget-precision
sweep, alpha sweep) and the totals for all shipped sets; results in
PERFORMANCE.md round-5 and results/noise_budget_validation.log.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

from ..crypto.params import TfheParams

LSB = 2.0**-32  # one torus32 quantum, in torus units


def rounded_gaussian_var_lsb(alpha: float, kmax: int = 64) -> float:
    """Exact variance (in lsb^2) of round(N(0, alpha)) stored as torus32.

    For s = alpha*2^32 >> 1 this approaches s^2 + 1/12; for s << 1/2 it
    collapses to ~0 (every draw rounds to zero) — the discretization
    cliff that silently de-noises medium/large's sub-lsb alphas."""
    s = alpha * 2.0**32
    if s == 0.0:
        return 0.0
    if s > 16.0:  # discretization correction is exactly +1/12 in this regime
        return s * s + 1.0 / 12.0
    var = 0.0
    top = max(2, int(8 * s) + 2)
    for k in range(1, min(top, kmax) + 1):
        p = 0.5 * (math.erfc((k - 0.5) / (s * math.sqrt(2.0)))
                   - math.erfc((k + 0.5) / (s * math.sqrt(2.0))))
        var += 2.0 * k * k * p
    return var


@dataclasses.dataclass
class NoiseBudget:
    """Per-source output-noise variances (lsb^2) and derived summary."""

    params: TfheParams
    bk_noise: float
    gadget: float
    ks_trunc: float
    ks_noise: float
    # sigma (lsb) of the PER-KEY constant output shift from E[d]*e in the
    # key switch — not part of total_var (it is a fixed bias of a keyset,
    # not per-bootstrap noise), surfaced for decode-budget accounting
    ks_bias_sigma: float = 0.0

    @property
    def total_var(self) -> float:
        return self.bk_noise + self.gadget + self.ks_trunc + self.ks_noise

    def sigma_slots(self) -> float:
        """Output noise sigma in message-space slots (the unit the
        validation harness reports)."""
        return math.sqrt(self.total_var) * LSB * self.params.msg_space

    def sigma_slots_of(self, term: str) -> float:
        return math.sqrt(getattr(self, term)) * LSB * self.params.msg_space

    def budget_sigma_multiple(self) -> float:
        """How many sigmas fit in the +-0.5-slot decode budget."""
        s = self.sigma_slots()
        return float("inf") if s == 0 else 0.5 / s

    def flip_probability(self) -> float:
        m = self.budget_sigma_multiple()
        return 0.0 if math.isinf(m) else math.erfc(m / math.sqrt(2.0))

    def table(self) -> Dict[str, float]:
        return {
            "bk_noise_slots": self.sigma_slots_of("bk_noise"),
            "gadget_slots": self.sigma_slots_of("gadget"),
            "ks_trunc_slots": self.sigma_slots_of("ks_trunc"),
            "ks_noise_slots": self.sigma_slots_of("ks_noise"),
            "ks_bias_slots": self.ks_bias_sigma * LSB * self.params.msg_space,
            "total_slots": self.sigma_slots(),
            "budget_sigma_multiple": self.budget_sigma_multiple(),
            "flip_probability": self.flip_probability(),
        }


def budget(p: TfheParams, engine: str = "discrete",
           n_rounds: int | None = None) -> NoiseBudget:
    """Compute the per-source budget for one gate bootstrap.

    ``engine="discrete"``: torus32-stored keys (this repo's engines) — the
    sub-lsb alpha cliff applies.  ``engine="continuous"``: ideal
    real-torus keys (the TFHE/SPQLIOS convention the reference links) —
    alpha enters at face value.  ``n_rounds`` overrides the CMUX round
    count (bundle=2 halves it)."""
    if engine == "discrete":
        a_bk = rounded_gaussian_var_lsb(p.alpha_bk)
        a_ks = rounded_gaussian_var_lsb(p.alpha_ks)
    elif engine == "continuous":
        a_bk = (p.alpha_bk * 2.0**32) ** 2
        a_ks = (p.alpha_ks * 2.0**32) ** 2
    else:
        raise ValueError(engine)
    rounds = p.n if n_rounds is None else n_rounds
    e_s2 = 0.5  # binary secret keys: E[s^2] = E[K^2] = 1/2

    # 1. BK sample noise: rounds * (k+1)*l*N * E[d^2] * Var(Z)
    e_d2 = (p.bg ** 2 - 1) / 12.0  # balanced digits, discrete uniform
    bk_noise = rounds * (p.k + 1) * p.l * p.N * e_d2 * a_bk

    # 2. gadget truncation: the one-sided residue's correlated mean
    # convolves with the full key -> SQUARED key factor (module docstring;
    # pinned by the r5 isolation sweep, linear in n and x64 per 3 bits)
    g_bits = 32 - p.l * p.bg_bit
    eps_g = (2.0 ** (2 * g_bits)) / 12.0 if g_bits > 0 else 0.0
    gadget = rounds * 0.5 * (1.0 + p.k * p.N * e_s2) ** 2 * eps_g

    # 3. KS decomposition truncation (cggi_core.cpp:288,403: rounded).
    # A full-precision KS (t*basebit >= 32) decomposes the int32 exactly:
    # zero truncation error, not a residual lsb.
    k_bits = 32 - p.ks_t * p.ks_basebit
    eps_k = (2.0 ** (2 * k_bits)) / 12.0 if k_bits > 0 else 0.0
    ks_trunc = p.k * p.N * e_s2 * eps_k

    # 4. KS key noise: unsigned digits uniform on [0, base) -> variance
    # term with Var(d); the E[d] mean component is a per-key constant
    b = p.ks_base
    var_d = (b * b - 1) / 12.0
    mean_d = (b - 1) / 2.0
    ks_noise = p.k * p.N * p.ks_t * var_d * a_ks
    ks_bias = mean_d * math.sqrt(p.k * p.N * p.ks_t * a_ks)

    return NoiseBudget(p, bk_noise, gadget, ks_trunc, ks_noise, ks_bias)
