"""Certified activation-range analysis for PBS validity guards.

Every programmable bootstrap has a domain of validity on its input phase:

- sign / maxpool-OR:        |v| < msg_space/2   (anti-periodic test vector)
- relu, quarter-range:      |v| < msg_space/4   (half-torus trick, 1 PBS)
- relu, full-range (FDFB):  |v| < msg_space/2   (odd/even split, 3 PBS)

The reference never checks this: its leveled accumulation silently wraps
beyond the 4096 message space (lib/BinFunc.cpp:166) and relies on BNN
statistics to stay inside.  Its tracked ``up_bound`` (lib/Layer.h:113-127)
is bit-width bookkeeping, not a sound value bound (it is off by 2x in both
directions on the shipped nets).  We instead compute a CERTIFIED per-channel
interval from the actual ternary weights (exact interval arithmetic), and
optionally a measured bound from a calibration run of the plaintext oracle
(``calibrate_ranges``); ``resolve_pbs_ranges`` picks the relu implementation
per layer and fails loudly when no implementation is valid.

A copy of the JAX package's module: numpy only, except that
``calibrate_ranges`` runs the torch plaintext oracle.  Where the JAX package
reads ``REDSEC_*`` environment variables, the port takes an argument:
``center`` (``REDSEC_CENTER``), ``tiebreak`` (``REDSEC_TIEBREAK``),
``gain_mode`` (``REDSEC_GAIN_MODE``), ``cascade_w`` (``REDSEC_CASCADE_W``),
``max_flip`` (``REDSEC_MAX_FLIP``), ``relu_mode``, ``majority_ks`` and
``escalate``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.spec import Activation, LayerPlan, ModelPlan

# Default weight of the modeled upstream-flip cascade in flip-optimal gain
# selection: the independent-flip Poisson model overestimates measured
# cascade at depth ~2-4x (flips are spatially correlated and partially
# cancel); 0 would be the pure local optimum.  The JAX package's default,
# from its simulator sweep (scripts/predict_agreement.py).
CASCADE_W = 0.25
# Default largest predicted local per-activation flip rate the strict guard
# accepts.
MAX_FLIP = 0.05
GAIN_MODES = ("flip", "max")


@dataclasses.dataclass
class PbsRange:
    """Range facts for one layer's PBS boundary (None when the layer has no
    bootstrap, i.e. a pure add-bias layer)."""

    certified: Optional[int]  # sound bound on |pre-PBS value| incl. bias
    measured: Optional[int]  # from calibrate_ranges, if run
    relu_mode: Optional[str] = None  # "quarter" | "full" for RELU layers
    # Per-edge encoding gains (encrypted domain only; powers of two).  The
    # layer's inputs arrive scaled by in_gain and its activations leave
    # scaled by out_gain, so the NEXT bootstrap's decision margins grow
    # out_gain x while the mod-switch noise (fixed in absolute units,
    # PERFORMANCE.md) does not.  The reference cannot do this: its message
    # encoding is hardwired to +-1 (lib/BinOps_enc.cpp:182-186).
    in_gain: int = 1
    out_gain: int = 1
    # Per-channel re-encoding shift [C] (ungained units) applied to the
    # ciphertext before this layer's PBS, folded back out by the test
    # vectors: centers an asymmetric pre-activation range so the budget
    # covers (hi-lo)/2 instead of max(|lo|,|hi|).  RELU layers only (a sign
    # boundary is pinned at 0 and cannot shift).
    center: Optional[np.ndarray] = None
    # Parity tie-break mask [H, W, C] (bool) for SIGN layers: positions whose
    # calibrated pre-activation parity is all-even include exact-zero phases
    # (a coin flip under mod-switch noise); adding +in_gain to the phase
    # there gives ties margin g instead of 0 and matches the oracle's
    # sign(0)=+1 exactly for every achievable (even) value.  The reference
    # has no analogue — its +-1 encoding leaves BNN parity ties at zero
    # phase (lib/BinOps_enc.cpp:182-186).
    tie_break: Optional[np.ndarray] = None
    # Predicted per-activation flip rate at this PBS boundary under the
    # mod-switch noise model (set by flip-optimal gain selection).
    # expected_flip_rate includes the modeled upstream cascade;
    # local_flip_rate is the same boundary with exact inputs (lam=0) — the
    # strict guard judges the local rate (cascade is a property of the net,
    # not of the message-space fit).
    expected_flip_rate: Optional[float] = None
    local_flip_rate: Optional[float] = None
    # The local rate an escalated boundary is judged at: recomputed from its
    # margin histogram at the second key's mod-switch sigma.
    escalated_local_rate: Optional[float] = None

    def effective(self) -> Optional[int]:
        return self.measured if self.measured is not None else self.certified

    def scaled(self) -> Optional[int]:
        b = self.effective()
        return None if b is None else b * self.in_gain


def _conv_interval(plan, lo: np.ndarray, hi: np.ndarray):
    """Per-output-channel interval of a ternary conv/fc given per-input-channel
    input intervals.  Padding taps contribute exact zeros, so the input
    interval is first widened to include 0 when the conv pads."""
    w = plan.weights.astype(np.int64)  # [wh, ww, cin, cout]
    if plan.offset != (0, 0):
        lo, hi = np.minimum(lo, 0), np.maximum(hi, 0)
    wp = np.maximum(w, 0).sum(axis=(0, 1))  # [cin, cout]
    wn = np.maximum(-w, 0).sum(axis=(0, 1))
    out_lo = lo @ wp - hi @ wn
    out_hi = hi @ wp - lo @ wn
    if plan.neg_correction is not None:
        out_lo = out_lo - plan.neg_correction
        out_hi = out_hi - plan.neg_correction
    return out_lo, out_hi


def _maxpool_bound(layer: LayerPlan, msg_space: int) -> int:
    """Worst |pre| of the window-OR bootstrap: all-true window of +-V signs
    plus the (count-1)V bias = (2w-1)V < msg_space/2 by construction of
    V = msg_space/(4w) (ops/encrypted.py:maxpool_sign_value)."""
    w = layer.maxpool.window[0] * layer.maxpool.window[1]
    v = max(1, msg_space // (4 * w))
    return (2 * w - 1) * v


def _layer_intervals(layer: LayerPlan, lo: np.ndarray, hi: np.ndarray):
    """Propagate per-channel intervals through one layer; returns
    (pre_pbs_bound or None, out_lo, out_hi)."""
    if layer.conv is not None:
        if layer.conv.flatten:
            reps = layer.conv.in_dep // lo.shape[0]
            lo, hi = np.tile(lo, reps), np.tile(hi, reps)
        lo, hi = _conv_interval(layer.conv, lo, hi)
    if layer.sumpool is not None:
        area = layer.sumpool.window[0] * layer.sumpool.window[1]
        lo, hi = lo * area, hi * area

    q = layer.quant
    bound: Optional[int] = None
    if q.mode == Activation.SIGN:
        b = q.bias.astype(np.int64)
        bound = int(np.maximum(np.abs(lo + b), np.abs(hi + b)).max())
        lo = np.full(q.depth, -1, np.int64)
        hi = np.ones(q.depth, np.int64)
    elif q.mode == Activation.RELU:
        # relu's bias folds into the test vector; the ciphertext input is the
        # raw accumulated value (ops/encrypted.py relu_test_vectors)
        bound = int(np.maximum(np.abs(lo), np.abs(hi)).max())
        top = (1 << q.shift_bits) - 1
        lo = np.zeros(q.depth, np.int64)
        hi = np.full(q.depth, top, np.int64)
    else:  # NONE: leveled bias add only, no bootstrap; bound still
        # matters (decrypt range / downstream gain selection)
        b = q.bias.astype(np.int64)
        lo, hi = lo + b, hi + b
        bound = int(np.maximum(np.abs(lo), np.abs(hi)).max())

    # maxpool's OR bootstrap bound is safe by construction and accounted in
    # resolve_pbs_ranges via _maxpool_bound (it needs msg_space)
    return bound, lo, hi


def certified_pbs_bounds(model: ModelPlan) -> List[Optional[int]]:
    """Sound per-layer bounds on |pre-PBS value| entering the QUANT
    bootstrap, from exact interval arithmetic over the loaded weights
    (None for bootstrap-free layers).  Maxpool OR bounds are handled
    separately (safe by construction, _maxpool_bound)."""
    b0 = int(model.in_dim.up_bound)
    lo = np.full(model.in_dim.in_dep, -b0, np.int64)
    hi = np.full(model.in_dim.in_dep, b0, np.int64)
    out = []
    for layer in model.layers:
        bound, lo, hi = _layer_intervals(layer, lo, hi)
        out.append(bound)
    return out


def calibrate_ranges(model: ModelPlan, images: np.ndarray,
                     device: str = "cuda") -> List[Optional[int]]:
    """Measure actual max |pre-PBS value| per layer by running the plaintext
    oracle over a calibration set; stores the result on each LayerPlan
    (``measured_pre_bound``, ``measured_chan_interval``, ``sign_calib``) so
    later ``build_encrypted_forward`` calls pick it up.  Mirrors the
    reference's implicit contract: its 4096 leveled budget is validated only
    by observed BNN statistics (REDsec paper §IV)."""
    from . import ptxt as rp

    x = torch.as_tensor(np.asarray(images, np.int32), device=resolve_device(device))
    bounds: List[Optional[int]] = []
    for layer in model.layers:
        pre = x
        if layer.conv is not None:
            pre = rp.conv_ptxt(layer.conv, pre)
        if layer.sumpool is not None:
            pre = rp.sumpool_ptxt(layer.sumpool, pre)
        pre = pre.cpu().numpy()
        q = layer.quant
        bound = None
        if q.mode == Activation.SIGN or q.mode == Activation.NONE:
            b = pre.astype(np.int64) + q.bias.reshape(1, 1, 1, -1)
            bound = int(np.abs(b).max())
            if q.mode == Activation.NONE:
                # per-channel output interval: feeds final-layer decrypt
                # centering (resolve_pbs_ranges) when logits overflow the
                # +-msg_space/2 decode range
                layer.measured_chan_interval = (
                    b.min(axis=(0, 1, 2)), b.max(axis=(0, 1, 2)))
            if q.mode == Activation.SIGN:
                # parity tie-break mask + margin histograms for flip-optimal
                # gain selection (see PbsRange.tie_break).  For pure-binary
                # layers the pre+bias parity is deterministic per position
                # (sum of K +-1 terms == K mod 2), so an all-even observation
                # over the calibration set is exact, not statistical.
                mask = (b % 2 == 0).all(axis=0)  # [H, W, C]
                cap = 1 << 14
                m_tb = np.abs(np.clip(b + mask[None], -cap, cap)).reshape(-1)
                m_raw = np.abs(np.clip(b, -cap, cap)).reshape(-1)
                layer.sign_calib = {
                    "mask": mask,
                    "hist": np.bincount(m_tb, minlength=cap + 2),
                    "hist_raw": np.bincount(m_raw, minlength=cap + 2),
                }
        elif q.mode == Activation.RELU:
            bound = int(np.abs(pre).max())
            layer.measured_chan_interval = (
                pre.min(axis=(0, 1, 2)).astype(np.int64),
                pre.max(axis=(0, 1, 2)).astype(np.int64),
            )
        layer.measured_pre_bound = bound
        bounds.append(bound)
        x = rp.layer_forward_ptxt(layer, x)
    return bounds


def _phi(z: np.ndarray) -> np.ndarray:
    """Standard normal CDF, vectorized (Abramowitz-Stegun 7.1.26 erf
    approximation, |err| < 1.5e-7 — flip-rate estimates need ~1e-5)."""
    x = np.asarray(z, np.float64) / np.sqrt(2.0)
    s = np.sign(x)
    a = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    erf = s * (1.0 - poly * np.exp(-a * a))
    return 0.5 * (1.0 + erf)


def _fanin(layer: LayerPlan) -> float:
    """Mean +-1-input fan-in of a layer's pre-PBS accumulation (cascade
    sensitivity): mean over outputs of sum|w| taps, x sumpool area."""
    f = 1.0
    if layer.conv is not None:
        w = np.abs(layer.conv.weights.astype(np.int64)).sum(axis=(0, 1, 2))
        f = float(w.mean())
    if layer.sumpool is not None:
        f *= layer.sumpool.window[0] * layer.sumpool.window[1]
    return f


def _flip_optimal_gain(hist: np.ndarray, sigma: float, half: int,
                       lam: float = 0.0, gmax: Optional[int] = None,
                       g_fixed: Optional[int] = None):
    """Integer encoding gain minimizing PREDICTED flips at a sign boundary,
    including upstream-flip CASCADE.

    ``hist[m]`` counts calibrated activations at phase margin m (in oracle
    units, tie-break applied).  Under gain g the phase is g*m plus two noise
    terms: the fixed mod-switch noise N(0, sigma) and the cascade shift from
    upstream activation flips — each of the fan-in's ~F +-1 inputs is wrong
    w.p. p (vs the noiseless calibration trace) and toggles the sum by
    +-2*g.  With k ~ Poisson(lam = F*p) flipped inputs the phase noise is
    ~N(0, sigma_k^2), sigma_k^2 = sigma^2 + 4*k*g^2, and

        E(g) = sum_m hist[m] * sum_k pois(k; lam) *
               [ Phi(-g*m / sigma_k)          (noise/cascade flip)
               + Phi((g*m - half) / sigma_k) ] (budget wrap)

    Cascade is why a pure local optimum over-gains: pushing the calibrated
    max to the budget edge leaves no room for cascade shifts, so upstream
    flips turn large confident activations into wraps.  As g grows the
    cascade term approaches Phi(-m / (2*sqrt(k))) — gains cannot beat
    cascade, only local noise — which naturally caps the chosen g.
    Returns (g, expected_flip_rate).  m=0 residual ties flip at 1/2 and add
    a floor."""
    total = float(hist.sum())
    if total <= 0 or sigma <= 0:
        return 1, 0.0
    nzm = np.nonzero(hist)[0].astype(np.float64)
    cnt = hist[np.nonzero(hist)[0]].astype(np.float64)
    # Poisson mixture over flipped-input counts (collapse to the mean for
    # large lam, where the mixture is indistinguishable from its center)
    if lam < 30.0:
        K = int(lam + 6 * np.sqrt(lam + 1)) + 1
        ks = np.arange(K + 1, dtype=np.float64)
        logw = ks * np.log(lam + 1e-300) - lam - np.cumsum(
            np.log(np.maximum(ks, 1.0)))
        w = np.exp(logw)
        w /= w.sum()
    else:
        ks = np.array([lam])
        w = np.array([1.0])
    best_g, best_e = 1, float("inf")
    cands = [int(g_fixed)] if g_fixed else range(1, int(gmax or half))
    for g in cands:
        sig_k = np.sqrt(sigma**2 + 4.0 * ks * g * g)  # [K]
        smax = float(sig_k[-1])
        # windows outside which the two Phi terms are 0 or 1
        t_hi = (half + 6.0 * smax) / g
        sel = nzm < t_hi
        ms, cs = nzm[sel], cnt[sel]
        wraps_sure = total - float(cs.sum())  # g*m far beyond half
        z_noise = -(g * ms[None, :]) / sig_k[:, None]          # [K, M]
        z_wrap = (g * ms[None, :] - half) / sig_k[:, None]
        pf = np.minimum(_phi(z_noise) + _phi(z_wrap), 1.0)
        e = wraps_sure + float((w @ pf) @ cs)
        if e < best_e - 1e-12:
            best_g, best_e = g, e
    return best_g, best_e / total


def resolve_pbs_ranges(
    model: ModelPlan, msg_space: int, strict: bool = True,
    gains: bool = True, gain_headroom: float = 2.0,
    input_gain: bool = False, sigma_units: Optional[float] = None,
    relu_mode: Optional[str] = None, majority_ks: Optional[Dict[int, int]] = None,
    escalate: Optional[Tuple[Set[int], object]] = None,
    center: bool = True, tiebreak: bool = True, gain_mode: str = "flip",
    cascade_w: float = CASCADE_W, max_flip: float = MAX_FLIP,
) -> Dict[int, PbsRange]:
    """Pick the relu implementation, per-edge encoding gains, and guard
    every PBS boundary.

    Returns {layer_index: PbsRange}.  Raises ValueError when a scaled bound
    exceeds the widest valid domain (msg_space/2) and ``strict``; with
    strict=False the widest implementation is used anyway (the same
    silent-wrap behavior the reference always has, lib/BinFunc.cpp:166).

    Gains: each activation layer's output encoding is scaled by the largest
    power of two keeping the NEXT layer's bound within
    msg_space/2 / gain_headroom.  The mod-switch noise that dominates
    end-to-end accuracy (~sqrt(n/24) rotation slots, PERFORMANCE.md) is
    fixed in absolute message units, so a gain of g multiplies every sign /
    relu decision margin by g at zero extra bootstraps.  Measured on
    sign1024x1: 59% of hidden-layer pre-activations sit within +-1 sigma of
    the boundary at unit encoding; at g=8 almost none do.  Gains need
    calibrated or tight certified bounds — with only loose worst-case
    bounds they stay 1 and behavior is unchanged.

    ``relu_mode``: "quarter" or "full" forces that relu implementation on
    every relu layer (None: chosen per layer from the scaled bound).  "full"
    is 3x the relu PBS cost, but disagreements from mod-switch noise near the
    quarter-range seam disappear.

    The flip-rate guard judges a boundary as it will run: ``majority_ks``
    ({layer: k}, the JAX package's ``REDSEC_MAJORITY*``) suppresses a voted
    boundary's rate to its binomial tail, and ``escalate`` = (layers,
    TfheParams of the second key; ``REDSEC_ESCALATE``) judges those layers at
    the second key's mod-switch sigma.

    The calibration knobs, each the JAX package's environment variable of the
    same name: ``center`` False (``REDSEC_CENTER=0``) assigns no relu or
    final-layer centering; ``tiebreak`` False (``REDSEC_TIEBREAK=0``) no
    parity tie-break; ``gain_mode`` "max" (``REDSEC_GAIN_MODE=max``) keeps the
    max-bound power-of-two gains where flip-optimal gains would be chosen;
    ``cascade_w`` (``REDSEC_CASCADE_W``) scales the modeled upstream-flip
    cascade; ``max_flip`` (``REDSEC_MAX_FLIP``) is the largest predicted local
    flip rate the strict guard accepts."""
    if relu_mode not in (None, "quarter", "full"):
        raise ValueError(f"relu_mode must be None, 'quarter' or 'full', got {relu_mode!r}")
    if gain_mode not in GAIN_MODES:
        raise ValueError(f"gain_mode must be one of {GAIN_MODES}, got {gain_mode!r}")
    certified = certified_pbs_bounds(model)
    out: Dict[int, PbsRange] = {}
    quarter, half = msg_space // 4, msg_space // 2
    ranges = []
    for i, layer in enumerate(model.layers):
        r = PbsRange(certified=certified[i], measured=layer.measured_pre_bound)
        ranges.append(r)
        out[i] = r

    # Per-channel centering for relu layers (``center=False`` disables): the
    # staircase is translation-foldable (unlike sign's pinned boundary), so
    # an asymmetric calibrated range [lo, hi] re-encodes as +-(hi-lo)/2 via
    # an exact noiseless shift — this is what makes relu1024x3 (|v|max 2690
    # at 100 images, beyond the +-2048 budget) runnable at all, and roughly
    # doubles the gain budget on the other relu edges.  The reference has no
    # analogue: its relu chain wraps silently (lib/IntFunc.cpp:860-973).
    if center:
        # FINAL-layer decrypt centering: a bias-only last layer's logits can
        # exceed the +-msg_space/2 decode range (relu1024x3: -2562 at 32
        # images) and wrap DETERMINISTICALLY at decrypt — the reference has
        # the same silent failure (decrypt_image.cpp:50-59 recenters
        # blindly).  A per-class shift s_c (public metadata, applied as a
        # noiseless body add) keeps every class in range; the decryptor
        # subtracts it back out (decrypt_scores(centers=...)).  Only the
        # LAST layer is eligible — a mid-net shift would propagate into
        # downstream weights.
        last = len(model.layers) - 1
        Lf = model.layers[last]
        if (Lf.quant.mode == Activation.NONE
                and Lf.measured_chan_interval is not None):
            lo, hi = Lf.measured_chan_interval
            ub = int(np.maximum(np.abs(lo), np.abs(hi)).max())
            s = -((lo + hi) // 2)
            s = s - (s % 2)  # keep the all-centers-slot-aligned invariant
            # engage only when the uncentered range threatens the decode
            # budget (wrap territory, or it would cap the gain schedule) —
            # an unnecessary center perturbs gain selection for no benefit
            if np.any(s != 0) and ub >= half / gain_headroom:
                ranges[last].center = s.astype(np.int64)
                ranges[last].measured = int(
                    np.maximum(np.abs(lo + s), np.abs(hi + s)).max())
        for i, layer in enumerate(model.layers):
            if (layer.quant.mode == Activation.RELU
                    and layer.measured_chan_interval is not None):
                lo, hi = layer.measured_chan_interval
                s = -((lo + hi) // 2)
                # align shifts to the 2N rotation grid (msg_space/2N units,
                # = 2 for every shipped set): a sub-slot phase shift would
                # change mod-switch rounding vs the uncentered grid and
                # break the exact tv fold (tests/test_noise_sim.py)
                s = s - (s % 2)
                if np.any(s != 0):
                    ranges[i].center = s.astype(np.int64)
                    ranges[i].measured = int(
                        np.maximum(np.abs(lo + s), np.abs(hi + s)).max())

    # Parity tie-break (``tiebreak=False`` disables): positions whose
    # calibrated pre+bias values are all even can realize an exact-zero
    # phase — a coin flip under mod-switch noise.  Shifting those phases by
    # +in_gain (folded exactly: the oracle's sign(0)=+1 and every even value
    # keeps its sign) converts zero margins to full-gain margins.
    if tiebreak:
        for i, layer in enumerate(model.layers):
            sc = layer.sign_calib
            if (layer.quant.mode == Activation.SIGN and sc is not None
                    and bool(sc["mask"].any())):
                ranges[i].tie_break = sc["mask"]

    # Flip-optimal gain selection (``gain_mode="max"`` restores the
    # max-bound power-of-two rule): when a sign layer has calibration
    # histograms and the caller supplied the mod-switch sigma, pick the
    # INTEGER gain minimizing predicted flips (noise + wraps) instead of the
    # largest power of two under the max bound — see _flip_optimal_gain.
    flip_mode = (gains and sigma_units is not None and sigma_units > 0
                 and gain_mode == "flip")

    def _sign_hist(j: int):
        sc = model.layers[j].sign_calib
        if sc is None or model.layers[j].quant.mode != Activation.SIGN:
            return None
        return sc["hist"] if (tiebreak and ranges[j].tie_break is not None) \
            else sc["hist_raw"]

    if gains:
        # choose out_gain of layer i from the bound of layer i+1 (whose
        # inputs are layer i's activations); bounds are linear in in_gain
        budget = half / gain_headroom
        if input_gain:
            # model-INPUT encoding gain: the client encrypts pixels scaled by
            # g0 (public metadata, exact re-encoding), multiplying the first
            # bootstrap's decision margins by g0 — reaches the edge no
            # layer-side gain can (the pixel edge has no bootstrap to
            # re-encode at).  Callers must scale the encrypted pixels by
            # info[0].in_gain (runtime.encrypted forward exposes it).
            # the gain propagates through leading bias-only layers to the
            # first PBS; that layer's bound is the constraint
            k = next(
                (j for j, L in enumerate(model.layers)
                 if L.quant.mode != Activation.NONE or L.maxpool is not None),
                None)
            h0 = _sign_hist(k) if (flip_mode and k is not None) else None
            if h0 is not None:
                # model-input edge: pixels are exact (no upstream flips)
                g, er = _flip_optimal_gain(h0, sigma_units, half, lam=0.0)
                ranges[0].in_gain = g
                ranges[k].expected_flip_rate = er
                ranges[k].local_flip_rate = er
            else:
                b0 = ranges[k].effective() if k is not None else None
                if b0 and b0 > 0:
                    g = 1
                    while b0 * (g * 2) <= budget:
                        g *= 2
                    ranges[0].in_gain = g
        # cascade recursion seed: the first PBS layer's own flip rate at its
        # resolved in_gain (flip-optimal above, or 1 without input_gain)
        p_cur = 0.0
        if flip_mode:
            k0 = next(
                (j for j, L in enumerate(model.layers)
                 if L.quant.mode != Activation.NONE or L.maxpool is not None),
                None)
            if k0 is not None:
                if ranges[k0].expected_flip_rate is not None:
                    p_cur = ranges[k0].expected_flip_rate
                else:
                    hk = _sign_hist(k0)
                    if hk is not None:
                        _, p_cur = _flip_optimal_gain(
                            hk, sigma_units, half, lam=0.0,
                            g_fixed=ranges[k0].in_gain)
                        ranges[k0].expected_flip_rate = p_cur

        for i in range(len(model.layers) - 1):
            q = model.layers[i].quant
            if q.mode == Activation.NONE and model.layers[i].maxpool is None:
                continue  # bootstrap-free layer: encoding passes through
            h = _sign_hist(i + 1) if flip_mode else None
            if h is not None:
                # cascade_w scales the modeled upstream-flip cascade (see
                # CASCADE_W); 0 = pure local optimum
                lam = cascade_w * _fanin(model.layers[i + 1]) * p_cur
                g, er = _flip_optimal_gain(h, sigma_units, half, lam)
                ranges[i].out_gain = g
                ranges[i + 1].in_gain = g
                ranges[i + 1].expected_flip_rate = er
                # local_flip_rate judges the FIT of the message space: the
                # best achievable rate with exact inputs (lam=0, gain free)
                # — NOT the rate at the cascade-chosen gain, which trades
                # local flips for cascade robustness on purpose
                _, er_local = _flip_optimal_gain(h, sigma_units, half,
                                                 lam=0.0)
                ranges[i + 1].local_flip_rate = er_local
                p_cur = er
                continue
            nxt = ranges[i + 1].effective()
            # the final bias-only layer has no bootstrap but its decrypt
            # range must stay inside the message space too
            if nxt is None or nxt <= 0:
                continue
            g = 1
            while nxt * (g * 2) <= budget:
                g *= 2
            ranges[i].out_gain = g
            ranges[i + 1].in_gain = g
        # bootstrap-free (bias-only) layers don't re-encode: their outputs
        # carry the input gain through (the final scores' out_gain)
        for i, layer in enumerate(model.layers):
            q = layer.quant
            if q.mode == Activation.NONE and layer.maxpool is None:
                ranges[i].out_gain = ranges[i].in_gain
                if i + 1 < len(model.layers):
                    ranges[i + 1].in_gain = ranges[i].out_gain

    for i, layer in enumerate(model.layers):
        r = ranges[i]
        q = layer.quant
        eff = r.scaled()
        if q.mode == Activation.RELU:
            r.relu_mode = relu_mode or (
                "quarter" if (eff is not None and eff < quarter) else "full")
        if r.expected_flip_rate is not None:
            # flip-optimal gain: wraps beyond the budget are DELIBERATE and
            # accounted in expected_flip_rate — the max-bound guard is
            # replaced by a bound on the predicted LOCAL flip rate (the
            # cascade share is a property of the net, not of the fit)
            local = (r.local_flip_rate if r.local_flip_rate is not None
                     else r.expected_flip_rate)
            if escalate is not None and i in escalate[0] and local is not None:
                # recompute the rate from the boundary's own margin histogram
                # at the run's gain and the second key's sigma: margin-limited
                # boundaries are sigma-insensitive, so halving the rate with
                # the sigma would understate it.  Without a histogram (relu
                # staircase, maxpool) the unescalated rate stays: a sound
                # bound, since a smaller sigma cannot raise it.
                h = _sign_hist(i)
                if h is not None:
                    ep = escalate[1]
                    _, local = _flip_optimal_gain(h, ep.mod_switch_sigma_units(),
                                                  ep.msg_space // 2, lam=0.0,
                                                  g_fixed=max(ranges[i].in_gain, 1))
                    r.escalated_local_rate = local
            k = (majority_ks or {}).get(i, 1)
            if k > 1 and local is not None:
                m = (k + 1) // 2
                local = float(sum(math.comb(k, j) * local**j * (1.0 - local)**(k - j)
                                  for j in range(m, k + 1)))
            if strict and local is not None and local > max_flip:
                raise ValueError(
                    f"layer {i} ({model.spec.name}): predicted per-activation "
                    f"flip rate {local:.3f} exceeds "
                    f"REDSEC_MAX_FLIP={max_flip} even at the flip-optimal "
                    f"encoding gain — the message space cannot hold this "
                    f"layer's margins against the mod-switch noise; use a "
                    f"larger-N parameter set or strict=False")
            continue
        if eff is not None and eff >= half and (
            q.mode == Activation.RELU or q.mode == Activation.SIGN
        ):
            msg = (
                f"layer {i} ({model.spec.name}): pre-bootstrap bound {eff} "
                f"(x{r.in_gain} encoding gain) exceeds the message-space "
                f"budget +-{half} "
                f"({'measured' if r.measured is not None else 'certified worst-case'}); "
                f"run runtime.ranges.calibrate_ranges for a data-driven bound, "
                f"use a larger msg_space parameter set, or pass "
                f"range_check=False to accept reference-style silent wrapping"
            )
            if strict:
                raise ValueError(msg)
    return out
