"""Monte-Carlo noise simulator for the encrypted pipeline.

Predicts encrypted-vs-oracle agreement WITHOUT touching the device: runs the
plaintext network in the ENCODED domain (per-edge gains, bias folding,
maxpool-OR, relu staircase test vectors — mirroring ops/encrypted.py exactly)
and injects the two real noise sources at every PBS boundary:

- mod-switch rounding: the n mask coefficients round to the 2N rotation grid;
  sigma = params.mod_switch_sigma_units() (the dominant term; identical in
  the reference, lib/BinOps_enc.cpp:182-186 -> tfhe_bootstrap_FFT).
- accumulated ciphertext noise: each PBS output carries ~sigma_pbs slots of
  decomposition noise (measured per parameter set, PERFORMANCE.md); a leveled
  fan-in of f sums f of those in quadrature.

The PBS itself is simulated EXACTLY: the noisy phase is switched to the 2N
grid and the layer's real test vector (sign / per-channel staircase / FDFB
odd+even+seam / window-OR) is read negacyclically — so range WRAPS beyond
+-msg_space/2 reproduce the true failure mode, not a soft approximation.

Used to (a) localize which bootstrap boundary flips first on a disagreeing
net (VERDICT r2 #1), (b) choose gain/centering operating points offline, and
(c) derive expected flip rates for the noise-budget notes. Validated against
the round-2 measured TPU agreements (tests/test_noise_sim.py).

The port's copy: the noise draws and every host step are the JAX package's
numpy calls in the same order, so a rollout from the same generator gives the
same numbers.  Where the JAX package runs its plaintext ops (conv, sumpool,
patch gather) in ``jax.numpy``, this runs the port's torch ops
(``runtime/ptxt.py``) on ``device`` (default ``"cuda"``; ``"cpu"`` on request),
int32 with the same wraparound.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..crypto.bootstrap import const_test_vector
from ..crypto.params import TfheParams
from ..device import resolve_device
from ..models.spec import Activation, ModelPlan
from ..ops.encrypted import maxpool_sign_value, relu_fdfb_test_vectors, relu_test_vectors
from ..runtime import ptxt as rp

# Measured per-bootstrap output noise in ROTATION SLOTS (sigma), from the
# parameter-set operating-point table (PERFORMANCE.md; empirically asserted
# in tests/test_params_tpu.py for the tpu sets).
PBS_OUT_SIGMA_SLOTS = {
    "small_v2": 0.024,
    "small_v2_tpu": 0.073,
    "small_v2_tpu2": 0.12,
    "small_v2_n2048": 0.024,
    "small": 0.02,
    "medium": 0.001,
    "large": 0.001,
}


def _slots_to_units(p: TfheParams, slots: float) -> float:
    return slots * p.msg_space / (2.0 * p.N)


def _decode_tv(tv_torus: np.ndarray, msize: int, scale: int = 1) -> np.ndarray:
    """int32 torus test-vector values -> message units x ``scale``.

    ``scale=1`` suffices for sign/quarter-relu vectors (exact integer
    units).  The FDFB odd/even split halves and quarter-shifts torus values
    (ops/encrypted.py:relu_fdfb_test_vectors: ``(a-b)>>1`` and the seam
    constant ``sum//4``), so its vectors live on the QUARTER-unit lattice —
    decode them at ``scale=4`` or the rint introduces a +-1-unit artifact
    the real engine (torus-exact until the single final decrypt rounding)
    does not have.  That artifact produced deterministic ~8-12% per-layer
    "flips" in FDFB forecasts that survived even the exact N=2048 grid
    (round-4 diagnosis; regression: tests/test_noise_sim.py)."""
    t = np.asarray(tv_torus).astype(np.int64)
    t = np.where(t < 0, t + (1 << 32), t)
    u = np.rint(t * (scale * msize / 2.0**32)).astype(np.int64)
    return np.where(u >= scale * msize // 2, u - scale * msize, u)


class _Sim:
    def __init__(self, params: TfheParams, rng: np.random.Generator,
                 pbs_sigma_slots: Optional[float] = None):
        self.p = params
        self.rng = rng
        self.sig_ms = params.mod_switch_sigma_units()
        if pbs_sigma_slots is None:
            pbs_sigma_slots = PBS_OUT_SIGMA_SLOTS.get(params.name, 0.073)
        self.var_pbs = _slots_to_units(params, pbs_sigma_slots) ** 2
        self.flips: Dict[str, int] = {}
        self.counts: Dict[str, int] = {}

    def pbs(self, phase: np.ndarray, tv_units: np.ndarray, var_in: np.ndarray,
            shared_eta: Optional[np.ndarray] = None):
        """Negacyclic PBS read of a noisy phase.

        phase [..., C] int64 message units; tv_units [N] or [C, N];
        var_in: scalar or [C] ciphertext-noise variance (units^2).
        Returns (out_units [..., C], eta) — eta so FDFB's sign and odd
        bootstraps can share one mod-switch realization."""
        p = self.p
        if shared_eta is None:
            sig = np.sqrt(np.asarray(var_in, np.float64) + self.sig_ms**2)
            eta = self.rng.standard_normal(phase.shape) * sig
            if getattr(self, "exact", False):
                eta = np.zeros_like(eta)
        else:
            eta = shared_eta
        twoN = 2 * p.N
        slot = np.rint((phase + eta) * (twoN / p.msg_space)).astype(np.int64) % twoN
        neg = slot >= p.N
        idx = np.where(neg, slot - p.N, slot)
        if tv_units.ndim == 1:
            out = tv_units[idx]
        else:  # [C, N], phase [..., C]
            out = np.take_along_axis(
                tv_units, idx.reshape(-1, idx.shape[-1]).T, axis=1
            ).T.reshape(idx.shape)
        return np.where(neg, -out, out), eta


def _on(dev: torch.device, x: np.ndarray) -> torch.Tensor:
    """int32 tensor on ``dev`` of an integer array (wrapping as a cast to
    int32 does)."""
    return torch.as_tensor(np.asarray(x).astype(np.int32), device=dev)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.int64)


def _conv_counts(plan) -> np.ndarray:
    """|w| summed over taps: [K, O] nonzero-weight counts for variance
    propagation."""
    return np.abs(plan.weights.astype(np.int64)).sum(axis=(0, 1))


def simulate_forward(model: ModelPlan, x: np.ndarray, params: TfheParams,
                     info, rng: np.random.Generator,
                     pbs_sigma_slots: Optional[float] = None,
                     oracle_trace: Optional[list] = None,
                     exact_layers: Optional[set] = None,
                     majority: int = 1, majority_from: int = 0,
                     majority_plan: Optional[Dict[int, int]] = None,
                     escalate: Optional[set] = None,
                     escalate_params: Optional[TfheParams] = None,
                     device: str = "cuda"):
    """One Monte-Carlo rollout of the encrypted pipeline.

    ``x``: converted pixels int [B, H, W, C] (unencoded).  ``info``: the
    {layer: PbsRange} dict from runtime.ranges.resolve_pbs_ranges (gains and
    relu modes are honored exactly).  Returns (scores [B, classes] in oracle
    units, per-layer flip stats dict) — flip stats compare each PBS stage's
    outputs against the noiseless oracle when ``oracle_trace`` (the list of
    per-layer oracle activations from trace_oracle) is given.

    ``majority`` k > 1 simulates the re-randomized majority-voted PBS on
    sign-type boundaries (ops/encrypted.py:majority_pbs): k copies with
    independent MOD-SWITCH rounding (the accumulated ciphertext noise stays
    common — it lives in the value) are sign-bootstrapped and merged by a
    homomorphic majority (stage-2 PBS at >=8 sigma margin, modeled exact).
    Engages on boundaries with layer index >= ``majority_from``.
    ``majority_plan`` {layer: k} overrides the global k per layer (mirrors
    the runtime's REDSEC_MAJORITY_PLAN).

    ``escalate`` + ``escalate_params``: per-boundary parameter escalation
    (runtime REDSEC_ESCALATE): the listed layers' PBS reads (sign, maxpool,
    relu quarter/FDFB) run at ``escalate_params``' geometry — finer 2N
    rotation grid (halved mod-switch sigma at N=2048) and that set's PBS
    output noise — while phases/gains stay identical (message spaces must
    match).  ``device``: where the plaintext conv, sumpool and patch gather
    run (the noise draws and reads are numpy on the host)."""
    dev = resolve_device(device)
    p = params
    msize = p.msg_space
    sim = _Sim(p, rng, pbs_sigma_slots)
    B = x.shape[0]
    sim_esc = None
    if escalate:
        if escalate_params is None or escalate_params.msg_space != msize:
            raise ValueError("escalate needs escalate_params with the same "
                             "message space")
        sim_esc = _Sim(escalate_params, rng)

    def _sim_for(i):
        return sim_esc if (escalate and i in escalate) else sim

    def _params_for(i):
        return escalate_params if (escalate and i in escalate) else p

    def _maj_k(i):
        if majority_plan and i in majority_plan:
            return majority_plan[i]
        return majority if i >= majority_from else 1

    def sign_read(sim_i, phase, tv, var_in, k):
        """One sign-type PBS read, majority-voted over k re-randomized
        copies (ops/encrypted.py:majority_pbs).  The accumulated-ciphertext
        noise lives in the VALUE and is common to every copy (re-
        randomization replaces only the mask); each copy's mod-switch
        rounding is an independent draw.  Vote values are symmetric (+-v),
        so majority == sign of the sum; ties are impossible for odd k.  The
        stage-2 bootstrap (margin MAJORITY_G1 ~ 8 sigma) is modeled exact;
        its fresh output noise is the var reset the caller applies."""
        if k <= 1:
            out, _ = sim_i.pbs(phase, tv, var_in)
            return out
        sig_common = np.sqrt(np.asarray(var_in, np.float64))
        eta_c = sim_i.rng.standard_normal(phase.shape) * sig_common
        if getattr(sim_i, "exact", False):
            eta_c = np.zeros_like(eta_c)
        acc = None
        for _ in range(k):
            # independent mod-switch rounding per re-randomized copy (the
            # zero-encryption's own noise, alpha_enc*msize ~ 0.13 units, is
            # folded into sig_ms' dominance and neglected)
            out, _ = sim_i.pbs(phase + eta_c, tv, 0.0)
            acc = out if acc is None else acc + out
        return np.sign(acc) * np.abs(np.int64(tv[0]))
    # fresh client encryption noise (SECALPHA), in units
    var = np.full(x.shape[3], (p.alpha_enc * msize) ** 2, np.float64)
    # the client encrypts pixels at the model-input gain (forward.in_gain)
    x = np.asarray(x, np.int64) * (info[0].in_gain if 0 in info else 1)
    stats: Dict[str, dict] = {}

    for i, layer in enumerate(model.layers):
        r = info[i]
        q = layer.quant
        # what-if diagnosis: pretend these layers' bootstraps are noiseless
        # (localizes which boundary bounds the end-to-end agreement)
        sim.exact = exact_layers is not None and i in exact_layers
        if sim_esc is not None:
            sim_esc.exact = sim.exact
        if layer.conv is not None:
            cv = layer.conv
            cnt = _conv_counts(cv)  # [K, O]
            vin = np.tile(var, cv.in_dep // var.shape[0]) if cv.flatten else var
            var = vin @ cnt
            out = _host(rp.conv_ptxt(cv, _on(dev, x)))
            if cv.neg_correction is not None:
                # conv_ptxt subtracted neg_corr once; encrypted subtracts
                # neg_corr * g_in (ops/encrypted.py conv_enc)
                out = out + cv.neg_correction.astype(np.int64) * (1 - r.in_gain)
            x = out
        if layer.sumpool is not None:
            area = layer.sumpool.window[0] * layer.sumpool.window[1]
            x = _host(rp.sumpool_ptxt(layer.sumpool, _on(dev, x)))
            var = var * area

        key = f"L{i}"
        if q.mode == Activation.SIGN:
            ov = (maxpool_sign_value(layer.maxpool, p)
                  if layer.maxpool is not None else r.out_gain)
            tie = (np.asarray(r.tie_break, np.int64)[None]
                   if getattr(r, "tie_break", None) is not None else 0)
            phase = (x + (q.bias.astype(np.int64) + tie) * r.in_gain
                     + _center_units(r))
            tv = _decode_tv(const_test_vector(_params_for(i), ov, msize), msize)
            x = sign_read(_sim_for(i), phase, tv, var, _maj_k(i))
            var = np.full(q.depth, _sim_for(i).var_pbs)
            if oracle_trace is not None:
                oref = oracle_trace[i]["quant"]  # +-1
                stats[key] = _flip(x // ov, oref)
        elif q.mode == Activation.NONE:
            x = x + q.bias.astype(np.int64) * r.in_gain + _center_units(r)
        elif r.relu_mode == "quarter":
            sim_i, p_i = _sim_for(i), _params_for(i)
            tvs = _decode_tv(
                relu_test_vectors(q, p_i, r.in_gain, r.out_gain,
                                  center=getattr(r, "center", None)), msize)
            phase = x + _center_units(r) + msize // 4
            x, _ = sim_i.pbs(phase, tvs, var)
            var = np.full(q.depth, sim_i.var_pbs)
            if oracle_trace is not None:
                stats[key] = _flip(x // r.out_gain, oracle_trace[i]["quant"])
        else:  # FDFB full-range relu
            sim_i, p_i = _sim_for(i), _params_for(i)
            tv_o, tv_e, c = relu_fdfb_test_vectors(
                q, p_i, r.in_gain, r.out_gain,
                center=getattr(r, "center", None))
            # quarter-unit lattice (see _decode_tv): reads sum exactly, the
            # final >>2 recovers integer units with no rounding artifact
            tv_o, tv_e = _decode_tv(tv_o, msize, 4), _decode_tv(tv_e, msize, 4)
            cu = _decode_tv(c, msize, 4)
            tv_sign = _decode_tv(const_test_vector(p_i, msize // 4, msize),
                                 msize)
            phase = x + _center_units(r)
            s, eta1 = sim_i.pbs(phase, tv_sign, var)
            odd, _ = sim_i.pbs(phase, tv_o, var, shared_eta=eta1)
            ct2 = phase - s + msize // 4
            even, _ = sim_i.pbs(ct2, tv_e, var + sim_i.var_pbs)
            # odd/even/cu are quarter-units; their sum is an exact multiple
            # of 4 (= the integer-unit staircase value) by construction
            x = (odd + even + cu) >> 2
            var = np.full(q.depth, 2 * sim_i.var_pbs)
            if oracle_trace is not None:
                stats[key] = _flip(x // r.out_gain, oracle_trace[i]["quant"])
        if layer.maxpool is not None:
            mp = layer.maxpool
            V = maxpool_sign_value(mp, p)
            pt = _host(rp.gather_patches(_on(dev, x), mp.window, mp.stride, mp.offset,
                                         (mp.out_h, mp.out_w)))
            s = pt.sum(axis=(3, 4))
            ih = (np.arange(mp.out_h)[:, None] * mp.stride[0]
                  + np.arange(mp.window[0])[None, :] - mp.offset[0])
            iw = (np.arange(mp.out_w)[:, None] * mp.stride[1]
                  + np.arange(mp.window[1])[None, :] - mp.offset[1])
            cntm = (((ih >= 0) & (ih < mp.in_h)).sum(1)[:, None]
                    * ((iw >= 0) & (iw < mp.in_w)).sum(1)[None, :])
            phase = s + ((cntm - 1) * V)[None, :, :, None]
            w = mp.window[0] * mp.window[1]
            tv = _decode_tv(
                const_test_vector(_params_for(i), r.out_gain, msize), msize)
            x = sign_read(_sim_for(i), phase, tv, var * w, _maj_k(i))
            var = np.full(x.shape[-1], _sim_for(i).var_pbs)
            if oracle_trace is not None:
                stats[f"L{i}.mp"] = _flip(x // r.out_gain,
                                          oracle_trace[i]["maxpool"])

    scores = x.reshape(B, -1)
    # final decrypt wraps into [-msize/2, msize/2) like the real LWE decode
    scores = ((scores + msize // 2) % msize) - msize // 2
    r_last = info[max(info)]
    scores = np.rint(scores / r_last.out_gain).astype(np.int64)
    if getattr(r_last, "center", None) is not None:
        # decrypt-side uncentering (runtime/encrypted.py:decrypt_scores)
        scores = scores - np.asarray(r_last.center, np.int64)[None, :]
    return scores, stats


def _center_units(r) -> np.ndarray | int:
    """Per-channel centering shift (gained units) applied to the ciphertext
    before this layer's PBS; 0 when the range has no center assigned."""
    c = getattr(r, "center", None)
    return 0 if c is None else np.asarray(c, np.int64) * r.in_gain


def _flip(got: np.ndarray, want: np.ndarray) -> dict:
    n = got.size
    f = int((got != want).sum())
    return {"flips": f, "n": n, "rate": f / n}


def trace_oracle(model: ModelPlan, x: np.ndarray, device: str = "cuda") -> list:
    """Noiseless per-layer oracle activations (for flip localization)."""
    out = []
    cur = _on(resolve_device(device), x)
    for layer in model.layers:
        t = {}
        v = cur
        if layer.conv is not None:
            v = rp.conv_ptxt(layer.conv, v)
        if layer.sumpool is not None:
            v = rp.sumpool_ptxt(layer.sumpool, v)
        q = layer.quant
        if q.mode == Activation.SIGN:
            v = rp.quant_sign_ptxt(q, v)
        elif q.mode == Activation.NONE:
            v = rp.quant_add_bias_ptxt(q, v)
        else:
            v = rp.quant_relu_ptxt(q, v)
        t["quant"] = _host(v)
        if layer.maxpool is not None:
            v = rp.maxpool_ptxt(layer.maxpool, v)
            t["maxpool"] = _host(v)
        out.append(t)
        cur = v
    return out


def agreement_estimate(model: ModelPlan, x: np.ndarray, params: TfheParams,
                       info, trials: int = 5, seed: int = 0,
                       pbs_sigma_slots: Optional[float] = None,
                       per_layer: bool = False,
                       majority: int = 1, majority_from: int = 0,
                       majority_plan: Optional[Dict[int, int]] = None,
                       escalate: Optional[set] = None,
                       escalate_params: Optional[TfheParams] = None,
                       device: str = "cuda"):
    """Monte-Carlo oracle-agreement estimate over ``trials`` rollouts.

    Returns dict with mean/min agreement and (optionally) per-layer flip
    rates averaged over trials."""
    want = rp.build_forward(model, device)(np.asarray(x, np.int32)).cpu().numpy()
    ptxt_preds = want.argmax(1)
    trace = trace_oracle(model, x, device) if per_layer else None
    agrees, layer_rates = [], {}
    for t in range(trials):
        rng = np.random.default_rng(seed + t)
        scores, stats = simulate_forward(model, x, params, info, rng,
                                         pbs_sigma_slots, trace,
                                         majority=majority,
                                         majority_from=majority_from,
                                         majority_plan=majority_plan,
                                         escalate=escalate,
                                         escalate_params=escalate_params,
                                         device=device)
        agrees.append(float((scores.argmax(1) == ptxt_preds).mean()))
        for k, v in stats.items():
            layer_rates.setdefault(k, []).append(v["rate"])
    res = {
        "agreement_mean": float(np.mean(agrees)),
        "agreement_min": float(np.min(agrees)),
        "trials": trials,
        "images": int(x.shape[0]),
    }
    if per_layer:
        res["layer_flip_rates"] = {
            k: round(float(np.mean(v)), 5) for k, v in layer_rates.items()}
    return res
