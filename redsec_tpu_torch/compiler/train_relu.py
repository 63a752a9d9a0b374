"""Staircase-STE trainer for the DoReFa/relu (Domain.INT) BYON family, on
torch autograd.

The reference's compiler also emits trainable DoReFa/relu twins
(compiler/compiler.py:310-328) whose inference side is the IntFunc staircase
``clip((v*slope + bias) >> slope_bits, 0, 2^shift_bits - 1)``
(lib/IntFunc.cpp:953-1000).  This module trains that second activation
family: mnist/relu1024xN-shaped nets
([INT passthrough (+SumPool) NONE] -> N x [INT FC + BNORM + RELU] ->
[INT FC NONE]).

The twin's hard forward emulates the weight converter
(compiler/weight_convert.py INT branch: slope = (1/sd) * 2^shift/scale *
2^slope_bits (+0.5 floor), bias = bias_f * slope + 0.5*2^slope_bits + 0.5
(floor)) and runs the exact integer staircase, so after
export_var_dat1 -> weight_convert -> prep_model the plaintext engine
reproduces the trainer's logits bit for bit (``train_and_export_relu``
checks it).  Gradients flow through a continuous staircase surrogate
(straight-through).

Noise-robustness shaping: an encrypted relu bootstrap flips a staircase step
when the mod-switch noise pushes the phase across a step edge, so the loss
hinges the distance of each continuous staircase argument from its nearest
step edge (``edge_margin``), on top of the final-layer multi-class logit
hinge and the |v| bound cap that keeps encoding gains available.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.spec import (
    Activation,
    BiasKind,
    ConvKind,
    Domain,
    INT_SLOPE_BITS,
    ModelSpec,
    PoolKind,
)
from .train import (Adam, _clip, _hist_loop, _mean, _sqrt, _ste_tern, exact_matmul, to_numpy,
                    to_torch)
from .weight_convert import BNORM_EPS, export_var_dat1, weight_convert


@dataclasses.dataclass
class ReluTrainConfig:
    steps: int = 800
    lr: float = 2e-3
    edge_margin: float = 0.35   # target distance (in staircase-output units,
    #                             max 0.5) from the nearest step edge
    bound: float = 900.0        # soft cap on |v| (message-space budget)
    logit_margin: float = 24.0
    lam_edge: float = 1.0
    lam_bound: float = 0.5
    hidden_noise: float = 1.0   # train-time gaussian on v (integer units)
    seed: int = 0
    log_every: int = 100


def _relu_geometry(spec: ModelSpec):
    """Weight-layer geometry + the converter's scale/slope_bits recurrence
    (compiler/weight_convert.py INT branch) for the relu FC family."""
    dim = spec.input_dims.copy()
    scale = float(dim.scale)
    h, w, c = dim.h, dim.w, dim.in_dep
    lead_pool = None
    out: List[dict] = []
    for L in spec.layers:
        assert L.domain == Domain.INT, "relu trainer is INT-domain only"
        if L.conv == ConvKind.NONE:
            assert L.activation == Activation.NONE and not out, (
                "only a leading passthrough layer is supported")
            if L.pool == PoolKind.SUM:
                lead_pool = L.pool_params.window
                h, w = h // lead_pool[0], w // lead_pool[1]
                scale *= lead_pool[0] * lead_pool[1]
            continue
        assert L.conv in (ConvKind.FC, ConvKind.FC_FINAL), "FC layers only"
        g = {"shape": (1, 1, h * w * c, L.out_depth),
             "thresh": L.conv_params.tern_thresh, "scale": scale}
        h, w, c = 1, 1, L.out_depth
        if L.activation == Activation.RELU:
            assert L.bias == BiasKind.BNORM
            shift = L.resolved_shift_bits()
            assert shift > 1, "DoReFa staircase needs shift_bits > 1"
            sc_b = 0
            while (1 << sc_b) < scale:
                sc_b += 1
            g.update(relu=True, shift=shift,
                     slope_bits=INT_SLOPE_BITS + sc_b - shift)
            scale = float((1 << shift) - 1)
        else:
            assert L.activation == Activation.NONE and L.bias == BiasKind.NONE
            g.update(relu=False)
        out.append(g)
    assert out and not out[-1]["relu"], "net must end with a bias-free FC"
    assert all(g["relu"] for g in out[:-1]), "hidden layers must be RELU"
    return out, lead_pool


def init_relu_params(spec: ModelSpec, seed: int = 0):
    rng = np.random.default_rng(seed)
    params = []
    geom, _ = _relu_geometry(spec)
    for g in geom:
        fan_in = g["shape"][2]
        w = rng.normal(0.0, 1.0 / np.sqrt(fan_in), size=g["shape"])
        w = np.where(np.abs(w) < 2 * g["thresh"],
                     np.sign(w + 1e-12) * 2 * g["thresh"], w)
        p = {"w": w.astype(np.float32)}
        if g["relu"]:
            p["beta"] = np.zeros(g["shape"][3], np.float32)
        params.append(p)
    return params


def build_relu_twin(spec: ModelSpec):
    """Returns (forward, geom): ``forward(params, px, gen=None, cfg=None) ->
    (logits, [per-layer continuous staircase args y_cont], [v_int])`` on the
    device of ``px``, with ``params`` from ``train.to_torch``.

    The activations fed forward are the exact integer staircase outputs
    (converter-emulated); y_cont drives the edge-margin loss and the STE
    gradient.  With a generator ``gen`` and a ``cfg``, Gaussian noise of
    ``cfg.hidden_noise`` is drawn from ``gen`` onto every ``v``."""
    geom, lead_pool = _relu_geometry(spec)

    def forward(params, px, *, gen=None, cfg=None):
        x = px.to(torch.float32)
        if lead_pool is not None:
            B, H, W, C = x.shape
            x = x.reshape(B, H // lead_pool[0], lead_pool[0],
                          W // lead_pool[1], lead_pool[1], C).sum(dim=(2, 4))
        a = x.reshape(x.shape[0], -1)
        ys, vs = [], []
        for g, p in zip(geom, params):
            wq = _ste_tern(p["w"], g["thresh"]).reshape(-1, g["shape"][3])
            s = exact_matmul(a, wq)
            if not g["relu"]:
                return s, ys, vs  # final layer: engine logits == s exactly
            scale, shift, sb = g["scale"], g["shift"], g["slope_bits"]
            top = (1 << shift) - 1
            mu = _mean(s, (0,)) / scale
            ss = s / scale
            sd = _sqrt(_mean((ss - _mean(ss, (0,))) ** 2, (0,)) + BNORM_EPS)
            v = s  # integer engine v differs by the folded n_neg correction
            if gen is not None and cfg is not None:
                v = v + cfg.hidden_noise * torch.randn(v.shape, generator=gen, device=v.device)
            vs.append(v)
            # continuous staircase argument (pre-floor, incl. the converter's
            # +0.5 rounding term): y_cont = 2^shift*((v/scale - mu)/sd + beta) + 0.5
            y_cont = (1 << shift) * ((v / scale - mu) / sd + p["beta"]) + 0.5
            ys.append(y_cont)
            # hard path (train-time surrogate): emulate the converter's
            # quantization (weight_convert.py + write_i32 floor) and the
            # integer staircase (runtime/ptxt.py quant_relu_ptxt), including
            # the engine's 1's-complement v = s - n_neg with +n_neg folded
            # into the bias; the two do not cancel through the floors
            # (slope_int != slope2).  Export and the self-check use the
            # float64 numpy walk (_hard_walk) instead.
            with torch.no_grad():
                n_neg = (wq < 0).to(torch.float32).sum(0)
                slope2 = (1.0 / sd) * ((1 << shift) / scale) * (1 << sb)
                slope_int = torch.floor(slope2 + 0.5)
                bias_f = n_neg - scale * mu + scale * p["beta"] * sd
                bias_int = torch.floor(bias_f * slope2 + 0.5 * (1 << sb) + 0.5)
                y_hard = torch.clip(torch.floor(((v - n_neg) * slope_int + bias_int)
                                                / (1 << sb)), 0, top)
            soft = _clip(y_cont - 0.5, 0.0, float(top))
            a = soft + (y_hard - soft).detach()
        raise AssertionError("unreachable: geometry guarantees a final FC")

    return forward, geom


def _hard_walk(spec: ModelSpec, params, px: np.ndarray):
    """Numpy float64 hard forward that exactly mirrors the exported
    pipeline: quantizes BN stats to float32 (what var.dat1 stores), then
    replicates the converter's float64 fold + floor casts and the integer
    staircase.  Returns (logits, arrays-for-var.dat1)."""
    geom, lead_pool = _relu_geometry(spec)
    x = np.asarray(px, np.float64)
    if lead_pool is not None:
        B, H, W, C = x.shape
        x = x.reshape(B, H // lead_pool[0], lead_pool[0],
                      W // lead_pool[1], lead_pool[1], C).sum(axis=(2, 4))
    a = x.reshape(x.shape[0], -1)
    arrays: List[np.ndarray] = []
    for g, p in zip(geom, params):
        w = np.asarray(p["w"], np.float64)
        sign, tern = w > 0, np.abs(w) < g["thresh"]
        wq = np.where(tern, 0.0, np.where(sign, 1.0, -1.0))
        wq2 = wq.reshape(-1, g["shape"][3])
        s = a @ wq2
        arrays.append(np.asarray(p["w"], np.float32))
        if not g["relu"]:
            return s, arrays
        scale, shift, sb = g["scale"], g["shift"], g["slope_bits"]
        # stats as STORED: float32-quantized beta/mean/variance, then the
        # converter's own float64 recovery sqrt(var + eps)
        mu32 = (s.mean(axis=0) / scale).astype(np.float32)
        var32 = ((s / scale).var(axis=0)).astype(np.float32)
        beta32 = np.asarray(p["beta"], np.float32)
        arrays += [beta32, mu32, var32]
        mu = mu32.astype(np.float64)
        sd = np.sqrt(var32.astype(np.float64) + BNORM_EPS)
        n_neg = (wq2 == -1.0).sum(axis=0).astype(np.float64)
        slope2 = (1.0 / sd) * ((1 << shift) / scale) * (1 << sb)
        slope_int = np.floor(slope2 + 0.5)
        bias_f = n_neg - scale * mu + scale * beta32.astype(np.float64) * sd
        bias_int = np.floor(bias_f * slope2 + 0.5 * (1 << sb) + 0.5)
        v_int = s - n_neg
        a = np.clip(np.floor((v_int * slope_int + bias_int) / (1 << sb)),
                    0, (1 << shift) - 1)
    raise AssertionError("unreachable")


def relu_loss(forward, geom, params, x, onehot, cfg: ReluTrainConfig, gen=None):
    """The training objective -> (loss, logits): the multi-class logit
    hinge, the step-edge margin hinge on every staircase argument and the
    |v| cap.  ``gen`` draws the training noise (None: none)."""
    logits, ys, vs = forward(params, x, gen=gen, cfg=cfg)
    z_true = (logits * onehot).sum(-1)
    z_other = (logits - 1e9 * onehot).amax(dim=-1)
    l_cls = torch.mean(torch.relu(cfg.logit_margin - (z_true - z_other)) / cfg.logit_margin)
    # step-edge margin: frac distance of y_cont from the nearest integer
    # (only edges inside the active staircase band flip outputs; the clamp
    # regions get a one-sided margin through clipping y_cont into
    # [-0.5, top+0.5] before taking the fraction)
    l_e = 0.0
    for g, yc in zip(geom, ys):
        top = float((1 << g["shift"]) - 1)
        ycl = _clip(yc, -0.5, top + 0.5)
        d = 0.5 - (ycl - torch.round(ycl)).abs()
        l_e += torch.mean(torch.relu(cfg.edge_margin - d) / cfg.edge_margin)
    l_e /= max(len(ys), 1)
    l_b = sum(torch.mean(torch.relu(v.abs() - cfg.bound) / cfg.bound)
              for v in vs) / max(len(vs), 1)
    return l_cls + cfg.lam_edge * l_e + cfg.lam_bound * l_b, logits


def train_relu(spec: ModelSpec, px: np.ndarray, labels: np.ndarray,
               cfg: ReluTrainConfig = ReluTrainConfig(), params=None, device: str = "cuda"):
    """Full-batch training on ``device``.  Returns (params as numpy, history)."""
    dev = resolve_device(device)
    forward, geom = build_relu_twin(spec)
    if params is None:
        params = init_relu_params(spec, cfg.seed)
    tparams = to_torch(params, dev, requires_grad=True)
    leaves = [t for p in tparams for t in p.values()]
    x = torch.as_tensor(np.asarray(px), device=dev)
    y = torch.as_tensor(np.asarray(labels), dtype=torch.int64, device=dev)
    onehot = F.one_hot(y, geom[-1]["shape"][3]).to(torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    opt = Adam(leaves, cfg.lr)

    def step():
        l, logits = relu_loss(forward, geom, tparams, x, onehot, cfg, gen)
        opt.step(torch.autograd.grad(l, leaves))
        with torch.no_grad():
            acc = _mean((logits.argmax(-1) == y).to(torch.float32), (0,))
        return l.detach(), acc, None

    hist = _hist_loop(cfg, step, with_margin=False)
    return to_numpy(tparams), hist


def export_trained_relu(spec: ModelSpec, params, px: np.ndarray) -> bytes:
    """var.dat1 bytes: per hidden layer w, beta, mean, variance (the
    converter's BNORM read order, weight_convert.py); final layer w only.
    BN statistics frozen from the float64 hard walk over ``px`` (the same
    walk the self-check compares against the exported engine)."""
    _, arrays = _hard_walk(spec, params, px)
    return export_var_dat1(arrays)


def export_and_check_relu(spec: ModelSpec, params, hist, px: np.ndarray, labels: np.ndarray,
                          device: str = "cuda") -> Tuple[bytes, bytes, dict]:
    """Export, weight-convert, and compare the exported plaintext pipeline
    with the float64 hard walk, on predictions and logits
    (``logits_bit_exact``).  Returns (var_dat1, var_prep, report)."""
    from ..models.spec import prep_model
    from ..runtime.ptxt import build_forward

    dev = resolve_device(device)
    raw = export_trained_relu(spec, params, px)
    prep = weight_convert(spec, raw)

    twin_logits, _ = _hard_walk(spec, params, px)
    plan = prep_model(spec, prep)
    ptxt_logits = build_forward(plan, device)(np.asarray(px)).cpu().numpy()
    ptxt_logits = ptxt_logits.reshape(twin_logits.shape).astype(np.float64)
    # edge distances from the twin's continuous staircase args
    forward, _g = build_relu_twin(spec)
    with torch.no_grad():
        _, ys, _ = forward(to_torch(params, dev), torch.as_tensor(np.asarray(px), device=dev))
    report = {
        "train_acc_twin": float((twin_logits.argmax(-1) == labels).mean()),
        "train_acc_ptxt": float((ptxt_logits.argmax(-1) == labels).mean()),
        "twin_vs_ptxt_agreement": float(
            (twin_logits.argmax(-1) == ptxt_logits.argmax(-1)).mean()),
        "logits_bit_exact": bool((twin_logits == ptxt_logits).all()),
        "min_edge_dist": [float((0.5 - (y - torch.round(y)).abs()).min()) for y in ys],
        "history": hist,
    }
    return raw, prep, report


def train_and_export_relu(spec: ModelSpec, px: np.ndarray, labels: np.ndarray,
                          cfg: ReluTrainConfig = ReluTrainConfig(), device: str = "cuda"
                          ) -> Tuple[bytes, bytes, dict]:
    """Train, export, weight-convert and self-check (``export_and_check_relu``)."""
    params, hist = train_relu(spec, px, labels, cfg, device=device)
    return export_and_check_relu(spec, params, hist, px, labels, device)
