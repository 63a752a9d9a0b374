"""Margin-aware STE trainer for sign BNN topologies (the BYON train step), on
torch autograd.

The reference's BYON flow trains a Larq/TensorFlow twin emitted by
``compiler.py`` and converts ``var.dat1`` -> ``var_prep.dat`` offline
(compiler/README.md:29-53; training scripts e.g.
nets/cifar/binarynet/binarynet.py:38-62).  This module is that training leg:
a small trainer with straight-through estimators whose hard-quantized forward
is bit-identical to the plaintext engine after export.  The pipeline is
train -> ``export_var_dat1`` -> ``weight_convert`` -> ``prep_model``, checked
end to end by ``train_and_export``, which compares the exported plaintext
predictions with the trainer's own.

Why margins are first-class: encrypted inference adds a fixed mod-switch
noise at every sign bootstrap, while per-edge encoding gains multiply each
boundary's decision margins by about budget/bound.  A network is
noise-robust when every boundary's margin times gain clears that noise, so
the loss shapes the integer pre-activation distribution directly: a hinge
pushing |v| >= margin and a cap keeping max|v| <= bound small enough that the
gain stays large.

Supported topology family: Domain.BIN conv/fc layers with SIGN+BNORM (and
optional MaxPool), an optional leading INT passthrough/SumPool sign layer,
and a trailing FC_FINAL (Activation.NONE): the mnist/sign* and
cifar/binarynet* families.  ReLU (DoReFa) nets are covered by the
staircase-STE twin in ``compiler/train_relu.py``.

Arithmetic follows the JAX package's trainer: activations NHWC, straight
through gradients of 1 inside (-1, 1), 0.5 at exactly +-1 and 0 outside (the
gradient of a clip at its bounds), maxpool and the logit max as ``amax``
(the gradient split evenly over ties), batch statistics with no Bessel
correction, and Adam in optax's order of operations.  Every conv and FC sum
is a contraction of +-1 (or pixel) activations with ternary weights; it runs
in float64 (an unfold and a matmul), which holds it as an exact integer in
any summation order on every device, whatever the caller's TF32 settings.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.spec import (
    Activation,
    BiasKind,
    ConvKind,
    Domain,
    ModelSpec,
    PoolKind,
)
from .weight_convert import BNORM_EPS, export_var_dat1, weight_convert


@dataclasses.dataclass
class TrainConfig:
    steps: int = 800
    lr: float = 2e-3
    margin: float = 6.0        # per-boundary integer-margin hinge target
    bound: float = 80.0        # soft cap on |v| (keeps encoding gains large)
    logit_margin: float = 24.0  # decrypt-boundary multi-class hinge
    lam_margin: float = 1.0
    lam_bound: float = 0.5
    input_sigma_units: float = 7.64  # mod-switch sigma for input-flip noise
    input_gain_est: float = 4.0      # assumed client-side input encoding gain
    hidden_noise: float = 1.0        # train-time noise on v (integer units)
    seed: int = 0
    log_every: int = 100
    # steps per history record (0 or 1: one record every log_every steps).
    # Above 1 the trainer runs whole chunks of this many steps and records
    # the last step of each, as the JAX package's scanned segments do.
    scan_chunk: int = 0


def _clip_grad(x: torch.Tensor) -> torch.Tensor:
    """d clip(x, -1, 1) / dx as JAX differentiates it: 1 inside, 0.5 at the
    bounds (a max or min of two equal values splits the gradient), 0 outside."""
    a = x.abs()
    return torch.where(a < 1, 1.0, torch.where(a == 1, 0.5, 0.0)).to(x.dtype)


class _SteSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v):
        ctx.save_for_backward(v)
        return torch.where(v >= 0, 1.0, -1.0).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        return g * _clip_grad(v)


class _SteTern(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, thresh):
        ctx.save_for_backward(w)
        q = torch.where(w > 0, 1.0, -1.0).to(w.dtype)
        return torch.where(w.abs() < thresh, 0.0, q).to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return g * _clip_grad(w), None


def _ste_sign(v: torch.Tensor) -> torch.Tensor:
    """sign with straight-through gradient (pass-through inside |v| <= 1);
    the hard value is ``where(v >= 0, 1, -1)``."""
    return _SteSign.apply(v)


def _ste_tern(w: torch.Tensor, thresh: float) -> torch.Tensor:
    """Exact ternarizer of the weight converter (sign = f > 0, zero =
    |f| < t, weight_convert.py) with clipped-identity gradient."""
    return _SteTern.apply(w, thresh)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``clip`` as JAX differentiates it (a max, then a min): the gradient
    is halved where ``x`` equals a bound; ``torch.clip`` passes all of it."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device (torch's CPU
    float32 sqrt may differ from it in the last bit; XLA's does not)."""
    return torch.sqrt(x.double()).to(x.dtype)


def exact_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in float64, returned as float32: exact for the integer
    activations and ternary weights of the twins (every partial sum far below
    2^53), in any order and with no TF32 rounding on any device."""
    return (a.double() @ w.double()).to(a.dtype)


def _conv_same(a: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME convolution of NHWC ``a`` with HWIO ``wq`` as an unfold
    and one exact matmul (XLA's SAME padding: (k - 1) // 2 before)."""
    kh, kw, c, o = wq.shape
    b, h, w, _ = a.shape
    x = F.pad(a.permute(0, 3, 1, 2).double(), ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    cols = F.unfold(x, (kh, kw)).transpose(1, 2)  # [B, H*W, C*kh*kw], (C, kh, kw) order
    s = cols @ wq.permute(2, 0, 1, 3).reshape(c * kh * kw, o).double()
    return s.to(a.dtype).reshape(b, h, w, o)


def _mean(x: torch.Tensor, dims) -> torch.Tensor:
    """Mean over ``dims`` as XLA computes it: the sum times 1/count."""
    count = int(np.prod([x.shape[d] for d in dims]))
    return x.sum(dim=dims) * (1.0 / count)


def _batch_stats(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and sqrt(population variance + 1e-3) over every axis
    but the last (``jnp.var``: no Bessel correction)."""
    dims = tuple(range(s.ndim - 1))
    mu = _mean(s, dims)
    return mu, _sqrt(_mean((s - mu) ** 2, dims) + 1e-3)


def _maxpool2(a: torch.Tensor) -> torch.Tensor:
    """2x2 maxpool of NHWC ``a`` as a reshape and an ``amax``, which splits
    the gradient evenly over tied maxima as JAX's max does."""
    b, h, w, c = a.shape
    return a.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _layer_geometry(spec: ModelSpec):
    """Per-weight-layer geometry + the weight converter's dim.scale
    recurrence (weight_convert.py:_convert_layer) for the supported
    sign-BNN family.  Returns a list of dicts for the Domain.BIN weight
    layers in order."""
    dim = spec.input_dims.copy()
    scale = float(dim.scale)
    h, w, c = dim.h, dim.w, dim.in_dep
    out: List[dict] = []
    for i, L in enumerate(spec.layers):
        if L.domain == Domain.INT:
            # leading passthrough/pool sign layer (no weights): INT branch
            # with shift_bits==1 sets scale=1.0 (weight_convert.py)
            assert L.conv == ConvKind.NONE and L.activation == Activation.SIGN, (
                "trainer supports only INT passthrough sign layers")
            if L.pool == PoolKind.SUM:
                pw = L.pool_params.window
                h, w = h // pw[0], w // pw[1]
                scale *= pw[0] * pw[1]
            scale = 1.0
            continue
        assert L.domain == Domain.BIN, "trainer supports sign BNNs only"
        g = {"index": i, "kind": L.conv, "thresh": L.conv_params.tern_thresh,
             "bnorm": L.bias == BiasKind.BNORM, "scale": scale,
             "maxpool": L.pool == PoolKind.MAX, "out": L.out_depth}
        if L.conv in (ConvKind.FC, ConvKind.FC_FINAL):
            g["shape"] = (1, 1, h * w * c, L.out_depth)
            h, w, c = 1, 1, L.out_depth
        else:
            assert L.conv_params.same_pad and L.conv_params.stride == (1, 1)
            g["shape"] = (L.conv_params.window[0], L.conv_params.window[1],
                          c, L.out_depth)
            c = L.out_depth
        if L.activation == Activation.SIGN:
            scale = 0.5  # BIN sign sets dim.scale=0.5 (weight_convert.py)
        else:
            assert L.conv == ConvKind.FC_FINAL and L.activation == Activation.NONE
        if g["maxpool"]:
            pw = L.pool_params.window
            h, w = h // pw[0], w // pw[1]
        out.append(g)
    return out


def init_params(spec: ModelSpec, seed: int = 0) -> List[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    params = []
    for g in _layer_geometry(spec):
        fan_in = g["shape"][0] * g["shape"][1] * g["shape"][2]
        w = rng.normal(0.0, 1.0 / np.sqrt(fan_in), size=g["shape"])
        # keep initial weights clear of the ternary dead zone so gradients
        # see the live quantizer from step 0
        w = np.where(np.abs(w) < 2 * g["thresh"],
                     np.sign(w + 1e-12) * 2 * g["thresh"], w)
        p = {"w": w.astype(np.float32)}
        if g["bnorm"]:
            p["beta"] = np.zeros(g["shape"][3], np.float32)
        params.append(p)
    return params


def to_torch(params, device, requires_grad: bool = False) -> List[Dict[str, torch.Tensor]]:
    """numpy parameters -> float32 tensors on ``device`` (leaves of autograd
    when ``requires_grad``)."""
    return [{k: torch.tensor(np.asarray(v, np.float32), device=device,
                             requires_grad=requires_grad) for k, v in p.items()}
            for p in params]


def to_numpy(params) -> List[Dict[str, np.ndarray]]:
    return [{k: v.detach().cpu().numpy() for k, v in p.items()} for p in params]


def build_twin(spec: ModelSpec):
    """Differentiable twin: ``forward(params, px, gen=None, cfg=None,
    record=None) -> (logits, [per-boundary v_int])`` on the device of
    ``px`` (NHWC), with ``params`` from ``to_torch``.

    With a ``torch.Generator`` ``gen`` and a ``cfg``, the training noise is
    drawn from ``gen``: input sign flips at the modelled rate and Gaussian
    noise on every ``v``.  ``record``, a list, receives ``(s, mu, sd)`` per
    weight layer (the integer sums and the batch statistics; ``None``
    statistics at the final layer)."""
    geom = _layer_geometry(spec)
    lead = spec.layers[0].domain == Domain.INT
    lead_pool = lead and spec.layers[0].pool == PoolKind.SUM
    pool_w = spec.layers[0].pool_params.window if lead_pool else None

    def forward(params, px, *, gen: Optional[torch.Generator] = None,
                cfg: Optional[TrainConfig] = None, record: Optional[list] = None):
        noisy = gen is not None and cfg is not None
        x = px.to(torch.float32)
        vs = []
        if lead_pool:
            B, H, W, C = x.shape
            x = x.reshape(B, H // pool_w[0], pool_w[0],
                          W // pool_w[1], pool_w[1], C).sum(dim=(2, 4))
        if lead:
            a = _ste_sign(x)
            if noisy:
                # train-time input-flip injection at the modelled rate
                # Phi(-g0 |x| / sigma): the encrypted input sign boundary
                # flips near-gray pixels, and downstream layers must learn
                # robustness to it (runtime/ranges.py noise model)
                p = torch.special.ndtr(-cfg.input_gain_est * x.abs() / cfg.input_sigma_units)
                flip = torch.rand(a.shape, generator=gen, device=a.device) < p
                a = a + (torch.where(flip, -a, a) - a).detach()
        else:
            a = x
        for g, p in zip(geom, params):
            wq = _ste_tern(p["w"], g["thresh"])
            if g["kind"] == ConvKind.CONV:
                s = _conv_same(a, wq)
            else:
                s = exact_matmul(a.reshape(a.shape[0], -1), wq.reshape(-1, g["shape"][3]))
            if g["kind"] == ConvKind.FC_FINAL:
                if record is not None:
                    record.append((s, None, None))
                return s, vs
            # batch norm on the integer sums (stats folded exactly at
            # export: bias_int = floor(scale * (-mean + beta * stddev)))
            mu, sd = _batch_stats(s)
            if record is not None:
                record.append((s, mu, sd))
            y = (s - mu) / sd + p["beta"]
            v = sd * y  # integer-domain pre-PBS value
            if noisy:
                v = v + cfg.hidden_noise * torch.randn(v.shape, generator=gen, device=v.device)
                y = v / sd
            vs.append(v)
            a = _ste_sign(y)
            if g["maxpool"]:
                a = _maxpool2(a)
        raise AssertionError("model must end with FC_FINAL")

    return forward, geom


def sign_loss(forward, params, x, onehot, cfg: TrainConfig, gen=None):
    """The training objective -> (loss, (logits, vs)): a multi-class integer
    margin hinge at the decrypt boundary, a per-boundary margin hinge on
    |v| and a cap on |v|.  ``gen`` draws the training noise (None: none)."""
    logits, vs = forward(params, x, gen=gen, cfg=cfg)
    z_true = (logits * onehot).sum(-1)
    z_other = (logits - 1e9 * onehot).amax(dim=-1)
    l_cls = torch.mean(torch.relu(cfg.logit_margin - (z_true - z_other)) / cfg.logit_margin)
    l_m = sum(torch.mean(torch.relu(cfg.margin - v.abs()) / cfg.margin) for v in vs) / len(vs)
    l_b = sum(torch.mean(torch.relu(v.abs() - cfg.bound) / cfg.bound) for v in vs) / len(vs)
    return l_cls + cfg.lam_margin * l_m + cfg.lam_bound * l_b, (logits, vs)


class Adam:
    """``optax.adam(lr)`` (``scale_by_adam`` with b1 0.9, b2 0.999, eps 1e-8,
    eps_root 0, then a scale by -lr, then ``apply_updates``) in optax's order
    of float32 operations, so that a step on the CPU equals optax's op for
    op.  ``torch.optim.Adam`` orders them differently."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, leaves: List[torch.Tensor], lr: float):
        self.leaves, self.lr = leaves, lr
        self.mu = [torch.zeros_like(p) for p in leaves]
        self.nu = [torch.zeros_like(p) for p in leaves]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.count += 1
        dev = self.leaves[0].device
        count = torch.tensor(float(self.count), device=dev)
        bc1 = 1 - torch.pow(torch.tensor(self.B1, device=dev), count)
        bc2 = 1 - torch.pow(torch.tensor(self.B2, device=dev), count)
        for i, (p, g) in enumerate(zip(self.leaves, grads)):
            self.mu[i] = (1 - self.B1) * g + self.B1 * self.mu[i]
            self.nu[i] = (1 - self.B2) * (g * g) + self.B2 * self.nu[i]
            u = (self.mu[i] / bc1) / (_sqrt(self.nu[i] / bc2 + 0.0) + self.EPS)
            p.copy_(p + (-self.lr) * u)


def _hist_loop(cfg, step_fn, with_margin: bool):
    """Run ``step_fn()`` -> (loss, acc, min_margin) ``cfg.steps`` times and
    keep the JAX package's history records: one every ``log_every`` steps
    and at the last, or, with ``scan_chunk`` > 1, whole chunks of that many
    steps and one record (the chunk's last step, no margin) per chunk."""
    hist = []
    if getattr(cfg, "scan_chunk", 0) > 1:
        for i in range(0, cfg.steps, cfg.scan_chunk):
            for _ in range(cfg.scan_chunk):
                l, acc, _m = step_fn()
            rec = (i + cfg.scan_chunk - 1, float(l), float(acc), -1.0)
            hist.append(rec)
            print(f"step {rec[0]:5d} loss {rec[1]:.4f} train_acc {rec[2]:.3f}", flush=True)
        return hist
    for i in range(cfg.steps):
        l, acc, min_m = step_fn()
        if i % cfg.log_every == 0 or i == cfg.steps - 1:
            if with_margin:
                rec = (i, float(l), float(acc), float(min_m))
                print(f"step {rec[0]:5d} loss {rec[1]:.4f} train_acc {rec[2]:.3f} "
                      f"min|v| {rec[3]:.1f}", flush=True)
            else:
                rec = (i, float(l), float(acc))
                print(f"step {i:5d} loss {rec[1]:.4f} train_acc {rec[2]:.3f}", flush=True)
            hist.append(rec)
    return hist


def train(spec: ModelSpec, px: np.ndarray, labels: np.ndarray,
          cfg: TrainConfig = TrainConfig(), params=None, device: str = "cuda"):
    """Full-batch margin-aware training on ``device``.  Returns
    (params as numpy, history)."""
    dev = resolve_device(device)
    forward, geom = build_twin(spec)
    if params is None:
        params = init_params(spec, cfg.seed)
    tparams = to_torch(params, dev, requires_grad=True)
    leaves = [t for p in tparams for t in p.values()]
    x = torch.as_tensor(np.asarray(px), device=dev)
    y = torch.as_tensor(np.asarray(labels), dtype=torch.int64, device=dev)
    onehot = F.one_hot(y, geom[-1]["shape"][3]).to(torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    opt = Adam(leaves, cfg.lr)

    def step():
        l, (logits, vs) = sign_loss(forward, tparams, x, onehot, cfg, gen)
        opt.step(torch.autograd.grad(l, leaves))
        with torch.no_grad():
            acc = _mean((logits.argmax(-1) == y).to(torch.float32), (0,))
            min_m = torch.stack([v.abs().min() for v in vs]).min()
        return l.detach(), acc, min_m

    hist = _hist_loop(cfg, step, with_margin=True)
    return to_numpy(tparams), hist


def stats_pass(spec: ModelSpec, params, px: np.ndarray, device: str = "cuda"):
    """The hard forward with no noise over ``px`` -> ``[(s, mu, sd)]`` per
    weight layer on ``device``: the integer conv/FC sums and the batch
    statistics export freezes (``None`` at the final layer)."""
    dev = resolve_device(device)
    forward, _ = build_twin(spec)
    record: list = []
    with torch.no_grad():
        forward(to_torch(params, dev), torch.as_tensor(np.asarray(px), device=dev),
                record=record)
    return record


def export_trained(spec: ModelSpec, params, px: np.ndarray, device: str = "cuda") -> bytes:
    """Export trained params as ``var.dat1`` bytes (the float dump the
    reference's weight-convert build reads; layout in weight_convert.py).

    BN statistics are frozen from a full-batch pass over ``px``:
    deterministic, and exactly the statistics the training forward used on
    its final step (full-batch training)."""
    stats = [(None if mu is None else mu.cpu().numpy(), None if sd is None else sd.cpu().numpy())
             for _, mu, sd in stats_pass(spec, params, px, device)]
    arrays: List[np.ndarray] = []
    for j, (g, p) in enumerate(zip(_layer_geometry(spec), params)):
        arrays.append(np.asarray(p["w"], np.float32))
        if g["bnorm"]:
            mu, sd = stats[j]
            scale = g["scale"]
            # fold target: bias_int = scale*(-mean + beta*stddev) with
            # stddev = sqrt(var + BNORM_EPS)  (weight_convert.py); mean and
            # var are stored in the twin's float units (= s / scale)
            arrays.append(np.asarray(p["beta"], np.float32))
            arrays.append((mu / scale).astype(np.float32))
            arrays.append(((sd / scale) ** 2 - BNORM_EPS).astype(np.float32))
    return export_var_dat1(arrays)


def export_and_check(spec: ModelSpec, params, hist, px: np.ndarray, labels: np.ndarray,
                     device: str = "cuda") -> Tuple[bytes, bytes, dict]:
    """Export ``params``, weight-convert, and compare the exported plaintext
    pipeline with the trainer's hard forward on the training rows.  Returns
    (var_dat1, var_prep, report); ``twin_vs_ptxt_agreement`` is the share of
    rows where both predict the same class."""
    from ..models.spec import prep_model
    from ..runtime.ptxt import build_forward

    dev = resolve_device(device)
    raw = export_trained(spec, params, px, device)
    prep = weight_convert(spec, raw)

    forward, _ = build_twin(spec)
    with torch.no_grad():
        logits, vs = forward(to_torch(params, dev), torch.as_tensor(np.asarray(px), device=dev))
    twin_preds = logits.argmax(-1).cpu().numpy()

    plan = prep_model(spec, prep)
    ptxt_logits = build_forward(plan, device)(np.asarray(px)).cpu().numpy()
    ptxt_preds = ptxt_logits.argmax(-1)
    agree = float((twin_preds == ptxt_preds).mean())
    report = {
        "train_acc_twin": float((twin_preds == labels).mean()),
        "train_acc_ptxt": float((ptxt_preds == labels).mean()),
        "twin_vs_ptxt_agreement": agree,
        "min_abs_margin": [float(v.abs().min()) for v in vs],
        "max_abs_bound": [float(v.abs().max()) for v in vs],
        "history": hist,
    }
    return raw, prep, report


def train_and_export(spec: ModelSpec, px: np.ndarray, labels: np.ndarray,
                     cfg: TrainConfig = TrainConfig(), device: str = "cuda"
                     ) -> Tuple[bytes, bytes, dict]:
    """Train, export var.dat1, weight-convert, and self-check
    (``export_and_check``).  Returns (var_dat1, var_prep, report)."""
    params, hist = train(spec, px, labels, cfg, device=device)
    return export_and_check(spec, params, hist, px, labels, device)
