"""Plaintext execution engine — the bit-exact oracle for the encrypted path.

Activations live in the +-1 integer domain throughout (the reference stores
binary activations as bits {0,1} encoding {-1,+1}, BinLayer.h:34-35), so a
layer is:

    conv/fc:   int32 matmul with plaintext ternary weights {-1,0,+1}
    sumpool:   strided window sum
    sign:      (x + bias) >= 0 -> +-1           (BinOps.cpp:207-217 via add)
    add_bias:  x + bias                          (BinFunc.cpp:1085-1107)
    relu:      clamp((x*slope + bias) >> slope_bits, 0, 2^shift-1)
                                                 (IntFunc.cpp:953-969 + IntOps)
    maxpool:   window max in the +-1 domain      (== bitwise OR, BinOps.cpp:180-193)

All arithmetic is int32 with two's-complement wraparound, matching the C++.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..device import int32_matmul, resolve_device
from ..models.spec import Activation, ConvPlan, LayerPlan, ModelPlan, PoolPlan, QuantPlan


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's-complement wraparound)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def gather_patches(x: torch.Tensor, window, stride, offset, out_hw, fill_value=0):
    """Extract conv/pool windows with boundary masking.

    ``x``: [B, H, W, C, ...] (any trailing dims).  Returns
    [B, OH, OW, wh, ww, C, ...] with out-of-bounds positions set to
    ``fill_value`` — the reference's zero-padding (BinFunc.cpp:271-294) and
    pool-window clipping (BinFunc.cpp:709-716).
    """
    B, H, W = x.shape[0], x.shape[1], x.shape[2]
    wh, ww = window
    oh, ow = out_hw
    dev = x.device
    idx_h = torch.arange(oh, device=dev)[:, None] * stride[0] \
        + torch.arange(wh, device=dev)[None, :] - offset[0]
    idx_w = torch.arange(ow, device=dev)[:, None] * stride[1] \
        + torch.arange(ww, device=dev)[None, :] - offset[1]
    ok_h = (idx_h >= 0) & (idx_h < H)
    ok_w = (idx_w >= 0) & (idx_w < W)

    g = torch.index_select(x, 1, idx_h.clamp(0, H - 1).reshape(-1))
    g = g.reshape(B, oh, wh, *x.shape[2:])
    g = torch.index_select(g, 3, idx_w.clamp(0, W - 1).reshape(-1))
    g = g.reshape(B, oh, wh, ow, ww, *x.shape[3:])
    g = torch.movedim(g, 3, 2)  # [B, OH, OW, wh, ww, C, ...]

    mask = ok_h[:, None, :, None] & ok_w[None, :, None, :]  # [OH, OW, wh, ww]
    mask = mask.reshape((1,) + tuple(mask.shape) + (1,) * (g.ndim - 5))
    return torch.where(mask, g, torch.tensor(fill_value, dtype=x.dtype, device=dev))


def conv_ptxt(plan: ConvPlan, x: torch.Tensor) -> torch.Tensor:
    """Ternary-weight convolution as patch-gather + exact int32 matmul
    (BinFunc.cpp:142-330 Loop1/Loop2 collapsed into one contraction)."""
    if plan.flatten:
        x = x.reshape(x.shape[0], 1, 1, -1)
    patches = gather_patches(
        x, (plan.weights.shape[0], plan.weights.shape[1]), plan.stride, plan.offset,
        (plan.out_h, plan.out_w),
    )
    B = x.shape[0]
    k = plan.weights.shape[0] * plan.weights.shape[1] * plan.in_dep
    patches = patches.reshape(B, plan.out_h * plan.out_w, k)
    w = torch.as_tensor(plan.weights.reshape(k, plan.out_dep), device=x.device)
    out = int32_matmul(patches, w, 1)
    if plan.neg_correction is not None:
        out = out - torch.as_tensor(plan.neg_correction.astype(np.int32), device=x.device)
    return out.reshape(B, plan.out_h, plan.out_w, plan.out_dep)


def sumpool_ptxt(plan: PoolPlan, x: torch.Tensor) -> torch.Tensor:
    patches = gather_patches(x, plan.window, plan.stride, plan.offset, (plan.out_h, plan.out_w))
    return wrap32(patches.to(torch.int64).sum(dim=(3, 4)))


def maxpool_ptxt(plan: PoolPlan, x: torch.Tensor) -> torch.Tensor:
    patches = gather_patches(
        x, plan.window, plan.stride, plan.offset, (plan.out_h, plan.out_w),
        fill_value=int(np.iinfo(np.int32).min),
    )
    return patches.amax(dim=(3, 4))


def _bias(plan: QuantPlan, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(plan.bias.astype(np.int32), device=x.device)


def quant_sign_ptxt(plan: QuantPlan, x: torch.Tensor) -> torch.Tensor:
    return torch.where(x + _bias(plan, x) >= 0, 1, -1).to(x.dtype)


def quant_add_bias_ptxt(plan: QuantPlan, x: torch.Tensor) -> torch.Tensor:
    return x + _bias(plan, x)


def quant_relu_ptxt(plan: QuantPlan, x: torch.Tensor) -> torch.Tensor:
    """DoReFa discretized ReLU (IntFunc.cpp:953-969):
    y = (x*slope + bias) >> slope_bits, then clamp to [0, 2^shift_bits - 1]."""
    slope = torch.as_tensor(plan.slope.astype(np.int32), device=x.device)
    y = x * slope + _bias(plan, x)
    y = y >> plan.slope_bits  # arithmetic shift on int32
    top = (1 << plan.shift_bits) - 1
    return y.clamp(0, top).to(x.dtype)


def layer_forward_ptxt(plan: LayerPlan, x: torch.Tensor) -> torch.Tensor:
    if plan.conv is not None:
        x = conv_ptxt(plan.conv, x)
    if plan.sumpool is not None:
        x = sumpool_ptxt(plan.sumpool, x)
    q = plan.quant
    if q.mode == Activation.SIGN:
        x = quant_sign_ptxt(q, x)
    elif q.mode == Activation.NONE:
        x = quant_add_bias_ptxt(q, x)
    else:
        x = quant_relu_ptxt(q, x)
    if plan.maxpool is not None:
        x = maxpool_ptxt(plan.maxpool, x)
    return x


def build_forward(model: ModelPlan, device: str = "cuda") -> Callable[[torch.Tensor], torch.Tensor]:
    """Build the plaintext forward: int32 [B, H, W, C] -> logits int32 [B, classes]."""
    dev = resolve_device(device)

    def forward(x) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                            device=dev).to(torch.int32)
        for layer in model.layers:
            x = layer_forward_ptxt(layer, x)
        return x.reshape(x.shape[0], -1)

    return forward


def predict(model: ModelPlan, images: np.ndarray, batch_size: int = 256,
            device: str = "cuda") -> np.ndarray:
    """Run the model over converted-pixel images [N,H,W,C] -> predicted classes [N]."""
    fwd = build_forward(model, device)
    preds = []
    for i in range(0, len(images), batch_size):
        logits = fwd(np.asarray(images[i : i + batch_size])).cpu().numpy()
        preds.append(logits.argmax(axis=1))
    return np.concatenate(preds)
