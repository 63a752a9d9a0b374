"""Encrypted operator library: REDsec layers over LWE ciphertext tensors.

A ciphertext tensor is int32 ``[B, H, W, C, n+1]`` (one LWE sample per
activation, batch leading).

- conv/fc : the reference's per-neuron ``lweAddTo`` gather/tree-reduce
            (lib/BinFunc.cpp:217-310) becomes ONE plaintext-ternary matmul
            over the ciphertext tensor, exact mod 2^32 through int8 limbs in
            fp32 (``device.int32_matmul``).
- sumpool : strided window sum (lib/BinFunc.cpp:677-732).
- sign    : add bias to the body column + one batched sign bootstrap per
            activation (lib/BinFunc.cpp:1044-1075, BinOps_enc.cpp:182-186).

Maxpool and relu (the window-OR bootstrap, the DoReFa staircase and its FDFB
variant) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.bootstrap import const_test_vector
from ..crypto.params import TfheParams
from ..crypto.torus import mod_switch_to_torus32
from ..device import int32_matmul
from ..models.spec import ConvPlan, PoolPlan, QuantPlan
from ..runtime.ptxt import gather_patches, wrap32


def ternary_matmul_ct(patches: torch.Tensor, weights: np.ndarray) -> torch.Tensor:
    """[B, P, K, R] ciphertexts x ternary [K, O] -> [B, P, O, R], exact mod 2^32."""
    w = torch.as_tensor(np.asarray(weights, np.int8), device=patches.device)
    out = int32_matmul(patches.transpose(-1, -2), w, 1)  # [B, P, R, O]
    return out.transpose(-1, -2)


def _add_body(x: torch.Tensor, mu) -> torch.Tensor:
    """Add noiseless-trivial torus constants to the body column only
    (lweNoiselessTrivial + lweAddTo, lib/BinOps_enc.cpp:274-295); ``mu``
    broadcasts against x[..., -1]."""
    mu = (np.asarray(mu, np.int64) + (1 << 31)) % (1 << 32) - (1 << 31)
    x = x.clone()
    x[..., -1] += torch.as_tensor(mu.astype(np.int32), device=x.device)
    return x


def conv_enc(plan: ConvPlan, x: torch.Tensor, msg_space: int = 4096,
             g_in: int = 1) -> torch.Tensor:
    """Encrypted conv/fc: per-tap shifted slices + ternary matmuls over
    ciphertexts (never materializes the [.., wh, ww, C, n+1] im2col tensor).

    Zero-padding contributes all-zero LWE samples — identical to the
    reference's ``lweClear`` padding (lib/BinFunc.cpp:278-284)."""
    if plan.flatten:
        x = x.reshape(x.shape[0], 1, 1, -1, x.shape[-1])
    B, R = x.shape[0], x.shape[-1]
    wh, ww = plan.weights.shape[0], plan.weights.shape[1]
    out = None
    for fh in range(wh):
        for fw in range(ww):
            tap = gather_patches(
                x, (1, 1), plan.stride,
                (plan.offset[0] - fh, plan.offset[1] - fw),
                (plan.out_h, plan.out_w),
            )  # [B, OH, OW, 1, 1, C, R]
            tap = tap.reshape(B, plan.out_h * plan.out_w, plan.in_dep, R)
            part = ternary_matmul_ct(tap, plan.weights[fh, fw])
            out = part if out is None else out + part
    out = out.reshape(B, plan.out_h, plan.out_w, plan.out_dep, R)
    if plan.neg_correction is not None:
        # integer-domain 1's-complement correction as a noiseless trivial
        # subtraction on the body column (see ConvPlan.neg_correction)
        mu = mod_switch_to_torus32(plan.neg_correction.astype(np.int64) * g_in, msg_space)
        out = _add_body(out, -mu.astype(np.int64))
    return out


def sumpool_enc(plan: PoolPlan, x: torch.Tensor) -> torch.Tensor:
    patches = gather_patches(
        x, plan.window, plan.stride, plan.offset, (plan.out_h, plan.out_w)
    )
    return wrap32(patches.to(torch.int64).sum(dim=(3, 4)))


def quant_sign_pre(plan: QuantPlan, x: torch.Tensor, params: TfheParams,
                   out_value: int = 1, g_in: int = 1, tie_break=None):
    """PBS boundary for the sign activation: (biased x, tv [N]); the caller
    flattens to [m, R], bootstraps, reshapes back.

    ``out_value``: message value of the +-output.  ``tie_break``: optional
    bool [H, W, C] parity mask (PbsRange.tie_break): positions whose
    achievable pre+bias values are all EVEN get +g_in added to the phase,
    lifting exact-zero ties to full-gain margins while preserving the sign of
    every achievable value."""
    total = plan.bias.astype(np.int64)
    if tie_break is not None:
        total = total[None, None, :] + np.asarray(tie_break, np.int64)  # [H, W, C]
    x = _add_body(x, mod_switch_to_torus32(total * g_in, params.msg_space))
    tv = torch.as_tensor(const_test_vector(params, out_value, params.msg_space),
                         device=x.device)
    return x, tv


def quant_sign_enc(plan: QuantPlan, x: torch.Tensor, pbs, params: TfheParams,
                   out_value: int = 1, g_in: int = 1, tie_break=None) -> torch.Tensor:
    """Sign activation: bias add + one sign bootstrap per activation."""
    xb, tv = quant_sign_pre(plan, x, params, out_value, g_in, tie_break)
    return pbs(xb.reshape(-1, xb.shape[-1]), tv).reshape(xb.shape)


def quant_add_bias_enc(plan: QuantPlan, x: torch.Tensor, params: TfheParams,
                       g_in: int = 1, center: "np.ndarray | None" = None) -> torch.Tensor:
    """Leveled bias add (BinFunc.cpp:1085-1107).  ``center``: optional
    per-class decrypt-centering shift [C], folded into the same noiseless
    body add; the decryptor subtracts it (decrypt_scores(centers=...))."""
    b = plan.bias.astype(np.int64)
    if center is not None:
        b = b + np.asarray(center, np.int64)
    return _add_body(x, mod_switch_to_torus32(b * g_in, params.msg_space))
