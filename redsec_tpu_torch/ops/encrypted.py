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
- maxpool : the reference ORs pairwise with one bootstrap per element
            (lib/BinOps_enc.cpp:164-167); here the window OR is a single
            biased sign bootstrap per OUTPUT:
            OR(x_1..x_w) = sign(sum x_i + (w-1)) for +-1 inputs.
- relu    : DoReFa relu_shift as ONE programmable bootstrap per activation
            with a per-channel test vector implementing the exact plaintext
            staircase clamp((slope*x + bias) >> slope_bits, 0, 2^shift-1)
            via the half-torus trick (valid while |conv output| < msize/4),
            or as the 3-bootstrap full-range variant (FDFB, valid to msize/2).

The test-vector builders are numpy; ciphertext arithmetic relies on torch's
int32 wraparound in add and subtract.
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


def maxpool_sign_value(plan: PoolPlan, params: TfheParams) -> int:
    """Message value V of the +-signs feeding a window-OR maxpool.

    OR(x_1..x_w) = sign(sum x_i + (w-1)V): the margin around the decision
    boundary is V, and the largest magnitude reached is (2w-2)V (all-true
    window with the (w-2)V bias), so V = msize/(4w) keeps every value
    strictly inside the +-msize/2 budget while making the margin ~2 orders
    above the mod-switch noise (a +-1 encoding would put the margin at half
    a rotation slot — noise-dominated)."""
    w = plan.window[0] * plan.window[1]
    return max(1, params.msg_space // (4 * w))


def _staircase_i64(plan: QuantPlan, v: np.ndarray, g_in: int = 1,
                   center: "np.ndarray | None" = None) -> np.ndarray:
    """The DoReFa staircase clamp((slope*v + bias) >> slope_bits, 0, top) on
    int64 message-space values v [M] -> [C, M] (IntFunc.cpp:953-969).

    ``g_in``: the encoding gain of v (a power of two).  The staircase of the
    UNSCALED value x = v/g folds exactly into integer arithmetic:
    (slope*(g*x) + g*bias) >> (slope_bits + log2 g) == (slope*x + bias) >>
    slope_bits for any integer x.

    ``center``: per-channel shift s [C]: v = g*(x + s) for true value x;
    staircase(x) folds via bias' = bias - slope*s (still exact integers)."""
    if g_in < 1 or g_in & (g_in - 1):
        raise ValueError(f"g_in must be a power of two, got {g_in}")
    slope = plan.slope.astype(np.int64)[:, None]
    bias = plan.bias.astype(np.int64)[:, None]
    if center is not None:
        bias = bias - slope * np.asarray(center, np.int64)[:, None]
    bias = bias * g_in
    sb = plan.slope_bits + (g_in.bit_length() - 1)
    y = (slope * v[None, :].astype(np.int64) + bias) >> sb
    return np.clip(y, 0, (1 << plan.shift_bits) - 1)


def relu_test_vectors(plan: QuantPlan, params: TfheParams, g_in: int = 1, g_out: int = 1,
                      center: "np.ndarray | None" = None) -> np.ndarray:
    """Per-channel programmable test vectors [C, N] for the DoReFa relu
    staircase.

    With the half-torus pre-bias R = msize/4, rotation j represents input
    value v = round(j * msize / 2N) - R; the output is the exact plaintext
    formula clamp((slope*v + bias) >> slope_bits, 0, 2^shift - 1)
    (IntFunc.cpp:953-969 semantics).

    ``center``: optional per-channel re-encoding shift [C] (ungained units):
    the ciphertext arrives as g_in*(x + center) and the staircase of the
    TRUE value x folds exactly into the vector (see _staircase_i64)."""
    N, msize = params.N, params.msg_space
    R = msize // 4
    j = np.arange(N)
    v = np.round(j * msize / (2 * N)).astype(np.int64) - R  # [-R, R)
    out = _staircase_i64(plan, v, g_in, center) * g_out
    return mod_switch_to_torus32(out, msize).astype(np.int32)


def relu_fdfb_test_vectors(plan: QuantPlan, params: TfheParams, g_in: int = 1,
                           g_out: int = 1, center: "np.ndarray | None" = None):
    """Odd/even test vectors for the FULL-range (|v| < msize/2) relu, plus a
    per-channel torus constant.

    Any f over the msize message space splits as f = O + E with
    O(v + msize/2) = -O(v) (anti-periodic: directly PBS-evaluable) and
    E(v + msize/2) = E(v) (periodic: evaluable on u = (v mod msize/2), which
    one sign bootstrap recovers).  Rotation j represents u_j = round(j *
    msize / 2N) in [0, msize/2); O/E there are (F(u) -/+ F(u - msize/2))/2.

    Seam correction: when v is within the mod-switch noise band of 0, the
    even PBS input u sits at ITS modular seam, where a wrap flips the read to
    -E.  Shifting the even part by the constant c = (F(0) + F(-1) + F(top) +
    F(bottom))/4 and adding c back as a plaintext trivial makes all four
    read-branch combinations agree near v~0 (the odd and sign bootstraps
    share one input ciphertext, hence one deterministic mod-switch, so they
    can never disagree with each other).  Residual near-seam error is then
    bounded by the staircase's local variation over the noise band — the
    same contract as the plain sign bootstrap's.

    Returns (tv_odd [C,N], tv_even_shifted [C,N], c_torus [C] int32).
    """
    N, msize = params.N, params.msg_space
    u = np.round(np.arange(N) * msize / (2 * N)).astype(np.int64)
    ms = lambda y: mod_switch_to_torus32(y, msize).astype(np.int64)  # noqa: E731
    a = ms(_staircase_i64(plan, u, g_in, center) * g_out)
    b = ms(_staircase_i64(plan, u - msize // 2, g_in, center) * g_out)
    tv_odd = ((a - b) >> 1).astype(np.int32)  # arithmetic shift on int64
    tv_even = (a + b) >> 1
    edge = np.array([0, -1, msize // 2 - 1, -msize // 2], np.int64)
    c = (ms(_staircase_i64(plan, edge, g_in, center) * g_out).sum(axis=1) // 4
         ).astype(np.int64)  # [C]
    tv_even = (tv_even - c[:, None]).astype(np.int32)
    return tv_odd, tv_even, c.astype(np.int32)


def _add_center(x: torch.Tensor, center, g_in: int, msize: int) -> torch.Tensor:
    """Per-channel re-encoding shift: ciphertext v -> v + g_in*center, exact
    noiseless body add.  Centers an asymmetric pre-activation range so the
    PBS budget covers (hi-lo)/2 instead of max(|lo|,|hi|) (runtime/ranges.py
    chooses the shifts; the matching test vectors fold them back out)."""
    if center is None:
        return x
    return _add_body(x, mod_switch_to_torus32(np.asarray(center, np.int64) * g_in, msize))


def _per_channel(rows: np.ndarray, m: int, device) -> torch.Tensor:
    """Per-channel rows [C, ...] repeated over the m // C positions of a
    flattened [.., C] activation tensor -> [m, ...] (channel fastest)."""
    t = torch.as_tensor(rows, device=device)
    return t[None].expand(m // t.shape[0], *t.shape).reshape(m, *t.shape[1:])


def quant_relu_fdfb_stage1(plan: QuantPlan, x: torch.Tensor, params: TfheParams,
                           g_in: int = 1, center=None):
    """FDFB part 1: flat (centered) ciphertexts [m, n+1] + the sign test
    vector [N]."""
    x = _add_center(x, center, g_in, params.msg_space)
    flat = x.reshape(-1, x.shape[-1])
    tv_sign = torch.as_tensor(
        const_test_vector(params, params.msg_space // 4, params.msg_space), device=x.device)
    return flat, tv_sign


def quant_relu_fdfb_stage2(plan: QuantPlan, flat: torch.Tensor, s: torch.Tensor,
                           params: TfheParams, g_in: int = 1, g_out: int = 1, center=None):
    """FDFB part 2: leveled glue + the two programmable test vectors, each
    [m, N] (per-channel), plus the seam constant row [m].  ``flat`` must
    already be centered (stage 1 applied the shift); ``s`` is the sign
    bootstrap's output, an LWE of +-msize/4."""
    msize = params.msg_space
    # phase of ct2 = (v mod msize/2); the subtraction wraps in int32
    ct2 = _add_body(flat - s, mod_switch_to_torus32(msize // 4, msize))
    tv_odd, tv_even, c = relu_fdfb_test_vectors(plan, params, g_in, g_out, center)
    m = flat.shape[0]
    return (ct2, _per_channel(tv_odd, m, flat.device), _per_channel(tv_even, m, flat.device),
            _per_channel(c, m, flat.device))


def quant_relu_fdfb_enc(plan: QuantPlan, x: torch.Tensor, pbs, params: TfheParams,
                        g_in: int = 1, g_out: int = 1, center=None) -> torch.Tensor:
    """Full-range DoReFa relu: 3 bootstraps per activation, valid while
    |conv output| < msize/2 — the same leveled budget as the reference's
    sign-then-select relu chain (lib/IntFunc.cpp:860-973, bootsMUX at
    :957-962), at 3 PBS vs its 1 + bits MUX bootstraps.

    out = PBS_odd(v) + PBS_even(v - sign(v)*msize/4 + msize/4) + c."""
    flat, tv_sign = quant_relu_fdfb_stage1(plan, x, params, g_in, center)
    s = pbs(flat, tv_sign)  # LWE of +-msize/4
    ct2, tvs_o, tvs_e, c_flat = quant_relu_fdfb_stage2(plan, flat, s, params, g_in, g_out,
                                                       center)
    out = pbs(flat, tvs_o) + pbs(ct2, tvs_e)
    out[:, -1] += c_flat  # plaintext trivial of the seam constant
    return out.reshape(x.shape)


def quant_relu_pre(plan: QuantPlan, x: torch.Tensor, params: TfheParams, g_in: int = 1,
                   g_out: int = 1, center=None):
    """PBS boundary for the DoReFa relu: (pre-biased x, per-activation tv
    [m, N]); the caller flattens to [m, R], bootstraps, reshapes back."""
    msize = params.msg_space
    x = _add_center(x, center, g_in, msize)
    x = _add_body(x, mod_switch_to_torus32(msize // 4, msize))  # into [0, msize/2)
    tvs = relu_test_vectors(plan, params, g_in, g_out, center)
    return x, _per_channel(tvs, x.numel() // x.shape[-1], x.device)


def quant_relu_enc(plan: QuantPlan, x: torch.Tensor, pbs, params: TfheParams,
                   g_in: int = 1, g_out: int = 1, center=None) -> torch.Tensor:
    """DoReFa relu as one per-channel programmable bootstrap.

    Valid while the conv output magnitude stays below msize/4 (half-torus
    trick); beyond that the phase wraps, exactly like the reference's leveled
    accumulation beyond its 4096 message space."""
    xb, tv_all = quant_relu_pre(plan, x, params, g_in, g_out, center)
    return pbs(xb.reshape(-1, xb.shape[-1]), tv_all).reshape(xb.shape)


def maxpool_pre(plan: PoolPlan, x: torch.Tensor, params: TfheParams, g_out: int = 1):
    """PBS boundary for the window-OR maxpool: (biased window sums
    [B, OH, OW, C, R], tv [N]); caller flattens, bootstraps, reshapes."""
    V = maxpool_sign_value(plan, params)
    s = sumpool_enc(plan, x)  # [B, OH, OW, C, R]; out-of-bounds slots are zero
    # per-position in-bounds count (static geometry, computed host-side)
    ih = (np.arange(plan.out_h)[:, None] * plan.stride[0]
          + np.arange(plan.window[0])[None, :] - plan.offset[0])
    iw = (np.arange(plan.out_w)[:, None] * plan.stride[1]
          + np.arange(plan.window[1])[None, :] - plan.offset[1])
    ok_h = ((ih >= 0) & (ih < plan.in_h)).sum(axis=1)  # [OH]
    ok_w = ((iw >= 0) & (iw < plan.in_w)).sum(axis=1)  # [OW]
    counts = ok_h[:, None] * ok_w[None, :]  # [OH, OW]
    s = _add_body(s, mod_switch_to_torus32((counts - 1) * V, params.msg_space)[:, :, None])
    tv = torch.as_tensor(const_test_vector(params, g_out, params.msg_space), device=x.device)
    return s, tv


def maxpool_enc(plan: PoolPlan, x: torch.Tensor, pbs, params: TfheParams,
                g_out: int = 1) -> torch.Tensor:
    """Window OR via one biased sign bootstrap per output element.

    Inputs are +-V sign bits (V = maxpool_sign_value, produced by the
    preceding sign stage); OR = sign(sum + (count-1)V), margin +-V.  The
    reference instead ORs pairwise with one bootstrap per ELEMENT in gate
    space (lib/BinOps_enc.cpp:164-167); one biased bootstrap per OUTPUT with
    a gate-scale margin is strictly cheaper at equal robustness.
    Out-of-bounds window slots contribute zero ciphertexts and are excluded
    from the count."""
    s, tv = maxpool_pre(plan, x, params, g_out)
    return pbs(s.reshape(-1, s.shape[-1]), tv).reshape(s.shape)
