"""Device resolution and kernel launch counters.

Every entry point of the package takes ``device`` and defaults to ``"cuda"``;
asking for CUDA where PyTorch has none raises instead of quietly running on the
CPU.  The CPU is used only when the caller names it (the tests do).

``launches`` counts, per kernel name, how often a wrapper in
``crypto/kernels.py`` launched its CUDA kernel.  A run resets it, drives the
main path and reads it back to show which kernels carried that path.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it is CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested (the default) but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class LaunchCounter:
    """Per-kernel launch counts (plain integers)."""

    def __init__(self):
        self.counts: dict[str, int] = {}

    def bump(self, name: str) -> None:
        self.counts[name] = self.counts.get(name, 0) + 1

    def reset(self) -> None:
        self.counts.clear()

    def get(self, name: str) -> int:
        return self.counts.get(name, 0)


launches = LaunchCounter()


def int32_matmul(x: torch.Tensor, w: torch.Tensor, w_max: int) -> torch.Tensor:
    """Exact ``x @ w`` mod 2^32 for int32 ``x`` [..., K] and a small-integer
    ``w`` [K, O] with |w| <= ``w_max``.

    torch.matmul has no int32 path on CUDA, so ``x`` is split into four
    sign-balanced 8-bit limbs and each limb product runs in fp32: every
    partial sum is an integer of magnitude <= K * 128 * w_max < 2^24, which
    fp32 holds exactly in any summation order.  TF32 would drop those bits,
    so it is switched off for CUDA matmuls here
    (``torch.backends.cuda.matmul.allow_tf32 = False``).  The limb products
    recombine with int32 wraparound, the same arithmetic on CPU and CUDA."""
    K = x.shape[-1]
    if K * 128 * max(w_max, 1) >= 1 << 24:
        raise ValueError(f"contraction {K} x |w|<={w_max} exceeds the exact fp32 range")
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    wf = w.to(torch.float32)
    out, cur = None, x.to(torch.int32)
    for i in range(4):
        lo = ((cur + 128) & 255) - 128 if i < 3 else cur
        cur = (cur - lo) >> 8
        part = torch.matmul(lo.to(torch.float32), wf).to(torch.int32)
        part = part * (1 << (8 * i))
        out = part if out is None else out + part
    return out
