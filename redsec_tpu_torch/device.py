"""Device resolution, kernel launch counters and the card's timers.

Every entry point of the package takes ``device`` and defaults to ``"cuda"``;
asking for CUDA where PyTorch has none raises instead of quietly running on the
CPU.  The CPU is used only when the caller names it (the tests do).

``launches`` counts, per kernel name, how often a wrapper in
``crypto/kernels.py`` launched its CUDA kernel.  A run resets it, drives the
main path and reads it back to show which kernels carried that path.
"""

from __future__ import annotations

import time

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

    def bump(self, name: str, times: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + times

    def reset(self) -> None:
        self.counts.clear()

    def get(self, name: str) -> int:
        return self.counts.get(name, 0)


launches = LaunchCounter()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean time of ``fn()`` on the card over ``reps`` calls, CUDA events,
    after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn``: ``calls`` calls on
    ``time.perf_counter_ns`` with no synchronize between them, then one
    outside the clock.  Where the card keeps up, this is the launch path's
    own cost: the wrapper's checks, its output's allocation, the C entry and
    the launch."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / calls / 1e3


def device_ms(fn, kernel: str, reps: int = 20, per_call: int | None = 1, tries: int = 5,
              required: bool = True) -> tuple[float | None, float | None, int, int]:
    """Device time of ``fn`` by torch.profiler, where CUDA events around a
    launch shorter than its host path time the host.  Returns (ms a call of
    the CUDA kernels whose name holds ``kernel``, ms a call of every CUDA
    kernel, launches of the named kernels seen, traces taken again); ``""``
    names every kernel.

    ``reps`` calls are traced, and each must launch ``per_call`` named
    kernels (``None``: the same number each call, whatever it is).  The
    trace starts a step early (the tracer can miss the first launch after it
    starts).  The tracer also drops launches for reasons not found (a fresh
    process sees them all; deep into a long one it has seen half of a
    trace's, trace after trace, and none of a one-call trace), so a time is
    taken only from a trace that saw every launch: one that saw fewer is
    taken again, ``tries`` traces in all, and then this raises, or with
    ``required`` false answers (None, None, launches seen, traces taken
    again); one that saw more raises at once."""
    from torch.profiler import ProfilerActivity, profile, schedule

    want = None if per_call is None else reps * per_call
    for retries in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()  # leaving the context ends the recorded step and keeps it
        # the step's own annotation has a span on the device's timeline too
        evs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]
        named = [e for e in evs if kernel in e.key]
        seen = sum(e.count for e in named)
        if want is not None and seen > want:
            raise RuntimeError(f"the profiler saw {seen} launches of {kernel} in {reps} calls "
                               f"of {per_call}")
        if seen and (seen == want if want is not None else seen % reps == 0):
            return (sum(e.self_device_time_total for e in named) / reps / 1e3,
                    sum(e.self_device_time_total for e in evs) / reps / 1e3, seen, retries)
        print(f"the profiler saw {seen} launches of {kernel or 'any kernel'} in {reps} calls; "
              f"tracing again", flush=True)
    msg = (f"the profiler saw {seen} launches of {kernel or 'any kernel'} in {reps} calls of "
           f"{per_call or 'the same number'} (trace {tries} of {tries})")
    if required:
        raise RuntimeError(msg)
    print(f"device time not measured: {msg}", flush=True)
    return None, None, seen, tries - 1


def int32_matmul(x: torch.Tensor, w: torch.Tensor, w_max: int) -> torch.Tensor:
    """Exact ``x @ w`` mod 2^32 for int32 ``x`` [..., K] and a small-integer
    ``w`` [K, O] with |w| <= ``w_max``, for any K.

    torch.matmul has no int32 path on CUDA, so ``x`` is split into four
    sign-balanced 8-bit limbs and each limb product runs in fp32.  The
    contraction runs in chunks of K short enough that every partial sum is an
    integer of magnitude <= chunk * 128 * w_max < 2^24, which fp32 holds
    exactly in any summation order; the chunks' int32 results add with
    wraparound, as the limb products recombine, so the same arithmetic holds
    on CPU and CUDA and the fp32 copies never exceed one chunk.  TF32 would
    drop those bits, so it is switched off for CUDA matmuls here
    (``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    K = x.shape[-1]
    chunk = ((1 << 24) - 1) // (128 * max(w_max, 1))
    if chunk == 0:
        raise ValueError(f"|w| <= {w_max}: one limb product can exceed fp32's exact range")
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    out = None
    for k0 in range(0, K, chunk):
        part = _limb_matmul(x[..., k0:k0 + chunk], w[k0:k0 + chunk])
        out = part if out is None else out + part
    return out


def _limb_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` mod 2^32 through four 8-bit limbs of ``x`` in fp32, exact
    while the contraction keeps every partial sum below 2^24."""
    wf = w.to(torch.float32)
    out, cur = None, x.to(torch.int32)
    for i in range(4):
        lo = ((cur + 128) & 255) - 128 if i < 3 else cur
        cur = (cur - lo) >> 8
        part = torch.matmul(lo.to(torch.float32), wf).to(torch.int32)
        part = part * (1 << (8 * i))
        out = part if out is None else out + part
    return out
