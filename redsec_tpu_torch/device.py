"""Device resolution, the package's instruments and the card's timers.

Every entry point of the package takes ``device`` and defaults to ``"cuda"``;
asking for CUDA where PyTorch has none raises instead of quietly running on the
CPU.  The CPU is used only when the caller names it (the tests do).

``launches`` counts, per kernel name, how often a wrapper in
``crypto/kernels.py`` launched its CUDA kernel.  A run resets it, drives the
main path and reads it back to show which kernels carried that path.

``span(name)`` marks a layer of the encrypted forward: the forward itself,
each layer, the leveled operators and each stage of a bootstrap.  While no
``torch.profiler`` session records, a span is one test of the profiler's flag
and does nothing.  While one records, a span is a
``record_function("redsec/<name>")`` range in the profiler's trace, on the
clock of the kernels inside it, and ``spans`` keeps it: its host start and
end, its parent, the request (the outermost span) it belongs to and, on a
CUDA request, a pair of CUDA events around it.  ``upload`` turns a host array
into a tensor on the device as ``torch.as_tensor`` does (on CUDA a blocking
copy) and counts it in the open request as ``forward.uploads``.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch
import torch.autograd.profiler as _profiler


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

SPAN_PREFIX = "redsec/"  # the profiler's name of span ``x`` is ``redsec/x``
UPLOADS = "forward.uploads"


class _NoSpan:
    """The span while no profiler records: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _SpanRecord:
    """One span: its name, its parent's index in the request's list (None
    for the outermost), its own index, its host start and end
    (``perf_counter_ns``) and its CUDA events (None off CUDA)."""

    __slots__ = ("name", "parent", "index", "t0", "t1", "start", "end")

    def __init__(self, name: str, parent: "int | None", index: int):
        self.name, self.parent, self.index = name, parent, index
        self.start = self.end = None


class _Request:
    """One outermost span and everything inside it: ``spans`` in the order
    they opened, ``counters`` by name."""

    __slots__ = ("id", "cuda", "spans", "counters")

    def __init__(self, rid: int, cuda: bool):
        self.id, self.cuda, self.spans, self.counters = rid, cuda, [], {}


@dataclasses.dataclass
class SpanRead:
    """What ``SpanStore.read`` gives for the last k requests."""

    requests: list  # per request: {"id", "root", "spans", "counters"}; each span a dict
    # of "name", "parent" (index in its request's list, None for the root),
    # "host_ms" and "device_ms" (None off CUDA)
    host_ms: dict  # span name -> host ms summed over the requests
    device_ms: dict  # span name -> device interval ms summed (empty off CUDA)
    counters: dict  # counter -> sum over the requests


class SpanStore:
    """The spans and counters of the last ``keep`` requests, in memory.

    A span opened while none is open starts a request; ``dev`` (a CUDA
    device) has that request's spans record a CUDA event pair on the current
    stream, read only in ``read``.  A span's device interval is the time
    between its two events on the device's clock: its kernels and whatever
    idle time the host leaves inside it, not the device's busy time.  One
    thread opens spans (the forward's)."""

    def __init__(self, keep: int = 1024):
        self.requests: collections.deque = collections.deque(maxlen=keep)
        self._open: list = []  # the open spans' records, outermost first
        self._next = 0

    def open(self, name: str, dev) -> None:
        if not self._open:
            cuda = dev is not None and torch.device(dev).type == "cuda"
            self.requests.append(_Request(self._next, cuda))
            self._next += 1
        req = self.requests[-1]
        rec = _SpanRecord(name, self._open[-1].index if self._open else None, len(req.spans))
        req.spans.append(rec)
        self._open.append(rec)
        if req.cuda:
            rec.start = torch.cuda.Event(enable_timing=True)
            rec.start.record()
        rec.t0 = time.perf_counter_ns()

    def close(self) -> None:
        rec = self._open.pop()
        rec.t1 = time.perf_counter_ns()
        if rec.start is not None:
            rec.end = torch.cuda.Event(enable_timing=True)
            rec.end.record()

    def innermost(self) -> "str | None":
        return self._open[-1].name if self._open else None

    def bump(self, counter: str, times: int = 1) -> None:
        """Add ``times`` to ``counter`` of the open request (none open: nothing)."""
        if self._open:
            c = self.requests[-1].counters
            c[counter] = c.get(counter, 0) + times

    def read(self, k: int) -> SpanRead:
        """The last ``k`` finished requests (fewer where fewer are kept), with
        one synchronize before the CUDA events are read."""
        done = list(self.requests)[:-1] if self._open else list(self.requests)
        reqs = done[max(0, len(done) - k):] if k > 0 else []
        if any(r.cuda for r in reqs):
            torch.cuda.synchronize()
        out, host, device, counters = [], {}, {}, {}
        for r in reqs:
            rows = []
            for s in r.spans:
                h = (s.t1 - s.t0) / 1e6
                d = s.start.elapsed_time(s.end) if s.start is not None else None
                rows.append({"name": s.name, "parent": s.parent, "host_ms": h, "device_ms": d})
                host[s.name] = host.get(s.name, 0.0) + h
                if d is not None:
                    device[s.name] = device.get(s.name, 0.0) + d
            for c, v in r.counters.items():
                counters[c] = counters.get(c, 0) + v
            out.append({"id": r.id, "root": r.spans[0].name, "spans": rows,
                        "counters": dict(r.counters)})
        return SpanRead(out, host, device, counters)


spans = SpanStore()


class _Span:
    __slots__ = ("name", "dev", "rf")

    def __init__(self, name: str, dev):
        self.name, self.dev = name, dev

    def __enter__(self):
        self.rf = _profiler.record_function(SPAN_PREFIX + self.name)
        self.rf.__enter__()
        spans.open(self.name, self.dev)
        return None

    def __exit__(self, *exc):
        spans.close()
        return self.rf.__exit__(*exc)


def span(name: str, dev=None):
    """A context manager around one layer's work, named ``name``.  With no
    profiler recording it is a shared object that does nothing; with one, a
    span (see the module's docstring).  ``dev`` matters only to an outermost
    span: its request records CUDA events if ``dev`` is a CUDA device.  A
    span inside one of its own name adds nothing, so a leveled operator that
    calls another stays one leaf."""
    if not _profiler._is_profiler_enabled or spans.innermost() == name:
        return _NO_SPAN
    return _Span(name, dev)


def upload(a, device, dtype: "torch.dtype | None" = None) -> torch.Tensor:
    """``torch.as_tensor(a, dtype=dtype, device=device)``, exactly (on CUDA a
    blocking copy from a host array); while a profiler records, a host array
    (anything but a tensor already on ``device``'s type) counts one in the
    open request's ``forward.uploads``."""
    if _profiler._is_profiler_enabled and not (
            isinstance(a, torch.Tensor) and a.device.type == torch.device(device).type):
        spans.bump(UPLOADS)
    return torch.as_tensor(a, dtype=dtype, device=device)


def is_annotation(key: str) -> bool:
    """Whether a profiler row named ``key`` is an annotation's range (a
    schedule's step or a span) and not an operation of the device."""
    return key.startswith(("ProfilerStep", SPAN_PREFIX))


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
        # the step's annotation and the spans have ranges on the device's timeline too
        evs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and not is_annotation(e.key)]
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
