"""The trace reader: a block of requests under torch.profiler, read from its
Chrome trace.

What it gives (``Trace``): the block's length on the host's clock, the device's
busy seconds (the union of kernel, copy and set intervals), device seconds and
records by kernel, the idle gaps inside the block with what the host was
doing in each, and the program's launch counters over the block.

No number comes from a partial trace.  The tracer drops kernel records now
and then, so a trace is kept only if every kernel launch it recorded on the
host (``cudaLaunch*`` and ``cuLaunch*``) has its kernel record, by the
correlation id, and each counted kernel of the program has as many records
as its counter rose (the guard of the port's ``device.device_ms``).  Else the
block is traced again, ``tries`` times in all, and then this raises.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
LAUNCHES = ("cudaLaunch", "cuLaunch")
REQUEST = "request"  # the annotation around each traced request

# the program's launch counters (device.launches) and the kernel each counts
COUNTED = {"blind_rotate": "blind_rotate_kernel", "schoolbook_round": "schoolbook_round_kernel",
           "ntt": "ntt_kernel", "cmux_round": "cmux_round_kernel",
           "external_product": "external_product_kernel",
           "blind_rotate_mm": "blind_rotate_mm_kernel", "cmux_round_mm": "cmux_round_mm",
           "external_product_mm": "external_product_mm", "schoolbook_product": "schoolbook_mma"}


@dataclasses.dataclass
class Trace:
    window_s: float  # the traced block on the host's clock
    busy_s: float  # union of the device's operation intervals
    kernels: dict  # short name -> [records, device seconds]
    gaps: dict  # host activity -> idle seconds of the device
    counters: dict  # program launch counter -> rise over the block
    requests: int
    images: int


def short_name(name: str) -> str:
    """A kernel's name without 'void ', anonymous namespaces and its argument
    list, cut to 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].strip()
    return (name[5:] if name.startswith("void ") else name)[:120]


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(events: list, counters: dict, window_s: float, requests: int, images: int):
    """A Trace from a Chrome trace's events, or the reason it is partial."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    kern_corr = {e["args"].get("correlation") for e in dev if e["cat"] == "kernel"}
    launched = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("name", "").startswith(LAUNCHES)]
    missing = sum(1 for e in launched if e["args"].get("correlation") not in kern_corr)
    if missing:
        return f"{missing} of {len(launched)} kernel launches have no kernel record"
    kernels = {}
    for e in dev:
        k = kernels.setdefault(short_name(e["name"]), [0, 0.0])
        k[0] += 1
        k[1] += e["dur"] * 1e-6
    for counter, rise in counters.items():
        sub = COUNTED.get(counter)
        if sub is None:
            continue
        seen = sum(n for name, (n, _) in kernels.items() if sub in name)
        if seen != rise:
            return f"{seen} records of {sub} for {rise} launches counted"
    merged = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy = sum(e - s for s, e in merged) * 1e-6
    reqs = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == REQUEST]
    gaps = {}
    if reqs and merged:
        tid = reqs[0]["tid"]
        lo = min(e["ts"] for e in reqs)
        hi = max(e["ts"] + e["dur"] for e in reqs)
        host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                      if e.get("cat") in HOST_CATS and e.get("tid") == tid and e.get("ph") == "X"
                      and e["name"] != REQUEST and not e["name"].startswith("ProfilerStep"))
        starts = [h[0] for h in host]
        idle, cur = [], lo
        for s, e in merged:
            if s > cur:
                idle.append((cur, min(s, hi)))
            cur = max(cur, e)
            if cur >= hi:
                break
        if cur < hi:
            idle.append((cur, hi))
        for s, e in idle:
            if e <= s:
                continue
            mid = (s + e) / 2
            name, i = "host code between operations", bisect.bisect_right(starts, mid) - 1
            while i >= 0:
                if host[i][1] >= mid:
                    name = host[i][2]
                    break
                i -= 1
            gaps[name] = gaps.get(name, 0.0) + (e - s) * 1e-6
    return Trace(window_s=window_s, busy_s=busy, kernels=kernels, gaps=gaps, counters=counters,
                 requests=requests, images=images)


def capture(warm, block, counters, tries: int = 5) -> Trace:
    """Trace ``block()`` (-> (requests, images)) after one ``warm()`` step;
    ``counters()`` reads the program's launch counters."""
    from torch.profiler import ProfilerActivity, profile, schedule

    why = None
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            warm()
            torch.cuda.synchronize()
            prof.step()
            c0 = dict(counters())
            t0 = time.perf_counter()
            requests, images = block()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
            c1 = dict(counters())
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        rise = {k: c1.get(k, 0) - c0.get(k, 0) for k in set(c0) | set(c1)}
        got = read(events, {k: v for k, v in rise.items() if v}, window_s, requests, images)
        if isinstance(got, Trace):
            return got
        why = got
        print(f"trace {attempt + 1} of {tries} is partial ({why}); tracing again", flush=True)
    raise RuntimeError(f"no complete trace in {tries} tries: {why}")
