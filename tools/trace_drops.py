"""Which launches torch.profiler loses in ``chip_smoke.py``'s device-time
traces.

    python tools/trace_drops.py

Runs this checkout's ``chip_smoke.py`` with ``device.device_ms`` wrapped:
before each named kernel's measurement, one more trace of the same calls
whose raw events are printed (lines starting ``DIAG``): every runtime
launch call with its correlation id and host time, and the kernel record
that carries that id, if the tracer kept one, with its start and duration.
Then the smoke's own measurement runs once (one trace, no retry) and its
result is printed.  The run stops after K3-mm's (phase 3), the first
measurement the tracer has been seen to come up short on.
"""
import os
import runpy
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import redsec_tpu_torch.device as D  # noqa: E402

measure = D.device_ms


def dump(fn, kernel: str, reps: int) -> None:
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = list(prof.profiler.kineto_results.events())
    dev = [e for e in evs if e.device_type() == torch.autograd.DeviceType.CUDA]
    named = [e for e in dev if kernel in e.name()]
    calls = [e for e in evs if "aunch" in e.name()]  # cudaLaunchKernel and its kin
    t0 = min([e.start_ns() for e in calls] or [0])
    print(f"DIAG {kernel}: {len(evs)} events, {len(dev)} device, {len(named)} named, "
          f"{len(calls)} runtime launches {sorted({e.name() for e in calls})}", flush=True)
    by_corr = {e.correlation_id(): e for e in named}
    for e in calls:
        k = by_corr.get(e.correlation_id())
        at = (e.start_ns() - t0) / 1e3
        print(f"DIAG   rt {e.name()} corr {e.correlation_id()} at {at:.1f} us"
              + (f" -> kernel at {(k.start_ns() - t0) / 1e3:.1f} us dur {k.duration_ns() / 1e3:.1f}"
                 if k else " -> no kernel"), flush=True)
    others = sorted({e.name()[:60] for e in dev if kernel not in e.name()})
    print(f"DIAG   other device events: {others[:10]}", flush=True)
    print(f"DIAG   kernels (corr, us): "
          f"{[(e.correlation_id(), (e.start_ns() - t0) / 1e3) for e in named]}", flush=True)


def wrapped(fn, kernel, reps=20, per_call=1, tries=5, required=True):
    if kernel:
        dump(fn, kernel, reps)
    got = measure(fn, kernel, reps=reps, per_call=per_call, tries=1, required=False)
    print(f"DIAG result {kernel}: {got}", flush=True)
    if kernel == "cmux_round_mm":  # the smoke names K3-mm so, both its designs
        raise SystemExit(0)
    if got[0] is None and required:
        return measure(fn, kernel, reps, per_call, tries, required)
    return got


D.device_ms = wrapped
sys.argv = ["chip_smoke.py"]
runpy.run_path(os.path.join(ROOT, "chip_smoke.py"), run_name="__main__")
