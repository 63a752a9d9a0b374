"""The port's spans against the profiler's trace, in one traced run of a
benchmark cell on the card:

    python tools/span_check.py --workload <cell> --seed <n> [--seconds 30]

Runs the cell as ``benchmark/run.py --trace 1`` does, prints its result line,
then one JSON line (``span_check``) that holds, for the traced block:

- ``clock``: the device intervals of the ``pbs.blind_rotate`` spans against
  the device time of the blind-rotation kernels in the trace (the kernels
  ``blind_rotation_roofline`` reads), ms, and their ratio;
- ``leaf_cover``: the leaf spans' device intervals over the ``forward``
  spans';
- ``per_request``: host-to-device copies, stream synchronizations and
  memory copy calls in the trace, the ``forward.uploads`` counter, and the
  spans, a request;
- ``named_idle``: the share of the block's idle time that the breakdown
  names by a ``redsec/`` span, and the idle seconds by name;
- ``spans``: per span name, its count, host ms and device ms a request.
"""
import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark import trace as tracing  # noqa: E402
from benchmark.metrics.blind_rotation_roofline import KERNELS  # noqa: E402

LEAVES = ("leveled", "pbs.prologue", "pbs.blind_rotate", "pbs.extract", "pbs.key_switch",
          "pbs.concat")


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)

    kept = {}
    read_trace = tracing.read

    def keep_events(events, *rest):
        got = read_trace(events, *rest)
        kept["events"] = events
        return got

    make_reader = harness.reader

    def keep_run(root, name):
        fn = make_reader(root, name)

        def read(run):
            kept["run"] = run
            return fn(run)
        return read

    tracing.read, harness.reader = keep_events, keep_run
    spec = harness.load_spec(ROOT, args.workload)
    result, checks = harness.run_cell(spec, args.seed, args.seconds, True, "cuda", T_START)
    print(json.dumps({**result, "checks": checks}), flush=True)

    from redsec_tpu_torch.device import spans

    tr = kept["run"].trace
    out = check(tr, kept["events"], spans.read(tr.requests))
    print("span_check " + json.dumps({"workload": args.workload, "seed": args.seed, **out}),
          flush=True)
    return 0


def check(tr, events: list, got) -> dict:
    """The checks of a traced block ``tr`` (``trace.Trace``) from its Chrome
    trace ``events`` and the port's ``SpanRead`` of its requests."""
    from redsec_tpu_torch.device import UPLOADS

    kernel_ms = 1e3 * sum(s for name, (_, s) in tr.kernels.items()
                          if any(k in name for k in KERNELS))
    span_ms = got.device_ms.get("pbs.blind_rotate", 0.0)
    leaves = sum(got.device_ms.get(n, 0.0) for n in LEAVES)

    def count(pred):
        return sum(1 for e in events if e.get("ph") == "X" and pred(e)) / tr.requests

    idle = sum(tr.gaps.values())
    named = {k: v for k, v in tr.gaps.items() if k.startswith("redsec/")}
    per_name = {}
    for r in got.requests:
        for s in r["spans"]:
            c = per_name.setdefault(s["name"], [0, 0.0, 0.0])
            c[0] += 1
            c[1] += s["host_ms"]
            c[2] += s["device_ms"] or 0.0
    return {
        "requests": tr.requests,
        "images": tr.images, "block_ms_per_request": 1e3 * tr.window_s / tr.requests,
        "clock": {"blind_rotate_span_ms": span_ms, "blind_rotation_kernels_ms": kernel_ms,
                  "ratio": span_ms / kernel_ms if kernel_ms else None},
        "leaf_cover": leaves / got.device_ms["forward"] if got.device_ms.get("forward") else None,
        "per_request": {
            "memcpy_htod": count(lambda e: e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]),
            "memcpy_dtoh": count(lambda e: e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]),
            "stream_synchronize": count(lambda e: e.get("name") == "cudaStreamSynchronize"),
            "memcpy_calls": count(lambda e: e.get("cat") == "cuda_runtime"
                                  and e.get("name", "").startswith("cudaMemcpy")),
            "uploads_counted": got.counters.get(UPLOADS, 0) / tr.requests,
            "spans": sum(len(r["spans"]) for r in got.requests) / tr.requests},
        "named_idle": {"share": sum(named.values()) / idle if idle else None, "idle_s": idle,
                       "by_name": dict(sorted(tr.gaps.items(), key=lambda kv: -kv[1])[:16])},
        "spans": {n: {"count": c / tr.requests, "host_ms": h / tr.requests,
                      "device_ms": d / tr.requests} for n, (c, h, d) in per_name.items()},
    }


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
