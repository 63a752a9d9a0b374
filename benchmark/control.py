"""The readings that set a cell's limits, at the cell's own size: for each
seed, the words in which the program's answers differ from the reference
(the lower reading) and those in which the control's differ (the upper).

The control is the reference put in the program's place and computed in the
precision below the one its configuration states: the float64 transforms of
every external product in float32.  The program answers one request for
each image the run's check would draw; the reference and the control then
score the same images.

    python3 benchmark/control.py --workload <name> --seeds 11,12,13

One JSON line a seed on standard output.  Runs on the card; like run.py it
exits 2 without one.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":  # as run.py does
    sys.path[0] = ROOT
    for _var, _sub in (("CUDA_CACHE_PATH", "nv"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                       ("TRITON_CACHE_DIR", "triton")):
        os.environ[_var] = os.path.join(ROOT, "build", "benchmark_cache", _sub)

import torch  # noqa: E402

from benchmark import harness, system  # noqa: E402


def readings(spec, seed: int, device: str) -> dict:
    """{"program", "control"}: differing words against the reference, with
    the reference's and the control's worst rounding distance and seconds."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    k, pool = harness.make_inputs(spec, seed, dev)
    sample = harness.check_sample(spec.cfg, seed, range(spec.mix["pool_images"]))
    forward = system.build(spec.cfg, spec.root, k, device)
    answers = [([i], forward(pool[[i]]).cpu().numpy()) for i in sample]
    del forward
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    expect, rounding = harness.reference_scores(spec, k, pool, sample, dev)
    t2 = time.perf_counter()
    control, rounding32 = harness.reference_scores(spec, k, pool, sample, dev, "float32")
    t3 = time.perf_counter()
    ctl = [([i], control[i][None]) for i in sample]
    return {"cell": spec.cell["name"], "seed": seed, "images": len(sample),
            "words": int(sum(v.size for v in expect.values())),
            "program": harness.compare(answers, [], expect)[0],
            "control": harness.compare(ctl, [], expect)[0],
            "reference_rounding": rounding, "control_rounding": rounding32,
            "program_s": t1 - t0, "reference_s": t2 - t1, "control_s": t3 - t2}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    spec = harness.load_spec(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"device: {harness.device_name(dev)}, power limit {harness.power_limit(dev)}",
          file=sys.stderr, flush=True)
    for s in args.seeds.split(","):
        print(json.dumps(readings(spec, int(s), "cuda")), flush=True)
    found = harness.forbidden_modules(list(sys.modules))
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
