"""One run of one cell: set-up, the measured window, an optional traced
block, the check against the reference, and the result line.

Everything a cell needs is found by the names in ``BENCHMARK.json``: its
configuration file (``configs[].file``), its traffic mix
(``benchmark/traffic/<traffic>.json``) and a reader for each of its metrics
(``benchmark/metrics/<metric>.py``, a function ``read(run)`` that returns the
value or None where it finds nothing to read).  Adding a cell, a mix or a
metric adds files and entries; no code here changes.

A run: keys and the image pool are made from the seed on the device, the
program prepares the key and builds its forward, one request warms every
shape; that is the set-up.  Then requests go back to back, one client in a
closed loop, each ending with its encrypted scores on the host, until
``seconds`` have passed; the window runs from the first request's start to
the end of the last.  With ``trace`` a block of further requests runs under
the profiler (``trace.capture``).  Then the device's peak memory is read,
the program's state is freed, and the reference recomputes the scores of a
sample of the pool's images, drawn from the seed; every answer of the run
for those images is compared word for word.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time
import types

import numpy as np
import torch

from . import counts, keys, system, traffic
from . import trace as tracing
from .reference import net as refnet
from .reference.tfhe import Reference

HERE = os.path.basename(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "redsec_tpu")
ROUNDING_LIMIT = 0.25  # the reference's own rounding, worst distance seen


@dataclasses.dataclass
class Spec:
    root: str
    cell: dict
    cfg: dict
    mix: dict
    end_to_end: list
    per_layer: list


def load_spec(root: str, workload: str) -> Spec:
    """The cell ``workload`` of ``root``/BENCHMARK.json, with its configuration,
    its mix and the metrics it reports."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        cfg = json.load(f)
    mix = traffic.load(os.path.join(root, HERE, "traffic", cell["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload] if m["moves"] in names else [])]
    return Spec(root, cell, cfg, mix, e2e, layer)


def reader(root: str, name: str):
    """The ``read`` function of metric ``name``'s file."""
    path = os.path.join(root, HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names) -> list:
    """Top-level names among ``names`` that the run may not have loaded."""
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def power_limit(dev: torch.device) -> str:
    """The card's power limit as nvidia-smi reads it."""
    if dev.type != "cuda":
        return "no card"
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", str(dev.index or 0)], capture_output=True, text=True,
                             timeout=60)
        return res.stdout.strip() or f"unread ({res.stderr.strip()})"
    except OSError as exc:
        return f"unread ({exc})"


def make_inputs(spec: Spec, seed: int, dev: torch.device) -> tuple[dict, np.ndarray]:
    """The client's keys and the encrypted image pool, from the seed."""
    p = spec.cfg["params"]
    g = keys.generator(seed, dev)
    k = keys.keygen(p, g, dev)
    pool = keys.encrypt(traffic.pool_images(spec.mix, spec.cfg, seed), k["lwe_key"], p, g, dev)
    return k, pool


def check_sample(cfg: dict, seed: int, used) -> list:
    """The pool images whose answers are checked: ``reference_images`` of
    those ``used``, drawn from the seed."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 0x636865636B])
    return sorted(int(i) for i in rng.permutation(sorted(used))[:cfg["reference_images"]])


def reference_scores(spec: Spec, k: dict, pool: np.ndarray, sample: list, dev: torch.device,
                     precision: str = "float64") -> tuple[dict, float]:
    """({pool index: the reference's scores [classes, n+1]}, the worst
    rounding distance its transforms saw) for the images ``sample``."""
    cfg = spec.cfg
    ref = Reference(cfg["params"], k["bk"], k["ksk"], dev, precision)
    layers = refnet.read_net(os.path.join(spec.root, cfg["weights"]), cfg["net"], cfg["input"])
    scores = refnet.forward(ref, cfg["net"], layers, cfg["params"]["msg_space"],
                            torch.as_tensor(pool[sample], device=dev)).cpu().numpy()
    return dict(zip(sample, scores)), float(ref.max_rounding)


def compare(answers: list, later: list, expect: dict) -> tuple[int, int, int]:
    """(words that differ, window requests with a differing word, images
    compared) of every answer (pool indices, scores) for an image in
    ``expect``; ``later`` answers are compared but not counted as failed."""
    mismatched, failed, compared = 0, 0, 0
    for n_ans, (idx, y) in enumerate(answers + later):
        bad = 0
        for j, i in enumerate(idx):
            if i in expect:
                compared += 1
                bad += int((y[j] != expect[i]).sum())
        mismatched += bad
        failed += int(bad > 0 and n_ans < len(answers))
    return mismatched, failed, compared


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> tuple[dict, dict]:
    """One run; returns (result, checks)."""
    cfg, mix = spec.cfg, spec.mix
    dev = torch.device(device)
    kind = device_name(dev)
    print(f"device: {kind}; cell {spec.cell['name']}, seed {seed}", file=sys.stderr, flush=True)

    # -- set-up ----------------------------------------------------------
    t_in = time.perf_counter()
    k, pool = make_inputs(spec, seed, dev)
    _sync(dev)
    t_build = time.perf_counter()
    forward = system.build(cfg, spec.root, k, device)
    _sync(dev)
    t_warm = time.perf_counter()

    def request(r: int):
        idx = traffic.request_images(mix, r)
        x = pool[idx]
        with torch.profiler.record_function(tracing.REQUEST):
            y = forward(x).cpu().numpy()
        return idx, y

    request(0)
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s: imports {t_in - t_start:.3f}, keys and pool "
          f"{t_build - t_in:.3f}, key preparation and forward {t_warm - t_build:.3f}, warm "
          f"request {setup_s - (t_warm - t_start):.3f}", file=sys.stderr, flush=True)

    # -- the window ------------------------------------------------------
    c0 = system.launch_counts()
    lat, answers, r = [], [], 0
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        answers.append(request(r))
        te = time.perf_counter()
        lat.append(te - ts)
        r += 1
        if te - t0 >= seconds:
            break
    window_s = te - t0
    c1 = system.launch_counts()
    per = mix["images_per_request"]
    print(f"window {window_s:.3f} s, {r} requests on {kind}, power limit {power_limit(dev)}",
          file=sys.stderr, flush=True)

    traced, later = None, []
    if trace and dev.type == "cuda":
        n_req = max(1, math.ceil(mix["trace_seconds"] / (window_s / r)))
        state = {"r": r}

        def step():
            later.append(request(state["r"]))
            state["r"] += 1

        def block():
            for _ in range(n_req):
                step()
            return n_req, n_req * per

        traced = tracing.capture(step, block, system.launch_counts)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # -- the check, once the program's state is freed ----------------------
    del forward, request
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    sample = check_sample(cfg, seed, {i for idx, _ in answers + later for i in idx})
    expect, rounding = reference_scores(spec, k, pool, sample, dev)
    mismatched, failed, compared = compare(answers, later, expect)
    print(f"check: {compared} answers against the reference ({len(sample)} images) in "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr, flush=True)
    checks = {"mismatched_words": {"value": mismatched, "limit": 0},
              "reference_rounding": {"value": rounding, "limit": ROUNDING_LIMIT}}
    correct = mismatched <= 0 and rounding < ROUNDING_LIMIT

    # -- metrics -----------------------------------------------------------
    run = types.SimpleNamespace(
        cfg=cfg, mix=mix, seed=seed, device=dev.type, setup_s=setup_s, trace=traced,
        least_ms=counts.least_ms_per_image(cfg),
        window={"seconds": window_s, "latencies_s": lat, "requests": r, "images": r * per,
                "launches": {n: c1.get(n, 0) - c0.get(n, 0) for n in c1}})
    metrics = {}
    for m in spec.per_layer if trace else spec.end_to_end:
        v = reader(spec.root, m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": r, "failed": failed, "metrics": metrics,
              "device": device_info}
    if traced is not None:
        device_info.update(busy_s=traced.busy_s, window_s=traced.window_s)
        top = sorted(traced.kernels.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(traced.gaps.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[n, s] for n, (_, s) in top],
                               "idle_gaps": [[n, s] for n, s in gaps]}
    return result, checks


def emit(result: dict, checks: dict) -> int:
    """Print the checks (standard error) and the result line (standard
    output), unless JAX or the JAX package was loaded: then 3, no result."""
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"forbidden modules loaded in this process: {found}", file=sys.stderr, flush=True)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    print(json.dumps({**result, "checks": checks}), flush=True)
    return 0


def main(argv, root: str, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec(root, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec.cell["chips"]:
        print(f"{torch.cuda.device_count()} CUDA devices, the cell needs {spec.cell['chips']}",
              file=sys.stderr)
        return 2
    result, checks = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    return emit(result, checks)
