"""A copy of the benchmark's data under a temporary root, with each cell's
configuration cut to a few CPU-sized rounds, for the CPU tests."""

from __future__ import annotations

import json
import os
import shutil
import time

from benchmark import harness

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ("sign1024x1-tpu-single", "sign1024x1-medium_v2-single")


def tiny_root(tmp: str, n: int = 4, reference_images: int = 2, params: dict | None = None) -> str:
    """``tmp`` set up as a checkout's root: BENCHMARK.json and the benchmark's
    traffic, metrics and weights, every configuration at LWE dimension ``n``
    (``params`` replaces the set's numbers instead)."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for sub in ("traffic", "metrics", "weights"):
        shutil.copytree(os.path.join(REPO, "benchmark", sub), os.path.join(tmp, "benchmark", sub))
    os.makedirs(os.path.join(tmp, "benchmark", "configs"))
    for conf in bench["configs"]:
        with open(os.path.join(REPO, conf["file"])) as f:
            cfg = json.load(f)
        cfg["params"] = dict(params) if params else {**cfg["params"], "n": n}
        cfg["reference_images"] = reference_images
        with open(os.path.join(tmp, conf["file"]), "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp


def run_cpu(root: str, workload: str, seed: int = 5, seconds: float = 0.0, trace: bool = False):
    """One run of ``workload`` on the CPU: (result, checks)."""
    return harness.run_cell(harness.load_spec(root, workload), seed, seconds, trace, "cpu",
                            time.perf_counter())


# a noiseless set of the port's test geometry (n cut to 4) at the cells'
# message space: the fastest CPU run of the whole path
TINY = {"name": "tiny", "n": 4, "N": 256, "k": 1, "bg_bit": 3, "l": 10, "ks_basebit": 3,
        "ks_t": 9, "alpha_ks": 0.0, "alpha_bk": 0.0, "alpha_enc": 0.0, "msg_space": 4096}
