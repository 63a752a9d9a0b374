"""BENCHMARK.json keeps the contract's shape, and the harness finds a cell's
configuration, mix and metrics by name: a throwaway cell added as files and
entries runs without a change to the harness."""

import json
import os
import re

import pytest

from benchmark import harness
from benchmark.tests import helpers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(helpers.REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    """1 to 200 characters on one line, no tab."""
    return isinstance(text, str) and 1 <= len(text) <= 200 and not set(text) & {"\n", "\r", "\t"}


def test_keys_and_names():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert all(_line(w) for w in b["command"])
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["reduced"] == []
        assert _line(c["source"]) and _line(c["why"])
        assert any(w["config"] == c["name"] for w in b["workloads"])
        with open(os.path.join(helpers.REPO, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    configs = {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert w["config"] in configs and NAME.match(w["traffic"]) and _line(w["why"])
        assert os.path.exists(os.path.join(helpers.REPO, "benchmark", "traffic",
                                           w["traffic"] + ".json"))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        assert os.path.exists(os.path.join(helpers.REPO, "benchmark", "metrics",
                                           m["name"] + ".py"))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])


@pytest.mark.parametrize("cell", helpers.CELLS)
def test_each_cell_reports_setup_and_more(cell):
    spec = harness.load_spec(helpers.REPO, cell)
    names = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and spec.per_layer


def test_throwaway_cell_found_by_name(tmp_path):
    """A new configuration, mix and metric, each a file, and their entries."""
    root = helpers.tiny_root(str(tmp_path), params=helpers.TINY)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    with open(os.path.join(root, b["configs"][0]["file"])) as f:
        cfg = json.load(f)
    cfg["name"] = "toy"
    with open(os.path.join(root, "benchmark", "configs", "toy.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "benchmark", "traffic", "pair.json"), "w") as f:
        json.dump({"images_per_request": 2, "pool_images": 4, "clients": 1, "loop": "closed",
                   "ink_share": 0.5, "trace_seconds": 1.0}, f)
    with open(os.path.join(root, "benchmark", "metrics", "requests_per_s.py"), "w") as f:
        f.write("def read(run):\n    return run.window['requests'] / run.window['seconds']\n")
    b["configs"].append({"name": "toy", "source": "test", "file": "benchmark/configs/toy.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "toy.pair", "config": "toy", "traffic": "pair", "chips": 1,
                           "why": "test"})
    b["end_to_end"].append({"name": "requests_per_s", "unit": "requests/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock", "workloads": ["toy.pair"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    spec = harness.load_spec(root, "toy.pair")
    assert spec.cfg["name"] == "toy" and spec.mix["images_per_request"] == 2
    res, checks = helpers.run_cpu(root, "toy.pair")
    assert res["correct"] and checks["mismatched_words"]["value"] == 0
    m = res["metrics"]
    assert set(m) == {"images_per_s", "setup_s", "requests_per_s"}
    assert m["images_per_s"]["value"] == pytest.approx(2 * m["requests_per_s"]["value"])
