"""Each cell's path end to end on the CPU (the port's plain twins) at its own
parameter set with n cut to 4: a well-formed last line, answers equal to the
reference's; and run.py refuses to run without a card."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests import helpers


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return helpers.tiny_root(str(tmp_path_factory.mktemp("root")))


@pytest.mark.parametrize("cell", helpers.CELLS)
def test_cell_end_to_end_on_cpu(root, cell, capsys):
    res, checks = helpers.run_cpu(root, cell, seed=2**31 + 7, trace=True)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert checks["mismatched_words"] == {"value": 0, "limit": 0}
    assert harness.emit(res, checks) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "cpu"  # never a device's name for a CPU run
    # a CPU run has no trace and no kernel launches: nothing for the readers
    assert line["metrics"] == {}
    res0, _ = helpers.run_cpu(root, cell)
    names = {m["name"] for m in harness.load_spec(root, cell).end_to_end}
    assert set(res0["metrics"]) == names
    assert all(v["value"] > 0 for v in res0["metrics"].values())


def test_run_refuses_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", helpers.CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=helpers.REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 2 and res.stdout == ""


def test_forbidden_modules():
    assert harness.forbidden_modules(["jax", "numpy"]) == ["jax"]
    assert harness.forbidden_modules(["redsec_tpu.crypto.params", "jaxlib.xla"]) == [
        "jaxlib", "redsec_tpu"]
    assert harness.forbidden_modules(["redsec_tpu_torch", "redsec_tpu_torch.crypto",
                                      "flaxen", "jax_like"]) == []
    assert harness.forbidden_modules(["flax.linen"]) == ["flax"]


def test_result_refused_with_jax_loaded(capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    assert harness.emit({"correct": True}, {}) == 3
    assert capsys.readouterr().out == ""


def test_benchmark_imports_no_jax():
    code = ("import sys; import benchmark.harness, benchmark.control; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'redsec_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=helpers.REPO, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": helpers.REPO})
    assert res.returncode == 0, res.stdout + res.stderr
