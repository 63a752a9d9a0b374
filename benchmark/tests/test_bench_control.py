"""The comparison that decides ``correct`` fails what it must: the control
(the reference in float32 in the program's place) and the faults a cell can
have, each planted under a CPU run of the harness.  The exchange between
chips is not among them: every cell runs on one chip."""

import numpy as np
import pytest
import torch

from benchmark import harness, system
from benchmark.control import readings
from benchmark.tests import helpers
from redsec_tpu_torch.crypto import kernels


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return helpers.tiny_root(str(tmp_path_factory.mktemp("root")), params=helpers.TINY)


@pytest.fixture(scope="module")
def cut_root(tmp_path_factory):
    return helpers.tiny_root(str(tmp_path_factory.mktemp("cut")), n=3, reference_images=1)


@pytest.mark.parametrize("cell", helpers.CELLS)
def test_control_fails_and_the_program_passes(cut_root, cell):
    r = readings(harness.load_spec(cut_root, cell), 2**31 + 77, "cpu")
    assert r["program"] == 0 and r["control"] >= r["words"] // 2 > 0


def _unchanged(acc0, *args, **kw):
    return acc0.clone()  # every blind rotation returns its state as it came


def _half_batch(acc0, abar, bk, params, plan):
    """Rotates the first half of the chunk and copies it over the second."""
    h = (acc0.shape[0] + 1) // 2
    done = kernels.blind_rotate_plain(acc0[:h], abar[:h], bk, params, plan)
    return torch.cat([done, done[:acc0.shape[0] - h]])


def _altered_build(build):
    def wrapped(*args, **kw):
        forward = build(*args, **kw)

        def altered(x):
            y = forward(x).clone()
            y[0, 0, -1] += 1  # one score's body, one unit of the torus
            return y

        return altered
    return wrapped


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_fault_makes_correct_false(root, fault, monkeypatch):
    if fault == "altered":
        monkeypatch.setattr(system, "build", _altered_build(system.build))
    else:
        monkeypatch.setattr(kernels, "blind_rotate",
                            _unchanged if fault == "unchanged" else _half_batch)
    res, checks = helpers.run_cpu(root, helpers.CELLS[0], seed=9)
    assert not res["correct"] and res["failed"] >= 1
    assert checks["mismatched_words"]["value"] > 0


def test_sound_run_is_correct(root):
    res, checks = helpers.run_cpu(root, helpers.CELLS[0], seed=9)
    assert res["correct"] and checks["mismatched_words"]["value"] == 0
    assert np.isfinite(checks["reference_rounding"]["value"])
