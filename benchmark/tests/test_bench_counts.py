"""The frozen work counts give chip_smoke.py's bounds."""

import json
import os

import pytest

from benchmark import counts
from benchmark.tests import helpers


def _cfg(name):
    with open(os.path.join(helpers.REPO, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


def test_k4_bound_at_512():
    ms = 512 * 350 * counts.cmux_ops(12, 1024) / counts.PEAK_INT32_OPS * 1e3
    assert ms == pytest.approx(12.3575, abs=5e-5)
    assert counts.round_ms(_cfg("sign1024x1-small_v2_tpu"), 512) * 350 == pytest.approx(ms)


def test_sbfft_round_bound_at_512():
    ms = counts.fp64_ms(counts.schoolbook_round_flops(512, 8, 4096))
    assert ms == pytest.approx(0.0202, abs=5e-5)
    assert counts.round_ms(_cfg("sign1024x1-medium_v2"), 512) == pytest.approx(ms)


@pytest.mark.parametrize("name,br", [("sign1024x1-small_v2_tpu", 1220 / 512 * 12.3575),
                                     ("sign1024x1-medium_v2", 1220 * 3072 * 0.02016 / 512)])
def test_least_time_an_image(name, br):
    cfg = _cfg(name)
    assert counts.pbs_per_image(cfg) == 1220
    least = counts.least_ms_per_image(cfg)
    assert least["blind_rotation"] == pytest.approx(br, rel=2e-3)
    assert least["total"] == pytest.approx(sum(least[k] for k in (
        "blind_rotation", "key_switch", "leveled")))
