"""``utils.debug.layerwise_compare`` against the JAX package's on the same
keys, weights and images: the same stages, agreement rates and mismatch
margins.  Tolerance: equal reports.  The port's reports also carry each
stage's largest distance from the oracle, which is 0 on an exact stage."""

import dataclasses

import numpy as np
import pytest
import torch

from redsec_tpu.models.spec import prep_model as jprep
from redsec_tpu.utils import debug as jdebug
from redsec_tpu_torch.models.spec import prep_model
from redsec_tpu_torch.ops import encrypted as eops
from redsec_tpu_torch.utils import debug
from test_torch_relu import keys, mini_maxpool_model, mini_relu_model  # noqa: F401
from test_torch_slice import jax_spec

torch.set_num_threads(2)

NETS = {"mini_maxpool": (mini_maxpool_model, (1, 8, 8, 1), 15),
        "mini_relu": (mini_relu_model, (2, 1, 1, 16), 1)}


@pytest.mark.parametrize("net", sorted(NETS))
def test_layerwise_compare_reports_equal_jax(keys, net):
    sk, dkey, jsk, jdkey = keys
    build, shape, top = NETS[net]
    spec, blob = build(np.random.default_rng(1))
    images = np.random.default_rng(2).integers(-top, top + 1, size=shape).astype(np.int32)
    got = debug.layerwise_compare(prep_model(spec, blob), dkey, sk, images,
                                  np.random.default_rng(3))
    want = jdebug.layerwise_compare(jprep(jax_spec(spec), blob), jdkey, jsk, images,
                                    np.random.default_rng(3))
    shared = [f.name for f in dataclasses.fields(jdebug.StageReport)]
    assert [[getattr(r, f) for f in shared] for r in got] == \
        [[getattr(r, f) for f in shared] for r in want]
    assert all(r.max_abs_err == 0 for r in got if r.exact)
    assert debug.format_reports(got) == jdebug.format_reports(want)
    stages = [r.stage for r in got]
    assert ("maxpool" in stages) if net == "mini_maxpool" else ("relu" in stages)


def test_a_leveled_stage_off_the_oracle_reports_how_far(keys, monkeypatch):
    """A conv whose output lands 3 units off (its body shifted by 3 message
    steps) is reported not exact, 3 off, and printed with its error."""
    sk, dkey = keys[0], keys[1]
    spec, blob = mini_maxpool_model(np.random.default_rng(1))
    real = eops.conv_enc
    step = 2**32 // dkey.params.msg_space

    def off_by_three(*a, **kw):
        out = real(*a, **kw).clone()
        out[..., -1] += 3 * step
        return out

    monkeypatch.setattr(eops, "conv_enc", off_by_three)
    images = np.random.default_rng(2).integers(-15, 16, size=(1, 8, 8, 1)).astype(np.int32)
    reports = debug.layerwise_compare(prep_model(spec, blob), dkey, sk, images,
                                      np.random.default_rng(3))
    convs = [r for r in reports if r.stage == "conv"]
    assert convs and all(not r.exact and r.max_abs_err == 3 for r in convs)
    assert "max_err=3" in debug.format_reports(reports)
