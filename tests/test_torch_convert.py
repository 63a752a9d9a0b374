"""``redsec_tpu_torch.convert`` carries the JAX package's keys and model
plans across as the port's own objects, equal to what the port makes itself
from the same seed and weights."""

import dataclasses
import os

import numpy as np
import pytest

from redsec_tpu.crypto import keygen as jkg
from redsec_tpu.crypto import params as jparams
from redsec_tpu.models.spec import prep_model as jprep
from redsec_tpu.models.zoo import get_model as jget_model
from redsec_tpu_torch import convert
from redsec_tpu_torch.crypto import keygen as kg
from redsec_tpu_torch.crypto.params import TEST_NOISELESS
from redsec_tpu_torch.models import spec as S
from redsec_tpu_torch.models.spec import prep_model
from redsec_tpu_torch.models.zoo import get_model
from test_torch_slice import jax_spec, mini_sign_model

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "sign1024x1_var_prep_from_ref_wght.dat")


def _assert_same(a, b, path="plan"):
    """Structural equality of plans: dataclasses field by field, arrays by
    value and dtype, enums by type and value."""
    if dataclasses.is_dataclass(a):
        assert type(a) is type(b), path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def test_keys_carry_across():
    jsk, jck = jkg.keygen(jparams.TEST_NOISELESS, seed=4, bundle=2)
    sk, ck = kg.keygen(TEST_NOISELESS, seed=4, bundle=2)
    _assert_same(convert.secret_key(jsk), sk)
    _assert_same(convert.cloud_key(jck), ck)
    assert convert.params(jparams.SMALL_V2_TPU).name == "small_v2_tpu"
    with pytest.raises(ValueError, match="differs"):
        convert.params(dataclasses.replace(jparams.TEST_NOISELESS, n=65))


@pytest.mark.parametrize("which", ["sign1024x1", "mini_sign"])
def test_model_plan_carries_across(which):
    if which == "sign1024x1":
        spec, jspec, blob = get_model("mnist/sign1024x1"), jget_model("mnist/sign1024x1"), GOLDEN
    else:
        spec, blob = mini_sign_model(np.random.default_rng(3))
        jspec = jax_spec(spec)
    got = convert.model_plan(jprep(jspec, blob))
    _assert_same(got, prep_model(spec, blob))
    assert isinstance(got.layers[0].quant.mode, S.Activation)
