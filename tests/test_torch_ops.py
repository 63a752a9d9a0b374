"""The port's leveled encrypted operators and plaintext oracle against the
JAX package, on random int32 ciphertext tensors (values up to +-2^31) and on
the same prepped plans.  Tolerance: exact equality of int32 arrays."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redsec_tpu.crypto import params as jparams
from redsec_tpu.models.spec import prep_model as jprep
from redsec_tpu.models.zoo import get_model as jget_model
from redsec_tpu.ops import encrypted as jops
from redsec_tpu.runtime import ptxt as jptxt
from redsec_tpu_torch.crypto.params import SMALL_V2_TPU
from redsec_tpu_torch.device import int32_matmul
from redsec_tpu_torch.formats.image_io import pixels_to_signed
from redsec_tpu_torch.models.spec import prep_model
from redsec_tpu_torch.models.zoo import get_model
from redsec_tpu_torch.ops import encrypted as ops
from redsec_tpu_torch.runtime import ptxt
from test_torch_slice import jax_spec, mini_sign_model

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "sign1024x1_var_prep_from_ref_wght.dat")
JP = jparams.SMALL_V2_TPU


def _ct(rng, shape):
    x = rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
    flat = x.reshape(-1)
    flat[:4] = [2**31 - 1, -2**31, 2**31 - 2, -2**31 + 1]
    return x


def _golden_plans():
    return (prep_model(get_model("mnist/sign1024x1"), GOLDEN),
            jprep(jget_model("mnist/sign1024x1"), GOLDEN))


@pytest.fixture(scope="module")
def golden():
    return _golden_plans()


@pytest.fixture(scope="module")
def plans():
    spec, blob = mini_sign_model(np.random.default_rng(0))
    return prep_model(spec, blob), jprep(jax_spec(spec), blob)


def test_int32_matmul_is_exact_mod_2_32():
    rng = np.random.default_rng(0)
    x = _ct(rng, (5, 1024))
    w = rng.integers(-1, 2, size=(1024, 7)).astype(np.int8)
    got = int32_matmul(torch.as_tensor(x), torch.as_tensor(w), 1).numpy()
    want = (x.astype(np.int64) @ w.astype(np.int64)).astype(np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(got, want.astype(np.int32))
    # a bound on |w| past one fp32-exact contraction runs in chunks of K
    got = int32_matmul(torch.as_tensor(x), torch.as_tensor(w), 1 << 10).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int32))
    with pytest.raises(ValueError):  # one limb product alone past 2^24
        int32_matmul(torch.as_tensor(x), torch.as_tensor(w), 1 << 17)


def test_ternary_matmul_ct_equals_jax():
    rng = np.random.default_rng(1)
    x = _ct(rng, (2, 3, 196, 11))
    w = rng.integers(-1, 2, size=(196, 5)).astype(np.int8)
    got = ops.ternary_matmul_ct(torch.as_tensor(x), w).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.ternary_matmul_ct(jnp.asarray(x), w)))


@pytest.mark.parametrize("layer", [1, 2, 3])
def test_conv_enc_equals_jax(plans, layer):
    plan, jplan = plans
    lp, jlp = plan.layers[layer], jplan.layers[layer]
    d = lp.in_dim
    x = _ct(np.random.default_rng(layer), (2, d.h, d.w, d.in_dep, 17))
    for g_in in (1, 3):
        got = ops.conv_enc(lp.conv, torch.as_tensor(x), 1024, g_in).numpy()
        want = np.asarray(jops.conv_enc(jlp.conv, jnp.asarray(x), 1024, g_in))
        np.testing.assert_array_equal(got, want)


def test_conv_enc_neg_correction_equals_jax():
    """The golden sign1024x1's first FC carries no 1's-complement correction;
    an integer-domain conv does: give both sides the same one."""
    plan, jplan = _golden_plans()  # fresh: the correction is written into them
    cp, jcp = plan.layers[1].conv, jplan.layers[1].conv
    corr = np.random.default_rng(3).integers(0, 40, size=cp.out_dep).astype(np.int32)
    cp.neg_correction, jcp.neg_correction = corr, corr.copy()
    x = _ct(np.random.default_rng(4), (1, 14, 14, 1, 9))
    got = ops.conv_enc(cp, torch.as_tensor(x), 4096, 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.conv_enc(jcp, jnp.asarray(x), 4096, 2)))


def test_sumpool_enc_equals_jax(golden):
    plan, jplan = golden
    x = _ct(np.random.default_rng(5), (2, 28, 28, 1, 13))
    got = ops.sumpool_enc(plan.layers[0].sumpool, torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.sumpool_enc(jplan.layers[0].sumpool, jnp.asarray(x))))


@pytest.mark.parametrize("tie", [False, True])
def test_quant_sign_pre_equals_jax(plans, tie):
    plan, jplan = plans
    q, jq = plan.layers[2].quant, jplan.layers[2].quant
    rng = np.random.default_rng(6)
    x = _ct(rng, (2, q.h, q.w, q.depth, SMALL_V2_TPU.n + 1))
    tb = rng.integers(0, 2, size=(q.h, q.w, q.depth)).astype(bool) if tie else None
    xb, tv = ops.quant_sign_pre(q, torch.as_tensor(x), SMALL_V2_TPU, 3, 2, tb)
    jxb, jtv = jops.quant_sign_pre(jq, jnp.asarray(x), JP, 3, 2, tb)
    np.testing.assert_array_equal(xb.numpy(), np.asarray(jxb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jtv))


def test_quant_add_bias_enc_equals_jax(plans):
    plan, jplan = plans
    q, jq = plan.layers[3].quant, jplan.layers[3].quant
    rng = np.random.default_rng(7)
    x = _ct(rng, (3, 1, 1, q.depth, 9))
    center = rng.integers(-50, 50, size=q.depth)
    for c in (None, center):
        got = ops.quant_add_bias_enc(q, torch.as_tensor(x), SMALL_V2_TPU, 2, c).numpy()
        want = np.asarray(jops.quant_add_bias_enc(jq, jnp.asarray(x), JP, 2, c))
        np.testing.assert_array_equal(got, want)


def test_ptxt_forward_equals_jax(golden):
    plan, jplan = golden
    x = pixels_to_signed(np.random.default_rng(8).integers(0, 256, size=(6, 28, 28, 1)))
    got = ptxt.build_forward(plan, device="cpu")(x).numpy()
    want = np.asarray(jptxt.build_forward(jplan)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ptxt.predict(plan, x, device="cpu"), want.argmax(axis=1))


def test_ptxt_mini_model_equals_jax(plans):
    plan, jplan = plans
    x = np.random.default_rng(9).integers(-15, 16, size=(5, 8, 8, 1)).astype(np.int32)
    got = ptxt.build_forward(plan, device="cpu")(x).numpy()
    np.testing.assert_array_equal(got, np.asarray(jptxt.build_forward(jplan)(jnp.asarray(x))))


@pytest.mark.parametrize("input_gain", [False, True])
def test_resolve_pbs_ranges_equals_jax(golden, input_gain):
    """Certified bounds, per-edge gains and flip estimates of the golden
    sign1024x1 at small_v2_tpu (message space 4096)."""
    from redsec_tpu.runtime.ranges import resolve_pbs_ranges as jresolve
    from redsec_tpu_torch.runtime.ranges import resolve_pbs_ranges

    plan, jplan = golden
    kw = dict(input_gain=input_gain, sigma_units=SMALL_V2_TPU.mod_switch_sigma_units())
    got = resolve_pbs_ranges(plan, SMALL_V2_TPU.msg_space, **kw)
    want = jresolve(jplan, JP.msg_space, **kw)
    assert got.keys() == want.keys()
    for i in got:
        for f in ("certified", "measured", "relu_mode", "in_gain", "out_gain",
                  "expected_flip_rate", "local_flip_rate"):
            assert getattr(got[i], f) == getattr(want[i], f), (i, f)
        for f in ("center", "tie_break"):
            a, b = getattr(got[i], f), getattr(want[i], f)
            assert (a is None) == (b is None), (i, f)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    if not input_gain:
        assert {i: (r.in_gain, r.out_gain) for i, r in got.items()} == \
            {0: (1, 4), 1: (4, 1), 2: (1, 1)}
