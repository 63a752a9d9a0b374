"""The port's calibration (``calibrate_ranges`` on the torch oracle and the
``redsec-tpu-calibration-v1`` artifact) against the JAX package: same plans,
same images, same files.  Tolerance: exact equality of every stored field
and of every resolved ``PbsRange`` field."""

import os

import numpy as np
import pytest
import torch

from redsec_tpu.crypto.params import SMALL_V2_TPU as JP
from redsec_tpu.models.spec import prep_model as jprep
from redsec_tpu.models.zoo import get_model as jget_model
from redsec_tpu.runtime import calibration as jcal
from redsec_tpu.runtime import ranges as jranges
from redsec_tpu_torch import convert
from redsec_tpu_torch.crypto.params import SMALL_V2_TPU as P
from redsec_tpu_torch.formats.image_io import pixel_transform_for
from redsec_tpu_torch.models.spec import prep_model
from redsec_tpu_torch.models.zoo import get_model
from redsec_tpu_torch.runtime import calibration as cal
from redsec_tpu_torch.runtime import ranges
from test_torch_relu import mini_maxpool_model, mini_relu_model
from test_torch_slice import jax_spec

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = os.path.join(REPO, "nets_trained")
GOLDEN = os.path.join(REPO, "tests", "golden", "sign1024x1_var_prep_from_ref_wght.dat")
CALIB_FIELDS = ("measured_pre_bound", "measured_chan_interval", "sign_calib")
RANGE_FIELDS = ("certified", "measured", "relu_mode", "in_gain", "out_gain",
                "expected_flip_rate", "local_flip_rate")


def _same_value(a, b, where):
    assert (a is None) == (b is None), where
    if a is None:
        return
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where}[{k}]")
    elif isinstance(a, tuple):
        assert len(a) == len(b), where
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=str(where))
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=str(where))
    else:
        assert a == b, where


def assert_same_calibration(plan, jplan):
    assert len(plan.layers) == len(jplan.layers)
    for i, (lp, jlp) in enumerate(zip(plan.layers, jplan.layers)):
        for f in CALIB_FIELDS:
            _same_value(getattr(lp, f), getattr(jlp, f), (i, f))


def assert_same_ranges(got, want):
    assert got.keys() == want.keys()
    for i in got:
        for f in RANGE_FIELDS:
            assert getattr(got[i], f) == getattr(want[i], f), (i, f)
        for f in ("center", "tie_break"):
            _same_value(getattr(got[i], f), getattr(want[i], f), (i, f))


KNOB_ENV = {"center": "REDSEC_CENTER", "tiebreak": "REDSEC_TIEBREAK",
            "gain_mode": "REDSEC_GAIN_MODE", "cascade_w": "REDSEC_CASCADE_W",
            "max_flip": "REDSEC_MAX_FLIP"}


def _knob_env(knobs):
    """The JAX package's environment for the port's knob arguments."""
    out = {}
    for k, v in knobs.items():
        out[KNOB_ENV[k]] = ("1" if v else "0") if isinstance(v, bool) else str(v)
    return out


def _resolve_both(plan, jplan, monkeypatch, input_gain=False, relu_mode=None, strict=True,
                  **knobs):
    """resolve_pbs_ranges in both packages; the JAX side reads its relu mode
    and the calibration knobs from the environment."""
    if relu_mode:
        monkeypatch.setenv("REDSEC_RELU_MODE", relu_mode)
    else:
        monkeypatch.delenv("REDSEC_RELU_MODE", raising=False)
    for name in KNOB_ENV.values():
        monkeypatch.delenv(name, raising=False)
    for name, v in _knob_env(knobs).items():
        monkeypatch.setenv(name, v)
    kw = dict(input_gain=input_gain, sigma_units=P.mod_switch_sigma_units(), strict=strict)
    return (ranges.resolve_pbs_ranges(plan, P.msg_space, relu_mode=relu_mode, **kw, **knobs),
            jranges.resolve_pbs_ranges(jplan, JP.msg_space, **kw))


def _plans(which):
    if which == "sign1024x1":
        return (prep_model(get_model("mnist/sign1024x1"), GOLDEN),
                jprep(jget_model("mnist/sign1024x1"), GOLDEN))
    if which == "relu1024x1":
        w = os.path.join(NETS, "mnist", "relu1024x1", "var_prep.dat")
        return (prep_model(get_model("mnist/relu1024x1"), w),
                jprep(jget_model("mnist/relu1024x1"), w))
    make = {"mini_relu": mini_relu_model, "mini_maxpool": mini_maxpool_model}[which]
    spec, blob = make(np.random.default_rng(3))
    return prep_model(spec, blob), jprep(jax_spec(spec), blob)


def _images(which, n=12):
    rng = np.random.default_rng(7)
    if which == "mini_relu":
        return rng.integers(-1, 2, size=(n, 1, 1, 16)).astype(np.int32)
    if which == "mini_maxpool":
        return rng.integers(-15, 16, size=(n, 8, 8, 1)).astype(np.int32)
    return pixel_transform_for(f"mnist/{which}")(rng.integers(0, 256, size=(n, 28, 28, 1)))


@pytest.mark.parametrize("which", ["sign1024x1", "relu1024x1", "mini_relu", "mini_maxpool"])
def test_calibrate_ranges_equals_jax(which, monkeypatch):
    """All three stored fields on every layer, the returned bounds, and the
    PbsRanges both sides then resolve (with and without input gain; not
    strict: synthetic images need not fit the message space)."""
    plan, jplan = _plans(which)
    x = _images(which)
    got = ranges.calibrate_ranges(plan, x, device="cpu")
    want = jranges.calibrate_ranges(jplan, x)
    assert got == want
    assert_same_calibration(plan, jplan)
    for input_gain in (False, True):
        assert_same_ranges(*_resolve_both(plan, jplan, monkeypatch, input_gain, strict=False))
    # a calibrated JAX plan carried across resolves the same as well
    carried = convert.model_plan(jplan)
    assert_same_calibration(carried, jplan)
    assert_same_ranges(*_resolve_both(carried, jplan, monkeypatch, True, strict=False))


def test_calibrate_ranges_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    plan, _ = _plans("mini_relu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ranges.calibrate_ranges(plan, _images("mini_relu"))


@pytest.mark.parametrize("relu_mode", [None, "quarter", "full"])
def test_forced_relu_mode_equals_the_jax_environment_knob(relu_mode, monkeypatch):
    plan, jplan = _plans("mini_relu")
    got, want = _resolve_both(plan, jplan, monkeypatch, relu_mode=relu_mode)
    assert_same_ranges(got, want)
    if relu_mode:
        assert got[0].relu_mode == relu_mode


@pytest.mark.parametrize("net,gains", [
    ("mnist/relu1024x1", {0: (8, 8), 1: (8, 1), 2: (1, 1)}),
    ("cifar/binarynet_small", None),
])
def test_committed_calibration_loads_and_resolves_as_in_jax(net, gains, monkeypatch):
    d = os.path.join(NETS, *net.split("/"))
    plan = prep_model(get_model(net), os.path.join(d, "var_prep.dat"))
    jplan = jprep(jget_model(net), os.path.join(d, "var_prep.dat"))
    meta = cal.load_calibration(os.path.join(d, "calibration.npz"), plan)
    jmeta = jcal.load_calibration(os.path.join(d, "calibration.npz"), jplan)
    assert meta == jmeta
    assert cal.weights_fingerprint(plan) == jcal.weights_fingerprint(jplan) == meta["weights_sha"]
    assert_same_calibration(plan, jplan)
    opts = cal.options_from_meta(meta)
    assert opts == {**_DEFAULTS, "input_gain": True}
    got, want = _resolve_both(plan, jplan, monkeypatch, opts["input_gain"], opts["relu_mode"])
    assert_same_ranges(got, want)
    # the artifact's own summary of the saving run
    assert {str(i): [r.in_gain, r.out_gain] for i, r in got.items()} == meta["gains"]
    assert {str(i): r.relu_mode for i, r in got.items() if r.relu_mode} == meta["relu_modes"]
    assert got[0].in_gain == meta["in_gain"]
    if gains:
        assert {i: (r.in_gain, r.out_gain) for i, r in got.items()} == gains
        assert got[1].relu_mode == "quarter"


@pytest.mark.parametrize("relu_mode", [None, "full"])
def test_saved_by_the_port_loads_in_jax_and_the_reverse(tmp_path, monkeypatch, relu_mode):
    plan, jplan = _plans("mini_relu")
    x = _images("mini_relu")
    ranges.calibrate_ranges(plan, x, device="cpu")
    jranges.calibrate_ranges(jplan, x)

    # port -> JAX
    path = str(tmp_path / "port.npz")
    meta = cal.save_calibration(path, plan, "small_v2_tpu", "synthetic[0:12]",
                                input_gain=True, relu_mode=relu_mode)
    fresh = _plans("mini_relu")[1]
    jmeta = jcal.load_calibration(path, fresh)
    assert jmeta == meta
    assert_same_calibration(plan, fresh)
    env = {}
    jcal.apply_env_knobs(jmeta, env)
    assert env == {"REDSEC_INPUT_GAIN": "1", **({"REDSEC_RELU_MODE": relu_mode}
                                                if relu_mode else {})}
    assert cal.options_from_meta(meta) == {**_DEFAULTS, "input_gain": True,
                                           "relu_mode": relu_mode}

    # JAX -> port, saved under the same knobs
    monkeypatch.setenv("REDSEC_INPUT_GAIN", "1")
    if relu_mode:
        monkeypatch.setenv("REDSEC_RELU_MODE", relu_mode)
    else:
        monkeypatch.delenv("REDSEC_RELU_MODE", raising=False)
    jpath = str(tmp_path / "jax.npz")
    jsaved = jcal.save_calibration(jpath, jplan, "small_v2_tpu", "synthetic[0:12]")
    assert jsaved == meta
    fresh = _plans("mini_relu")[0]
    assert cal.load_calibration(jpath, fresh) == jsaved
    assert_same_calibration(fresh, jplan)
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_load_rejects_other_weights_model_and_format(tmp_path):
    plan, _ = _plans("mini_relu")
    ranges.calibrate_ranges(plan, _images("mini_relu"), device="cpu")
    path = str(tmp_path / "c.npz")
    cal.save_calibration(path, plan, "small_v2_tpu")
    other, _ = _plans("mini_relu")
    other.layers[0].quant.bias[0] += 1
    with pytest.raises(ValueError, match="fingerprint"):
        cal.load_calibration(path, other)
    cal.load_calibration(path, other, check_weights=False)
    assert other.layers[0].measured_pre_bound == plan.layers[0].measured_pre_bound
    with pytest.raises(ValueError, match="calibrated for model"):
        cal.load_calibration(path, _plans("mini_maxpool")[0])
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, meta=np.frombuffer(b'{"format": "other"}', dtype=np.uint8))
    with pytest.raises(ValueError, match="not a calibration artifact"):
        cal.load_calibration(bad, plan)


_DEFAULTS = {"input_gain": False, "relu_mode": None, "majority": 1, "majority_from": 0,
             "majority_plan": None, "center": True, "tiebreak": True, "gain_mode": "flip",
             "cascade_w": 0.25, "max_flip": 0.05}
_KNOBS = tuple(KNOB_ENV)


def _calibrated(net):
    """(port plan, JAX plan), calibrated the same way: relu1024x1 from its
    committed artifact, sign1024x1 on twelve synthetic images."""
    plan, jplan = _plans(net)
    if net == "relu1024x1":
        path = os.path.join(NETS, "mnist", "relu1024x1", "calibration.npz")
        cal.load_calibration(path, plan)
        jcal.load_calibration(path, jplan)
    else:
        ranges.calibrate_ranges(plan, _images(net), device="cpu")
        jranges.calibrate_ranges(jplan, _images(net))
    return plan, jplan


# every recorded knob becomes an option: majority voting and escalation
# (escalation's through escalation_from_meta, since it needs a second key)
# and the five calibration knobs, which then resolve as in JAX under the
# same environment
@pytest.mark.parametrize("env,ok", [
    ({"REDSEC_MAJORITY": "3"}, {"majority": 3}),
    ({"REDSEC_MAJORITY_PLAN": "5:5", "REDSEC_MAJORITY_FROM": "2"},
     {"majority_plan": "5:5", "majority_from": 2}),
    ({"REDSEC_ESCALATE": "6,7"}, {}),
    ({"REDSEC_GAIN_MODE": "max"}, {"gain_mode": "max"}),
    ({"REDSEC_CASCADE_W": "0.5"}, {"cascade_w": 0.5}),
    ({"REDSEC_MAX_FLIP": "0.2"}, {"max_flip": 0.2}),
    ({"REDSEC_CENTER": "0"}, {"center": False}),
    ({"REDSEC_TIEBREAK": "0"}, {"tiebreak": False}),
    ({"REDSEC_GAIN_MODE": "flip", "REDSEC_CASCADE_W": "0.25", "REDSEC_CENTER": "1",
      "REDSEC_RELU_MODE": "full"}, {"relu_mode": "full"}),
])
def test_options_from_meta_loads_every_recorded_knob(env, ok, monkeypatch):
    opts = cal.options_from_meta({"env": env})
    assert opts == {**_DEFAULTS, **ok}
    want = ({6, 7}, "small_v2_n2048") if "REDSEC_ESCALATE" in env else (set(), "small_v2_n2048")
    assert cal.escalation_from_meta({"env": env}) == want
    if set(ok) & set(_KNOBS):
        for net in ("sign1024x1", "relu1024x1"):
            plan, jplan = _calibrated(net)
            knobs = {k: opts[k] for k in _KNOBS if opts[k] != _DEFAULTS[k]}
            assert_same_ranges(*_resolve_both(plan, jplan, monkeypatch, True, opts["relu_mode"],
                                              strict=False, **knobs))


@pytest.mark.parametrize("net", ["relu1024x1", "sign1024x1"])
@pytest.mark.parametrize("knob,value", [("center", False), ("tiebreak", False),
                                        ("gain_mode", "max"), ("cascade_w", 0.5),
                                        ("max_flip", 0.001)])
def test_each_knob_resolves_as_the_jax_environment_variable(net, knob, value, monkeypatch):
    """Each knob at a value other than its default against the JAX package
    under its environment variable: the same PbsRanges, or the same refusal
    of the strict guard (its message names REDSEC_MAX_FLIP, as JAX's does).
    Where the net has the layers a knob acts on, it changes the resolution."""
    plan, jplan = _calibrated(net)
    outcome = []
    for strict in (False, True):
        try:
            got, want = _resolve_both(plan, jplan, monkeypatch, True, strict=strict,
                                      **{knob: value})
            assert_same_ranges(got, want)
            outcome.append(got)
        except ValueError as e:
            with pytest.raises(ValueError) as je:
                jranges.resolve_pbs_ranges(jplan, JP.msg_space, strict=True, input_gain=True,
                                           sigma_units=JP.mod_switch_sigma_units())
            assert str(e) == str(je.value)
            if knob == "max_flip":
                assert "REDSEC_MAX_FLIP=0.001" in str(e)
            outcome.append("refused")
    default, _ = _resolve_both(plan, jplan, monkeypatch, True, strict=False)
    acts = {("relu1024x1", "center"), ("sign1024x1", "tiebreak"), ("sign1024x1", "gain_mode"),
            ("sign1024x1", "cascade_w"), ("sign1024x1", "max_flip")}
    if (net, knob) == ("sign1024x1", "max_flip"):
        assert outcome[1] == "refused"
    elif (net, knob) in acts:
        with pytest.raises(AssertionError):
            assert_same_ranges(outcome[0], default)
    else:
        assert_same_ranges(outcome[0], default)


def test_a_file_with_every_knob_set_loads_both_ways(tmp_path, monkeypatch):
    """The port saves a calibration with all five knobs off their defaults;
    JAX loads it, replays its environment and resolves the same ranges.  JAX
    saves under that environment; the port loads the same options from it,
    and the two files hold the same meta and arrays."""
    plan, jplan = _calibrated("sign1024x1")
    knobs = dict(center=False, tiebreak=False, gain_mode="max", cascade_w=0.5, max_flip=0.2)
    path = str(tmp_path / "port.npz")
    meta = cal.save_calibration(path, plan, "small_v2_tpu", "synthetic[0:12]",
                                input_gain=True, **knobs)
    fresh = _plans("sign1024x1")[1]
    jmeta = jcal.load_calibration(path, fresh)
    assert jmeta == meta
    env = {}
    jcal.apply_env_knobs(jmeta, env)
    assert env == {"REDSEC_INPUT_GAIN": "1", **_knob_env(knobs)}
    opts = cal.options_from_meta(meta)
    assert opts == {**_DEFAULTS, "input_gain": True, **knobs}
    got, want = _resolve_both(plan, fresh, monkeypatch, True, strict=False, **knobs)
    assert_same_ranges(got, want)
    assert {str(i): [r.in_gain, r.out_gain] for i, r in got.items()} == meta["gains"]

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jpath = str(tmp_path / "jax.npz")
    assert jcal.save_calibration(jpath, jplan, "small_v2_tpu", "synthetic[0:12]") == meta
    fresh = _plans("sign1024x1")[0]
    assert cal.options_from_meta(cal.load_calibration(jpath, fresh)) == opts
    assert_same_calibration(fresh, jplan)
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
