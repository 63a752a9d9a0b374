"""The port's noise models against the JAX package: the analytic per-source
budget (``utils/noise_budget.py``, mirroring tests/test_noise_budget.py), the
Monte-Carlo simulator (``utils/noise_sim.py``, mirroring
tests/test_noise_sim.py but for its one test that needs the reference
checkout) and the ``predict_agreement`` script on a synthetic dataset.

Tolerance: exact equality.  The budget is the same float arithmetic in the
same order; the simulator draws its noise from the same numpy generator calls
in the same order, so a rollout of either package from one seed gives the
same scores, flip counts and agreement."""

import contextlib
import dataclasses
import io
import json
import math
import os
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redsec_tpu.crypto import bootstrap as jbs
from redsec_tpu.crypto import keygen as jkg
from redsec_tpu.crypto import params as jparams
from redsec_tpu.models.spec import prep_model as jprep
from redsec_tpu.models.zoo import get_model as jget_model
from redsec_tpu.ops import encrypted as jops
from redsec_tpu.runtime import encrypted as jenc
from redsec_tpu.runtime import ranges as jranges
from redsec_tpu.utils import noise_budget as jnb
from redsec_tpu.utils import noise_sim as jns
from redsec_tpu_torch.crypto import bootstrap as bs
from redsec_tpu_torch.crypto import keygen as kg
from redsec_tpu_torch.crypto.params import PARAM_SETS, TEST_NOISELESS, get_params
from redsec_tpu_torch.formats.image_io import pixel_transform_for
from redsec_tpu_torch.formats.varprep import VarPrepWriter
from redsec_tpu_torch.models.dims import Dimensions
from redsec_tpu_torch.models.spec import (
    Activation, BiasKind, ConvKind, ConvParams, Domain, LayerSpec, ModelSpec, PoolKind,
    prep_model,
)
from redsec_tpu_torch.models.zoo import get_model
from redsec_tpu_torch.ops import encrypted as ops
from redsec_tpu_torch.runtime import ptxt
from redsec_tpu_torch.runtime import ranges as rr
from redsec_tpu_torch.runtime.encrypted import (
    build_forward_impl, decrypt_scores, encrypt_images, model_in_gain, model_out_center,
    model_out_gain,
)
from redsec_tpu_torch.scripts import predict_agreement
from redsec_tpu_torch.utils.metrics import StageTimer
from redsec_tpu_torch.utils.noise_budget import budget, rounded_gaussian_var_lsb
from redsec_tpu_torch.utils.noise_sim import agreement_estimate, simulate_forward, trace_oracle
from test_torch_relu import mini_maxpool_model, mini_relu_model
from test_torch_slice import jax_spec

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "sign1024x1_var_prep_from_ref_wght.dat")


# --------------------------------------------------------------------------- #
# noise_budget (tests/test_noise_budget.py)                                   #
# --------------------------------------------------------------------------- #


def _budget_pair(p, **kw):
    """The port's budget, held field by field equal to the JAX package's on
    the same parameters."""
    b = budget(p, **kw)
    jb = jnb.budget(jparams.TfheParams(**{f.name: getattr(p, f.name)
                                          for f in dataclasses.fields(jparams.TfheParams)}),
                    **kw)
    for f in ("bk_noise", "gadget", "ks_trunc", "ks_noise", "ks_bias_sigma"):
        assert getattr(b, f) == getattr(jb, f), (p.name, f)
    assert b.table() == jb.table()
    return b


def test_rounded_gaussian_discretization_cliff():
    a = 2.0**-25  # 128 lsb
    s = a * 2**32
    assert rounded_gaussian_var_lsb(a) == pytest.approx(s * s + 1 / 12)
    assert rounded_gaussian_var_lsb(2.0**-45) == 0.0
    assert rounded_gaussian_var_lsb(0.0) == 0.0
    v = rounded_gaussian_var_lsb(0.3 * 2.0**-32)
    assert 0.0 < v < 0.3**2 + 1 / 12
    for alpha in (0.0, 2.0**-45, 0.3 * 2.0**-32, 1.7 * 2.0**-32, 2.0**-25, 2.0**-15):
        assert rounded_gaussian_var_lsb(alpha) == jnb.rounded_gaussian_var_lsb(alpha)


def test_bk_term_matches_round4_measurements():
    for name, meas in (("small_v2", 0.024), ("small_v2_tpu", 0.073),
                       ("small_v2_tpu2", 0.12)):
        pred = _budget_pair(PARAM_SETS[name]).sigma_slots_of("bk_noise")
        assert abs(pred - meas) / meas < 0.20, (name, pred, meas)


def test_ks_truncation_scaling():
    p6 = dataclasses.replace(PARAM_SETS["small_v2"], ks_t=6)
    p7 = dataclasses.replace(PARAM_SETS["small_v2"], ks_t=7)
    r = (_budget_pair(p6).sigma_slots_of("ks_trunc")
         / _budget_pair(p7).sigma_slots_of("ks_trunc"))
    assert r == pytest.approx(8.0)


def test_reference_wide_recipes_are_marginal_by_arithmetic():
    for name in ("medium", "large"):
        b = _budget_pair(PARAM_SETS[name])
        assert b.bk_noise == 0.0 and b.ks_noise == 0.0
        assert b.sigma_slots_of("ks_trunc") > 0.2
        assert b.budget_sigma_multiple() < 2.5
        assert b.sigma_slots_of("ks_trunc") > b.sigma_slots_of("gadget")


def test_repaired_recipes_have_zero_discrete_budget():
    for name in ("medium_v2", "large_v2"):
        p = PARAM_SETS[name]
        assert p.ks_basebit * p.ks_t == 32
        assert p.l * p.bg_bit == 32
        b = _budget_pair(p)
        assert b.total_var == 0.0
        assert math.isinf(b.budget_sigma_multiple())
        bc = _budget_pair(p, engine="continuous")
        assert bc.sigma_slots() < 1e-3
        assert bc.budget_sigma_multiple() > 100
        o = PARAM_SETS[name[:-3]]
        assert (p.n, p.N, p.alpha_ks, p.alpha_bk) == (o.n, o.N, o.alpha_ks, o.alpha_bk)


def test_full_totals_match_measured_sigmas():
    for name, meas, tol in (("small_v2", 0.0386, 0.25), ("small_v2_tpu2", 0.1419, 0.25),
                            ("medium", 0.248, 0.35), ("large", 0.410, 0.35)):
        pred = _budget_pair(PARAM_SETS[name]).sigma_slots()
        assert abs(pred - meas) / meas < tol, (name, pred, meas)
    for name in PARAM_SETS:  # every set, both conventions, and bundle=2's n/2 rounds
        _budget_pair(PARAM_SETS[name])
        _budget_pair(PARAM_SETS[name], engine="continuous", n_rounds=PARAM_SETS[name].n // 2)


def test_gadget_coherent_term_anchor():
    p = dataclasses.replace(PARAM_SETS["small_v2"], alpha_bk=0.0, alpha_ks=0.0,
                            alpha_enc=0.0, bg_bit=3, l=7, ks_basebit=4, ks_t=8)
    pred = _budget_pair(p).sigma_slots()
    assert abs(pred - 4.098) / 4.098 < 0.25, pred


def test_stage_timer_reports_each_stage():
    t = StageTimer()
    t.mark("a")
    t.mark("b")
    assert [n for n, _ in t.stages] == ["a", "b"]
    assert all(dt >= 0 for _, dt in t.stages)
    assert t.report().splitlines()[1].startswith("b: ")


# --------------------------------------------------------------------------- #
# noise_sim (tests/test_noise_sim.py)                                         #
# --------------------------------------------------------------------------- #


def fc_relu_model(n_in=16, n_out=8, slope=16, in_bound=4):
    """tests/test_ranges.py's ``_fc_relu_model`` in the port's spec classes:
    (spec, var_prep bytes)."""
    spec = ModelSpec(
        "test/ranges",
        Dimensions(h=1, w=1, in_dep=n_in, in_bits=3, up_bound=in_bound, scale=1.0),
        [LayerSpec(Domain.INT, ConvKind.FC, n_out, PoolKind.NONE, Activation.RELU,
                   BiasKind.BNORM, conv_params=ConvParams(tern_thresh=0.1), shift_bits=3),
         LayerSpec(Domain.INT, ConvKind.FC, 3, PoolKind.NONE, Activation.NONE,
                   BiasKind.NONE)])
    rng = np.random.default_rng(0)
    wr = VarPrepWriter()
    wr.write_tern(rng.choice([-1, 0, 1], size=n_in * n_out))
    wr.write_i32(rng.integers(-8, 8, size=n_out))
    wr.write_i32(np.full(n_out, slope), signed=False)
    wr.write_tern(rng.choice([-1, 0, 1], size=n_out * 3))
    wr.write_i32(rng.integers(-4, 5, size=3))
    return spec, wr.getvalue()


def wrap_final_model():
    """The final-layer decrypt-centering model of tests/test_noise_sim.py: a
    class-0 logit near 600 > msg_space/2 = 512 wraps without centering."""
    spec = ModelSpec(
        "test/wrap_final",
        Dimensions(h=1, w=1, in_dep=16, in_bits=2, up_bound=1, scale=0.5),
        [LayerSpec(Domain.BIN, ConvKind.FC, 8, PoolKind.NONE, Activation.SIGN,
                   BiasKind.BNORM, conv_params=ConvParams(tern_thresh=0.1)),
         LayerSpec(Domain.BIN, ConvKind.FC_FINAL, 3, PoolKind.NONE, Activation.NONE,
                   BiasKind.BIAS, conv_params=ConvParams(tern_thresh=0.1))])
    rng = np.random.default_rng(11)
    wr = VarPrepWriter()
    wr.write_tern(rng.choice([-1, 0, 1], size=16 * 8))
    wr.write_i32(rng.integers(-2, 3, size=8))
    wr.write_tern(rng.choice([-1, 0, 1], size=8 * 3))
    wr.write_i32(np.array([600, 0, -600]))
    return spec, wr.getvalue(), rng


def _pair(spec, blob):
    return prep_model(spec, blob), jprep(jax_spec(spec), blob)


def _keys(seed):
    sk, cloud = kg.keygen(TEST_NOISELESS, seed=seed)
    jsk, jcloud = jkg.keygen(jparams.TEST_NOISELESS, seed=seed)
    return sk, bs.prepare_cloud_key(cloud, device="cpu"), jbs.prepare_cloud_key(jcloud)


def _forward_both(plan, jplan, info, jinfo, keys, ct):
    """Score ciphertexts of both packages' forwards under their own resolved
    info, asserted equal; the port's decrypted scores."""
    sk, dkey, jdkey = keys
    got = build_forward_impl(plan, dkey, info=info)(ct).numpy()
    want = np.asarray(jenc.build_forward_impl(jplan, jdkey.params, jdkey.plan, info=jinfo)(
        jdkey.bk_ntt, jdkey.ksk_limbs, jnp.asarray(ct)))
    np.testing.assert_array_equal(got, want)
    return decrypt_scores(sk, got, TEST_NOISELESS, model_out_gain(info), model_out_center(info))


def test_staircase_center_fold_exact():
    spec, blob = fc_relu_model()
    plan, jplan = _pair(spec, blob)
    q, jq = plan.layers[0].quant, jplan.layers[0].quant
    rng = np.random.default_rng(0)
    s = rng.integers(-50, 50, size=q.depth).astype(np.int64)
    x = np.arange(-200, 200, dtype=np.int64)
    for g in (1, 4):
        want = ops._staircase_i64(q, x * g, g)
        got_c = np.stack([ops._staircase_i64(q, (x + s[c]) * g, g, center=s)[c]
                          for c in range(q.depth)])
        np.testing.assert_array_equal(got_c, want)
        np.testing.assert_array_equal(want, jops._staircase_i64(jq, x * g, g))
        np.testing.assert_array_equal(ops._staircase_i64(q, x * g, g, center=s),
                                      jops._staircase_i64(jq, x * g, g, center=s))


def test_centered_relu_forward_is_reencoding_noop(monkeypatch):
    """Centered and uncentered (``center=False``, JAX's REDSEC_CENTER=0)
    forwards decode identically on noiseless keys, and each one's score
    ciphertexts equal the JAX package's."""
    plan, jplan = _pair(*fc_relu_model())
    rng = np.random.default_rng(7)
    x = rng.integers(0, 3, size=(12, 1, 1, 16)).astype(np.int32)
    rr.calibrate_ranges(plan, x, device="cpu")
    jranges.calibrate_ranges(jplan, x)
    monkeypatch.delenv("REDSEC_CENTER", raising=False)
    info = rr.resolve_pbs_ranges(plan, TEST_NOISELESS.msg_space)
    jinfo = jranges.resolve_pbs_ranges(jplan, TEST_NOISELESS.msg_space)
    assert any(r.center is not None for r in info.values())
    assert all(r.center is None or (np.asarray(r.center) % 2 == 0).all() for r in info.values())
    info0 = rr.resolve_pbs_ranges(plan, TEST_NOISELESS.msg_space, center=False)
    monkeypatch.setenv("REDSEC_CENTER", "0")
    jinfo0 = jranges.resolve_pbs_ranges(jplan, TEST_NOISELESS.msg_space)
    assert all(r.center is None for r in info0.values())

    keys = _keys(5)
    ct = encrypt_images(keys[0], x[:4], TEST_NOISELESS, rng)
    np.testing.assert_array_equal(_forward_both(plan, jplan, info, jinfo, keys, ct),
                                  _forward_both(plan, jplan, info0, jinfo0, keys, ct))


def test_input_gain_forward_matches_oracle():
    plan, jplan = _pair(*fc_relu_model())
    rng = np.random.default_rng(9)
    x = rng.integers(-1, 2, size=(8, 1, 1, 16)).astype(np.int32)
    rr.calibrate_ranges(plan, x, device="cpu")
    jranges.calibrate_ranges(jplan, x)
    info = rr.resolve_pbs_ranges(plan, TEST_NOISELESS.msg_space, input_gain=True)
    jinfo = jranges.resolve_pbs_ranges(jplan, TEST_NOISELESS.msg_space, input_gain=True)
    g0 = model_in_gain(info)
    assert g0 >= 2 and g0 == jenc.model_in_gain(jinfo)
    keys = _keys(6)
    ct = encrypt_images(keys[0], x[:4], TEST_NOISELESS, rng, gain=g0)
    got = _forward_both(plan, jplan, info, jinfo, keys, ct)
    np.testing.assert_array_equal(got, ptxt.build_forward(plan, "cpu")(x[:4]).numpy())


def test_sim_noiseless_reproduces_oracle():
    plan, jplan = _pair(*fc_relu_model())
    rng = np.random.default_rng(3)
    x = rng.integers(-2, 3, size=(16, 1, 1, 16)).astype(np.int32)
    rr.calibrate_ranges(plan, x, device="cpu")
    jranges.calibrate_ranges(jplan, x)
    p = get_params("small_v2_tpu")
    info = rr.resolve_pbs_ranges(plan, p.msg_space, input_gain=True)
    jinfo = jranges.resolve_pbs_ranges(jplan, p.msg_space, input_gain=True)
    exact = set(range(len(plan.layers)))
    scores, _ = simulate_forward(plan, x, p, info, np.random.default_rng(0),
                                 exact_layers=exact, device="cpu")
    jscores, _ = jns.simulate_forward(jplan, x, jparams.SMALL_V2_TPU, jinfo,
                                      np.random.default_rng(0), exact_layers=exact)
    np.testing.assert_array_equal(scores, ptxt.build_forward(plan, "cpu")(x).numpy())
    np.testing.assert_array_equal(scores, jscores)


def test_final_layer_decrypt_centering_rescues_wrapped_logits(monkeypatch):
    spec, blob, rng = wrap_final_model()
    plan, jplan = _pair(spec, blob)
    x = rng.choice([-1, 1], size=(6, 1, 1, 16)).astype(np.int32)
    rr.calibrate_ranges(plan, x, device="cpu")
    jranges.calibrate_ranges(jplan, x)
    monkeypatch.delenv("REDSEC_CENTER", raising=False)
    info = rr.resolve_pbs_ranges(plan, TEST_NOISELESS.msg_space)
    jinfo = jranges.resolve_pbs_ranges(jplan, TEST_NOISELESS.msg_space)
    assert info[1].center is not None
    want = ptxt.build_forward(plan, "cpu")(x).numpy()
    assert np.abs(want).max() > TEST_NOISELESS.msg_space // 2

    keys = _keys(8)
    ct = encrypt_images(keys[0], x, TEST_NOISELESS, rng)
    got = _forward_both(plan, jplan, info, jinfo, keys, ct)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))

    info0 = rr.resolve_pbs_ranges(plan, TEST_NOISELESS.msg_space, center=False)
    monkeypatch.setenv("REDSEC_CENTER", "0")
    jinfo0 = jranges.resolve_pbs_ranges(jplan, TEST_NOISELESS.msg_space)
    assert info0[1].center is None
    got0 = _forward_both(plan, jplan, info0, jinfo0, keys, ct)
    assert not (got0.argmax(1) == want.argmax(1)).all()


# --------------------------------------------------------------------------- #
# simulate_forward / agreement_estimate against JAX on the same generator     #
# --------------------------------------------------------------------------- #


def _sim_case(which):
    """(port plan, JAX plan, images) calibrated on both sides."""
    rng = np.random.default_rng(21)
    if which == "sign1024x1":
        plan = prep_model(get_model("mnist/sign1024x1"), GOLDEN)
        jplan = jprep(jget_model("mnist/sign1024x1"), GOLDEN)
        x = pixel_transform_for("mnist/sign1024x1")(rng.integers(0, 256, size=(6, 28, 28, 1)))
    elif which == "mini_maxpool":
        plan, jplan = _pair(*mini_maxpool_model(np.random.default_rng(3)))
        x = rng.integers(-15, 16, size=(10, 8, 8, 1)).astype(np.int32)
    elif which == "mini_relu":
        plan, jplan = _pair(*mini_relu_model(np.random.default_rng(3)))
        x = rng.integers(-1, 2, size=(10, 1, 1, 16)).astype(np.int32)
    else:
        plan, jplan = _pair(*fc_relu_model())
        x = rng.integers(0, 3, size=(10, 1, 1, 16)).astype(np.int32)
    rr.calibrate_ranges(plan, x, device="cpu")
    jranges.calibrate_ranges(jplan, x)
    return plan, jplan, x


@pytest.mark.parametrize("which,relu_mode,opts", [
    ("sign1024x1", None, {}),
    ("sign1024x1", None, {"majority": 3, "majority_from": 1}),
    ("sign1024x1", None, {"majority_plan": {0: 5}, "escalate": {1},
                          "escalate_params": "small_v2_n2048"}),
    ("mini_maxpool", None, {"majority": 3}),
    ("mini_relu", None, {}),
    ("mini_relu", "full", {"escalate": {0}, "escalate_params": "small_v2_n2048"}),
    ("fc_relu", "full", {}),
])
def test_simulate_forward_and_agreement_equal_jax(which, relu_mode, opts, monkeypatch):
    """One rollout per package from generators of one seed: the same scores
    and per-boundary flip stats; ``agreement_estimate`` over three trials
    returns the same dict.  Noise at ``small_v2_tpu``."""
    plan, jplan, x = _sim_case(which)
    p, jp = get_params("small_v2_tpu"), jparams.SMALL_V2_TPU
    if relu_mode:
        monkeypatch.setenv("REDSEC_RELU_MODE", relu_mode)
    else:
        monkeypatch.delenv("REDSEC_RELU_MODE", raising=False)
    kw = dict(strict=False, input_gain=True, sigma_units=p.mod_switch_sigma_units())
    info = rr.resolve_pbs_ranges(plan, p.msg_space, relu_mode=relu_mode, **kw)
    jinfo = jranges.resolve_pbs_ranges(jplan, jp.msg_space, **kw)
    sim_kw = dict(opts)
    jsim_kw = dict(opts)
    if "escalate_params" in opts:
        sim_kw["escalate_params"] = get_params(opts["escalate_params"])
        jsim_kw["escalate_params"] = jparams.get_params(opts["escalate_params"])

    trace = trace_oracle(plan, x, device="cpu")
    jtrace = jns.trace_oracle(jplan, x)
    assert len(trace) == len(jtrace)
    for t, jt in zip(trace, jtrace):
        assert t.keys() == jt.keys()
        for k in t:
            np.testing.assert_array_equal(t[k], jt[k])
    scores, stats = simulate_forward(plan, x, p, info, np.random.default_rng(4),
                                     oracle_trace=trace, device="cpu", **sim_kw)
    jscores, jstats = jns.simulate_forward(jplan, x, jp, jinfo, np.random.default_rng(4),
                                           oracle_trace=jtrace, **jsim_kw)
    np.testing.assert_array_equal(scores, jscores)
    assert stats == jstats and stats

    got = agreement_estimate(plan, x, p, info, trials=3, seed=2, per_layer=True,
                             device="cpu", **sim_kw)
    want = jns.agreement_estimate(jplan, x, jp, jinfo, trials=3, seed=2, per_layer=True,
                                  **jsim_kw)
    assert got == want


def test_simulator_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    plan, _, x = _sim_case("mini_relu")
    p = get_params("small_v2_tpu")
    info = rr.resolve_pbs_ranges(plan, p.msg_space, strict=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate_forward(plan, x, p, info, np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        trace_oracle(plan, x)


# --------------------------------------------------------------------------- #
# predict_agreement on a synthetic dataset                                    #
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def reference_dir(tmp_path_factory):
    """A directory laid out as the scripts read a reference checkout:
    ``nets/mnist/mnist_data.csv`` (label, then 784 pixels a row) of twelve
    synthetic MNIST-shaped images."""
    root = tmp_path_factory.mktemp("reference")
    d = root / "nets" / "mnist"
    d.mkdir(parents=True)
    rng = np.random.default_rng(17)
    ink = rng.random((12, 784)) < 0.2
    px = rng.integers(0, 256, size=(12, 784)) * ink
    labels = rng.integers(0, 10, size=12)
    with open(d / "mnist_data.csv", "w") as f:
        f.write("label,pixels\n")
        for lab, row in zip(labels, px):
            f.write(",".join(str(int(v)) for v in [lab, *row]) + "\n")
    return str(root)


def _jax_predict(argv, env, monkeypatch):
    """The JAX package's scripts/predict_agreement.py in this process, under
    ``env``; its last JSON line."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(sys, "argv", ["predict_agreement.py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(os.path.join(REPO, "scripts", "predict_agreement.py"),
                       run_name="__main__")
    return out.getvalue().strip().splitlines()[-1]


@pytest.mark.parametrize("flags,env", [
    (["--per-layer", "--input-gain"], {"REDSEC_INPUT_GAIN": "1"}),
    (["--no-tiebreak", "--cascade-w", "0.5", "--majority", "3", "--majority-from", "1"],
     {"REDSEC_TIEBREAK": "0", "REDSEC_CASCADE_W": "0.5"}),
    (["--exact-layers", "0", "--gain-mode", "max"], {"REDSEC_GAIN_MODE": "max"}),
    (["--isolate", "--input-gain"], {"REDSEC_INPUT_GAIN": "1"}),
])
def test_predict_agreement_prints_the_json_of_the_jax_script(reference_dir, flags, env,
                                                             monkeypatch, capsys):
    """The same arguments (the knobs as flags here, as environment variables
    there) print the same last line, but for its ``seconds``."""
    for k in ("REDSEC_INPUT_GAIN", "REDSEC_TIEBREAK", "REDSEC_CASCADE_W", "REDSEC_GAIN_MODE",
              "REDSEC_CENTER", "REDSEC_RELU_MODE", "REDSEC_MAX_FLIP"):
        monkeypatch.delenv(k, raising=False)
    common = ["--model", "mnist/sign1024x1", "--varprep", GOLDEN, "--reference", reference_dir,
              "--images", "6", "--trials", "2", "--params", "small_v2_tpu", "--no-range-check"]
    jflags = [f for f in flags if f not in ("--input-gain", "--no-tiebreak", "--gain-mode",
                                            "max", "--cascade-w", "0.5")]
    got = predict_agreement.main(common + flags + ["--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    tag = "ISOLATE " if "--isolate" in flags else "PREDICT "
    assert line.startswith(tag)
    jline = _jax_predict(common + jflags, env, monkeypatch)
    assert jline.startswith(tag)
    mine, theirs = json.loads(line[len(tag):]), json.loads(jline[len(tag):])
    assert mine.pop("seconds") >= 0 and theirs.pop("seconds") >= 0
    assert mine == theirs
    got.pop("seconds")
    assert json.loads(json.dumps(got)) == mine
