"""Majority voting and per-layer escalation, against the JAX package.

- ``majority_pbs`` and the majority-voted forward (the JAX package reads
  ``REDSEC_MAJORITY``, ``REDSEC_MAJORITY_FROM`` and ``REDSEC_MAJORITY_PLAN``
  from the environment, set here with ``monkeypatch``; the port takes them as
  arguments) on the mini conv-sign-maxpool model at ``test_noiseless``.
- The escalated forward against the JAX package's staged escalated forward:
  chosen layers' bootstraps run through a second key at N = 512 with the
  same n and message space (same-seed keygen shares the client LWE key).
- The flip-rate guard judging voted and escalated boundaries, the
  calibration knobs both ways, and ``run-encrypted --eval2`` through both
  command lines.

Tolerance: exact equality of int32 ciphertexts and of the guard's rates.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redsec_tpu import cli as jcli
from redsec_tpu.crypto import bootstrap as jbs
from redsec_tpu.crypto import keygen as jkg
from redsec_tpu.crypto import params as jparams
from redsec_tpu.models.spec import prep_model as jprep
from redsec_tpu.ops import encrypted as jeops
from redsec_tpu.runtime import calibration as jcal
from redsec_tpu.runtime import encrypted as jenc
from redsec_tpu.runtime import ranges as jrr
from redsec_tpu_torch import cli
from redsec_tpu_torch.compiler.netlist import spec_to_json
from redsec_tpu_torch.crypto import bootstrap as bs
from redsec_tpu_torch.crypto import keygen as kg
from redsec_tpu_torch.crypto import lwe
from redsec_tpu_torch.crypto import params as pparams
from redsec_tpu_torch.formats.image_io import write_image_ptxt
from redsec_tpu_torch.models.spec import prep_model
from redsec_tpu_torch.ops import encrypted as eops
from redsec_tpu_torch.runtime import calibration as cal
from redsec_tpu_torch.runtime import encrypted as enc
from redsec_tpu_torch.runtime import ranges as rr
from test_torch_forward_modes import staged_relu_model
from test_torch_relu import mini_maxpool_model
from test_torch_slice import jax_spec

torch.set_num_threads(2)

P = pparams.TEST_NOISELESS
P512 = dataclasses.replace(P, name="test_noiseless_n512", N=512)
JP = jparams.TEST_NOISELESS
JP512 = dataclasses.replace(JP, name="test_noiseless_n512", N=512)
SEED = 17


@pytest.fixture(scope="module")
def keys():
    sk, cloud = kg.keygen(P, seed=SEED)
    sk2, cloud2 = kg.keygen(P512, seed=SEED)
    np.testing.assert_array_equal(sk.lwe_key, sk2.lwe_key)  # the escalation contract
    _, jcloud = jkg.keygen(JP, seed=SEED)
    _, jcloud2 = jkg.keygen(JP512, seed=SEED)
    return (sk, bs.prepare_cloud_key(cloud, device="cpu"),
            bs.prepare_cloud_key(cloud2, device="cpu"),
            jbs.prepare_cloud_key(jcloud), jbs.prepare_cloud_key(jcloud2))


def _clear_knobs(monkeypatch):
    for k in jcal.ENV_KNOBS:
        monkeypatch.delenv(k, raising=False)


def _scrub():
    """Drop the knobs the JAX command line replays into os.environ (its
    ``apply_env_knobs``), so that they reach no later test."""
    for k in jcal.ENV_KNOBS:
        os.environ.pop(k, None)


def test_majority_pbs_equals_jax(keys):
    sk, dkey, _, jdkey, _ = keys
    rng = np.random.default_rng(1)
    ct = lwe.encrypt_integers(sk.lwe_key, rng.integers(-300, 300, size=6), P, rng)
    tv = bs.const_test_vector(P, 5, P.msg_space)
    pbs = bs.make_chunked_bootstrap(dkey)
    jpbs = jbs.make_chunked_bootstrap(jdkey)
    for k, salt in ((3, 0), (5, 4)):
        copies, tv1 = eops.majority_stage1_pre(torch.as_tensor(ct), P, k, dkey.rerand, salt)
        jcopies, jtv1 = jeops.majority_stage1_pre(jnp.asarray(ct), JP, k, jdkey.rerand, salt)
        np.testing.assert_array_equal(copies.numpy(), np.asarray(jcopies))
        np.testing.assert_array_equal(tv1.numpy(), np.asarray(jtv1))
        got = eops.majority_pbs(pbs, torch.as_tensor(ct), tv, P, k, dkey.rerand, salt)
        want = jeops.majority_pbs(jpbs, jnp.asarray(ct), jnp.asarray(tv), JP, k,
                                  jdkey.rerand, salt)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(eops.majority_vote_sum(copies, k).numpy(),
                                      np.asarray(jeops.majority_vote_sum(jcopies, k)))
    assert eops.MAJORITY_G1 == jeops.MAJORITY_G1


def test_majority_plan_resolves_as_in_jax(monkeypatch):
    _clear_knobs(monkeypatch)
    for majority, frm, plan in ((3, 1, "0:5, 2:1"), (1, 0, "1:3"), (5, 2, None)):
        monkeypatch.setenv("REDSEC_MAJORITY", str(majority))
        monkeypatch.setenv("REDSEC_MAJORITY_FROM", str(frm))
        if plan:
            monkeypatch.setenv("REDSEC_MAJORITY_PLAN", plan)
        else:
            monkeypatch.delenv("REDSEC_MAJORITY_PLAN", raising=False)
        for i in range(4):
            assert (enc.majority_k_for_layer(i, majority, frm, plan)
                    == jenc.majority_k_for_layer(i))
    with pytest.raises(ValueError, match="odd"):
        enc.majority_k_for_layer(0, 2)
    with pytest.raises(ValueError, match="odd"):
        enc.majority_k_for_layer(1, 1, 0, "1:4")


def _mini(rng_seed=3):
    spec, blob = mini_maxpool_model(np.random.default_rng(rng_seed))
    return spec, blob, prep_model(spec, blob), jprep(jax_spec(spec), blob)


# every sign and maxpool boundary of the mini net, voted globally, from a
# layer on, and by a per-layer plan
@pytest.mark.parametrize("majority,frm,plan", [(3, 0, None), (3, 1, "0:5,2:1")])
def test_majority_forward_equals_jax(keys, monkeypatch, majority, frm, plan):
    sk, dkey, _, jdkey, _ = keys
    _clear_knobs(monkeypatch)
    spec, blob, mplan, jplan = _mini()
    ct = enc.encrypt_images(sk, np.random.default_rng(4).integers(-15, 16, size=(1, 8, 8, 1)),
                            P, np.random.default_rng(5))
    fwd = enc.build_encrypted_forward(mplan, dkey, majority=majority, majority_from=frm,
                                      majority_plan=plan)
    got = fwd(ct).numpy()
    monkeypatch.setenv("REDSEC_MAJORITY", str(majority))
    monkeypatch.setenv("REDSEC_MAJORITY_FROM", str(frm))
    if plan:
        monkeypatch.setenv("REDSEC_MAJORITY_PLAN", plan)
    jfwd = jenc.build_encrypted_forward(jplan, jdkey, jit=True)
    np.testing.assert_array_equal(got, np.asarray(jfwd(jnp.asarray(ct))))
    ks = enc.majority_ks(mplan, majority, frm, plan)
    plain = enc.build_encrypted_forward(mplan, dkey)
    extra = sum((k if k > 1 else 0) * n for k, n in zip(ks.values(), (16, 64 + 16, 6, 0)))
    assert fwd.pbs_per_image == plain.pbs_per_image + extra


def test_majority_needs_the_rerand_pool(keys):
    _, dkey, _, _, _ = keys
    _, _, mplan, _ = _mini()
    with pytest.raises(ValueError, match="re-randomization pool"):
        enc.build_encrypted_forward(mplan, dataclasses.replace(dkey, rerand=None), majority=3)


# the JAX package runs a second key only in its staged forward; the port's
# one forward equals it: sign and maxpool boundaries escalated (one of them
# also voted), relu boundaries escalated as quarter-range and as FDFB
@pytest.mark.parametrize("net,layers,relu_mode,plan", [
    ("mini_maxpool", {0, 1}, None, None),
    ("mini_maxpool", {1}, None, "1:3"),
    ("relu_staged", {0}, "quarter", None),
    ("relu_staged", {0}, "full", None),
])
def test_escalated_forward_equals_jax_staged(keys, monkeypatch, net, layers, relu_mode, plan):
    sk, dkey, dkey2, jdkey, jdkey2 = keys
    _clear_knobs(monkeypatch)
    rng = np.random.default_rng(6)
    if net == "mini_maxpool":
        spec, blob, mplan, jplan = _mini()
        x = rng.integers(-15, 16, size=(1, 8, 8, 1))
    else:
        spec, blob = staged_relu_model(rng)
        mplan, jplan = prep_model(spec, blob), jprep(jax_spec(spec), blob)
        x = rng.integers(-1, 2, size=(2, 1, 1, 16))
    ct = enc.encrypt_images(sk, x, P, np.random.default_rng(7))
    fwd = enc.build_encrypted_forward(mplan, dkey, relu_mode=relu_mode, majority_plan=plan,
                                      escalate=(layers, dkey2))
    assert fwd.mode == "staged"
    got = fwd(ct).numpy()
    if relu_mode:
        monkeypatch.setenv("REDSEC_RELU_MODE", relu_mode)
    if plan:
        monkeypatch.setenv("REDSEC_MAJORITY_PLAN", plan)
    jfwd = jenc.build_encrypted_forward(jplan, jdkey, escalate=(layers, jdkey2))
    assert jfwd.mode == "staged"
    np.testing.assert_array_equal(got, np.asarray(jfwd(jnp.asarray(ct))))
    # and the escalated key really ran: the unescalated forward differs
    assert not np.array_equal(got, enc.build_encrypted_forward(
        mplan, dkey, relu_mode=relu_mode, majority_plan=plan)(ct).numpy())


def test_escalation_keys_must_share_the_message_space(keys):
    _, dkey, dkey2, _, _ = keys
    _, _, mplan, _ = _mini()
    other = dataclasses.replace(dkey2, params=dataclasses.replace(P512, msg_space=2048))
    with pytest.raises(ValueError, match="message space"):
        enc.build_encrypted_forward(mplan, dkey, escalate=({0}, other))


@pytest.mark.parametrize("ks,esc", [({}, None), ({}, {1, 2}), ({1: 3, 2: 5}, None),
                                    ({2: 3}, {2})])
def test_guard_judges_voted_and_escalated_boundaries_as_jax(monkeypatch, ks, esc):
    """On the calibrated mini sign net at small_v2_tpu's sigma the flip-rate
    guard reads an escalated boundary at small_v2_n2048's sigma and a voted
    one at its binomial tail, as the JAX package's does."""
    _clear_knobs(monkeypatch)
    _, _, mplan, jplan = _mini()
    x = np.random.default_rng(8).integers(-15, 16, size=(16, 8, 8, 1)).astype(np.int32)
    rr.calibrate_ranges(mplan, x, device="cpu")
    jrr.calibrate_ranges(jplan, x)
    sp = pparams.get_params("small_v2_tpu")
    if ks:
        monkeypatch.setenv("REDSEC_MAJORITY_PLAN", ",".join(f"{i}:{k}" for i, k in ks.items()))
    if esc:
        monkeypatch.setenv("REDSEC_ESCALATE", ",".join(map(str, sorted(esc))))
    kw = dict(input_gain=True, sigma_units=sp.mod_switch_sigma_units())
    outcome = []
    for strict in (False, True):
        try:
            got = rr.resolve_pbs_ranges(
                mplan, sp.msg_space, strict=strict, majority_ks=ks,
                escalate=None if esc is None else (esc, pparams.get_params("small_v2_n2048")),
                **kw)
            outcome.append("ok")
        except ValueError as e:
            outcome.append(str(e))
        try:
            want = jrr.resolve_pbs_ranges(jplan, sp.msg_space, strict=strict, **kw)
            outcome.append("ok")
        except ValueError as e:
            outcome.append(str(e).replace("REDSEC_MAX_FLIP=", "MAX_FLIP="))
        if not strict:
            for i in got:
                assert got[i].escalated_local_rate == want[i].escalated_local_rate
                assert got[i].local_flip_rate == want[i].local_flip_rate
            if esc:
                assert any(got[i].escalated_local_rate is not None for i in esc)
    assert outcome[2] == outcome[3]


def test_calibration_records_voting_and_escalation_both_ways(tmp_path, monkeypatch):
    _clear_knobs(monkeypatch)
    _, _, mplan, jplan = _mini()
    x = np.random.default_rng(9).integers(-15, 16, size=(8, 8, 8, 1)).astype(np.int32)
    rr.calibrate_ranges(mplan, x, device="cpu")
    jrr.calibrate_ranges(jplan, x)
    path = str(tmp_path / "port.npz")
    meta = cal.save_calibration(path, mplan, "test_noiseless", majority=3, majority_from=1,
                                majority_plan="2:5", escalate="1,2",
                                escalate_params="test_noiseless")
    env = {}
    jcal.apply_env_knobs(jcal.load_calibration(path, jplan), env)
    assert env == {"REDSEC_MAJORITY": "3", "REDSEC_MAJORITY_FROM": "1",
                   "REDSEC_MAJORITY_PLAN": "2:5", "REDSEC_ESCALATE": "1,2",
                   "REDSEC_ESCALATE_PARAMS": "test_noiseless"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jpath = str(tmp_path / "jax.npz")
    assert jcal.save_calibration(jpath, jplan, "test_noiseless") == meta
    jmeta = cal.load_calibration(jpath, mplan)
    assert cal.options_from_meta(jmeta) == {"input_gain": False, "relu_mode": None,
                                            "majority": 3, "majority_from": 1,
                                            "majority_plan": "2:5"}
    assert cal.escalation_from_meta(jmeta) == ({1, 2}, "test_noiseless")


@pytest.fixture
def n512_registered(monkeypatch):
    """The N = 512 escalation set under a name both packages' key files resolve."""
    monkeypatch.setitem(pparams.PARAM_SETS, P512.name, P512)
    monkeypatch.setitem(jparams.PARAM_SETS, JP512.name, JP512)


def _run(main, capsys, *argv):
    capsys.readouterr()
    ret = main([str(a) for a in argv])
    return capsys.readouterr().out, ret


def test_run_encrypted_eval2_equals_jax(tmp_path, capsys, monkeypatch, n512_registered):
    """The calibrating run records an escalation; run-encrypted without
    --eval2 refuses it with the JAX package's message, and with a same-seed
    N = 512 key gives the JAX command line's score file."""
    _clear_knobs(monkeypatch)
    d = tmp_path
    spec, blob, _, _ = _mini()
    (d / "w.dat").write_bytes(blob)
    with open(d / "spec.json", "w") as f:
        json.dump(spec_to_json(spec), f)
    rng = np.random.default_rng(10)
    with open(d / "data.csv", "w") as f:
        for label in range(6):
            f.write(f"{label}," + ",".join(str(v) for v in rng.integers(100, 156, size=64)) + "\n")
    for params, sub in (("test_noiseless", "k1"), (P512.name, "k2")):
        _run(cli.main, capsys, "keygen", "--params", params, "--seed", SEED, "--out-dir", d / sub)
    common = ["--model", d / "spec.json", "--weights", d / "w.dat"]
    _run(cli.main, capsys, "calibrate", *common, "--csv", d / "data.csv", "--rows", "0:6",
         "--params", "test_noiseless", "--escalate", "1", "--escalate-params", P512.name,
         "--majority-plan", "2:3", "--no-guard", "--out", d / "cal.npz", "--device", "cpu")
    write_image_ptxt(str(d / "img.ptxt"), 3, rng.integers(110, 145, size=(8, 8, 1)))
    _run(cli.main, capsys, "encrypt-image", "--secret", d / "k1" / "secret.key.npz",
         "--image-ptxt", d / "img.ptxt", "--calib", d / "cal.npz", "--out", d / "img.npz")
    run = ["run-encrypted", *common, "--eval", d / "k1" / "eval.key.npz", "--image",
           d / "img.npz", "--calib", d / "cal.npz"]
    with pytest.raises(SystemExit) as ours:
        _run(cli.main, capsys, *run, "--device", "cpu")
    with pytest.raises(SystemExit) as theirs:
        _run(jcli.main, capsys, *run)
    _scrub()
    assert str(ours.value) == str(theirs.value) and "--eval2" in str(ours.value)
    out, rec = _run(cli.main, capsys, *run, "--eval2", d / "k2" / "eval.key.npz",
                    "--out", d / "t.npz", "--device", "cpu")
    try:
        _run(jcli.main, capsys, *run, "--eval2", d / "k2" / "eval.key.npz", "--out", d / "j.npz")
    finally:
        _scrub()
    a, b = np.load(d / "t.npz"), np.load(d / "j.npz")
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert rec["mode"] == "staged" and rec["images"] == 1
    assert rec["pbs"] == 16 + 64 + 16 + 6 * 4  # layer 2's 6 signs voted at k = 3
