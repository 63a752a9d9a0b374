"""The port's relu trainer (``compiler/train_relu.py``) against the JAX
package's on the CPU, at the mini spec and seeds of tests/test_train_relu.py.

Tolerances: geometry, init draws, the float64 hard walk, the export, v and
the logits exact; the staircase arguments within rtol 2e-6 (plus 2e-6 of
their largest magnitude, where they cross zero); the loss and
gradients within rtol 1e-5 of ``jax.value_and_grad`` of JAX's own loss
composition, plus 1e-5 of each tensor's largest entry (cancelling sums, as
in test_torch_train.py); five noise-free training steps within rtol 1e-5 of JAX's
``train_relu``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redsec_tpu.compiler import train_relu as jrelu
from redsec_tpu_torch.compiler import train as tr
from redsec_tpu_torch.compiler import train_relu as trr
from redsec_tpu_torch.compiler.weight_convert import weight_convert
from redsec_tpu_torch.models.spec import prep_model
from redsec_tpu_torch.runtime.ptxt import build_forward
from test_torch_slice import jax_spec
from torch_train_specs import mini_relu_spec, relu_data as data, write_csv

torch.set_num_threads(2)


def perturbed_params(spec, seed=1):
    params = trr.init_relu_params(spec, seed)
    rng = np.random.default_rng(seed + 100)
    for p in params:
        if "beta" in p:
            p["beta"] = rng.normal(0, 0.3, size=p["beta"].shape).astype(np.float32)
    return params


def jax_loss_fn(spec, px, labels, cfg):
    """JAX's relu training objective (the closure in its train_relu), no noise."""
    forward, geom = jrelu.build_relu_twin(jax_spec(spec))
    x, onehot = jnp.asarray(px), jax.nn.one_hot(jnp.asarray(labels), geom[-1]["shape"][3])

    def loss_fn(params):
        logits, ys, vs = forward(params, x)
        z_true = (logits * onehot).sum(-1)
        z_other = jnp.max(logits - 1e9 * onehot, axis=-1)
        l_cls = jnp.mean(jax.nn.relu(cfg.logit_margin - (z_true - z_other))
                         / cfg.logit_margin)
        l_e = 0.0
        for g, yc in zip(geom, ys):
            top = float((1 << g["shift"]) - 1)
            ycl = jnp.clip(yc, -0.5, top + 0.5)
            d = 0.5 - jnp.abs(ycl - jnp.round(ycl))
            l_e += jnp.mean(jax.nn.relu(cfg.edge_margin - d) / cfg.edge_margin)
        l_e /= max(len(ys), 1)
        l_b = sum(jnp.mean(jax.nn.relu(jnp.abs(v) - cfg.bound) / cfg.bound)
                  for v in vs) / max(len(vs), 1)
        return l_cls + cfg.lam_edge * l_e + cfg.lam_bound * l_b

    return loss_fn


def loss_and_grads(spec, params, px, labels, cfg):
    forward, geom = trr.build_relu_twin(spec)
    tp = tr.to_torch(params, "cpu", requires_grad=True)
    onehot = torch.nn.functional.one_hot(torch.as_tensor(labels, dtype=torch.int64),
                                         geom[-1]["shape"][3]).float()
    loss, _ = trr.relu_loss(forward, geom, tp, torch.as_tensor(px), onehot, cfg)
    grads = torch.autograd.grad(loss, [t for p in tp for t in p.values()])
    jl, jg = jax.value_and_grad(jax_loss_fn(spec, px, labels, cfg))(
        jax.tree_util.tree_map(jnp.asarray, params))
    want = [np.asarray(jp[k]) for jp, p in zip(jg, params) for k in p]
    return float(loss.detach()), [g.numpy() for g in grads], float(jl), want


def test_geometry_recurrence_and_init_equal_jax():
    spec = mini_relu_spec()
    geom, lead = trr._relu_geometry(spec)
    assert lead == (2, 2)
    assert [g["shape"] for g in geom] == [(1, 1, 16, 32), (1, 1, 32, 16), (1, 1, 16, 3)]
    # converter recurrence: scale 1*4 -> sc_b=2, sb=8+2-3=7; then scale=7
    # -> sc_b=3, sb=8+3-4=7; final no relu
    assert geom[0]["scale"] == 4.0 and geom[0]["slope_bits"] == 7
    assert geom[1]["scale"] == 7.0 and geom[1]["slope_bits"] == 7
    assert not geom[2]["relu"]
    assert (geom, lead) == jrelu._relu_geometry(jax_spec(spec))
    for p, jp in zip(trr.init_relu_params(spec, 1), jrelu.init_relu_params(jax_spec(spec), 1)):
        assert p.keys() == jp.keys()
        for k in p:
            np.testing.assert_array_equal(p[k], jp[k])


def test_twin_forward_matches_jax_without_noise():
    spec = mini_relu_spec()
    px, _ = data()
    params = perturbed_params(spec)
    forward, _ = trr.build_relu_twin(spec)
    with torch.no_grad():
        logits, ys, vs = forward(tr.to_torch(params, "cpu"), torch.as_tensor(px))
    jforward, _ = jrelu.build_relu_twin(jax_spec(spec))
    jlogits, jys, jvs = jforward(params, jnp.asarray(px))
    # logits are integer sums of the hard staircase outputs: exact
    np.testing.assert_array_equal(logits.numpy(), np.asarray(jlogits))
    for v, jv in zip(vs, jvs):
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    # y_cont = 2^shift * (standardised v + beta) + 0.5 rounds at the scale of
    # its largest terms; where it passes near zero one float32 ulp of those
    # terms exceeds 2e-6 of the result, so the bound is 2e-6 of the largest
    # |y_cont| there (rtol alone fails on 1 of 768 entries: 9.5e-7 at 0.025)
    for y, jy in zip(ys, jys):
        jy = np.asarray(jy)
        np.testing.assert_allclose(y.numpy(), jy, rtol=2e-6, atol=2e-6 * np.abs(jy).max())


def test_hard_walk_and_export_equal_jax():
    spec = mini_relu_spec()
    px, _ = data()
    params = perturbed_params(spec)
    got, arrays = trr._hard_walk(spec, params, px)
    want, jarrays = jrelu._hard_walk(jax_spec(spec), params, px)
    np.testing.assert_array_equal(got, want)
    assert len(arrays) == len(jarrays)
    for a, b in zip(arrays, jarrays):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert trr.export_trained_relu(spec, params, px) == \
        jrelu.export_trained_relu(jax_spec(spec), params, px)


def test_hard_walk_matches_exported_pipeline_untrained():
    """Even at random init, the float64 hard walk equals the exported
    plaintext engine bit for bit (the emulation is exact, not trained in)."""
    spec = mini_relu_spec()
    px, _ = data()
    params = trr.init_relu_params(spec, seed=1)
    want, _ = trr._hard_walk(spec, params, px)
    plan = prep_model(spec, weight_convert(spec, trr.export_trained_relu(spec, params, px)))
    got = build_forward(plan, "cpu")(px).numpy()
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_loss_and_gradients_match_jax_value_and_grad():
    spec = mini_relu_spec()
    px, labels = data()
    loss, grads, jl, want = loss_and_grads(spec, perturbed_params(spec), px, labels,
                                           trr.ReluTrainConfig())
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    assert len(grads) == len(want) == 5
    for g, w in zip(grads, want):
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


def test_gradients_match_jax_at_the_clip_bounds():
    """Two channels of the first layer with zeroed weights (s = mu = 0):
    beta 0 puts y_cont at exactly 0.5, the surrogate's lower clip bound, and
    beta 7/8 at exactly top + 0.5, the edge clip's upper bound; JAX halves
    the gradient there, as the port must."""
    spec = mini_relu_spec()
    px, labels = data()
    params = perturbed_params(spec, seed=2)
    params[0]["w"][..., 0] = 0.0
    params[0]["w"][..., 1] = 0.0
    params[0]["beta"][0], params[0]["beta"][1] = 0.0, 7.0 / 8.0
    forward, _ = trr.build_relu_twin(spec)
    with torch.no_grad():
        _, ys, _ = forward(tr.to_torch(params, "cpu"), torch.as_tensor(px))
    assert set(ys[0][:, 0].numpy()) == {0.5} and set(ys[0][:, 1].numpy()) == {7.5}
    loss, grads, jl, want = loss_and_grads(spec, params, px, labels, trr.ReluTrainConfig())
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
    assert grads[1][0] != 0 and grads[1][1] != 0  # the tied channels' betas learn


def test_five_noise_free_steps_match_jax_train_relu(capsys):
    spec = mini_relu_spec()
    px, labels = data()
    cfg = trr.ReluTrainConfig(steps=5, hidden_noise=0.0, log_every=1)
    params, hist = trr.train_relu(spec, px, labels, cfg, device="cpu")
    jparams, jhist = jrelu.train_relu(jax_spec(spec), px, labels, cfg)
    for p, jp in zip(params, jparams):
        for k in p:
            np.testing.assert_allclose(p[k], jp[k], rtol=1e-5, atol=1e-7)
    assert [h[0] for h in hist] == [h[0] for h in jhist] == [0, 1, 2, 3, 4]
    np.testing.assert_allclose([h[1] for h in hist], [h[1] for h in jhist], rtol=1e-5)
    assert [h[2] for h in hist] == [h[2] for h in jhist]
    assert "train_acc" in capsys.readouterr().out


@pytest.mark.slow
def test_train_and_export_relu_self_check():
    """tests/test_train_relu.py's contract: after 300 steps the exported
    plaintext engine bit-matches the hard walk, and the twin fits."""
    spec = mini_relu_spec()
    px, labels = data()
    cfg = trr.ReluTrainConfig(steps=300, log_every=150, bound=600.0)
    raw, prep, report = trr.train_and_export_relu(spec, px, labels, cfg, device="cpu")
    assert report["logits_bit_exact"], report
    assert report["twin_vs_ptxt_agreement"] == 1.0
    assert report["train_acc_twin"] >= 0.9, report
    assert len(raw) > 0 and len(prep) > 0


def test_relu_script_on_a_synthetic_csv(tmp_path):
    from redsec_tpu_torch.models.zoo import get_model
    from redsec_tpu_torch.scripts import train_relu_mnist

    rng = np.random.default_rng(6)
    os.makedirs(tmp_path / "nets" / "mnist")
    px = rng.integers(0, 256, size=(8, 28, 28, 1)) * (rng.random((8, 28, 28, 1)) < 0.19)
    write_csv(tmp_path / "nets" / "mnist" / "mnist_data.csv", rng.integers(0, 10, size=8), px)
    out = tmp_path / "out"
    rep = train_relu_mnist.main(["--reference", str(tmp_path), "--steps", "3",
                                 "--device", "cpu", "--out-dir", str(out)])
    assert rep["logits_bit_exact"] and rep["twin_vs_ptxt_agreement"] == 1.0
    raw = (out / "var.dat1").read_bytes()
    assert (out / "var_prep.dat").read_bytes() == weight_convert(get_model("mnist/relu1024x1"),
                                                                 raw)
    assert (out / "train_report.json").exists()
