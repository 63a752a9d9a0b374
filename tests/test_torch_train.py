"""The port's sign-BNN trainer (``compiler/train.py``) against the JAX
package's on the CPU, at the mini spec and seeds of tests/test_train.py.

Tolerances: geometry, init draws, integer conv/FC sums, logits and hard
activations exact; batch statistics and v within rtol 2e-6 (float32 sums in
another order); the loss and its gradients within rtol 1e-5 of
``jax.value_and_grad`` of JAX's own loss composition, each gradient tensor
also within 1e-5 of its largest entry: a weight gradient is a sum of terms
that cancel, to exactly 0 in XLA's order and to about 1e-9 in torch's
(rtol alone fails on such entries: 0 against 2.3e-9, with |grad| up to
0.01); one Adam step equal to optax's bit for bit.  JAX's threefry draws cannot be matched, so the tests
that train with noise hold the contract (the exported pipeline agrees with
the trainer), not the trajectory."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from redsec_tpu.compiler import train as jtrain
from redsec_tpu.compiler.weight_convert import weight_convert as jweight_convert
from redsec_tpu_torch.compiler import train as tr
from redsec_tpu_torch.compiler.weight_convert import weight_convert
from test_torch_slice import jax_spec
from torch_train_specs import mini_spec, sign_data as data, write_csv

torch.set_num_threads(2)


def perturbed_params(spec, seed=1):
    """init_params with random betas, so every BN term is live."""
    params = tr.init_params(spec, seed)
    rng = np.random.default_rng(seed + 100)
    for p in params:
        if "beta" in p:
            p["beta"] = rng.normal(0, 0.5, size=p["beta"].shape).astype(np.float32)
    return params


def jax_walk(spec, params, px):
    """JAX's stats pass (the body of its export_trained) with its
    intermediates kept: per weight layer (s, mu, sd, hard sign output)."""
    jspec = jax_spec(spec)
    geom = jtrain._layer_geometry(jspec)
    x = jnp.asarray(px).astype(jnp.float32)
    B, H, W, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C).sum(axis=(2, 4))
    a = jtrain._ste_sign(x)
    out = []
    for g, p in zip(geom, params):
        wq = jtrain._ste_tern(jnp.asarray(p["w"]), g["thresh"])
        if g["kind"].name == "CONV":
            s = jax.lax.conv_general_dilated(a, wq, (1, 1), "SAME",
                                             dimension_numbers=("NHWC", "HWIO", "NHWC"))
        else:
            s = a.reshape(a.shape[0], -1) @ wq.reshape(-1, g["shape"][3])
        if g["kind"].name == "FC_FINAL":
            out.append((s, None, None, None))
            return out
        mu = s.mean(axis=tuple(range(s.ndim - 1)))
        sd = jnp.sqrt(s.var(axis=tuple(range(s.ndim - 1))) + 1e-3)
        a = jtrain._ste_sign((s - mu) / sd + p["beta"])
        act = a
        if g["maxpool"]:
            B, H, W, C = a.shape
            a = a.reshape(B, H // 2, 2, W // 2, 2, C).max(axis=(2, 4))
        out.append((s, mu, sd, act))
    raise AssertionError


def jax_loss_fn(spec, px, labels, cfg):
    """JAX's training objective (the closure in its train), without noise."""
    forward, geom = jtrain.build_twin(jax_spec(spec))
    x, onehot = jnp.asarray(px), jax.nn.one_hot(jnp.asarray(labels), geom[-1]["shape"][3])

    def loss_fn(params):
        logits, vs = forward(params, x)
        z_true = (logits * onehot).sum(-1)
        z_other = jnp.max(logits - 1e9 * onehot, axis=-1)
        l_cls = jnp.mean(jax.nn.relu(cfg.logit_margin - (z_true - z_other))
                         / cfg.logit_margin)
        l_m = sum(jnp.mean(jax.nn.relu(cfg.margin - jnp.abs(v)) / cfg.margin)
                  for v in vs) / len(vs)
        l_b = sum(jnp.mean(jax.nn.relu(jnp.abs(v) - cfg.bound) / cfg.bound)
                  for v in vs) / len(vs)
        return l_cls + cfg.lam_margin * l_m + cfg.lam_bound * l_b

    return loss_fn


def port_loss_and_grads(spec, params, px, labels, cfg):
    forward, geom = tr.build_twin(spec)
    tp = tr.to_torch(params, "cpu", requires_grad=True)
    onehot = torch.nn.functional.one_hot(torch.as_tensor(labels, dtype=torch.int64),
                                         geom[-1]["shape"][3]).float()
    loss, _ = tr.sign_loss(forward, tp, torch.as_tensor(px), onehot, cfg)
    leaves = [t for p in tp for t in p.values()]
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


def test_geometry_and_init_equal_jax():
    spec = mini_spec()
    geom, jgeom = tr._layer_geometry(spec), jtrain._layer_geometry(jax_spec(spec))
    assert len(geom) == len(jgeom) == 3
    for g, jg in zip(geom, jgeom):
        assert {k: (v.value if hasattr(v, "value") else v) for k, v in g.items()} == \
            {k: (v.value if hasattr(v, "value") else v) for k, v in jg.items()}
    for seed in (0, 5):
        for p, jp in zip(tr.init_params(spec, seed), jtrain.init_params(jax_spec(spec), seed)):
            assert p.keys() == jp.keys()
            for k in p:
                assert p[k].dtype == jp[k].dtype
                np.testing.assert_array_equal(p[k], jp[k])


def test_twin_forward_matches_jax_without_noise():
    spec = mini_spec()
    px, _ = data()
    params = perturbed_params(spec)
    record = tr.stats_pass(spec, params, px, device="cpu")
    want = jax_walk(spec, params, px)
    assert len(record) == len(want) == 3
    for (s, mu, sd), (js, jmu, jsd, _) in zip(record, want):
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert np.array_equal(s.numpy(), np.round(s.numpy()))
        if jmu is not None:
            np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=2e-6)
            np.testing.assert_allclose(sd.numpy(), np.asarray(jsd), rtol=2e-6)

    forward, _ = tr.build_twin(spec)
    with torch.no_grad():
        logits, vs = forward(tr.to_torch(params, "cpu"), torch.as_tensor(px))
    jforward, _ = jtrain.build_twin(jax_spec(spec))
    jlogits, jvs = jforward(params, jnp.asarray(px))
    np.testing.assert_array_equal(logits.numpy(), np.asarray(jlogits))
    for v, jv in zip(vs, jvs):
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=2e-6)
    # the hard activations: sign(y) per boundary, recomputed from the port's
    # own statistics, equal JAX's exactly
    for (s, mu, sd), (_, _, _, jact), p in zip(record[:-1], want[:-1], params):
        y = (s - mu) / sd + torch.as_tensor(p["beta"])
        np.testing.assert_array_equal(torch.where(y >= 0, 1.0, -1.0).numpy(), np.asarray(jact))


def test_loss_and_gradients_match_jax_value_and_grad():
    spec = mini_spec()
    px, labels = data()
    params = perturbed_params(spec)
    cfg = tr.TrainConfig()
    loss, grads = port_loss_and_grads(spec, params, px, labels, cfg)
    jl, jg = jax.value_and_grad(jax_loss_fn(spec, px, labels, cfg))(
        jax.tree_util.tree_map(jnp.asarray, params))
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    jleaves = [np.asarray(jp[k]) for jp, p in zip(jg, params) for k in p]
    assert len(grads) == len(jleaves) == 5
    for g, want in zip(grads, jleaves):
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_straight_through_gradients_at_ties_match_jax():
    """1 inside (-1, 1), 0.5 at exactly +-1, 0 outside, for the sign and the
    ternarizer; the maxpool and logit max split ties evenly."""
    v = np.array([-2.0, -1.0, -0.5, -0.0, 0.0, 0.03, 0.05, 1.0, 2.0], np.float32)
    up = np.arange(1, v.size + 1, dtype=np.float32)
    for port_fn, jax_fn in ((tr._ste_sign, jtrain._ste_sign),
                            (lambda t: tr._ste_tern(t, 0.05), lambda t: jtrain._ste_tern(t, 0.05))):
        t = torch.tensor(v, requires_grad=True)
        out = port_fn(t)
        (g,) = torch.autograd.grad((out * torch.tensor(up)).sum(), t)
        jout, jvjp = jax.vjp(jax_fn, jnp.asarray(v))
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
        np.testing.assert_array_equal(g.numpy(), np.asarray(jvjp(jnp.asarray(up))[0]))
    # a 2x2 window of four equal values, one of three ties, one strict max
    a = np.array([[1, 1, 1, -1], [1, 1, 1, 1], [-1, -1, -1, -1], [-1, 1, -1, -1]],
                 np.float32).reshape(1, 4, 4, 1)
    up = np.arange(1, 5, dtype=np.float32).reshape(1, 2, 2, 1)
    t = torch.tensor(a, requires_grad=True)
    (g,) = torch.autograd.grad((tr._maxpool2(t) * torch.tensor(up)).sum(), t)
    jfn = lambda x: x.reshape(1, 2, 2, 2, 2, 1).max(axis=(2, 4))  # noqa: E731
    _, jvjp = jax.vjp(jfn, jnp.asarray(a))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jvjp(jnp.asarray(up))[0]))


def test_gradients_match_jax_with_forced_ties():
    """The whole loss with y exactly +-1 on two channels of each BN layer
    (their weights zeroed: s = mu = 0, so y = beta = +-1) and the maxpool
    windows of +-1 activations, which tie throughout."""
    spec = mini_spec()
    px, labels = data()
    params = perturbed_params(spec, seed=2)
    for p in params[:2]:
        p["w"][..., 0] = 0.0
        p["w"][..., 1] = 0.0
        p["beta"][0], p["beta"][1] = 1.0, -1.0
    record = tr.stats_pass(spec, params, px, device="cpu")
    for s, mu, sd in record[:2]:
        y = (s - mu) / sd + torch.as_tensor(np.array([1.0, -1.0] + [0.0] * (s.shape[-1] - 2),
                                                     np.float32))
        assert set(np.unique(y[..., :2].numpy())) == {-1.0, 1.0}
    cfg = tr.TrainConfig()
    loss, grads = port_loss_and_grads(spec, params, px, labels, cfg)
    jl, jg = jax.value_and_grad(jax_loss_fn(spec, px, labels, cfg))(
        jax.tree_util.tree_map(jnp.asarray, params))
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    for g, want in zip(grads, [np.asarray(jp[k]) for jp, p in zip(jg, params) for k in p]):
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_one_adam_step_equals_optax_bit_for_bit():
    """One step (and three) of the port's Adam equal optax.adam applied op
    by op, bit for bit.  Under jax.jit, XLA contracts (1 - b1) * g + b1 * mu
    into one fused multiply-add, so the jitted step (the one JAX's train
    runs) may differ from both in the last bit of the moments; that step is
    held within 2 ulp of the parameters' magnitude."""
    spec = mini_spec()
    params = perturbed_params(spec)
    rng = np.random.default_rng(7)
    flat =[v for p in params for v in p.values()]
    grads = [[rng.normal(0, 1e-2, size=v.shape).astype(np.float32) for v in flat]
             for _ in range(3)]
    leaves = [torch.tensor(v) for v in flat]
    opt = tr.Adam(leaves, 2e-3)
    jopt = optax.adam(2e-3)
    jp = [jnp.asarray(v) for v in flat]
    state = jopt.init(jp)
    jit_update = jax.jit(lambda g, s, p: jopt.update(g, s, p))
    jpj, statej = list(jp), jopt.init(jp)
    for k, g in enumerate(grads):
        opt.step([torch.tensor(x) for x in g])
        upd, state = jopt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for t, want in zip(leaves, jp):
            np.testing.assert_array_equal(t.numpy(), np.asarray(want), err_msg=f"step {k}")
        updj, statej = jit_update([jnp.asarray(x) for x in g], statej, jpj)
        jpj = optax.apply_updates(jpj, updj)
        for t, want in zip(leaves, jpj):
            np.testing.assert_allclose(t.numpy(), np.asarray(want), rtol=0,
                                       atol=2 * np.spacing(np.abs(np.asarray(want)).max()))


def test_export_matches_jax_and_weight_convert_is_byte_identical():
    """var.dat1 of the same params and images: weights, betas and means
    byte-identical to JAX's, the variances within rtol 2e-6 (float32 sums
    of (s - mean)^2, a non-integer sum that XLA and torch order
    differently); the var_prep.dat weight_convert makes of each (the file
    the engine runs) byte-identical."""
    spec = mini_spec()
    px, _ = data()
    params = perturbed_params(spec)
    raw = tr.export_trained(spec, params, px, device="cpu")
    jraw = jtrain.export_trained(jax_spec(spec), params, px)
    assert len(raw) == len(jraw)
    got, want = np.frombuffer(raw, "<f4"), np.frombuffer(jraw, "<f4")
    is_var = np.zeros(got.size, bool)
    off = 0
    for g, p in zip(tr._layer_geometry(spec), params):
        off += p["w"].size
        if g["bnorm"]:
            d = p["beta"].size
            is_var[off + 2 * d: off + 3 * d] = True
            off += 3 * d
    np.testing.assert_array_equal(got[~is_var], want[~is_var])
    np.testing.assert_allclose(got[is_var], want[is_var], rtol=2e-6)
    assert weight_convert(spec, raw) == jweight_convert(jax_spec(spec), jraw)
    assert weight_convert(spec, raw) == weight_convert(spec, jraw)


def test_scan_chunk_keeps_jax_history_rule(capsys):
    spec = mini_spec()
    px, labels = data()
    _, hist = tr.train(spec, px, labels, tr.TrainConfig(steps=5, scan_chunk=2), device="cpu")
    assert [h[0] for h in hist] == [1, 3, 5] and all(h[3] == -1.0 for h in hist)
    _, hist = tr.train(spec, px, labels, tr.TrainConfig(steps=5, log_every=2), device="cpu")
    assert [h[0] for h in hist] == [0, 2, 4] and all(h[3] >= 0 for h in hist)
    assert "min|v|" in capsys.readouterr().out


def test_train_export_roundtrip_bit_exact():
    """tests/test_train.py's contract: after train -> export -> weight_convert
    -> prep_model the plaintext engine predicts exactly what the trainer's
    hard forward predicts, and training moved the twin off chance."""
    px, labels = data()
    raw, prep, rep = tr.train_and_export(mini_spec(), px, labels,
                                         tr.TrainConfig(steps=80, log_every=1000), device="cpu")
    assert rep["twin_vs_ptxt_agreement"] == 1.0, rep
    assert len(raw) > 0 and len(prep) > 0
    assert rep["train_acc_twin"] >= 0.4


def test_margin_loss_shapes_margins():
    """With the margin hinge active, trained boundaries hold fewer pre-PBS
    values inside the +-4 band than the same training without it."""
    spec = mini_spec()
    px, labels = data(seed=5)

    def frac_thin(params, m=4.0):
        forward, _ = tr.build_twin(spec)
        with torch.no_grad():
            _, vs = forward(tr.to_torch(params, "cpu"), torch.as_tensor(px))
        return sum(int((v.abs() < m).sum()) for v in vs) / sum(v.numel() for v in vs)

    p_off, _ = tr.train(spec, px, labels, tr.TrainConfig(
        steps=150, log_every=1000, seed=5, lam_margin=0.0, hidden_noise=0.0), device="cpu")
    p_on, _ = tr.train(spec, px, labels, tr.TrainConfig(
        steps=150, log_every=1000, seed=5, lam_margin=4.0, hidden_noise=0.0), device="cpu")
    f0, f1 = frac_thin(p_off), frac_thin(p_on)
    assert f1 < f0, (f0, f1)


def test_train_script_on_a_synthetic_csv(tmp_path):
    from redsec_tpu_torch.scripts import train_cifar_small

    rng = np.random.default_rng(4)
    os.makedirs(tmp_path / "nets" / "mnist")
    write_csv(tmp_path / "nets" / "mnist" / "mnist_data.csv", rng.integers(0, 10, size=8),
              rng.integers(0, 256, size=(8, 28, 28, 1)))
    out = tmp_path / "out"
    rep = train_cifar_small.main(["--reference", str(tmp_path), "--model", "mnist/sign1024x1",
                                  "--steps", "3", "--device", "cpu", "--out-dir", str(out)])
    assert rep["twin_vs_ptxt_agreement"] == 1.0
    with open(out / "train_report.json") as f:
        assert json.load(f)["history"] == [list(h) for h in rep["history"]]
    from redsec_tpu_torch.models.spec import prep_model
    from redsec_tpu_torch.models.zoo import get_model

    prep = (out / "var_prep.dat").read_bytes()
    assert prep == weight_convert(get_model("mnist/sign1024x1"), (out / "var.dat1").read_bytes())
    assert len(prep_model(get_model("mnist/sign1024x1"), prep).layers) == 3
