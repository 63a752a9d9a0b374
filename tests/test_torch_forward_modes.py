"""The port's one eager forward against each of the JAX package's forwards
(``jit=True``, ``"layer"`` and ``"staged"``) on the same keys, weights and
ciphertexts, and ``forward.mode`` naming what ``jit="auto"`` picks.
Tolerance: exact equality of the int32 score ciphertexts (a PBS is
deterministic).  JAX's ``pbs_chunk=16, pbs_macro=7`` cuts every PBS boundary
into macro slices with a padded tail."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redsec_tpu.models.spec import prep_model as jprep
from redsec_tpu.models.zoo import get_model as jget_model
from redsec_tpu.runtime import encrypted as jenc
from redsec_tpu_torch.formats.varprep import VarPrepWriter
from redsec_tpu_torch.models.dims import Dimensions
from redsec_tpu_torch.models.spec import (
    Activation, BiasKind, ConvKind, ConvParams, Domain, LayerSpec, ModelSpec, PoolKind,
    prep_model,
)
from redsec_tpu_torch.models.zoo import get_model
from redsec_tpu_torch.runtime.encrypted import build_encrypted_forward, encrypt_images
from test_torch_relu import P, keys, mini_maxpool_model  # noqa: F401
from test_torch_slice import jax_spec, mini_sign_model

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def staged_relu_model(rng):
    """FC8 relu(shift 3) -> FC3 on 1x1x16 ternary inputs: the per-activation
    ([m, N]) test-vector net of the JAX package's staged-forward test."""
    spec = ModelSpec(
        "test/relu_staged",
        Dimensions(h=1, w=1, in_dep=16, in_bits=3, up_bound=4, scale=1.0),
        [
            LayerSpec(Domain.INT, ConvKind.FC, 8, PoolKind.NONE, Activation.RELU,
                      BiasKind.BNORM, conv_params=ConvParams(tern_thresh=0.1), shift_bits=3),
            LayerSpec(Domain.INT, ConvKind.FC, 3, PoolKind.NONE, Activation.NONE,
                      BiasKind.NONE),
        ],
    )
    wr = VarPrepWriter()
    wr.write_tern(rng.choice([-1, 0, 1], size=16 * 8))
    wr.write_i32(rng.integers(-64, 64, size=8))
    wr.write_i32(np.full(8, 16), signed=False)
    wr.write_tern(rng.choice([-1, 0, 1], size=8 * 3))
    wr.write_i32(rng.integers(-4, 5, size=3))
    return spec, wr.getvalue()


NETS = {  # model builder, one image
    "relu_staged": (staged_relu_model, lambda rng: rng.integers(-1, 2, size=(1, 1, 1, 16))),
    "mini_maxpool": (mini_maxpool_model, lambda rng: rng.integers(-15, 16, size=(1, 8, 8, 1))),
}


_PORT_OUT = {}  # (net, relu_mode) -> the port's scores: one forward for the three JAX ones


# mini_maxpool is the JAX package's mini sign net (sumpool+sign ->
# conv+sign+maxpool -> fc+sign -> fc): every sign, maxpool and bias boundary
@pytest.mark.parametrize("jit", [True, "layer", "staged"])
@pytest.mark.parametrize("net,relu_mode", [
    ("mini_maxpool", None), ("relu_staged", "quarter"), ("relu_staged", "full")])
def test_forward_bit_identical_to_each_jax_forward(keys, monkeypatch, net, relu_mode, jit):
    sk, dkey, _, jdkey = keys
    build, images = NETS[net]
    spec, blob = build(np.random.default_rng(3))
    plan, jplan = prep_model(spec, blob), jprep(jax_spec(spec), blob)
    rng = np.random.default_rng(4)
    ct = encrypt_images(sk, images(rng).astype(np.int32), P, rng)
    monkeypatch.setenv("REDSEC_INPUT_GAIN", "0")
    if relu_mode:
        monkeypatch.setenv("REDSEC_RELU_MODE", relu_mode)
    else:
        monkeypatch.delenv("REDSEC_RELU_MODE", raising=False)
    jfwd = jenc.build_encrypted_forward(jplan, jdkey, jit=jit, pbs_chunk=16, pbs_macro=7)
    assert jfwd.mode == jit
    if (net, relu_mode) not in _PORT_OUT:
        fwd = build_encrypted_forward(plan, dkey, pbs_chunk=16, relu_mode=relu_mode)
        _PORT_OUT[net, relu_mode] = fwd(torch.as_tensor(ct)).numpy()
    np.testing.assert_array_equal(_PORT_OUT[net, relu_mode], np.asarray(jfwd(jnp.asarray(ct))))


def _deep_sign_model(rng, depth=8):
    """``depth`` FC4+sign layers and a final FC3 on 1x1x4 inputs."""
    layers = [LayerSpec(Domain.INT, ConvKind.FC, 4, PoolKind.NONE, Activation.SIGN,
                        BiasKind.NONE)]
    layers += [LayerSpec(Domain.BIN, ConvKind.FC, 4, PoolKind.NONE, Activation.SIGN,
                         BiasKind.BNORM) for _ in range(depth - 2)]
    layers.append(LayerSpec(Domain.BIN, ConvKind.FC_FINAL, 3, PoolKind.NONE,
                            Activation.NONE, BiasKind.NONE))
    spec = ModelSpec("test/deep_sign", Dimensions(h=1, w=1, in_dep=4, in_bits=2, up_bound=2,
                                                  scale=1.0), layers)
    wr = VarPrepWriter()
    for ls in layers:
        wr.write_tern(rng.choice([-1, 0, 1], size=4 * ls.out_depth))
        wr.write_i32(rng.integers(-2, 3, size=ls.out_depth))
    return spec, wr.getvalue()


@pytest.mark.parametrize("net,want", [
    ("mnist/sign1024x1", "whole"), ("cifar/binarynet", "staged"),
    ("cifar/binarynet_small", "staged"), ("deep_sign", "layer")])
def test_mode_names_what_jax_auto_picks(keys, monkeypatch, net, want):
    _, dkey, _, jdkey = keys
    monkeypatch.setenv("REDSEC_INPUT_GAIN", "0")
    monkeypatch.delenv("REDSEC_RELU_MODE", raising=False)
    if net == "deep_sign":
        spec, blob = _deep_sign_model(np.random.default_rng(0))
        jspec = jax_spec(spec)
    else:
        weights = (os.path.join(REPO, "tests", "golden", "sign1024x1_var_prep_from_ref_wght.dat")
                   if net.startswith("mnist") else
                   os.path.join(REPO, "nets_trained", net, "var_prep.dat"))
        blob = open(weights, "rb").read()
        spec, jspec = get_model(net), jget_model(net)
    plan, jplan = prep_model(spec, blob), jprep(jspec, blob)
    fwd = build_encrypted_forward(plan, dkey, range_check=False)
    jmode = jenc.build_encrypted_forward(jplan, jdkey, range_check=False).mode
    assert fwd.mode == want
    assert {True: "whole"}.get(jmode, jmode) == want


def test_escalation_raises(keys):
    """Escalation is ported (tests/test_torch_escalation.py holds it against
    the JAX package); what raises is a second key that cannot take the first
    key's ciphertexts: another message space or another LWE dimension."""
    import dataclasses

    dkey = keys[1]
    spec, blob = mini_sign_model(np.random.default_rng(0))
    plan = prep_model(spec, blob)
    for change, match in (({"msg_space": 2 * P.msg_space}, "message space"),
                          ({"n": P.n + 2}, "LWE dimension")):
        other = dataclasses.replace(dkey, params=dataclasses.replace(P, **change))
        with pytest.raises(ValueError, match=match):
            build_encrypted_forward(plan, dkey, escalate=({1}, other))
    assert build_encrypted_forward(plan, dkey, escalate=({1}, dkey)).mode == "staged"
