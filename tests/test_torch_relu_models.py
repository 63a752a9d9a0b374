"""Models with relu and maxpool layers end to end against the JAX package:
the same keys, weights and encrypted images through both
``build_encrypted_forward``s, in every relu mode.  Tolerance: exact equality
of the int32 score ciphertexts (a PBS is deterministic).  The JAX package
takes its options from the environment (``REDSEC_RELU_MODE``,
``REDSEC_INPUT_GAIN``), the port as arguments."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redsec_tpu.models.spec import prep_model as jprep
from redsec_tpu.models.zoo import get_model as jget_model
from redsec_tpu.runtime import calibration as jcal
from redsec_tpu.runtime import encrypted as jenc
from redsec_tpu_torch.crypto import kernels
from redsec_tpu_torch.formats.image_io import pixel_transform_for
from redsec_tpu_torch.models.spec import prep_model
from redsec_tpu_torch.models.zoo import get_model
from redsec_tpu_torch.runtime import calibration as cal
from redsec_tpu_torch.runtime.encrypted import (
    build_encrypted_forward, decrypt_scores, encrypt_images,
)
from test_torch_relu import P, keys, mini_maxpool_model, mini_relu_model  # noqa: F401
from test_torch_slice import jax_spec

torch.set_num_threads(2)

RELU_NET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "nets_trained", "mnist", "relu1024x1")


def _forward_pair(keys, plan, jplan, x, monkeypatch, relu_mode=None, input_gain=False,
                  pbs_chunk=16, range_check=True):
    """Score ciphertexts of the same encrypted images through both packages;
    the JAX side gets its options through the environment."""
    sk, dkey, _, jdkey = keys
    if relu_mode:
        monkeypatch.setenv("REDSEC_RELU_MODE", relu_mode)
    else:
        monkeypatch.delenv("REDSEC_RELU_MODE", raising=False)
    monkeypatch.setenv("REDSEC_INPUT_GAIN", "1" if input_gain else "0")
    fwd = build_encrypted_forward(plan, dkey, pbs_chunk=pbs_chunk, relu_mode=relu_mode,
                                  input_gain=input_gain, range_check=range_check)
    jfwd = jenc.build_encrypted_forward(jplan, jdkey, pbs_chunk=pbs_chunk,
                                        range_check=range_check)
    assert (fwd.in_gain, fwd.out_gain) == (jfwd.in_gain, jfwd.out_gain)
    rng = np.random.default_rng(50)
    ct = encrypt_images(sk, x, dkey.params, rng, gain=fwd.in_gain)
    got = fwd(ct)
    want = np.asarray(jfwd(jnp.asarray(ct)))
    return fwd, got.numpy(), want


@pytest.mark.parametrize("relu_mode,input_gain",
                         [(None, False), ("quarter", True), ("full", False), ("full", True)])
def test_mini_relu_model_bit_identical_to_jax(keys, monkeypatch, relu_mode, input_gain):
    spec, blob = mini_relu_model(np.random.default_rng(3))
    plan, jplan = prep_model(spec, blob), jprep(jax_spec(spec), blob)
    x = np.random.default_rng(4).integers(-1, 2, size=(2, 1, 1, 16)).astype(np.int32)
    fwd, got, want = _forward_pair(keys, plan, jplan, x, monkeypatch, relu_mode, input_gain)
    assert got.shape == (2, 10, P.n + 1)
    np.testing.assert_array_equal(got, want)
    scores = decrypt_scores(keys[0], got, P, fwd.out_gain, fwd.out_center)
    assert scores.shape == (2, 10)


def test_mini_maxpool_model_bit_identical_to_jax(keys, monkeypatch):
    """conv-sign-maxpool: the sign feeding the window OR emits +-V."""
    spec, blob = mini_maxpool_model(np.random.default_rng(5))
    plan, jplan = prep_model(spec, blob), jprep(jax_spec(spec), blob)
    x = np.random.default_rng(6).integers(-15, 16, size=(1, 8, 8, 1)).astype(np.int32)
    _, got, want = _forward_pair(keys, plan, jplan, x, monkeypatch)
    assert got.shape == (1, 3, P.n + 1)
    np.testing.assert_array_equal(got, want)


# the PBS count is what the kernel gets: three an FDFB relu activation, one a
# sign activation and a maxpool output (16 * 3 = 48 an image on the relu net;
# 16 + 64 + 16 + 6 = 102 on the maxpool net), counted at the kernel's door
@pytest.mark.parametrize("net,relu_mode,want", [("relu", "full", 48), ("maxpool", None, 102)])
def test_pbs_per_image_counts_the_batches_the_kernel_gets(keys, monkeypatch, net, relu_mode,
                                                         want):
    make, shape = {"relu": (mini_relu_model, (2, 1, 1, 16)),
                   "maxpool": (mini_maxpool_model, (2, 8, 8, 1))}[net]
    spec, blob = make(np.random.default_rng(7))
    plan, jplan = prep_model(spec, blob), jprep(jax_spec(spec), blob)
    x = np.random.default_rng(8).integers(-1, 2, size=shape).astype(np.int32)
    door = kernels.blind_rotate
    batches = []

    def counted(acc0, *args, **kw):
        batches.append(acc0.shape[0])
        return door(acc0, *args, **kw)

    monkeypatch.setattr(kernels, "blind_rotate", counted)
    fwd, got, want_ct = _forward_pair(keys, plan, jplan, x, monkeypatch, relu_mode)
    np.testing.assert_array_equal(got, want_ct)
    assert fwd.pbs_per_image == want
    assert sum(batches) == want * x.shape[0]


def test_an_unknown_relu_mode_raises(keys):
    spec, blob = mini_relu_model(np.random.default_rng(3))
    with pytest.raises(ValueError, match="relu_mode"):
        build_encrypted_forward(prep_model(spec, blob), keys[1], relu_mode="half")


@pytest.mark.slow
@pytest.mark.parametrize("relu_mode", [None, "full"])
def test_relu1024x1_full_width_bit_identical_to_jax(keys, monkeypatch, relu_mode):
    """Full-width mnist/relu1024x1 with its committed weights and calibration
    artifact, one image: 1024 PBS as calibrated (quarter), 3072 with FDFB
    forced.  On the test_noiseless key with range_check=False on both sides:
    the artifact targets small_v2_tpu's wider message space, and parity, not
    accuracy, is this test's contract (small_v2_tpu on the CPU takes an hour)."""
    weights = os.path.join(RELU_NET, "var_prep.dat")
    plan = prep_model(get_model("mnist/relu1024x1"), weights)
    jplan = jprep(jget_model("mnist/relu1024x1"), weights)
    opts = cal.options_from_meta(cal.load_calibration(
        os.path.join(RELU_NET, "calibration.npz"), plan))
    jcal.load_calibration(os.path.join(RELU_NET, "calibration.npz"), jplan)
    assert opts == {"input_gain": True, "relu_mode": None, "majority": 1, "majority_from": 0,
                    "majority_plan": None, "center": True, "tiebreak": True,
                    "gain_mode": "flip", "cascade_w": 0.25, "max_flip": 0.05}
    rng = np.random.default_rng(1)  # a fifth of the pixels inked, as on MNIST rows
    raw = rng.integers(0, 256, size=(1, 28, 28, 1)) * (rng.random((1, 28, 28, 1)) < 0.19)
    x = pixel_transform_for("mnist/relu1024x1")(raw)
    _, got, want = _forward_pair(keys, plan, jplan, x, monkeypatch,
                                 relu_mode or opts["relu_mode"], opts["input_gain"],
                                 pbs_chunk=256, range_check=False)
    assert got.shape == (1, 10, P.n + 1)
    np.testing.assert_array_equal(got, want)
