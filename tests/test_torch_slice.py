"""The port's slice end to end against the JAX package: keygen ->
prepare_cloud_key -> prep_model -> encrypt_images -> encrypted forward ->
decrypt_scores, on the same keys, weights and ciphertexts.  Tolerance: exact
equality of the int32 score ciphertexts (a PBS is deterministic)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redsec_tpu.crypto import bootstrap as jbs
from redsec_tpu.crypto import keygen as jkg
from redsec_tpu.crypto.params import TEST_NOISELESS as JP
from redsec_tpu.models.spec import prep_model as jprep
from redsec_tpu.models.zoo import get_model as jget_model
from redsec_tpu.runtime import encrypted as jenc
from redsec_tpu_torch.crypto import bootstrap as bs
from redsec_tpu_torch.crypto import keygen as kg
from redsec_tpu_torch.crypto.params import TEST_NOISELESS
from redsec_tpu_torch.formats.image_io import pixels_to_signed
from redsec_tpu_torch.formats.varprep import VarPrepWriter
from redsec_tpu_torch.models.dims import Dimensions
from redsec_tpu_torch.models.spec import (
    Activation, BiasKind, ConvKind, ConvParams, Domain, LayerSpec, ModelSpec,
    PoolKind, PoolParams, prep_model,
)
from redsec_tpu_torch.models.zoo import get_model
from redsec_tpu_torch.runtime.encrypted import (
    build_encrypted_forward, decrypt_scores, encrypt_images,
)

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def mini_sign_model(rng):
    """sumpool -> 3x3 conv -> FC16 -> FC10 on 8x8x1 inputs (the mini sign
    model of __graft_entry__._tiny_setup), built from the port's own spec
    classes; returns (spec, var_prep bytes)."""
    spec = ModelSpec(
        "entry/mini_sign",
        Dimensions(h=8, w=8, in_dep=1, in_bits=5, up_bound=30, scale=15.0),
        [
            LayerSpec(Domain.INT, ConvKind.NONE, 1, PoolKind.SUM, Activation.SIGN,
                      BiasKind.NONE, pool_params=PoolParams((2, 2), (2, 2))),
            LayerSpec(Domain.BIN, ConvKind.CONV, 4, PoolKind.NONE, Activation.SIGN,
                      BiasKind.BNORM, conv_params=ConvParams((3, 3), (1, 1), True)),
            LayerSpec(Domain.BIN, ConvKind.FC, 16, PoolKind.NONE, Activation.SIGN,
                      BiasKind.BNORM),
            LayerSpec(Domain.BIN, ConvKind.FC_FINAL, 10, PoolKind.NONE,
                      Activation.NONE, BiasKind.NONE),
        ],
    )
    wr = VarPrepWriter()
    wr.write_i32(np.array([0]))
    wr.write_tern(rng.choice([-1, 0, 1], size=3 * 3 * 1 * 4))
    wr.write_i32(rng.integers(-3, 4, size=4))
    wr.write_tern(rng.choice([-1, 0, 1], size=4 * 4 * 4 * 16))
    wr.write_i32(rng.integers(-3, 4, size=16))
    wr.write_tern(rng.choice([-1, 0, 1], size=16 * 10))
    wr.write_i32(rng.integers(-3, 4, size=10))
    return spec, wr.getvalue()


@pytest.fixture(scope="module")
def keys():
    sk, cloud = kg.keygen(TEST_NOISELESS, seed=0)
    jsk, jcloud = jkg.keygen(JP, seed=0)
    return sk, bs.prepare_cloud_key(cloud, device="cpu"), jsk, jbs.prepare_cloud_key(jcloud)


def test_mini_sign_model_bit_identical_to_jax(keys):
    sk, dkey, jsk, jdkey = keys
    spec, blob = mini_sign_model(np.random.default_rng(0))
    plan = prep_model(spec, blob)
    jplan = jprep(jax_spec(spec), blob)
    rng = np.random.default_rng(1)
    x = rng.integers(-15, 16, size=(4, 8, 8, 1)).astype(np.int32)
    ct = encrypt_images(sk, x, TEST_NOISELESS, rng)

    fwd = build_encrypted_forward(plan, dkey)
    got = fwd(torch.as_tensor(ct)).numpy()
    jfwd = jenc.build_encrypted_forward(jplan, jdkey)
    want = np.asarray(jfwd(jnp.asarray(ct)))
    assert got.shape == (4, 10, TEST_NOISELESS.n + 1)
    np.testing.assert_array_equal(got, want)

    scores = decrypt_scores(sk, got, TEST_NOISELESS, fwd.out_gain, fwd.out_center)
    jscores = jenc.decrypt_scores(jsk, want, JP, jfwd.out_gain, jfwd.out_center)
    np.testing.assert_array_equal(scores, jscores)
    assert (fwd.out_gain, fwd.in_gain) == (jfwd.out_gain, jfwd.in_gain)


def jax_spec(spec):
    """The JAX package's ModelSpec of a port spec (through its enum values)."""
    from redsec_tpu.models import dims as jd
    from redsec_tpu.models import spec as js

    layers = [js.LayerSpec(
        js.Domain(ls.domain.value), js.ConvKind(ls.conv.value), ls.out_depth,
        js.PoolKind(ls.pool.value), js.Activation(ls.activation.value),
        js.BiasKind(ls.bias.value),
        conv_params=js.ConvParams(ls.conv_params.window, ls.conv_params.stride,
                                  ls.conv_params.same_pad, ls.conv_params.tern_thresh),
        pool_params=js.PoolParams(ls.pool_params.window, ls.pool_params.stride,
                                  ls.pool_params.same_pad),
        shift_bits=ls.shift_bits) for ls in spec.layers]
    d = spec.input_dims
    return js.ModelSpec(spec.name, jd.Dimensions(d.h, d.w, d.in_dep, d.in_bits, d.out_bits,
                                                 d.filter_bits, d.bias_bits, d.up_bound,
                                                 d.scale), layers)


@pytest.mark.slow
def test_sign1024x1_full_width_bit_identical_to_jax(keys):
    """Full-width mnist/sign1024x1 (1220 PBS per image) with the golden
    reference weights, one image.  range_check=False on both sides: the
    certified bound exceeds test_noiseless's +-512 budget, and parity, not
    accuracy, is this test's contract."""
    sk, dkey, jsk, jdkey = keys
    blob = open(os.path.join(GOLDEN, "sign1024x1_var_prep_from_ref_wght.dat"), "rb").read()
    plan = prep_model(get_model("mnist/sign1024x1"), blob)
    jplan = jprep(jget_model("mnist/sign1024x1"), blob)
    rng = np.random.default_rng(2)
    x = pixels_to_signed(rng.integers(0, 256, size=(1, 28, 28, 1)))
    ct = encrypt_images(sk, x, TEST_NOISELESS, rng)
    got = build_encrypted_forward(plan, dkey, range_check=False)(ct).numpy()
    want = np.asarray(jenc.build_encrypted_forward(jplan, jdkey, range_check=False)(
        jnp.asarray(ct)))
    np.testing.assert_array_equal(got, want)
