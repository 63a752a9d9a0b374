"""The port's relu (1-PBS quarter-range and 3-PBS FDFB) and window-OR maxpool
operators against the JAX package on the same numpy-seeded inputs, keys and
weights (the models that use them: test_torch_relu_models.py).  Tolerance:
exact equality of the int32/int64 arrays (test vectors are integer formulas,
a PBS is deterministic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redsec_tpu.crypto import bootstrap as jbs
from redsec_tpu.crypto import keygen as jkg
from redsec_tpu.crypto.params import SMALL_V2_TPU as JP_SMALL
from redsec_tpu.crypto.params import TEST_NOISELESS as JP
from redsec_tpu.models import spec as jspec
from redsec_tpu.ops import encrypted as jops
from redsec_tpu_torch.crypto import bootstrap as bs
from redsec_tpu_torch.crypto import keygen as kg
from redsec_tpu_torch.crypto import lwe
from redsec_tpu_torch.crypto.params import SMALL_V2_TPU, TEST_NOISELESS
from redsec_tpu_torch.formats.varprep import VarPrepWriter
from redsec_tpu_torch.models.dims import Dimensions
from redsec_tpu_torch.models.spec import (
    Activation, BiasKind, ConvKind, ConvParams, Domain, LayerSpec, ModelSpec,
    PoolKind, PoolParams, PoolPlan, QuantPlan,
)
from redsec_tpu_torch.ops import encrypted as ops

torch.set_num_threads(2)

P = TEST_NOISELESS


@pytest.fixture(scope="module")
def keys():
    sk, cloud = kg.keygen(P, seed=0)
    jsk, jcloud = jkg.keygen(JP, seed=0)
    return sk, bs.prepare_cloud_key(cloud, device="cpu"), jsk, jbs.prepare_cloud_key(jcloud)


def _pbs_pair(keys, chunk=16):
    """The port's and the JAX package's chunked PBS on the same key."""
    _, dkey, _, jdkey = keys
    return (bs.make_chunked_bootstrap(dkey, chunk=chunk),
            jbs.make_chunked_bootstrap(jdkey, chunk=chunk))


def relu_plans(rng, C=4, shift_bits=3, slope_bits=7):
    """One QuantPlan per package with the same random slopes and biases."""
    slope = rng.integers(1, 6, size=C).astype(np.uint32)
    bias = rng.integers(-300, 300, size=C).astype(np.int32)
    kw = dict(bias=bias, slope=slope, shift_bits=shift_bits, slope_bits=slope_bits,
              in_bits=9, h=1, w=1, depth=C)
    return (QuantPlan(mode=Activation.RELU, **kw),
            jspec.QuantPlan(mode=jspec.Activation.RELU, **kw))


@pytest.mark.parametrize("g_in", [1, 8])
@pytest.mark.parametrize("centered", [False, True])
def test_relu_test_vectors_equal_jax(g_in, centered):
    rng = np.random.default_rng(10 + g_in)
    q, jq = relu_plans(rng)
    center = rng.integers(-40, 40, size=q.depth) * 2 if centered else None
    got = ops.relu_test_vectors(q, SMALL_V2_TPU, g_in, 3, center)
    want = jops.relu_test_vectors(jq, JP_SMALL, g_in, 3, center)
    assert got.dtype == want.dtype == np.int32 and got.shape == (q.depth, SMALL_V2_TPU.N)
    np.testing.assert_array_equal(got, want)
    v = rng.integers(-2048, 2048, size=200)
    np.testing.assert_array_equal(ops._staircase_i64(q, v, g_in, center),
                                  jops._staircase_i64(jq, v, g_in, center))


@pytest.mark.parametrize("g_in", [1, 8])
@pytest.mark.parametrize("centered", [False, True])
def test_relu_fdfb_test_vectors_equal_jax(g_in, centered):
    rng = np.random.default_rng(20 + g_in)
    q, jq = relu_plans(rng)
    center = rng.integers(-40, 40, size=q.depth) * 2 if centered else None
    got = ops.relu_fdfb_test_vectors(q, SMALL_V2_TPU, g_in, 2, center)
    want = jops.relu_fdfb_test_vectors(jq, JP_SMALL, g_in, 2, center)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_staircase_rejects_a_gain_that_is_no_power_of_two():
    q, _ = relu_plans(np.random.default_rng(0))
    with pytest.raises(ValueError, match="power of two"):
        ops._staircase_i64(q, np.arange(4), 3)


def _ct(rng, shape):
    x = rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
    x.reshape(-1)[:4] = [2**31 - 1, -2**31, 2**31 - 2, -2**31 + 1]
    x[..., -1].reshape(-1)[:2] = [2**31 - 1, -2**31]  # the body column wraps too
    return x


@pytest.mark.parametrize("centered", [False, True])
def test_quant_relu_pre_equals_jax(centered):
    rng = np.random.default_rng(30)
    q, jq = relu_plans(rng)
    x = _ct(rng, (2, 3, 2, q.depth, 9))
    center = rng.integers(-40, 40, size=q.depth) * 2 if centered else None
    xb, tv = ops.quant_relu_pre(q, torch.as_tensor(x), SMALL_V2_TPU, 2, 4, center)
    jxb, jtv = jops.quant_relu_pre(jq, jnp.asarray(x), JP_SMALL, 2, 4, center)
    np.testing.assert_array_equal(xb.numpy(), np.asarray(jxb))
    assert tv.shape == (2 * 3 * 2 * q.depth, SMALL_V2_TPU.N)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jtv))


def test_fdfb_stages_equal_jax():
    rng = np.random.default_rng(31)
    q, jq = relu_plans(rng)
    x = _ct(rng, (3, 1, 2, q.depth, 9))
    center = rng.integers(-40, 40, size=q.depth) * 2
    flat, tv = ops.quant_relu_fdfb_stage1(q, torch.as_tensor(x), SMALL_V2_TPU, 2, center)
    jflat, jtv = jops.quant_relu_fdfb_stage1(jq, jnp.asarray(x), JP_SMALL, 2, center)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jtv))
    s = _ct(rng, flat.shape)  # any ciphertext: the glue is leveled
    got = ops.quant_relu_fdfb_stage2(q, flat, torch.as_tensor(s), SMALL_V2_TPU, 2, 4, center)
    want = jops.quant_relu_fdfb_stage2(jq, jflat, jnp.asarray(s), JP_SMALL, 2, 4, center)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def pool_plans(**kw):
    return PoolPlan(**kw), jspec.PoolPlan(**kw)


def test_maxpool_pre_on_a_padded_window_equals_jax():
    """5x5 input, 2x2 window, stride 2, one row and column of padding: the
    border outputs see 1 or 2 in-bounds slots, the inner ones 4, and the OR
    bias counts only those."""
    mp, jmp = pool_plans(window=(2, 2), stride=(2, 2), offset=(1, 1), in_h=5, in_w=5,
                         depth=3, out_h=3, out_w=3)
    rng = np.random.default_rng(32)
    x = _ct(rng, (2, 5, 5, 3, 9))
    s, tv = ops.maxpool_pre(mp, torch.as_tensor(x), SMALL_V2_TPU, 5)
    js, jtv = jops.maxpool_pre(jmp, jnp.asarray(x), JP_SMALL, 5)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jtv))
    assert ops.maxpool_sign_value(mp, SMALL_V2_TPU) == jops.maxpool_sign_value(jmp, JP_SMALL) \
        == SMALL_V2_TPU.msg_space // 16
    # the bias differs between a corner (1 slot) and the centre (4 slots)
    zero = torch.zeros((1, 5, 5, 3, 9), dtype=torch.int32)
    body = ops.maxpool_pre(mp, zero, SMALL_V2_TPU)[0][0, :, :, 0, -1]
    assert body[0, 0] == 0 and body[1, 1] != 0 and body[0, 1] != body[1, 1]


@pytest.mark.parametrize("centered", [False, True])
def test_quant_relu_enc_through_a_real_pbs_equals_jax(keys, centered):
    """36 ciphertexts in PBS chunks of 16 (two full, one partial), each with
    its own channel's test vector."""
    sk = keys[0]
    pbs, jpbs = _pbs_pair(keys)
    rng = np.random.default_rng(40)
    q, jq = relu_plans(rng, C=4)
    vals = rng.integers(-120, 120, size=(9, 1, 1, 4))
    ct = lwe.encrypt_integers(sk.lwe_key, vals, P, rng)
    center = np.array([4, -6, 0, 10]) if centered else None
    got = ops.quant_relu_enc(q, torch.as_tensor(ct), pbs, P, 1, 2, center).numpy()
    want = np.asarray(jops.quant_relu_enc(jq, jnp.asarray(ct), jpbs, JP, 1, 2, center))
    assert got.shape == ct.shape
    np.testing.assert_array_equal(got, want)


def test_quant_relu_fdfb_enc_through_a_real_pbs_equals_jax(keys):
    sk = keys[0]
    pbs, jpbs = _pbs_pair(keys)
    rng = np.random.default_rng(41)
    q, jq = relu_plans(rng, C=4)
    vals = rng.integers(-250, 250, size=(3, 1, 1, 4))
    ct = lwe.encrypt_integers(sk.lwe_key, vals, P, rng)
    center = np.array([4, -6, 0, 10])
    got = ops.quant_relu_fdfb_enc(q, torch.as_tensor(ct), pbs, P, 1, 2, center).numpy()
    want = np.asarray(jops.quant_relu_fdfb_enc(jq, jnp.asarray(ct), jpbs, JP, 1, 2, center))
    np.testing.assert_array_equal(got, want)


def test_maxpool_enc_through_a_real_pbs_equals_jax(keys):
    sk = keys[0]
    pbs, jpbs = _pbs_pair(keys)
    mp, jmp = pool_plans(window=(2, 2), stride=(2, 2), offset=(1, 1), in_h=3, in_w=3,
                         depth=2, out_h=2, out_w=2)
    rng = np.random.default_rng(42)
    V = ops.maxpool_sign_value(mp, P)
    vals = rng.choice([-V, V], size=(3, 3, 3, 2))
    ct = lwe.encrypt_integers(sk.lwe_key, vals, P, rng)
    got = ops.maxpool_enc(mp, torch.as_tensor(ct), pbs, P, 3).numpy()
    want = np.asarray(jops.maxpool_enc(jmp, jnp.asarray(ct), jpbs, JP, 3))
    assert got.shape == (3, 2, 2, 2, P.n + 1)
    np.testing.assert_array_equal(got, want)


def test_per_ciphertext_test_vectors_through_the_chunked_pbs(keys):
    """[m, N] test vectors handed over as a non-contiguous expanded view, with
    a partial last chunk: equal to bootstrapping each ciphertext alone."""
    sk, dkey = keys[0], keys[1]
    rng = np.random.default_rng(43)
    C, m = 3, 6
    tvs = torch.as_tensor(rng.integers(-2**31, 2**31, size=(C, P.N)).astype(np.int32))
    view = tvs[None].expand(m // C, C, P.N)
    assert not view.is_contiguous()
    tv_all = view.reshape(m, P.N)
    strided = torch.as_tensor(rng.integers(-2**31, 2**31, size=(m, 2 * P.N))
                              .astype(np.int32))[:, ::2]
    ct = torch.as_tensor(lwe.encrypt_integers(sk.lwe_key, rng.integers(-200, 200, size=m),
                                              P, rng))
    one = bs.make_batched_bootstrap(dkey)
    for tv in (tv_all, strided):
        got = bs.make_chunked_bootstrap(dkey, chunk=4)(ct, tv)
        want = torch.cat([one(ct[i:i + 1], tv[i].contiguous()) for i in range(m)])
        assert torch.equal(got, want)
    assert torch.equal(bs.make_chunked_bootstrap(dkey, chunk=4)(ct, view),
                       bs.make_chunked_bootstrap(dkey, chunk=64)(ct, tv_all))


def mini_relu_model(rng):
    """FC16 relu(shift 3) -> FC10 on 1x1x16 ternary inputs."""
    spec = ModelSpec(
        "entry/mini_relu",
        Dimensions(h=1, w=1, in_dep=16, in_bits=3, up_bound=4, scale=1.0),
        [
            LayerSpec(Domain.INT, ConvKind.FC, 16, PoolKind.NONE, Activation.RELU,
                      BiasKind.BNORM, conv_params=ConvParams(tern_thresh=0.1), shift_bits=3),
            LayerSpec(Domain.INT, ConvKind.FC, 10, PoolKind.NONE, Activation.NONE,
                      BiasKind.NONE),
        ],
    )
    wr = VarPrepWriter()
    wr.write_tern(rng.choice([-1, 0, 1], size=16 * 16))
    wr.write_i32(rng.integers(-64, 64, size=16))
    wr.write_i32(np.full(16, 16), signed=False)  # slope
    wr.write_tern(rng.choice([-1, 0, 1], size=16 * 10))
    wr.write_i32(rng.integers(-4, 5, size=10))
    return spec, wr.getvalue()


def mini_maxpool_model(rng):
    """sumpool+sign -> 3x3 conv(4)+sign+2x2 maxpool -> FC6+sign -> FC3 on 8x8x1."""
    spec = ModelSpec(
        "entry/mini_maxpool",
        Dimensions(h=8, w=8, in_dep=1, in_bits=5, up_bound=30, scale=15.0),
        [
            LayerSpec(Domain.INT, ConvKind.NONE, 1, PoolKind.SUM, Activation.SIGN,
                      BiasKind.NONE, pool_params=PoolParams((2, 2), (2, 2))),
            LayerSpec(Domain.BIN, ConvKind.CONV, 4, PoolKind.MAX, Activation.SIGN,
                      BiasKind.BNORM, conv_params=ConvParams((3, 3), (1, 1), True),
                      pool_params=PoolParams((2, 2), (2, 2))),
            LayerSpec(Domain.BIN, ConvKind.FC, 6, PoolKind.NONE, Activation.SIGN,
                      BiasKind.BNORM),
            LayerSpec(Domain.BIN, ConvKind.FC_FINAL, 3, PoolKind.NONE, Activation.NONE,
                      BiasKind.NONE),
        ],
    )
    wr = VarPrepWriter()
    wr.write_i32(np.array([1]))
    wr.write_tern(rng.choice([-1, 0, 1], size=3 * 3 * 1 * 4))
    wr.write_i32(rng.integers(-3, 4, size=4))
    wr.write_tern(rng.choice([-1, 0, 1], size=2 * 2 * 4 * 6))
    wr.write_i32(rng.integers(-3, 4, size=6))
    wr.write_tern(rng.choice([-1, 0, 1], size=6 * 3))
    wr.write_i32(rng.integers(-3, 4, size=3))
    return spec, wr.getvalue()
