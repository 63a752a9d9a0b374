"""Multi-device scale-out on ``torch.distributed`` (``redsec_tpu_torch.parallel``)
against the JAX package's single-device outputs: spawned gloo groups of 2 and
4 CPU ranks run the data-parallel and tensor-parallel forwards, the
fan-in-sharded FC + sign layer (with a simulated two-host dcn axis), the
polynomial-sharded four-step NTT and bootstrap, and int32 all-reduces whose
partial sums overflow.  Mirrors tests/test_parallel.py and
tests/test_ntt_shard.py, which run the same paths on 8 virtual JAX devices.

One group a world size runs every job (tests/torch_dist_jobs.py), each rank
joining through a file store under the test's temporary directory, with a
60 s timeout on every collective and a time limit on every join.  The keys
are ``test_noiseless`` with n cut to 16 (a noiseless set: every PBS decodes
exactly), made from seeds on both sides.  Tolerance: exact equality of every
int32 output."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redsec_tpu.crypto import bootstrap as jbs
from redsec_tpu.crypto import keygen as jkg
from redsec_tpu.crypto import ntt as jntt
from redsec_tpu.crypto import ntt_matmul as jmm
from redsec_tpu.crypto import params as jparams
from redsec_tpu.crypto.torus import mod_switch_to_torus32 as jms
from redsec_tpu.models.spec import prep_model as jprep
from redsec_tpu.ops.encrypted import ternary_matmul_ct as jternary
from redsec_tpu.parallel import ntt_shard as jns
from redsec_tpu.runtime import encrypted as jenc
from redsec_tpu.runtime import ranges as jranges
from redsec_tpu_torch.crypto import bootstrap as bs
from redsec_tpu_torch.crypto import keygen as kg
from redsec_tpu_torch.crypto import lwe
from redsec_tpu_torch.crypto import ntt
from redsec_tpu_torch.crypto.params import TEST_NOISELESS, get_params
from redsec_tpu_torch.formats.varprep import VarPrepWriter
from redsec_tpu_torch.models.dims import Dimensions
from redsec_tpu_torch.models.spec import (
    Activation, BiasKind, ConvKind, ConvParams, Domain, LayerSpec, ModelSpec, PoolKind,
    prep_model,
)
from redsec_tpu_torch.parallel import mesh as pm
from redsec_tpu_torch.parallel import ntt_shard as ns
from redsec_tpu_torch.runtime import ranges as rr
from redsec_tpu_torch.runtime.encrypted import encrypt_images
import torch_dist_jobs
from test_torch_slice import jax_spec, mini_sign_model

torch.set_num_threads(2)

P = dataclasses.replace(TEST_NOISELESS, n=16)
JP = dataclasses.replace(jparams.TEST_NOISELESS, n=16)
WORLDS = (2, 4)
# (N, sp) of the sharded transform at each world size (sp ranks a tp row)
NTT_CASES = {2: [(256, 2), (2048, 2)], 4: [(1024, 4)]}


def _keys(seed, bundle=1):
    sk, cloud = kg.keygen(P, seed=seed, bundle=bundle)
    _, jcloud = jkg.keygen(JP, seed=seed, bundle=bundle)
    return sk, cloud, jcloud


def tp_relu_model(rng):
    """tests/test_parallel.py's relu net in the port's spec classes: FC8
    relu -> FC4 relu -> FC3 on 1x1x16 inputs."""
    spec = ModelSpec(
        "test/tp_relu",
        Dimensions(h=1, w=1, in_dep=16, in_bits=3, up_bound=4, scale=1.0),
        [LayerSpec(Domain.INT, ConvKind.FC, 8, PoolKind.NONE, Activation.RELU, BiasKind.BNORM,
                   conv_params=ConvParams(tern_thresh=0.1), shift_bits=3),
         LayerSpec(Domain.INT, ConvKind.FC, 4, PoolKind.NONE, Activation.RELU, BiasKind.BNORM,
                   conv_params=ConvParams(tern_thresh=0.1), shift_bits=3),
         LayerSpec(Domain.INT, ConvKind.FC, 3, PoolKind.NONE, Activation.NONE,
                   BiasKind.NONE)])
    wr = VarPrepWriter()
    wr.write_tern(rng.choice([-1, 0, 1], size=16 * 8))
    wr.write_i32(rng.integers(-64, 64, size=8))
    wr.write_i32(np.full(8, 16), signed=False)
    wr.write_tern(rng.choice([-1, 0, 1], size=8 * 4))
    wr.write_i32(rng.integers(-64, 64, size=4))
    wr.write_i32(np.full(4, 16), signed=False)
    wr.write_tern(rng.choice([-1, 0, 1], size=4 * 3))
    wr.write_i32(rng.integers(-4, 5, size=3))
    return spec, wr.getvalue()


@pytest.fixture(scope="module")
def case():
    """The inputs of every job, and the JAX package's single-device outputs
    for them."""
    c = {}
    sk, c["cloud"], jcloud = _keys(31)
    jdkey = jbs.prepare_cloud_key(jcloud)
    rng = np.random.default_rng(0)

    # the mini sign net (sumpool, 3x3 conv, fc, final fc) on 4 images
    spec, blob = mini_sign_model(np.random.default_rng(0))
    c["sign_plan"] = prep_model(spec, blob)
    x = rng.integers(-15, 16, size=(4, 8, 8, 1)).astype(np.int32)
    c["sign_ct"] = encrypt_images(sk, x, P, rng)
    jsign = jprep(jax_spec(spec), blob)
    c["sign_want"] = np.asarray(jenc.build_encrypted_forward(jsign, jdkey)(
        jnp.asarray(c["sign_ct"])))

    # a bundled key (bundle=2) through the same net
    bsk, c["bundled_cloud"], bjcloud = _keys(33, bundle=2)
    c["bundled_ct"] = encrypt_images(bsk, x, P, rng)
    c["bundled_want"] = np.asarray(jenc.build_encrypted_forward(
        jsign, jbs.prepare_cloud_key(bjcloud))(jnp.asarray(c["bundled_ct"])))

    # quarter and full-range (FDFB) relu: layer 1 left uncalibrated
    rspec, rblob = tp_relu_model(np.random.default_rng(6))
    rplan, jrplan = prep_model(rspec, rblob), jprep(jax_spec(rspec), rblob)
    xr = np.random.default_rng(6).integers(-1, 2, size=(4, 1, 1, 16)).astype(np.int32)
    rr.calibrate_ranges(rplan, xr, device="cpu")
    jranges.calibrate_ranges(jrplan, xr)
    rplan.layers[1].measured_pre_bound = jrplan.layers[1].measured_pre_bound = None
    c["relu_plan"] = rplan
    c["relu_ct"] = encrypt_images(sk, xr, P, rng)
    c["relu_want"] = np.asarray(jenc.build_encrypted_forward(jrplan, jdkey)(
        jnp.asarray(c["relu_ct"])))

    # FC + sign over a fan-in of 32 +-1 inputs, 16 outputs, batch 8
    B, K, O = 8, 32, 16
    c["fc_w"] = rng.choice([-1, 0, 1], size=(K, O)).astype(np.int8)
    c["fc_b"] = rng.integers(-3, 4, size=O).astype(np.int32)
    c["fc_ct"] = lwe.encrypt_integers(sk.lwe_key, rng.choice([-1, 1], size=(B, K)), P, rng)
    full = np.array(jternary(jnp.asarray(c["fc_ct"])[:, None], jnp.asarray(c["fc_w"]))[:, 0])
    full[..., -1] = (full[..., -1] + jms(c["fc_b"], JP.msg_space)).astype(np.int32)
    want = jbs.make_batched_bootstrap(jdkey)(jnp.asarray(full.reshape(-1, full.shape[-1])),
                                             jnp.asarray(jbs.const_test_vector(JP, 1,
                                                                               JP.msg_space)))
    c["fc_want"] = np.asarray(want).reshape(B, O, -1)

    # the "matmul" key and 16 ciphertexts for the poly-sharded bootstrap
    msk, c["mm_cloud"], mjcloud = _keys(13)
    c["mm_vals"] = rng.integers(-400, 400, size=16)
    c["mm_ct"] = lwe.encrypt_integers(msk.lwe_key, c["mm_vals"], P, rng)
    c["mm_tv"] = bs.const_test_vector(P, 1, P.msg_space)
    c["mm_sk"] = msk
    os.environ["REDSEC_NTT"] = "matmul"  # the JAX package's four-step flavour
    try:
        mjdkey = jbs.prepare_cloud_key(mjcloud)
        assert mjdkey.ntt_flavor == "matmul"
        c["mm_want"] = np.asarray(jbs.make_batched_bootstrap(mjdkey)(
            jnp.asarray(c["mm_ct"]), jnp.asarray(c["mm_tv"])))
    finally:
        os.environ.pop("REDSEC_NTT")
    c["mm_jdkey"] = mjdkey

    # transform inputs, each prime of each N
    c["ntt_x"] = {}
    for N in {N for cases in NTT_CASES.values() for N, _ in cases}:
        plan = ntt.make_plan(N, max_operand=4, limb_bits=8, accum=10)
        c["ntt_x"][N] = {pi: rng.integers(0, p, size=(6, N)).astype(np.int32)
                         for pi, p in enumerate(plan.primes)}

    # partial sums whose int32 totals overflow both ways
    c["partials"] = {w: np.stack([np.array([2**31 - 1 - r, -2**31 + r, 2**30 + r, -7 * r],
                                           np.int32) for r in range(w)]) for w in WORLDS}
    return c


def _jobs(c, world):
    tp = 2
    jobs = [
        {"name": "dp", "kind": "dp_forward", "plan": c["sign_plan"], "cloud": c["cloud"],
         "ct": c["sign_ct"], "tp": 1 if world == 2 else 2},
        {"name": "dp_bundled", "kind": "dp_forward", "plan": c["sign_plan"],
         "cloud": c["bundled_cloud"], "ct": c["bundled_ct"], "tp": 1},
        {"name": "tp_sign", "kind": "tp_forward", "plan": c["sign_plan"], "cloud": c["cloud"],
         "ct": c["sign_ct"], "tp": tp},
        {"name": "tp_relu", "kind": "tp_forward", "plan": c["relu_plan"], "cloud": c["cloud"],
         "ct": c["relu_ct"], "tp": tp},
        {"name": "fc", "kind": "fc_sign_tp", "cloud": c["cloud"], "ct": c["fc_ct"],
         "weights": c["fc_w"], "bias": c["fc_b"], "tp": tp, "dcn": world // tp},
        {"name": "poly", "kind": "poly_pbs", "cloud": c["mm_cloud"], "ct": c["mm_ct"],
         "tv": c["mm_tv"], "tp": 2},
        {"name": "all_reduce", "kind": "all_reduce", "partials": c["partials"][world],
         "tp": tp},
    ]
    for N, sp in NTT_CASES[world]:
        jobs.append({"name": f"ntt{N}_{sp}", "kind": "ntt_shard", "N": N, "tp": sp,
                     "x": c["ntt_x"][N], "primes": sorted(c["ntt_x"][N])})
    return jobs


@pytest.fixture(scope="module")
def groups(case, tmp_path_factory):
    """Both world sizes' groups, run side by side; {world: [rank results]}."""
    started = {}
    for world in WORLDS:
        work = str(tmp_path_factory.mktemp(f"gloo{world}"))
        started[world] = (torch_dist_jobs.start_group(world, _jobs(case, world), work), work)
    return {w: torch_dist_jobs.finish_group(procs, work) for w, (procs, work) in started.items()}


def _every_rank(groups, world, key):
    """``key`` from every rank of the group, asserted equal across ranks."""
    vals = [r[key] for r in groups[world]]
    for v in vals[1:]:
        np.testing.assert_array_equal(v, vals[0])
    return vals[0]


@pytest.mark.parametrize("world", WORLDS)
def test_dp_forward_matches_single_device(groups, case, world):
    np.testing.assert_array_equal(_every_rank(groups, world, "dp/out"), case["sign_want"])


@pytest.mark.parametrize("world", WORLDS)
def test_dp_forward_bundled_key_matches_single_device(groups, case, world):
    np.testing.assert_array_equal(_every_rank(groups, world, "dp_bundled/out"),
                                  case["bundled_want"])


@pytest.mark.parametrize("world", WORLDS)
def test_tp_whole_model_matches_single_device(groups, case, world):
    """conv (4 ch) and fc (16 ch) layers shard over tp = 2; layer 0 (sumpool
    and sign on 1 channel) is replicated; with world 4, dp = 2 beside it."""
    np.testing.assert_array_equal(_every_rank(groups, world, "tp_sign/out"), case["sign_want"])
    layout = _every_rank(groups, world, "tp_sign/layout")
    assert [tuple(row) for row in layout] == [(False, False), (False, True), (True, True),
                                              (True, False)]


@pytest.mark.parametrize("world", WORLDS)
def test_tp_whole_model_relu_fdfb_matches_single_device(groups, case, world):
    """Quarter-range relu on layer 0 and FDFB on layer 1 (left uncalibrated),
    with per-channel test vectors sharded over tp."""
    info = rr.resolve_pbs_ranges(case["relu_plan"], P.msg_space,
                                 sigma_units=P.mod_switch_sigma_units())
    assert (info[0].relu_mode, info[1].relu_mode) == ("quarter", "full")
    np.testing.assert_array_equal(_every_rank(groups, world, "tp_relu/out"), case["relu_want"])


def test_tp_fc_sign_matches_single_device(groups, case):
    np.testing.assert_array_equal(_every_rank(groups, 2, "fc/out"), case["fc_want"])


def test_dcn_axis_simulated_two_hosts(groups, case):
    """World 4 as two simulated hosts (dcn = 2, dp = 1, tp = 2): the batch
    rides dcn, the fan-in all-reduce stays inside each host's tp pair."""
    np.testing.assert_array_equal(_every_rank(groups, 4, "fc/out"), case["fc_want"])


@pytest.mark.parametrize("world", WORLDS)
def test_int32_all_reduce_wraps_mod_2_32(groups, case, world):
    """gloo's int32 SUM wraps as the JAX package's int32 ``psum`` does: the
    partials overflow int32 both ways, over the world and over tp rows."""
    parts = case["partials"][world].astype(np.int64)

    def wrap(v):
        return ((v + 2**31) % 2**32 - 2**31).astype(np.int32)

    assert (np.abs(parts.sum(0)) >= 2**31).any()
    np.testing.assert_array_equal(_every_rank(groups, world, "all_reduce/world"),
                                  wrap(parts.sum(0)))
    for r, res in enumerate(groups[world]):
        row = r // 2
        np.testing.assert_array_equal(res["all_reduce/tp"], wrap(parts[2 * row:2 * row + 2].sum(0)))


@pytest.mark.parametrize("world,N,sp", [(w, N, sp) for w in WORLDS for N, sp in NTT_CASES[w]])
def test_sharded_ntt_matches_single_device(groups, case, world, N, sp):
    assert ns.poly_shard_viable(N, sp) and jns.poly_shard_viable(N, sp)
    jplan = jntt.make_plan(N, max_operand=4, limb_bits=8, accum=10)
    for pi, x in case["ntt_x"][N].items():
        want = np.asarray(jmm.ntt_device_mm(jnp.asarray(x), jplan, pi))
        np.testing.assert_array_equal(_every_rank(groups, world, f"ntt{N}_{sp}/fwd{pi}"), want)
        np.testing.assert_array_equal(_every_rank(groups, world, f"ntt{N}_{sp}/inv{pi}"), x)


@pytest.mark.parametrize("world", WORLDS)
def test_poly_sharded_bootstrap_bit_exact(groups, case, world):
    """sp = 2 (N = 256: R = 2); with world 4 the batch splits over dp = 2
    beside it.  Equal to the JAX package's single-device "matmul" PBS and to
    the port's; the decrypted signs are the inputs'."""
    got = _every_rank(groups, world, "poly/out")
    np.testing.assert_array_equal(got, case["mm_want"])
    dkey = bs.prepare_cloud_key(case["mm_cloud"], device="cpu", ntt_flavor="matmul")
    single = bs.make_batched_bootstrap(dkey)(torch.as_tensor(case["mm_ct"]), case["mm_tv"])
    np.testing.assert_array_equal(got, single.numpy())
    dec = lwe.decrypt_integers(case["mm_sk"].lwe_key, got, P)
    np.testing.assert_array_equal(np.sign(dec), np.sign(case["mm_vals"]))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_key_footprint(groups, case, world):
    """Each rank holds 1/sp of the BK's frequency axis and of the KSK's limbs
    (the k-steps of its block of coefficients), the BK in the same block
    shapes as the JAX package's addressable shards."""
    bk_full = tuple(_every_rank(groups, world, "poly/bk_full"))
    ksk_full = tuple(_every_rank(groups, world, "poly/ksk_full"))
    assert tuple(_every_rank(groups, world, "poly/bk_shard")) == \
        bk_full[:-2] + (bk_full[-2] // 2, bk_full[-1])
    assert tuple(_every_rank(groups, world, "poly/ksk_shard")) == \
        (ksk_full[0], ksk_full[1] // 2, ksk_full[2])
    jbk = case["mm_jdkey"].bk_ntt[0]
    assert int(np.prod(bk_full[1:])) == int(np.prod(jbk.shape))


def test_radix2_key_rejected(case):
    """A radix-2 key (bit-reversed frequency order) is refused before any
    collective, as is a bundled "matmul" one."""
    mesh = pm.Mesh(dcn=1, dp=1, tp=2, rank=0, tp_group=None, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="matmul"):
        ns.shard_cloud_key_poly(bs.prepare_cloud_key(case["mm_cloud"], device="cpu"), mesh)
    with pytest.raises(ValueError, match="bundle"):
        ns.shard_cloud_key_poly(bs.prepare_cloud_key(case["bundled_cloud"], device="cpu",
                                                     ntt_flavor="matmul"), mesh)
    assert not ns.poly_shard_viable(256, 4) and not jns.poly_shard_viable(256, 4)


def test_exchange_bytes_per_round_equal_jax():
    for name in ("small_v2", "small_v2_tpu", "small", "small_v2_n2048"):
        p, jp = get_params(name), jparams.get_params(name)
        plan = bs.bootstrap_plan(p)
        jplan = jntt.make_plan(jp.N, max_operand=jp.half_bg, limb_bits=8,
                               accum=jp.decomp_rows, balanced=True)
        for sp in (2, 4, 8):
            assert ns.exchange_bytes_per_round(p, plan, sp) == \
                jns.exchange_bytes_per_round(jp, jplan, sp)
    ex = ns.exchange_bytes_per_round(get_params("small_v2"), bs.bootstrap_plan(
        get_params("small_v2")), sp=4)
    assert 150_000 < ex["total"] < 300_000, ex


def test_the_backend_follows_the_device():
    with pytest.raises(ValueError, match="gloo"):
        pm.init_distributed("file:///nonexistent", 1, 0, device="cpu", backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pm.init_distributed("file:///nonexistent", 1, 0)
