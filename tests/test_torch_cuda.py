"""The CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: without a card every test here skips.  The tests import
nothing of JAX, so they run on a machine without it (``--noconftest``
skips ``tests/conftest.py``, which pins JAX to the CPU):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: exact equality (integer arithmetic mod p and mod 2^32).
"""

import contextlib
import ctypes
import dataclasses
import os

import numpy as np
import pytest
import torch

from redsec_tpu_torch.crypto import bootstrap as bs
from redsec_tpu_torch.crypto import kernels as K
from redsec_tpu_torch.crypto import keygen as kg
from redsec_tpu_torch.crypto import lwe
from redsec_tpu_torch.crypto import probe_kernels as PK
from redsec_tpu_torch.crypto.params import TEST_NOISELESS as P

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def key():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    sk, cloud = kg.keygen(P, seed=0)
    return sk, cloud, bs.prepare_cloud_key(cloud, device="cuda")


def _ri(rng, lo, hi, shape):
    return torch.as_tensor(rng.integers(lo, hi, size=shape).astype(np.int32), device="cuda")


@pytest.mark.parametrize("rows", [1, 37, 64])  # a block takes 8 rows: ragged and full grids
def test_ntt_kernel_equals_twin(key, rows):
    plan = key[2].plan
    rng = np.random.default_rng(0)
    for pi, p in enumerate(plan.primes):
        x = _ri(rng, 0, p, (rows, P.N))
        for inv in (False, True):
            assert torch.equal(K.ntt(x, plan, pi, inv), K.ntt_plain(x, plan, pi, inv))


def test_round_kernels_equal_twins(key):
    dkey = key[2]
    rng = np.random.default_rng(1)
    bk = dkey.bk[:, 3].contiguous()
    digits = _ri(rng, -P.half_bg, P.half_bg, (5, P.decomp_rows, P.N))
    assert torch.equal(K.external_product(digits, bk, dkey.plan),
                       K.external_product_plain(digits, bk, dkey.plan))
    acc = _ri(rng, -2**31, 2**31, (5, 2, P.N))
    t = _ri(rng, 0, 2 * P.N, (5,))
    assert torch.equal(K.cmux_round(acc, t, bk, P, dkey.plan),
                       K.cmux_round_plain(acc, t, bk, P, dkey.plan))


def test_pbs_kernel_path_equals_plain_path_and_host(key):
    sk, cloud, dkey = key
    rng = np.random.default_rng(2)
    vals = rng.integers(-300, 300, size=7)
    ct = lwe.encrypt_integers(sk.lwe_key, vals, P, rng)
    tv = bs.const_test_vector(P, 1, P.msg_space)
    before = K.launches.get("blind_rotate")
    got = bs.make_batched_bootstrap(dkey)(ct, tv)
    assert K.launches.get("blind_rotate") == before + 1
    with pytest.MonkeyPatch.context() as mp:  # the same PBS through the plain twin
        mp.setattr(K, "blind_rotate", K.blind_rotate_plain)
        plain = bs.make_batched_bootstrap(dkey)(ct, tv)
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got[0].cpu().numpy(), bs.bootstrap_host(cloud, ct[0], tv))
    np.testing.assert_array_equal(lwe.decrypt_integers(sk.lwe_key, got.cpu().numpy(), P),
                                  np.where(vals >= 0, 1, -1))


@pytest.fixture(scope="module")
def key_1024():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from redsec_tpu_torch.crypto.params import SMALL_V2_TPU

    _, cloud = kg.keygen(SMALL_V2_TPU, seed=0)
    return SMALL_V2_TPU, bs.prepare_cloud_key(cloud, device="cuda")


def _blind_rotate_equals_twin(params, dkey, batch):
    rng = np.random.default_rng(batch)
    acc0 = _ri(rng, -2**31, 2**31, (batch, 2, params.N))
    abar = _ri(rng, 0, 2 * params.N, (batch, params.n))
    before = K.launches.get("blind_rotate")
    got = K.blind_rotate(acc0, abar, dkey.bk, params, dkey.plan)
    assert K.launches.get("blind_rotate") == before + 1
    assert torch.equal(got, K.blind_rotate_plain(acc0, abar, dkey.bk, params, dkey.plan))
    _config_equals_mirror(batch, params, dkey.plan, K.key_bundle(dkey.bk, params))


def _config_equals_mirror(batch, params, plan, bundle):
    """The layout the built library chooses is the Python mirror's."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cfg = K.blind_rotate_config(batch, params, plan, bundle)
    want = K.k4_layout(batch, params, plan, bundle, sms)
    assert {k: cfg[k] for k in want} == want
    return cfg


# one ciphertext a block up to the card's SM count, two beyond it; an odd
# batch beyond it ends on a block with one ciphertext missing
@pytest.mark.parametrize("batch", [1, 5, 132, 133, 267])
def test_blind_rotate_kernel_equals_twin_at_small_and_ragged_batches_n256(key, batch):
    _blind_rotate_equals_twin(P, key[2], batch)


@pytest.mark.parametrize("batch", [1, 3, 133])
def test_blind_rotate_kernel_equals_twin_at_small_and_ragged_batches_n1024(key_1024, batch):
    _blind_rotate_equals_twin(*key_1024, batch)


@pytest.fixture(scope="module")
def key_small_v2():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from redsec_tpu_torch.crypto.params import SMALL_V2

    _, cloud = kg.keygen(SMALL_V2, seed=0)
    return SMALL_V2, bs.prepare_cloud_key(cloud, device="cuda")


# the CLI's default set: 20 digit rows, so two ciphertexts fit a block's
# shared memory only with the rows in chunks (12 + 8) and the MAC reduces
# inside its row loop; one ciphertext a block up to the SM count
@pytest.mark.parametrize("batch", [1, 5, 133, 512])
def test_blind_rotate_kernel_equals_twin_at_small_v2(key_small_v2, batch):
    params, dkey = key_small_v2
    assert params.decomp_rows == 20
    cfg = K.blind_rotate_config(batch, params)
    assert cfg["shared_bytes_g2"] > 232448
    _blind_rotate_equals_twin(params, dkey, batch)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert (cfg["group"], cfg["chunk_rows"]) == ((2, 12) if batch > sms else (1, 20))


NEW_SETS = [("small_v2_n2048", 1), ("small", 1), ("test_noiseless", 2), ("small_v2_tpu", 2),
            ("small_v2_tpu2", 2), ("small_v2_n2048", 2)]


@pytest.fixture(scope="module", params=NEW_SETS, ids=[f"{n}-bundle{b}" for n, b in NEW_SETS])
def new_key(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from redsec_tpu_torch.crypto.params import get_params

    name, bundle = request.param
    params = get_params(name)
    _, cloud = kg.keygen(params, seed=0, bundle=bundle)
    return params, bundle, bs.prepare_cloud_key(cloud, device="cuda")


# the K4 instances of N = 2048, three primes and bundled rounds at their
# layouts (kernels.k4_layout); 133 and 512 are above the SM count, 133 and 5
# end on a ragged block
@pytest.mark.parametrize("batch", [1, 3, 5, 133, 512])
def test_blind_rotate_kernel_equals_twin_at_the_new_instances(new_key, batch):
    params, bundle, dkey = new_key
    assert dkey.bundle == bundle and K.key_bundle(dkey.bk, params) == bundle
    rng = np.random.default_rng(batch)
    acc0 = _ri(rng, -2**31, 2**31, (batch, 2, params.N))
    abar = _ri(rng, 0, 2 * params.N, (batch, params.n))
    before = K.launches.get("blind_rotate")
    got = K.blind_rotate(acc0, abar, dkey.bk, params, dkey.plan)
    assert K.launches.get("blind_rotate") == before + 1
    # the twin on the first and the last ciphertexts (the last block's may be
    # alone in it): every ciphertext runs the same code
    idx = torch.tensor(sorted({0, 1, 2, batch - 2, batch - 1} & set(range(batch))),
                       device=acc0.device)
    assert torch.equal(got[idx], K.blind_rotate_plain(acc0[idx], abar[idx], dkey.bk, params,
                                                      dkey.plan))
    cfg = _config_equals_mirror(batch, params, dkey.plan, bundle)
    assert cfg["shared_bytes"] <= 232448 and 1 <= cfg["chunk_rows"]


# K4 at N = 2048 with n cut to an odd and an even number of rounds, plain
# and bundled: the launch's one staging of the stage tables, each half's
# refill with the next prime's (and the next round's first) while the block
# runs on, and a chunk's first key row started before the barrier that ends
# its forward transforms; every ciphertext against the twin
CUT_N2048 = [(1, 3), (1, 4), (2, 6), (2, 4)]  # (bundle, n): 3, 4, 3 and 2 rounds


@pytest.mark.parametrize("bundle,n", CUT_N2048, ids=[f"bundle{b}-n{n}" for b, n in CUT_N2048])
@pytest.mark.parametrize("batch", [1, 133])
def test_blind_rotate_kernel_at_n2048_equals_twin_at_cut_rounds(bundle, n, batch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import dataclasses

    from redsec_tpu_torch.crypto.params import get_params

    params = dataclasses.replace(get_params("small_v2_n2048"), n=n)
    _, cloud = kg.keygen(params, seed=0, bundle=bundle)
    dkey = bs.prepare_cloud_key(cloud, device="cuda")
    assert K.key_bundle(dkey.bk, params) == bundle
    rng = np.random.default_rng(10 * n + batch)
    acc0 = _ri(rng, -2**31, 2**31, (batch, 2, params.N))
    abar = _ri(rng, 0, 2 * params.N, (batch, n))
    got = K.blind_rotate(acc0, abar, dkey.bk, params, dkey.plan)
    assert torch.equal(got, K.blind_rotate_plain(acc0, abar, dkey.bk, params, dkey.plan))
    cfg = _config_equals_mirror(batch, params, dkey.plan, bundle)
    assert (cfg["group"], cfg["chunk_rows"]) == (1, 12 if bundle == 1 else 8)


@pytest.mark.parametrize("name", ["small_v2_n2048", "small"])
def test_ntt_kernel_equals_twin_at_the_new_plans(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from redsec_tpu_torch.crypto.params import get_params

    params = get_params(name)
    plan = bs.bootstrap_plan(params)
    rng = np.random.default_rng(3)
    for rows in (1, 37):
        for pi, p in enumerate(plan.primes):
            x = _ri(rng, 0, p, (rows, params.N))
            x[0, :7] = p - 1
            for inv in (False, True):
                assert torch.equal(K.ntt(x, plan, pi, inv), K.ntt_plain(x, plan, pi, inv))


def test_three_primes_and_bundles_at_n256_and_n512():
    """Instances no shipped set reaches: three primes at N = 256 (Bg = 2^10,
    bundled) and N = 512, two ciphertexts a block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import dataclasses

    for kw, bundle in (({"bg_bit": 10, "l": 3}, 2), ({"N": 512}, 1), ({"N": 512}, 2)):
        params = dataclasses.replace(P, n=16, **kw)
        _, cloud = kg.keygen(params, seed=1, bundle=bundle)
        dkey = bs.prepare_cloud_key(cloud, device="cuda")
        _blind_rotate_equals_twin(params, dkey, 135)


# Every K4 instance at N <= 1024 (N, primes, bundle), n cut to 4 rounds:
# (base set, gadget) giving those primes at that N
SMALL_N = {(2, 1): ("small_v2_tpu", {}), (2, 2): ("small_v2_tpu", {}),
           (3, 1): ("small", {}), (3, 2): ("small", {})}
SMALL_N_INSTANCES = [(N, P_, b) for N in (256, 512, 1024) for P_ in (2, 3) for b in (1, 2)]


@pytest.fixture(scope="module")
def small_n_keys():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return {}


@pytest.mark.parametrize("N,primes,bundle", SMALL_N_INSTANCES,
                         ids=[f"N{N}-P{p}-bundle{b}" for N, p, b in SMALL_N_INSTANCES])
@pytest.mark.parametrize("batch", [1, 5, 133, 512])
def test_every_small_n_instance_equals_twin(small_n_keys, N, primes, bundle, batch):
    """One and two ciphertexts a block, a ragged last block (5, 133), every
    layout (tables resident or refilled, the last prime's sums on the
    differences), the key ring's 16-byte runs and early rows, at each N."""
    import dataclasses

    from redsec_tpu_torch.crypto.params import get_params

    if (N, primes, bundle) not in small_n_keys:
        name, kw = SMALL_N[(primes, bundle)]
        if (N, primes, bundle) == (256, 3, 1):
            kw = {"bg_bit": 11, "l": 2}  # three primes at N = 256 need Bg * rows this large
        params = dataclasses.replace(get_params(name), N=N, n=4, **kw)
        _, cloud = kg.keygen(params, seed=0, bundle=bundle)
        small_n_keys[(N, primes, bundle)] = (params, bs.prepare_cloud_key(cloud, device="cuda"))
    params, dkey = small_n_keys[(N, primes, bundle)]
    assert len(dkey.plan.primes) == primes and K.key_bundle(dkey.bk, params) == bundle
    _blind_rotate_equals_twin(params, dkey, batch)


def test_wrappers_reject_what_the_kernels_do_not_take(key):
    dkey = key[2]
    bk = dkey.bk[:, 0]  # a strided view: the kernel reads contiguous slices
    digits = torch.zeros((2, P.decomp_rows, P.N), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        K.external_product(digits, bk, dkey.plan)
    with pytest.raises(ValueError, match="dtype"):
        K.ntt(digits[0].to(torch.int64), dkey.plan, 0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.mark.parametrize("N", [256, 1024])
def test_rotation_kernels_equal_twin(card, N):
    rng = np.random.default_rng(3)
    B = 128
    x = _ri(rng, -2**31, 2**31, (B, 2, N))
    x[:, 0, 0] = -2**31  # negates to itself
    t = _ri(rng, 0, 2 * N, (B,))
    t[:6] = torch.tensor([0, 1, N - 1, N, N + 1, 2 * N - 1], dtype=torch.int32)
    want = PK.rotate_plain(x, t)
    before = {k: K.launches.get(k) for k in ("rotate_rows", "rotate_tile")}
    assert torch.equal(PK.rotate_rows(x, t), want)
    for tile in (1, 64, 128):
        assert torch.equal(PK.rotate_tile(x, t, tile), want)
    assert K.launches.get("rotate_rows") == before["rotate_rows"] + 1
    assert K.launches.get("rotate_tile") == before["rotate_tile"] + 3
    # any int32 exponent acts as t mod 2N, as in the twin
    far = t - 6 * N
    assert torch.equal(PK.rotate_rows(x, far), want)
    assert torch.equal(PK.rotate_tile(x, far, 64), want)


@pytest.mark.parametrize("tile", [64, 256, 512])  # 8, 2 and 1 tiles, the last the whole batch
def test_rotate_tile_kernel_equals_twin_at_the_bench_shape(card, tile):
    rng = np.random.default_rng(5)
    x = _ri(rng, -2**31, 2**31, (512, 2, 1024))
    t = _ri(rng, -4096, 4096, (512,))
    assert torch.equal(PK.rotate_tile(x, t, tile), PK.rotate_plain(x, t))


def test_toeplitz_kernel_equals_twin(card):
    w = _ri(np.random.default_rng(4), -2**31, 2**31, (1, 256))
    before = K.launches.get("toeplitz_tile")
    assert torch.equal(PK.toeplitz_tile(w), PK.toeplitz_tile_plain(w))
    assert K.launches.get("toeplitz_tile") == before + 1


def test_probe_wrappers_reject_what_the_kernels_do_not_take(card):
    x = torch.zeros((128, 2, 256), dtype=torch.int32, device="cuda")
    t = torch.zeros((128,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="multiple of the tile"):
        PK.rotate_tile(x, t, tile=48)
    with pytest.raises(ValueError, match="dtype"):
        PK.rotate_rows(x.to(torch.int64), t)
    with pytest.raises(ValueError, match="dtype"):
        PK.rotate_tile(x, t.to(torch.int64), 64)
    with pytest.raises(ValueError, match="contiguous"):
        PK.rotate_rows(x.transpose(1, 2).contiguous().transpose(1, 2), t)
    with pytest.raises(ValueError, match="on cpu"):
        PK.rotate_rows(x, t.cpu())
    with pytest.raises(ValueError, match=r"\[B, 2, N\]"):
        PK.rotate_rows(x[:, :1].contiguous(), t)
    with pytest.raises(ValueError, match="shape"):
        PK.toeplitz_tile(torch.zeros((1, 128), dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        PK.toeplitz_tile(torch.zeros((1, 512), dtype=torch.int32, device="cuda")[:, ::2])


# the schoolbook kernel's shapes: the sets without NTT primes (medium, large
# and their v2 repairs: 6 or 8 digit rows) and the forced-schoolbook checks
SCHOOLBOOK_SHAPES = [(4096, 6), (4096, 8), (8192, 6), (8192, 8), (1024, 12), (1024, 20),
                     (256, 20)]
# Bg/2 of the sets with these rows: medium/large, the v2 sets, small_v2_tpu,
# small_v2 and test_noiseless
SCHOOLBOOK_HALF_BG = {6: 512, 8: 128, 12: 16, 20: 4}


@pytest.mark.parametrize("N,rows", SCHOOLBOOK_SHAPES)
# the tile edges: 8, 16 and 32 ciphertexts a block (4 pads to 8, 9 to 16),
# ragged grids, medium_v2's 196-chunk and a full 512
@pytest.mark.parametrize("batch", [1, 4, 8, 9, 17, 33, 70, 196, 512])
def test_schoolbook_kernel_equals_twin(card, N, rows, batch):
    rng = np.random.default_rng(N + rows + batch)
    half = SCHOOLBOOK_HALF_BG[rows]
    digits = _ri(rng, -half, half, (batch, rows, N))
    bk = _ri(rng, -2**31, 2**31, (rows, 2, N))
    bk[0, 0, :4] = -2**31
    before = K.launches.get("schoolbook_product")
    got = K.schoolbook_product(digits, bk, half)
    assert K.launches.get("schoolbook_product") == before + 1
    assert torch.equal(got, K.schoolbook_product_plain(digits, bk, half))


@pytest.mark.parametrize("half", [128, 512])
@pytest.mark.parametrize("dval", ["low", "high"])
@pytest.mark.parametrize("kval", [-2**31, -1, 0, 2**31 - 1])
def test_schoolbook_kernel_at_extreme_inputs(card, half, dval, kval):
    """Digits all -Bg/2 or all Bg/2 - 1 against keys all -2^31, -1 (every
    key byte 255), 0 or 2^31 - 1: the accumulators at their bound (large_v2's
    rows and N: 128 x 255 x 8 x 8192 = 2,139,095,040 in one flush)."""
    N, rows = 8192, (8 if half == 128 else 6)
    digits = torch.full((9, rows, N), -half if dval == "low" else half - 1, dtype=torch.int32,
                        device="cuda")
    bk = torch.full((rows, 2, N), kval, dtype=torch.int32, device="cuda")
    assert torch.equal(K.schoolbook_product(digits, bk, half),
                       K.schoolbook_product_plain(digits, bk, half))


@pytest.mark.parametrize("rows,half", [(8, 512), (16, 512), (16, 128)])
@pytest.mark.parametrize("inputs", ["random", "extreme"])
def test_schoolbook_kernel_flushes_mid_launch(card, rows, half, inputs):
    """More digit rows than one run between flushes (at N 8192, 7 rows at
    Bg/2 512 and 8 at 128: ``kernels.schoolbook_flush_rows``), so the kernel
    adds its int32 accumulators into the uint32 total and clears them
    mid-launch, and again at the last row.  Extreme: digits all -Bg/2 against
    keys all -1 (every key byte 255), each run's sums at their bound."""
    N = 8192
    assert rows > K.schoolbook_flush_rows(N, half)
    if inputs == "random":
        rng = np.random.default_rng(rows + half)
        digits = _ri(rng, -half, half, (9, rows, N))
        bk = _ri(rng, -2**31, 2**31, (rows, 2, N))
    else:
        digits = torch.full((9, rows, N), -half, dtype=torch.int32, device="cuda")
        bk = torch.full((rows, 2, N), -1, dtype=torch.int32, device="cuda")
    before = K.launches.get("schoolbook_product")
    got = K.schoolbook_product(digits, bk, half)
    assert K.launches.get("schoolbook_product") == before + 1
    assert torch.equal(got, K.schoolbook_product_plain(digits, bk, half))


def test_schoolbook_pbs_equals_the_ntt_pbs(key):
    sk, cloud, dkey = key
    rng = np.random.default_rng(3)
    ct = lwe.encrypt_integers(sk.lwe_key, rng.integers(-300, 300, size=9), P, rng)
    tv = bs.const_test_vector(P, 1, P.msg_space)
    sb = bs.prepare_cloud_key(cloud, device="cuda", schoolbook=True)
    before = K.launches.get("schoolbook_round")  # one round kernel launch a round
    got = bs.make_batched_bootstrap(sb)(ct, tv)
    assert K.launches.get("schoolbook_round") == before + P.n
    assert torch.equal(got, bs.make_batched_bootstrap(dkey)(ct, tv))


def test_schoolbook_wrapper_rejects_what_the_kernel_does_not_take(card):
    digits = torch.zeros((2, 6, 4096), dtype=torch.int32, device="cuda")
    bk = torch.zeros((6, 2, 4096), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="N in"):
        K.schoolbook_product(digits[..., :2000].contiguous(), bk[..., :2000].contiguous(), 512)
    with pytest.raises(ValueError, match="dtype"):
        K.schoolbook_product(digits.to(torch.int64), bk, 512)
    with pytest.raises(ValueError, match="shape"):
        K.schoolbook_product(digits, bk[:5].contiguous(), 512)
    with pytest.raises(ValueError, match="contiguous"):
        K.schoolbook_product(digits, bk.transpose(0, 1).contiguous().transpose(0, 1), 512)


@pytest.mark.parametrize("half", [0, 513, 1024])
def test_schoolbook_wrapper_rejects_bg_without_a_limb_plan(card, half):
    digits = torch.zeros((2, 6, 4096), dtype=torch.int32, device="cuda")
    bk = torch.zeros((6, 2, 4096), dtype=torch.int32, device="cuda")
    before = K.launches.get("schoolbook_product")
    with pytest.raises(ValueError, match="Bg/2"):
        K.schoolbook_product(digits, bk, half)
    assert K.launches.get("schoolbook_product") == before


# the schoolbook round kernel's sets: N 4096 and 8192 with 6 rows at Bg/2 512
# and 8 at 128 (medium, large and the v2 sets), N 1024 with 12 and 20 rows
# (forced small_v2_tpu and small_v2), both gadgets of the N >= 4096 sets at N
# 1024, and the other N the kernel takes: 256 (test_noiseless, 20 rows), 512
# and 2048
ROUND_SETS = ["medium", "medium_v2", "large", "large_v2", "small_v2_tpu", "small_v2",
              "medium@1024", "medium_v2@1024", "test_noiseless", "medium@512",
              "medium_v2@2048"]


def _round_params(name):
    from redsec_tpu_torch.crypto.params import get_params

    base, _, n = name.partition("@")
    p = get_params(base)
    return dataclasses.replace(p, N=int(n)) if n else p


def _round_inputs(rng, Pr, batch):
    acc = _ri(rng, -2**31, 2**31, (batch, 2, Pr.N))
    t = _ri(rng, 0, 2 * Pr.N, (batch,))
    bk = _ri(rng, -2**31, 2**31, (Pr.decomp_rows, 2, Pr.N))
    bk[0, 0, :4] = -2**31
    return acc, t, K.key_spectra(bk), bk


@pytest.mark.parametrize("name", ROUND_SETS)
@pytest.mark.parametrize("batch", [1, 4, 196, 512, 513])
def test_schoolbook_round_kernel_equals_twin(card, name, batch):
    """One launch against its twin (the same transforms in torch) and against
    S1 with the torch glue, and a second one in place (``out=acc``); at
    batch 4 the first two ciphertexts' digits all -Bg/2 (acc = offset / 2,
    rotated by N), the worst-case norm."""
    Pr = _round_params(name)
    rng = np.random.default_rng(batch + Pr.N + Pr.decomp_rows)
    acc, t, spectra, bk = _round_inputs(rng, Pr, batch)
    if batch == 4:
        fill = bs.gadget_offset(Pr) // 2
        acc[:2] = fill - 2**32 if fill >= 2**31 else fill
        t[:2] = Pr.N
    before = K.launches.get("schoolbook_round")
    got = K.schoolbook_round(acc, t, spectra, Pr)
    assert K.launches.get("schoolbook_round") == before + 1
    assert torch.equal(got, K.schoolbook_round_plain(acc, t, spectra, Pr))
    ops = bs.RoundOps(Pr)
    digits = ops.decompose(ops.rotate(acc, t) - acc)
    if batch == 4:
        assert int(digits[:2].max()) == int(digits[:2].min()) == -Pr.half_bg
    assert torch.equal(got, acc + K.schoolbook_product_plain(digits, bk, Pr.half_bg))
    assert K.schoolbook_round(acc, t, spectra, Pr, out=acc) is acc
    assert torch.equal(acc, got)


@pytest.mark.parametrize("name", ["medium_v2", "large", "small_v2_tpu"])
def test_schoolbook_round_kernel_in_place(card, name):
    """``out=acc``: at N 8192 the cluster pair of a ciphertext meets at a
    barrier after its last read of acc, so the in-place round is exact."""
    Pr = _round_params(name)
    acc, t, spectra, _ = _round_inputs(np.random.default_rng(2), Pr, 133)
    want = K.schoolbook_round_plain(acc, t, spectra, Pr)
    assert K.schoolbook_round(acc, t, spectra, Pr, out=acc) is acc
    assert torch.equal(acc, want)


def test_schoolbook_round_wrapper_rejects_what_the_kernel_does_not_take(card):
    Pr = _round_params("medium_v2")
    acc, t, spectra, _ = _round_inputs(np.random.default_rng(3), Pr, 4)
    before = K.launches.get("schoolbook_round")
    with pytest.raises(ValueError, match="spectra"):  # a key without spectra
        K.schoolbook_round(acc, t, None, Pr)
    flat = torch.zeros(acc.numel() + 1, dtype=torch.int32, device="cuda")
    unaligned = flat[1:].view(acc.shape)
    unaligned.copy_(acc)
    with pytest.raises(ValueError, match="16-byte"):
        K.schoolbook_round(unaligned, t, spectra, Pr)
    with pytest.raises(ValueError, match="16-byte"):
        K.schoolbook_round(acc, t, spectra, Pr, out=unaligned)
    with pytest.raises(ValueError, match="shape"):
        K.schoolbook_round(acc, t, spectra[:7].contiguous(), Pr)
    with pytest.raises(ValueError, match="dtype"):
        K.schoolbook_round(acc, t.long(), spectra, Pr)
    with pytest.raises(ValueError, match="contiguous"):
        K.schoolbook_round(acc.transpose(0, 1).contiguous().transpose(0, 1), t, spectra, Pr)
    with pytest.raises(ValueError, match="N in"):
        K.schoolbook_round(acc, t, spectra, dataclasses.replace(Pr, N=16384))
    assert K.launches.get("schoolbook_round") == before


@pytest.mark.parametrize("batch", [4, 513])
def test_schoolbook_rounds_equal_single_round_launches(card, batch):
    """``schoolbook_rounds`` at ``medium_v2`` over n = 16 rounds (one C loop
    of 16 launches) against 16 launches of ``schoolbook_round`` on two
    buffers: bit-identical, counted 16 times, ``acc`` left as it was."""
    Pr, n = _round_params("medium_v2"), 16
    rng = np.random.default_rng(batch + n)
    acc = _ri(rng, -2**31, 2**31, (batch, 2, Pr.N))
    ts = _ri(rng, 0, 2 * Pr.N, (n, batch))
    spectra = K.key_spectra(_ri(rng, -2**31, 2**31, (n, Pr.decomp_rows, 2, Pr.N)))
    want, spare = acc.clone(), torch.empty_like(acc)
    for i in range(n):
        want, spare = K.schoolbook_round(want, ts[i], spectra[i], Pr, out=spare), want
    kept = acc.clone()
    before = K.launches.get("schoolbook_round")
    got = K.schoolbook_rounds(acc, ts, spectra, Pr)
    assert K.launches.get("schoolbook_round") == before + n
    assert torch.equal(got, want)
    assert torch.equal(acc, kept)


def test_launches_go_to_the_current_stream(card):
    """K7, S1-fft and the rounds' loop launched on a side stream, and under
    ``torch.cuda.device``, run on that stream: their inputs are written on it
    after the stream has spun for a while (``torch.cuda._sleep``), so a
    launch placed on another stream would read them too early.  The launch
    reads the stream's raw handle with PyTorch's raw reader, building no
    ``torch.cuda.Stream``."""
    assert K._raw_stream is torch._C._cuda_getCurrentRawStream
    Pr = _round_params("medium_v2")
    rng = np.random.default_rng(21)
    w_src = _ri(rng, -2**31, 2**31, (1, 256))
    acc_src, t, spectra, _ = _round_inputs(rng, Pr, 4)
    ts = _ri(rng, 0, 2 * Pr.N, (3, 4))
    spec3 = K.key_spectra(_ri(rng, -2**31, 2**31, (3, Pr.decomp_rows, 2, Pr.N)))
    want7 = PK.toeplitz_tile_plain(w_src)
    want = K.schoolbook_round_plain(acc_src, t, spectra, Pr)
    want3 = acc_src
    for i in range(3):
        want3 = K.schoolbook_round_plain(want3, ts[i], spec3[i], Pr)
    side = torch.cuda.Stream()
    for ctx in (contextlib.nullcontext(), torch.cuda.device(0)):
        w, acc = torch.zeros_like(w_src), torch.zeros_like(acc_src)
        torch.cuda.synchronize()
        with ctx, torch.cuda.stream(side):
            torch.cuda._sleep(20_000_000)
            w.copy_(w_src)
            acc.copy_(acc_src)
            got7 = PK.toeplitz_tile(w)
            got = K.schoolbook_round(acc, t, spectra, Pr)
            got3 = K.schoolbook_rounds(acc, ts, spec3, Pr)
        side.synchronize()
        assert torch.equal(got7, want7)
        assert torch.equal(got, want)
        assert torch.equal(got3, want3)


def test_a_refused_launch_in_the_rounds_loop_names_its_round(card):
    """The rounds' C entry stops at the first launch that fails and the
    wrapper's error names its round; nothing is counted.  Round 0 here asks
    for 8 * 2^29 blocks, past a grid's reach, so it never starts."""
    Pr = _round_params("medium_v2")
    tw, twist = K.fft_tables(Pr.N, torch.device("cuda", 0))
    buf = torch.zeros((1, 2, Pr.N), dtype=torch.int32, device="cuda")
    ts = torch.zeros((3, 1), dtype=torch.int32, device="cuda")
    spec = K.key_spectra(torch.zeros((3, Pr.decomp_rows, 2, Pr.N), dtype=torch.int32,
                                     device="cuda"))
    failed = ctypes.c_int(-1)
    before = K.launches.get("schoolbook_round")
    with pytest.raises(RuntimeError, match="schoolbook_round failed at round 0"):
        K._sbf_lib().launch("redsec_schoolbook_rounds", "schoolbook_round", 0, buf.data_ptr(),
                            ts.data_ptr(), spec.data_ptr(), tw.data_ptr(), twist.data_ptr(),
                            buf.data_ptr(), buf.data_ptr(), 2**30, Pr.N, Pr.decomp_rows,
                            *K._gadget_args(Pr), 3, ctypes.addressof(failed), count=3,
                            failed=failed)
    assert failed.value == 0
    assert K.launches.get("schoolbook_round") == before
    torch.cuda.synchronize()  # nothing was left running


def test_device_ms_takes_no_time_from_a_partial_trace(card):
    """``device.device_ms`` sees every launch of a short trace (K7, 20
    calls), and raises rather than answer when a trace sees fewer launches
    than the calls make (here, told each call makes two), or answers None
    where the time is not required."""
    from redsec_tpu_torch.device import device_ms

    w = _ri(np.random.default_rng(7), -2**31, 2**31, (1, 2 * PK.TOEPLITZ_TILE))
    ms, busy, seen, _ = device_ms(lambda: PK.toeplitz_tile(w), "toeplitz_tile_kernel")
    assert seen == 20 and 0 < ms <= busy
    with pytest.raises(RuntimeError, match="saw 20 launches"):
        device_ms(lambda: PK.toeplitz_tile(w), "toeplitz_tile_kernel", per_call=2, tries=2)
    assert device_ms(lambda: PK.toeplitz_tile(w), "toeplitz_tile_kernel", per_call=2, tries=1,
                     required=False) == (None, None, 20, 0)


def test_schoolbook_pbs_without_spectra_raises(key):
    _, cloud, _ = key
    sb = bs.prepare_cloud_key(cloud, device="cuda", schoolbook=True)
    assert sb.spectra.device.type == "cuda"
    with pytest.raises(ValueError, match="spectra"):
        bs.make_batched_bootstrap(dataclasses.replace(sb, spectra=None))


@pytest.mark.parametrize("n", [32, 64])
# staged layouts: (K-direction stride between 16-byte core columns, stride
# between 8-row groups) in bytes
@pytest.mark.parametrize("kc,ng", [(128, 256), (1024, 128)])
def test_wgmma_layouts_hold_on_the_card(card, n, kc, ng):
    """The descriptor reading and register layouts S1's wgmma relies on
    (``csrc/wgmma_check.cu``: one wgmma m64nNk32 u8.s8 against a host
    product): LBO the K-direction stride between core columns and SBO the
    stride between 8-row groups; the other reading must not match."""
    lib = K.Library(os.path.join(os.path.dirname(K.SCHOOLBOOK_SOURCE), "wgmma_check.cu"),
                    ("redsec_wgmma_check",))
    rng = np.random.default_rng(n + kc)
    A = torch.as_tensor(rng.integers(0, 256, (64, 32)).astype(np.uint8), device="cuda")
    B = torch.as_tensor(rng.integers(-128, 128, (n, 32)).astype(np.int8), device="cuda")
    want = A.cpu().numpy().astype(np.int64) @ B.cpu().numpy().astype(np.int64).T
    matches = {}
    for reading, (lbo, sbo) in (("lbo_k", (kc, ng)), ("lbo_mn", (ng, kc))):
        got = torch.zeros((64, n), dtype=torch.int32, device="cuda")
        lib.launch("redsec_wgmma_check", "wgmma_check", 0, n,
                   A.data_ptr(), B.data_ptr(), got.data_ptr(), kc, ng, lbo, sbo)
        matches[reading] = bool(np.array_equal(got.cpu().numpy(), want))
    assert matches == {"lbo_k": True, "lbo_mn": False}


# --------------------------------------------------------------------------- #
# The four-step NTT and the "matmul" key flavour on the card (the key's       #
# preparation: fp32 limb matmuls with TF32 off, exact while every partial     #
# stays below 2^24; its PBS: the four-step kernel K4-mm)                      #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("N", [256, 1024, 2048])
def test_four_step_ntt_on_the_card_equals_the_cpu(card, N):
    from redsec_tpu_torch.crypto import ntt
    from redsec_tpu_torch.crypto import ntt_matmul as mm

    plan = ntt.make_plan(N, max_operand=4, limb_bits=8, accum=20)
    rng = np.random.default_rng(N)
    for pi, p in enumerate(plan.primes):
        x = rng.integers(0, p, size=(64, N)).astype(np.int32)
        x[0] = p - 1  # every limb product at its largest
        y = mm.ntt_device_mm(torch.as_tensor(x, device="cuda"), plan, pi)
        assert torch.equal(y.cpu(), mm.ntt_device_mm(torch.as_tensor(x), plan, pi))
        assert torch.equal(mm.intt_device_mm(y, plan, pi).cpu(), torch.as_tensor(x))


def test_matmul_key_pbs_on_the_card_equals_k4(key):
    sk, cloud, dkey = key
    mkey = bs.prepare_cloud_key(cloud, device="cuda", ntt_flavor="matmul")
    assert torch.equal(K.residues(mkey.bk).cpu().flatten(-2),
                       K.residues(bs.prepare_cloud_key(cloud, device="cpu",
                                                       ntt_flavor="matmul").bk).flatten(-2))
    rng = np.random.default_rng(7)
    ct = lwe.encrypt_integers(sk.lwe_key, rng.integers(-300, 300, size=9), P, rng)
    tv = bs.const_test_vector(P, 1, P.msg_space)
    before = K.launches.get("blind_rotate")
    before_mm = K.launches.get("blind_rotate_mm")
    got = bs.make_batched_bootstrap(mkey)(ct, tv)
    assert K.launches.get("blind_rotate") == before  # the 'matmul' path never reaches K4
    assert K.launches.get("blind_rotate_mm") == before_mm + 1  # but K4-mm
    assert torch.equal(got, bs.make_batched_bootstrap(dkey)(ct, tv))
    with pytest.raises(ValueError, match="radix-2"):
        K.blind_rotate(torch.zeros((1, 2, P.N), dtype=torch.int32, device="cuda"),
                       torch.zeros((1, P.n), dtype=torch.int32, device="cuda"), mkey.bk, P,
                       mkey.plan)


# --------------------------------------------------------------------------- #
# The four-step kernels K2-mm, K3-mm, K4-mm (csrc/blind_mm.cu)                #
# --------------------------------------------------------------------------- #

MM_SETS = ("test_noiseless", "small_v2_tpu", "small_v2", "small_v2_tpu2")


@pytest.fixture(scope="module")
def mm_keys():
    """A "matmul" key at each set the four-step kernels take (n cut to 16:
    the kernels take n at run time), and the radix-2 key of small_v2_tpu's
    raw key."""
    import dataclasses

    from redsec_tpu_torch.crypto.params import get_params

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    out = {}
    for name in MM_SETS:
        Pm = dataclasses.replace(get_params(name), n=16)
        _, cloud = kg.keygen(Pm, seed=3)
        out[name] = (Pm, bs.prepare_cloud_key(cloud, device="cuda", ntt_flavor="matmul"))
        if name == "small_v2_tpu":
            out["radix2"] = bs.prepare_cloud_key(cloud, device="cuda")
    return out


@pytest.mark.parametrize("name", MM_SETS)
@pytest.mark.parametrize("batch", [1, 5, 133, 512])
def test_blind_rotate_mm_equals_twin(mm_keys, name, batch):
    Pm, mk = mm_keys[name]
    lay = K.k4mm_layout(Pm, mk.plan)
    assert {k: lay[k] for k in K.mm_layout(Pm)} == K.mm_layout(Pm)  # the library's own rule
    rng = np.random.default_rng(batch)
    acc = _ri(rng, -2**31, 2**31, (batch, 2, Pm.N))
    abar = _ri(rng, 0, 2 * Pm.N, (batch, Pm.n))
    before = K.launches.get("blind_rotate_mm")
    got = K.blind_rotate_mm(acc, abar, mk.bk, Pm, mk.plan)
    assert K.launches.get("blind_rotate_mm") == before + 1
    assert torch.equal(got, K.blind_rotate_mm_plain(acc, abar, mk.bk, Pm, mk.plan))


@pytest.mark.parametrize("name", MM_SETS)
@pytest.mark.parametrize("M", [1, 3, 32, 64, 133, 512])
def test_round_mm_kernels_equal_twins(mm_keys, name, M):
    """K2-mm and K3-mm at every split (one block a ciphertext, a cluster
    pair) and at the one the wrapper picks, on round 5's slice read in place
    from the whole key (a view: each prime contiguous), one launch a call."""
    Pm, mk = mm_keys[name]
    rng = np.random.default_rng(M)
    bk = mk.bk[:, 5]
    digits = _ri(rng, -Pm.half_bg, Pm.half_bg, (M, Pm.decomp_rows, Pm.N))
    digits[0, :, :3] = -Pm.half_bg
    acc = _ri(rng, -2**31, 2**31, (M, 2, Pm.N))
    t = _ri(rng, 0, 2 * Pm.N, (M,))
    want2 = K.external_product_mm_plain(digits, bk, mk.plan)
    want3 = K.cmux_round_mm_plain(acc, t, bk, Pm, mk.plan)
    for split in (None, 1, 2):
        before = K.launches.get("cmux_round_mm")
        assert torch.equal(K._external_product_mm(digits, bk, mk.plan, split), want2), split
        assert torch.equal(K._cmux_round_mm(acc, t, bk, Pm, mk.plan, split), want3), split
        assert K.launches.get("cmux_round_mm") == before + 1


@pytest.mark.parametrize("name", MM_SETS)
def test_round_mm_layout_is_the_librarys(mm_keys, name):
    """The library's layout of every split (``redsec_round_mm_layout``) is
    ``kernels.round_mm_layout``'s; the card runs a cluster of each at once
    at least, no instance spills."""
    Pm, mk = mm_keys[name]
    for full in (False, True):
        for split in K.ROUND_MM_SPLITS:
            built = K.round_mm_built(Pm.N, Pm.decomp_rows, split, full)
            lay = K.round_mm_layout(Pm, split, mk.plan)
            assert {k: built[k] for k in lay if k in built} == {k: lay[k] for k in built
                                                                if k in lay}
            assert built["at_once"] >= 1 and built["local_bytes"] == 0
    for split in (3, 4):
        with pytest.raises(ValueError, match="split"):
            K._cmux_round_mm(torch.zeros((1, 2, Pm.N), dtype=torch.int32, device="cuda"),
                             torch.zeros((1,), dtype=torch.int32, device="cuda"), mk.bk[:, 0], Pm,
                             mk.plan, split)


@pytest.mark.parametrize("round_kernel", ["full", "partial"])
def test_round_kernel_pbs_equals_k4mm(mm_keys, round_kernel):
    """A 512-chunk PBS through ``round_kernel`` (n launches of K3-mm, or of
    K2-mm with the torch round around it) equals K4-mm's."""
    Pm, mk = mm_keys["small_v2_tpu"]
    rng = np.random.default_rng(17)
    sk, _ = kg.keygen(Pm, seed=3)
    ct = torch.as_tensor(lwe.encrypt_integers(sk.lwe_key, rng.integers(-100, 100, size=512),
                                              Pm, rng), device="cuda")
    tv = bs.const_test_vector(Pm, 1, Pm.msg_space)
    name = "cmux_round_mm" if round_kernel == "full" else "external_product_mm"
    before = K.launches.get(name)
    got = bs.make_batched_bootstrap(mk, round_kernel=round_kernel)(ct, tv)
    assert K.launches.get(name) == before + Pm.n
    assert torch.equal(got, bs.make_batched_bootstrap(mk)(ct, tv))


def test_blind_rotate_mm_equals_k4_on_one_raw_key(mm_keys):
    Pm, mk = mm_keys["small_v2_tpu"]
    rk = mm_keys["radix2"]
    rng = np.random.default_rng(11)
    acc = _ri(rng, -2**31, 2**31, (512, 2, Pm.N))
    abar = _ri(rng, 0, 2 * Pm.N, (512, Pm.n))
    assert torch.equal(K.blind_rotate_mm(acc, abar, mk.bk, Pm, mk.plan),
                       K.blind_rotate(acc, abar, rk.bk, Pm, rk.plan))


def test_mm_wrappers_reject_what_the_kernels_do_not_take(mm_keys):
    import dataclasses

    from redsec_tpu_torch.crypto.params import SMALL_V2_N2048

    Pm, mk = mm_keys["small_v2_tpu"]
    rk = mm_keys["radix2"]
    acc = torch.zeros((2, 2, Pm.N), dtype=torch.int32, device="cuda")
    abar = torch.zeros((2, Pm.n), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="four-step"):  # a radix-2 key, by its shape
        K.blind_rotate_mm(acc, abar, rk.bk, Pm, rk.plan)
    with pytest.raises(ValueError, match="contiguous"):
        K.blind_rotate_mm(acc, abar.t().contiguous().t(), mk.bk, Pm, mk.plan)
    # N = 2048 (40961 > 2^15) and bundled keys are outside the kernels' envelope
    Pn = dataclasses.replace(SMALL_V2_N2048, n=4)
    _, cn = kg.keygen(Pn, seed=1)
    nk = bs.prepare_cloud_key(cn, device="cuda", ntt_flavor="matmul")
    with pytest.raises(ValueError, match="outside"):
        K.blind_rotate_mm(torch.zeros((1, 2, Pn.N), dtype=torch.int32, device="cuda"),
                          torch.zeros((1, Pn.n), dtype=torch.int32, device="cuda"), nk.bk, Pn,
                          nk.plan)
    Pb = dataclasses.replace(P, n=4)
    _, cb = kg.keygen(Pb, seed=1, bundle=2)
    bkey = bs.prepare_cloud_key(cb, device="cuda", ntt_flavor="matmul")
    assert not K.supported_mm(Pb, bkey.plan, bkey.bundle)
    before = K.launches.get("blind_rotate_mm")
    ct = torch.zeros((3, Pb.n + 1), dtype=torch.int32, device="cuda")
    bs.make_batched_bootstrap(bkey)(ct, bs.const_test_vector(Pb, 1, Pb.msg_space))
    assert K.launches.get("blind_rotate_mm") == before  # the bundled key keeps the torch loop
