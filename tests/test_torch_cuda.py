"""The CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: without a card every test here skips.  The tests import
nothing of JAX, so they run on a machine without it (``--noconftest``
skips ``tests/conftest.py``, which pins JAX to the CPU):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: exact equality (integer arithmetic mod p and mod 2^32).
"""

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


def test_ntt_kernel_equals_twin(key):
    plan = key[2].plan
    rng = np.random.default_rng(0)
    for pi, p in enumerate(plan.primes):
        x = _ri(rng, 0, p, (37, P.N))
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
