"""Key and ciphertext files between the port and the JAX package: what one
writes, the other loads array-equal (same npz container, FORMAT_VERSION 1).
Tolerance: exact equality."""

import numpy as np
import pytest
import torch

from redsec_tpu.crypto import keygen as jkg
from redsec_tpu.crypto.params import TEST_NOISELESS as JP
from redsec_tpu.formats import keys as jkio
from redsec_tpu_torch.crypto import keygen as kg
from redsec_tpu_torch.crypto.params import TEST_NOISELESS as P
from redsec_tpu_torch.formats import keys as kio

torch.set_num_threads(2)


def _same_key(a, b, fields):
    assert a.params.name == b.params.name
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)


CLOUD_FIELDS = ("bk", "ksk", "bk_pair", "rerand")


@pytest.mark.parametrize("bundle", [1, 2])
def test_jax_key_files_load_in_the_port_and_the_reverse(tmp_path, bundle):
    """bundle=2 keys carry ``bk_pair``; every key carries ``rerand``."""
    jsk, jcloud = jkg.keygen(JP, seed=3, bundle=bundle)
    sk, cloud = kg.keygen(P, seed=3, bundle=bundle)
    assert cloud.rerand is not None and (cloud.bk_pair is not None) == (bundle == 2)
    jkio.save_secret_key(str(tmp_path / "j_sk.npz"), jsk)
    jkio.save_cloud_key(str(tmp_path / "j_ck.npz"), jcloud)
    kio.save_secret_key(str(tmp_path / "t_sk.npz"), sk)
    kio.save_cloud_key(str(tmp_path / "t_ck.npz"), cloud)
    for src in ("j", "t"):
        for load_sk, load_ck in ((kio.load_secret_key, kio.load_cloud_key),
                                 (jkio.load_secret_key, jkio.load_cloud_key)):
            _same_key(load_sk(str(tmp_path / f"{src}_sk.npz")), sk, ("lwe_key", "rlwe_key"))
            _same_key(load_ck(str(tmp_path / f"{src}_ck.npz")), cloud, CLOUD_FIELDS)


def test_a_cloud_key_without_rerand_loads_as_none(tmp_path):
    _, cloud = kg.keygen(P, seed=1)
    cloud.rerand = None
    kio.save_cloud_key(str(tmp_path / "ck.npz"), cloud)
    assert kio.load_cloud_key(str(tmp_path / "ck.npz")).rerand is None
    assert jkio.load_cloud_key(str(tmp_path / "ck.npz")).rerand is None


@pytest.mark.parametrize("gain,center", [(1, None), (8, np.array([3, -2, 0], np.int64))])
def test_ciphertext_files_load_both_ways(tmp_path, gain, center):
    ct = np.random.default_rng(0).integers(-2**31, 2**31, size=(2, 3, P.n + 1)).astype(np.int32)
    kio.save_ciphertexts(str(tmp_path / "t.npz"), ct, P, label=7,
                         out_gain=gain, out_center=center)
    jkio.save_ciphertexts(str(tmp_path / "j.npz"), ct, JP, label=7, out_gain=gain,
                          out_center=center)
    for path in ("t.npz", "j.npz"):
        for load in (kio.load_ciphertexts, jkio.load_ciphertexts):
            got, params, label, g, c = load(str(tmp_path / path))
            np.testing.assert_array_equal(got, ct)
            assert (params.name, label, g) == (P.name, 7, gain)
            assert (c is None) if center is None else np.array_equal(c, center)


def test_ensure_keyset_generates_then_loads(tmp_path):
    sk, dkey = kio.ensure_keyset("test_noiseless", seed=2, base=str(tmp_path), device="cpu")
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["cloud_test_noiseless_s2.npz", "secret_test_noiseless_s2.npz"]
    sk2, dkey2 = kio.ensure_keyset("test_noiseless", seed=2, base=str(tmp_path), device="cpu")
    np.testing.assert_array_equal(sk2.lwe_key, sk.lwe_key)
    assert torch.equal(dkey2.bk, dkey.bk) and torch.equal(dkey2.rerand, dkey.rerand)
    # the same files as the JAX package's cache, and its keys
    jsk = jkio.load_secret_key(str(tmp_path / "secret_test_noiseless_s2.npz"))
    np.testing.assert_array_equal(jsk.lwe_key, jkg.keygen(JP, seed=2)[0].lwe_key)
    # a cache written before the re-randomization pool is upgraded in place,
    # with the pool the JAX package draws
    ck_path = str(tmp_path / "cloud_test_noiseless_s2.npz")
    ck = kio.load_cloud_key(ck_path)
    ck.rerand = None
    kio.save_cloud_key(ck_path, ck)
    kio.ensure_keyset("test_noiseless", seed=2, base=str(tmp_path), device="cpu")
    mine = kio.load_cloud_key(ck_path).rerand
    ck.rerand = None
    jkio.save_cloud_key(ck_path, ck)
    jkio.ensure_keyset("test_noiseless", seed=2, base=str(tmp_path))
    np.testing.assert_array_equal(mine, jkio.load_cloud_key(ck_path).rerand)


def test_ensure_keyset_defaults_to_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        kio.ensure_keyset("test_noiseless", base=str(tmp_path))
    assert list(tmp_path.iterdir()) == []  # raised before any keygen
