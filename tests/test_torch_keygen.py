"""The port's numpy keygen draws the JAX package's keys byte for byte from
the same seed.  Tolerance: exact equality of every key array."""

import numpy as np
import pytest

from redsec_tpu.crypto import keygen as jkg
from redsec_tpu.crypto import params as jparams
from redsec_tpu_torch.crypto import keygen as kg
from redsec_tpu_torch.crypto import params


def _assert_keys_equal(ours, theirs):
    (sk, ck), (jsk, jck) = ours, theirs
    np.testing.assert_array_equal(sk.lwe_key, jsk.lwe_key)
    np.testing.assert_array_equal(sk.rlwe_key, jsk.rlwe_key)
    np.testing.assert_array_equal(ck.bk, jck.bk)
    np.testing.assert_array_equal(ck.ksk, jck.ksk)
    np.testing.assert_array_equal(ck.rerand, jck.rerand)
    if jck.bk_pair is None:
        assert ck.bk_pair is None
    else:
        np.testing.assert_array_equal(ck.bk_pair, jck.bk_pair)
    assert ck.bk.dtype == jck.bk.dtype and ck.ksk.dtype == jck.ksk.dtype


@pytest.mark.parametrize("name,seed,bundle", [
    ("test_noiseless", 0, 1),
    ("test_noiseless", 11, 2),
    ("small_v2_tpu", 0, 1),
])
def test_keygen_equals_jax_for_the_same_seed(name, seed, bundle):
    ours = kg.keygen(params.get_params(name), seed=seed, bundle=bundle)
    theirs = jkg.keygen(jparams.get_params(name), seed=seed, bundle=bundle)
    _assert_keys_equal(ours, theirs)


def test_parameter_sets_equal_the_jax_package():
    assert sorted(params.PARAM_SETS) == sorted(jparams.PARAM_SETS)
    for name, p in params.PARAM_SETS.items():
        q = jparams.PARAM_SETS[name]
        for f in ("n", "N", "k", "bg_bit", "l", "ks_basebit", "ks_t", "alpha_ks",
                  "alpha_bk", "alpha_enc", "msg_space"):
            assert getattr(p, f) == getattr(q, f), (name, f)
        assert p.mod_switch_sigma_units() == q.mod_switch_sigma_units()


def test_negacyclic_binary_product_equals_schoolbook():
    from redsec_tpu_torch.crypto.ntt import negacyclic_mul_host

    rng = np.random.default_rng(4)
    N = 64
    a = rng.integers(-2**31, 2**31, size=(3, N)).astype(np.int32)
    key = rng.integers(0, 2, size=N).astype(np.int32)
    got = kg.negacyclic_mul_binary_host(a, key, N)
    want = np.stack([negacyclic_mul_host(row, key, N) for row in a])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jkg.negacyclic_mul_binary_host(a, key, N))
