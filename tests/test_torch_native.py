"""The port's native CGGI core (``redsec_tpu_torch/native``) against the JAX
package's native core and the port's own PBS, bit for bit, at
``test_noiseless``, with a programmable test vector, at ``medium`` (n cut to
6) and at ``small_v2_tpu`` (n cut to 8), the card's smoke set.  Also: the
library lands under ``build/native/`` keyed on its source, and a failed build
raises with the compiler's message."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from redsec_tpu import native as jnative
from redsec_tpu.crypto import keygen as jkg
from redsec_tpu.crypto.params import TfheParams as JTfheParams
from redsec_tpu_torch import native
from redsec_tpu_torch.crypto import bootstrap as bs
from redsec_tpu_torch.crypto import keygen as kg
from redsec_tpu_torch.crypto import lwe
from redsec_tpu_torch.crypto.params import MEDIUM, SMALL_V2_TPU, TEST_NOISELESS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def needs_gxx():
    if not native.available():
        pytest.skip("no g++ on PATH: the native core cannot be built")


def jax_params(p):
    """The JAX package's TfheParams with the port's field values."""
    return JTfheParams(**{f.name: getattr(p, f.name) for f in dataclasses.fields(p) if f.init})


def three_ways(P, seed, ct, tv):
    """The port's native PBS, the JAX package's native PBS on the JAX
    package's key of the same seed, and the port's PBS (CPU twins)."""
    _, cloud = kg.keygen(P, seed=seed)
    _, jcloud = jkg.keygen(jax_params(P), seed=seed)
    np.testing.assert_array_equal(cloud.bk, jcloud.bk)
    got = native.NativeEngine(cloud).bootstrap(ct, tv)
    jeng = jnative.NativeEngine(jcloud)
    want_native = jeng.bootstrap(ct, tv)
    dkey = bs.prepare_cloud_key(cloud, device="cpu")
    want_pbs = bs.make_batched_bootstrap(dkey)(torch.as_tensor(ct), torch.as_tensor(tv)).numpy()
    return got, want_native, want_pbs


def test_noiseless_matches_jax_native_and_the_port_pbs():
    sk, _ = kg.keygen(TEST_NOISELESS, seed=42)
    rng = np.random.default_rng(9)
    vals = rng.integers(-500, 500, size=16)
    ct = lwe.encrypt_integers(sk.lwe_key, vals, TEST_NOISELESS, rng)
    tv = bs.const_test_vector(TEST_NOISELESS, 1, TEST_NOISELESS.msg_space)
    got, want_native, want_pbs = three_ways(TEST_NOISELESS, 42, ct, tv)
    np.testing.assert_array_equal(got, want_native)
    np.testing.assert_array_equal(got, want_pbs)
    np.testing.assert_array_equal(lwe.decrypt_integers(sk.lwe_key, got, TEST_NOISELESS),
                                  np.where(vals >= 0, 1, -1))


def test_programmable_test_vector():
    P = TEST_NOISELESS
    sk, _ = kg.keygen(P, seed=1)

    def fn(u):
        return np.clip((u - 256) >> 3, 0, 7)

    tv = bs.function_test_vector(P, fn, P.msg_space)
    vals = np.array([0, 16, 64, -16, -64, 200])
    triv = lwe.lwe_noiseless_trivial(lwe.mod_switch_to_torus32(vals + 256, P.msg_space), P.n)
    got, want_native, want_pbs = three_ways(P, 1, triv, tv)
    np.testing.assert_array_equal(got, want_native)
    np.testing.assert_array_equal(got, want_pbs)
    np.testing.assert_array_equal(lwe.decrypt_integers(sk.lwe_key, got, P),
                                  np.clip(vals >> 3, 0, 7))


@pytest.mark.parametrize("base,n", [(MEDIUM, 6), (SMALL_V2_TPU, 8)])
def test_cut_sets_match_jax_native_and_the_port_pbs(base, n):
    """medium (N 4096, Bg 2^10, l 3: three primes with the 64-bit Barrett
    reduction; the port's PBS through its schoolbook path) without noise, as
    tests/test_native.py; small_v2_tpu (N 1024, two primes) with its noise."""
    P = dataclasses.replace(base, name=f"{base.name}_cut", n=n)
    if base is MEDIUM:
        P = dataclasses.replace(P, alpha_ks=0.0, alpha_bk=0.0, alpha_enc=0.0)
    sk, _ = kg.keygen(P, seed=5)
    rng = np.random.default_rng(6)
    vals = np.array([123, -800])
    ct = lwe.encrypt_integers(sk.lwe_key, vals, P, rng)
    tv = bs.const_test_vector(P, 1, P.msg_space)
    got, want_native, want_pbs = three_ways(P, 5, ct, tv)
    np.testing.assert_array_equal(got, want_native)
    np.testing.assert_array_equal(got, want_pbs)
    assert native.primes_for(P) == ((40961, 65537, 114689) if base is MEDIUM else (12289, 18433))
    np.testing.assert_array_equal(lwe.decrypt_integers(sk.lwe_key, got, P),
                                  np.where(vals >= 0, 1, -1))


def test_library_lands_under_build_native_keyed_on_its_source():
    path = native.build()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "native")
    assert os.path.basename(path).startswith("libcggi_core-") and os.path.exists(path)
    assert native.library_path() == path
    assert native.num_threads() >= 1


def test_failed_build_raises_with_the_compiler_message(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int cggi_engine_new( { return undeclared_name; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build(str(bad))
    assert "error" in str(err.value) and str(bad) in str(err.value)
    assert not os.path.exists(native.library_path(str(bad)))


def test_engine_refuses_what_the_core_cannot_cover():
    P = dataclasses.replace(MEDIUM, N=16384, name="medium_n16384")  # 65537 * 163841 < bound
    with pytest.raises(ValueError, match="do not cover"):
        native.primes_for(P)
