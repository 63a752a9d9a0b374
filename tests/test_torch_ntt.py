"""The port's NTT, inverse NTT and CRT against the JAX package's device
functions and its numpy oracle, for every prime of the N = 256 and N = 1024
plans.  Tolerance: exact equality of the int32 residues and torus values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redsec_tpu.crypto import bootstrap as jbs
from redsec_tpu.crypto import ntt as jntt
from redsec_tpu.crypto import params as jparams
from redsec_tpu_torch.crypto import ntt
from redsec_tpu_torch.crypto.bootstrap import bootstrap_plan
from redsec_tpu_torch.crypto.params import get_params

torch.set_num_threads(2)

# test_noiseless (N=256) and small_v2_tpu (N=1024): 12289, 18433; small
# (N=1024, Bg=2^10): 12289, 18433, 40961
NAMES = ("test_noiseless", "small_v2_tpu", "small")
PLANS = {name: bootstrap_plan(get_params(name)) for name in NAMES}
JPLANS = {name: jbs._bootstrap_plan(jparams.get_params(name)) for name in NAMES}
CASES = [(name, pi) for name, plan in PLANS.items() for pi in range(len(plan.primes))]


def test_plans_and_tables_equal_the_jax_package():
    for name, plan in PLANS.items():
        jplan = JPLANS[name]
        assert plan.primes == jplan.primes
        assert (plan.crt_inv, plan.crt_shift_mod232, plan.prod_mod232) == \
            (jplan.crt_inv, jplan.crt_shift_mod232, jplan.prod_mod232)
        for pi in range(len(plan.primes)):
            np.testing.assert_array_equal(plan.twist[pi], jplan.twist[pi])
            np.testing.assert_array_equal(plan.untwist[pi], jplan.untwist[pi])
            for a, b in zip(plan.fwd_tabs[pi] + plan.inv_tabs[pi],
                            jplan.fwd_tabs[pi] + jplan.inv_tabs[pi]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,pi", CASES)
def test_ntt_and_inverse_equal_jax_and_host(name, pi):
    plan = PLANS[name]
    p, N = plan.primes[pi], plan.N
    x = np.random.default_rng(pi).integers(0, p, size=(3, 2, N)).astype(np.int32)
    x[0, 0, :4] = [0, p - 1, p - 1, 1]

    got = ntt.ntt_device(torch.as_tensor(x), plan, pi).numpy()
    np.testing.assert_array_equal(got, np.asarray(jntt.ntt_device(jnp.asarray(x), JPLANS[name], pi)))
    np.testing.assert_array_equal(got, ntt.ntt_host(x, plan, pi))

    back = ntt.intt_device(torch.as_tensor(got), plan, pi).numpy()
    np.testing.assert_array_equal(back, np.asarray(jntt.intt_device(jnp.asarray(got), JPLANS[name], pi)))
    np.testing.assert_array_equal(back, ntt.intt_host(got, plan, pi))
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("name", list(PLANS))
def test_crt_to_torus32_equals_jax_and_the_exact_value(name):
    plan = PLANS[name]
    P = int(np.prod([int(p) for p in plan.primes], dtype=object))
    half = int(0.36 * P)  # the range primes_for certifies
    rng = np.random.default_rng(5)
    v = np.array([int(a) for a in rng.integers(-half, half, size=512)] + [0, -1, half, -half],
                 dtype=object)
    res = [np.array([int(a) % p for a in v], np.int32) for p in plan.primes]
    got = ntt.crt_to_torus32([torch.as_tensor(r) for r in res], plan).numpy()
    want = np.asarray(jntt.crt_to_torus32([jnp.asarray(r) for r in res], JPLANS[name]))
    np.testing.assert_array_equal(got, want)
    exact = np.array([((int(a) + 2**31) % 2**32) - 2**31 for a in v], np.int32)
    np.testing.assert_array_equal(got, exact)


def test_negacyclic_product_through_the_transform():
    """x * y mod (X^N + 1, p) through forward, pointwise and inverse
    transforms equals the schoolbook product mod p."""
    plan = PLANS["test_noiseless"]
    p, N = plan.primes[0], plan.N
    rng = np.random.default_rng(9)
    a = rng.integers(-16, 16, size=N)
    b = rng.integers(-128, 128, size=N)
    fa = ntt.ntt_device(torch.as_tensor((a % p).astype(np.int32)), plan, 0)
    fb = ntt.ntt_device(torch.as_tensor((b % p).astype(np.int32)), plan, 0)
    got = ntt.intt_device(fa * fb % p, plan, 0).numpy()
    want = ntt.negacyclic_mul_host(a, b, N).astype(np.int64) % p
    np.testing.assert_array_equal(got, want)
