"""The PBS branches beyond the two-prime plain rotation, against the JAX package.

Every NTT-plan branch of the JAX package's ``make_bootstrap_impl``:

- ``small_v2_n2048`` (N = 2048, primes 12289 and 40961; JAX takes its GEMM
  pointwise branch at 40961),
- ``small`` (three primes, 12289, 18433 and 40961),
- bundled keys (``bundle=2``) at ``test_noiseless``, ``small_v2_tpu``,
  ``small_v2_tpu2`` (three primes only when bundled) and ``small_v2_n2048``
  (60 digit rows a round at primes 12289 and 40961).

Depth is cut with ``dataclasses.replace`` on both sides (n = 16 or 8
rounds); widths (N, Bg, l, primes) are the sets' own.  Keys come from the
same seed on both sides, ciphertexts from a numpy seed.  The port's PBS
(``make_batched_bootstrap`` and ``make_chunked_bootstrap``) runs on the CPU
twins and must equal JAX's ``make_batched_bootstrap`` and
``make_chunked_bootstrap``.  Tolerance: exact equality of int32 arrays.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redsec_tpu.crypto import bootstrap as jbs
from redsec_tpu.crypto import keygen as jkg
from redsec_tpu.crypto import params as jparams
from redsec_tpu_torch.crypto import bootstrap as bs
from redsec_tpu_torch.crypto import keygen as kg
from redsec_tpu_torch.crypto import kernels, lwe
from redsec_tpu_torch.crypto.params import get_params

torch.set_num_threads(2)

# (set, rounds, bundle, primes of the plan the key is prepared with)
CASES = [
    ("small_v2_n2048", 16, 1, (12289, 40961)),
    ("small", 8, 1, (12289, 18433, 40961)),
    ("test_noiseless", 16, 2, (12289, 18433)),
    ("small_v2_tpu", 16, 2, (12289, 18433)),
    ("small_v2_tpu2", 8, 2, (12289, 18433, 40961)),
    ("small_v2_n2048", 8, 2, (12289, 40961)),
]
IDS = [f"{name}-n{n}-bundle{b}" for name, n, b, _ in CASES]


def _params(name, n):
    return (dataclasses.replace(get_params(name), n=n),
            dataclasses.replace(jparams.get_params(name), n=n))


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    name, n, bundle, primes = request.param
    P, JP = _params(name, n)
    sk, cloud = kg.keygen(P, seed=4, bundle=bundle)
    _, jcloud = jkg.keygen(JP, seed=4, bundle=bundle)
    dkey = bs.prepare_cloud_key(cloud, device="cpu")
    jdkey = jbs.prepare_cloud_key(jcloud)
    rng = np.random.default_rng(9)
    vals = rng.integers(-P.msg_space // 4, P.msg_space // 4, size=5)
    ct = lwe.encrypt_integers(sk.lwe_key, vals, P, rng)
    return dict(name=name, P=P, sk=sk, cloud=cloud, dkey=dkey, jdkey=jdkey, ct=ct,
                vals=vals, bundle=bundle, primes=primes)


def test_plan_and_key_follow_the_jax_package(case):
    P, dkey, jdkey = case["P"], case["dkey"], case["jdkey"]
    assert dkey.plan.primes == jdkey.plan.primes == case["primes"]
    assert dkey.bundle == jdkey.bundle == case["bundle"]
    rounds = P.n // case["bundle"]
    rows = P.decomp_rows * (3 if case["bundle"] == 2 else 1)
    assert tuple(dkey.bk.shape) == (len(case["primes"]), rounds, rows, 8, P.N)
    assert kernels.key_bundle(dkey.bk, P) == case["bundle"]
    # the JAX key's uint16 residues are the port's int16 patterns, zero-extended
    # (radix-2 order on both sides)
    for pi in range(len(case["primes"])):
        want = np.asarray(jdkey.bk_ntt[pi]).reshape(rounds, rows, 8, P.N)
        np.testing.assert_array_equal(kernels.residues(dkey.bk[pi]).numpy(), want)
    assert int(kernels.residues(dkey.bk).max()) < case["primes"][-1]
    assert kernels.supported(P, dkey.plan, case["bundle"])


def test_pbs_equals_jax_batched_and_chunked(case):
    P, ct = case["P"], case["ct"]
    tv = bs.const_test_vector(P, 1, P.msg_space)
    got = bs.make_batched_bootstrap(case["dkey"])(ct, tv).numpy()
    want = np.asarray(jbs.make_batched_bootstrap(case["jdkey"])(jnp.asarray(ct),
                                                                 jnp.asarray(tv)))
    assert got.shape == (ct.shape[0], P.n + 1) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if case["name"] == "test_noiseless":  # the only set that decrypts exactly
        np.testing.assert_array_equal(lwe.decrypt_integers(case["sk"].lwe_key, got, P),
                                      np.where(case["vals"] >= 0, 1, -1))
    # chunked with a ragged last slice, and per-ciphertext test vectors
    tvs = np.stack([bs.const_test_vector(P, v, P.msg_space) for v in (1, 2, 3, 1, 2)])
    got = bs.make_chunked_bootstrap(case["dkey"], chunk=2)(ct, tvs).numpy()
    want = np.asarray(jbs.make_chunked_bootstrap(case["jdkey"], chunk=2)(
        jnp.asarray(ct), jnp.asarray(tvs)))
    np.testing.assert_array_equal(got, want)


def test_bundled_round_twin_equals_two_plain_rounds_algebra():
    """The bundled round's expansion acc + BK_i.D(u) + BK_j.D(v) + BK_ij.D(w)
    against its definition, on one round slice of a test_noiseless key:
    the twin's digits are those of u, v and w stacked row = which * rows + r."""
    P, _ = _params("test_noiseless", 4)
    _, cloud = kg.keygen(P, seed=1, bundle=2)
    dkey = bs.prepare_cloud_key(cloud, device="cpu")
    rng = np.random.default_rng(3)
    acc = torch.as_tensor(rng.integers(-2**31, 2**31, size=(3, 2, P.N)).astype(np.int32))
    ti = torch.as_tensor(rng.integers(0, 2 * P.N, size=3).astype(np.int32))
    tj = torch.as_tensor(rng.integers(0, 2 * P.N, size=3).astype(np.int32))
    got = kernels.bundled_round_plain(acc, ti, tj, dkey.bk[:, 1], P, dkey.plan)
    ops = bs.RoundOps(P)
    u = ops.rotate(acc, ti) - acc
    v = ops.rotate(acc, tj) - acc
    w = ops.rotate(u, tj) - u
    rows = P.decomp_rows
    delta = sum(kernels.external_product_plain(ops.decompose(d), dkey.bk[:, 1, k * rows:(k + 1) * rows],
                                               dkey.plan)
                for k, d in enumerate((u, v, w)))
    assert torch.equal(got, acc + delta)


def test_what_still_raises_on_cuda():
    """The schoolbook sets (N >= 4096) have no NTT plan; a prime at or above
    2^16 is outside the kernels' instances.  Bundled N = 2048 is taken."""
    for name in ("medium", "large", "medium_v2", "large_v2"):
        assert bs.bootstrap_plan(get_params(name)) is None
    n2048 = get_params("small_v2_n2048")
    assert kernels.supported(n2048, bs.bootstrap_plan(n2048))
    assert kernels.supported(n2048, bs.bootstrap_plan(n2048, True), bundle=2)
    small = get_params("small")
    assert kernels.supported(small, bs.bootstrap_plan(small))
    plan = bs.bootstrap_plan(small)
    wide = dataclasses.replace(plan, primes=(12289, 18433, 65537))
    assert not kernels.supported(small, wide)
    with pytest.raises(ValueError, match="2 or 3 ascending primes"):
        kernels.ntt(torch.zeros((8, 1024), dtype=torch.int32, device="meta"), wide, 0)
