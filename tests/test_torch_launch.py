"""The host side of the port's launch path, on the CPU (its card side is in
``tests/test_torch_cuda.py``, marked ``cuda``).

- ``kernels.schoolbook_rounds`` on the CPU equals n calls of
  ``schoolbook_round_plain``: one call of ``kernels.schoolbook_round`` a
  round, looked up at call time, on two buffers in turn, with ``acc`` left
  as it was.
- The schoolbook PBS runs its n rounds in one call of ``schoolbook_rounds``
  and equals the JAX package's schoolbook PBS on the same key and
  ciphertexts, at the sets ``test_torch_schoolbook_fft.py``'s PBS test uses
  (``medium`` as it is, ``medium_v2`` with JAX's int8 wrap emulated).
- Every constant a wrapper reads from a cache (the gadget's, the four-step
  shape rule, the kernels' twiddle tables and their addresses) equals its
  direct computation at every parameter set of ``params.py``.
- The launch counter adds a loop's launches in one step.

Tolerance: exact equality (integer arithmetic mod 2^32; the tables are the
same numbers).
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
from redsec_tpu_torch.crypto import kernels, lwe, ntt_matmul
from redsec_tpu_torch.crypto import keygen as kg
from redsec_tpu_torch.crypto.params import PARAM_SETS, get_params
from redsec_tpu_torch.device import LaunchCounter
from test_torch_schoolbook import _noiseless, _spectra_product_with_int8_wrap

torch.set_num_threads(2)


def _i32(rng, lo, hi, shape):
    return torch.as_tensor(rng.integers(lo, hi, size=shape).astype(np.int32))


@pytest.mark.parametrize("name,N,n,B", [("medium_v2", 256, 5, 3), ("medium", 512, 4, 2)])
def test_schoolbook_rounds_equal_n_plain_rounds(name, N, n, B, monkeypatch):
    P = dataclasses.replace(get_params(name), N=N)
    rng = np.random.default_rng(11)
    acc = _i32(rng, -2**31, 2**31, (B, 2, N))
    ts = _i32(rng, 0, 2 * N, (n, B))
    spectra = kernels.key_spectra(_i32(rng, -2**31, 2**31, (n, P.decomp_rows, 2, N)))
    want = acc
    for i in range(n):
        want = kernels.schoolbook_round_plain(want, ts[i], spectra[i], P)
    before = acc.clone()
    outs = []
    the_round = kernels.schoolbook_round

    def spy(a, t, spectra_round, params, out=None):
        outs.append(out)
        return the_round(a, t, spectra_round, params, out=out)

    monkeypatch.setattr(kernels, "schoolbook_round", spy)
    got = kernels.schoolbook_rounds(acc, ts, spectra, P)
    assert torch.equal(got, want)
    assert torch.equal(kernels.schoolbook_rounds_plain(acc, ts, spectra, P), want)
    assert torch.equal(acc, before)  # acc is not written
    assert len(outs) == n and len({o.data_ptr() for o in outs}) == 2  # two buffers in turn
    none = kernels.schoolbook_rounds(acc, ts[:0], spectra[:0], P)
    assert torch.equal(none, acc) and none.data_ptr() != acc.data_ptr()
    with pytest.raises(ValueError, match="spectra"):
        kernels.schoolbook_rounds(acc, ts, None, P)


@pytest.mark.parametrize("name", ["medium", "medium_v2"])
def test_schoolbook_pbs_runs_its_rounds_in_one_call_vs_jax(name, monkeypatch):
    monkeypatch.delenv("REDSEC_FORCE_SCHOOLBOOK", raising=False)
    P = _noiseless(get_params(name), 6)
    sk, cloud = kg.keygen(P, seed=3)
    dkey = bs.prepare_cloud_key(cloud, device="cpu")
    rng = np.random.default_rng(9)
    vals = np.array([37, -1200])
    ct = np.stack([lwe.encrypt_integers(sk.lwe_key, np.array([v]), P, rng)[0] for v in vals])
    tv = bs.const_test_vector(P, 1, P.msg_space)

    calls = []
    the_rounds = kernels.schoolbook_rounds

    def spy(acc, ts, spectra, params):
        calls.append((tuple(ts.shape), spectra))
        return the_rounds(acc, ts, spectra, params)

    monkeypatch.setattr(kernels, "schoolbook_rounds", spy)
    if name == "medium_v2":  # JAX's int8 convolution wraps -(-128) at Bg/2 = 128
        monkeypatch.setattr(kernels, "schoolbook_fft_product_plain",
                            _spectra_product_with_int8_wrap())
    got = bs.make_batched_bootstrap(dkey)(ct, tv).numpy()
    assert len(calls) == 1 and calls[0][0] == (P.n, len(vals)) and calls[0][1] is dkey.spectra

    _, jcloud = jkg.keygen(jparams.TfheParams(**dataclasses.asdict(P)), seed=3)
    jkey = jbs.prepare_cloud_key(jcloud)
    want = np.asarray(jbs.make_batched_bootstrap(jkey)(jnp.asarray(ct), jnp.asarray(tv)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(PARAM_SETS))
def test_memoized_constants_equal_their_direct_computation(name):
    P = PARAM_SETS[name]
    assert kernels._gadget_args(P) == (P.l, P.bg_bit, bs.gadget_offset(P))
    assert kernels._gadget_args(dataclasses.replace(P, name="other")) == kernels._gadget_args(P)
    cpu = torch.device("cpu")
    tw, twist = kernels.fft_tables(P.N, cpu)
    tw_host, twist_host, _ = kernels._fft_tables_host(P.N)
    assert torch.equal(tw, torch.as_tensor(tw_host[kernels.fft_pass_index(P.N)]))
    assert torch.equal(twist, torch.as_tensor(twist_host))
    assert kernels.fft_tables(P.N, cpu)[0] is tw and kernels.fft_tables(P.N, "cpu")[0] is tw
    assert kernels._fft_entry(P.N, -1)[2:] == (tw.data_ptr(), twist.data_ptr())
    for bundle in (1, 2):
        plan = bs.bootstrap_plan(P, bundle == 2)
        if plan is None:  # the schoolbook sets: no NTT plan, no four-step key
            continue
        for rows in sorted({P.decomp_rows, 3 * P.decomp_rows, 1, 12, 20, 64, 200}):
            direct = kernels._mm_shape_ok_at.__wrapped__(tuple(plan.primes), plan.N, P.N, rows)
            assert kernels._mm_shape_ok(plan, P.N, rows) == direct
        direct = (bundle == 1 and P.l * P.bg_bit <= 32 and kernels._mm_shape_ok_at.__wrapped__(
            tuple(plan.primes), plan.N, P.N, P.decomp_rows))
        assert kernels.supported_mm(P, plan, bundle) == direct
        tabs = kernels.kernel_tables(plan, cpu)
        assert torch.equal(tabs, torch.as_tensor(kernels.shoup_tables(plan).view(np.int32)))
        assert kernels.kernel_tables(plan, cpu) is tabs
        mm = ntt_matmul.kernel_tables_mm(plan, cpu)
        host = [ntt_matmul.kernel_tables_mm_host(plan.N, p, int(plan.twist[pi][1]))
                for pi, p in enumerate(plan.primes)]
        assert torch.equal(mm["tw"], torch.as_tensor(np.stack([h["tw"] for h in host])
                                                     .view(np.int32)))
        assert torch.equal(mm["wc"], torch.as_tensor(np.stack([h["wc"] for h in host])))
        assert ntt_matmul.kernel_tables_mm(plan, cpu) is mm


def test_launch_counter_adds_a_loops_launches_at_once():
    c = LaunchCounter()
    c.bump("schoolbook_round", 3072)
    c.bump("schoolbook_round")
    assert c.get("schoolbook_round") == 3073 and c.get("other") == 0
