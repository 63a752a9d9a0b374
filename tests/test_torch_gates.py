"""The port's bootstrapped gate library against the JAX package's, mirroring
``tests/test_gates.py``: the same key (seed 21) and ciphertexts through both
``GateSet``s, outputs bit-identical and decrypting to the truth tables; the
gates over a schoolbook key equal those over the NTT key; and the LWE
helpers ``lwe_decrypt`` / ``lwe_noiseless_trivial`` equal JAX's.

Tolerance everywhere: exact equality of int32 arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redsec_tpu.crypto import bootstrap as jbs
from redsec_tpu.crypto import gates as jgates
from redsec_tpu.crypto import keygen as jkg
from redsec_tpu.crypto import lwe as jlwe
from redsec_tpu.crypto import params as jparams
from redsec_tpu_torch.crypto import bootstrap as bs
from redsec_tpu_torch.crypto import keygen as kg
from redsec_tpu_torch.crypto import lwe
from redsec_tpu_torch.crypto.gates import GateSet, gate_decrypt_host, gate_encrypt_host
from redsec_tpu_torch.crypto.params import TEST_NOISELESS

torch.set_num_threads(2)
P = TEST_NOISELESS


@pytest.fixture(scope="module")
def env():
    sk, cloud = kg.keygen(P, seed=21)
    _, jcloud = jkg.keygen(jparams.TEST_NOISELESS, seed=21)
    return sk, GateSet(bs.prepare_cloud_key(cloud, device="cpu")), \
        jgates.GateSet(jbs.prepare_cloud_key(jcloud))


def _enc(sk, bits):
    ct = gate_encrypt_host(sk.lwe_key, np.asarray(bits), P, np.random.default_rng(0))
    jct = jgates.gate_encrypt_host(sk.lwe_key, np.asarray(bits), jparams.TEST_NOISELESS,
                                   np.random.default_rng(0))
    np.testing.assert_array_equal(ct, jct)
    return torch.as_tensor(ct), jnp.asarray(jct)


def _same(sk, got, jgot):
    """The port's and JAX's output ciphertexts are equal; their bits."""
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    bits = gate_decrypt_host(sk.lwe_key, got.numpy(), P)
    np.testing.assert_array_equal(
        bits, jgates.gate_decrypt_host(sk.lwe_key, np.asarray(jgot), jparams.TEST_NOISELESS))
    return bits


def test_two_input_gates(env):
    sk, g, jg = env
    a = np.array([0, 0, 1, 1])
    b = np.array([0, 1, 0, 1])
    (ca, ja), (cb, jb) = _enc(sk, a), _enc(sk, b)
    cases = {
        "AND": a & b, "OR": a | b, "NAND": 1 - (a & b), "NOR": 1 - (a | b),
        "XOR": a ^ b, "XNOR": 1 - (a ^ b),
        "ANDNY": (1 - a) & b, "ANDYN": a & (1 - b),
        "ORNY": (1 - a) | b, "ORYN": a | (1 - b),
    }
    for name, want in cases.items():
        got = _same(sk, getattr(g, name)(ca, cb), getattr(jg, name)(ja, jb))
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_not_copy_constant_mux(env):
    sk, g, jg = env
    a = np.array([0, 1, 0, 1])
    s = np.array([0, 0, 1, 1])
    b = np.array([1, 1, 0, 0])
    (ca, ja), (cb, jb), (cs, js) = _enc(sk, a), _enc(sk, b), _enc(sk, s)
    np.testing.assert_array_equal(_same(sk, g.NOT(ca), jg.NOT(ja)), 1 - a)
    np.testing.assert_array_equal(_same(sk, g.COPY(ca), jg.COPY(ja)), a)
    np.testing.assert_array_equal(_same(sk, g.CONSTANT(True, ca), jg.CONSTANT(True, ja)),
                                  np.ones(4))
    np.testing.assert_array_equal(_same(sk, g.MUX(cs, ca, cb), jg.MUX(js, ja, jb)),
                                  np.where(s, a, b))


def test_ripple_add(env):
    sk, g, jg = env
    rng = np.random.default_rng(5)
    x = rng.integers(0, 8, size=4)
    y = rng.integers(0, 8, size=4)
    xb = np.stack([(x >> i) & 1 for i in range(3)], axis=-1)  # [B, 3] LSB first
    yb = np.stack([(y >> i) & 1 for i in range(3)], axis=-1)
    (cx, jx), (cy, jy) = _enc(sk, xb), _enc(sk, yb)
    s, carry = g.ripple_add(cx, cy)
    js, jcarry = jg.ripple_add(jx, jy)
    sbits, cbit = _same(sk, s, js), _same(sk, carry, jcarry)
    got = (sbits * (2 ** np.arange(3))).sum(-1) + cbit * 8
    np.testing.assert_array_equal(got, x + y)


def test_gates_over_a_schoolbook_key_equal_the_ntt_key(env):
    """GateSet runs over any device key: the forced-schoolbook key gives the
    NTT key's ciphertexts."""
    sk, g, _ = env
    _, cloud = kg.keygen(P, seed=21)
    gs = GateSet(bs.prepare_cloud_key(cloud, device="cpu", schoolbook=True))
    assert gs.dkey.ntt_flavor == "schoolbook"
    (ca, _), (cb, _) = _enc(sk, [0, 1, 1, 0]), _enc(sk, [1, 1, 0, 0])
    for name in ("AND", "XOR"):
        assert torch.equal(getattr(gs, name)(ca, cb), getattr(g, name)(ca, cb))


@pytest.mark.parametrize("msize", [2, 8, 4096])
def test_lwe_decrypt_and_noiseless_trivial_equal_jax(msize):
    rng = np.random.default_rng(msize)
    key = lwe.lwe_key_gen(rng, P.n)
    mu = rng.integers(-2**31, 2**31, size=(3, 5), dtype=np.int64).astype(np.int32)
    mu[0, :3] = [-2**31, 2**31 - 1, 0]
    ct = lwe.lwe_encrypt(key, mu, 2.0**-20, rng)
    got = lwe.lwe_decrypt(key, ct, msize)
    np.testing.assert_array_equal(got, jlwe.lwe_decrypt(key, ct, msize))
    assert got.min() >= 0 and got.max() < msize
    triv = lwe.lwe_noiseless_trivial(mu, P.n)
    np.testing.assert_array_equal(triv, jlwe.lwe_noiseless_trivial(mu, P.n))
    assert triv.shape == (3, 5, P.n + 1) and triv.dtype == np.int32
    np.testing.assert_array_equal(lwe.lwe_phase(key, triv), mu)  # (0, mu) decrypts to mu
