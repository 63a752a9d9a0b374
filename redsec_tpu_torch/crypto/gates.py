"""Bootstrapped boolean gate library — the reference's TFHE gate surface.

A copy of the JAX package's ``crypto/gates.py`` over the port's PBS.  The
reference's Ops layer exposes TFHE's bootstrapped gates
(bootsAND/OR/NAND/NOR/XOR/XNOR/NOT/COPY/MUX, used by the legacy ripple-carry
adder at lib/BinOps_enc.cpp:55-119 and relu at lib/IntOps_enc.cpp:58-65).
These operate in the *gate encoding*: TRUE = +1/8, FALSE = -1/8.

Every 2-input gate is one bootstrap of a leveled combination:
``result = sign_bootstrap(c1*a + c2*b + offset)`` with the standard TFHE
constants; NOT/COPY are leveled (free).  All functions are batched: inputs
are int32 ciphertext tensors ``[..., n+1]`` on the key's device, and any
``DeviceCloudKey`` serves, NTT or schoolbook.
"""

from __future__ import annotations

import numpy as np
import torch

from .bootstrap import DeviceCloudKey, make_batched_bootstrap
from .params import TfheParams
from .torus import mod_switch_to_torus32

GATE_SPACE = 8  # mu = 1/8: TFHE's gate message encoding


def gate_encrypt_host(key, bits, params: TfheParams, rng):
    """Client-side helper: encrypt booleans in the gate encoding."""
    from .lwe import lwe_encrypt

    mu = np.where(np.asarray(bits) != 0, 1, -1)
    return lwe_encrypt(key, mod_switch_to_torus32(mu, GATE_SPACE), params.alpha_enc, rng)


def gate_decrypt_host(key, ct, params: TfheParams):
    from .lwe import lwe_decrypt_signed

    return (lwe_decrypt_signed(key, ct, GATE_SPACE) > 0).astype(np.int8)


class GateSet:
    """Batched bootstrapped gates over a device cloud key."""

    def __init__(self, dkey: DeviceCloudKey):
        self.dkey = dkey
        self.params = dkey.params
        self._pbs = make_batched_bootstrap(dkey)
        mu = int(mod_switch_to_torus32(1, GATE_SPACE))
        self._tv = torch.full((dkey.params.N,), mu, dtype=torch.int32, device=dkey.device)
        self._mu = mu

    def _boot(self, combo):
        shape = combo.shape
        out = self._pbs(combo.reshape(-1, shape[-1]), self._tv)
        return out.reshape(shape)

    def _offset(self, num, den=8):
        return int(mod_switch_to_torus32(num, den))

    def _biased(self, x, num, den=8):
        out = x.clone()
        out[..., -1] += self._offset(num, den)
        return out

    # --- leveled (free) ---
    def NOT(self, a):
        return -a

    def COPY(self, a):
        return a

    def CONSTANT(self, val, like):
        out = torch.zeros_like(like)
        out[..., -1] = self._mu if val else -self._mu
        return out

    # --- one bootstrap each (constants from TFHE v1.1 boot-gates) ---
    def AND(self, a, b):
        return self._boot(self._biased(a + b, -1))

    def OR(self, a, b):
        return self._boot(self._biased(a + b, 1))

    def NAND(self, a, b):
        return self._boot(self._biased(-(a + b), 1))

    def NOR(self, a, b):
        return self._boot(self._biased(-(a + b), -1))

    def XOR(self, a, b):
        return self._boot(self._biased(2 * (a + b), 2, 8))

    def XNOR(self, a, b):
        return self._boot(self._biased(-2 * (a + b), -2, 8))

    def ANDNY(self, a, b):  # not(a) and b
        return self._boot(self._biased(b - a, -1))

    def ANDYN(self, a, b):  # a and not(b)
        return self._boot(self._biased(a - b, -1))

    def ORNY(self, a, b):  # not(a) or b
        return self._boot(self._biased(b - a, 1))

    def ORYN(self, a, b):  # a or not(b)
        return self._boot(self._biased(a - b, 1))

    def MUX(self, sel, a, b):
        """sel ? a : b — two bootstraps + one leveled add (TFHE bootsMUX)."""
        t1 = self._boot(self._biased(sel + a, -1))  # sel AND a
        t0 = self._boot(self._biased(b - sel, -1))  # (not sel) AND b
        return self._boot(self._biased(t1 + t0, 1))

    # --- multi-bit ripple-carry adder (legacy BinOps::add, BinOps_enc.cpp:55-119)
    def ripple_add(self, a_bits, b_bits):
        """[..., nbits, n+1] LSB-first addition, returns same width + carry."""
        nbits = a_bits.shape[-2]
        carry = self.CONSTANT(False, a_bits[..., 0, :])
        outs = []
        for i in range(nbits):
            ai, bi = a_bits[..., i, :], b_bits[..., i, :]
            s1 = self.XOR(ai, bi)
            outs.append(self.XOR(s1, carry))
            c1 = self.AND(carry, s1)
            c2 = self.AND(ai, bi)
            carry = self.OR(c1, c2)
        return torch.stack(outs, dim=-2), carry
