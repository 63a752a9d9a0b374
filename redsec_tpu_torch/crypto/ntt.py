"""Exact negacyclic NTT over small CRT primes.

Negacyclic convolutions over Z[X]/(X^N+1) are computed modulo a few
15/16-bit NTT-friendly primes and recombined by CRT, so every PBS output is
an exact function of its inputs, bit-identical to the JAX package whatever
the transform order.  The torch functions below (int32 with an fp32
reciprocal for the modular reduction, see ``_mulmod_device``, or int32
remainders inside the butterflies) are the plain PyTorch twin of the NTT
kernel ``ntt_fwd``/``ntt_inv`` in ``csrc/pbs.cu`` (bound in
``crypto/kernels.py``).

Layout conventions
------------------
- Forward transform is decimation-in-frequency (natural order in, bit-reversed
  order out); inverse is decimation-in-time (bit-reversed in, natural out), so
  no bit-reversal permutations are ever materialized — pointwise products in
  the bit-reversed domain are order-agnostic.
- Negacyclic twist: ``x_j * psi^j`` before the forward transform and
  ``psi^-j / N`` after the inverse, with psi a primitive 2N-th root mod p.

Primes: p ≡ 1 (mod 2N) with p < 46341 so every butterfly product fits in
int32.  For N ≤ 1024 exactly three exist: 12289, 18433, 40961 — two cover the
Bg=2^3 decomposition (small_v2), all three cover Bg=2^10 (small).  N >= 4096
(medium/large parameter sets) has no usable primes in this range; the JAX
package runs those sets through a schoolbook external product, which the
port does not have yet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

# Candidate primes, ascending: smaller primes leave int32 headroom for lazy
# accumulation of raw products in the external-product pointwise stage
# (floor((2^31-1)/(p-1)^2) products can be summed before a reduction).
_CANDIDATE_PRIMES = (12289, 18433, 40961)


def _factorize(m: int):
    fs, d = set(), 2
    while d * d <= m:
        while m % d == 0:
            fs.add(d)
            m //= d
        d += 1
    if m > 1:
        fs.add(m)
    return fs


def _primitive_root(p: int) -> int:
    order = p - 1
    factors = _factorize(order)
    for g in range(2, p):
        if all(pow(g, order // q, p) != 1 for q in factors):
            return g
    raise ValueError(f"no primitive root for {p}")


def primes_for(N: int, max_operand: int, limb_bits: int, accum: int = 1,
               balanced: bool = False) -> Tuple[int, ...]:
    """Choose the minimal prime set whose product covers the exact convolution.

    A SUM of ``accum`` digit-poly x limb-poly products (the TGSW external
    product accumulates all (k+1)*l rows in the NTT domain before leaving it)
    has coefficients bounded by ``accum * N * max_operand * limb_max``
    in absolute value; the CRT modulus must exceed twice that (signed range).
    ``balanced`` limbs (sign-balanced int8, |limb| <= 2^(limb_bits-1)) halve
    the bound vs unsigned limbs — that headroom is what lets the 2-bit
    bundled blind rotation accumulate 3*rows products in the same 2-prime
    plan (bootstrap.prepare_cloud_key).
    """
    limb_max = (1 << (limb_bits - 1)) if balanced else ((1 << limb_bits) - 1)
    bound = 2 * accum * N * max_operand * limb_max
    usable = [p for p in _CANDIDATE_PRIMES if (p - 1) % (2 * N) == 0]
    prod, chosen = 1, []
    for p in usable:
        chosen.append(p)
        prod *= p
        if prod > bound:
            return tuple(chosen)
    raise ValueError(f"cannot cover bound {bound} for N={N} with primes {usable}")


@dataclasses.dataclass(frozen=True)
class NttPlan:
    """Per-(N, prime-set) precomputed tables.  Numpy tables; device functions
    close over them as constants."""

    N: int
    primes: Tuple[int, ...]
    limb_bits: int
    # per prime: psi twiddle [N], psi^-1/N [N], fwd stage tables, inv stage tables
    twist: Tuple[np.ndarray, ...]
    untwist: Tuple[np.ndarray, ...]
    fwd_tabs: Tuple[Tuple[np.ndarray, ...], ...]
    inv_tabs: Tuple[Tuple[np.ndarray, ...], ...]
    # CRT mixed-radix constants
    crt_inv: Tuple[int, ...]  # inv(prod(p_0..p_{i-1})) mod p_i
    crt_shift_mod232: Tuple[int, ...]  # prod(p_0..p_{i-1}) mod 2^32 (int32)
    prod_mod232: int  # prod(all) mod 2^32 (int32)


@functools.lru_cache(maxsize=None)
def make_plan(N: int, max_operand: int, limb_bits: int = 16, accum: int = 1,
              balanced: bool = False) -> NttPlan:
    primes = primes_for(N, max_operand, limb_bits, accum, balanced)
    stages = N.bit_length() - 1
    twist, untwist, fwd_tabs, inv_tabs = [], [], [], []
    for p in primes:
        g = _primitive_root(p)
        psi = pow(g, (p - 1) // (2 * N), p)  # primitive 2N-th root
        w = (psi * psi) % p  # primitive N-th root
        j = np.arange(N, dtype=np.int64)
        twist.append(np.array([pow(psi, int(i), p) for i in range(N)], dtype=np.int64))
        ninv = pow(N, p - 2, p)
        untwist.append(
            np.array([pow(psi, -int(i) % (2 * N), p) * ninv % p for i in range(N)],
                     dtype=np.int64)
        )
        fs, isv = [], []
        for s in range(stages):
            h = N >> (s + 1)  # fwd stage s: m=2^s groups, half h
            wf = pow(w, 1 << s, p)  # root of order 2h
            fs.append(np.array([pow(wf, i, p) for i in range(h)], dtype=np.int64))
            hh = 1 << s  # inv stage s: half hh
            wi = pow(w, -(N >> (s + 1)) % (p - 1), p)  # (w^{N/2h})^-1, order 2hh
            isv.append(np.array([pow(wi, i, p) for i in range(hh)], dtype=np.int64))
        fwd_tabs.append(tuple(fs))
        inv_tabs.append(tuple(isv))

    crt_inv, crt_shift = [], []
    prod = 1
    for p in primes:
        crt_inv.append(pow(prod % p, p - 2, p) if prod % p else 0)
        crt_shift.append(_to_i32(prod))
        prod *= p
    return NttPlan(
        N=N,
        primes=primes,
        limb_bits=limb_bits,
        twist=tuple(twist),
        untwist=tuple(untwist),
        fwd_tabs=tuple(fwd_tabs),
        inv_tabs=tuple(inv_tabs),
        crt_inv=tuple(crt_inv),
        crt_shift_mod232=tuple(crt_shift),
        prod_mod232=_to_i32(prod),
    )


def _to_i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


# --------------------------------------------------------------------------- #
# Host (numpy, int64) — used for key preparation and as the test oracle       #
# --------------------------------------------------------------------------- #


def _mulmod_host(a: np.ndarray, b: np.ndarray, p: int) -> np.ndarray:
    """(a*b) mod p for int64 a,b in [0,p), p < 2^16 — float64 reciprocal is
    ~4x faster than numpy's int64 ``%`` and exact after one correction."""
    prod = a * b
    q = np.floor(prod.astype(np.float64) * (1.0 / p)).astype(np.int64)
    r = prod - q * p
    r = np.where(r < 0, r + p, r)
    return np.where(r >= p, r - p, r)


def _cond_sub(x: np.ndarray, p: int) -> np.ndarray:
    return np.where(x >= p, x - p, x)


def ntt_host(x: np.ndarray, plan: NttPlan, pi: int) -> np.ndarray:
    """Negacyclic forward NTT mod plan.primes[pi]; x int64 [..., N] -> bit-rev order."""
    p = plan.primes[pi]
    arr = _mulmod_host(np.asarray(x, dtype=np.int64) % p, plan.twist[pi], p)
    N = plan.N
    stages = N.bit_length() - 1
    for s in range(stages):
        m, h = 1 << s, N >> (s + 1)
        v = arr.reshape(*arr.shape[:-1], m, 2, h)
        a, b = v[..., 0, :], v[..., 1, :]
        arr = np.stack(
            [_cond_sub(a + b, p), _mulmod_host(a - b + p, plan.fwd_tabs[pi][s], p)],
            axis=-2,
        )
        arr = arr.reshape(*arr.shape[:-3], N)
    return arr


def intt_host(y: np.ndarray, plan: NttPlan, pi: int) -> np.ndarray:
    p = plan.primes[pi]
    N = plan.N
    arr = np.asarray(y, dtype=np.int64) % p
    stages = N.bit_length() - 1
    for s in range(stages):
        m, h = N >> (s + 1), 1 << s
        v = arr.reshape(*arr.shape[:-1], m, 2, h)
        a, b = v[..., 0, :], v[..., 1, :]
        t = _mulmod_host(b, plan.inv_tabs[pi][s], p)
        arr = np.concatenate([_cond_sub(a + t, p), a - t + p], axis=-1)
        arr[..., h:] = _cond_sub(arr[..., h:], p)
        arr = arr.reshape(*arr.shape[:-2], N)
    return _mulmod_host(arr, plan.untwist[pi], p)


def negacyclic_mul_host(a: np.ndarray, b: np.ndarray, N: int) -> np.ndarray:
    """Schoolbook negacyclic product mod 2^32 (int64 exact) — the slow oracle."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    out = np.zeros(a.shape[:-1] + (N,), dtype=np.int64)
    for i in range(N):
        ai = a[..., i : i + 1]
        out[..., i:] += ai * b[..., : N - i]
        out[..., : i] -= ai * b[..., N - i :]
    return out.astype(np.uint64).astype(np.uint32).astype(np.int32)


# --------------------------------------------------------------------------- #
# Torch (int32-only arithmetic): the plain twin of the NTT kernel             #
# --------------------------------------------------------------------------- #

_TABLES: dict = {}


def device_tables(plan: NttPlan, pi: int, device) -> dict:
    """Per-(N, prime, device) int32 twiddle tensors, built once."""
    key = (plan.N, plan.primes[pi], str(device))
    if key not in _TABLES:
        def t(a):
            return torch.as_tensor(np.asarray(a, np.int64).astype(np.int32), device=device)

        _TABLES[key] = {
            "twist": t(plan.twist[pi]),
            "untwist": t(plan.untwist[pi]),
            "fwd": [t(w) for w in plan.fwd_tabs[pi]],
            "inv": [t(w) for w in plan.inv_tabs[pi]],
        }
    return _TABLES[key]


def _mulmod_device(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """(a*b) mod p with int32 a,b in [0,p), p < 46341, using int32 + fp32
    reciprocal.  The int32 product is exact (< 2^31).  The fp32 quotient
    estimate is off by at most 1 either way, so two conditional corrections
    land r in [0, p)."""
    prod = a * b
    q = torch.floor(a.to(torch.float32) * b.to(torch.float32) * (1.0 / p))
    r = prod - q.to(torch.int32) * p
    r = torch.where(r < 0, r + p, r)
    return torch.where(r >= p, r - p, r)


def _reduce_int32(x: torch.Tensor, p: int) -> torch.Tensor:
    """Reduce any int32 x in [0, 2^31) to [0, p): the fp32 quotient estimate
    is off by at most 1, fixed by two conditional corrections; q*p may wrap
    int32 but x - q*p is still exact."""
    q = torch.floor(x.to(torch.float32) * (1.0 / p)).to(torch.int32)
    r = x - q * p
    r = torch.where(r < 0, r + p, r)
    return torch.where(r >= p, r - p, r)


# The butterflies below reduce with ``%`` (torch's remainder, non-negative for
# a positive modulus) in int32: every operand is in (-p, p) and every product
# below 2^30, so the residues equal the JAX package's int32 + fp32 steps at a
# third of the tensor operations, which is what the plain path's time is
# made of.


def ntt_device(x: torch.Tensor, plan: NttPlan, pi: int) -> torch.Tensor:
    """Forward negacyclic NTT (decimation in frequency); x int32 [..., N] in
    [0, p) -> int32 residues in bit-reversed order (= the JAX package's
    ``ntt_device``)."""
    p, N = plan.primes[pi], plan.N
    tab = device_tables(plan, pi, x.device)
    arr = x * tab["twist"] % p
    lead = x.shape[:-1]
    for s in range(N.bit_length() - 1):
        m, h = 1 << s, N >> (s + 1)
        v = arr.reshape(*lead, m, 2, h)
        a, b = v[..., 0, :], v[..., 1, :]
        arr = torch.stack([(a + b) % p, (a - b) * tab["fwd"][s] % p],
                          dim=-2).reshape(*lead, N)
    return arr


def intt_device(y: torch.Tensor, plan: NttPlan, pi: int) -> torch.Tensor:
    """Inverse of ``ntt_device`` (decimation in time, bit-reversed in, natural
    out, with the psi^-j / N untwist)."""
    p, N = plan.primes[pi], plan.N
    tab = device_tables(plan, pi, y.device)
    arr = y
    lead = y.shape[:-1]
    for s in range(N.bit_length() - 1):
        m, h = N >> (s + 1), 1 << s
        v = arr.reshape(*lead, m, 2, h)
        a = v[..., 0, :]
        t = v[..., 1, :] * tab["inv"][s] % p
        arr = torch.cat([(a + t) % p, (a - t) % p], dim=-1).reshape(*lead, N)
    return arr * tab["untwist"] % p


def crt_to_torus32(residues, plan: NttPlan) -> torch.Tensor:
    """CRT-recombine per-prime residues into the signed value mod 2^32.

    ``residues``: list over primes of int32 [..., N] in [0, p_i).  Mixed-radix
    (Garner) digits come from int32 mulmods; the recombination is taken mod
    2^32 (int32 wraparound multiplies), with the sign decided by an fp32
    estimate of x/P — exact because |value| <= bound/2 < 0.36*P by
    construction of ``primes_for``.
    """
    primes = plan.primes
    digits = [residues[0]]
    for i in range(1, len(primes)):
        p = primes[i]
        xm = _reduce_int32(digits[0], p)
        mult = 1
        for j in range(1, i):
            mult = (mult * primes[j - 1]) % p
            term = _mulmod_device(digits[j], torch.full_like(digits[j], mult), p)
            xm = _reduce_int32(xm + term, p)
        diff = residues[i] - xm
        diff = torch.where(diff < 0, diff + p, diff)
        digits.append(_mulmod_device(diff, torch.full_like(diff, plan.crt_inv[i]), p))
    out = digits[0]
    for i in range(1, len(primes)):
        out = out + digits[i] * plan.crt_shift_mod232[i]
    suffix = [1.0] * (len(primes) + 1)
    for j in range(len(primes) - 1, -1, -1):
        suffix[j] = suffix[j + 1] * float(primes[j])
    frac = digits[0].to(torch.float32) * float(np.float32(1.0 / suffix[0]))
    for j in range(1, len(primes)):
        frac = frac + digits[j].to(torch.float32) * float(np.float32(1.0 / suffix[j]))
    neg = frac >= 0.5
    return out - torch.where(neg, plan.prod_mod232, 0).to(torch.int32)
