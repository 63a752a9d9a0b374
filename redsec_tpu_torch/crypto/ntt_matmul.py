"""Four-step NTT as matrix products — the JAX package's ``ntt_matmul``.

The four-step factorization N = R*C turns the negacyclic transform into

    pre-twist (psi^j)  ->  C-many NTT_R (a product with a constant [R, R]
    matrix over rows)  ->  twiddle w^(j2*k1)  ->  R-many NTT_C (a product with
    a constant [C, C] matrix over columns)

and the inverse into the same steps backwards.  The JAX package runs the two
products on the TPU's matrix unit as bf16 products of 8-bit limbs with fp32
accumulation; here they are fp32 ``torch.matmul``s of the same 8-bit limbs
(every limb is an integer in [0, 255], every partial sum at most
C * 255 * 255 < 2^24, so fp32 holds every sum exactly in any order; TF32,
which would drop those bits, is switched off on CUDA).  Both are plain matrix
products outside any Pallas kernel in the JAX package, so they stay torch
matmuls here.

Output order is the four-step [k1, k2] matrix order, not the radix-2
bit-reversed order of ``ntt.ntt_device``: a key prepared with these
transforms (flavour ``"matmul"``, ``bootstrap.prepare_cloud_key``) is held in
that order, and only these transforms may meet it.  The inverse consumes that
order and emits natural order.  The order is the JAX package's, so the
NTT-domain tensors of either package compare equal.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .ntt import NttPlan, _mulmod_device, _reduce_int32


def _split_rc(N: int) -> Tuple[int, int]:
    """N = R * C with C = 128 when N >= 256 (the JAX package's split, chosen
    for the TPU's 128 lanes; kept so both packages' NTT-domain orders
    agree)."""
    C = 128 if N >= 256 else max(16, N // 16)
    return N // C, C


def supported(N: int) -> bool:
    R, C = _split_rc(N)
    return R * C == N and R >= 2


@functools.lru_cache(maxsize=None)
def _mm_tables(N: int, p: int, psi: int) -> dict:
    """Four-step tables mod p for the primitive 2N-th root ``psi`` (numpy
    int64): the [R, R] and [C, C] DFT matrices and their inverses, the
    twiddles w^(k1*j2) and their inverses, the pre-twist psi^j and the
    post-untwist psi^-j / N, each [R, C] in row-major j = j1*C + j2."""
    w = psi * psi % p  # primitive N-th root
    R, C = _split_rc(N)
    wR, wC = pow(w, C, p), pow(w, R, p)  # orders R and C

    def mat(root: int, dim: int, inv: bool = False) -> np.ndarray:
        e = np.arange(dim)
        base = pow(root, p - 2, p) if inv else root
        vals = [1]
        for _ in range(1, dim):
            vals.append(vals[-1] * base % p)
        return np.array(vals, dtype=np.int64)[np.outer(e, e) % dim]

    jflat = np.arange(R)[:, None] * C + np.arange(C)[None, :]
    psi_pows = np.array([pow(psi, int(j), p) for j in range(N)], dtype=np.int64)
    psi_inv = pow(psi, 2 * N - 1, p)
    psin_pows = np.array([pow(psi_inv, int(j), p) for j in range(N)], dtype=np.int64)
    ninv = pow(N, p - 2, p)
    w_inv = pow(w, p - 2, p)
    k1j2 = np.arange(R)[:, None] * np.arange(C)[None, :]
    tw = np.array([pow(w, int(e), p) for e in k1j2.reshape(-1)], dtype=np.int64).reshape(R, C)
    twi = np.array([pow(w_inv, int(e), p) for e in k1j2.reshape(-1)],
                   dtype=np.int64).reshape(R, C)
    return {"R": R, "C": C, "WR": mat(wR, R), "WC": mat(wC, C), "WRi": mat(wR, R, True),
            "WCi": mat(wC, C, True), "TW": tw, "TWi": twi, "twist": psi_pows[jflat],
            "untwist": (psin_pows[jflat] * ninv) % p}


_DEVICE_TABLES: dict = {}


def tables(plan: NttPlan, pi: int, device) -> dict:
    """The four-step tables of ``plan``'s prime ``pi`` on ``device``: the
    pointwise ones as int32 [R, C], each matrix as fp32 limb stacks (``"WR"``
    [2R, R] = [lo; hi] for products from the left, ``"WC"`` [C, 2C] =
    [lo | hi] for products from the right).  Built once per (N, prime,
    device); psi is read from the plan's twist table (twist[1] = psi)."""
    p = plan.primes[pi]
    key = (plan.N, p, str(device))
    if key not in _DEVICE_TABLES:
        t = _mm_tables(plan.N, p, int(plan.twist[pi][1]))

        def i32(a):
            return torch.as_tensor(a.astype(np.int32), device=device)

        def limbs(a, dim):
            return torch.as_tensor(np.concatenate([a & 255, a >> 8], axis=dim).astype(np.float32),
                                   device=device)

        _DEVICE_TABLES[key] = {
            "R": t["R"], "C": t["C"],
            "twist": i32(t["twist"]), "untwist": i32(t["untwist"]),
            "TW": i32(t["TW"]), "TWi": i32(t["TWi"]),
            "WR": limbs(t["WR"], 0), "WRi": limbs(t["WRi"], 0),
            "WC": limbs(t["WC"], 1), "WCi": limbs(t["WCi"], 1),
        }
    return _DEVICE_TABLES[key]


def _recombine(p00, p01, p10, p11, p: int) -> torch.Tensor:
    """lo*lo + 2^8 (lo*hi + hi*lo) + 2^16 hi*hi mod p from the four exact
    limb products (int32), each reduced before a shift could overflow."""
    r_mid = _reduce_int32(p01 + p10, p)
    r_hi = _reduce_int32(p11, p)
    # r_hi * 2^16 may exceed int32 for p > 2^15: fold the shift into a mulmod
    r_hi_t = _mulmod_device(r_hi, torch.full_like(r_hi, (1 << 16) % p), p)
    return _reduce_int32(p00 + (r_mid << 8) + r_hi_t, p)


def _data_limbs(data: torch.Tensor) -> torch.Tensor:
    """int32 [..., R, C] in [0, 2^16) -> fp32 [2, ..., R, C]: low and high
    bytes."""
    if data.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    return torch.stack([data & 255, data >> 8]).to(torch.float32)


def _matmul_left(data: torch.Tensor, w: torch.Tensor, p: int) -> torch.Tensor:
    """out[.., i, c] = sum_j W[i, j] * data[.., j, c] mod p, for data int32
    [B, R, C] in [0, p) and ``w`` the [2R, R] limb stack of W."""
    R = w.shape[1]
    prod = torch.matmul(w, _data_limbs(data)).to(torch.int32)  # [2, B, 2R, C]
    # prod[d, :, wl*R + i]: weight limb wl times data limb d
    return _recombine(prod[0, :, :R], prod[1, :, :R], prod[0, :, R:], prod[1, :, R:], p)


def _matmul_right(data: torch.Tensor, w: torch.Tensor, p: int) -> torch.Tensor:
    """out[.., r, k] = sum_j data[.., r, j] * W[j, k] mod p, for data int32
    [B, R, C] in [0, p) and ``w`` the [C, 2C] limb stack of W."""
    C = w.shape[0]
    prod = torch.matmul(_data_limbs(data), w).to(torch.int32)  # [2, B, R, 2C]
    return _recombine(prod[0, ..., :C], prod[1, ..., :C], prod[0, ..., C:], prod[1, ..., C:], p)


def ntt_device_mm(x: torch.Tensor, plan: NttPlan, pi: int) -> torch.Tensor:
    """Negacyclic forward NTT (four-step order); x int32 [..., N] in [0, p)."""
    p = plan.primes[pi]
    t = tables(plan, pi, x.device)
    m = x.reshape(-1, t["R"], t["C"])
    m = _mulmod_device(m, t["twist"][None], p)
    a = _matmul_left(m, t["WR"], p)  # [B, k1, j2]
    a = _mulmod_device(a, t["TW"][None], p)
    return _matmul_right(a, t["WC"], p).reshape(x.shape)  # [B, k1, k2]


def intt_device_mm(y: torch.Tensor, plan: NttPlan, pi: int) -> torch.Tensor:
    """Inverse (consumes four-step order, emits natural coefficient order)."""
    p = plan.primes[pi]
    t = tables(plan, pi, y.device)
    m = y.reshape(-1, t["R"], t["C"])  # [B, k1, k2]
    b = _matmul_right(m, t["WCi"], p)  # sum over k2 -> [B, k1, j2]
    b = _mulmod_device(b, t["TWi"][None], p)
    x = _matmul_left(b, t["WRi"], p)  # sum over k1 -> [B, j1, j2]
    return _mulmod_device(x, t["untwist"][None], p).reshape(y.shape)


# --------------------------------------------------------------------------- #
# Tables of the four-step blind-rotation kernels (csrc/blind_mm.cu)           #
# --------------------------------------------------------------------------- #

MM_C = 128  # the kernels' column count (the split of every N they take)


def _brv(k: int, bits: int) -> int:
    """k with its low ``bits`` bits reversed."""
    return int(format(k, f"0{bits}b")[::-1], 2) if bits else 0


def _shoup(w: np.ndarray, p: int) -> np.ndarray:
    """uint32 [..., 2] pairs (w, floor(w * 2^32 / p)) for residues w."""
    w = np.asarray(w, np.uint64) % np.uint64(p)
    return np.stack([w, (w << np.uint64(32)) // np.uint64(p)], axis=-1).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def kernel_tables_mm_host(N: int, p: int, psi: int) -> dict:
    """The tables ``csrc/blind_mm.cu`` reads for one prime, in numpy, built
    from ``_mm_tables`` (JAX's ``_round_tables`` without bf16, with the folds
    the kernel makes):

    ``"wc"``: uint8 [2, C, C], WC's low 8 bits and high 7 bits (WC is
    symmetric; the inverse multiplies by WC too, on its input columns
    reversed, since WCi[k2] = WC[-k2 mod C]).
    ``"tw"``: uint32 [2 R C + 2 R, 2] Shoup pairs: TWf = TW psi^j2 [R, C], then
    TWi' = TWi psi^-j2 / N [R, C], then the forward R-point negacyclic NTT's
    twiddles psi_R^brv(k) and the inverse's psi_R^-brv(k), k < R (entry 0 of
    each 0), psi_R = psi^C: the pre-twist psi^(C j1) and the [R, R] DFT of
    the JAX formulation are that R-point NTT, the rest of the twist and the
    untwist ride on the twiddles."""
    t = _mm_tables(N, p, psi)
    R, C = t["R"], t["C"]
    assert C == MM_C, "the kernels take the (R, 128) split"
    lg = R.bit_length() - 1
    pj = np.array([pow(psi, j, p) for j in range(C)], np.int64)
    pji = np.array([pow(psi, 2 * N - j, p) for j in range(C)], np.int64)
    twf = t["TW"] * pj[None] % p
    twi = t["TWi"] * pji[None] % p * pow(N, p - 2, p) % p
    psi_r = pow(psi, C, p)
    psi_ri = pow(psi_r, p - 2, p)
    psf = [0] + [pow(psi_r, _brv(k, lg), p) for k in range(1, R)]
    psv = [0] + [pow(psi_ri, _brv(k, lg), p) for k in range(1, R)]
    tw = np.concatenate([twf.reshape(-1), twi.reshape(-1), psf, psv]).astype(np.int64)
    pairs = _shoup(tw, p)
    pairs[2 * R * C] = pairs[2 * R * C + R] = 0
    wc = t["WC"].astype(np.int64)
    return {"R": R, "wc": np.stack([wc & 255, wc >> 8]).astype(np.uint8), "tw": pairs}


_KERNEL_TABLES: dict = {}


def kernel_tables_mm(plan: NttPlan, device: torch.device) -> dict:
    """``kernel_tables_mm_host`` of every prime of ``plan`` on ``device``:
    ``"tw"`` int32 [P, 2 R C + 2 R, 2] (bit patterns of the uint32 pairs) and
    ``"wc"`` uint8 [P, 2, C, C]; built once per plan and device and kept
    under (N, primes, device)."""
    tabs = _KERNEL_TABLES.get((plan.N, plan.primes, device))
    if tabs is None:
        host = [kernel_tables_mm_host(plan.N, p, int(plan.twist[pi][1]))
                for pi, p in enumerate(plan.primes)]
        tabs = _KERNEL_TABLES[plan.N, plan.primes, device] = {
            "tw": torch.as_tensor(np.stack([h["tw"] for h in host]).view(np.int32), device=device),
            "wc": torch.as_tensor(np.stack([h["wc"] for h in host]), device=device),
        }
    return tabs
