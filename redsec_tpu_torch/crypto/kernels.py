"""The blind-rotation kernels: ctypes loader, wrappers and plain twins.

Four CUDA kernels for ``sm_90a`` live in ``csrc/pbs.cu`` (design notes and
the TPU kernel each replaces are at its top):

============================  ==============================================
wrapper                       replaces (JAX package)
============================  ==============================================
``ntt``                       ``crypto/pallas_ntt.py::ntt_pallas``
``external_product``          ``crypto/pallas_round.py::make_round_kernel``
``cmux_round``                ``crypto/pallas_round.py::make_full_round_kernel``
``blind_rotate``              ``crypto/pallas_blind.py::make_blind_rotate_kernel``
============================  ==============================================

Each wrapper takes the plain PyTorch twin (``*_plain``, same function, built
from ``ntt``'s torch transform and ``bootstrap.RoundOps``) only because its
tensor lies on the CPU.  On a CUDA tensor it checks device, dtype, shape and
contiguity, allocates the output with ``torch.empty``, launches on the
current stream, raises on a non-zero ``cudaGetLastError()``, and adds one to
its count in ``device.launches``.  Nothing falls back to the twin.

The shared library is built with ``nvcc`` into ``build/kernels/`` at the
root of the checkout on first use (``build_library``, shared with
``probe_kernels.py``); importing this module needs no compiler.  The
NTT-domain order of every key tensor these take is the radix-2 bit-reversed
order of ``ntt.ntt_device`` (flavour "radix2").
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np
import torch

from ..device import launches
from . import bootstrap as bs
from . import ntt as ntt_mod
from .params import TfheParams

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "pbs.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
KERNEL_N = (256, 512, 1024)  # N the kernels are instantiated for


def _plan_ok(plan: ntt_mod.NttPlan) -> bool:
    return (len(plan.primes) == 2 and all(p < (1 << 15) for p in plan.primes)
            and plan.N in KERNEL_N)


def supported(params: TfheParams, plan: ntt_mod.NttPlan) -> bool:
    """Whether the CUDA kernels take this parameter set and NTT plan: two
    primes below 2^15 (residues fit int16, products fit uint32) and an N they
    are instantiated for (one thread per butterfly, N/2 threads a block)."""
    return _plan_ok(plan) and params.l * params.bg_bit <= 32


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin")
    return path


def library_path(source: str) -> str:
    """Where the shared library of ``csrc/<stem>.cu`` is built."""
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"libredsec_{stem}.so")


def build_library(source: str) -> str:
    """Compile one CUDA source into its ``library_path`` unless that is up to
    date.  Returns the compiler's messages (``-Xptxas -v``: registers, shared
    memory, spills per kernel), empty when nothing was built.  Raises with
    the compiler's output if nvcc fails."""
    lib = library_path(source)
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(source):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) on {source}:\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib)
    return res.stdout + res.stderr


class Library:
    """A built and loaded shared library of one CUDA source.  ``entries`` maps
    each C function's name to its argtypes; every entry returns the
    ``cudaGetLastError()`` of its launch, and the source exports
    ``redsec_error_string``."""

    def __init__(self, source: str, entries: dict):
        build_library(source)
        lib = ctypes.CDLL(library_path(source))
        lib.redsec_error_string.argtypes = [ctypes.c_int]
        lib.redsec_error_string.restype = ctypes.c_char_p
        for name, argtypes in entries.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.lib = lib

    def check(self, name: str, code: int) -> None:
        if code != 0:
            msg = self.lib.redsec_error_string(code).decode()
            raise RuntimeError(f"CUDA kernel {name} failed: {msg} ({code})")


_P, _I, _L, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
_ENTRIES = {
    "redsec_ntt": [_P, _P, _P, _I, _I, _I, _I, _P],
    "redsec_external_product": [_P, _P, _L, _P, _P, _I, _I, _I, _I, _I, _P],
    "redsec_cmux_round": [_P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _U, _I, _I, _P],
    "redsec_blind_rotate": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _I, _I, _P],
}
_loaded: list[Library] = []


def _lib() -> Library:
    if not _loaded:
        _loaded.append(Library(SOURCE, _ENTRIES))
    return _loaded[0]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
             device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _require_cuda_plan(plan: ntt_mod.NttPlan) -> None:
    if not _plan_ok(plan):
        raise ValueError(f"CUDA kernels take 2 primes < 2^15 and N in {KERNEL_N}; "
                         f"got primes {plan.primes}, N={plan.N}")


_TABLES: dict = {}


def kernel_tables(plan: ntt_mod.NttPlan, device) -> torch.Tensor:
    """int32 [P, 4, N] twiddles in the kernels' layout: twist, forward stage
    tables concatenated (stage s at N - (N >> s)), untwist, inverse stage
    tables concatenated (stage s at 2^s - 1)."""
    key = (plan.N, plan.primes, str(device))
    if key not in _TABLES:
        N = plan.N
        out = np.zeros((len(plan.primes), 4, N), np.int64)
        for pi in range(len(plan.primes)):
            out[pi, 0] = plan.twist[pi]
            out[pi, 1, :N - 1] = np.concatenate(plan.fwd_tabs[pi])
            out[pi, 2] = plan.untwist[pi]
            out[pi, 3, :N - 1] = np.concatenate(plan.inv_tabs[pi])
        _TABLES[key] = torch.as_tensor(out.astype(np.int32), device=device)
    return _TABLES[key]


# --------------------------------------------------------------------------- #
# K1: NTT                                                                     #
# --------------------------------------------------------------------------- #


def ntt_plain(x: torch.Tensor, plan: ntt_mod.NttPlan, pi: int,
              inverse: bool = False) -> torch.Tensor:
    return (ntt_mod.intt_device if inverse else ntt_mod.ntt_device)(x, plan, pi)


def ntt(x: torch.Tensor, plan: ntt_mod.NttPlan, pi: int,
        inverse: bool = False) -> torch.Tensor:
    """Negacyclic NTT (or inverse) mod ``plan.primes[pi]`` of int32 [M, N]
    rows with values in [0, p); bit-reversed order in the NTT domain."""
    if x.device.type == "cpu":
        return ntt_plain(x, plan, pi, inverse)
    _require_cuda_plan(plan)
    M = x.shape[0]
    _require(x, "x", torch.int32, (M, plan.N), x.device)
    tabs = kernel_tables(plan, x.device)
    y = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.lib.redsec_ntt(x.data_ptr(), y.data_ptr(), tabs[pi].data_ptr(), M,
                                  plan.N, plan.primes[pi], int(inverse), _stream(x))
    lib.check("ntt", code)
    launches.bump("ntt")
    return y


# --------------------------------------------------------------------------- #
# K2: one round's external product                                            #
# --------------------------------------------------------------------------- #


def external_product_plain(digits: torch.Tensor, bk_round: torch.Tensor,
                           plan: ntt_mod.NttPlan) -> torch.Tensor:
    """digits int32 [M, rows, N] (signed gadget digits) x BK round slice int16
    [P, rows, 2*limbs, N] (NTT domain) -> torus delta int32 [M, 2, N]:
    forward NTT per prime, lazy MAC over rows, inverse NTT, CRT, and the
    recombination of the 4 BK limbs."""
    M, rows, N = digits.shape
    limbs = bs.BK_LIMBS
    conv = []
    for pi, p in enumerate(plan.primes):
        dn = ntt_mod.ntt_device(digits + p * (digits < 0).to(torch.int32), plan, pi)
        bki = bk_round[pi].to(torch.int32)  # [rows, 8, N]
        # lazy int32 MAC: `group` products of residues stay below 2^31
        group = max(1, (2**31 - 1) // ((p - 1) ** 2))
        total, part = None, None
        for j in range(rows):
            prod = dn[:, j, None, :] * bki[j][None]
            part = prod if part is None else part + prod
            if (j + 1) % group == 0 or j == rows - 1:
                total = part % p if total is None else total + part % p
                part = None
        s = total % p
        conv.append(ntt_mod.intt_device(s, plan, pi).reshape(M, 2, limbs, N))
    out = None
    for limb in range(limbs):
        v = ntt_mod.crt_to_torus32([c[:, :, limb, :] for c in conv], plan)
        v = v * (1 << (bs.BK_LIMB_BITS * limb))
        out = v if out is None else out + v
    return out


def external_product(digits: torch.Tensor, bk_round: torch.Tensor,
                     plan: ntt_mod.NttPlan) -> torch.Tensor:
    """K2: see ``external_product_plain``."""
    if digits.device.type == "cpu":
        return external_product_plain(digits, bk_round, plan)
    _require_cuda_plan(plan)
    M, rows, N = digits.shape
    dev = digits.device
    _require(digits, "digits", torch.int32, (M, rows, plan.N), dev)
    _require(bk_round, "bk_round", torch.int16, (2, rows, 2 * bs.BK_LIMBS, N), dev)
    tabs = kernel_tables(plan, dev)
    delta = torch.empty((M, 2, N), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.lib.redsec_external_product(
            digits.data_ptr(), bk_round.data_ptr(), rows * 2 * bs.BK_LIMBS * N,
            tabs.data_ptr(), delta.data_ptr(), M, N, rows, plan.primes[0], plan.primes[1],
            _stream(digits))
    lib.check("external_product", code)
    launches.bump("external_product")
    return delta


# --------------------------------------------------------------------------- #
# K3: one CMUX round                                                          #
# --------------------------------------------------------------------------- #


def cmux_round_plain(acc: torch.Tensor, t: torch.Tensor, bk_round: torch.Tensor,
                     params: TfheParams, plan: ntt_mod.NttPlan) -> torch.Tensor:
    """acc int32 [M, 2, N], exponents t int32 [M] in [0, 2N), BK round slice
    int16 [P, rows, 8, N] -> acc + ExtProd(Decompose(X^t acc - acc), BK)."""
    ops = bs.RoundOps(params)
    digits = ops.decompose(ops.rotate(acc, t) - acc)
    return acc + external_product_plain(digits, bk_round, plan)


def _gadget_args(params: TfheParams):
    return params.l, params.bg_bit, bs.gadget_offset(params)


def cmux_round(acc: torch.Tensor, t: torch.Tensor, bk_round: torch.Tensor,
               params: TfheParams, plan: ntt_mod.NttPlan) -> torch.Tensor:
    """K3: see ``cmux_round_plain``."""
    if acc.device.type == "cpu":
        return cmux_round_plain(acc, t, bk_round, params, plan)
    _require_cuda_plan(plan)
    M, N, rows = acc.shape[0], params.N, params.decomp_rows
    dev = acc.device
    _require(acc, "acc", torch.int32, (M, 2, N), dev)
    _require(t, "t", torch.int32, (M,), dev)
    _require(bk_round, "bk_round", torch.int16, (2, rows, 2 * bs.BK_LIMBS, N), dev)
    tabs = kernel_tables(plan, dev)
    out = torch.empty_like(acc)
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.lib.redsec_cmux_round(
            acc.data_ptr(), t.data_ptr(), bk_round.data_ptr(), rows * 2 * bs.BK_LIMBS * N,
            tabs.data_ptr(), out.data_ptr(), M, N, *_gadget_args(params),
            plan.primes[0], plan.primes[1], _stream(acc))
    lib.check("cmux_round", code)
    launches.bump("cmux_round")
    return out


# --------------------------------------------------------------------------- #
# K4: the whole blind rotation                                                #
# --------------------------------------------------------------------------- #


def blind_rotate_plain(acc0: torch.Tensor, abar: torch.Tensor, bk: torch.Tensor,
                       params: TfheParams, plan: ntt_mod.NttPlan) -> torch.Tensor:
    """acc0 int32 [B, 2, N], abar int32 [B, n] in [0, 2N), prepared BK int16
    [P, n, rows, 8, N] -> accumulator after all n CMUX rounds."""
    acc = acc0
    for i in range(params.n):
        acc = cmux_round_plain(acc, abar[:, i], bk[:, i], params, plan)
    return acc


def blind_rotate(acc0: torch.Tensor, abar: torch.Tensor, bk: torch.Tensor,
                 params: TfheParams, plan: ntt_mod.NttPlan) -> torch.Tensor:
    """K4: see ``blind_rotate_plain``.  One launch runs all n rounds."""
    if acc0.device.type == "cpu":
        return blind_rotate_plain(acc0, abar, bk, params, plan)
    _require_cuda_plan(plan)
    B, N, n, rows = acc0.shape[0], params.N, params.n, params.decomp_rows
    dev = acc0.device
    _require(acc0, "acc0", torch.int32, (B, 2, N), dev)
    _require(abar, "abar", torch.int32, (B, n), dev)
    _require(bk, "bk", torch.int16, (2, n, rows, 2 * bs.BK_LIMBS, N), dev)
    tabs = kernel_tables(plan, dev)
    out = torch.empty_like(acc0)
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.lib.redsec_blind_rotate(
            acc0.data_ptr(), abar.data_ptr(), bk.data_ptr(), tabs.data_ptr(),
            out.data_ptr(), B, n, N, *_gadget_args(params), plan.primes[0],
            plan.primes[1], _stream(acc0))
    lib.check("blind_rotate", code)
    launches.bump("blind_rotate")
    return out
