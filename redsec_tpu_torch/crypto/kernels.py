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
order of ``ntt.ntt_device`` (flavour "radix2"), and BK residues are 16-bit
patterns of int16 (``residues`` zero-extends them).

``ntt`` and ``blind_rotate`` take every NTT plan of the JAX package (two or
three primes below 2^16, N = 256 .. 2048), plain and bundled keys
(``supported``); ``external_product`` and ``cmux_round``, which the model
paths run only inside ``blind_rotate``, take two primes up to N = 1024, as
the Pallas kernels they replace do.

Three more, in ``csrc/blind_mm.cu`` (a library of its own), take four-step
("matmul") keys in the JAX package's [k1, k2] order, as its Pallas kernels do:

============================  ==============================================
``external_product_mm``       ``crypto/pallas_round.py::make_round_kernel``
``cmux_round_mm``             ``crypto/pallas_round.py::make_full_round_kernel``
``blind_rotate_mm``           ``crypto/pallas_blind.py::make_blind_rotate_kernel``
============================  ==============================================

with the twins ``*_mm_plain`` (the radix-2 twins with the four-step
``ntt_matmul`` pair), the envelope ``supported_mm`` (the JAX package's
``pallas_blind.supported``, unbundled) and the layout mirror
``k4mm_layout``; a radix-2 key raises in them by its shape.

A further kernel, ``schoolbook_product`` (S1, ``csrc/schoolbook.cu``), is the
external product of the parameter sets without NTT primes (N >= 4096), and
of any set prepared with ``schoolbook=True``: the JAX package computes it as
an XLA int8 convolution (``redsec_tpu/crypto/bootstrap.py:517-556``), not in
Pallas.  S1 computes JAX's limb formulation, exactly, on the int8 tensor
cores; its twin is an exact float64 FFT product.
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
from . import ntt_matmul
from .params import TfheParams

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "pbs.cu")
SCHOOLBOOK_SOURCE = os.path.join(_PKG, "csrc", "schoolbook.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
KERNEL_N = (256, 512, 1024, 2048)  # N the kernels are instantiated for
ROUND_KERNEL_N = (256, 512, 1024)  # N of the one-round kernels K2 and K3
SCHOOLBOOK_N = (256, 512, 1024, 2048, 4096, 8192)  # N the schoolbook kernel takes


def _primes_ok(plan: ntt_mod.NttPlan, count: tuple) -> bool:
    pr = plan.primes
    return (len(pr) in count and all(a < b for a, b in zip(pr, pr[1:]))
            and pr[-1] < (1 << 16))


def _plan_ok(plan: ntt_mod.NttPlan) -> bool:
    """Primes ascending and below 2^16 (residues are 16-bit patterns of the
    int16 BK), two or three of them, and an N the kernels are built for;
    N = 2048 has only two NTT primes (12289, 40961)."""
    return (_primes_ok(plan, (2, 3)) and plan.N in KERNEL_N
            and (plan.N < 2048 or len(plan.primes) == 2))


def supported(params: TfheParams, plan: ntt_mod.NttPlan, bundle: int = 1) -> bool:
    """Whether the CUDA kernels take this parameter set, NTT plan and key
    bundling (a bundled key pairs its n rounds, so n is even).  How K4 lays
    out each instance it takes (``group`` ciphertexts a block, so that one
    load of a key row serves them all; digit rows in chunks; at bundled
    N = 2048 the accumulators on the inverse results' region) is
    ``k4_layout``."""
    return (_plan_ok(plan) and params.l * params.bg_bit <= 32 and params.N == plan.N
            and (bundle == 1 or (bundle == 2 and params.n % 2 == 0)))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin")
    return path


def library_path(source: str) -> str:
    """Where the shared library of ``csrc/<stem>.cu`` is built."""
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"libredsec_{stem}.so")


def build_library(source: str, force: bool = False) -> str:
    """Compile one CUDA source into its ``library_path`` unless that is up to
    date (``force`` compiles anyway).  Returns the compiler's messages
    (``-Xptxas -v``: registers, shared memory, spills per kernel), empty when
    nothing was built.  Raises with the compiler's output if nvcc fails."""
    lib = library_path(source)
    if (not force and os.path.exists(lib)
            and os.path.getmtime(lib) >= os.path.getmtime(source)):
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
    each C function's name to its argtypes (all return int); an entry that
    launches a kernel takes the stream last and returns the
    ``cudaGetLastError()`` of its launch, and the source exports
    ``redsec_error_string``."""

    def __init__(self, source: str, entries: dict):
        build_library(source)
        lib = ctypes.CDLL(library_path(source))
        lib.redsec_error_string.argtypes = [ctypes.c_int]
        lib.redsec_error_string.restype = ctypes.c_char_p
        self.fn = {}
        for name, argtypes in entries.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self.fn[name] = fn
        self.lib = lib

    def launch(self, entry: str, kernel: str, dev: torch.device, *args) -> None:
        """Call ``entry(*args, stream)`` on ``dev``'s current stream, raise on
        a non-zero ``cudaGetLastError()`` and add one to ``kernel``'s launch
        count.  The device guard is entered only when ``dev`` is not already
        the current device."""
        fn = self.fn[entry]
        if dev.index == torch.cuda.current_device():
            code = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        else:
            with torch.cuda.device(dev):
                code = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        if code != 0:
            msg = self.lib.redsec_error_string(code).decode()
            raise RuntimeError(f"CUDA kernel {kernel} failed: {msg} ({code})")
        launches.bump(kernel)


_P, _I, _L, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
_ENTRIES = {
    "redsec_ntt": [_P, _P, _P, _I, _I, _I, _I, _P],
    "redsec_external_product": [_P, _P, _L, _P, _P, _I, _I, _I, _I, _I, _P],
    "redsec_cmux_round": [_P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _U, _I, _I, _P],
    "redsec_blind_rotate": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _I, _I, _I, _I, _I,
                            _P],
    "redsec_blind_rotate_config": [_I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)],
}
_loaded: list[Library] = []


def _lib() -> Library:
    if not _loaded:
        _loaded.append(Library(SOURCE, _ENTRIES))
    return _loaded[0]


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
        raise ValueError(f"CUDA kernels take 2 or 3 ascending primes < 2^16 (2 at N = 2048) "
                         f"and N in {KERNEL_N}; got primes {plan.primes}, N={plan.N}")


def _require_round_plan(plan: ntt_mod.NttPlan) -> None:
    if not (_primes_ok(plan, (2,)) and plan.N in ROUND_KERNEL_N):
        raise ValueError(f"the one-round kernels take 2 ascending primes < 2^16 and N in "
                         f"{ROUND_KERNEL_N}; got primes {plan.primes}, N={plan.N}")


def residues(bk: torch.Tensor) -> torch.Tensor:
    """int16 BK residues -> int32 in [0, 2^16): the BK keeps each residue as
    its 16-bit pattern (40961 does not fit a signed int16), so every reader
    zero-extends."""
    return bk.to(torch.int32) & 0xFFFF


def shoup_tables(plan: ntt_mod.NttPlan) -> np.ndarray:
    """uint32 [P, 4, N, 2]: the kernels' twiddles as pairs (w, w') with
    w' = floor(w * 2^32 / p), the Shoup companion that turns x * w mod p into
    one high product and two low ones.  Tables per prime, values and order of
    ``plan``: 0 twist, 1 forward stage tables concatenated (the stage of
    half-span h = N >> (s + 1) at offset N - 2h), 2 untwist (psi^-j / N),
    3 inverse stage tables concatenated (half-span h = 2^s at offset h - 1).
    The last entry of tables 1 and 3 is unused (0)."""
    N = plan.N
    w = np.zeros((len(plan.primes), 4, N), np.uint64)
    for pi in range(len(plan.primes)):
        w[pi, 0] = plan.twist[pi]
        w[pi, 1, :N - 1] = np.concatenate(plan.fwd_tabs[pi])
        w[pi, 2] = plan.untwist[pi]
        w[pi, 3, :N - 1] = np.concatenate(plan.inv_tabs[pi])
    p = np.asarray(plan.primes, np.uint64)[:, None, None]
    return np.stack([w, (w << np.uint64(32)) // p], axis=-1).astype(np.uint32)


_TABLES: dict = {}


def kernel_tables(plan: ntt_mod.NttPlan, device) -> torch.Tensor:
    """``shoup_tables(plan)`` on ``device`` as int32 [P, 4, N, 2] (the bit
    patterns of the uint32 pairs), built once per plan and device."""
    key = (plan.N, plan.primes, device)
    tabs = _TABLES.get(key)
    if tabs is None:
        tabs = torch.as_tensor(shoup_tables(plan).view(np.int32), device=device)
        _TABLES[key] = tabs
    return tabs


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
    tab = tabs.data_ptr() + pi * 4 * plan.N * 8  # this prime's [4, N, 2] int32
    _lib().launch("redsec_ntt", "ntt", x.device, x.data_ptr(), y.data_ptr(), tab, M,
                  plan.N, plan.primes[pi], int(inverse))
    return y


# The radix-2 transform pair of the kernels' twins (bit-reversed NTT domain).
RADIX2 = (ntt_mod.ntt_device, ntt_mod.intt_device)


# --------------------------------------------------------------------------- #
# K2: one round's external product                                            #
# --------------------------------------------------------------------------- #


def external_product_plain(digits: torch.Tensor, bk_round: torch.Tensor,
                           plan: ntt_mod.NttPlan, fwd=ntt_mod.ntt_device,
                           inv=ntt_mod.intt_device) -> torch.Tensor:
    """digits int32 [M, R, N] (signed gadget digits) x BK round slice int16
    [P, R, 2*limbs, N] (NTT domain) -> torus delta int32 [M, 2, N]: forward
    NTT per prime, lazy MAC over the R rows, inverse NTT, CRT, and the
    recombination of the 4 BK limbs.  R is the round's digit rows, or three
    times that for a bundled round (one contraction over its three
    differences).  ``fwd``/``inv``: the transform pair the BK was prepared
    with (radix-2 for the kernels; the four-step ``ntt_matmul`` pair for a
    "matmul" key)."""
    M, rows, N = digits.shape
    conv = []
    for pi, p in enumerate(plan.primes):
        dn = fwd(digits + p * (digits < 0).to(torch.int32), plan, pi)
        s = mac_rows(dn, residues(bk_round[pi]), p)  # [M, 8, N]
        conv.append(inv(s, plan, pi).reshape(M, 2, bs.BK_LIMBS, N))
    return recombine_limbs(conv, plan)


def mac_rows(dn: torch.Tensor, bki: torch.Tensor, p: int) -> torch.Tensor:
    """sum_j dn[:, j] * bki[j] mod p for NTT-domain digits int32 [M, R, L]
    and BK residues int32 [R, 8, L] -> [M, 8, L]: the lazy int32 MAC, where
    ``group`` products of residues stay below 2^31 (one at 40961, whose
    square is 1.68e9)."""
    group = max(1, (2**31 - 1) // ((p - 1) ** 2))
    rows = dn.shape[1]
    total, part = None, None
    for j in range(rows):
        prod = dn[:, j, None, :] * bki[j][None]
        part = prod if part is None else part + prod
        if (j + 1) % group == 0 or j == rows - 1:
            total = part % p if total is None else total + part % p
            part = None
    return total % p


def recombine_limbs(conv, plan: ntt_mod.NttPlan) -> torch.Tensor:
    """Per-prime residues [M, 2, limbs, ...] -> torus int32 [M, 2, ...]: CRT
    of each BK limb's products, shifted by its 8 bits, summed mod 2^32."""
    out = None
    for limb in range(bs.BK_LIMBS):
        v = ntt_mod.crt_to_torus32([c[:, :, limb] for c in conv], plan)
        v = v * (1 << (bs.BK_LIMB_BITS * limb))
        out = v if out is None else out + v
    return out


def external_product(digits: torch.Tensor, bk_round: torch.Tensor,
                     plan: ntt_mod.NttPlan) -> torch.Tensor:
    """K2: see ``external_product_plain`` (two primes, N up to 1024)."""
    if digits.device.type == "cpu":
        return external_product_plain(digits, bk_round, plan)
    _require_round_plan(plan)
    M, rows, N = digits.shape
    dev = digits.device
    _require(digits, "digits", torch.int32, (M, rows, plan.N), dev)
    _require(bk_round, "bk_round", torch.int16, (2, rows, 2 * bs.BK_LIMBS, N), dev)
    tabs = kernel_tables(plan, dev)
    delta = torch.empty((M, 2, N), dtype=torch.int32, device=dev)
    _lib().launch("redsec_external_product", "external_product", dev, digits.data_ptr(),
                  bk_round.data_ptr(), rows * 2 * bs.BK_LIMBS * N, tabs.data_ptr(),
                  delta.data_ptr(), M, N, rows, plan.primes[0], plan.primes[1])
    return delta


# --------------------------------------------------------------------------- #
# K3: one CMUX round                                                          #
# --------------------------------------------------------------------------- #


def cmux_round_plain(acc: torch.Tensor, t: torch.Tensor, bk_round: torch.Tensor,
                     params: TfheParams, plan: ntt_mod.NttPlan,
                     transforms=RADIX2) -> torch.Tensor:
    """acc int32 [M, 2, N], exponents t int32 [M] in [0, 2N), BK round slice
    int16 [P, rows, 8, N] -> acc + ExtProd(Decompose(X^t acc - acc), BK)."""
    ops = bs.RoundOps(params)
    digits = ops.decompose(ops.rotate(acc, t) - acc)
    return acc + external_product_plain(digits, bk_round, plan, *transforms)


def bundled_round_plain(acc: torch.Tensor, ti: torch.Tensor, tj: torch.Tensor,
                        bk_round: torch.Tensor, params: TfheParams,
                        plan: ntt_mod.NttPlan, transforms=RADIX2) -> torch.Tensor:
    """One 2-bit bundled CMUX round (the JAX package's ``bundle == 2`` body):
    u = X^ti acc - acc, v = X^tj acc - acc, w = X^tj u - u; the digits of
    [u, v, w] stacked so that row = which * rows + bloc * l + level, against
    the round's interleaved BK slice int16 [P, 3 * rows, 8, N]
    ([bk(s_2i) | bk(s_2i+1) | bk(s_2i * s_2i+1)])."""
    ops = bs.RoundOps(params)
    M, N = acc.shape[0], params.N
    u = ops.rotate(acc, ti) - acc
    v = ops.rotate(acc, tj) - acc
    w = ops.rotate(u, tj) - u
    digits = ops.decompose(torch.stack([u, v, w], dim=1).reshape(3 * M, 2, N))
    return acc + external_product_plain(digits.reshape(M, 3 * params.decomp_rows, N),
                                        bk_round, plan, *transforms)


def _gadget_args(params: TfheParams):
    return params.l, params.bg_bit, bs.gadget_offset(params)


def cmux_round(acc: torch.Tensor, t: torch.Tensor, bk_round: torch.Tensor,
               params: TfheParams, plan: ntt_mod.NttPlan) -> torch.Tensor:
    """K3: see ``cmux_round_plain`` (two primes, N up to 1024)."""
    if acc.device.type == "cpu":
        return cmux_round_plain(acc, t, bk_round, params, plan)
    _require_round_plan(plan)
    M, N, rows = acc.shape[0], params.N, params.decomp_rows
    dev = acc.device
    _require(acc, "acc", torch.int32, (M, 2, N), dev)
    _require(t, "t", torch.int32, (M,), dev)
    _require(bk_round, "bk_round", torch.int16, (2, rows, 2 * bs.BK_LIMBS, N), dev)
    tabs = kernel_tables(plan, dev)
    out = torch.empty_like(acc)
    _lib().launch("redsec_cmux_round", "cmux_round", dev, acc.data_ptr(), t.data_ptr(),
                  bk_round.data_ptr(), rows * 2 * bs.BK_LIMBS * N, tabs.data_ptr(),
                  out.data_ptr(), M, N, *_gadget_args(params), plan.primes[0], plan.primes[1])
    return out


# --------------------------------------------------------------------------- #
# K4: the whole blind rotation                                                #
# --------------------------------------------------------------------------- #


def key_bundle(bk: torch.Tensor, params: TfheParams) -> int:
    """1 for a BK of n rounds [P, n, rows, 8, N], 2 for a bundled one of n/2
    rounds [P, n/2, 3 * rows, 8, N].  Raises on anything else, a four-step
    ("matmul") BK [P, n, rows, 8, R, C] included: the kernels and their twins
    take radix-2 keys only."""
    if bk.ndim != 5:
        raise ValueError(f"BK of shape {tuple(bk.shape)} is not a radix-2 NTT key "
                         "[P, rounds, rows, 8, N] (a 'matmul' key is [P, n, rows, 8, R, C]): "
                         "the blind-rotation kernel and its twin take radix-2 keys only")
    if bk.shape[1] == params.n and bk.shape[2] == params.decomp_rows:
        return 1
    if 2 * bk.shape[1] == params.n and bk.shape[2] == 3 * params.decomp_rows:
        return 2
    raise ValueError(f"BK shape {tuple(bk.shape)} is neither plain nor bundled for "
                     f"n={params.n}, rows={params.decomp_rows}")


def blind_rotate_plain(acc0: torch.Tensor, abar: torch.Tensor, bk: torch.Tensor,
                       params: TfheParams, plan: ntt_mod.NttPlan,
                       transforms=RADIX2) -> torch.Tensor:
    """acc0 int32 [B, 2, N], abar int32 [B, n] in [0, 2N), prepared BK int16
    [P, n, rows, 8, N] -> accumulator after all n CMUX rounds; a bundled BK
    [P, n/2, 3 * rows, 8, N] runs n/2 bundled rounds on exponent pairs.
    ``transforms``: the (forward, inverse) NTT pair the BK was prepared with
    (the loop of a "matmul" key passes the four-step pair and its BK viewed
    as [..., N])."""
    acc = acc0
    if key_bundle(bk, params) == 2:
        for i in range(params.n // 2):
            acc = bundled_round_plain(acc, abar[:, 2 * i], abar[:, 2 * i + 1], bk[:, i],
                                      params, plan, transforms)
        return acc
    for i in range(params.n):
        acc = cmux_round_plain(acc, abar[:, i], bk[:, i], params, plan, transforms)
    return acc


def blind_rotate(acc0: torch.Tensor, abar: torch.Tensor, bk: torch.Tensor,
                 params: TfheParams, plan: ntt_mod.NttPlan) -> torch.Tensor:
    """K4: see ``blind_rotate_plain``.  One launch runs all rounds, laid out
    as ``k4_layout`` says."""
    if acc0.device.type == "cpu":
        return blind_rotate_plain(acc0, abar, bk, params, plan)
    bundle = key_bundle(bk, params)
    if not supported(params, plan, bundle):
        raise ValueError(f"{params.name}: primes {plan.primes} at N={plan.N}, bundle "
                         f"{bundle}: outside what blind_rotate_kernel is built for")
    B, N, n, rows = acc0.shape[0], params.N, params.n, params.decomp_rows
    dev = acc0.device
    _require(acc0, "acc0", torch.int32, (B, 2, N), dev)
    _require(abar, "abar", torch.int32, (B, n), dev)
    _require(bk, "bk", torch.int16, (len(plan.primes), n // bundle,
                                     rows * (3 if bundle == 2 else 1), 2 * bs.BK_LIMBS, N), dev)
    tabs = kernel_tables(plan, dev)
    out = torch.empty_like(acc0)
    pr = tuple(plan.primes) + (0,) * (3 - len(plan.primes))
    _lib().launch("redsec_blind_rotate", "blind_rotate", dev, acc0.data_ptr(),
                  abar.data_ptr(), bk.data_ptr(), tabs.data_ptr(), out.data_ptr(), B, n, N,
                  *_gadget_args(params), len(plan.primes), *pr, bundle)
    return out


def blind_rotate_config(batch: int, params: TfheParams, plan: ntt_mod.NttPlan | None = None,
                        bundle: int = 1, sm_count: int | None = None) -> dict:
    """How K4 runs at this batch, as the built library's C entry chooses it
    for a card of ``sm_count`` SMs (default: the current card's): the keys of
    ``k4_layout``, which mirrors the rule in Python, plus
    ``shared_bytes_g2``, what two ciphertexts a block would take with all
    their digit rows and every prime's stage tables (above the 232,448 a
    block may have where they do not fit)."""
    plan = plan or bs.bootstrap_plan(params, bundle == 2)
    if sm_count is None:
        sm_count = torch.cuda.get_device_properties(torch.cuda.current_device()) \
            .multi_processor_count
    out = (ctypes.c_int * 6)()
    code = _lib().fn["redsec_blind_rotate_config"](batch, params.N, params.l,
                                                   len(plan.primes), bundle, sm_count, out)
    if code != 0:
        raise ValueError(f"blind_rotate_kernel has no instance for N={params.N}, "
                         f"{len(plan.primes)} primes, bundle {bundle}")
    N, P, D = params.N, len(plan.primes), 3 if bundle == 2 else 1
    return {"group": out[0], "chunk_rows": out[1], "shared_bytes": out[2],
            "tables_resident": bool(out[3]), "accumulators_on_r2": bool(out[5]),
            "instance": _k4_instance(N, out[0], P, D), "shared_bytes_g2": out[4]}


# K4's layout (csrc/pbs.cu: Geo, Smem, k4_chunk, k4_config), mirrored so that
# the CPU tests can hold it: shared memory a block may have on sm_90
K4_MAX_SHARED = 232448


def k4_shared_bytes(N: int, group: int, primes: int, diffs: int, chunk: int,
                    tables: int, alias: bool = False) -> int:
    """Dynamic shared bytes of ``Smem<N, group, primes, diffs>`` with ``chunk``
    digit rows a chunk and the stage tables of ``tables`` primes: the tables
    (uint2 [tables][2][N]), the exchange buffers ([POLYS][2][N + N/16 padded]
    words, the key ring in the MAC), accumulators and differences ([group]
    [1 + diffs][2][N] words; [group][diffs][2][N] with ``alias``, where the
    accumulators lie on the last region), digit rows or MAC sums (uint16
    [group * max(chunk, 8)][N]) and the inverse transforms of all primes but
    the last (uint16 [primes - 1][group * 8][N])."""
    polys = 8 if N <= 1024 else 4
    xw = N + N // 16  # N + 16 * S words, S = N / 256
    accs = diffs if alias else 1 + diffs
    return (8 * tables * 2 * N + 4 * (polys * 2 * xw + accs * group * 2 * N)
            + 2 * (group * max(chunk, 8) * N + (primes - 1) * group * 8 * N))


def _k4_tables(N: int, group: int, primes: int, diffs: int) -> int:
    """Primes whose stage tables stay in shared memory: every prime's where
    they fit beside the smallest chunk (N <= 1024), else one prime's at a
    time."""
    smallest = (8 if N <= 1024 else 4) // group
    if N <= 1024 and k4_shared_bytes(N, group, primes, diffs, smallest,
                                     primes) <= K4_MAX_SHARED:
        return primes
    return 1


def _k4_alias(N: int, group: int, primes: int, diffs: int) -> bool:
    """Whether the accumulators lie on the inverse results' region (r2, idle
    between rounds, (primes - 1) * group * 8 * N * 2 bytes against their
    group * 2 * N * 4): where the layout with them in their own words does
    not fit at the smallest chunk and this one does.  Only the bundled
    instance at N = 2048 takes it."""
    smallest = (8 if N <= 1024 else 4) // group
    tables = _k4_tables(N, group, primes, diffs)
    return (k4_shared_bytes(N, group, primes, diffs, smallest, tables) > K4_MAX_SHARED
            >= k4_shared_bytes(N, group, primes, diffs, smallest, tables, True))


def _k4_chunk(N: int, group: int, primes: int, diffs: int, rows: int) -> int:
    """The largest chunk of digit rows that fits at ``group`` ciphertexts a
    block: all rows, else a multiple of POLYS / group; 0 where none fits
    (the instance is not built)."""
    step = (8 if N <= 1024 else 4) // group
    tables = _k4_tables(N, group, primes, diffs)
    alias = _k4_alias(N, group, primes, diffs)
    if k4_shared_bytes(N, group, primes, diffs, step, tables, alias) > K4_MAX_SHARED:
        return 0
    cr = rows
    while k4_shared_bytes(N, group, primes, diffs, cr, tables, alias) > K4_MAX_SHARED:
        cr = (cr - 1) // step * step
    return cr


def _k4_instance(N: int, group: int, primes: int, diffs: int) -> str:
    """The kernel a layout launches, as the compiler's report and the SASS
    name it (the start of its mangled name)."""
    return f"blind_rotate_kernelILi{N}ELi{group}ELi{primes}ELi{diffs}E"


def k4_layout(batch: int, params: TfheParams, plan: ntt_mod.NttPlan | None = None,
              bundle: int = 1, sm_count: int = 132) -> dict:
    """How K4 lays out a launch, a function of N, the primes, the bundling,
    the digit rows, the batch and the card's SM count only (132 on the H100
    SXM).  ``group``: ciphertexts a block, 2 when the batch exceeds the SM
    count and two fit shared memory at some chunk of digit rows, so that each
    key row a block loads serves both (every block loads its own key rows:
    a cluster of two blocks sharing one multicast copy a row, where two
    ciphertexts do not fit a block, was slower than one a block, PERF.md);
    ``chunk_rows``: digit rows transformed and multiplied at a time (the
    largest chunk that fits); ``shared_bytes``: the block's dynamic shared
    memory; ``tables_resident``: every prime's stage tables stay in shared
    memory (else one prime's at a time, staged again for every prime of
    every round); ``accumulators_on_r2``: the accumulators lie on the
    inverse results' region, carried in registers through each round (where
    nothing else fits: bundled at N = 2048); ``instance``: the kernel
    launched, as the compiler's report names it.
    Raises for a combination ``supported`` refuses."""
    plan = plan or bs.bootstrap_plan(params, bundle == 2)
    if plan is None or not supported(params, plan, bundle):
        raise ValueError(f"{params.name}, bundle {bundle}: not a blind_rotate_kernel instance")
    N, P, D = params.N, len(plan.primes), 3 if bundle == 2 else 1
    rows = D * params.decomp_rows
    cr2 = _k4_chunk(N, 2, P, D, rows)
    group = 2 if batch > sm_count and cr2 > 0 else 1
    cr = cr2 if group == 2 else _k4_chunk(N, 1, P, D, rows)
    tables = _k4_tables(N, group, P, D)
    alias = _k4_alias(N, group, P, D)
    return {"group": group, "chunk_rows": cr,
            "shared_bytes": k4_shared_bytes(N, group, P, D, cr, tables, alias),
            "tables_resident": tables == P, "accumulators_on_r2": alias,
            "instance": _k4_instance(N, group, P, D)}


# --------------------------------------------------------------------------- #
# S1: the schoolbook external product (the sets without NTT primes)           #
# --------------------------------------------------------------------------- #

_SB_ENTRIES = {
    "redsec_schoolbook_product": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "redsec_schoolbook_tile": [_I, _I, _I, _I, ctypes.POINTER(_I)],
}
_sb_loaded: list[Library] = []
SCHOOLBOOK_MAX_HALF_BG = 512  # two s8 limbs of a digit: lo in [-128, 127], hi in [-2, 2]
SCHOOLBOOK_MAX_ROWS = 64


def _sb_lib() -> Library:
    if not _sb_loaded:
        _sb_loaded.append(Library(SCHOOLBOOK_SOURCE, _SB_ENTRIES))
    return _sb_loaded[0]


def schoolbook_digit_limbs(half_bg: int) -> int:
    """s8 limbs a digit in [-half_bg, half_bg) takes in S1: one up to 128,
    two up to ``SCHOOLBOOK_MAX_HALF_BG``."""
    if not 1 <= half_bg <= SCHOOLBOOK_MAX_HALF_BG:
        raise ValueError(f"schoolbook_kernel takes Bg/2 in 1..{SCHOOLBOOK_MAX_HALF_BG} "
                         f"(no limb plan beyond two s8 limbs); got {half_bg}")
    return 1 if half_bg <= 128 else 2


def schoolbook_tap_bound(half_bg: int) -> int:
    """The most one tap adds to one of S1's int32 accumulators: key bytes are
    at most 255, and the accumulator of shift s sums the low digit limb
    (|lo| <= 128) against key byte s and, with two limbs, the high one
    (|hi| <= 2) against key byte s - 1."""
    return (128 if schoolbook_digit_limbs(half_bg) == 1 else 130) * 255


def schoolbook_flush_rows(N: int, half_bg: int) -> int:
    """Digit rows S1 sums in int32 before it adds its accumulators into the
    uint32 total: the most for which rows x N taps stay below 2^31."""
    return (2**31 - 1) // (schoolbook_tap_bound(half_bg) * N)


def schoolbook_tile(B: int, N: int, half_bg: int, device=None) -> dict:
    """The tile S1 launches with at this batch, N and Bg/2 on ``device``'s
    card: ``nt`` (8 nt ciphertexts a block), ``mt`` (16 mt coefficients a
    block), ``limbs`` (digit limbs) and ``instance``, the kernel's template
    arguments as the compiler's report spells them."""
    dev = torch.device(device if device is not None else "cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = (ctypes.c_int * 3)()
    if _sb_lib().fn["redsec_schoolbook_tile"](B, N, half_bg, sms, out) != 0:
        raise ValueError(f"schoolbook_kernel has no tile for B={B}, N={N}, Bg/2={half_bg}")
    nt, mt, limbs = out
    return {"nt": nt, "mt": mt, "limbs": limbs,
            "instance": f"schoolbook_mma_kernelILi{nt}ELi{mt}ELi{limbs}E"}


def _fft_error_bound(digits: torch.Tensor, halves: torch.Tensor) -> float:
    """A bound on the largest error of the values ``schoolbook_product_plain``
    rounds to integers: each is a negacyclic fold c[j] - c[j + N] of two
    linear-convolution coefficients, so its error is at most twice the bound
    on one coefficient below, and that twice is what this returns.

    A product of two length-L real sequences through a float64 FFT of length
    L = 2^k (forward, forward, pointwise, inverse) is off by less than
    ||x||_2 ||y||_2 ((1 + e)^3k (1 + sqrt(5) e)^(3k+1) (1 + b)^3k - 1), with
    e = 2^-53 and b the error of the twiddles (Percival, "Rapid multiplication
    modulo the sum and difference of highly composite numbers", Math. Comp.
    72 (2003), Theorem 5.1).  Twiddles from a library are taken as no better
    than 4e, and the ``rows`` products are summed in the frequency domain, so
    the bound on one coefficient is the sum over rows of the largest
    ||digits_r||_2 x ||half_r||_2, times that factor."""
    L = 2 * digits.shape[-1]
    k = L.bit_length() - 1
    e = 2.0 ** -53
    factor = (1 + e) ** (3 * k) * (1 + 5 ** 0.5 * e) ** (3 * k + 1) * (1 + 4 * e) ** (3 * k) - 1
    dn = digits.to(torch.float64).norm(dim=-1).amax(dim=0)  # [rows]
    hn = halves.norm(dim=-1).flatten(1).amax(dim=1)  # [rows]
    return 2 * float((dn * hn).sum()) * factor


def schoolbook_product_plain(digits: torch.Tensor, bk_round: torch.Tensor,
                             half_bg: int) -> torch.Tensor:
    """digits int32 [B, rows, N] in [-half_bg, half_bg) x one round of the
    raw BK int32 [rows, 2, N] -> delta int32 [B, 2, N], delta[b, u] =
    sum_r digits[b, r] * bk[r, u] in Z[X]/(X^N + 1) mod 2^32: the function of
    the JAX package's ``external_delta_schoolbook`` after its ``decompose``.
    Raises on a digit outside [-half_bg, half_bg), the domain S1 takes.

    Exact through float64 FFTs: the key is split into sign-balanced 16-bit
    halves (bk = hi * 2^16 + lo, |lo|, |hi| <= 2^15), each half's product with
    the digits is a zero-padded length-2N real FFT product summed over the
    rows, folded negacyclically and rounded; the halves recombine mod 2^32 in
    int64.  Rounding is exact while the error stays below 1/2, which
    ``_fft_error_bound`` bounds from these inputs and this function asserts
    (at N = 8192, rows 8 and digits in [-512, 512) it is at most 0.062)."""
    if digits.numel():
        lo, hi = torch.stack(torch.aminmax(digits)).tolist()  # one reduction, one sync
        if not (lo >= -half_bg and hi < half_bg):
            raise ValueError(f"digits outside [-{half_bg}, {half_bg}): [{lo}, {hi}]")
    B, rows, N = digits.shape
    bk = bk_round.to(torch.int64)
    lo = ((bk + (1 << 15)) & 0xFFFF) - (1 << 15)
    halves = torch.stack([lo, (bk - lo) >> 16], dim=2).to(torch.float64)  # [rows, 2, 2, N]
    bound = _fft_error_bound(digits, halves)
    if not bound < 0.5:
        raise ValueError(f"the float64 FFT product could round wrongly (error bound "
                         f"{bound:.3g} >= 1/2): digits too wide for an exact product")
    fd = torch.fft.rfft(digits.to(torch.float64), n=2 * N)  # [B, rows, N + 1]
    fk = torch.fft.rfft(halves, n=2 * N)  # [rows, 2, 2, N + 1]
    spec = None
    for r in range(rows):
        term = fd[:, r, None, None, :] * fk[r][None]
        spec = term if spec is None else spec + term
    conv = torch.fft.irfft(spec, n=2 * N)  # [B, 2, 2, 2N]
    v = torch.round(conv[..., :N] - conv[..., N:]).to(torch.int64)
    out = v[:, :, 0] + (v[:, :, 1] << 16)
    return (((out + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def schoolbook_product(digits: torch.Tensor, bk_round: torch.Tensor,
                       half_bg: int) -> torch.Tensor:
    """S1: see ``schoolbook_product_plain``.  One launch a round; digits in
    [-half_bg, half_bg) with half_bg <= ``SCHOOLBOOK_MAX_HALF_BG`` (the
    kernel's limb plan: it does not check the digits, and outside that range
    its result is not the product), N in ``SCHOOLBOOK_N``, 1 ..
    ``SCHOOLBOOK_MAX_ROWS`` digit rows, any batch."""
    if digits.device.type == "cpu":
        return schoolbook_product_plain(digits, bk_round, half_bg)
    if digits.ndim != 3:
        raise ValueError(f"digits has shape {tuple(digits.shape)}, expected [B, rows, N]")
    B, rows, N = digits.shape
    if N not in SCHOOLBOOK_N or not 1 <= rows <= SCHOOLBOOK_MAX_ROWS or B < 1:
        raise ValueError(f"schoolbook_kernel takes N in {SCHOOLBOOK_N} and "
                         f"1..{SCHOOLBOOK_MAX_ROWS} digit rows; "
                         f"got digits of shape {tuple(digits.shape)}")
    flush_rows = schoolbook_flush_rows(N, half_bg)
    dev = digits.device
    _require(digits, "digits", torch.int32, (B, rows, N), dev)
    _require(bk_round, "bk_round", torch.int32, (rows, 2, N), dev)
    out = torch.empty((B, 2, N), dtype=torch.int32, device=dev)
    for name, t in (("digits", digits), ("bk_round", bk_round)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    _sb_lib().launch("redsec_schoolbook_product", "schoolbook_product", dev, digits.data_ptr(),
                     bk_round.data_ptr(), out.data_ptr(), B, rows, N, half_bg, flush_rows)
    return out


# --------------------------------------------------------------------------- #
# K2-K4 on four-step ("matmul") keys (csrc/blind_mm.cu)                       #
# --------------------------------------------------------------------------- #

MM_SOURCE = os.path.join(_PKG, "csrc", "blind_mm.cu")
MM_KERNEL_N = (256, 1024)  # N = R * 128 the four-step kernels are instantiated for
MATMUL = (ntt_matmul.ntt_device_mm, ntt_matmul.intt_device_mm)  # the twins' transform pair
_MM_ENTRIES = {
    "redsec_mm_layout": [_I, _I, ctypes.POINTER(_I)],
    "redsec_external_product_mm": [_P, _P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "redsec_cmux_round_mm": [_P, _P, _P, _L, _P, _P, _P, _I, _I, _I, _I, _U, _I, _I, _P],
    "redsec_blind_rotate_mm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _I, _I, _P],
}
_mm_loaded: list[Library] = []


def _mm_lib() -> Library:
    if not _mm_loaded:
        _mm_loaded.append(Library(MM_SOURCE, _MM_ENTRIES))
    return _mm_loaded[0]


# The layout rule of csrc/blind_mm.cu (mm_mrows, mm_u_bytes, mm_smem_bytes),
# mirrored: padded row bytes of a u8 limb matrix, padded row halves of the
# 16-bit results, key rows in the ring.
MM_WS, MM_ZS, MM_RING = 144, 136, 2


def _mm_rows(N: int, rows: int) -> int:
    """Mr: rows of the C-steps' operands and results, the larger of rows * R
    and 8R rounded up to a whole m16 tile."""
    R = N // ntt_matmul.MM_C
    return -(-max(rows * R, 8 * R) // 16) * 16


def _mm_u_bytes(N: int, rows: int) -> int:
    """U: the C-steps' u8 left operand [2][Mr][144] or the key ring
    [2][8][N] u16, the larger."""
    return max(2 * _mm_rows(N, rows) * MM_WS, MM_RING * 8 * N * 2)


def k4mm_shared_bytes(N: int, rows: int) -> int:
    """Dynamic shared bytes of the four-step kernels at N and ``rows`` digit
    rows: WC's limbs of both primes (uint8 [2][2][128][144]), accumulators
    and differences (uint32 [2][2][N]), U, Z (16-bit C-step results
    [Mr][136]) and the two primes' inverse transforms (uint16 [2][8][N])."""
    return (2 * 2 * 128 * MM_WS + 4 * 2 * 2 * N + _mm_u_bytes(N, rows)
            + 2 * _mm_rows(N, rows) * MM_ZS + 2 * 2 * 8 * N)


def _mm_shape_ok(plan: ntt_mod.NttPlan, N: int, rows: int) -> bool:
    """The JAX package's ``pallas_blind.supported`` (two primes below 2^15,
    the (R, 128) split) on an N the four-step kernels are built for, primes
    ascending, and ``rows`` digit rows fitting a block."""
    pr = plan.primes
    return (len(pr) == 2 and all(p < (1 << 15) for p in pr)
            and ntt_matmul.supported(N) and ntt_matmul._split_rc(N)[1] == 128
            and N == plan.N and N in MM_KERNEL_N and 256 < pr[0] < pr[1]
            and 0 < rows and k4mm_shared_bytes(N, rows) <= K4_MAX_SHARED)


def supported_mm(params: TfheParams, plan: ntt_mod.NttPlan, bundle: int = 1) -> bool:
    """Whether the four-step kernels take this set, plan and bundling: the
    JAX package's ``pallas_blind.supported`` with bundle 1 (its
    blind-rotation kernel runs only unbundled keys), on the N they are built
    for, with the digit rows fitting a block (``k4mm_shared_bytes``).  Every
    parameter set's answer is JAX's."""
    return (bundle == 1 and params.l * params.bg_bit <= 32
            and _mm_shape_ok(plan, params.N, params.decomp_rows))


def k4mm_layout(params: TfheParams, plan: ntt_mod.NttPlan | None = None) -> dict:
    """How the four-step kernels lay out a block, a function of N and the
    digit rows only: one ciphertext a block of N/2 threads (``threads``),
    ``rows_padded`` rows of the C-steps' operands (Mr), ``u_bytes`` of U,
    ``shared_bytes`` of dynamic shared memory, and the ``instance`` launched
    as the compiler's report names it.  Raises for what ``supported_mm``
    refuses."""
    plan = plan or bs.bootstrap_plan(params)
    if plan is None or not supported_mm(params, plan):
        raise ValueError(f"{params.name}: not a blind_rotate_mm_kernel instance")
    N, rows = params.N, params.decomp_rows
    return {"threads": N // 2, "rows_padded": _mm_rows(N, rows), "u_bytes": _mm_u_bytes(N, rows),
            "shared_bytes": k4mm_shared_bytes(N, rows),
            "instance": f"blind_rotate_mm_kernelILi{N}E"}


def mm_layout(params: TfheParams) -> dict:
    """The built library's own answer for ``k4mm_layout``'s numbers (its C
    entry ``redsec_mm_layout``)."""
    out = (ctypes.c_int * 4)()
    if _mm_lib().fn["redsec_mm_layout"](params.N, params.decomp_rows, out) != 0:
        raise ValueError(f"{params.name}: no four-step kernel instance")
    return {"shared_bytes": out[0], "rows_padded": out[1], "u_bytes": out[2], "threads": out[3]}


def _require_mm_key(bk: torch.Tensor, ndim: int, N: int) -> None:
    """A four-step key (tensor) is [..., R, C] with N = R * C; a radix-2 one
    ([..., N]) is refused by its shape."""
    rc = ntt_matmul._split_rc(N)
    if bk.ndim != ndim or tuple(bk.shape[-2:]) != rc:
        want = "[P, n, rows, 8, R, C]" if ndim == 6 else "[P, rows, 8, R, C]"
        raise ValueError(f"BK of shape {tuple(bk.shape)} is not a four-step ('matmul') key "
                         f"{want} with (R, C) = {rc}: the four-step kernels and their twins "
                         "take 'matmul' keys only")


def external_product_mm_plain(digits: torch.Tensor, bk_round: torch.Tensor,
                              plan: ntt_mod.NttPlan) -> torch.Tensor:
    """``external_product_plain`` with the four-step pair, on a "matmul"
    key's round slice int16 [P, rows, 8, R, C]."""
    _require_mm_key(bk_round, 5, digits.shape[-1])
    return external_product_plain(digits, bk_round.flatten(-2), plan, *MATMUL)


def cmux_round_mm_plain(acc: torch.Tensor, t: torch.Tensor, bk_round: torch.Tensor,
                        params: TfheParams, plan: ntt_mod.NttPlan) -> torch.Tensor:
    """``cmux_round_plain`` with the four-step pair, on a "matmul" key's round
    slice int16 [P, rows, 8, R, C]."""
    _require_mm_key(bk_round, 5, params.N)
    return cmux_round_plain(acc, t, bk_round.flatten(-2), params, plan, MATMUL)


def blind_rotate_mm_plain(acc0: torch.Tensor, abar: torch.Tensor, bk: torch.Tensor,
                          params: TfheParams, plan: ntt_mod.NttPlan) -> torch.Tensor:
    """The blind rotation of a "matmul" key int16 [P, n', rows', 8, R, C]: the
    JAX package's XLA loop on its matmul branch, in torch (n rounds, or n/2
    bundled ones, of rotate, decompose, ``ntt_matmul.ntt_device_mm`` per
    prime, the exact lazy MAC, the inverse and the CRT:
    ``blind_rotate_plain`` with the four-step pair)."""
    _require_mm_key(bk, 6, params.N)
    return blind_rotate_plain(acc0, abar, bk.flatten(-2), params, plan, MATMUL)


def _require_mm_shape(plan: ntt_mod.NttPlan, N: int, rows: int, what: str,
                      params: TfheParams | None = None) -> None:
    if not _mm_shape_ok(plan, N, rows) or (params is not None and not supported_mm(params, plan)):
        raise ValueError(f"primes {plan.primes} at N={N}, {rows} digit rows: outside what "
                         f"{what} is built for (two ascending primes < 2^15, N in "
                         f"{MM_KERNEL_N}, rows fitting {K4_MAX_SHARED} B, l * bg_bit <= 32)")


def external_product_mm(digits: torch.Tensor, bk_round: torch.Tensor,
                        plan: ntt_mod.NttPlan) -> torch.Tensor:
    """K2-mm: see ``external_product_mm_plain``."""
    _require_mm_key(bk_round, 5, digits.shape[-1])
    if digits.device.type == "cpu":
        return external_product_mm_plain(digits, bk_round, plan)
    M, rows, N = digits.shape
    _require_mm_shape(plan, N, rows, "external_product_mm_kernel")
    dev = digits.device
    R, C = ntt_matmul._split_rc(N)
    _require(digits, "digits", torch.int32, (M, rows, N), dev)
    _require(bk_round, "bk_round", torch.int16, (2, rows, 2 * bs.BK_LIMBS, R, C), dev)
    if digits.data_ptr() % 16:
        raise ValueError("digits must start on a 16-byte boundary")
    tabs = ntt_matmul.kernel_tables_mm(plan, dev)
    delta = torch.empty((M, 2, N), dtype=torch.int32, device=dev)
    _mm_lib().launch("redsec_external_product_mm", "external_product_mm", dev, digits.data_ptr(),
                     bk_round.data_ptr(), rows * 2 * bs.BK_LIMBS * N, tabs["tw"].data_ptr(),
                     tabs["wc"].data_ptr(), delta.data_ptr(), M, N, rows, plan.primes[0],
                     plan.primes[1])
    return delta


def cmux_round_mm(acc: torch.Tensor, t: torch.Tensor, bk_round: torch.Tensor,
                  params: TfheParams, plan: ntt_mod.NttPlan) -> torch.Tensor:
    """K3-mm: see ``cmux_round_mm_plain``."""
    _require_mm_key(bk_round, 5, params.N)
    if acc.device.type == "cpu":
        return cmux_round_mm_plain(acc, t, bk_round, params, plan)
    M, N, rows = acc.shape[0], params.N, params.decomp_rows
    _require_mm_shape(plan, N, rows, "cmux_round_mm_kernel", params)
    dev = acc.device
    R, C = ntt_matmul._split_rc(N)
    _require(acc, "acc", torch.int32, (M, 2, N), dev)
    _require(t, "t", torch.int32, (M,), dev)
    _require(bk_round, "bk_round", torch.int16, (2, rows, 2 * bs.BK_LIMBS, R, C), dev)
    tabs = ntt_matmul.kernel_tables_mm(plan, dev)
    out = torch.empty_like(acc)
    _mm_lib().launch("redsec_cmux_round_mm", "cmux_round_mm", dev, acc.data_ptr(), t.data_ptr(),
                     bk_round.data_ptr(), rows * 2 * bs.BK_LIMBS * N, tabs["tw"].data_ptr(),
                     tabs["wc"].data_ptr(), out.data_ptr(), M, N, *_gadget_args(params),
                     plan.primes[0], plan.primes[1])
    return out


def blind_rotate_mm(acc0: torch.Tensor, abar: torch.Tensor, bk: torch.Tensor,
                    params: TfheParams, plan: ntt_mod.NttPlan) -> torch.Tensor:
    """K4-mm: see ``blind_rotate_mm_plain``.  One launch runs all n rounds,
    one ciphertext a block (``k4mm_layout``); a bundled "matmul" key is
    outside ``supported_mm`` and raises here on CUDA."""
    _require_mm_key(bk, 6, params.N)
    if acc0.device.type == "cpu":
        return blind_rotate_mm_plain(acc0, abar, bk, params, plan)
    B, N, n, rows = acc0.shape[0], params.N, params.n, params.decomp_rows
    _require_mm_shape(plan, N, rows, "blind_rotate_mm_kernel", params)
    dev = acc0.device
    R, C = ntt_matmul._split_rc(N)
    _require(acc0, "acc0", torch.int32, (B, 2, N), dev)
    _require(abar, "abar", torch.int32, (B, n), dev)
    _require(bk, "bk", torch.int16, (2, n, rows, 2 * bs.BK_LIMBS, R, C), dev)
    tabs = ntt_matmul.kernel_tables_mm(plan, dev)
    out = torch.empty_like(acc0)
    _mm_lib().launch("redsec_blind_rotate_mm", "blind_rotate_mm", dev, acc0.data_ptr(),
                     abar.data_ptr(), bk.data_ptr(), tabs["tw"].data_ptr(), tabs["wc"].data_ptr(),
                     out.data_ptr(), B, n, N, *_gadget_args(params), plan.primes[0],
                     plan.primes[1])
    return out
