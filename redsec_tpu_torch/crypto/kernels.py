"""The blind-rotation kernels: their loader, wrappers and plain twins.

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
contiguity, allocates the output with ``torch.empty`` (or its ``new_empty``
and ``empty_like`` forms, which skip parsing a dtype and a device), launches
on the current stream, raises on a non-zero ``cudaGetLastError()``, and
adds one to its count in ``device.launches``.  Nothing falls back to the
twin.

The launch path is kept short, since a kernel of a few microseconds is
paced by the host's work around it.  Each library is a CPython extension
module of its C entries (``csrc/py_entries.cuh``: METH_FASTCALL, no
PyTorch header), each entry bound once by ``Library``, which takes the
current stream's raw handle (``torch._C._cuda_getCurrentRawStream``, as
Triton's launcher does) without building a ``torch.cuda.Stream``.  The
wrappers test each tensor in one expression (``_require_all``) and read a
parameter set's and a plan's constants from caches (``_gadget_args``,
``kernel_tables``, ``fft_tables`` with its addresses, ``_fft_entry``,
``ntt_matmul.kernel_tables_mm``, ``_mm_shape_ok``); the C entries opt each
kernel in to its shared memory and read the SM count once per instance and
device (``csrc/launch_once.cuh``).  ``schoolbook_rounds`` runs a PBS's n
rounds of the schoolbook round kernel from one C loop.

The library is built with ``nvcc`` (and Python's headers) into
``build/kernels/`` at the root of the checkout on first use
(``build_library``, shared with ``probe_kernels.py``); importing this
module needs no compiler.  The NTT-domain order of every key tensor these
take is the radix-2 bit-reversed order of ``ntt.ntt_device`` (flavour
"radix2"), and BK residues are 16-bit patterns of int16 (``residues``
zero-extends them).

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
``k4mm_layout``; a radix-2 key raises in them by its shape.  The two
one-round kernels launch a ciphertext's round on one block or on a cluster
pair, one prime a block (``round_mm_split``, from the batch and the card's occupancy; the layout
mirror ``round_mm_layout``), and are the per-round path of
``bootstrap.make_bootstrap_impl(round_kernel=...)``.

A further kernel, ``schoolbook_product`` (S1, ``csrc/schoolbook.cu``), is the
external product of the parameter sets without NTT primes (N >= 4096), and
of any set prepared with ``schoolbook=True``: the JAX package computes it as
an XLA int8 convolution (``redsec_tpu/crypto/bootstrap.py:517-556``), not in
Pallas.  S1 computes JAX's limb formulation, exactly, on the int8 tensor
cores; its twin is an exact float64 FFT product.

The last, ``key_switch`` (``csrc/key_switch.cu``), ends every PBS: the
digits of the extracted mask against the key-switching key's int8 limbs,
made once by ``bootstrap.prepare_cloud_key`` in the kernel's tiled order
(``ksk_tiles``), as u8 x s8 products on the int8 tensor cores.  The JAX
package computes it as an XLA ``dot_general`` a limb
(``redsec_tpu/crypto/bootstrap.py:456``); the twin, ``key_switch_plain``,
is that formula in torch.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import importlib.util
import math
import os
import shutil
import subprocess
import sysconfig

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
CSRC = os.path.join(_PKG, "csrc")  # the shared headers (launch_once.cuh, py_entries.cuh)
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
    date with the source and the headers beside it (``force`` compiles
    anyway).  Returns the compiler's messages (``-Xptxas -v``: registers,
    shared memory, spills per kernel), empty when nothing was built.  Raises
    with the compiler's output if nvcc fails."""
    lib = library_path(source)
    inputs = [source, *glob.glob(os.path.join(CSRC, "*.cuh"))]
    if (not force and os.path.exists(lib)
            and os.path.getmtime(lib) >= max(map(os.path.getmtime, inputs))):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    includes = {CSRC, sysconfig.get_paths()["include"], sysconfig.get_paths()["platinclude"]}
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, *(f"-I{d}" for d in sorted(includes)), "-o",
                          tmp, source], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) on {source}:\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib)
    return res.stdout + res.stderr


# the raw handle of a device's current stream, read without building a
# torch.cuda.Stream (Triton's launcher reads it so); a build without CUDA,
# which launches nothing, has no such reader
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
OTHER_DEVICE = -1  # a launch entry's answer when its device is not the current one


class LaunchError(RuntimeError):
    """A launch entry's non-zero answer ``code``."""

    def __init__(self, msg: str, code: int):
        super().__init__(msg)
        self.code = code


class Library:
    """A built and loaded library of one CUDA source, which is a CPython
    extension module of its extern "C" entries (``csrc/py_entries.cuh``:
    plain C API, one METH_FASTCALL function an entry, arguments as Python
    ints, an array by its ``ctypes.addressof``).  ``entries`` names the
    entries, each bound once here; each returns an int.  One that launches a
    kernel takes the device index first and the stream last, and returns
    ``OTHER_DEVICE`` without launching where that device is not the current
    one, else the ``cudaGetLastError()`` of its launch.
    ``redsec_error_string`` gives a code's text."""

    def __init__(self, source: str, entries):
        build_library(source)
        path = library_path(source)
        spec = importlib.util.spec_from_file_location(
            os.path.splitext(os.path.basename(path))[0], path)
        lib = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(lib)
        self.fn = {name: getattr(lib, name) for name in entries}
        self.lib = lib

    def launch(self, entry: str, kernel: str, dev: int, *args, count: int = 1,
               failed: ctypes.c_int | None = None) -> None:
        """Call ``entry(dev, *args, stream)`` on the current stream of CUDA
        device ``dev`` (an index), raise on a non-zero ``cudaGetLastError()``
        and add ``count`` to ``kernel``'s launch count.  The entry holds
        ``dev`` against the current device in C; the device guard is entered,
        and the entry called again, only when it is another.  ``failed``: the
        cell an entry that launches several times writes the failing launch's
        round to, named in the error."""
        fn = self.fn[entry]
        code = fn(dev, *args, _raw_stream(dev))
        if code == OTHER_DEVICE:
            with torch.cuda.device(dev):
                code = fn(dev, *args, _raw_stream(dev))
        if code:
            msg = self.lib.redsec_error_string(code)
            where = "" if failed is None else f" at round {failed.value}"
            raise LaunchError(f"CUDA kernel {kernel} failed{where}: {msg} ({code})", code)
        launches.bump(kernel, count)


_ENTRIES = ("redsec_ntt", "redsec_external_product", "redsec_cmux_round", "redsec_blind_rotate",
            "redsec_blind_rotate_config")
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


def _require_all(dev: int, *specs) -> None:
    """``_require`` of each (tensor, name, dtype, shape) on CUDA device
    ``dev`` (an index), each tensor tested in one expression; ``_require``
    runs only to name the first check that fails, with its own error."""
    for t, name, dtype, shape in specs:
        if not (t.dtype is dtype and t.shape == shape and t.get_device() == dev
                and t.is_contiguous()):
            _require(t, name, dtype, shape, torch.device("cuda", dev))


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


def kernel_tables(plan: ntt_mod.NttPlan, device: torch.device) -> torch.Tensor:
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
    if x.is_cpu:
        return ntt_plain(x, plan, pi, inverse)
    _require_cuda_plan(plan)
    M, dev = x.shape[0], x.get_device()
    _require_all(dev, (x, "x", torch.int32, (M, plan.N)))
    tabs = kernel_tables(plan, x.device)
    y = torch.empty_like(x)
    tab = tabs.data_ptr() + pi * 4 * plan.N * 8  # this prime's [4, N, 2] int32
    _lib().launch("redsec_ntt", "ntt", dev, x.data_ptr(), y.data_ptr(), tab, M,
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
    if digits.is_cpu:
        return external_product_plain(digits, bk_round, plan)
    _require_round_plan(plan)
    M, rows, N = digits.shape
    dev = digits.get_device()
    _require_all(dev, (digits, "digits", torch.int32, (M, rows, plan.N)),
                 (bk_round, "bk_round", torch.int16, (2, rows, 2 * bs.BK_LIMBS, N)))
    tabs = kernel_tables(plan, digits.device)
    delta = digits.new_empty((M, 2, N))  # int32, as the digits (checked)
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


_GADGET: dict = {}


def _gadget_args(params: TfheParams) -> tuple[int, int, int]:
    """(l, bg_bit, ``bs.gadget_offset``) of a parameter set, computed once a
    (l, bg_bit): the offset depends on nothing else."""
    args = _GADGET.get((params.l, params.bg_bit))
    if args is None:
        args = _GADGET[params.l, params.bg_bit] = (params.l, params.bg_bit,
                                                   bs.gadget_offset(params))
    return args


def cmux_round(acc: torch.Tensor, t: torch.Tensor, bk_round: torch.Tensor,
               params: TfheParams, plan: ntt_mod.NttPlan) -> torch.Tensor:
    """K3: see ``cmux_round_plain`` (two primes, N up to 1024)."""
    if acc.is_cpu:
        return cmux_round_plain(acc, t, bk_round, params, plan)
    _require_round_plan(plan)
    M, N, rows = acc.shape[0], params.N, params.decomp_rows
    dev = acc.get_device()
    _require_all(dev, (acc, "acc", torch.int32, (M, 2, N)), (t, "t", torch.int32, (M,)),
                 (bk_round, "bk_round", torch.int16, (2, rows, 2 * bs.BK_LIMBS, N)))
    tabs = kernel_tables(plan, acc.device)
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
    if acc0.is_cpu:
        return blind_rotate_plain(acc0, abar, bk, params, plan)
    bundle = key_bundle(bk, params)
    if not supported(params, plan, bundle):
        raise ValueError(f"{params.name}: primes {plan.primes} at N={plan.N}, bundle "
                         f"{bundle}: outside what blind_rotate_kernel is built for")
    B, N, n, rows = acc0.shape[0], params.N, params.n, params.decomp_rows
    dev = acc0.get_device()
    _require_all(dev, (acc0, "acc0", torch.int32, (B, 2, N)), (abar, "abar", torch.int32, (B, n)),
                 (bk, "bk", torch.int16, (len(plan.primes), n // bundle,
                                          rows * (3 if bundle == 2 else 1), 2 * bs.BK_LIMBS, N)))
    tabs = kernel_tables(plan, acc0.device)
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
    out = (ctypes.c_int * 7)()
    code = _lib().fn["redsec_blind_rotate_config"](batch, params.N, params.l, len(plan.primes),
                                                   bundle, sm_count, ctypes.addressof(out))
    if code != 0:
        raise ValueError(f"blind_rotate_kernel has no instance for N={params.N}, "
                         f"{len(plan.primes)} primes, bundle {bundle}")
    N, P, D = params.N, len(plan.primes), 3 if bundle == 2 else 1
    return {"group": out[0], "chunk_rows": out[1], "shared_bytes": out[2],
            "tables_resident": bool(out[3]), "tables_refilled": not out[3],
            "accumulators_on_r2": bool(out[5]), "sums_on_differences": bool(out[6]),
            "instance": _k4_instance(N, out[0], P, D), "shared_bytes_g2": out[4]}


# K4's layout (csrc/pbs.cu: Geo, Smem, k4_chunk, k4_config), mirrored so that
# the CPU tests can hold it: shared memory a block may have on sm_90
K4_MAX_SHARED = 232448


def k4_shared_bytes(N: int, group: int, primes: int, diffs: int, chunk: int,
                    tables: int, alias: bool = False, on_diff: bool = False) -> int:
    """Dynamic shared bytes of ``Smem<N, group, primes, diffs>`` with ``chunk``
    digit rows a chunk and the stage tables of ``tables`` primes: the tables
    (uint2 [tables][2][N]), the exchange buffers ([POLYS][2][N + N/16 padded]
    words, the key ring in the MAC), accumulators and differences ([group]
    [1 + diffs][2][N] words; [group][diffs][2][N] with ``alias``, where the
    accumulators lie on the last region), digit rows and the last prime's
    MAC sums (uint16 [group * max(chunk, 8)][N]; [group * chunk][N] with
    ``on_diff``, where those sums lie on the differences) and the MAC sums of
    all primes but the last (uint16 [primes - 1][group * 8][N])."""
    polys = 8 if N <= 1024 else 4
    xw = N + N // 16  # N + 16 * S words, S = N / 256
    accs = diffs if alias else 1 + diffs
    r1 = group * (chunk if on_diff else max(chunk, 8))
    return (8 * tables * 2 * N + 4 * (polys * 2 * xw + accs * group * 2 * N)
            + 2 * (r1 * N + (primes - 1) * group * 8 * N))


def _k4_regions(N: int, group: int, primes: int, diffs: int) -> tuple:
    """The first of these layouts that fits at the smallest chunk, each giving
    up one more region of its own: every prime's stage tables (N <= 1024);
    one prime's, refilled half by half; the accumulators on the region of the
    MAC sums, idle between rounds (``alias``); the last prime's MAC sums on
    the differences, dead once its last forward transforms have cut their
    digits (``on_diff``, a bundled round's three differences only).  Returns
    (tables, alias, on_diff): primes whose tables stay and the two flags."""
    smallest = (8 if N <= 1024 else 4) // group

    def fits(tables, alias=False, on_diff=False):
        return k4_shared_bytes(N, group, primes, diffs, smallest, tables, alias,
                               on_diff) <= K4_MAX_SHARED

    tables = primes if N <= 1024 and fits(primes) else 1
    alias = not fits(tables)
    on_diff = diffs == 3 and alias and not fits(tables, True)
    return tables, alias, on_diff


def _k4_chunk(N: int, group: int, primes: int, diffs: int, rows: int) -> int:
    """The largest chunk of digit rows that fits at ``group`` ciphertexts a
    block: all rows, else a multiple of POLYS / group; 0 where none fits
    (the instance is not built)."""
    step = (8 if N <= 1024 else 4) // group
    tables, alias, on_diff = _k4_regions(N, group, primes, diffs)
    if k4_shared_bytes(N, group, primes, diffs, step, tables, alias, on_diff) > K4_MAX_SHARED:
        return 0
    cr = rows
    while k4_shared_bytes(N, group, primes, diffs, cr, tables, alias, on_diff) > K4_MAX_SHARED:
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
    memory; else ``tables_refilled``: one prime's region, refilled half by
    half with the next prime's tables by ``cp.async`` as soon as each half is
    dead (the forward half riding with a key row of the prime's last chunk,
    the inverse half issued as the prime starts), so the launch stages tables
    once and no block waits for them (``small``, bundled ``small_v2_tpu`` and
    ``small_v2_tpu2`` at two ciphertexts a block, both N = 2048 instances);
    ``accumulators_on_r2``: the accumulators lie on the region of the MAC
    sums, carried in registers through each round, and
    ``sums_on_differences``: the last prime's MAC sums lie on the round's
    differences, so that the digit rows' region holds the chunk's rows only
    (each taken only where the layout before it does not fit: bundled at
    N = 2048, and bundled ``small_v2_tpu2`` at two a block, which takes
    both); ``instance``: the kernel launched, as the compiler's report names
    it.  Whatever the layout, in the MAC each thread copies 16-byte runs of
    each key row (eight coefficients of N / T of the limb polynomials) by
    ``cp.async.cg``, past L1, and multiplies just those at one ciphertext a
    block, or at two its N / T coefficients of all eight limb polynomials,
    copied by its warp; a chunk's first key rows start in the ring slots on
    the exchange buffers' x0 halves during the last pass of its last forward
    transforms.
    Raises for a combination ``supported`` refuses."""
    plan = plan or bs.bootstrap_plan(params, bundle == 2)
    if plan is None or not supported(params, plan, bundle):
        raise ValueError(f"{params.name}, bundle {bundle}: not a blind_rotate_kernel instance")
    N, P, D = params.N, len(plan.primes), 3 if bundle == 2 else 1
    rows = D * params.decomp_rows
    cr2 = _k4_chunk(N, 2, P, D, rows)
    group = 2 if batch > sm_count and cr2 > 0 else 1
    cr = cr2 if group == 2 else _k4_chunk(N, 1, P, D, rows)
    tables, alias, on_diff = _k4_regions(N, group, P, D)
    return {"group": group, "chunk_rows": cr,
            "shared_bytes": k4_shared_bytes(N, group, P, D, cr, tables, alias, on_diff),
            "tables_resident": tables == P, "tables_refilled": tables < P,
            "accumulators_on_r2": alias, "sums_on_differences": on_diff,
            "instance": _k4_instance(N, group, P, D)}


# --------------------------------------------------------------------------- #
# S1: the schoolbook external product (the sets without NTT primes)           #
# --------------------------------------------------------------------------- #

_SB_ENTRIES = ("redsec_schoolbook_product", "redsec_schoolbook_tile")
_sb_loaded: list[Library] = []
SCHOOLBOOK_MAX_HALF_BG = 512  # two s8 limbs of a digit: lo in [-128, 127], hi in [-2, 2]
SCHOOLBOOK_MAX_ROWS = 64
_E = 2.0 ** -53  # float64's unit roundoff


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
    if _sb_lib().fn["redsec_schoolbook_tile"](B, N, half_bg, sms, ctypes.addressof(out)) != 0:
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
    ||digits_r||_2 x ||half_r||_2, times that factor.  The powers are taken
    through log1p: in float64 1 + 2^-53 is 1, and (1 + e)^3k with it."""
    L = 2 * digits.shape[-1]
    k = L.bit_length() - 1
    e = _E
    factor = math.expm1(3 * k * math.log1p(e) + (3 * k + 1) * math.log1p(5 ** 0.5 * e)
                        + 3 * k * math.log1p(4 * e))
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
    if digits.is_cpu:
        return schoolbook_product_plain(digits, bk_round, half_bg)
    if digits.ndim != 3:
        raise ValueError(f"digits has shape {tuple(digits.shape)}, expected [B, rows, N]")
    B, rows, N = digits.shape
    if N not in SCHOOLBOOK_N or not 1 <= rows <= SCHOOLBOOK_MAX_ROWS or B < 1:
        raise ValueError(f"schoolbook_kernel takes N in {SCHOOLBOOK_N} and "
                         f"1..{SCHOOLBOOK_MAX_ROWS} digit rows; "
                         f"got digits of shape {tuple(digits.shape)}")
    flush_rows = schoolbook_flush_rows(N, half_bg)
    dev = digits.get_device()
    _require_all(dev, (digits, "digits", torch.int32, (B, rows, N)),
                 (bk_round, "bk_round", torch.int32, (rows, 2, N)))
    out = digits.new_empty((B, 2, N))  # int32, as the digits (checked)
    for name, t in (("digits", digits), ("bk_round", bk_round)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    _sb_lib().launch("redsec_schoolbook_product", "schoolbook_product", dev, digits.data_ptr(),
                     bk_round.data_ptr(), out.data_ptr(), B, rows, N, half_bg, flush_rows)
    return out


# --------------------------------------------------------------------------- #
# S1-fft: the whole schoolbook CMUX round on the key's spectra                #
# (csrc/schoolbook_fft.cu)                                                    #
# --------------------------------------------------------------------------- #

SBFFT_SOURCE = os.path.join(_PKG, "csrc", "schoolbook_fft.cu")
SBFFT_N = (256, 512, 1024, 2048, 4096, 8192)  # N the round kernel is instantiated for
_SBF_ENTRIES = ("redsec_schoolbook_round", "redsec_schoolbook_rounds")
_sbf_loaded: list[Library] = []
_fft_cache: dict = {}  # (N, device index; -1 the CPU) -> _fft_entry
_LIBRARY_TWIDDLE_ERROR = 4 * _E  # what the bounds take for torch.fft's own twiddles


def _sbf_lib() -> Library:
    if not _sbf_loaded:
        _sbf_loaded.append(Library(SBFFT_SOURCE, _SBF_ENTRIES))
    return _sbf_loaded[0]


def _fft_tables_host(N: int) -> tuple[np.ndarray, np.ndarray, float]:
    """The round kernel's twiddles at N (M = N / 2), computed in long double
    and rounded once to complex128: W_M^m = exp(-2 pi i m / M) and the twist
    zeta^j = exp(i pi j / N), m, j < M; and the largest error of either table
    against its long double value, plus 16 long double ulps for that value's
    own error (its argument and cos/sin)."""
    M = N // 2
    pi = np.longdouble("3.14159265358979323846264338327950288")
    m = np.arange(M).astype(np.longdouble)
    err = 0.0
    tabs = []
    for ang in (-2 * pi * m / M, pi * m / N):
        c, s = np.cos(ang), np.sin(ang)
        t = c.astype(np.float64) + 1j * s.astype(np.float64)
        err = max(err, float(np.max(np.hypot(t.real - c, t.imag - s))))
        tabs.append(t)
    return tabs[0], tabs[1], err + 16 * float(np.finfo(np.longdouble).eps)


def fft_pass_index(N: int) -> np.ndarray:
    """Where the round kernel's passes read their twiddles: entry i of its
    table is W_M^idx[i] (M = N / 2), pass by pass.  A radix-8 pass that has
    sub-transforms of Ns points done (Ns = 4, 32, ... below M / RL, the last
    pass's radix RL in 2, 4, 8 making the radices multiply to M) reads
    W_M^(k r M / (8 Ns)) at Ns - 4 + (r - 1) Ns + k, r = 1..7, k < Ns; the
    last pass reads W_M^(j r) at J - 4 + (r - 1) J + j, r < RL, j < J =
    M / RL: M - 4 entries, and the threads of a warp read consecutive ones
    (``schoolbook_fft.cu``'s ``pass`` and ``last_pass``)."""
    M = N // 2
    RL = {0: 8, 1: 2, 2: 4}[(M.bit_length() - 3) % 3]
    idx = []
    Ns = 4
    while Ns < M // RL:
        idx += [k * r * (M // (8 * Ns)) for r in range(1, 8) for k in range(Ns)]
        Ns *= 8
    J = M // RL
    idx += [j * r for r in range(1, RL) for j in range(J)]
    return np.array(idx, dtype=np.int64)


def _fft_entry(N: int, index: int) -> tuple:
    """(twiddles, twist, their two addresses) on CUDA device ``index`` (-1:
    the CPU), built once a (N, device index) and kept; the tensors stay alive
    in the cache, so the addresses stay good."""
    ent = _fft_cache.get((N, index))
    if ent is None:
        dev = torch.device("cpu") if index < 0 else torch.device("cuda", index)
        tw, twist, _ = _fft_tables_host(N)
        tabs = (torch.as_tensor(tw[fft_pass_index(N)], device=dev),
                torch.as_tensor(twist, device=dev))
        ent = _fft_cache[N, index] = tabs + (tabs[0].data_ptr(), tabs[1].data_ptr())
    return ent


def fft_tables(N: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(the round kernel's twiddles W_M^m in its passes' order,
    ``fft_pass_index``; zeta^j) as complex128 tensors on ``device``
    (``_fft_tables_host``: the same values, rounded once from long double),
    built once per N and device (``_fft_entry``)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return _fft_entry(N, -1)[:2]
    return _fft_entry(N, torch.cuda.current_device() if dev.index is None else dev.index)[:2]


def fft_twiddle_error(N: int) -> float:
    """The largest error of the round kernel's twiddles at N (absolute; every
    twiddle has modulus 1), from their long double values."""
    return _fft_tables_host(N)[2]


def schoolbook_fft_error_bound(N: int, rows: int, half_bg: int, half_norm_sum: float) -> float:
    """An a-priori bound on the largest error of the values the round kernel
    and its twin round to integers, for ``rows`` digit rows with digits in
    [-half_bg, half_bg) and key halves whose 2-norms sum over the rows to at
    most ``half_norm_sum`` (for every round, polynomial and half).

    Percival's Theorem 5.1 ("Rapid multiplication modulo the sum and
    difference of highly composite numbers", Math. Comp. 72 (2003)): a cyclic
    convolution of length 2^k through three float64 FFTs (forward, forward,
    pointwise product, inverse) is off by less than ||x||_2 ||y||_2
    ((1 + e)^3k (1 + sqrt(5) e)^(3k+1) (1 + b)^3k - 1), e = 2^-53, b the
    twiddles' error.  Re-derived for the twisted transform the kernel uses
    (``csrc/schoolbook_fft.cu``): length M = N / 2 (k = log2 M), each of the
    three transforms with one more complex product by a tabled root (the
    twist, or the untwist), and the rows products summed in the frequency
    domain before the inverse (rows - 1 more roundings).  The fold and twist
    keep the 2-norm of a real row (|zeta^j| = 1), so x and y are a digit row
    and a key half: ||x||_2 <= half_bg sqrt(N), the worst case whatever the
    data, and the halves' norms are the prepared key's.  b is the larger of
    the kernel's own twiddles' error (``fft_twiddle_error``) and 4e, taken
    for torch.fft's (the key's spectra, and every transform of the twin); the
    key's spectra are stored as their FFT rounds them, so their rounding is
    the last level of that transform.  The powers are taken through log1p
    (1 + 2^-53 is 1 in float64).  With the halves at their largest
    (2^15 sqrt(N) each, any key): ``medium`` 0.01212, ``large`` 0.02622,
    ``medium_v2`` 0.00407, ``large_v2`` 0.008803, forced ``small_v2_tpu``
    0.0001626; a uniformly random key's halves (2^15 sqrt(N / 3)) give about
    0.58 of that (``schoolbook_key_bound``; the prepared keys' values are in
    PERF.md section 6)."""
    M = N // 2
    k = M.bit_length() - 1
    b = max(_LIBRARY_TWIDDLE_ERROR, fft_twiddle_error(N))
    log_factor = ((3 * k + rows - 1) * math.log1p(_E)
                  + (3 * (k + 1) + 1) * math.log1p(5 ** 0.5 * _E)
                  + 3 * (k + 1) * math.log1p(b))
    return half_bg * math.sqrt(N) * half_norm_sum * math.expm1(log_factor)


def _key_halves(bk: torch.Tensor) -> torch.Tensor:
    """int32 [..., N] -> float64 [..., 2, N]: its sign-balanced 16-bit halves
    lo, hi with bk = lo + 2^16 hi (|lo|, |hi| <= 2^15)."""
    b = bk.to(torch.int64)
    lo = ((b + (1 << 15)) & 0xFFFF) - (1 << 15)
    return torch.stack([lo, (b - lo) >> 16], dim=-2).to(torch.float64)


def _twisted_dft(x: torch.Tensor, twist: torch.Tensor) -> torch.Tensor:
    """float64 [..., N] -> complex128 [..., N / 2]: the DFT of the twisted
    fold (x[j] + i x[j + N/2]) zeta^j."""
    M = x.shape[-1] // 2
    return torch.fft.fft(torch.complex(x[..., :M], x[..., M:]) * twist)


def key_spectra(bk: torch.Tensor) -> torch.Tensor:
    """Raw BK rounds int32 [..., rows, 2, N] -> their spectra complex128
    [..., rows, 2, 2, N / 2] ([u][half]: the twisted DFT of each 16-bit
    half), on ``bk``'s device; the operand the round kernel reads."""
    return _twisted_dft(_key_halves(bk), fft_tables(bk.shape[-1], bk.device)[1])


def prepare_key_spectra(bk: torch.Tensor, params: TfheParams, chunk: int) -> torch.Tensor:
    """A schoolbook key's spectra [n, rows, 2, 2, N / 2] from its raw BK
    int32 [n, rows, 2, N] on the BK's device, ``chunk`` rounds at a time.
    Raises unless ``schoolbook_fft_error_bound`` at the worst-case digits
    and this key's halves is below 1/2: then every product the round kernel
    and its twin compute rounds to the exact integer, whatever the data."""
    n, rows, _, N = bk.shape
    if N not in SBFFT_N:
        raise ValueError(f"{params.name}: the schoolbook round kernel takes N in {SBFFT_N}, "
                         f"not {N}")
    bound = schoolbook_key_bound(bk, params, chunk)
    if not bound < 0.5:
        raise ValueError(f"{params.name}: the float64 round could round wrongly (a-priori "
                         f"error bound {bound:.3g} >= 1/2 at Bg/2 = {params.half_bg}, N = {N})")
    spectra = torch.empty((n, rows, 2, 2, N // 2), dtype=torch.complex128, device=bk.device)
    for i0 in range(0, n, chunk):
        spectra[i0:i0 + chunk] = key_spectra(bk[i0:i0 + chunk])
    return spectra


def schoolbook_key_bound(bk: torch.Tensor, params: TfheParams, chunk: int = 64) -> float:
    """``schoolbook_fft_error_bound`` for the raw BK int32 [n, rows, 2, N]:
    the worst-case digits of ``params`` against the largest sum over the
    rows of this key's halves' 2-norms (any round, polynomial and half),
    ``chunk`` rounds at a time."""
    n, rows, _, N = bk.shape
    norm_sum = max(float(_key_halves(bk[i0:i0 + chunk]).norm(dim=-1).sum(dim=1).amax())
                   for i0 in range(0, n, chunk))
    return schoolbook_fft_error_bound(N, rows, params.half_bg, norm_sum)


def schoolbook_fft_product_plain(digits: torch.Tensor, spectra_round: torch.Tensor,
                                 half_bg: int) -> torch.Tensor:
    """digits int32 [B, rows, N] in [-half_bg, half_bg) x one round's key
    spectra complex128 [rows, 2, 2, N / 2] -> delta int32 [B, 2, N]: the same
    function as ``schoolbook_product_plain`` on the raw round, computed as
    the round kernel computes it (the twisted length-N/2 transforms, see
    ``csrc/schoolbook_fft.cu``) with torch.fft.  Exact while
    ``schoolbook_fft_error_bound`` is below 1/2, which ``prepare_key_spectra``
    asserts for every prepared key.  Raises on a digit outside
    [-half_bg, half_bg)."""
    if digits.numel():
        lo, hi = torch.stack(torch.aminmax(digits)).tolist()
        if not (lo >= -half_bg and hi < half_bg):
            raise ValueError(f"digits outside [-{half_bg}, {half_bg}): [{lo}, {hi}]")
    B, rows, N = digits.shape
    if tuple(spectra_round.shape) != (rows, 2, 2, N // 2):
        raise ValueError(f"key spectra of shape {tuple(spectra_round.shape)}, expected "
                         f"{(rows, 2, 2, N // 2)} for digits {tuple(digits.shape)}")
    twist = fft_tables(N, digits.device)[1]
    fd = _twisted_dft(digits.to(torch.float64), twist)  # [B, rows, M]
    spec = None
    for r in range(rows):
        term = fd[:, r, None, None, :] * spectra_round[r][None]
        spec = term if spec is None else spec + term
    z = torch.fft.ifft(spec) * twist.conj()  # [B, 2, 2, M]
    v = torch.round(torch.cat([z.real, z.imag], dim=-1)).to(torch.int64)
    out = v[:, :, 0] + (v[:, :, 1] << 16)
    return (((out + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def schoolbook_round_plain(acc: torch.Tensor, t: torch.Tensor, spectra_round: torch.Tensor,
                           params: TfheParams, out: torch.Tensor | None = None) -> torch.Tensor:
    """One schoolbook CMUX round: acc [B, 2, N] + the external product of
    decompose(X^t acc - acc) (``bootstrap.RoundOps``) with the round's key
    spectra, in torch (``schoolbook_fft_product_plain``); written into
    ``out`` when it is given."""
    _require_spectra(spectra_round)
    ops = bs.RoundOps(params)
    digits = ops.decompose(ops.rotate(acc, t) - acc)
    res = acc + schoolbook_fft_product_plain(digits, spectra_round, params.half_bg)
    return res if out is None else out.copy_(res)


def _require_spectra(spectra_round) -> None:
    if spectra_round is None:
        raise ValueError("the schoolbook round needs the key's spectra (DeviceCloudKey.spectra, "
                         "made by prepare_cloud_key); this key has none")


SBFFT_ROLES = 4  # blocks a ciphertext: one accumulated spectrum (u, half) each


def sbfft_pad(i):
    """Where position i of a transform lies in the round kernel's buffer
    (``schoolbook_fft.cu``'s ``pad``): one padding entry after every 8."""
    return i + (i >> 3)


SBFFT_SLOTS = 2  # digit rows a block transforms in a chunk


def schoolbook_round_layout(N: int, rows: int | None = None) -> dict:
    """How the round kernel lays out a launch at N (the rule of
    ``schoolbook_fft.cu``'s ``kR``, ``kSlots``, ``Shape<M>`` and
    ``launch<M>``): a ``cluster`` of 4 blocks for each of its
    ``ciphertexts`` (2 at N >= 512, 1 at N = 256); ``threads``
    a block (N / 16, at least 32); ``shared_bytes`` a block: a transform
    buffer of N / 2 complex128 with one padding entry after every 8
    (``sbfft_pad``), and an inbox of the chunk's row spectra's slices, N
    complex128; the ``instance`` as the compiler's report names it (a
    second instance carries the MAC's sums from chunk to chunk where rows >
    ``rows_a_chunk``).  With ``rows``, also who does what, block c of a
    cluster working for its ciphertext e = c // 4 in role c % 4:
    ``chunks``, for each chunk of 8 digit rows, the rows of its ciphertext
    role c % 4 transforms (``chunks[k][role][s]``), each spectrum's slice
    of bins ``bins[o]`` going to block o's inbox; ``bins[c]``, the range of
    spectrum bins whose sums block c accumulates for every ciphertext of the
    cluster, reading each key value once, and sends to the block that
    inverts them; ``inverts[c]``, the ciphertext and the accumulated
    spectrum (u, half) block c inverts; ``swap``, the pairs of blocks of
    one polynomial, which hand each other the rounded values of the half
    they do not store; and ``stores[c]``, the ciphertext, polynomial and
    coefficient range block c recombines (lo + 2^16 hi), adds acc to and
    stores."""
    if N not in SBFFT_N:
        raise ValueError(f"the schoolbook round kernel takes N in {SBFFT_N}, not {N}")
    M, R, S = N // 2, SBFFT_ROLES, SBFFT_SLOTS
    CT = 2 if M >= 256 else 1
    C = R * CT
    multi = rows is not None and rows > R * S
    lay = {"cluster": C, "ciphertexts": CT, "threads": max(32, M // 8), "rows_a_chunk": R * S,
           "shared_bytes": 16 * (sbfft_pad(M) + 2 * M),
           "instance": f"schoolbook_round_kernelILi{M}ELb{int(multi)}E"}
    if rows is not None:
        lay["chunks"] = [[list(range(r0 + role, min(r0 + R * S, rows), R)) for role in range(R)]
                         for r0 in range(0, rows, R * S)]
        lay["bins"] = [(c * M // C, (c + 1) * M // C) for c in range(C)]
        lay["inverts"] = [(c // R, c % R // 2, c % 2) for c in range(C)]
        lay["swap"] = [(c, c + 1) for c in range(0, C, 2)]
        lay["stores"] = [(c // R, c % R // 2, (c % 2) * M, (c % 2 + 1) * M) for c in range(C)]
    return lay


def schoolbook_round(acc: torch.Tensor, t: torch.Tensor, spectra_round: torch.Tensor,
                     params: TfheParams, out: torch.Tensor | None = None) -> torch.Tensor:
    """S1-fft: one schoolbook CMUX round in one launch, see
    ``schoolbook_round_plain``: rotate, difference, decompose, the forward
    transforms, the product with the round's key spectra [rows, 2, 2, N/2]
    (``DeviceCloudKey.spectra[i]``), the inverse, rounding, and the add, with
    no digit in memory.  ``out`` may be ``acc`` itself.  Takes N in
    ``SBFFT_N`` with rows = 2 l; raises on anything else, and on a key
    without spectra."""
    _require_spectra(spectra_round)
    if acc.is_cpu:
        return schoolbook_round_plain(acc, t, spectra_round, params, out)
    B, N, rows = acc.shape[0], params.N, params.decomp_rows
    _require_round_set(params)
    dev = acc.get_device()
    if out is None:
        out = torch.empty_like(acc)
    _require_all(dev, (acc, "acc", torch.int32, (B, 2, N)), (t, "t", torch.int32, (B,)),
                 (spectra_round, "spectra_round", torch.complex128, (rows, 2, 2, N // 2)),
                 (out, "out", torch.int32, (B, 2, N)))
    pa, ps, po = acc.data_ptr(), spectra_round.data_ptr(), out.data_ptr()
    if (pa | ps | po) % 16:
        _require_aligned(("acc", pa), ("spectra_round", ps), ("out", po))
    if B == 0:
        return out
    _sbf_lib().launch("redsec_schoolbook_round", "schoolbook_round", dev, pa, t.data_ptr(), ps,
                      *_fft_entry(N, dev)[2:], po, B, N, rows, *_gadget_args(params))
    return out


def _require_round_set(params: TfheParams) -> None:
    if params.N not in SBFFT_N or params.l * params.bg_bit > 32:
        raise ValueError(f"{params.name}: the schoolbook round kernel takes N in {SBFFT_N} "
                         f"and l * bg_bit <= 32")


def _require_aligned(*ptrs) -> None:
    """Raise for the first (name, address) not on a 16-byte boundary."""
    for name, ptr in ptrs:
        if ptr % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def schoolbook_rounds_plain(acc: torch.Tensor, ts: torch.Tensor, spectra: torch.Tensor,
                            params: TfheParams) -> torch.Tensor:
    """``schoolbook_rounds``' function in torch on any device: round i is
    ``schoolbook_round_plain(acc, ts[i], spectra[i], params)``."""
    _require_spectra(spectra)
    out = acc.clone()
    for i in range(ts.shape[0]):
        out = schoolbook_round_plain(out, ts[i], spectra[i], params)
    return out


def schoolbook_rounds(acc: torch.Tensor, ts: torch.Tensor, spectra: torch.Tensor,
                      params: TfheParams) -> torch.Tensor:
    """The n = ``ts.shape[0]`` schoolbook CMUX rounds of a PBS: round i is
    ``schoolbook_round`` on the accumulator round i - 1 left (``acc`` for
    round 0), the exponents ``ts[i]`` (int32 [n, B]: round i's in row i)
    and the key's spectra ``spectra[i]`` ([n, rows, 2, 2, N/2],
    ``DeviceCloudKey.spectra``), on two buffers in turn; ``acc`` is not
    written and the result is a new tensor.

    On the CPU each round is a call of ``schoolbook_round``, looked up on
    this module at call time.  On CUDA the batch and the key are checked
    once, and one C entry launches the n round kernels from a loop in C on
    the current stream, reading ``cudaGetLastError()`` after each launch: the
    first error raises with the round it came from.  ``device.launches``
    counts n launches of ``schoolbook_round``.  This is the counterpart of
    the JAX package's loop over the rounds inside one program."""
    _require_spectra(spectra)
    n = ts.shape[0]
    if acc.is_cpu:
        bufs = (torch.empty_like(acc), torch.empty_like(acc))
        for i in range(n):
            acc = schoolbook_round(acc, ts[i], spectra[i], params, out=bufs[i % 2])
        return acc.clone() if n == 0 else acc
    B, N, rows = acc.shape[0], params.N, params.decomp_rows
    _require_round_set(params)
    dev = acc.get_device()
    bufs = (torch.empty_like(acc), torch.empty_like(acc))
    _require_all(dev, (acc, "acc", torch.int32, (B, 2, N)), (ts, "ts", torch.int32, (n, B)),
                 (spectra, "spectra", torch.complex128, (n, rows, 2, 2, N // 2)))
    pa, ps = acc.data_ptr(), spectra.data_ptr()
    if (pa | ps) % 16:
        _require_aligned(("acc", pa), ("spectra", ps))
    if B == 0 or n == 0:
        return acc.clone()
    failed = ctypes.c_int(-1)
    _sbf_lib().launch("redsec_schoolbook_rounds", "schoolbook_round", dev, pa, ts.data_ptr(), ps,
                      *_fft_entry(N, dev)[2:], bufs[0].data_ptr(), bufs[1].data_ptr(),
                      B, N, rows, *_gadget_args(params), n, ctypes.addressof(failed), count=n,
                      failed=failed)
    return bufs[(n - 1) % 2]


# --------------------------------------------------------------------------- #
# K2-K4 on four-step ("matmul") keys (csrc/blind_mm.cu)                       #
# --------------------------------------------------------------------------- #

MM_SOURCE = os.path.join(_PKG, "csrc", "blind_mm.cu")
MM_KERNEL_N = (256, 1024)  # N = R * 128 the four-step kernels are instantiated for
MATMUL = (ntt_matmul.ntt_device_mm, ntt_matmul.intt_device_mm)  # the twins' transform pair
_MM_ENTRIES = ("redsec_mm_layout", "redsec_round_mm_layout", "redsec_external_product_mm",
               "redsec_cmux_round_mm", "redsec_blind_rotate_mm")
_mm_loaded: list[Library] = []


def _mm_lib() -> Library:
    if not _mm_loaded:
        _mm_loaded.append(Library(MM_SOURCE, _MM_ENTRIES))
    return _mm_loaded[0]


# The layout rule of csrc/blind_mm.cu (mm_mrows, mm_ring_own, mm_u_bytes,
# mm_smem_bytes), mirrored: padded row bytes of a u8 limb matrix, padded row
# halves of the 16-bit results; the most and the fewest key rows of a ring of
# its own, and the rows of the ring that lies on U where that does not fit.
MM_WS, MM_ZS = 144, 136
MM_RING_MAX, MM_RING_MIN, MM_RING_ALIASED = 4, 2, 2


def _mm_rows(N: int, rows: int) -> int:
    """Mr: rows of the C-steps' operands and results, the larger of rows * R
    and 8R rounded up to a whole m16 tile."""
    R = N // ntt_matmul.MM_C
    return -(-max(rows * R, 8 * R) // 16) * 16


def _mm_base_bytes(N: int, rows: int) -> int:
    """WC's limbs of both primes (uint8 [2][2][128][144]), accumulators and
    differences (uint32 [2][2][N]), the C-steps' u8 left operand
    [2][Mr][144], Z (16-bit C-step results [Mr][136]) and the two primes'
    inverse transforms (uint16 [2][8][N]): all but the key ring."""
    return (2 * 2 * 128 * MM_WS + 4 * 2 * 2 * N + 2 * _mm_rows(N, rows) * MM_WS
            + 2 * _mm_rows(N, rows) * MM_ZS + 2 * 2 * 8 * N)


def k4mm_ring(N: int, rows: int) -> tuple[int, bool]:
    """The key ring's rows (8 x N int16 each) and whether it lies on U: a
    ring of its own, as deep as fits (at most ``MM_RING_MAX`` rows and the
    digit rows), or, where fewer than ``MM_RING_MIN`` rows (or the digit
    rows) fit, ``MM_RING_ALIASED`` rows on U."""
    for depth in range(min(MM_RING_MAX, rows), min(MM_RING_MIN, rows) - 1, -1):
        if _mm_base_bytes(N, rows) + depth * 16 * N <= K4_MAX_SHARED:
            return depth, False
    return MM_RING_ALIASED, True


def _mm_u_bytes(N: int, rows: int) -> int:
    """U: the C-steps' u8 left operand, or with the ring on it the larger of
    that and the ring."""
    depth, aliased = k4mm_ring(N, rows)
    ops = 2 * _mm_rows(N, rows) * MM_WS
    return max(ops, depth * 16 * N) if aliased else ops


def k4mm_shared_bytes(N: int, rows: int) -> int:
    """Dynamic shared bytes of the four-step kernels at N and ``rows`` digit
    rows: ``_mm_base_bytes`` with U as ``_mm_u_bytes``, and the ring where it
    has its own region."""
    depth, aliased = k4mm_ring(N, rows)
    return (_mm_base_bytes(N, rows) - 2 * _mm_rows(N, rows) * MM_WS + _mm_u_bytes(N, rows)
            + (0 if aliased else depth * 16 * N))


def _mm_shape_ok(plan: ntt_mod.NttPlan, N: int, rows: int) -> bool:
    """The JAX package's ``pallas_blind.supported`` (two primes below 2^15,
    the (R, 128) split) on an N the four-step kernels are built for, primes
    ascending, and ``rows`` digit rows fitting a block; computed once a
    (primes, plan's N, N, rows)."""
    return _mm_shape_ok_at(tuple(plan.primes), plan.N, N, rows)


@functools.lru_cache(maxsize=None)
def _mm_shape_ok_at(pr: tuple, plan_n: int, N: int, rows: int) -> bool:
    return (len(pr) == 2 and all(p < (1 << 15) for p in pr)
            and ntt_matmul.supported(N) and ntt_matmul._split_rc(N)[1] == 128
            and N == plan_n and N in MM_KERNEL_N and 256 < pr[0] < pr[1]
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
    ``shared_bytes`` of dynamic shared memory, the key ring's rows
    (``ring_rows``), whether it lies on U (``ring_aliased``) and the key
    bytes it holds in flight (``ring_bytes``), each warp copying its own
    words 16 bytes a ``cp.async`` (``ring_copy``), and the ``instance``
    launched as the compiler's report names it.  Raises for what
    ``supported_mm`` refuses."""
    plan = plan or bs.bootstrap_plan(params)
    if plan is None or not supported_mm(params, plan):
        raise ValueError(f"{params.name}: not a blind_rotate_mm_kernel instance")
    N, rows = params.N, params.decomp_rows
    depth, aliased = k4mm_ring(N, rows)
    return {"threads": N // 2, "rows_padded": _mm_rows(N, rows), "u_bytes": _mm_u_bytes(N, rows),
            "shared_bytes": k4mm_shared_bytes(N, rows), "ring_rows": depth,
            "ring_aliased": aliased, "ring_bytes": depth * 16 * N, "ring_copy": "async",
            "instance": f"blind_rotate_mm_kernelILi{N}E"}


def mm_layout(params: TfheParams) -> dict:
    """The built library's own answer for ``k4mm_layout``'s numbers (its C
    entry ``redsec_mm_layout``)."""
    out = (ctypes.c_int * 6)()
    if _mm_lib().fn["redsec_mm_layout"](params.N, params.decomp_rows, ctypes.addressof(out)) != 0:
        raise ValueError(f"{params.name}: no four-step kernel instance")
    return {"shared_bytes": out[0], "rows_padded": out[1], "u_bytes": out[2], "threads": out[3],
            "ring_rows": out[4], "ring_aliased": bool(out[5])}


# The round kernels K2-mm and K3-mm (csrc/blind_mm.cu): a ciphertext's round
# on ``split`` blocks, 1 (one a block, as K4-mm's round) or 2 (a prime a
# block, a cluster pair: split_round); the rule that picks one at M
# ciphertexts (``round_mm_split``) prices a pair's block at
# ``ROUND_MM_PAIR_COST`` of a one-a-block block's time.
ROUND_MM_SPLITS = (1, 2)
ROUND_MM_PAIR_COST = 0.55
MM_SPLIT_RING_MAX = 4


def _pair_rows(N: int, rows: int) -> int:
    """Mr of a pair block: its rows digit rows times R or its 8R inverse
    rows, whichever is more, rounded up to a whole m16 tile."""
    R = N // ntt_matmul.MM_C
    return -(-max(rows * R, 8 * R) // 16) * 16


def _pair_base_bytes(N: int, rows: int) -> int:
    """A pair block without its ring: WC's limbs of one prime (uint8
    [2][128][144]), accumulators and differences (uint32 [2][2][N]), U
    [2][Mr][144], Z [Mr][136], and the residues of the 8 outputs at its half
    of the coefficients with the CRT partner's of that half (uint16
    [8][N / 2] each)."""
    mr = _pair_rows(N, rows)
    return 2 * 128 * MM_WS + 16 * N + 2 * mr * MM_WS + 2 * mr * MM_ZS + 16 * N


def round_mm_ring(N: int, rows: int) -> int:
    """Key rows in a pair block's ring (of its own): as many as fit, at most
    ``MM_SPLIT_RING_MAX`` and its rows; 0 if none fits."""
    depth = min(MM_SPLIT_RING_MAX, rows)
    while depth >= 1 and _pair_base_bytes(N, rows) + depth * 16 * N > K4_MAX_SHARED:
        depth -= 1
    return depth


@functools.lru_cache(maxsize=None)
def round_mm_fits(N: int, rows: int, split: int) -> bool:
    """Whether the round kernels run ``rows`` digit rows at ``split``."""
    if split == 1:
        return 0 < rows and k4mm_shared_bytes(N, rows) <= K4_MAX_SHARED
    return split == 2 and 0 < rows and round_mm_ring(N, rows) >= 1


def round_mm_shared_bytes(N: int, rows: int, split: int) -> int:
    """Dynamic shared bytes of a round kernel's block at ``split``."""
    if split == 1:
        return k4mm_shared_bytes(N, rows)
    return _pair_base_bytes(N, rows) + round_mm_ring(N, rows) * 16 * N


def round_mm_split(M: int, at_once: dict) -> int:
    """The split the round kernels launch M ciphertexts with, given the
    ciphertexts the card runs at once at each split (``at_once``; the
    library's occupancy answer): the least waves ``ceil(M / at_once[s])``
    times a block's cost (1, ``ROUND_MM_PAIR_COST`` for the pair), ties to
    one block a ciphertext."""
    cost = {s: -(-M // n) * (1.0 if s == 1 else ROUND_MM_PAIR_COST)
            for s, n in at_once.items() if n > 0}
    return min(cost, key=lambda s: (cost[s], s))


def round_mm_layout(params: TfheParams, split: int, plan: ntt_mod.NttPlan | None = None,
                    kernel: str = "cmux_round_mm") -> dict:
    """How K2-mm (``kernel="external_product_mm"``) and K3-mm lay out a
    block at ``split`` blocks a ciphertext: ``cluster`` blocks launched
    together (1 at split 1), ``threads``, ``shared_bytes``, ``rows_padded``
    (Mr), ``ring_rows`` and the ``instance`` as the compiler's report names
    it (its template arguments closed).  Raises for what ``supported_mm``
    refuses or the split does not take."""
    plan = plan or bs.bootstrap_plan(params)
    N, rows = params.N, params.decomp_rows
    if plan is None or not supported_mm(params, plan) or not round_mm_fits(N, rows, split):
        raise ValueError(f"{params.name}: no {kernel} instance at split {split}")
    if split == 1:
        return {"split": 1, "cluster": 1, "threads": N // 2,
                "shared_bytes": k4mm_shared_bytes(N, rows), "rows_padded": _mm_rows(N, rows),
                "ring_rows": k4mm_ring(N, rows)[0], "instance": f"{kernel}_kernelILi{N}EE"}
    return {"split": 2, "cluster": 2, "threads": N // 2,
            "shared_bytes": round_mm_shared_bytes(N, rows, 2),
            "rows_padded": _pair_rows(N, rows), "ring_rows": round_mm_ring(N, rows),
            "instance": f"{kernel}_pair_kernelILi{N}EE"}


def round_mm_built(N: int, rows: int, split: int, full: bool = True) -> dict:
    """The built library's own answer for ``round_mm_layout`` (its C entry
    ``redsec_round_mm_layout``) on the current CUDA device, with what only
    the card tells: ``at_once`` (ciphertexts it runs at once: blocks, or
    cluster pairs, from the occupancy calculator), ``registers`` and
    ``local_bytes`` (spills) a thread of the instance."""
    out = (ctypes.c_int * 7)()
    code = _mm_lib().fn["redsec_round_mm_layout"](N, rows, split, int(full), ctypes.addressof(out))
    if code:
        raise ValueError(f"no round kernel at N={N}, {rows} rows, split {split}: "
                         f"{_mm_lib().lib.redsec_error_string(code)} ({code})")
    return {"shared_bytes": out[0], "rows_padded": out[1], "threads": out[2], "ring_rows": out[3],
            "at_once": out[4], "registers": out[5], "local_bytes": out[6]}


@functools.lru_cache(maxsize=None)
def _round_mm_at_once(dev: int, N: int, rows: int, full: bool) -> dict:
    with torch.cuda.device(dev):
        return {s: round_mm_built(N, rows, s, full)["at_once"] for s in ROUND_MM_SPLITS
                if round_mm_fits(N, rows, s)}


@functools.lru_cache(maxsize=None)
def round_mm_split_on(dev: int, N: int, rows: int, M: int, full: bool = True) -> int:
    """``round_mm_split`` of M ciphertexts on CUDA device ``dev``."""
    return round_mm_split(M, _round_mm_at_once(dev, N, rows, full))


def _require_round_slice(bk_round: torch.Tensor, dev: int, shape: tuple) -> int:
    """A round slice int16 ``shape`` = [2, rows, 8, R, C] on device ``dev``
    whose two primes are each contiguous (a whole key's ``bk[:, j]`` is
    one); returns the prime stride in elements."""
    _, limbs, R, C = shape[1:]
    inner = (limbs * R * C, R * C, C, 1)
    if not (bk_round.dtype is torch.int16 and bk_round.shape == shape
            and bk_round.get_device() == dev and bk_round.stride()[1:] == inner):
        _require(bk_round, "bk_round", torch.int16, shape, torch.device("cuda", dev))
        raise ValueError("bk_round: each prime's [rows, 8, R, C] must be contiguous")
    return bk_round.stride(0)


def _split_for(split: int | None, dev: int, N: int, rows: int, M: int, full: bool) -> int:
    """``split`` as given (checked) or, for None, ``round_mm_split_on``'s."""
    if split is None:
        return round_mm_split_on(dev, N, rows, M, full)
    if not round_mm_fits(N, rows, split):
        raise ValueError(f"split {split} at N={N}, {rows} digit rows: not a round kernel "
                         f"instance (splits {ROUND_MM_SPLITS})")
    return split


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
    """K2-mm: see ``external_product_mm_plain``.  ``bk_round`` may be a view
    ``bk[:, j]`` of a whole key (each prime contiguous).  One block or a
    cluster pair a ciphertext, as ``round_mm_split_on`` picks."""
    return _external_product_mm(digits, bk_round, plan)


def _external_product_mm(digits: torch.Tensor, bk_round: torch.Tensor, plan: ntt_mod.NttPlan,
                         split: int | None = None) -> torch.Tensor:
    """``external_product_mm`` at ``split`` blocks a ciphertext
    (``ROUND_MM_SPLITS``; None: ``round_mm_split_on``'s), for the tests and
    tools that hold or time each design."""
    _require_mm_key(bk_round, 5, digits.shape[-1])
    if digits.is_cpu:
        return external_product_mm_plain(digits, bk_round, plan)
    M, rows, N = digits.shape
    _require_mm_shape(plan, N, rows, "external_product_mm_kernel")
    dev = digits.get_device()
    R, C = ntt_matmul._split_rc(N)
    _require_all(dev, (digits, "digits", torch.int32, (M, rows, N)))
    stride = _require_round_slice(bk_round, dev, (2, rows, 2 * bs.BK_LIMBS, R, C))
    if digits.data_ptr() % 16:
        raise ValueError("digits must start on a 16-byte boundary")
    split = _split_for(split, dev, N, rows, M, False)
    tabs = ntt_matmul.kernel_tables_mm(plan, digits.device)
    delta = digits.new_empty((M, 2, N))  # int32, as the digits (checked)
    _mm_lib().launch("redsec_external_product_mm", "external_product_mm", dev, digits.data_ptr(),
                     bk_round.data_ptr(), stride, tabs["tw"].data_ptr(), tabs["wc"].data_ptr(),
                     delta.data_ptr(), M, N, rows, plan.primes[0], plan.primes[1], split)
    return delta


def cmux_round_mm(acc: torch.Tensor, t: torch.Tensor, bk_round: torch.Tensor,
                  params: TfheParams, plan: ntt_mod.NttPlan) -> torch.Tensor:
    """K3-mm: see ``cmux_round_mm_plain``; ``bk_round`` and the design as for
    ``external_product_mm``."""
    return _cmux_round_mm(acc, t, bk_round, params, plan)


def _cmux_round_mm(acc: torch.Tensor, t: torch.Tensor, bk_round: torch.Tensor,
                   params: TfheParams, plan: ntt_mod.NttPlan,
                   split: int | None = None) -> torch.Tensor:
    """``cmux_round_mm`` at ``split``, as ``_external_product_mm``."""
    _require_mm_key(bk_round, 5, params.N)
    if acc.is_cpu:
        return cmux_round_mm_plain(acc, t, bk_round, params, plan)
    M, N, rows = acc.shape[0], params.N, params.decomp_rows
    _require_mm_shape(plan, N, rows, "cmux_round_mm_kernel", params)
    dev = acc.get_device()
    R, C = ntt_matmul._split_rc(N)
    _require_all(dev, (acc, "acc", torch.int32, (M, 2, N)), (t, "t", torch.int32, (M,)))
    stride = _require_round_slice(bk_round, dev, (2, rows, 2 * bs.BK_LIMBS, R, C))
    split = _split_for(split, dev, N, rows, M, True)
    tabs = ntt_matmul.kernel_tables_mm(plan, acc.device)
    out = torch.empty_like(acc)
    _mm_lib().launch("redsec_cmux_round_mm", "cmux_round_mm", dev, acc.data_ptr(), t.data_ptr(),
                     bk_round.data_ptr(), stride, tabs["tw"].data_ptr(), tabs["wc"].data_ptr(),
                     out.data_ptr(), M, N, *_gadget_args(params), plan.primes[0],
                     plan.primes[1], split)
    return out


def blind_rotate_mm(acc0: torch.Tensor, abar: torch.Tensor, bk: torch.Tensor,
                    params: TfheParams, plan: ntt_mod.NttPlan) -> torch.Tensor:
    """K4-mm: see ``blind_rotate_mm_plain``.  One launch runs all n rounds,
    one ciphertext a block (``k4mm_layout``); a bundled "matmul" key is
    outside ``supported_mm`` and raises here on CUDA."""
    _require_mm_key(bk, 6, params.N)
    if acc0.is_cpu:
        return blind_rotate_mm_plain(acc0, abar, bk, params, plan)
    B, N, n, rows = acc0.shape[0], params.N, params.n, params.decomp_rows
    _require_mm_shape(plan, N, rows, "blind_rotate_mm_kernel", params)
    dev = acc0.get_device()
    R, C = ntt_matmul._split_rc(N)
    _require_all(dev, (acc0, "acc0", torch.int32, (B, 2, N)), (abar, "abar", torch.int32, (B, n)),
                 (bk, "bk", torch.int16, (2, n, rows, 2 * bs.BK_LIMBS, R, C)))
    tabs = ntt_matmul.kernel_tables_mm(plan, acc0.device)
    out = torch.empty_like(acc0)
    _mm_lib().launch("redsec_blind_rotate_mm", "blind_rotate_mm", dev, acc0.data_ptr(),
                     abar.data_ptr(), bk.data_ptr(), tabs["tw"].data_ptr(), tabs["wc"].data_ptr(),
                     out.data_ptr(), B, n, N, *_gadget_args(params), plan.primes[0],
                     plan.primes[1])
    return out


# --------------------------------------------------------------------------- #
# The PBS key switch (csrc/key_switch.cu)                                     #
# --------------------------------------------------------------------------- #

KS_SOURCE = os.path.join(_PKG, "csrc", "key_switch.cu")
_KS_ENTRIES = ("redsec_key_switch",)
KS_CHUNK = 16  # coefficients a chunk of the tiled key's order
KS_STEP_BYTES = 1024  # a column group's k-step: 4 limbs x 32 key rows x 8 columns
KS_NO_PLAN = -2  # the C entry's answer for a digit plan it has no instance of
_ks_loaded: list[Library] = []
_sm_counts: dict = {}  # device index -> SMs


def _ks_lib() -> Library:
    if not _ks_loaded:
        _ks_loaded.append(Library(KS_SOURCE, _KS_ENTRIES))
    return _ks_loaded[0]


def ksk_shape(N: int, params: TfheParams) -> tuple[int, int, int]:
    """Shape of the tiled key of ``N`` coefficients (``ksk_tiles``):
    (column groups of 8, k-steps of 32 key rows, bytes a k-step of a group)."""
    return ((params.n + 8) // 8, N // KS_CHUNK * ((params.ks_t + 1) // 2), KS_STEP_BYTES)


def ksk_tiles(limbs: torch.Tensor, t: int) -> torch.Tensor:
    """The key switch's key layout from the key-switching key's four int8
    limbs [4, N t, n+1] (row j t + l: coefficient j, level l; the JAX
    package's ``ksk_limbs``), N a multiple of 16: int8 [ceil((n+1) / 8),
    N / 16 * ceil(t / 2), 1024], a permutation with zeros for the padding.

    The rows go in chunks of 16 coefficients, and in a chunk the levels two
    at a time: k-step (c, p) holds coefficients 16 c .. 16 c + 15 at level
    2 p (its k 0-15), then at level 2 p + 1 (k 16-31); an odd t gets a zero
    level.  The columns go in groups of 8 (zero columns past n+1).  The 1,024
    bytes of a group's k-step are [limb pair q][lane 4 g + tq][16 bytes],
    the 16 bytes limb 2 q at k 4 tq .. 4 tq + 3 and 16 + 4 tq .. + 3 of the
    group's column g, then limb 2 q + 1 the same: mma.sync m16n8k32's B
    fragments as the lanes hold them (csrc/key_switch.cu)."""
    _, rows, n1 = limbs.shape
    N, t2, G = rows // t, t + t % 2, (n1 + 7) // 8
    full = limbs.new_zeros((4, N, t2, 8 * G))
    full[:, :, :t, :n1] = limbs.reshape(4, N, t, n1)
    # [q, r, c, tq, e, p, h, cg, g] -> [cg, c, p, q, g, tq, r, h, e]: limb 2q + r,
    # coefficient 16 c + 4 tq + e, level 2 p + h, column 8 cg + g
    v = full.reshape(2, 2, N // KS_CHUNK, 4, 4, t2 // 2, 2, G, 8).permute(7, 2, 5, 0, 8, 3, 1, 6, 4)
    return v.reshape(G, N // KS_CHUNK * (t2 // 2), KS_STEP_BYTES)


def ksk_limbs_plain(tiles: torch.Tensor, N: int, t: int, n1: int) -> torch.Tensor:
    """``ksk_tiles``' inverse: the limbs int8 [4, N t, n+1] in the key's own
    row order (the JAX package's ``ksk_limbs``)."""
    G, t2 = tiles.shape[0], t + t % 2
    v = tiles.reshape(G, N // KS_CHUNK, t2 // 2, 2, 8, 4, 2, 2, 4)  # [cg, c, p, q, g, tq, r, h, e]
    full = v.permute(3, 6, 1, 5, 8, 2, 7, 0, 4).reshape(4, N, t2, 8 * G)
    return full[:, :, :t, :n1].reshape(4, N * t, n1)


def _require_key_switch(N: int, params: TfheParams) -> None:
    """N must split into chunks of 16 coefficients, and a limb's sum over
    the N t digits must stay inside int32: N t (base - 1) 128 < 2^31."""
    if N <= 0 or N % KS_CHUNK:
        raise ValueError(f"the key switch takes N a positive multiple of {KS_CHUNK}, got {N}")
    if params.ks_basebit * params.ks_t > 32 or params.ks_basebit > 7:
        raise ValueError(f"{params.name}: key-switch digits of {params.ks_basebit} bits x "
                         f"{params.ks_t} levels do not fit a word in bytes")
    if N * params.ks_t * (params.ks_base - 1) * 128 >= 1 << 31:
        raise ValueError(f"{params.name}: {N} x {params.ks_t} digits below {params.ks_base} "
                         "against int8 limbs can pass 2^31 in an int32 sum")


def _ks_prec(params: TfheParams) -> int:
    """The digits' rounding offset (``RoundOps._prec_offset``) as uint32."""
    kbits = params.ks_basebit * params.ks_t
    return (1 << (32 - 1 - kbits)) if kbits < 32 else 0


def key_switch_layout(B: int, N: int, params: TfheParams, sms: int) -> dict:
    """How the key switch kernel cuts a call: 16 ``mt`` rows a warp, 8 warps
    a block (``rows``: 512 for a batch above 256, so that the port's PBS
    chunk of 512 is one tile, else 256), 8 ``groups`` columns a block (2 or
    4: the block's accumulators take the same registers), and the key's rows
    in ``splits`` parts of ``chunks_per_split`` chunks of 16 coefficients,
    the count (up to 64) whose grid of one block per SM wastes the least:
    the fewest waves times the chunks a block walks, plus two for its fill
    and epilogue.  Mirrors the C entry's grid, which each launch takes."""
    _require_key_switch(N, params)
    mt = 4 if B > 256 else 2
    groups, rows, chunks = 8 // mt, 128 * mt, N // KS_CHUNK
    tiles = -(-ksk_shape(N, params)[0] // groups)
    tiles_b = -(-B // rows)
    best = None
    for splits in range(1, min(chunks, 64) + 1):
        per = -(-chunks // splits)
        if -(-chunks // per) != splits:
            continue  # the same grid as fewer splits
        cost = -(-tiles * splits * tiles_b // sms) * (per + 2)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return {"mt": mt, "rows": rows, "groups": groups, "splits": best[1],
            "chunks_per_split": best[2], "grid": (tiles, best[1], tiles_b)}


@functools.lru_cache(maxsize=None)
def _ks_layout_on(dev: int, B: int, N: int, params: TfheParams) -> tuple[int, int]:
    if dev not in _sm_counts:
        _sm_counts[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    lay = key_switch_layout(B, N, params, _sm_counts[dev])
    return lay["mt"], lay["splits"]


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 with the same low 32 bits."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def key_switch_plain(a_n: torch.Tensor, b_n: torch.Tensor, ksk: torch.Tensor,
                     params: TfheParams) -> torch.Tensor:
    """The key switch in torch on any device, the JAX package's formula
    (``redsec_tpu/crypto/bootstrap.py:456``): the digits of the extracted
    mask ``a_n`` [B, N] (``RoundOps.ks_digits``) against the four limbs of
    the tiled key ``ksk`` (``ksk_tiles``), ssum = sum_i (dig @ limb_i) << 8 i
    mod 2^32, and out = -ssum with ``b_n`` [B] added to column n: int32
    [B, n+1].  Each limb product is exact in float64 (its sums are integers
    below 2^31, ``_require_key_switch``)."""
    N, n1 = a_n.shape[1], params.n + 1
    _require_key_switch(N, params)
    dig = bs.RoundOps(params).ks_digits(a_n).to(torch.float64)  # [B, N t]
    limbs = ksk_limbs_plain(ksk, N, params.ks_t, n1)
    ssum = torch.zeros((a_n.shape[0], n1), dtype=torch.int64, device=a_n.device)
    for i in range(4):
        ssum += (dig @ limbs[i].to(torch.float64)).to(torch.int64) << (8 * i)
    out = -ssum
    out[:, params.n] += b_n.to(torch.int64)
    return _wrap_int32(out)


def key_switch(a_n: torch.Tensor, b_n: torch.Tensor, ksk: torch.Tensor,
               params: TfheParams) -> torch.Tensor:
    """The PBS key switch, see ``key_switch_plain``: one launch of
    ``key_switch_kernel`` (csrc/key_switch.cu: the digits made in registers,
    u8 x s8 products on the int8 tensor cores, the key read once), after an
    asynchronous zeroing of the output where the layout splits the key's
    rows (``key_switch_layout``); built for the digit plans that the C
    entry lists, and raises for any other.  ``a_n`` int32 [B, N] contiguous, ``b_n``
    int32 [B] with any stride, ``ksk`` int8 ``ksk_shape(N, params)`` (N may
    be a block of the key's coefficients, as a poly-sharded rank holds)."""
    if a_n.is_cpu:
        return key_switch_plain(a_n, b_n, ksk, params)
    if a_n.dim() != 2:
        raise ValueError(f"a_n must be [B, N], got shape {tuple(a_n.shape)}")
    B, N = a_n.shape
    _require_key_switch(N, params)
    dev = a_n.get_device()
    _require_all(dev, (a_n, "a_n", torch.int32, (B, N)),
                 (ksk, "ksk", torch.int8, ksk_shape(N, params)))
    if not (b_n.dtype is torch.int32 and b_n.shape == (B,) and b_n.get_device() == dev):
        raise ValueError(f"b_n must be int32 [{B}] on cuda:{dev}, got {b_n.dtype} "
                         f"{tuple(b_n.shape)} on {b_n.device}")
    pa, pk = a_n.data_ptr(), ksk.data_ptr()
    if (pa | pk) % 16:
        _require_aligned(("a_n", pa), ("ksk", pk))
    out = a_n.new_empty((B, params.n + 1))
    if B == 0:
        return out
    mt, splits = _ks_layout_on(dev, B, N, params)
    try:
        _ks_lib().launch("redsec_key_switch", "key_switch", dev, pa, pk, b_n.data_ptr(),
                         b_n.stride(0), out.data_ptr(), B, N, params.n + 1, params.ks_t,
                         params.ks_basebit, _ks_prec(params), mt, splits)
    except LaunchError as e:
        if e.code != KS_NO_PLAN:
            raise
        raise ValueError(f"{params.name}: the key switch kernel is not built for the digit "
                         f"plan (bits, levels) ({params.ks_basebit}, {params.ks_t}); "
                         "csrc/key_switch.cu lists the digit plans it has") from None
    return out
