"""ctypes binding of the native CGGI core (``cggi_core.cpp``): an OpenMP CPU
bootstrap engine, independent of the torch and CUDA paths, used as their
oracle.

The library is built with ``g++ -O3 -march=native -fopenmp`` into
``build/native/`` at the repository root, under a name keyed on a hash of the
source and the flags, so a changed source is never served by a stale build.
A failed build raises with the compiler's messages; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "cggi_core.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]
# the core's candidate primes (= 1 mod 2N), in the order it takes them
_CANDIDATES = (12289, 18433, 40961, 65537, 114689, 147457, 163841, 270337)

_P = ctypes.c_void_p


def available() -> bool:
    """Whether a C++ compiler is on PATH (the tests skip without one)."""
    return shutil.which("g++") is not None


def library_path(source: str = SOURCE) -> str:
    """Where ``source`` is built: ``build/native/libcggi_core-<hash>.so``."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libcggi_core-{digest}.so")


def build(source: str = SOURCE) -> str:
    """Compile ``source`` unless its keyed library exists; returns the
    library's path.  Raises RuntimeError with the compiler's stderr."""
    lib = library_path(source)
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    res = subprocess.run(["g++", *CXX_FLAGS, source, "-o", tmp],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}) on {source}:\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


def load(source: str = SOURCE) -> ctypes.CDLL:
    """Build (if needed) and load the core, with its C signatures declared."""
    lib = ctypes.CDLL(build(source))
    lib.cggi_engine_new.restype = _P
    lib.cggi_engine_new.argtypes = [_P] * 3
    lib.cggi_engine_free.restype = None
    lib.cggi_engine_free.argtypes = [_P]
    lib.cggi_bootstrap_batch.restype = None
    lib.cggi_bootstrap_batch.argtypes = [_P] * 4 + [ctypes.c_int]
    lib.cggi_num_threads.restype = ctypes.c_int
    lib.cggi_num_threads.argtypes = []
    return lib


def primes_for(params) -> tuple:
    """The NTT primes the core picks for ``params``: candidates = 1 mod 2N,
    in order, until their product exceeds the exact bound of a row-summed
    external product.  Raises where they cannot cover it (the core's CRT
    takes two or three primes)."""
    N, rows = params.N, 2 * params.l
    bound = 2 * rows * N * (1 << (params.bg_bit - 1)) * 255
    chosen, prod = [], 1
    for c in _CANDIDATES:
        if (c - 1) % (2 * N):
            continue
        chosen.append(c)
        prod *= c
        if prod > bound:
            break
    if prod <= bound or len(chosen) not in (2, 3):
        raise ValueError(f"{params.name}: the native core's primes {chosen} at N={N} do not "
                         f"cover the product bound {bound} with two or three primes")
    return tuple(chosen)


class NativeEngine:
    """OpenMP-parallel batched bootstrap engine over a (host) ``CloudKey``."""

    def __init__(self, cloud):
        p = cloud.params
        if p.k != 1:
            raise ValueError(f"{p.name}: the native core takes k = 1, not {p.k}")
        self.primes = primes_for(p)
        self._lib = load()
        self.params = p
        self._p_arr = np.array([p.n, p.N, p.l, p.bg_bit, p.ks_t, p.ks_basebit], dtype=np.int32)
        self._bk = np.ascontiguousarray(cloud.bk, dtype=np.int32)
        self._ksk = np.ascontiguousarray(cloud.ksk, dtype=np.int32)
        want_bk, want_ksk = (p.n, 2 * p.l, 2, p.N), (p.N, p.ks_t, p.n + 1)
        if self._bk.shape != want_bk or self._ksk.shape != want_ksk:
            raise ValueError(f"key shapes {self._bk.shape}, {self._ksk.shape}; expected "
                             f"{want_bk}, {want_ksk}")
        self._h = self._lib.cggi_engine_new(self._p_arr.ctypes.data, self._bk.ctypes.data,
                                            self._ksk.ctypes.data)

    def bootstrap(self, ct: np.ndarray, testvect: np.ndarray) -> np.ndarray:
        """PBS of LWE ciphertexts ``ct`` [..., n+1] with one test vector [N]
        -> int32 [B, n+1]."""
        p = self.params
        if not self._h:
            raise RuntimeError("the native engine is closed")
        ct = np.ascontiguousarray(np.asarray(ct).reshape(-1, p.n + 1), dtype=np.int32)
        tv = np.ascontiguousarray(testvect, dtype=np.int32)
        if tv.shape != (p.N,):
            raise ValueError(f"test vector of shape {tv.shape}, expected ({p.N},)")
        out = np.empty_like(ct)
        self._lib.cggi_bootstrap_batch(self._h, ct.ctypes.data, tv.ctypes.data,
                                       out.ctypes.data, ct.shape[0])
        return out

    def close(self) -> None:
        if self._h:
            self._lib.cggi_engine_free(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


def num_threads() -> int:
    """OpenMP threads the core runs its batch over."""
    return load().cggi_num_threads()
