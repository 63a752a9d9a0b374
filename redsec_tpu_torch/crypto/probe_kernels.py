"""The rotation and Toeplitz probe kernels: wrappers and plain twins.

Three CUDA kernels for ``sm_90a`` live in ``csrc/probes.cu`` (design notes
at its top).  They serve the port's microbenchmarks
(``scripts/bench_rotate.py``, ``scripts/bench_schoolbook.py``); no model path
launches them.

============================  ==============================================
wrapper                       replaces (JAX package)
============================  ==============================================
``rotate_rows``               ``scripts/bench_rotate.py::_mk_pallas_grid``
``rotate_tile``               ``scripts/bench_rotate.py::_mk_pallas_tile``
``toeplitz_tile``             ``scripts/bench_schoolbook.py::main.toep``
============================  ==============================================

The contract is that of ``kernels.py``: a wrapper takes its plain PyTorch
twin (``rotate_plain``, ``toeplitz_tile_plain``) only because its tensor lies
on the CPU.  On a CUDA tensor it checks device, dtype, shape and contiguity,
allocates the output with ``torch.empty``, launches on the current stream,
raises on a non-zero ``cudaGetLastError()``, and adds one to its count in
``device.launches``.  Nothing falls back to the twin.
"""

from __future__ import annotations

import os

import torch

from .kernels import _PKG, Library, _require_all

SOURCE = os.path.join(_PKG, "csrc", "probes.cu")
TOEPLITZ_TILE = 128  # the tile is [128, 128], cut from one doubled row of 256
_W_SHAPE, _TILE_SHAPE = (1, 2 * TOEPLITZ_TILE), (TOEPLITZ_TILE, TOEPLITZ_TILE)
_tile_like: dict = {}  # device index -> an int32 [128, 128] tile, never written

_ENTRIES = ("redsec_rotate_rows", "redsec_rotate_tile", "redsec_toeplitz_tile")
_loaded: list[Library] = []


def _lib() -> Library:
    if not _loaded:
        _loaded.append(Library(SOURCE, _ENTRIES))
    return _loaded[0]


# --------------------------------------------------------------------------- #
# K5, K6: negacyclic X^t rotation, one exponent per batch row                 #
# --------------------------------------------------------------------------- #


def rotate_plain(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x int32 [B, 2, N], t int32 [B] -> X^t[b] * x[b] (negacyclic):
    out[b, c, k] = ext[b, c, (k - t[b]) mod 2N] with ext = [x, -x], as one
    gather with a sign (the function of ``bootstrap.RoundOps.rotate``).
    Any t acts as t mod 2N."""
    N = x.shape[-1]
    k = torch.arange(N, device=x.device, dtype=torch.int32)
    src = (k[None, :] - t[:, None].to(torch.int32)) % (2 * N)  # in [0, 2N)
    neg = (src >= N)[:, None, :]
    idx = (src % N).to(torch.int64)[:, None, :].expand(x.shape)
    g = torch.gather(x, -1, idx)
    return torch.where(neg, -g, g)  # int32 negation wraps


def _check_rotation(x: torch.Tensor, t: torch.Tensor) -> int:
    """Raise unless x is int32 [B, 2, N] and t int32 [B], contiguous, on one
    CUDA device; return that device's index."""
    if x.ndim != 3 or x.shape[1] != 2:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected [B, 2, N]")
    dev = x.get_device()
    _require_all(dev, (x, "x", torch.int32, x.shape), (t, "t", torch.int32, (x.shape[0],)))
    return dev


def rotate_rows(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """K5: see ``rotate_plain``.  One block per batch row."""
    if x.is_cpu:
        return rotate_plain(x, t)
    dev = _check_rotation(x, t)
    out = torch.empty_like(x)
    _lib().launch("redsec_rotate_rows", "rotate_rows", dev, x.data_ptr(), t.data_ptr(),
                  out.data_ptr(), x.shape[0], x.shape[2])
    return out


def rotate_tile(x: torch.Tensor, t: torch.Tensor, tile: int = 64) -> torch.Tensor:
    """K6: see ``rotate_plain``.  The batch is cut into tiles of ``tile``
    rows; a tile's rows are dealt out over as many blocks as fill the card,
    each staging its rows' exponents in shared memory and looping over them.
    The batch must be a multiple of ``tile`` (on either device)."""
    if tile <= 0 or x.shape[0] % tile != 0:
        raise ValueError(f"batch {x.shape[0]} is not a multiple of the tile {tile}")
    if x.is_cpu:
        return rotate_plain(x, t)
    dev = _check_rotation(x, t)
    out = torch.empty_like(x)
    _lib().launch("redsec_rotate_tile", "rotate_tile", dev, x.data_ptr(), t.data_ptr(),
                  out.data_ptr(), x.shape[0], x.shape[2], tile)
    return out


# --------------------------------------------------------------------------- #
# K7: Toeplitz tile of one doubled key row                                    #
# --------------------------------------------------------------------------- #


def toeplitz_tile_plain(w: torch.Tensor) -> torch.Tensor:
    """w int32 [1, 256] -> int32 [128, 128], out[j, k] = w[0, (127 + k - j)
    mod 256]: row j is w rolled right by 129 + j, first 128 entries kept."""
    T = TOEPLITZ_TILE
    j = torch.arange(T, device=w.device)[:, None]
    k = torch.arange(T, device=w.device)[None, :]
    return w[0][(T - 1 + k - j) % (2 * T)]


def toeplitz_tile(w: torch.Tensor) -> torch.Tensor:
    """K7: see ``toeplitz_tile_plain``.  One launch, one element a thread."""
    if w.is_cpu:
        return toeplitz_tile_plain(w)
    dev = w.get_device()
    _require_all(dev, (w, "w", torch.int32, _W_SHAPE))
    like = _tile_like.get(dev)
    if like is None:  # a tile kept a device only as the form of each output
        like = _tile_like[dev] = w.new_empty(_TILE_SHAPE)
    out = torch.empty_like(like)  # one tensor to parse: the cheapest allocation call
    _lib().launch("redsec_toeplitz_tile", "toeplitz_tile", dev, w.data_ptr(), out.data_ptr())
    return out
