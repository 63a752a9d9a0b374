"""Byte-compatible reader/writer for REDsec's packed weight file (``var_prep.dat``).

The reference serializes each model as a concatenation of tagged sections
(format enum at lib/BinOps.cpp:28-36):

=====  =========  ====================================================
tag    name       payload
=====  =========  ====================================================
1      BIN_FMT    ceil(len/8) bytes, 1 sign bit per weight, MSB first
2      TERN_FMT   ceil(len*2/8) bytes, 2 bits per weight, MSB first:
                  [sign, is_zero]; sign=1 -> +1, sign=0 -> -1
3      UINT32_FMT len * uint32 little-endian
4      INT32_FMT  len * int32  little-endian
=====  =========  ====================================================

Packing layout per the reference reader (lib/BinOps.cpp:289-314, identical
encrypted copy at lib/BinOps_enc.cpp:247-272) and writer (lib/BinOps.cpp:393-415):
within each byte, weight ``w`` occupies bits ``(7-2w, 6-2w)`` = (sign, tern).
Note the reference *writer* bottom-aligns a trailing partial byte while the
reader top-aligns it; every shipped net has ``len % 4 == 0`` so the mismatch is
unobservable.  We always top-align (reader-compatible) and assert on write.
"""

from __future__ import annotations

import io
from typing import BinaryIO, Optional, Union

import numpy as np

NULL_FMT = 0
BIN_FMT = 1
TERN_FMT = 2
UINT32_FMT = 3
INT32_FMT = 4


class VarPrepReader:
    """Sequential reader over a ``var_prep.dat`` byte stream."""

    def __init__(self, data: Union[bytes, BinaryIO, str]):
        if isinstance(data, (bytes, bytearray)):
            self._buf = io.BytesIO(bytes(data))
        elif isinstance(data, str):
            with open(data, "rb") as f:
                self._buf = io.BytesIO(f.read())
        else:
            self._buf = io.BytesIO(data.read())

    def _read_exact(self, n: int) -> bytes:
        b = self._buf.read(n)
        if len(b) != n:
            raise EOFError(f"var_prep stream truncated: wanted {n} bytes, got {len(b)}")
        return b

    def _read_tag(self, *allowed: int) -> int:
        tag = self._read_exact(1)[0]
        if tag not in allowed:
            raise ValueError(f"unexpected section tag {tag}, wanted one of {allowed}")
        return tag

    def read_tern(self, length: int) -> np.ndarray:
        """Read a BIN/TERN section of ``length`` weights -> int8 array in {-1,0,+1}.

        Mirrors BinOps::get_ternfilters (lib/BinOps.cpp:289-314): a BIN section
        yields only +-1 (no zeros).
        """
        tag = self._read_tag(BIN_FMT, TERN_FMT)
        nbits = 1 if tag == BIN_FMT else 2
        adj_len = (length * nbits + 7) // 8
        raw = np.frombuffer(self._read_exact(adj_len), dtype=np.uint8)
        bits = np.unpackbits(raw)  # MSB-first, matches (pack >> (8-j-1)) & 1
        if tag == BIN_FMT:
            sign = bits[:length].astype(np.int8)
            tern = np.zeros(length, dtype=np.int8)
        else:
            pairs = bits[: 2 * length].reshape(length, 2)
            sign = pairs[:, 0].astype(np.int8)
            tern = pairs[:, 1].astype(np.int8)
        w = np.where(sign == 1, np.int8(1), np.int8(-1))
        return np.where(tern == 1, np.int8(0), w)

    def read_i32(self, length: int) -> np.ndarray:
        """Read an INT32/UINT32 section as signed int32 (BinOps::get_intfilters)."""
        self._read_tag(UINT32_FMT, INT32_FMT)
        return np.frombuffer(self._read_exact(4 * length), dtype="<i4").copy()

    def read_u32(self, length: int) -> np.ndarray:
        """Read an INT32/UINT32 section as uint32 (BinOps::get_intfilters_ptxt)."""
        self._read_tag(UINT32_FMT, INT32_FMT)
        return np.frombuffer(self._read_exact(4 * length), dtype="<u4").copy()

    def at_eof(self) -> bool:
        pos = self._buf.tell()
        extra = self._buf.read(1)
        self._buf.seek(pos)
        return extra == b""


class VarPrepWriter:
    """Sequential writer producing reference-compatible sections."""

    def __init__(self, out: Optional[BinaryIO] = None):
        self._buf = out if out is not None else io.BytesIO()

    def write_tern_raw(self, sign: np.ndarray, tern: np.ndarray) -> None:
        """Write a TERN section from explicit (sign, is_zero) bit planes.

        The reference's weight converter stores the raw float sign bit even
        for zeroed (ternary) weights (BinOps.cpp:348-358 + 393-415); use this
        for byte-exact var_prep.dat reproduction."""
        pairs = np.stack(
            [np.asarray(sign, np.uint8) & 1, np.asarray(tern, np.uint8) & 1], axis=-1
        ).reshape(-1)
        self._buf.write(bytes([TERN_FMT]))
        self._buf.write(np.packbits(pairs).tobytes())

    def write_tern(self, weights: np.ndarray) -> None:
        """Write a TERN section from int weights in {-1, 0, +1}.

        Matches BinOps::export_tern (lib/BinOps.cpp:393-415) for len % 4 == 0
        (top-aligned trailing byte otherwise; see module docstring).
        """
        w = np.asarray(weights).reshape(-1)
        if not np.isin(w, (-1, 0, 1)).all():
            raise ValueError("ternary weights must be in {-1, 0, +1}")
        sign = (w > 0).astype(np.uint8)  # -1 -> 0, +1 -> 1, 0 -> 0 (masked by tern)
        tern = (w == 0).astype(np.uint8)
        # reference keeps the raw sign bit for zero weights; zeros came from
        # thresholding where sign = (value > 0) (lib/BinOps.cpp:348-358).
        pairs = np.stack([sign, tern], axis=1).reshape(-1)
        packed = np.packbits(pairs)  # MSB-first, zero-padded trailing byte
        self._buf.write(bytes([TERN_FMT]))
        self._buf.write(packed.tobytes())

    def write_i32(self, values: np.ndarray, signed: bool = True) -> None:
        """Write an INT32 (signed) or UINT32 section.

        Matches BinOps::export_signedBias / export_mulbits (lib/BinOps.cpp:427-467):
        floats are floored before casting.
        """
        v = np.asarray(values).reshape(-1)
        if np.issubdtype(v.dtype, np.floating):
            v = np.floor(v)
        v = v.astype(np.int64).astype("<i4" if signed else "<u4")
        self._buf.write(bytes([INT32_FMT if signed else UINT32_FMT]))
        self._buf.write(v.tobytes())

    def getvalue(self) -> bytes:
        if isinstance(self._buf, io.BytesIO):
            return self._buf.getvalue()
        raise TypeError("writer wraps an external stream")
