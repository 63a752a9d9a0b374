"""Offline weight compilation: float training dump -> packed ``var_prep.dat``.

The reference's ``make weight_convert`` build (same layer sources compiled
with ``-D_WEIGHT_CONVERT_``) reads the raw float dump ``var.dat1`` and writes
the packed inference file: ternarize filters at the threshold, fold BatchNorm
(beta/mean/variance) and SumPool scaling into per-channel bias (+ slope for
ReLU), then 2-bit-pack weights and floor-cast biases
(call stack: SURVEY.md §3.3; formulas at lib/BinFunc.cpp:440-592, 1172-1202
and lib/IntFunc.cpp:404-557, 983-1000).

``var.dat1`` layout (implied by the readers, nothing in the reference writes
it — SURVEY.md §2.5 gap): for each layer, in prep order,
  - conv filters: float32 [fh, fw, in_dep, out_dep]     (BinOps.cpp:348-358)
  - if bias==BIAS:  float32 [out_dep]                   (BinFunc.cpp:480-491)
  - if bias==BNORM: [gamma float32 [d] only if use_scale,] beta, mean,
    variance float32 [d] each                           (BinFunc.cpp:560-569)
``export_var_dat1`` writes this layout from plain numpy arrays (e.g. exported
from a trained Larq model's weights).
"""

from __future__ import annotations

import io
import math
from typing import BinaryIO, Sequence, Union

import numpy as np

from ..formats.varprep import VarPrepWriter
from ..models.dims import Dimensions, bits_for_upper_bound
from ..models.spec import (
    Activation,
    BiasKind,
    ConvKind,
    Domain,
    LayerSpec,
    ModelSpec,
    PoolKind,
)
from ..models.spec import BIN_SLOPE_BITS, INT_SLOPE_BITS, _same_pad_geometry

BNORM_EPS = 0.001  # tBNormParams.eps default (net templates)


class _FloatReader:
    def __init__(self, data: Union[bytes, BinaryIO, str]):
        if isinstance(data, (bytes, bytearray)):
            self._buf = io.BytesIO(bytes(data))
        elif isinstance(data, str):
            with open(data, "rb") as f:
                self._buf = io.BytesIO(f.read())
        else:
            self._buf = io.BytesIO(data.read())

    def read_f32(self, count: int) -> np.ndarray:
        b = self._buf.read(4 * count)
        if len(b) != 4 * count:
            raise EOFError(f"var.dat1 truncated: wanted {count} floats")
        return np.frombuffer(b, dtype="<f4").astype(np.float64)


def weight_convert(spec: ModelSpec, raw: Union[bytes, str, BinaryIO]) -> bytes:
    """Convert a float dump to the packed inference format (var_prep bytes)."""
    rd = _FloatReader(raw)
    wr = VarPrepWriter()
    dim = spec.input_dims.copy()

    for layer in spec.layers:
        _convert_layer(layer, dim, rd, wr)
    return wr.getvalue()


def _convert_layer(spec: LayerSpec, dim: Dimensions, rd: _FloatReader, wr: VarPrepWriter):
    is_int = spec.domain == Domain.INT
    weights = None
    bias = None
    slope = None

    # ---- conv prep + filter read (BinFunc.cpp:76-133 weight-convert branch)
    if spec.conv != ConvKind.NONE:
        p = spec.conv_params
        window, stride = p.window, p.stride
        if spec.conv in (ConvKind.FC, ConvKind.FC_FINAL):
            dim.in_dep *= dim.h * dim.w
            dim.h = dim.w = 1
            window, same_pad = (1, 1), True
        else:
            same_pad = p.same_pad
        if same_pad:
            out_h, out_w, _ = _same_pad_geometry(dim.h, dim.w, window, stride)
        else:
            out_h = (dim.h - 2 * ((window[0] - 1) // 2)) // stride[0]
            out_w = (dim.w - 2 * ((window[1] - 1) // 2)) // stride[1]
        flen = window[0] * window[1] * dim.in_dep * spec.out_depth
        f = rd.read_f32(flen).reshape(window[0], window[1], dim.in_dep, spec.out_depth)
        sign = f > 0  # BinOps.cpp:354
        tern = np.abs(f) < p.tern_thresh  # BinOps.cpp:355
        weights = (sign.astype(np.uint8), tern.astype(np.uint8))

        bias = np.zeros(spec.out_depth, dtype=np.float64)
        if is_int:
            # 1's-complement correction (IntFunc.cpp:405-427)
            bias += ((tern == 0) & (sign == 0)).sum(axis=(0, 1, 2)).astype(np.float64)
        if spec.bias == BiasKind.BIAS:
            read_bias = rd.read_f32(spec.out_depth)
            if not is_int:  # Bin adds; Int reads and discards (IntFunc.cpp:449-455)
                bias += read_bias

        dim.up_bound *= dim.filter_bits * window[0] * window[1] * dim.in_dep
        dim.in_bits = bits_for_upper_bound(dim.up_bound, dim.in_bits)
        dim.h, dim.w, dim.in_dep = out_h, out_w, spec.out_depth
    else:
        bias = np.zeros(dim.in_dep, dtype=np.float64)

    depth = dim.in_dep

    # ---- batch norm fold (BinFunc.cpp:552-592 / IntFunc.cpp:519-557)
    if spec.bias == BiasKind.BNORM:
        gamma = np.ones(depth)
        beta = rd.read_f32(depth)
        mean = rd.read_f32(depth)
        var = rd.read_f32(depth)
        stddev = np.sqrt(var + BNORM_EPS)
        bias = bias - dim.scale * mean + dim.scale * beta * stddev / gamma
        slope = gamma / stddev

    # ---- sumpool (BinFunc.cpp:795-802: bias *= window area; dims update)
    if spec.pool == PoolKind.SUM:
        pp = spec.pool_params
        window = pp.window
        stride = tuple(s if s != 0 else w for s, w in zip(pp.stride, window))
        if pp.same_pad:
            out_h, out_w, _ = _same_pad_geometry(dim.h, dim.w, window, stride)
        else:
            out_h = (dim.h - (window[0] // 2) - 1) // stride[0] + 1
            out_w = (dim.w - (window[1] // 2) - 1) // stride[1] + 1
        bias = bias * window[0] * window[1]
        dim.up_bound *= window[0] * window[1]
        dim.in_bits = bits_for_upper_bound(dim.up_bound, dim.in_bits)
        dim.h, dim.w = out_h, out_w
        dim.scale *= window[0] * window[1]

    # ---- quantize bias/slope scaling + export
    shift_bits = spec.resolved_shift_bits()
    want_slope = spec.activation == Activation.RELU and spec.bias == BiasKind.BNORM
    if not is_int:
        # BinFunc.cpp:1172-1202 (non-ZERO_BRIDGE: add_offset starts 0)
        sb = 0
        while (1 << sb) < math.sqrt(dim.up_bound) / 2:
            sb += 1
        slope_bits = BIN_SLOPE_BITS + sb
        if want_slope and slope is not None:
            slope = slope * (1 << slope_bits)
            bias = bias + 1.0 / (1 << shift_bits)
            bias = bias * slope
            add_offset = -(dim.up_bound * slope / 2.0)
            slope = slope + 0.5
            bias = bias + add_offset
        out_bits = (shift_bits + 1) if shift_bits > 1 else 1
        dim.in_bits = out_bits
        dim.up_bound = 1 << (out_bits - 1)
        dim.scale = float(dim.up_bound) if shift_bits > 1 else 0.5
        if weights is not None:
            wr.write_tern_raw(*weights)
        wr.write_i32(bias, signed=False)  # export_mulbits (BinFunc.cpp:1217)
        if want_slope:
            wr.write_i32(slope, signed=False)
    else:
        sc_b = 0
        while (1 << sc_b) < dim.scale:
            sc_b += 1
        slope_bits = INT_SLOPE_BITS + sc_b - shift_bits
        if want_slope and shift_bits > 1 and slope is not None:
            # IntFunc.cpp:983-1000
            slope = slope * (1 << shift_bits) / dim.scale
            slope = slope * (1 << slope_bits)
            bias = bias * slope
            bias = bias + 0.5 * (1 << slope_bits) + 0.5
            slope = slope + 0.5
        if shift_bits == 0:
            out_bits = dim.in_bits
        elif shift_bits == 1:
            out_bits = 1
            dim.scale = 1.0
        else:
            out_bits = shift_bits
            dim.scale = float((1 << out_bits) - 1)
        dim.in_bits = out_bits
        dim.up_bound = 1 << (out_bits - 1)
        if weights is not None:
            wr.write_tern_raw(*weights)
        wr.write_i32(bias, signed=True)  # export_signedBias (IntFunc.cpp:1015)
        if want_slope and shift_bits > 1:
            wr.write_i32(slope, signed=False)

    # ---- maxpool dims
    if spec.pool == PoolKind.MAX and spec.conv != ConvKind.FC_FINAL:
        pp = spec.pool_params
        window = pp.window
        if pp.same_pad:
            dim.h = (dim.h - 1) // (pp.stride[0] or window[0]) + 1
            dim.w = (dim.w - 1) // (pp.stride[1] or window[1]) + 1
        else:
            dim.h //= window[0]
            dim.w //= window[1]


def export_var_dat1(arrays: Sequence[np.ndarray]) -> bytes:
    """Write a float dump from plain arrays (e.g. a trained Larq model's
    ``model.get_weights()``) in the reader-implied order — the exporter the
    reference never shipped (SURVEY.md §2.5)."""
    buf = io.BytesIO()
    for a in arrays:
        buf.write(np.ascontiguousarray(a, dtype="<f4").tobytes())
    return buf.getvalue()
