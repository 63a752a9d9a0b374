"""Model IR: layer specifications and the prep pass (dimension inference + weight load).

One declarative spec replaces the reference's four ``#ifdef``-forked builds
(lib/Makefile:10-26).  A ``ModelSpec`` describes the architecture exactly as the
generated ``net.cpp`` constructors do (e.g. nets/mnist/sign1024x1/net.cpp:85-93);
``prep_model`` mirrors the reference's prep chain (BinLayer.cpp:150-241,
IntLayer.cpp:153-234): it walks the layers, infers shapes/bit-widths via the
``tDimensions`` recurrences, and loads weights sequentially from a
``var_prep.dat`` stream.

The execution order inside a layer is fixed (BinLayer.cpp:150-241):
``Conv/FC -> SumPool -> Quantize(sign|none|relu) -> MaxPool``.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import List, Optional, Tuple

import numpy as np

from ..formats.varprep import VarPrepReader
from .dims import Dimensions, bits_for_upper_bound

BIN_SLOPE_BITS = 16  # lib/BinFunc.cpp:40
INT_SLOPE_BITS = 8  # lib/IntFunc.cpp:45


class Domain(enum.Enum):
    BIN = "bin"  # BinLayer: inputs are +-1 bits
    INT = "int"  # IntLayer: inputs are multi-bit integers


class ConvKind(enum.Enum):
    NONE = "none"
    CONV = "conv"
    FC = "fc"
    FC_FINAL = "fc_final"


class PoolKind(enum.Enum):
    NONE = "none"
    MAX = "max"
    SUM = "sum"


class Activation(enum.Enum):
    NONE = "none"
    SIGN = "sign"
    RELU = "relu"


class BiasKind(enum.Enum):
    NONE = "none"
    BIAS = "bias"
    BNORM = "bnorm"


@dataclasses.dataclass
class ConvParams:
    window: Tuple[int, int] = (1, 1)
    stride: Tuple[int, int] = (1, 1)
    same_pad: bool = False
    tern_thresh: float = 0.05


@dataclasses.dataclass
class PoolParams:
    window: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (0, 0)  # 0 -> window (BinFunc.cpp:608-609)
    same_pad: bool = False


@dataclasses.dataclass
class LayerSpec:
    domain: Domain
    conv: ConvKind
    out_depth: int
    pool: PoolKind = PoolKind.NONE
    activation: Activation = Activation.SIGN
    bias: BiasKind = BiasKind.BNORM
    conv_params: ConvParams = dataclasses.field(default_factory=ConvParams)
    pool_params: PoolParams = dataclasses.field(default_factory=PoolParams)
    shift_bits: int = 1

    def resolved_shift_bits(self) -> int:
        """Constructor-forced shift_bits (BinLayer.cpp:72, IntLayer.cpp:74-75)."""
        if self.activation == Activation.SIGN:
            return 1
        if self.domain == Domain.INT and self.activation == Activation.NONE:
            return 0
        if self.domain == Domain.BIN and self.shift_bits < 1:
            return 1
        return self.shift_bits


@dataclasses.dataclass
class ModelSpec:
    name: str
    input_dims: Dimensions
    layers: List[LayerSpec]

    @property
    def num_classes(self) -> int:
        return self.layers[-1].out_depth


# --------------------------------------------------------------------------- #
# Prepped plans                                                               #
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class ConvPlan:
    weights: np.ndarray  # int8 [wh, ww, in_dep, out_dep], values in {-1, 0, +1}
    # Integer-domain layers negate by 1's complement (~x = -x-1,
    # IntOps.cpp:72-82) with the +1s folded into the exported bias
    # (IntFunc.cpp:405-427), so the conv output is sum(w*x) - #neg_weights.
    # None for binary-domain layers (bit flip is an exact +-1 negation).
    neg_correction: "np.ndarray | None"
    in_h: int
    in_w: int
    in_dep: int
    out_dep: int
    out_h: int
    out_w: int
    stride: Tuple[int, int]
    offset: Tuple[int, int]
    flatten: bool  # FC/FC_FINAL flatten input first (BinLayer.cpp:161-167)


@dataclasses.dataclass
class PoolPlan:
    window: Tuple[int, int]
    stride: Tuple[int, int]
    offset: Tuple[int, int]
    in_h: int
    in_w: int
    depth: int
    out_h: int
    out_w: int


@dataclasses.dataclass
class QuantPlan:
    mode: Activation
    bias: np.ndarray  # int32 [depth]
    slope: Optional[np.ndarray]  # uint32 [depth] (ReLU only)
    shift_bits: int
    slope_bits: int
    in_bits: int
    h: int
    w: int
    depth: int


@dataclasses.dataclass
class LayerPlan:
    spec: LayerSpec
    in_dim: Dimensions
    out_dim: Dimensions
    conv: Optional[ConvPlan]
    sumpool: Optional[PoolPlan]
    quant: QuantPlan
    maxpool: Optional[PoolPlan]
    # max |pre-PBS value| observed by runtime.ranges.calibrate_ranges, if run;
    # drives the per-layer relu implementation choice and the range guard
    measured_pre_bound: Optional[int] = None
    # per-channel (lo, hi) pre-PBS intervals from calibrate_ranges (RELU
    # layers only); lets runtime.ranges center asymmetric ranges so the PBS
    # budget covers (hi-lo)/2 instead of max(|lo|,|hi|)
    measured_chan_interval: "Optional[tuple]" = None
    # SIGN layers: calibration artifacts for flip-optimal gain selection —
    # {"mask": bool [H,W,C] all-even-parity positions (tie-break targets),
    #  "hist": int64 [M] histogram of |pre+bias(+tie)| margins,
    #  "hist_raw": same without the tie-break offset}
    sign_calib: "Optional[dict]" = None


@dataclasses.dataclass
class ModelPlan:
    spec: ModelSpec
    layers: List[LayerPlan]
    in_dim: Dimensions
    out_dim: Dimensions


# --------------------------------------------------------------------------- #
# Prep pass                                                                   #
# --------------------------------------------------------------------------- #


def _same_pad_geometry(in_h, in_w, window, stride):
    """Output size and window offset for 'same' padding (BinFunc.cpp:87-95)."""
    out_h = (in_h - 1) // stride[0] + 1
    out_w = (in_w - 1) // stride[1] + 1
    if stride[0] == 1:
        ofs_h = (window[0] - 1) // 2
    else:
        ofs_h = (out_h * stride[0] - in_h) // 2
    if stride[1] == 1:
        ofs_w = (window[1] - 1) // 2
    else:
        ofs_w = (out_w * stride[1] - in_w) // 2
    return out_h, out_w, (ofs_h, ofs_w)


def _prep_conv(spec: LayerSpec, dim: Dimensions, reader: VarPrepReader) -> ConvPlan:
    """Convolution prep: geometry + bit growth + TERN weight load
    (BinFunc.cpp:76-133, identical in IntFunc.cpp:81-143)."""
    p = spec.conv_params
    window, stride = p.window, p.stride
    if spec.conv in (ConvKind.FC, ConvKind.FC_FINAL):
        # flatten + forced 1x1 same-pad window (BinLayer.cpp:57-62, 161-167)
        dim.in_dep *= dim.h * dim.w
        dim.h = dim.w = 1
        window, same_pad = (1, 1), True
    else:
        same_pad = p.same_pad

    in_h, in_w, in_dep = dim.h, dim.w, dim.in_dep
    if same_pad:
        out_h, out_w, offset = _same_pad_geometry(in_h, in_w, window, stride)
    else:
        # valid padding (BinFunc.cpp:96-104)
        offset = (0, 0)
        out_h = (in_h - 2 * ((window[0] - 1) // 2)) // stride[0]
        out_w = (in_w - 2 * ((window[1] - 1) // 2)) // stride[1]

    dim.up_bound *= dim.filter_bits * window[0] * window[1] * in_dep
    out_bits = bits_for_upper_bound(dim.up_bound, dim.in_bits)

    flen = window[0] * window[1] * in_dep * spec.out_depth
    weights = reader.read_tern(flen).reshape(window[0], window[1], in_dep, spec.out_depth)
    neg = None
    if spec.domain == Domain.INT:
        neg = (weights == -1).sum(axis=(0, 1, 2)).astype(np.int32)

    dim.h, dim.w = out_h, out_w
    dim.in_dep = spec.out_depth
    dim.in_bits = out_bits
    dim.out_bits = 1
    return ConvPlan(
        weights=weights,
        neg_correction=neg,
        in_h=in_h,
        in_w=in_w,
        in_dep=in_dep,
        out_dep=spec.out_depth,
        out_h=out_h,
        out_w=out_w,
        stride=stride,
        offset=offset,
        flatten=spec.conv in (ConvKind.FC, ConvKind.FC_FINAL),
    )


def _prep_sumpool(spec: LayerSpec, dim: Dimensions) -> PoolPlan:
    """SumPooling prep (BinFunc.cpp:622-669 / IntFunc.cpp:586-634)."""
    p = spec.pool_params
    window = p.window
    stride = tuple(s if s != 0 else w for s, w in zip(p.stride, window))
    in_h, in_w = dim.h, dim.w
    if p.same_pad:
        out_h, out_w, offset = _same_pad_geometry(in_h, in_w, window, stride)
    else:
        offset = (0, 0)
        out_h = (in_h - (window[0] // 2) - 1) // stride[0] + 1
        out_w = (in_w - (window[1] // 2) - 1) // stride[1] + 1

    dim.up_bound *= window[0] * window[1]
    out_bits = bits_for_upper_bound(dim.up_bound, dim.in_bits)
    dim.h, dim.w = out_h, out_w
    dim.in_bits = out_bits
    dim.scale = dim.scale * window[0] * window[1]
    dim.out_bits = 1
    return PoolPlan(window, stride, offset, in_h, in_w, dim.in_dep, out_h, out_w)


def _prep_maxpool(spec: LayerSpec, dim: Dimensions) -> PoolPlan:
    """MaxPooling prep (BinFunc.cpp:836-872).

    The reference never initializes ``offset_window`` for maxpool; shipped nets
    only use valid pooling where it is zero.  We use zero offset for valid and
    the sumpool-style offset for same padding (documented deviation).
    """
    p = spec.pool_params
    window = p.window
    stride = tuple(s if s != 0 else w for s, w in zip(p.stride, window))
    in_h, in_w = dim.h, dim.w
    if p.same_pad:
        out_h, out_w, offset = _same_pad_geometry(in_h, in_w, window, stride)
    else:
        offset = (0, 0)
        out_h = in_h // window[0]
        out_w = in_w // window[1]
    dim.h, dim.w = out_h, out_w
    dim.out_bits = 1
    return PoolPlan(window, stride, offset, in_h, in_w, dim.in_dep, out_h, out_w)


def _prep_quant(spec: LayerSpec, dim: Dimensions, reader: VarPrepReader) -> QuantPlan:
    """Quantize prep: bias/slope load + slope_bits + dims update
    (BinFunc.cpp:985-1034, IntFunc.cpp:781-849)."""
    shift_bits = spec.resolved_shift_bits()
    depth = dim.in_dep
    bias = reader.read_i32(depth)
    slope = None
    wants_slope = spec.activation == Activation.RELU and spec.bias == BiasKind.BNORM
    if spec.domain == Domain.BIN:
        if wants_slope:
            slope = reader.read_u32(depth)
        # slope_bits = SLOPE_BITS + ceil-ish log2(sqrt(up_bound)/2) (BinFunc.cpp:1013-1015)
        sb = 0
        while (1 << sb) < math.sqrt(dim.up_bound) / 2:
            sb += 1
        slope_bits = BIN_SLOPE_BITS + sb
        in_bits = dim.in_bits
        out_bits = (shift_bits + 1) if shift_bits > 1 else 1
        dim.in_bits = out_bits
        dim.out_bits = 1
        dim.up_bound = 1 << (out_bits - 1)
        dim.scale = float(dim.up_bound) if shift_bits > 1 else 0.5
    else:
        if wants_slope and shift_bits > 1:
            slope = reader.read_u32(depth)
        # slope_bits = SLOPE_BITS + log2ceil(scale) - shift_bits (IntFunc.cpp:813-815)
        sc_b = 0
        while (1 << sc_b) < dim.scale:
            sc_b += 1
        slope_bits = INT_SLOPE_BITS + sc_b - shift_bits
        in_bits = dim.in_bits
        if shift_bits == 0:  # no activation
            out_bits = dim.in_bits
        elif shift_bits == 1:  # sign
            out_bits = 1
            dim.scale = 1.0
        else:  # relu shift
            out_bits = shift_bits
            dim.scale = float((1 << out_bits) - 1)
        dim.in_bits = out_bits
        dim.out_bits = 1
        dim.up_bound = 1 << (out_bits - 1)  # unconditional override (IntFunc.cpp:844)
    return QuantPlan(
        mode=spec.activation,
        bias=bias,
        slope=slope,
        shift_bits=shift_bits,
        slope_bits=slope_bits,
        in_bits=in_bits,
        h=dim.h,
        w=dim.w,
        depth=depth,
    )


def prep_layer(spec: LayerSpec, dim: Dimensions, reader: VarPrepReader) -> LayerPlan:
    in_dim = dim.copy()
    conv = _prep_conv(spec, dim, reader) if spec.conv != ConvKind.NONE else None
    sumpool = _prep_sumpool(spec, dim) if spec.pool == PoolKind.SUM else None
    quant = _prep_quant(spec, dim, reader)
    maxpool = None
    if spec.pool == PoolKind.MAX:
        if spec.activation != Activation.SIGN:
            raise ValueError("MaxPool requires sign activation (BinLayer.cpp:68)")
        if spec.conv != ConvKind.FC_FINAL:  # IntLayer.cpp:221 guard
            maxpool = _prep_maxpool(spec, dim)
    return LayerPlan(
        spec=spec,
        in_dim=in_dim,
        out_dim=dim.copy(),
        conv=conv,
        sumpool=sumpool,
        quant=quant,
        maxpool=maxpool,
    )


def prep_model(spec: ModelSpec, weights: "VarPrepReader | bytes | str") -> ModelPlan:
    """Run the full prep chain, consuming the var_prep.dat stream in layer order."""
    reader = weights if isinstance(weights, VarPrepReader) else VarPrepReader(weights)
    dim = spec.input_dims.copy()
    in_dim = dim.copy()
    plans = [prep_layer(layer, dim, reader) for layer in spec.layers]
    return ModelPlan(spec=spec, layers=plans, in_dim=in_dim, out_dim=dim.copy())
