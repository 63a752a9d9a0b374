"""Dimension / bit-width bookkeeping, mirroring the reference's ``tDimensions``.

The reference threads a ``tDimensions`` struct (lib/Layer.h:113-127) through
every layer's ``prep``: height/width, channel depth, input/output bit counts,
the running upper bound of the integer values, and a float scale factor.  The
bit-width and ``up_bound`` recurrences below are load-bearing: the ReLU path's
``slope_bits`` is derived from them (lib/BinFunc.cpp:1013-1015,
lib/IntFunc.cpp:813-815), so we reproduce them exactly.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Dimensions:
    h: int
    w: int
    in_dep: int
    in_bits: int
    out_bits: int = 1
    filter_bits: int = 1
    bias_bits: int = 1
    up_bound: int = 0
    scale: float = 1.0

    def copy(self) -> "Dimensions":
        return dataclasses.replace(self)


def bits_for_upper_bound(up_bound: int, start_bits: int) -> int:
    """``for(out_bits=in_bits; (up_bound>>out_bits)>0; out_bits++)``
    (lib/BinFunc.cpp:112-114)."""
    out_bits = start_bits
    while (up_bound >> out_bits) > 0:
        out_bits += 1
    return out_bits


def mnist_input_dims() -> Dimensions:
    """Input dims used by the mnist sign nets (nets/mnist/sign1024x1/net.cpp:96-105):
    pixels mapped to 2p-255 in [-255, 255]."""
    return Dimensions(h=28, w=28, in_dep=1, in_bits=9, up_bound=2 * 255, scale=255.0)


def mnist_relu_input_dims() -> Dimensions:
    """Input dims used by the mnist relu nets (nets/mnist/relu1024x2/net.cpp:96-108)."""
    return Dimensions(h=28, w=28, in_dep=1, in_bits=2, up_bound=2, scale=1.0)


def cifar_input_dims() -> Dimensions:
    """Input dims used by the cifar nets (nets/cifar/binarynet/net.cpp:96-108)."""
    return Dimensions(h=32, w=32, in_dep=3, in_bits=8, up_bound=2 * 255, scale=255.0)
