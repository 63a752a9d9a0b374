"""Carry state across from the JAX package.

The JAX package's keys and model plans are plain dataclasses whose state is
numpy arrays, enums and ints.  These functions read that state by attribute
name (without importing the JAX package) and build the port's own objects
from it, so both packages can compute on identical inputs:

- ``secret_key``: ``SecretKey`` (``lwe_key``, ``rlwe_key``);
- ``cloud_key``: ``CloudKey`` (``bk``, ``ksk``, ``bk_pair``, ``rerand``);
- ``model_plan``: ``ModelPlan`` with its spec and every layer's ternary
  weights, biases, slopes, ``neg_correction``, pool geometry and calibration
  artefacts.

Parameter sets are matched by name and must equal the port's own.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .crypto.keygen import CloudKey, SecretKey
from .crypto.params import TfheParams, get_params
from .models import spec as S
from .models.dims import Dimensions


def params(src) -> TfheParams:
    """The port's parameter set of the same name; raises if any field differs."""
    mine = get_params(src.name)
    theirs = {f.name: getattr(src, f.name) for f in dataclasses.fields(TfheParams)}
    if dataclasses.asdict(mine) != theirs:
        raise ValueError(f"parameter set {src.name!r} differs between the packages")
    return mine


def _arr(a, dtype=None):
    return None if a is None else np.array(a, dtype=dtype, copy=True)


def secret_key(src) -> SecretKey:
    return SecretKey(params(src.params), _arr(src.lwe_key, np.int32),
                     _arr(src.rlwe_key, np.int32))


def cloud_key(src) -> CloudKey:
    return CloudKey(params(src.params), _arr(src.bk, np.int32), _arr(src.ksk, np.int32),
                    bk_pair=_arr(src.bk_pair, np.int32), rerand=_arr(src.rerand, np.int32))


def _enum(cls, v):
    return cls(v.value)


def _dims(d) -> Dimensions:
    return Dimensions(**{f.name: getattr(d, f.name) for f in dataclasses.fields(Dimensions)})


def _layer_spec(ls) -> S.LayerSpec:
    cp, pp = ls.conv_params, ls.pool_params
    return S.LayerSpec(
        domain=_enum(S.Domain, ls.domain), conv=_enum(S.ConvKind, ls.conv),
        out_depth=ls.out_depth, pool=_enum(S.PoolKind, ls.pool),
        activation=_enum(S.Activation, ls.activation), bias=_enum(S.BiasKind, ls.bias),
        conv_params=S.ConvParams(tuple(cp.window), tuple(cp.stride), cp.same_pad,
                                 cp.tern_thresh),
        pool_params=S.PoolParams(tuple(pp.window), tuple(pp.stride), pp.same_pad),
        shift_bits=ls.shift_bits)


def model_spec(src) -> S.ModelSpec:
    return S.ModelSpec(src.name, _dims(src.input_dims), [_layer_spec(ls) for ls in src.layers])


def _pool(p):
    if p is None:
        return None
    return S.PoolPlan(tuple(p.window), tuple(p.stride), tuple(p.offset), p.in_h, p.in_w,
                      p.depth, p.out_h, p.out_w)


def _conv(c):
    if c is None:
        return None
    return S.ConvPlan(
        weights=_arr(c.weights, np.int8), neg_correction=_arr(c.neg_correction, np.int32),
        in_h=c.in_h, in_w=c.in_w, in_dep=c.in_dep, out_dep=c.out_dep, out_h=c.out_h,
        out_w=c.out_w, stride=tuple(c.stride), offset=tuple(c.offset), flatten=c.flatten)


def _quant(q) -> S.QuantPlan:
    return S.QuantPlan(
        mode=_enum(S.Activation, q.mode), bias=_arr(q.bias, np.int32),
        slope=_arr(q.slope, np.uint32), shift_bits=q.shift_bits, slope_bits=q.slope_bits,
        in_bits=q.in_bits, h=q.h, w=q.w, depth=q.depth)


def _calib(d):
    return None if d is None else {k: _arr(v) for k, v in d.items()}


def model_plan(src) -> S.ModelPlan:
    """The port's ``ModelPlan`` carrying the same per-layer arrays."""
    spec = model_spec(src.spec)
    layers = []
    for ls, lp in zip(spec.layers, src.layers):
        interval = lp.measured_chan_interval
        layers.append(S.LayerPlan(
            spec=ls, in_dim=_dims(lp.in_dim), out_dim=_dims(lp.out_dim),
            conv=_conv(lp.conv), sumpool=_pool(lp.sumpool), quant=_quant(lp.quant),
            maxpool=_pool(lp.maxpool), measured_pre_bound=lp.measured_pre_bound,
            measured_chan_interval=(None if interval is None
                                    else tuple(_arr(a) for a in interval)),
            sign_calib=_calib(lp.sign_calib)))
    return S.ModelPlan(spec=spec, layers=layers, in_dim=_dims(src.in_dim),
                       out_dim=_dims(src.out_dim))
