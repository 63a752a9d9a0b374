"""BYON netlist compiler: CSV netlist -> ModelSpec (+ Larq training script).

Replaces the reference's ``compiler/compiler.py`` C++ code generation: instead
of emitting ``net.cpp``/``net.h``, we emit a JSON model spec the runtime loads
directly (no codegen step needed), plus the same Larq/TensorFlow training
script it generates.  The CSV grammar is unchanged
(compiler/NetlistStyleGuide.md:6-73; parsing mirrors compiler/compiler.py:135-339):

  col 1: input_size(h:w:c:bits) | Convolution(dep:{wh:ww}:{sh:sw}:pad:thresh)
         | FullyConnect(dep:thresh)
  col 2: MaxPool({wh:ww}:{sh:sw}:pad) | SumPool(...)  (SumPooling accepted)
  col 3: BNorm(momentum:eps)
  col 4: Dropout(rate)          (training only)
  col 5: Sign() | ReLU(outBits)
  col 6: Flatten()

Layer-domain rule (compiler.py:310-335): a layer is a Bin layer iff the
PREVIOUS row's activation was Sign; the first layer is always Int.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List

from ..models.dims import Dimensions
from ..models.spec import (
    Activation,
    BiasKind,
    ConvKind,
    ConvParams,
    Domain,
    LayerSpec,
    ModelSpec,
    PoolKind,
    PoolParams,
)


def _args(cell: str) -> List[str]:
    inner = cell[cell.find("(") + 1 : cell.find(")")]
    return [a.strip() for a in inner.split(":")] if inner.strip() else []


def _brace_pair(a: str, b: str):
    return int(a.lstrip("{")), int(b.rstrip("}"))


@dataclasses.dataclass
class ParsedRow:
    cells: List[str]

    def cell(self, i: int) -> str:
        return self.cells[i].strip() if i < len(self.cells) and self.cells[i] else ""

    def has(self, i: int, token: str) -> bool:
        return token.lower() in self.cell(i).lower()


def parse_netlist(path: str, name: str = "custom") -> ModelSpec:
    with open(path) as f:
        rows = [ParsedRow(line.rstrip("\n").split(",")) for line in f if line.strip()]

    first = rows[0]
    if not first.has(0, "input_size"):
        raise ValueError("first netlist row must contain input_size (NetlistStyleGuide)")
    h, w, c, bits = (int(v) for v in _args(first.cell(0)))
    # compiler.py:156-159: up_bound = 2*(2^bits - 1), scale = 2^bits - 1
    input_dims = Dimensions(h=h, w=w, in_dep=c, in_bits=bits,
                            up_bound=2 * (2**bits - 1), scale=float(2**bits - 1))

    layers: List[LayerSpec] = []
    domain = Domain.INT  # compiler.py:133: layers = ["IntLayer"]
    flattened = False
    for li, row in enumerate(rows):
        # column 1: linear op
        if li == 0:
            conv_kind, out_depth, conv_params = ConvKind.NONE, c, ConvParams()
        elif row.has(0, "FullyConnect"):
            if not flattened:
                raise ValueError("FullyConnect requires a prior Flatten() (compiler.py:172-174)")
            a = _args(row.cell(0))
            conv_kind = ConvKind.FC
            out_depth = int(a[0])
            conv_params = ConvParams(tern_thresh=float(a[1]))
        elif row.has(0, "Convolution"):
            a = _args(row.cell(0))
            wh, ww = _brace_pair(a[1], a[2])
            sh, sw = _brace_pair(a[3], a[4])
            conv_kind = ConvKind.CONV
            out_depth = int(a[0])
            conv_params = ConvParams(window=(wh, ww), stride=(sh, sw),
                                     same_pad="same" in a[5].lower(),
                                     tern_thresh=float(a[6]))
        else:
            raise ValueError(f"row {li}: expected Convolution or FullyConnect")

        # column 2: pooling
        pool_kind, pool_params = PoolKind.NONE, PoolParams()
        cell1 = row.cell(1)
        if cell1:
            a = _args(cell1)
            wh, ww = _brace_pair(a[0], a[1])
            sh, sw = _brace_pair(a[2], a[3])
            pool_params = PoolParams(window=(wh, ww), stride=(sh, sw),
                                     same_pad="same" in a[4].lower())
            if row.has(1, "MaxPool"):
                pool_kind = PoolKind.MAX
            elif row.has(1, "SumPool"):
                pool_kind = PoolKind.SUM
            else:
                raise ValueError(f"row {li}: unknown pooling {cell1!r}")

        # column 3: batch norm
        bias = BiasKind.BNORM if row.has(2, "BNorm") else BiasKind.NONE

        # column 5: activation (decides the NEXT layer's domain)
        shift_bits = 1
        if row.has(4, "Sign"):
            act, next_domain = Activation.SIGN, Domain.BIN
        elif row.has(4, "ReLU"):
            act, next_domain = Activation.RELU, Domain.INT
            shift_bits = int(_args(row.cell(4))[0])
        else:
            if bias == BiasKind.BNORM:
                raise ValueError(f"row {li}: BNorm requires an activation (compiler.py:329-332)")
            act, next_domain = Activation.NONE, Domain.INT
        if pool_kind == PoolKind.MAX and act != Activation.SIGN:
            raise ValueError(f"row {li}: MaxPool requires Sign activation")

        if row.has(5, "Flatten"):
            flattened = True

        layers.append(LayerSpec(
            domain=domain, conv=conv_kind, out_depth=out_depth, pool=pool_kind,
            activation=act, bias=bias, conv_params=conv_params,
            pool_params=pool_params, shift_bits=shift_bits,
        ))
        domain = next_domain

    return ModelSpec(name, input_dims, layers)


# --------------------------------------------------------------------------- #
# JSON (de)serialization of model specs                                       #
# --------------------------------------------------------------------------- #


def spec_to_json(spec: ModelSpec) -> dict:
    return {
        "name": spec.name,
        "input_dims": dataclasses.asdict(spec.input_dims),
        "layers": [
            {
                "domain": l.domain.value, "conv": l.conv.value,
                "out_depth": l.out_depth, "pool": l.pool.value,
                "activation": l.activation.value, "bias": l.bias.value,
                "conv_params": dataclasses.asdict(l.conv_params),
                "pool_params": dataclasses.asdict(l.pool_params),
                "shift_bits": l.shift_bits,
            }
            for l in spec.layers
        ],
    }


def spec_from_json(d: dict) -> ModelSpec:
    layers = [
        LayerSpec(
            domain=Domain(l["domain"]), conv=ConvKind(l["conv"]),
            out_depth=l["out_depth"], pool=PoolKind(l["pool"]),
            activation=Activation(l["activation"]), bias=BiasKind(l["bias"]),
            conv_params=ConvParams(**{**l["conv_params"],
                                      "window": tuple(l["conv_params"]["window"]),
                                      "stride": tuple(l["conv_params"]["stride"])}),
            pool_params=PoolParams(**{**l["pool_params"],
                                      "window": tuple(l["pool_params"]["window"]),
                                      "stride": tuple(l["pool_params"]["stride"])}),
            shift_bits=l["shift_bits"],
        )
        for l in d["layers"]
    ]
    return ModelSpec(d["name"], Dimensions(**d["input_dims"]), layers)


# --------------------------------------------------------------------------- #
# Larq training-script generation (compiler.py's tf output)                   #
# --------------------------------------------------------------------------- #


def generate_larq_script(path: str, spec: ModelSpec) -> str:
    """Emit the Larq/TensorFlow training twin (QuantConv2D/QuantDense with
    ste_sign / SteTern / DoReFa quantizers, compiler.py:186-221, 310-328)."""
    d = spec.input_dims
    lines = [
        "# Auto-generated by redsec_tpu_torch.compiler (Larq training twin)",
        "import tensorflow as tf",
        "import larq as lq",
        "",
        "model = tf.keras.models.Sequential()",
        f"model.add(tf.keras.Input(({d.h},{d.w},{d.in_dep})))",
    ]
    act_str = f"input_quantizer=lq.quantizers.NoOp(precision={d.in_bits})"
    flattened = False
    for l in spec.layers:
        cp = l.conv_params
        if cp.tern_thresh == 0:
            kq = 'kernel_quantizer="ste_sign"'
        else:
            kq = f"kernel_quantizer=lq.quantizers.SteTern(threshold_value={cp.tern_thresh})"
        if l.conv == ConvKind.CONV:
            pad = "same" if cp.same_pad else "valid"
            lines.append(
                f"model.add(lq.layers.QuantConv2D({l.out_depth}, {cp.window}, "
                f"strides={cp.stride}, padding=\"{pad}\", {kq}, "
                f'kernel_constraint="weight_clip", use_bias=False, {act_str}))'
            )
        elif l.conv in (ConvKind.FC, ConvKind.FC_FINAL):
            if not flattened:
                lines.append("model.add(tf.keras.layers.Flatten())")
                flattened = True
            lines.append(
                f"model.add(lq.layers.QuantDense({l.out_depth}, {kq}, "
                f'kernel_constraint="weight_clip", use_bias=False, {act_str}))'
            )
        pp = l.pool_params
        pad = "same" if pp.same_pad else "valid"
        if l.pool == PoolKind.SUM:
            lines.append(
                f"model.add(tf.keras.layers.AveragePooling2D({pp.window}, "
                f"strides={pp.stride}, padding=\"{pad}\"))"
            )
        if l.bias == BiasKind.BNORM:
            lines.append("model.add(tf.keras.layers.BatchNormalization(momentum=0.9, "
                         "epsilon=0.001, scale=False))")
        if l.activation == Activation.SIGN:
            act_str = 'input_quantizer="ste_sign"'
        elif l.activation == Activation.RELU:
            act_str = f"input_quantizer=lq.quantizers.DoReFa(k_bit={l.shift_bits})"
        if l.pool == PoolKind.MAX:
            lines.append(
                f"model.add(tf.keras.layers.MaxPool2D({pp.window}, "
                f"strides={pp.stride}, padding=\"{pad}\"))"
            )
    lines.append('model.add(tf.keras.layers.Activation("softmax"))')
    lines.append("")
    lines.append("lq.models.summary(model)")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def compile_netlist(csv_path: str, name: str, out_dir: str = ".") -> dict:
    spec = parse_netlist(csv_path, name)
    os.makedirs(out_dir, exist_ok=True)
    spec_path = os.path.join(out_dir, f"{name}_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec_to_json(spec), f, indent=2)
    train_path = generate_larq_script(os.path.join(out_dir, f"{name}_train.py"), spec)
    return {
        "name": name,
        "layers": len(spec.layers),
        "spec": spec_path,
        "train_script": train_path,
    }
