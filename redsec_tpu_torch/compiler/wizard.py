"""Interactive netlist generator: the role of the reference's Excel/VBA
``REDsecNetlistGenerator.xlsm`` (compiler/README.md:12-22) as a terminal
wizard — prompts for the input geometry and per-layer choices, enforces the
NetlistStyleGuide constraints as it goes (MaxPool requires Sign, BNorm not in
the last layer, Flatten before the first FC after spatial layers), and writes
the CSV the netlist compiler consumes.

Also usable non-interactively: ``build_netlist(...)`` assembles the CSV from
a plain layer description list (what the Excel sheet's cells held).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, TextIO


@dataclasses.dataclass
class WizardLayer:
    """One netlist row (compiler/NetlistStyleGuide.md:6-73)."""

    kind: str  # "conv" | "fc"
    depth: int
    window: tuple = (3, 3)
    stride: tuple = (1, 1)
    same_pad: bool = True
    tern_thresh: float = 0.05
    pool: Optional[str] = None  # "max" | "sum"
    pool_window: tuple = (2, 2)
    pool_stride: tuple = (0, 0)  # 0 -> window
    bnorm: bool = True
    bnorm_momentum: float = 0.95
    bnorm_eps: float = 0.001
    dropout: float = 0.0
    activation: str = "sign"  # "sign" | "relu" | "none"
    relu_bits: int = 4


def _pool_cell(name: str, window, stride, same_pad=False) -> str:
    sh = stride[0] or window[0]
    sw = stride[1] or window[1]
    pad = "Same" if same_pad else "Valid"
    return f"{name}({{{window[0]}:{window[1]}}}:{{{sh}:{sw}}}:{pad})"


def build_netlist(input_hwc_bits, layers: Sequence[WizardLayer]) -> str:
    """Assemble the CSV netlist; raises on style-guide violations."""
    h, w, c, bits = input_hwc_bits
    rows = []
    seen_fc = False
    flattened = h == 1 and w == 1
    for i, L in enumerate(layers):
        last = i == len(layers) - 1
        if L.pool == "max" and L.activation != "sign":
            raise ValueError(
                f"layer {i}: MaxPool requires Sign activation "
                "(NetlistStyleGuide.md:34-36)")
        if L.bnorm and last:
            raise ValueError(
                f"layer {i}: BNorm not allowed in the last layer "
                "(NetlistStyleGuide.md:44-45)")
        if L.kind == "conv" and seen_fc:
            raise ValueError(f"layer {i}: Convolution after FullyConnect")
        cells = [""] * 6
        if i == 0:
            cells[0] = f"input_size({h}:{w}:{c}:{bits})"
        elif L.kind == "conv":
            pad = "Same" if L.same_pad else "Valid"
            cells[0] = (f"Convolution({L.depth}:{{{L.window[0]}:{L.window[1]}}}"
                        f":{{{L.stride[0]}:{L.stride[1]}}}:{pad}:{L.tern_thresh}")
            cells[0] += ")"
        else:
            cells[0] = f"FullyConnect({L.depth}:{L.tern_thresh})"
            seen_fc = True
        if L.pool == "max":
            cells[1] = _pool_cell("MaxPooling", L.pool_window, L.pool_stride)
        elif L.pool == "sum":
            cells[1] = _pool_cell("SumPooling", L.pool_window, L.pool_stride)
        if L.bnorm and not last:
            cells[2] = f"BNorm({L.bnorm_momentum}:{L.bnorm_eps})"
        if L.dropout > 0:
            cells[3] = f"Dropout({L.dropout})"
        if L.activation == "sign":
            cells[4] = "Sign()"
        elif L.activation == "relu":
            cells[4] = f"ReLU({L.relu_bits})"
        # Flatten before the first FC after spatial layers
        # (NetlistStyleGuide.md:69-71)
        nxt = layers[i + 1] if i + 1 < len(layers) else None
        if not flattened and (nxt is None or nxt.kind == "fc") and (
            i == 0 or L.kind == "conv"
        ):
            cells[5] = "Flatten()"
            flattened = True
        rows.append(",".join(cells))
    return "\n".join(rows) + "\n"


def _ask(prompt: str, default, cast, inp: TextIO, out: TextIO):
    out.write(f"{prompt} [{default}]: ")
    out.flush()
    line = inp.readline().strip()
    return cast(line) if line else default


def run_wizard(inp: TextIO, out: TextIO) -> str:
    """Interactive prompts -> CSV text (the xlsm form-flow, terminalized)."""
    out.write("REDsec netlist wizard (role of REDsecNetlistGenerator.xlsm)\n")
    h = _ask("input height", 28, int, inp, out)
    w = _ask("input width", 28, int, inp, out)
    c = _ask("input channels", 1, int, inp, out)
    bits = _ask("input pixel bits", 8, int, inp, out)
    n = _ask("number of layers (incl. final classifier)", 4, int, inp, out)
    layers: List[WizardLayer] = []
    for i in range(n):
        last = i == n - 1
        out.write(f"--- layer {i}{' (final)' if last else ''} ---\n")
        if last:
            depth = _ask("classes", 10, int, inp, out)
            layers.append(WizardLayer("fc", depth, bnorm=False,
                                      activation="none"))
            continue
        kind = _ask("kind (conv/fc/input-pool)", "fc", str, inp, out)
        if kind == "input-pool" and i == 0:
            pool = _ask("pool (sum/max/none)", "sum", str, inp, out)
            act = _ask("activation (sign/relu/none)", "sign", str, inp, out)
            layers.append(WizardLayer(
                "conv", 0, pool=None if pool == "none" else pool,
                bnorm=False, activation=act))
            continue
        depth = _ask("output depth", 1024, int, inp, out)
        L = WizardLayer(kind, depth)
        if kind == "conv":
            wh = _ask("filter h", 3, int, inp, out)
            ww = _ask("filter w", 3, int, inp, out)
            L.window = (wh, ww)
            L.same_pad = _ask("same padding (y/n)", "y", str, inp, out) == "y"
        L.tern_thresh = _ask("ternary threshold", 0.05, float, inp, out)
        pool = _ask("pool (none/max/sum)", "none", str, inp, out)
        L.pool = None if pool == "none" else pool
        L.bnorm = _ask("batch norm (y/n)", "y", str, inp, out) == "y"
        L.activation = _ask("activation (sign/relu)", "sign", str, inp, out)
        if L.activation == "relu":
            L.relu_bits = _ask("relu output bits", 4, int, inp, out)
        layers.append(L)
    return build_netlist((h, w, c, bits), layers)
