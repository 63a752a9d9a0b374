"""Per-layer metrics: analytic op counts and wall-clock instrumentation.

The reference's observability is stdout timers in the GPU operators
(lib/GPU/BinFunc_gpu.cu:214-216 "BinConv: X seconds") and analytic op counts
derived in BASELINE.md.  Here the counts come from the prepped ModelPlan, so
``summarize`` reports exactly what a run will execute: bootstraps (nearly all
the cost) and leveled MAC/adds.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

from ..models.spec import Activation, LayerPlan, ModelPlan


@dataclasses.dataclass
class LayerStats:
    name: str
    bootstraps: int
    leveled_macs: int  # plaintext-weight x ciphertext MACs (conv/pool adds)
    activations_out: int


def layer_stats(i: int, lp: LayerPlan) -> LayerStats:
    boots = 0
    macs = 0
    if lp.conv is not None:
        c = lp.conv
        # every output position contracts the full nonzero filter bank
        nonzero = int((c.weights != 0).sum())
        macs += c.out_h * c.out_w * nonzero
    if lp.sumpool is not None:
        s = lp.sumpool
        macs += s.out_h * s.out_w * s.depth * s.window[0] * s.window[1]
    q = lp.quant
    n_act = q.h * q.w * q.depth
    if q.mode in (Activation.SIGN, Activation.RELU):
        boots += n_act
    if lp.maxpool is not None:
        m = lp.maxpool
        boots += m.out_h * m.out_w * m.depth  # one biased sign bootstrap/output
        out_act = m.out_h * m.out_w * m.depth
    else:
        out_act = n_act
    kind = lp.spec.domain.value + "/" + (lp.spec.conv.value if lp.conv else "none")
    return LayerStats(f"L{i} {kind}", boots, macs, out_act)


def model_stats(plan: ModelPlan) -> List[LayerStats]:
    return [layer_stats(i, lp) for i, lp in enumerate(plan.layers)]


def summarize(plan: ModelPlan) -> Dict:
    per = model_stats(plan)
    return {
        "model": plan.spec.name,
        "layers": [dataclasses.asdict(s) for s in per],
        "total_bootstraps": sum(s.bootstraps for s in per),
        "total_leveled_macs": sum(s.leveled_macs for s in per),
    }


class StageTimer:
    """Wall-clock stage timer (host side), the analogue of the reference's
    per-layer prints; mark a stage after the work it times has finished on
    the device (``torch.cuda.synchronize()``)."""

    def __init__(self):
        self.stages: List[tuple] = []
        self._t = time.perf_counter()

    def mark(self, name: str):
        now = time.perf_counter()
        self.stages.append((name, now - self._t))
        self._t = now

    def report(self) -> str:
        return "\n".join(f"{n}: {dt:.3f} seconds" for n, dt in self.stages)
