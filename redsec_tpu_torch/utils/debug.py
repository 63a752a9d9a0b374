"""Layer-by-layer cross-checking — the reference's ``_PRINT_LAYER_`` dumps and
``Cifar_test.ipynb`` comparison flow as a library API.

``layerwise_compare`` runs the encrypted pipeline one stage at a time,
decrypting after every stage and comparing against the plaintext oracle
(``runtime/ptxt.py``, on the key's device) applied to the decrypted stage
input.  Leveled stages must agree exactly at a noiseless parameter set;
at a real one each reports how far it lands from the oracle
(``max_abs_err``, message units), which must stay inside the noise band.
Bootstrapped stages report agreement rate and the margin of every mismatch
(which should sit inside the mod-switch noise band).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..crypto import lwe
from ..crypto.bootstrap import DeviceCloudKey, make_chunked_bootstrap
from ..models.spec import Activation, ModelPlan
from ..ops import encrypted as eops
from ..runtime import ptxt as rp


LEVELED = ("conv", "sumpool", "add_bias")  # stages with no bootstrap


@dataclasses.dataclass
class StageReport:
    layer: int
    stage: str
    exact: bool
    agreement: float
    max_mismatch_margin: int  # |pre-activation| of the worst disagreeing unit
    max_abs_err: int = 0  # max |decrypted - oracle| over the stage, message units


def layerwise_compare(plan: ModelPlan, dkey: DeviceCloudKey, sk, images: np.ndarray,
                      rng=None) -> List[StageReport]:
    params = dkey.params
    pbs = make_chunked_bootstrap(dkey)
    rng = rng or np.random.default_rng(0)
    xc = torch.as_tensor(lwe.encrypt_integers(sk.lwe_key, images, params, rng),
                         device=dkey.device)
    reports: List[StageReport] = []

    def dec(ct):
        return lwe.decrypt_integers(sk.lwe_key, ct.cpu().numpy(), params)

    def oracle(fn, op, x):
        x = torch.as_tensor(np.asarray(x, np.int32), device=dkey.device)
        return fn(op, x).cpu().numpy()

    def err(got, want):
        return int(np.abs(got.astype(np.int64) - np.asarray(want, np.int64)).max(initial=0))

    def report_exact(li, stage, got, want):
        ok = np.array_equal(got, want)
        reports.append(StageReport(li, stage, ok, float((got == want).mean()), 0,
                                   err(got, want)))

    def report_boots(li, stage, got, want, margin):
        bad = got != want
        worst = int(np.abs(margin[bad]).max(initial=0))
        reports.append(StageReport(li, stage, not bad.any(), float((~bad).mean()), worst,
                                   err(got, want)))

    for li, layer in enumerate(plan.layers):
        x_in = dec(xc)
        if layer.conv is not None:
            xc = eops.conv_enc(layer.conv, xc, params.msg_space)
            report_exact(li, "conv", dec(xc), oracle(rp.conv_ptxt, layer.conv, x_in))
        if layer.sumpool is not None:
            x_in = dec(xc)
            xc = eops.sumpool_enc(layer.sumpool, xc)
            report_exact(li, "sumpool", dec(xc), oracle(rp.sumpool_ptxt, layer.sumpool, x_in))
        q = layer.quant
        x_in = dec(xc)
        if q.mode == Activation.SIGN:
            xc = eops.quant_sign_enc(q, xc, pbs, params)
            pre = x_in + q.bias
            report_boots(li, "sign", dec(xc), np.where(pre >= 0, 1, -1), pre)
        elif q.mode == Activation.NONE:
            xc = eops.quant_add_bias_enc(q, xc, params)
            report_exact(li, "add_bias", dec(xc), x_in + q.bias)
        else:
            xc = eops.quant_relu_enc(q, xc, pbs, params)
            report_boots(li, "relu", dec(xc), oracle(rp.quant_relu_ptxt, q, x_in), x_in)
        if layer.maxpool is not None:
            x_in = dec(xc)
            xc = eops.maxpool_enc(layer.maxpool, xc, pbs, params)
            want = oracle(rp.maxpool_ptxt, layer.maxpool, x_in)
            report_boots(li, "maxpool", dec(xc), want, np.ones_like(want))
    return reports


def format_reports(reports: List[StageReport]) -> str:
    """One line a stage, as the JAX package prints it; a leveled stage off
    the oracle also shows its ``max_abs_err``."""
    lines = []
    for r in reports:
        flag = ("exact" if r.exact
                else f"agree={r.agreement:.4f} worst_margin={r.max_mismatch_margin}")
        if not r.exact and r.stage in LEVELED:
            flag += f" max_err={r.max_abs_err}"
        lines.append(f"L{r.layer:<2} {r.stage:<9} {flag}")
    return "\n".join(lines)
