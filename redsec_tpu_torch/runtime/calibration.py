"""Persisted calibration metadata — a public artifact next to var_prep.dat.

The reference's client flow is key+image only because its +-1 message
encodings are hardwired (lib/BinOps_enc.cpp:182-186; client flow
encrypt_image.cpp:76-77, decrypt_image.cpp:50-63).  This framework's
accuracy mechanism (encoding gains, relu/decrypt centering, parity
tie-breaks — runtime/ranges.py) instead derives PUBLIC metadata from a
calibration pass of the plaintext oracle over sample rows, disjoint from the
evaluated images, and persists it so that a fresh process reproduces the
IDENTICAL ``resolve_pbs_ranges`` assignment.

The artifact holds exactly the three per-layer fields
``runtime.ranges.calibrate_ranges`` stores on a ModelPlan
(``measured_pre_bound`` / ``measured_chan_interval`` / ``sign_calib``) plus
the options the saving run resolved under.  The format
(``redsec-tpu-calibration-v1``, an npz) is the JAX package's, which records
those options as ``REDSEC_*`` environment variables under ``meta["env"]``:
the port writes its explicit options under the same keys and reads them back
with ``options_from_meta``, so either package loads the other's files.  The
loaded plan's weights are fingerprinted so a stale artifact cannot silently
pair with different weights.

Everything in the artifact is derived from plaintext weights and plaintext
calibration data — nothing is secret-key material, matching the paper's
threat model (weights and network structure are the server's, only the
image is encrypted).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional

import numpy as np

from ..crypto.params import get_params
from ..models.spec import ModelPlan
from .ranges import CASCADE_W, MAX_FLIP, resolve_pbs_ranges

FORMAT = "redsec-tpu-calibration-v1"

# Recorded knobs the port implements only at the JAX package's default, each
# with the test "this recorded value is that default" (as the JAX package
# parses it): a file that records another value asks for behaviour the port
# does not have.
_DEFAULT_ONLY = {
    "REDSEC_GAIN_MODE": lambda v: v == "flip",
    "REDSEC_CASCADE_W": lambda v: float(v) == CASCADE_W,
    "REDSEC_MAX_FLIP": lambda v: float(v) == MAX_FLIP,
    "REDSEC_CENTER": lambda v: v != "0",
    "REDSEC_TIEBREAK": lambda v: v != "0",
}
# Recorded knobs of features the port does not implement at all.
_UNPORTED = ("REDSEC_MAJORITY", "REDSEC_MAJORITY_FROM", "REDSEC_MAJORITY_PLAN",
             "REDSEC_ESCALATE", "REDSEC_ESCALATE_PARAMS")


def weights_fingerprint(plan: ModelPlan) -> str:
    """sha256 over every layer's weight/bias material (hex, truncated).

    Binds a calibration artifact to the exact var_prep.dat it was derived
    from — loading it against different weights raises."""
    h = hashlib.sha256()
    for layer in plan.layers:
        if layer.conv is not None:
            h.update(np.ascontiguousarray(layer.conv.weights).tobytes())
        h.update(np.ascontiguousarray(layer.quant.bias).tobytes())
        if layer.quant.slope is not None:
            h.update(np.ascontiguousarray(layer.quant.slope).tobytes())
    return h.hexdigest()[:16]


def save_calibration(path: str, plan: ModelPlan, params_name: str, calib_rows: str = "",
                     extra: Optional[Dict] = None, input_gain: bool = False,
                     relu_mode: Optional[str] = None) -> Dict:
    """Write the calibration artifact for a plan that has been through
    ``calibrate_ranges``.  Returns the meta dict.

    ``params_name``: the parameter set the calibration targets (its
    mod-switch sigma drove the flip-optimal gains).  ``calib_rows``: free
    text describing the calibration rows (provenance for the eval-set
    disjointness claim).  ``input_gain`` / ``relu_mode``: the options the
    forward will be built with; recorded under ``meta["env"]`` as
    ``REDSEC_INPUT_GAIN`` / ``REDSEC_RELU_MODE``."""
    params = get_params(params_name)
    # resolve now (strict off: the artifact may deliberately record a
    # configuration whose guard verdict the runner re-judges) to persist the
    # client-facing summary: the input encoding gain the ENCRYPTOR must
    # apply, and the per-layer assignment for human inspection
    info = resolve_pbs_ranges(plan, params.msg_space, strict=False, input_gain=input_gain,
                              sigma_units=params.mod_switch_sigma_units(),
                              relu_mode=relu_mode)
    env = {}
    if input_gain:
        env["REDSEC_INPUT_GAIN"] = "1"
    if relu_mode is not None:
        env["REDSEC_RELU_MODE"] = relu_mode
    meta = {
        "format": FORMAT,
        "model": plan.spec.name,
        "n_layers": len(plan.layers),
        "weights_sha": weights_fingerprint(plan),
        "params": params_name,
        "calib_rows": calib_rows,
        "env": env,
        # resolved summary (client side reads in_gain; the rest is
        # documentation — the cloud re-resolves from the raw fields below)
        "in_gain": int(info[0].in_gain) if 0 in info else 1,
        "gains": {str(i): [int(r.in_gain), int(r.out_gain)] for i, r in info.items()},
        "relu_modes": {str(i): r.relu_mode for i, r in info.items() if r.relu_mode},
        "local_flip_rates": {str(i): float(r.local_flip_rate) for i, r in info.items()
                             if r.local_flip_rate is not None},
    }
    if extra:
        meta.update(extra)

    arrays = {"meta": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)}
    for i, layer in enumerate(plan.layers):
        if layer.measured_pre_bound is not None:
            arrays[f"L{i}_pre_bound"] = np.int64(layer.measured_pre_bound)
        if layer.measured_chan_interval is not None:
            lo, hi = layer.measured_chan_interval
            arrays[f"L{i}_chan_lo"] = np.asarray(lo, np.int64)
            arrays[f"L{i}_chan_hi"] = np.asarray(hi, np.int64)
        if layer.sign_calib is not None:
            sc = layer.sign_calib
            arrays[f"L{i}_mask"] = np.asarray(sc["mask"], bool)
            arrays[f"L{i}_hist"] = np.asarray(sc["hist"], np.int64)
            arrays[f"L{i}_hist_raw"] = np.asarray(sc["hist_raw"], np.int64)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)
    return meta


def load_calibration(path: str, plan: ModelPlan, check_weights: bool = True) -> Dict:
    """Restore a saved calibration onto ``plan`` (the inverse of
    ``calibrate_ranges`` + ``save_calibration``); returns the meta dict.

    After this, ``resolve_pbs_ranges`` / ``build_encrypted_forward`` on the
    plan reproduce the saving run's assignment exactly — provided they are
    given the recorded options (see ``options_from_meta``)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta.get("format") != FORMAT:
            raise ValueError(f"{path}: not a calibration artifact")
        if meta["model"] != plan.spec.name:
            raise ValueError(f"{path}: calibrated for model {meta['model']!r}, "
                             f"loading against {plan.spec.name!r}")
        if meta["n_layers"] != len(plan.layers):
            raise ValueError(f"{path}: {meta['n_layers']} layers calibrated, plan has "
                             f"{len(plan.layers)}")
        if check_weights:
            sha = weights_fingerprint(plan)
            if meta["weights_sha"] != sha:
                raise ValueError(
                    f"{path}: weights fingerprint mismatch ({meta['weights_sha']} "
                    f"calibrated vs {sha} loaded) — the artifact belongs to a different "
                    f"var_prep.dat")
        for i, layer in enumerate(plan.layers):
            if f"L{i}_pre_bound" in z:
                layer.measured_pre_bound = int(z[f"L{i}_pre_bound"])
            if f"L{i}_chan_lo" in z:
                layer.measured_chan_interval = (z[f"L{i}_chan_lo"], z[f"L{i}_chan_hi"])
            if f"L{i}_mask" in z:
                layer.sign_calib = {"mask": z[f"L{i}_mask"], "hist": z[f"L{i}_hist"],
                                    "hist_raw": z[f"L{i}_hist_raw"]}
    return meta


def options_from_meta(meta: Dict) -> Dict:
    """The explicit options that reproduce the artifact's recorded
    ``REDSEC_*`` knobs: ``{"input_gain": bool, "relu_mode": None | "quarter" |
    "full"}``, to be passed to ``build_encrypted_forward`` /
    ``resolve_pbs_ranges``.

    Raises ValueError on a recorded knob the port does not implement
    (majority voting, escalation) or implements only at its default (gain
    mode, cascade weight, flip guard, centering, tie-break): resolving such a
    file under other settings than it was saved with would silently give a
    different assignment."""
    env = meta.get("env", {})
    for k in _UNPORTED:
        if k in env:
            raise ValueError(f"calibration records {k}={env[k]!r}: majority voting and "
                             f"escalation are not ported yet")
    for k, is_default in _DEFAULT_ONLY.items():
        if k in env and not is_default(env[k]):
            raise ValueError(f"calibration records {k}={env[k]!r}: the port implements "
                             f"only the JAX package's default for it")
    mode = env.get("REDSEC_RELU_MODE", "")
    return {"input_gain": env.get("REDSEC_INPUT_GAIN", "0") == "1",
            "relu_mode": mode if mode in ("quarter", "full") else None}
