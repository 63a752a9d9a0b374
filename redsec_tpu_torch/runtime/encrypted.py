"""Encrypted execution engine: run a prepped model over LWE ciphertext tensors.

The cloud side of the reference's ``make cpu-encrypt`` flow
(nets/mnist/sign1024x1/net.cpp:117-131): evaluation key in, encrypted image
in, encrypted class scores out.  Layers run eagerly on the key's device;
every sign, relu and maxpool boundary is a batched PBS whose blind rotation
is the ``blind_rotate`` kernel on CUDA.

Ported here: sign, relu (1-PBS quarter-range and 3-PBS full-range FDFB) and
bias-only layers with conv/fc, sumpool and maxpool, the whole model in one
eager pass.  Where the JAX package reads ``REDSEC_INPUT_GAIN`` and
``REDSEC_RELU_MODE`` from the environment, the builders here take
``input_gain`` and ``relu_mode``.  Majority voting, escalation and the
per-layer / staged forwards of the JAX package are later work.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..crypto import lwe
from ..crypto.bootstrap import DeviceCloudKey, make_chunked_bootstrap
from ..models.spec import Activation, ModelPlan
from ..ops import encrypted as eops
from .ranges import resolve_pbs_ranges


def _resolve_info(model: ModelPlan, params, range_check: bool = True,
                  input_gain: bool = False, relu_mode: Optional[str] = None):
    """Per-layer PbsRange info: relu implementation ("quarter" 1-PBS |
    "full" 3-PBS FDFB), per-edge encoding gains, per-channel relu centering,
    and the loud range guard (runtime/ranges.py)."""
    return resolve_pbs_ranges(model, params.msg_space, strict=range_check,
                              input_gain=input_gain,
                              sigma_units=params.mod_switch_sigma_units(),
                              relu_mode=relu_mode)


def model_out_center(info):
    """Per-class decrypt-centering shift of the final layer, or None."""
    return getattr(info[max(info)], "center", None)


def model_out_gain(info) -> int:
    """Encoding gain carried by the final class scores."""
    return info[max(info)].out_gain


def model_in_gain(info) -> int:
    """Encoding gain expected on the model-input ciphertexts."""
    return info[0].in_gain if 0 in info else 1


def _run_layer_ops(layer, x, pbs_fn, params, r):
    """Conv/pool/quant/maxpool for one layer, with r: PbsRange gains."""
    if layer.conv is not None:
        x = eops.conv_enc(layer.conv, x, params.msg_space, r.in_gain)
    if layer.sumpool is not None:
        x = eops.sumpool_enc(layer.sumpool, x)
    q = layer.quant
    if q.mode == Activation.SIGN:
        # a maxpool-feeding sign outputs +-V so the window-OR margin dwarfs
        # the mod-switch noise (ops/encrypted.py:maxpool_sign_value)
        ov = (eops.maxpool_sign_value(layer.maxpool, params)
              if layer.maxpool is not None else r.out_gain)
        x = eops.quant_sign_enc(q, x, pbs_fn, params, ov, r.in_gain, r.tie_break)
    elif q.mode == Activation.NONE:
        x = eops.quant_add_bias_enc(q, x, params, r.in_gain, r.center)
    elif r.relu_mode == "quarter":
        x = eops.quant_relu_enc(q, x, pbs_fn, params, r.in_gain, r.out_gain, r.center)
    else:
        x = eops.quant_relu_fdfb_enc(q, x, pbs_fn, params, r.in_gain, r.out_gain, r.center)
    if layer.maxpool is not None:
        x = eops.maxpool_enc(layer.maxpool, x, pbs_fn, params, r.out_gain)
    return x


def build_forward_impl(model: ModelPlan, dkey: DeviceCloudKey, pbs_chunk: int = 512,
                       info=None) -> Callable:
    """Encrypted forward bound to a device key:
    ``forward(x [B, H, W, C, n+1]) -> [B, classes, n+1]`` (int32 tensors)."""
    params = dkey.params
    pbs_fn = make_chunked_bootstrap(dkey, chunk=pbs_chunk)
    if info is None:
        info = _resolve_info(model, params)

    def forward(x) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                            dtype=torch.int32, device=dkey.device)
        for i, layer in enumerate(model.layers):
            x = _run_layer_ops(layer, x, pbs_fn, params, info[i])
        return x.reshape(x.shape[0], -1, x.shape[-1])

    forward.out_gain = model_out_gain(info)
    forward.out_center = model_out_center(info)
    forward.in_gain = model_in_gain(info)
    return forward


def build_encrypted_forward(model: ModelPlan, dkey: DeviceCloudKey, pbs_chunk: int = 512,
                            range_check: bool = True, input_gain: bool = False,
                            relu_mode: Optional[str] = None) -> Callable:
    """Encrypted forward bound to a device key:
    int32 [B, H, W, C, n+1] -> [B, classes, n+1], on the key's device.

    ``range_check``: every PBS boundary's input bound (measured via
    runtime.ranges.calibrate_ranges when available, else certified interval
    arithmetic) must fit the message-space budget; violations raise here
    instead of silently wrapping like the reference (runtime/ranges.py).
    Relu layers pick the 1-PBS quarter-range or 3-PBS full-range (FDFB)
    implementation from the same bounds unless ``relu_mode`` ("quarter" |
    "full") forces one.

    ``input_gain``: also assign a model-input encoding gain; the client must
    then encrypt pixels scaled by ``forward.in_gain``
    (``encrypt_images(gain=...)``).  A calibration artifact records both
    options (runtime/calibration.py:options_from_meta)."""
    info = _resolve_info(model, dkey.params, range_check, input_gain, relu_mode)
    return build_forward_impl(model, dkey, pbs_chunk, info)


def encrypt_images(sk, images: np.ndarray, params, rng=None, gain: int = 1) -> np.ndarray:
    """Client-side: encrypt converted-pixel images [B, H, W, C] -> ciphertext
    tensor [B, H, W, C, n+1] (client/encrypt_image.cpp:73-80), numpy int32.

    ``gain``: model-input encoding gain (forward.in_gain)."""
    rng = rng or np.random.default_rng(0)
    images = np.asarray(images, np.int64) * int(gain)
    return lwe.encrypt_integers(sk.lwe_key, images, params, rng)


def decrypt_scores(sk, scores_ct, params, out_gain: int = 1, centers=None) -> np.ndarray:
    """Client-side: decrypt class-score ciphertexts [B, classes, n+1] ->
    signed integers (client/decrypt_image.cpp:46-63).

    ``out_gain``: the forward's encoding gain (forward.out_gain) — scores are
    rescaled back to reference logit units.  ``centers``: the forward's
    per-class decrypt-centering shift (forward.out_center)."""
    if isinstance(scores_ct, torch.Tensor):
        scores_ct = scores_ct.cpu().numpy()
    raw = lwe.decrypt_integers(sk.lwe_key, np.asarray(scores_ct), params)
    if out_gain != 1:
        raw = np.rint(raw / out_gain).astype(raw.dtype)
    if centers is not None:
        raw = raw - np.asarray(centers, raw.dtype)
    return raw
