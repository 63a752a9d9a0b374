"""Encrypted execution engine: run a prepped model over LWE ciphertext tensors.

The cloud side of the reference's ``make cpu-encrypt`` flow
(nets/mnist/sign1024x1/net.cpp:117-131): evaluation key in, encrypted image
in, encrypted class scores out.  Layers run eagerly on the key's device;
every sign, relu and maxpool boundary is a batched PBS whose blind rotation
is the ``blind_rotate`` kernel on CUDA.  A forward runs in a ``forward`` span
(``device.span``), each layer in ``L<i>``.

Ported here: sign, relu (1-PBS quarter-range and 3-PBS full-range FDFB) and
bias-only layers with conv/fc, sumpool and maxpool, the whole model in one
eager pass, majority-voted sign boundaries and per-layer escalation to a
second key.  Where the JAX package reads ``REDSEC_INPUT_GAIN``,
``REDSEC_RELU_MODE``, ``REDSEC_MAJORITY``, ``REDSEC_MAJORITY_FROM``,
``REDSEC_MAJORITY_PLAN``, ``REDSEC_ESCALATE`` and the calibration knobs
(``REDSEC_CENTER``, ``REDSEC_TIEBREAK``, ``REDSEC_GAIN_MODE``,
``REDSEC_CASCADE_W``, ``REDSEC_MAX_FLIP``) from the environment, the functions
here take ``input_gain``, ``relu_mode``, ``majority``, ``majority_from``,
``majority_plan``, ``escalate`` and ``center``, ``tiebreak``, ``gain_mode``,
``cascade_w``, ``max_flip``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..crypto import lwe
from ..crypto.bootstrap import DeviceCloudKey, make_chunked_bootstrap
from ..device import span, upload
from ..models.spec import Activation, ModelPlan
from ..ops import encrypted as eops
from ..utils.metrics import model_stats
from .ranges import CASCADE_W, MAX_FLIP, resolve_pbs_ranges


def _resolve_info(model: ModelPlan, params, range_check: bool = True,
                  input_gain: bool = False, relu_mode: Optional[str] = None,
                  majority_ks: Optional[Dict[int, int]] = None, escalate=None,
                  **knobs):
    """Per-layer PbsRange info: relu implementation ("quarter" 1-PBS |
    "full" 3-PBS FDFB), per-edge encoding gains, per-channel relu centering,
    and the loud range guard (runtime/ranges.py), which judges a voted or
    escalated boundary as it will run.  ``knobs``: the calibration knobs of
    ``resolve_pbs_ranges`` (``center``, ``tiebreak``, ``gain_mode``,
    ``cascade_w``, ``max_flip``)."""
    return resolve_pbs_ranges(model, params.msg_space, strict=range_check,
                              input_gain=input_gain,
                              sigma_units=params.mod_switch_sigma_units(),
                              relu_mode=relu_mode, majority_ks=majority_ks,
                              escalate=escalate, **knobs)


def parse_majority_plan(plan: Optional[str]) -> Dict[int, int]:
    """``"5:5,7:7"`` (the JAX package's ``REDSEC_MAJORITY_PLAN``) -> {layer
    index: k}."""
    out = {}
    for item in (plan or "").split(","):
        li, _, lk = item.partition(":")
        if li.strip():
            out[int(li)] = int(lk)
    return out


def majority_k_for_layer(i: int, majority: int = 1, majority_from: int = 0,
                         majority_plan: Optional[str] = None) -> int:
    """Vote count for layer i's sign-type boundaries (its sign activations
    and its maxpool ORs): ``majority`` (odd; 1 = no voting) from layer
    ``majority_from`` on, with ``majority_plan`` overriding it per layer
    index.  The cascade-aware shape: a large k on a small deep boundary that
    feeds a huge fan-in buys flip suppression at the cascade's source for a
    small share of the bootstraps, while the bulky early layers stay at the
    cheap k."""
    if majority > 1 and majority % 2 == 0:
        raise ValueError(f"majority must be odd (ties), got {majority}")
    kk = majority if i >= majority_from else 1
    kk = parse_majority_plan(majority_plan).get(i, kk)
    if kk > 1 and kk % 2 == 0:
        raise ValueError(f"majority k must be odd (ties), got {kk} @ layer {i}")
    return kk


def majority_ks(model: ModelPlan, majority: int = 1, majority_from: int = 0,
                majority_plan: Optional[str] = None) -> Dict[int, int]:
    """{layer index: vote count} for every layer of ``model``."""
    return {i: majority_k_for_layer(i, majority, majority_from, majority_plan)
            for i in range(len(model.layers))}


def model_out_center(info):
    """Per-class decrypt-centering shift of the final layer, or None."""
    return getattr(info[max(info)], "center", None)


def model_out_gain(info) -> int:
    """Encoding gain carried by the final class scores."""
    return info[max(info)].out_gain


def model_in_gain(info) -> int:
    """Encoding gain expected on the model-input ciphertexts."""
    return info[0].in_gain if 0 in info else 1


def _run_layer_ops(layer, x, pbs_fn, vote_fn, params, pp, r):
    """Conv/pool/quant/maxpool for one layer, with r: PbsRange gains.
    ``vote_fn`` runs the sign-type boundaries (sign activations, maxpool ORs;
    ``pbs_fn`` itself when they are not voted).  ``pp``: the parameter set of
    the key the layer's bootstraps run through (an escalated layer's test
    vectors are that key's); the leveled ops stay at ``params``."""
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
        x = eops.quant_sign_enc(q, x, vote_fn, pp, ov, r.in_gain, r.tie_break)
    elif q.mode == Activation.NONE:
        x = eops.quant_add_bias_enc(q, x, params, r.in_gain, r.center)
    elif r.relu_mode == "quarter":
        x = eops.quant_relu_enc(q, x, pbs_fn, pp, r.in_gain, r.out_gain, r.center)
    else:
        x = eops.quant_relu_fdfb_enc(q, x, pbs_fn, pp, r.in_gain, r.out_gain, r.center)
    if layer.maxpool is not None:
        x = eops.maxpool_enc(layer.maxpool, x, vote_fn, pp, r.out_gain)
    return x


def _check_escalation(dkey: DeviceCloudKey, escalate) -> None:
    if escalate is None:
        return
    layers, dkey2 = escalate
    if dkey2.params.msg_space != dkey.params.msg_space:
        raise ValueError("escalation keys must share the message space")
    if dkey2.params.n != dkey.params.n:
        raise ValueError("escalation keys must share the LWE dimension n (same-seed keygen "
                         "of the two sets draws the same client key)")
    if dkey2.device != dkey.device:
        raise ValueError(f"escalation key is on {dkey2.device}, the key on {dkey.device}")


def build_forward_impl(model: ModelPlan, dkey: DeviceCloudKey, pbs_chunk: int = 512,
                       info=None, ks: Optional[Dict[int, int]] = None,
                       escalate=None, round_kernel: Optional[str] = None) -> Callable:
    """Encrypted forward bound to a device key:
    ``forward(x [B, H, W, C, n+1]) -> [B, classes, n+1]`` (int32 tensors).

    ``ks``: {layer: vote count} of the majority-voted sign-type boundaries
    (``majority_ks``); voting draws its copies from the key's
    re-randomization pool.  ``escalate``: ``(layers, dkey2)`` runs every PBS
    boundary of those layers (sign, maxpool OR, relu quarter or FDFB)
    through the second key ``dkey2``, with its test vectors; same-seed keygen
    of both sets draws the same client LWE key, so ciphertexts pass between
    the two keys' bootstraps.  ``round_kernel``: every PBS's blind rotation
    one launch a round (``make_bootstrap_impl``), through both keys."""
    params = dkey.params
    pbs_fn = make_chunked_bootstrap(dkey, chunk=pbs_chunk, round_kernel=round_kernel)
    if info is None:
        info = _resolve_info(model, params)
    ks = ks or {}
    _check_escalation(dkey, escalate)
    esc_layers, pbs2, params2 = set(), None, None
    if escalate is not None:
        esc_layers, dkey2 = escalate
        pbs2 = make_chunked_bootstrap(dkey2, chunk=pbs_chunk, round_kernel=round_kernel)
        params2 = dkey2.params
    if max(ks.values(), default=1) > 1 and dkey.rerand is None:
        raise ValueError("majority voting needs a re-randomization pool on the cloud key "
                         "(keygen always emits CloudKey.rerand; re-generate keys saved "
                         "before it existed)")

    def layer_fns(i):
        """(PBS, sign-type PBS, parameter set of their key) of layer i."""
        pbs, pp = (pbs2, params2) if i in esc_layers else (pbs_fn, params)
        k = ks.get(i, 1)
        if k < 2:
            return pbs, pbs, pp

        def voted(ct, tv):
            return eops.majority_pbs(pbs, ct, tv, pp, k, dkey.rerand, salt=i)

        return pbs, voted, pp

    fns = [layer_fns(i) for i in range(len(model.layers))]
    names = [f"L{i}" for i in range(len(model.layers))]

    def forward(x) -> torch.Tensor:
        with span("forward", dkey.device):
            x = upload(np.asarray(x) if not isinstance(x, torch.Tensor) else x, dkey.device,
                       torch.int32)
            for i, layer in enumerate(model.layers):
                pbs, vote, pp = fns[i]
                with span(names[i]):
                    x = _run_layer_ops(layer, x, pbs, vote, params, pp, info[i])
            return x.reshape(x.shape[0], -1, x.shape[-1])

    forward.out_gain = model_out_gain(info)
    forward.out_center = model_out_center(info)
    forward.in_gain = model_in_gain(info)
    return forward


def _pbs_per_image(model: ModelPlan, info, ks: Optional[Dict[int, int]] = None) -> int:
    """Bootstraps one image costs under the resolved ``info``: one per sign,
    maxpool output and quarter-range relu activation, three per full-range
    (FDFB) relu activation, and k + 1 per sign activation or maxpool output of
    a layer voted at k (``ks``)."""
    total = 0
    for i, layer in enumerate(model.layers):
        k = (ks or {}).get(i, 1)
        vote = k + 1 if k > 1 else 1
        q = layer.quant
        n_act = q.h * q.w * q.depth
        if q.mode == Activation.SIGN:
            total += n_act * vote
        elif q.mode == Activation.RELU:
            total += n_act * (3 if info[i].relu_mode == "full" else 1)
        if layer.maxpool is not None:
            m = layer.maxpool
            total += m.out_h * m.out_w * m.depth * vote
    return total


# the JAX package's staged-forward slice: its jit="auto" rule stages a model
# whose biggest layer holds more bootstraps an image than this
JAX_PBS_MACRO = 16384


def jax_forward_mode(model: ModelPlan, escalated: bool = False) -> str:
    """The forward the JAX package's ``jit="auto"`` picks for ``model``:
    "staged" when the biggest layer holds more than ``JAX_PBS_MACRO``
    bootstraps an image or layers are escalated (its second key runs only
    in the staged forward), else "whole" (its ``jit=True``) below 8 layers
    and "layer" from 8 on."""
    biggest = max((st.bootstraps for st in model_stats(model)), default=0)
    if biggest > JAX_PBS_MACRO or escalated:
        return "staged"
    return "whole" if len(model.layers) < 8 else "layer"


def build_encrypted_forward(model: ModelPlan, dkey: DeviceCloudKey, pbs_chunk: int = 512,
                            range_check: bool = True, input_gain: bool = False,
                            relu_mode: Optional[str] = None, majority: int = 1,
                            majority_from: int = 0, majority_plan: Optional[str] = None,
                            escalate=None, center: bool = True, tiebreak: bool = True,
                            gain_mode: str = "flip", cascade_w: float = CASCADE_W,
                            max_flip: float = MAX_FLIP,
                            round_kernel: Optional[str] = None) -> Callable:
    """Encrypted forward bound to a device key:
    int32 [B, H, W, C, n+1] -> [B, classes, n+1], on the key's device.

    One eager forward serves every model.  The JAX package's whole-model,
    per-layer and staged forwards exist to bound its compiled programs; they
    give the same ciphertexts as this one.  ``forward.mode`` names the one
    its ``jit="auto"`` would pick (``jax_forward_mode``), for reports only.

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
    options (runtime/calibration.py:options_from_meta).

    ``majority``, ``majority_from``, ``majority_plan``: majority-voted
    sign-type boundaries (``majority_k_for_layer``; the JAX package's
    ``REDSEC_MAJORITY``, ``REDSEC_MAJORITY_FROM``, ``REDSEC_MAJORITY_PLAN``).
    ``escalate``: ``(layers, dkey2)`` routes those layers' PBS boundaries
    through a second key (the JAX package's ``REDSEC_ESCALATE`` with
    ``--eval2``; default second set ``small_v2_n2048``: the same n and
    message space at N = 2048, half the mod-switch sigma).  The range guard
    judges a voted boundary at its binomial tail and an escalated one at the
    second key's sigma.  ``center``, ``tiebreak``, ``gain_mode``,
    ``cascade_w`` and ``max_flip``: the calibration knobs of
    ``resolve_pbs_ranges`` (the JAX package's ``REDSEC_CENTER``,
    ``REDSEC_TIEBREAK``, ``REDSEC_GAIN_MODE``, ``REDSEC_CASCADE_W``,
    ``REDSEC_MAX_FLIP``).  The JAX package's per-program bootstrap ceiling
    (``REDSEC_MAX_PROGRAM_BOOTS``) and its escalated macro cap guard a TPU
    remote-compile backend and have no counterpart: a CUDA launch has no
    such ceiling.

    ``round_kernel`` (None, "full" or "partial"): the JAX package's
    ``REDSEC_ROUND_KERNEL`` (``=1``, ``=partial``), every blind rotation run
    one launch of a one-round kernel a round on a "matmul" key
    (``crypto.bootstrap.make_bootstrap_impl``); raises for a key, or with
    ``escalate`` a second key, outside its envelope."""
    ks = majority_ks(model, majority, majority_from, majority_plan)
    esc = None if escalate is None else (set(escalate[0]), escalate[1].params)
    info = _resolve_info(model, dkey.params, range_check, input_gain, relu_mode, ks, esc,
                         center=center, tiebreak=tiebreak, gain_mode=gain_mode,
                         cascade_w=cascade_w, max_flip=max_flip)
    forward = build_forward_impl(model, dkey, pbs_chunk, info, ks, escalate, round_kernel)
    forward.info = info
    forward.mode = jax_forward_mode(model, escalated=escalate is not None)
    forward.pbs_per_image = _pbs_per_image(model, info, ks)
    return forward


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
