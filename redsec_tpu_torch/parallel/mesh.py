"""Multi-device execution on ``torch.distributed``: a dcn/dp/tp mesh of
ranks and sharded encrypted inference (the JAX package's ``parallel/mesh.py``).

One process a device.  The JAX package lays its devices out as a
``jax.sharding.Mesh`` with axes ("dcn", "dp", "tp") and runs one SPMD program;
here every rank runs the same eager code on its own shard and the collectives
are explicit:

- ``dp`` (and ``dcn``, the host axis, data-parallel too): the ciphertext batch
  is split into contiguous blocks over the dcn x dp positions.  Bootstraps are
  independent, so a rank runs the port's own forward on its block with no
  collective at all; the evaluation key is replicated (each rank prepares
  it).
- ``tp``: a layer's fan-in is split over the tp ranks of one dp position.
  Each contracts its channel shard, the partial LWE sums are combined with an
  int32 ``all_reduce`` (SUM; int32 wraps mod 2^32 in gloo and NCCL as the
  JAX package's ``psum`` does), and each rank then bootstraps its slice of
  the output channels.

Rank r sits at (dcn, dp, tp) = divmod-order of r, tp fastest, as the JAX
package reshapes its process-major device list.  The backend follows the
device, never a fallback: NCCL on CUDA, gloo on the CPU.  NCCL refuses two
ranks on one card, so on a machine with one card only world size 1 runs
there; the exchanges across ranks are held on the CPU with gloo.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(init_method: str, world_size: int, rank: int, device: str = "cuda",
                     backend: Optional[str] = None, timeout_s: float = 60.0) -> torch.device:
    """Join the process group: ``init_method`` (``tcp://localhost:<port>`` or
    ``file://<path>``), ``world_size`` and ``rank`` are the caller's, as
    nothing in the environment describes a cluster.  The backend follows the
    device (NCCL for ``cuda``, gloo for ``cpu``); a ``backend`` that disagrees
    with it raises.  Every collective times out after ``timeout_s``.  On CUDA
    the rank takes card ``rank % device_count``.  Returns the rank's device."""
    dev = resolve_device(device)
    want = BACKENDS[dev.type]
    if backend is not None and backend != want:
        raise ValueError(f"backend {backend!r} on {dev.type}: the port runs {want!r} there")
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(want, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a (dcn, dp, tp) mesh of ``torch.distributed``
    ranks and the process group of its tp row (the ranks that share its
    (dcn, dp) position)."""

    dcn: int
    dp: int
    tp: int
    rank: int
    tp_group: object
    device: torch.device

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp

    @property
    def batch_index(self) -> int:
        """Position on the flattened (dcn, dp) batch axis."""
        return self.rank // self.tp

    @property
    def batch_shards(self) -> int:
        return self.dcn * self.dp


def make_mesh(device: torch.device, tp: int = 1, dcn: int = 1) -> Mesh:
    """The (dcn, dp, tp) mesh over every rank of the initialised group:
    dp = world / (dcn * tp).  Every rank calls it (``new_group`` is
    collective), in the same order."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % (tp * dcn):
        raise ValueError(f"world size {world} does not divide into dcn={dcn} x tp={tp}")
    groups = [dist.new_group(list(range(b * tp, (b + 1) * tp))) for b in range(world // tp)]
    return Mesh(dcn=dcn, dp=world // (tp * dcn), tp=tp, rank=rank,
                tp_group=groups[rank // tp], device=torch.device(device))


def shard_ciphertext_batch(ct, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a ciphertext batch [B, ...] (the batch split over
    the dcn x dp positions, replicated over tp), on the mesh's device."""
    ct = torch.as_tensor(np.asarray(ct) if not isinstance(ct, torch.Tensor) else ct)
    B = ct.shape[0]
    if B % mesh.batch_shards:
        raise ValueError(f"batch {B} does not split over {mesh.batch_shards} dcn x dp shards")
    b = B // mesh.batch_shards
    return ct[mesh.batch_index * b:(mesh.batch_index + 1) * b].to(mesh.device)


def gather_ciphertext_batch(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole batch from every rank's block (the inverse of
    ``shard_ciphertext_batch``; one copy of each tp row)."""
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local.contiguous())
    return torch.cat(parts[::mesh.tp], dim=0)


def all_reduce_int32(x: torch.Tensor, group=None) -> torch.Tensor:
    """SUM of int32 partials over ``group``, wrapping mod 2^32 (the JAX
    package's ``psum`` on int32)."""
    if x.dtype != torch.int32:
        raise ValueError(f"expected int32 partials, got {x.dtype}")
    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def build_dp_encrypted_forward(model, dkey, mesh: Mesh, pbs_chunk: int = 512):
    """Data-parallel whole-model encrypted forward: ``forward(x_local)`` runs
    the port's own forward (``runtime.encrypted.build_forward_impl``, the
    blind-rotation kernel on CUDA) on this rank's batch block, with the key
    replicated.  No collective: every stage is batch-elementwise."""
    from ..runtime.encrypted import build_forward_impl

    if dkey.device != mesh.device:
        raise ValueError(f"key on {dkey.device}, mesh on {mesh.device}")
    return build_forward_impl(model, dkey, pbs_chunk)


def fc_sign_tp(x_local: torch.Tensor, weights: np.ndarray, bias: np.ndarray, dkey,
               mesh: Mesh) -> torch.Tensor:
    """Fan-in-sharded FC + sign layer, the tp building block.

    ``x_local``: [B/(dcn*dp), K/tp, n+1], this rank's batch block and fan-in
    shard; ``weights``: int [K, O] (the whole matrix: each rank takes its
    K/tp rows); ``bias`` [O].  Each rank contracts its shard, the partial sums
    are all-reduced over tp, and each rank bootstraps its O/tp output
    neurons.  Returns [B/(dcn*dp), O/tp, n+1]."""
    from ..crypto.bootstrap import const_test_vector, make_batched_bootstrap
    from ..crypto.torus import mod_switch_to_torus32
    from ..ops.encrypted import ternary_matmul_ct

    params = dkey.params
    tp, ti = mesh.tp, mesh.tp_index
    K, O = weights.shape
    if O % tp or K % tp:
        raise ValueError(f"fan-in {K} and outputs {O} must split over tp={tp}")
    kl, chunk = K // tp, O // tp
    part = ternary_matmul_ct(x_local[:, None], weights[ti * kl:(ti + 1) * kl])[:, 0]
    full = all_reduce_int32(part, mesh.tp_group)  # [B_l, O, n+1]
    mine = full[:, ti * chunk:(ti + 1) * chunk].clone()
    mu = mod_switch_to_torus32(np.asarray(bias, np.int64)[ti * chunk:(ti + 1) * chunk],
                               params.msg_space)
    mine[..., -1] += torch.as_tensor(mu.astype(np.int32), device=mine.device)
    tv = const_test_vector(params, 1, params.msg_space)
    out = make_batched_bootstrap(dkey)(mine.reshape(-1, mine.shape[-1]), tv)
    return out.reshape(mine.shape[0], chunk, -1)


# --------------------------------------------------------------------------- #
# Whole-model tensor-parallel forward                                         #
# --------------------------------------------------------------------------- #


def _shard(a: np.ndarray, sharded: bool, tp: int, ti: int, axis: int = 0) -> np.ndarray:
    """This rank's block of ``a`` along ``axis`` when ``sharded``, else all."""
    if not sharded:
        return a
    n = a.shape[axis] // tp
    return np.take(a, np.arange(ti * n, (ti + 1) * n), axis=axis)


def _plan_tp_layers(model, params, tp: int, ti: int, info=None):
    """Host-side prep for the tp forward: per layer, the layout and this
    rank's arrays.

    Activations stay channel-sharded [B_l, H, W, C/tp, n+1] between layers; a
    layer whose channel count does not divide tp stays replicated (every rank
    evaluates it: deterministic integer arithmetic keeps the copies
    identical).  Conv weights are arranged [wh, ww, H?, W?, C, O] so the
    CHANNEL axis is the sharded one even after an FC flatten (its order is
    (h, w, c), so a contiguous K shard would straddle channels).  ``info``:
    resolved PbsRanges (default: ``resolve_pbs_ranges`` as the single-device
    forward resolves them)."""
    from ..crypto.bootstrap import const_test_vector
    from ..crypto.torus import mod_switch_to_torus32
    from ..models.spec import Activation
    from ..ops.encrypted import maxpool_sign_value, relu_fdfb_test_vectors, relu_test_vectors
    from ..runtime.encrypted import _resolve_info

    if info is None:
        info = _resolve_info(model, params)
    msize = params.msg_space
    layers = []
    in_sharded = False  # input images are replicated over tp
    h, w, c = model.in_dim.h, model.in_dim.w, model.in_dim.in_dep
    for i, layer in enumerate(model.layers):
        L = {"layer": layer}
        if layer.conv is not None:
            cv = layer.conv
            wts = cv.weights  # [wh, ww, K, O]
            if cv.flatten:
                wts = wts.reshape(wts.shape[0], wts.shape[1], h, w, c, cv.out_dep)
            L["weights"] = _shard(wts, in_sharded, tp, ti, axis=wts.ndim - 2)
            h, w, c = cv.out_h, cv.out_w, cv.out_dep
        # the replicated -> sharded transition happens at the conv's own slice;
        # conv-less layers keep their input layout; bootstrap-free layers stay
        # replicated
        out_sharded = ((layer.conv is not None and c % tp == 0
                        and (layer.quant.mode != Activation.NONE or layer.maxpool is not None))
                       or (layer.conv is None and in_sharded))
        L["in_sharded"], L["out_sharded"] = in_sharded, out_sharded
        r = info[i]
        L["gains"] = (r.in_gain, r.out_gain)

        def mine(a):
            return _shard(np.asarray(a), out_sharded, tp, ti)

        if layer.conv is not None and layer.conv.neg_correction is not None:
            L["neg_mu"] = mine(mod_switch_to_torus32(
                layer.conv.neg_correction.astype(np.int64) * r.in_gain, msize))
        q = layer.quant
        if q.mode in (Activation.SIGN, Activation.NONE):
            L["bias_mu"] = mine(mod_switch_to_torus32(q.bias.astype(np.int64) * r.in_gain,
                                                      msize))
            if q.mode == Activation.SIGN:
                ov = (maxpool_sign_value(layer.maxpool, params)
                      if layer.maxpool is not None else r.out_gain)
                L["tv_sign"] = const_test_vector(params, ov, msize)
        else:
            if r.center is not None:
                L["center_mu"] = mine(mod_switch_to_torus32(
                    np.asarray(r.center, np.int64) * r.in_gain, msize))
            if r.relu_mode == "quarter":
                L["relu"] = "quarter"
                L["tvs"] = mine(relu_test_vectors(q, params, r.in_gain, r.out_gain, r.center))
            else:
                L["relu"] = "full"
                tv_o, tv_e, c_seam = relu_fdfb_test_vectors(q, params, r.in_gain, r.out_gain,
                                                            r.center)
                L["tv_o"], L["tv_e"], L["c_seam"] = mine(tv_o), mine(tv_e), mine(c_seam)
                L["tv_sign_fdfb"] = const_test_vector(params, msize // 4, msize)
        if layer.sumpool is not None:
            h, w = layer.sumpool.out_h, layer.sumpool.out_w
        if layer.maxpool is not None:
            h, w = layer.maxpool.out_h, layer.maxpool.out_w
        layers.append(L)
        in_sharded = out_sharded
    return layers, info


def build_tp_encrypted_forward(model, dkey, mesh: Mesh, pbs_chunk: int = 512, info=None):
    """Whole-model encrypted forward with fan-in tensor parallelism:
    ``forward(x_local [B_l, H, W, C, n+1])`` (this rank's batch block,
    replicated over tp) -> [B_l, classes, n+1], the same on every rank of a
    tp row.

    Every conv/FC contracts a channel shard of its fan-in on each rank,
    all-reduces the partial LWE sums over tp, and re-shards the bootstraps
    over output channels (each rank bootstraps C/tp of them) — the
    whole-model generalisation of ``fc_sign_tp``, sign, relu (quarter and
    FDFB) and maxpool as in the single-device forward.  Bit-identical to it:
    int32 sums mod 2^32 do not depend on their order."""
    from ..crypto.bootstrap import make_chunked_bootstrap
    from ..crypto.torus import mod_switch_to_torus32
    from ..models.spec import Activation
    from ..ops.encrypted import maxpool_sign_value, ternary_matmul_ct
    from ..runtime.encrypted import model_out_gain
    from ..runtime.ptxt import gather_patches

    params = dkey.params
    tp, ti = mesh.tp, mesh.tp_index
    msize = params.msg_space
    N = params.N
    pbs = make_chunked_bootstrap(dkey, chunk=pbs_chunk)
    layers, info = _plan_tp_layers(model, params, tp, ti, info)
    dev = dkey.device

    def t32(a):
        return torch.as_tensor(np.asarray(a).astype(np.int32), device=dev)

    def add_body(x, mu):
        x = x.clone()
        x[..., -1] += t32(mu)
        return x

    def conv_local(cv, x, wts):
        B, R = x.shape[0], x.shape[-1]
        if cv.flatten:
            wts = wts.reshape(1, 1, -1, wts.shape[-1])
            x = x.reshape(B, 1, 1, -1, R)
        out = None
        for fh in range(wts.shape[0]):
            for fw in range(wts.shape[1]):
                tap = gather_patches(x, (1, 1), cv.stride, (cv.offset[0] - fh, cv.offset[1] - fw),
                                     (cv.out_h, cv.out_w))
                part = ternary_matmul_ct(tap.reshape(B, cv.out_h * cv.out_w, -1, R), wts[fh, fw])
                out = part if out is None else out + part
        return out.reshape(B, cv.out_h, cv.out_w, wts.shape[-1], R)

    def per_channel(rows, m, C):
        """[C, ...] per-channel rows -> [m, ...], repeated over positions."""
        t = t32(rows)
        return t[None].expand(m // C, *t.shape).reshape(m, *t.shape[1:])

    def forward(x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.int32, device=dev)
        for L in layers:
            layer = L["layer"]
            if layer.conv is not None:
                part = conv_local(layer.conv, x, L["weights"])
                x = all_reduce_int32(part, mesh.tp_group) if L["in_sharded"] else part
                if L["out_sharded"]:  # keep this rank's output-channel slice
                    chunk = x.shape[3] // tp
                    x = x[:, :, :, ti * chunk:(ti + 1) * chunk]
                if "neg_mu" in L:
                    x = add_body(x, -np.asarray(L["neg_mu"], np.int64))
            if layer.sumpool is not None:
                sp = layer.sumpool
                x = gather_patches(x, sp.window, sp.stride, sp.offset,
                                   (sp.out_h, sp.out_w)).sum(dim=(3, 4), dtype=torch.int32)
            q = layer.quant
            shp = x.shape
            if q.mode == Activation.SIGN:
                x = add_body(x, L["bias_mu"])
                x = pbs(x.reshape(-1, shp[-1]), L["tv_sign"]).reshape(shp)
            elif q.mode == Activation.NONE:
                x = add_body(x, L["bias_mu"])
            else:
                if "center_mu" in L:
                    x = add_body(x, L["center_mu"])
                flat = x.reshape(-1, shp[-1])
                m, C = flat.shape[0], shp[3]
                if L["relu"] == "quarter":
                    flat = add_body(flat, mod_switch_to_torus32(msize // 4, msize))
                    x = pbs(flat, per_channel(L["tvs"], m, C)).reshape(shp)
                else:  # full-range FDFB relu
                    s = pbs(flat, L["tv_sign_fdfb"])
                    ct2 = add_body(flat - s, mod_switch_to_torus32(msize // 4, msize))
                    out = (pbs(flat, per_channel(L["tv_o"], m, C))
                           + pbs(ct2, per_channel(L["tv_e"], m, C)))
                    out[:, -1] += per_channel(L["c_seam"], m, C)
                    x = out.reshape(shp)
            if layer.maxpool is not None:
                mp = layer.maxpool
                V = maxpool_sign_value(mp, params)
                ssum = gather_patches(x, mp.window, mp.stride, mp.offset,
                                      (mp.out_h, mp.out_w)).sum(dim=(3, 4), dtype=torch.int32)
                ih = (np.arange(mp.out_h)[:, None] * mp.stride[0]
                      + np.arange(mp.window[0])[None, :] - mp.offset[0])
                iw = (np.arange(mp.out_w)[:, None] * mp.stride[1]
                      + np.arange(mp.window[1])[None, :] - mp.offset[1])
                cnt = (((ih >= 0) & (ih < mp.in_h)).sum(1)[:, None]
                       * ((iw >= 0) & (iw < mp.in_w)).sum(1)[None, :])
                ssum = add_body(ssum, mod_switch_to_torus32((cnt - 1) * V, msize)[None, :, :, None])
                tv1 = np.full(N, int(mod_switch_to_torus32(np.int64(L["gains"][1]), msize)),
                              np.int32)
                x = pbs(ssum.reshape(-1, ssum.shape[-1]), tv1).reshape(ssum.shape)
        return x.reshape(x.shape[0], -1, x.shape[-1])

    forward.tp_layout = [(L["in_sharded"], L["out_sharded"]) for L in layers]
    forward.out_gain = model_out_gain(info)
    return forward
