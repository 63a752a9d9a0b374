"""Jobs the multi-process tests of ``redsec_tpu_torch.parallel`` run in each
rank of a spawned gloo group (tests/test_torch_parallel.py).

This module imports torch and the port only, so that a spawned rank starts
without JAX.  ``run_group`` starts ``world`` ranks, each of which joins the
group through a file store, runs every job in order (the collectives of each
job in the same order on every rank) and writes its results to
``<out_dir>/rank<r>.npz`` under ``<job name>/<key>``."""

from __future__ import annotations

import multiprocessing
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from redsec_tpu_torch.crypto import bootstrap as bs
from redsec_tpu_torch.crypto import ntt
from redsec_tpu_torch.crypto import ntt_matmul as mm
from redsec_tpu_torch.parallel import mesh as pm
from redsec_tpu_torch.parallel import ntt_shard as ns

JOIN_TIMEOUT_S = 150.0


def _gather_tp(t: torch.Tensor, mesh: pm.Mesh, dim: int) -> torch.Tensor:
    """The blocks of a tp row concatenated along ``dim`` in tp order."""
    parts = [torch.empty_like(t) for _ in range(mesh.tp)]
    dist.all_gather(parts, t.contiguous(), group=mesh.tp_group)
    return torch.cat(parts, dim=dim)


def _mesh(job, dev) -> pm.Mesh:
    return pm.make_mesh(dev, tp=job.get("tp", 1), dcn=job.get("dcn", 1))


def _dp_forward(job, dev):
    m = _mesh(job, dev)
    dkey = bs.prepare_cloud_key(job["cloud"], device=dev.type)
    fwd = pm.build_dp_encrypted_forward(job["plan"], dkey, m)
    out = fwd(pm.shard_ciphertext_batch(job["ct"], m))
    return {"out": pm.gather_ciphertext_batch(out, m)}


def _tp_forward(job, dev):
    m = _mesh(job, dev)
    dkey = bs.prepare_cloud_key(job["cloud"], device=dev.type)
    fwd = pm.build_tp_encrypted_forward(job["plan"], dkey, m)
    out = fwd(pm.shard_ciphertext_batch(job["ct"], m))
    return {"out": pm.gather_ciphertext_batch(out, m),
            "layout": np.array(fwd.tp_layout, dtype=bool), "out_gain": np.int64(fwd.out_gain)}


def _fc_sign_tp(job, dev):
    m = _mesh(job, dev)
    dkey = bs.prepare_cloud_key(job["cloud"], device=dev.type)
    x = pm.shard_ciphertext_batch(job["ct"], m)
    kl = x.shape[1] // m.tp
    out = pm.fc_sign_tp(x[:, m.tp_index * kl:(m.tp_index + 1) * kl], job["weights"],
                        job["bias"], dkey, m)  # [B_l, O/tp, n+1]
    return {"out": pm.gather_ciphertext_batch(_gather_tp(out, m, 1), m)}


def _ntt_shard(job, dev):
    m = _mesh(job, dev)
    plan = ntt.make_plan(job["N"], max_operand=4, limb_bits=8, accum=10)
    R, C = mm._split_rc(job["N"])
    sp, ti = m.tp, m.tp_index
    out = {}
    for pi in job["primes"]:
        fwd, inv = ns.make_ntt_poly_sharded(plan, pi, m)
        x = torch.as_tensor(job["x"][pi]).reshape(-1, R, C)
        y = _gather_tp(fwd(x[..., ti * (C // sp):(ti + 1) * (C // sp)]), m, 1)
        nl = job["N"] // sp
        back = _gather_tp(inv(y[:, ti * nl:(ti + 1) * nl]), m, 2)
        out[f"fwd{pi}"], out[f"inv{pi}"] = y, back.reshape(y.shape)
    return out


def _poly_pbs(job, dev):
    m = _mesh(job, dev)
    dkey = bs.prepare_cloud_key(job["cloud"], device=dev.type, ntt_flavor="matmul")
    fn = ns.make_poly_sharded_bootstrap(dkey, m)
    out = fn(pm.shard_ciphertext_batch(job["ct"], m), job["tv"])
    return {"out": pm.gather_ciphertext_batch(out, m),
            "bk_shard": np.array(fn.sharded_key.bk.shape),
            "ksk_shard": np.array(fn.sharded_key.ksk.shape),
            "bk_full": np.array(dkey.bk.shape), "ksk_full": np.array(dkey.ksk.shape)}


def _all_reduce(job, dev):
    m = _mesh(job, dev)
    t = torch.as_tensor(job["partials"][dist.get_rank()]).to(dev)
    return {"world": pm.all_reduce_int32(t.clone()), "tp": pm.all_reduce_int32(t, m.tp_group)}


JOBS = {"dp_forward": _dp_forward, "tp_forward": _tp_forward, "fc_sign_tp": _fc_sign_tp,
        "ntt_shard": _ntt_shard, "poly_pbs": _poly_pbs, "all_reduce": _all_reduce}


def run_rank(rank: int, world: int, init_file: str, jobs: list, out_dir: str) -> None:
    torch.set_num_threads(1)
    try:
        dev = pm.init_distributed(f"file://{init_file}", world, rank, device="cpu")
        res = {}
        for job in jobs:
            for k, v in JOBS[job["kind"]](job, dev).items():
                res[f"{job['name']}/{k}"] = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def start_group(world: int, jobs: list, work_dir: str) -> list:
    """Start ``world`` spawned ranks running ``jobs``; returns the processes."""
    os.makedirs(work_dir, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    init_file = os.path.join(work_dir, "store")
    procs = [ctx.Process(target=run_rank, args=(r, world, init_file, jobs, work_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def finish_group(procs: list, work_dir: str) -> list:
    """Join the ranks (each within the time limit; stragglers are killed) and
    load their results; raises with the ranks' tracebacks if any failed."""
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = [open(os.path.join(work_dir, f)).read() for f in sorted(os.listdir(work_dir))
              if f.endswith(".err")]
    codes = [p.exitcode for p in procs]
    if errors or any(c != 0 for c in codes):
        raise RuntimeError(f"ranks exited {codes}:\n" + "\n".join(errors))
    out = []
    for r in range(len(procs)):
        with np.load(os.path.join(work_dir, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out
