"""Rotation-stage candidates: negacyclic X^t rotation with per-batch t.

    python -m redsec_tpu_torch.scripts.bench_rotate [--device cpu] [--batch 512] [--iters 50]

The rotation of a [B, 2, N] accumulator by one exponent per batch row opens
every CMUX round of the blind rotation.  Candidates (every one is checked
equal to the first before any is timed; a mismatch or a failing candidate
raises):

  select11      11 binary-decomposed stages of where(concat-shift)
  select-r4     radix-4: 6 stages of 4-way select
  ext-circ      doubled-poly circular shifts (no per-stage negation)
  cuda-rows     the ``rotate_rows`` kernel, one block per batch row
  cuda-tile64   the ``rotate_tile`` kernel, a block per 64 rows with a row loop
  cuda-tile256  the same with 256 rows a block

The first three are plain PyTorch; the last three are the CUDA kernels of
``csrc/probes.cu`` (on ``--device cpu`` their wrappers run the plain twin,
and the line says so).  Times are per rotation over ``--iters`` chained
rotations (each feeds the next, the exponents move by one), CUDA events on
the card, the host clock on the CPU.
"""

from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from ..crypto import probe_kernels as pk
from ..device import resolve_device

N = 1024


def _log2_2n(x: torch.Tensor) -> int:
    return (2 * x.shape[-1]).bit_length() - 1


def _bit(t: torch.Tensor, k: int, width: int = 1) -> torch.Tensor:
    return ((t >> k) & ((1 << width) - 1)).reshape(-1, 1, 1)


def _shift(out: torch.Tensor, s: int) -> torch.Tensor:
    """X^s * out for a static s in [0, 2N]: concat-shift with negation."""
    n = out.shape[-1]
    if s >= n:
        return -_shift(out, s - n)
    if s == 0:
        return out
    return torch.cat([-out[..., n - s:], out[..., : n - s]], dim=-1)


def rot_select11(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    out = x
    for k in range(_log2_2n(x)):
        out = torch.where(_bit(t, k).bool(), _shift(out, 1 << k), out)
    return out


def rot_select_r4(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    out, bits = x, _log2_2n(x)
    for k in range(0, bits, 2):
        nbits = min(2, bits - k)
        d = _bit(t, k, nbits)
        cands = [_shift(out, c << k) for c in range(1 << nbits)]
        r = cands[-1]
        for c in range(len(cands) - 2, -1, -1):
            r = torch.where(d == c, cands[c], r)
        out = r
    return out


def rot_ext_circ(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    ext = torch.cat([x, -x], dim=-1)  # [B, 2, 2N]
    for k in range(_log2_2n(x)):
        s = 1 << k
        rx = torch.cat([ext[..., 2 * n - s:], ext[..., : 2 * n - s]], dim=-1)
        ext = torch.where(_bit(t, k).bool(), rx, ext)
    return ext[..., :n]


def candidates(batch: int):
    """(name, fn) of every candidate that takes this batch; the tiled kernel
    needs a batch that its tile divides."""
    out = [("select11", rot_select11), ("select-r4", rot_select_r4),
           ("ext-circ", rot_ext_circ), ("cuda-rows", pk.rotate_rows)]
    for tile in (64, 256):
        if batch % tile == 0:
            out.append((f"cuda-tile{tile}", functools.partial(pk.rotate_tile, tile=tile)))
        else:
            print(f"  cuda-tile{tile} not run: batch {batch} is not a multiple of {tile}")
    return out


def timed(name: str, body, x0: torch.Tensor, iters: int, work_macs=None) -> float:
    """ms per iteration of ``x = body(x, i)`` chained ``iters`` times (each
    output feeds the next input), after one warm-up chain: CUDA events on the
    card, the host clock on the CPU."""
    def chain():
        x = x0
        for i in range(iters):
            x = body(x, i)
        return x

    chain()
    if x0.is_cuda:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = chain()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        out = chain()
        ms = (time.perf_counter() - t0) * 1e3 / iters
    extra = f"  {work_macs / (ms * 1e-3) / 1e12:.2f} TMAC/s" if work_macs else ""
    print(f"{name:20s} {ms:9.4f} ms/iter{extra}  (chk {float(out.reshape(-1)[0])})",
          flush=True)
    return ms


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(-(2**30), 2**30, size=(args.batch, 2, N))
                        .astype(np.int32), device=dev)
    t = torch.as_tensor(rng.integers(0, 2 * N, size=(args.batch,)).astype(np.int32), device=dev)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else \
        "cpu (the cuda-* wrappers run their plain twin)"
    print(f"device={where}  B={args.batch} N={N} iters={args.iters}", flush=True)

    cands = candidates(args.batch)
    ref = cands[0][1](x, t)
    for name, fn in cands[1:]:
        if not torch.equal(fn(x, t), ref):
            raise AssertionError(f"{name} differs from {cands[0][0]}")
        print(f"  {name} correct: True")
    return {name: timed(name, lambda v, i, fn=fn: fn(v, (t + i) % (2 * N)), x, args.iters)
            for name, fn in cands}


if __name__ == "__main__":
    main()
