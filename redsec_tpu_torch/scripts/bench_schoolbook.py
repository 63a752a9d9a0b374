"""Microbenchmarks for the schoolbook external product candidates.

    python -m redsec_tpu_torch.scripts.bench_schoolbook [--device cpu] [--batch 1024] [--iters 20]

The external product per blind-rotation round is
    delta[b, out, k] = sum_{row, j} digits[b, row, j] * b_ext[row, out, N+k-j]
(negacyclic schoolbook; out = 2 polys x 4 8-bit limbs).  Exact in int32; the
sums stay below rows*N * 4 * 128 = 10.5M < 2^24, so an fp32 accumulator holds
them too.

Candidates, each timed over ``--iters`` chained iterations (the output feeds
the next input; CUDA events on the card, the host clock on the CPU):

  mm-int8 / mm-bf16    raw matmul [B, rows*N] x [rows*N, 8N]
  gen-shear-int8       Toeplitz expansion of the round BK via shear-reshape
  round-int8 / -bf16   gen + matmul (the full per-round external product)
  conv-bf16            conv1d formulation (no materialization)
  rot-select           11-stage select-chain rotation
  rot-gather           one gather over the doubled poly
  rot-onehot           lane shift via gathered shift-matrix matmuls + block roll
  toeplitz-cuda        the ``toeplitz_tile`` kernel (csrc/probes.cu)

The matmul, conv and gather candidates are library calls (``torch._int_mm``,
``torch.matmul``, ``F.conv1d``, ``torch.gather``), as they are XLA ops in the
JAX package.  PyTorch's bf16 matmul and conv accumulate in fp32 but round
their OUTPUT to bf16, so the bf16 candidates measure the rate of that
formulation and are exact only for small sums; the int8 ones are exact.
Where the installation has no ``torch._int_mm`` for the device, the int8
candidates are skipped and the line says so.  Checks (a mismatch raises): the
shear-reshape expansion against sliding windows, the exact round against a
direct negacyclic product on a few rows, rot-gather against rot-select,
rot-onehot against rot-select on inputs bf16 holds exactly, and the Toeplitz
kernel against an index loop.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from ..crypto import probe_kernels as pk
from ..device import resolve_device
from .bench_rotate import rot_select11, timed

N = 1024
ROWS = 20
OUTS = 8


def has_int_mm(dev: torch.device) -> bool:
    """Whether ``torch._int_mm`` (int8 x int8 -> int32) runs on ``dev`` here."""
    if not hasattr(torch, "_int_mm"):
        return False
    a = torch.ones((32, 32), dtype=torch.int8, device=dev)
    try:
        torch._int_mm(a, a)
    except (RuntimeError, NotImplementedError):
        return False
    return True


def gen_toeplitz(be: torch.Tensor) -> torch.Tensor:
    """[rows, outs, 2N] -> [rows, outs, N(jrev), N(k)] by shear-reshape:
    window j' = be[1+j' : 1+j'+N] (row j' serves digit index N-1-j')."""
    r, o, two_n = be.shape
    n = two_n // 2
    flat = be[:, :, None, :].expand(r, o, n + 1, two_n).reshape(r, o, (n + 1) * two_n)
    w = flat[:, :, 1: 1 + n * (two_n + 1)]
    return w.reshape(r, o, n, two_n + 1)[:, :, :, :n]


def toeplitz_matrix(be: torch.Tensor) -> torch.Tensor:
    """The round's Toeplitz operand as a matmul right-hand side
    [rows*N, outs*N] (contracting rows and the window index)."""
    r, o, two_n = be.shape
    n = two_n // 2
    return gen_toeplitz(be).permute(0, 2, 1, 3).reshape(r * n, o * n)


def refill(o: torch.Tensor, width: int) -> torch.Tensor:
    """Tile the last dim of ``o`` up to ``width`` (feeds an output back as
    the next iteration's left-hand side)."""
    reps = -(-width // o.shape[-1])
    return o.repeat(*([1] * (o.ndim - 1)), reps)[..., :width]


def refill_rows(o: torch.Tensor, rows: int) -> torch.Tensor:
    """[B, outs, N] -> [B, rows, N] by tiling the middle dim."""
    return o.repeat(1, -(-rows // o.shape[1]), 1)[:, :rows, :]


def rot_gather(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """One ``torch.gather`` over the doubled polynomial [x, -x]."""
    n = x.shape[-1]
    ext = torch.cat([x, -x], dim=-1)  # [B, 2, 2N]
    k = torch.arange(n, device=x.device, dtype=torch.int64)
    idx = (k[None, :] - t[:, None].to(torch.int64)) % (2 * n)
    return torch.gather(ext, -1, idx[:, None, :].expand(x.shape))


def onehot_tables(dev: torch.device):
    """Shift matrices: A[r] moves lane c to c+r within a 128-lane block,
    B[r] carries the lanes that spill into the next block."""
    r = torch.arange(128)[:, None, None]
    c = torch.arange(128)[None, :, None]
    d = torch.arange(128)[None, None, :]
    a = ((c + r < 128) & (d == c + r)).to(torch.bfloat16)
    b = ((c + r >= 128) & (d == c + r - 128)).to(torch.bfloat16)
    return a.to(dev), b.to(dev)


def rot_onehot(x: torch.Tensor, t: torch.Tensor, tables) -> torch.Tensor:
    """Two-stage rotation on matmuls: lane shift by t mod 128 with gathered
    shift matrices, then a roll of the 128-lane blocks by t div 128 as a
    one-hot matmul.  Exact while bf16 holds the values (|x| <= 256)."""
    a_tab, b_tab = tables
    bsz, _, n = x.shape
    rq = n // 128
    r, q = t % 128, t // 128
    ext = torch.cat([x, -x], dim=-1).reshape(bsz, 2, 2 * rq, 128)
    xb = ext.reshape(bsz, 4 * rq, 128).to(torch.bfloat16)
    lo = torch.bmm(xb, a_tab[r.long()])
    xprev = torch.roll(ext, 1, dims=2).reshape(bsz, 4 * rq, 128).to(torch.bfloat16)
    hi = torch.bmm(xprev, b_tab[r.long()])
    s1 = (lo.float() + hi.float()).to(torch.int32).reshape(bsz, 2, 2 * rq, 128)
    blk = (torch.arange(rq, device=x.device)[None, :] - q[:, None]) % (2 * rq)  # [B, RQ]
    qoh = F.one_hot(blk.long(), 2 * rq).to(torch.bfloat16)  # [B, RQ, 2RQ]
    s1f = s1.permute(0, 2, 1, 3).reshape(bsz, 2 * rq, 2 * 128).to(torch.bfloat16)
    o = torch.bmm(qoh, s1f).float().to(torch.int32)
    return o.reshape(bsz, rq, 2, 128).permute(0, 2, 1, 3).reshape(bsz, 2, n)


def negacyclic_direct(dig: torch.Tensor, be: torch.Tensor) -> torch.Tensor:
    """delta[b, out, k] = sum_{row, j} dig[b, row, j] * be[row, out, N + k - j]
    by index arithmetic, summed in fp64 (exact: the sums stay below 2^24;
    CUDA has no int64 matmul) and returned as int64."""
    n = dig.shape[-1]
    k = torch.arange(n, device=dig.device)[None, :]
    j = torch.arange(n, device=dig.device)[:, None]
    m = be.double()[:, :, n + k - j]  # [rows, outs, j, k]
    return torch.einsum("brj,rojk->bok", dig.double(), m).long()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    B, iters = args.batch, args.iters
    K, M = ROWS * N, OUTS * N
    rng = np.random.default_rng(0)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={where}  B={B} N={N} rows={ROWS} iters={iters}", flush=True)
    times = {}

    def ints(lo, hi, shape, dtype):
        return torch.as_tensor(rng.integers(lo, hi, size=shape), device=dev).to(dtype)

    int_mm = has_int_mm(dev)
    if not int_mm:
        print(f"mm-int8, round-int8 skipped: torch._int_mm is not available on {dev.type} "
              f"in torch {torch.__version__}", flush=True)

    # ---------------- raw matmuls ----------------
    lhs8 = ints(-4, 5, (B, K), torch.int8)
    rhs8 = ints(-128, 128, (K, M), torch.int8)
    macs = B * K * M
    if int_mm:
        times["mm-int8"] = timed(
            "mm-int8", lambda x, i: (refill(torch._int_mm(x, rhs8), K) & 7).to(torch.int8) - 4,
            lhs8, iters, macs)
    rhsb = rhs8.to(torch.bfloat16)
    times["mm-bf16"] = timed(
        "mm-bf16", lambda x, i: ((refill(torch.matmul(x, rhsb).to(torch.int32), K) & 7) - 4)
        .to(torch.bfloat16), lhs8.to(torch.bfloat16), iters, macs)
    del rhs8, rhsb

    # ---------------- Toeplitz generation (shear-reshape) ----------------
    bext = ints(-128, 128, (ROWS, OUTS, 2 * N), torch.int8)
    windows = bext.unfold(-1, N, 1)[:, :, 1: N + 1, :]
    if not torch.equal(gen_toeplitz(bext), windows):
        raise AssertionError("gen_toeplitz differs from the sliding windows")
    print("gen_toeplitz == sliding windows: True")

    def gen_only(x, i):
        m = toeplitz_matrix(bext + x.reshape(()))
        return x + m[0, 0]

    times["gen-shear-int8"] = timed("gen-shear-int8", gen_only,
                                    torch.zeros((1, 1, 1), dtype=torch.int8, device=dev), iters)

    # ---------------- full round: gen + contraction ----------------
    dig8 = ints(-4, 5, (B, ROWS, N), torch.int8)
    if int_mm:
        def round_int8(x, i):
            o = torch._int_mm(x.reshape(B, K), toeplitz_matrix(bext)).reshape(B, OUTS, N)
            return (refill_rows(o, ROWS) & 7).to(torch.int8) - 4

        few = min(B, 2)
        got = torch._int_mm(dig8.reshape(B, K), toeplitz_matrix(bext)).reshape(B, OUTS, N)[:few]
        # window j' serves digit index N-1-j': the matmul sees the digits reversed
        if not torch.equal(got.long(), negacyclic_direct(dig8[:few].flip(-1), bext)):
            raise AssertionError("round-int8 differs from the direct negacyclic product")
        print("round-int8 == direct negacyclic product: True")
        times["round-int8"] = timed("round-int8", round_int8, dig8, iters, macs)
    bextb = bext.to(torch.bfloat16)

    def round_bf16(x, i):
        o = torch.matmul(x.reshape(B, K), toeplitz_matrix(bextb)).reshape(B, OUTS, N)
        return ((refill_rows(o.to(torch.int32), ROWS) & 7) - 4).to(torch.bfloat16)

    times["round-bf16"] = timed("round-bf16", round_bf16, dig8.to(torch.bfloat16), iters, macs)

    # ---------------- conv formulation ----------------
    # input [B, rows, 2N] = [-d, d]; kernel [outs, rows, N]; valid corr -> [B, outs, N+1]
    ker = ints(-128, 128, (OUTS, ROWS, N), torch.int8).to(torch.bfloat16).flip(-1).contiguous()

    def conv_bf16(x, i):
        o = F.conv1d(torch.cat([-x, x], dim=-1), ker)[:, :, :N]
        return ((refill_rows(o.to(torch.int32), ROWS) & 7) - 4).to(torch.bfloat16)

    times["conv-bf16"] = timed("conv-bf16", conv_bf16, dig8.to(torch.bfloat16), iters,
                               B * ROWS * OUTS * N * N)
    del bext, bextb, dig8, ker

    # ---------------- rotation candidates ----------------
    acc = ints(-(2**30), 2**30, (B, 2, N), torch.int32)
    t = ints(0, 2 * N, (B,), torch.int32)
    tables = onehot_tables(dev)
    ref = rot_select11(acc, t)
    if not torch.equal(rot_gather(acc, t), ref):
        raise AssertionError("rot-gather differs from rot-select")
    print("rot gather == select: True")
    small = ints(-256, 257, (B, 2, N), torch.int32)
    if not torch.equal(rot_onehot(small, t, tables), rot_select11(small, t)):
        raise AssertionError("rot-onehot differs from rot-select on bf16-exact inputs")
    print("rot onehot == select (|x| <= 256, exact in bf16): True")
    times["rot-select"] = timed("rot-select", lambda x, i: rot_select11(x, (t + i) % (2 * N)),
                                acc, iters)
    times["rot-gather"] = timed("rot-gather", lambda x, i: rot_gather(x, (t + i) % (2 * N)),
                                acc, iters)
    times["rot-onehot"] = timed(
        "rot-onehot", lambda x, i: rot_onehot(x, (t + i) % (2 * N), tables), acc, iters)

    # ---------------- Toeplitz tile kernel ----------------
    w = ints(-100, 100, (1, 256), torch.int32)
    got = pk.toeplitz_tile(w).cpu().numpy()
    wnp = w.cpu().numpy()[0]
    want = np.empty((128, 128), np.int32)
    for j in range(128):
        for k in range(128):
            want[j, k] = wnp[(127 + k - j) % 256]
    if not np.array_equal(got, want):
        raise AssertionError("toeplitz_tile differs from the index loop")
    note = "" if dev.type == "cuda" else " (cpu: the wrapper runs its plain twin)"
    print(f"toeplitz_tile correct: True{note}")
    # chained: the tile's first two rows are the next doubled row
    times["toeplitz-cuda"] = timed(
        "toeplitz-cuda", lambda x, i: pk.toeplitz_tile(x)[:2].reshape(1, 256), w, iters)
    return times


if __name__ == "__main__":
    main()
