"""The int8 tensor-core instructions S1 can issue, measured alone on the card.

    python tools/mma_rate.py [--iters 4096]        (from the repo's root)

``tools/mma_rate.cu``: ``mma.sync`` m16n8k32 u8.s8 (Hopper's older
tensor-core path, which S1 first ran on) on 16 independent accumulators a
warp, 8 warps a block, and ``wgmma`` m64nNk32 u8.s8 (A from registers, B
from shared memory; what ``redsec_tpu_torch/csrc/schoolbook.cu`` issues) for
N 32, 64 and 128, two warpgroups a block, both over 132 x 4 blocks.  Rates
are int8 multiply-accumulates a second from CUDA events (one warm-up
launch); the H100's dense int8 peak is 989.5e12 of them (1,979 TOPS).  Then
how much other work (a chain of multiply-adds, or shared loads) a warpgroup
can put between issuing 8 wgmmas and waiting for them, with and without the
wgmmas: where the two times add up, the tensor cores wait for that work.
No path of the port runs this; the layout check of S1's ``wgmma`` is a test
(``tests/test_torch_cuda.py::test_wgmma_layouts_hold_on_the_card``).
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from redsec_tpu_torch.crypto.kernels import Library  # noqa: E402
from redsec_tpu_torch.device import cuda_ms  # noqa: E402

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mma_rate.cu")
PEAK_INT8_MACS = 1979e12 / 2
ENTRIES = ("redsec_mma_sync_rate", "redsec_wgmma_rate", "redsec_wgmma_overlap")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=4096, help="loop trips a launch")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mma_rate measures the card: no CUDA device")
    lib = Library(SOURCE, ENTRIES)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    out = {"card": card}
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    blocks = 4 * torch.cuda.get_device_properties(dev).multi_processor_count
    ms = cuda_ms(lambda: lib.launch("redsec_mma_sync_rate", "mma_sync_rate", dev.index, blocks,
                                    args.iters, sink.data_ptr()), 3)
    macs = blocks * 8 * args.iters * 16 * 16 * 8 * 32
    out["mma_sync_macs_per_s"] = macs / ms * 1e3
    print(f"mma.sync m16n8k32 u8.s8: {ms:.4f} ms, {macs / ms * 1e3:.4e} MAC/s, "
          f"{macs / ms * 1e3 / PEAK_INT8_MACS:.4f} of the dense int8 peak on {card}", flush=True)
    for n in (32, 64, 128):
        ms = cuda_ms(lambda: lib.launch("redsec_wgmma_rate", "wgmma_rate", dev.index, n, blocks,
                                        args.iters, sink.data_ptr()), 3)
        macs = blocks * 2 * args.iters * 4 * 64 * n * 32
        out[f"wgmma_n{n}_macs_per_s"] = macs / ms * 1e3
        print(f"wgmma m64n{n}k32 u8.s8 (A in registers): {ms:.4f} ms, {macs / ms * 1e3:.4e} "
              f"MAC/s, {macs / ms * 1e3 / PEAK_INT8_MACS:.4f} of the dense int8 peak on {card}",
              flush=True)
    # overlap: a trip is 8 wgmma m64n32k32 a warpgroup (256 tensor-core clocks
    # an SM for both warpgroups at the peak), then `work` units, then a wait
    trips = max(1, args.iters // 4)
    for kind, what in ((1, "dependent multiply-adds"), (2, "shared loads")):
        for work in (0, 16, 32, 64, 128):
            row = {}
            for mma in (1, 0):
                row[mma] = cuda_ms(lambda: lib.launch(
                    "redsec_wgmma_overlap", "wgmma_overlap", dev.index, kind, mma, work, blocks,
                    trips, sink.data_ptr()), 3) / trips * 1e6 / (blocks / (blocks // 4))
            out[f"overlap_kind{kind}_work{work}_ns_per_trip"] = row
            print(f"overlap, {work} {what} a trip: {row[1]:.2f} ns a trip with the wgmmas, "
                  f"{row[0]:.2f} without (per SM, {blocks // 4} SMs) on {card}", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
