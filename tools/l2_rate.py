"""How fast the card feeds K4's MAC with key rows from L2, measured alone.

    python tools/l2_rate.py [--rounds 700]        (from the repo's root)

``tools/l2_rate.cu``: K4's ring of key rows without its arithmetic
(``cp.async`` by every thread of the words it reads, as
``redsec_tpu_torch/csrc/pbs.cu`` does; one ``cp.async.bulk`` a row with
mbarriers; one multicast bulk copy a row for a cluster of two blocks; or
16-byte copies, each warp copying the words its threads read),
and a plain stream of 16-byte loads, one block of 512 threads on each SM,
as K4 runs.  Each walks ``--rounds`` rounds of 20 key rows (one
prime's slice of a ``small_v2`` round: 20 x 8 x N int16) at N = 1024 and
2048, from a source of 16 slices (5.2 or 10.5 MB, held in L2 after the
first pass) and from one of 700 slices (229 or 459 MB, from device memory).
Rates are bytes read a second by CUDA events after one warm-up launch.  No
path of the port runs this.  Prints one JSON line.
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

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "l2_rate.cu")
ROWS = 20
ENTRIES = ("redsec_l2_ring", "redsec_l2_stream")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=700, help="rounds of 20 rows a launch")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("l2_rate measures the card: no CUDA device")
    lib = Library(SOURCE, ENTRIES)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    out = {"card": card, "blocks": blocks, "rounds": args.rounds, "rows": ROWS}
    for N in (1024, 2048):
        slice_bytes = ROWS * 8 * N * 2
        for slices in (16, 700):
            src = torch.randint(-2**15, 2**15, (slices * slice_bytes // 2,), dtype=torch.int16,
                                device=dev)
            rounds = args.rounds if slices == 16 else min(args.rounds, 350)
            moved = blocks * rounds * slice_bytes
            for name, mode in (("async", 0), ("bulk", 1), ("multicast", 2), ("wide", 3)):
                ms = cuda_ms(lambda: lib.launch("redsec_l2_ring", f"l2_ring_{name}", dev.index,
                                                mode, N, blocks, src.data_ptr(), slices, ROWS,
                                                rounds, sink.data_ptr()), 3)
                key = f"ring_{name}_N{N}_slices{slices}_bytes_per_s"
                out[key] = moved / ms * 1e3
                # multicast: each row read from L2 once for the two blocks of a cluster
                l2 = "" if mode != 2 else f", {out[key] / 2:.4e} B/s read from L2"
                print(f"ring ({name}) N {N}, {slices} slices of {slice_bytes} B: {ms:.4f} ms, "
                      f"{out[key]:.4e} B/s into shared memory{l2} on {card}", flush=True)
            ms = cuda_ms(lambda: lib.launch("redsec_l2_stream", "l2_stream", dev.index, blocks,
                                            src.data_ptr(), slices, slice_bytes // 16, rounds,
                                            sink.data_ptr()), 3)
            key = f"stream_N{N}_slices{slices}_bytes_per_s"
            out[key] = moved / ms * 1e3
            print(f"stream (16-byte loads, every block reads every slice) N {N}, {slices} "
                  f"slices: {ms:.4f} ms, {out[key]:.4e} B/s on {card}", flush=True)
            del src
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
