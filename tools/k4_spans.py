"""Where a block of K4 spends its time, phase by phase, on the card.

    python tools/k4_spans.py [--root DIR] [--tag NAME] [--sets small_v2_tpu,small_v2_n2048,small_v2_n2048/2]

Copies ``DIR/redsec_tpu_torch`` (default: this checkout's) into
``build/spans/<tag>/`` (gitignored) and inserts a span probe into the copy's
``csrc/pbs.cu``; the shipped package has no such knob.  In every eighth
block, thread 0 reads ``%globaltimer`` and ``clock64()`` at each phase
boundary of ``blind_rotate_kernel`` and adds the span since the last one to
a device buffer by phase:

    tables    the launch's start (accumulators loaded, stage tables staged)
              and, in a build that stages one prime's tables again for
              every prime, every staging
    diff      the differences of a round (X^t acc - acc)
    fwd0      the forward transforms of a prime's first chunk of digit rows,
              to the barrier after them
    fwdN      those of its later chunks
    first     the wait for a chunk's first key row
    mac       the rest of the MAC, to the barrier that ends the chunk
    inverse   the MAC sums' store and the inverse transforms
    crt       the CRT, the accumulator update and the round's last barrier

A phase's span includes the barrier that ends it.  The probe is switched on
by a device flag, so the same build is timed with it off (CUDA events, 3
launches) and then run once with it on.  Each set (``name`` or ``name/2``
for a bundled key) runs at batch 512 on seed-0 keys.  Prints, per set, the
share of block time of each phase, its ms a launch (the share times the
probe-off time) and how often it ran a block, then one JSON line.  The
anchors the probe is inserted at are statements of ``pbs.cu``; the tool
stops if one is missing.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("tables", "diff", "fwd0", "fwdN", "first", "mac", "inverse", "crt")
EVERY = 8  # one block in EVERY is probed

PROBE = r"""
// ---- span probe (tools/k4_spans.py) ----
__device__ unsigned long long g_spans[3][8];  // globaltimer ns, clock64 cycles, count
__device__ int g_spans_on;
__device__ __forceinline__ unsigned long long spans_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
struct SpanProbe {
  unsigned long long g = 0, c = 0;
  bool on;
  __device__ SpanProbe() : on(threadIdx.x == 0 && blockIdx.x % EVERY_ == 0 && g_spans_on) {
    if (on) { g = spans_gtime(); c = clock64(); }
  }
  __device__ __forceinline__ void mark(int k) {
    if (on) {
      const unsigned long long g2 = spans_gtime(), c2 = clock64();
      atomicAdd(&g_spans[0][k], g2 - g);
      atomicAdd(&g_spans[1][k], c2 - c);
      atomicAdd(&g_spans[2][k], 1ull);
      g = g2;
      c = c2;
    }
  }
};
""".replace("EVERY_", str(EVERY))

ENTRY = r"""
extern "C" int redsec_spans(unsigned long long* out, int on) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (out) e = cudaMemcpyFromSymbol(out, g_spans, sizeof(g_spans));
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned long long zero[3][8] = {};
  e = cudaMemcpyToSymbol(g_spans, zero, sizeof(zero));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaMemcpyToSymbol(g_spans_on, &on, sizeof(on)));
}
"""

# (pattern, replacement) applied once each to pbs.cu; \g<0> keeps the match.
# External_product_block takes a SpanProbe* (null from K2 and K3).
PATCHES = [
    (r"// Geometry of one transform and of a block", PROBE + r"\n\g<0>"),
    (r"(const Smem<N, G, P, D>& sm, uint32_t \(&delta\)\[G\]\[2\]\[Geo<N>::E\])\)",
     r"\1, SpanProbe* prb_ = nullptr)"),
    # the stagings of one prime's tables inside the prime loop (absent where
    # only the launch stages them)
    (r"stage_tables<N>\(sm\.stage, tabs, pi, 1\);",
     r"{\n      \g<0>\n      if (prb_) prb_->mark(0);\n    }"),
    (r"(\n\s*)// MAC over the chunk's rows", r"\1if (prb_) prb_->mark(c0 == 0 ? 2 : 3);\g<0>"),
    ((r"(cp_async_wait_upto<RING>\(cn - 1 - j\);\n)(\s*if \(pending == lazy\) \{)",
      r"(cp_async_wait<0>\(\);\n(?:.*__syncwarp.*\n)?)(\s*if \(pending == lazy\) \{)"),
     r"\1      if (prb_ && j == 0) prb_->mark(4);\n\2"),
    (r"__syncthreads\(\);  // the chunk's digit rows and the ring are free again",
     r"\g<0>\n      if (prb_) prb_->mark(5);"),
    (r"(\n    __syncthreads\(\);\n)(  \}\n  // CRT and the recombination)",
     r"\1    if (prb_) prb_->mark(6);\n\2"),
    (r"const S sm\(reinterpret_cast<unsigned char\*>\(smem_raw\), cr\);",
     r"\g<0>\n  SpanProbe pr_;"),
    (r"\n  const GadgetDigits<N, D> dig\{sm\.diff, g\};", r"\n  pr_.mark(0);\g<0>"),
    (r"(rotate_diff<N, G, P>\(sm, tt, g\.offset\);)", r"\1 pr_.mark(1);"),
    (r"(rotate_diff3<N, G, P>\(sm, ti, tj, g\.offset\);)", r"\1 pr_.mark(1);"),
    (r"(bk \+ j \* round_stride, prime_stride, tabs,\s*crt, sm, delta)\)", r"\1, &pr_)"),
    (r"(\n    __syncthreads\(\);\n)(  \}\n#pragma unroll\n  for \(int c = 0; c < G; \+\+c\)\n"
     r"    if \(first \+ c < B\))", r"\1    pr_.mark(7);\n\2"),
]
OPTIONAL = {2}  # the staging inside the prime loop: gone where only the launch stages


def patch(src: str) -> str:
    for i, (pats, rep) in enumerate(PATCHES):
        n = 0
        for pat in (pats,) if isinstance(pats, str) else pats:
            src, n = re.subn(pat, rep, src, count=1)
            if n:
                break
        if n != 1 and i not in OPTIONAL:
            raise SystemExit(f"k4_spans: anchor {i} ({pats!r:.60}) not found in pbs.cu")
    return src + ENTRY


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout whose redsec_tpu_torch is probed")
    ap.add_argument("--tag", default="change", help="name of this checkout in the output")
    ap.add_argument("--sets", default="small_v2_tpu,small_v2_n2048,small_v2_n2048/2",
                    help="comma-separated parameter sets (name, or name/2 for a bundled key)")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--build-only", action="store_true",
                    help="patch and build the copy, measure nothing (a later run reuses the build)")
    args = ap.parse_args(argv)
    dest = os.path.join(REPO, "build", "spans", args.tag)
    pkg = os.path.join(dest, "redsec_tpu_torch")
    root_pkg = os.path.join(os.path.abspath(args.root), "redsec_tpu_torch")
    with open(os.path.join(root_pkg, "csrc", "pbs.cu")) as f:
        want = patch(f.read())
    cu = os.path.join(pkg, "csrc", "pbs.cu")
    if not os.path.exists(cu) or open(cu).read() != want:  # else keep the copy and its build
        shutil.rmtree(dest, ignore_errors=True)
        shutil.copytree(root_pkg, pkg, ignore=shutil.ignore_patterns("__pycache__"))
        with open(cu, "w") as f:
            f.write(want)
    sys.path.insert(0, dest)

    import numpy as np
    import torch

    from redsec_tpu_torch.crypto import bootstrap as bs
    from redsec_tpu_torch.crypto import kernels as K
    from redsec_tpu_torch.crypto import keygen as kg
    from redsec_tpu_torch.crypto.params import get_params
    from redsec_tpu_torch.device import cuda_ms

    if not torch.cuda.is_available():
        raise SystemExit("k4_spans measures the card: no CUDA device")
    assert os.path.abspath(K.SOURCE) == os.path.abspath(cu), K.SOURCE
    if args.build_only:
        print(K.build_library(K.SOURCE), flush=True)
        return {}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    K._lib()  # builds and loads the probed library
    lib = ctypes.CDLL(K.library_path(K.SOURCE))  # the same loaded file: its probe entry
    lib.redsec_spans.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.redsec_spans.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 24)()

    def spans(on: int, read: bool) -> list:
        code = lib.redsec_spans(buf if read else None, on)
        if code:
            raise SystemExit(f"k4_spans: CUDA error {code}")
        return list(buf)

    dev = torch.device("cuda", 0)
    gen = np.random.default_rng(7)
    out = {"tag": args.tag, "card": card, "batch": args.batch, "every": EVERY}
    print(f"{args.tag}: {card}", flush=True)
    for item in filter(None, args.sets.split(",")):
        name, _, b = item.partition("/")
        bundle = int(b or 1)
        P = get_params(name)
        _, cloud = kg.keygen(P, seed=0, bundle=bundle)
        dk = bs.prepare_cloud_key(cloud, device="cuda")
        B = args.batch
        acc0 = torch.as_tensor(gen.integers(-2**31, 2**31, (B, 2, P.N)).astype(np.int32),
                               device=dev)
        abar = torch.as_tensor(gen.integers(0, 2 * P.N, (B, P.n)).astype(np.int32), device=dev)
        spans(0, False)
        off = K.blind_rotate(acc0, abar, dk.bk, P, dk.plan)
        ms = cuda_ms(lambda: K.blind_rotate(acc0, abar, dk.bk, P, dk.plan), 3)
        spans(1, False)
        on = K.blind_rotate(acc0, abar, dk.bk, P, dk.plan)
        raw = spans(0, True)
        if not torch.equal(on, off):
            raise SystemExit(f"k4_spans: {item} differs with the probe on")
        cfg = K.k4_layout(B, P, dk.plan, bundle)
        blocks = (B + cfg["group"] - 1) // cfg["group"]
        probed = (blocks + EVERY - 1) // EVERY
        ns, cyc, cnt = raw[:8], raw[8:16], raw[16:]
        tot_ns, tot_cyc = sum(ns), sum(cyc)
        res = {"ms": ms, "layout": cfg, "probed_blocks": probed,
               "block_us": tot_ns / probed / 1e3,
               "clock_ghz": tot_cyc / tot_ns if tot_ns else None, "phases": {}}
        print(f"{args.tag} {item} batch {B}: {ms:.4f} ms (probe off), {probed} blocks probed, "
              f"{res['block_us']:.1f} us a block, {cfg['instance']}", flush=True)
        for k, ph in enumerate(PHASES):
            share = ns[k] / tot_ns if tot_ns else 0.0
            cshare = cyc[k] / tot_cyc if tot_cyc else 0.0
            res["phases"][ph] = {"share": share, "share_clock": cshare, "ms": share * ms,
                                 "per_block": cnt[k] / probed,
                                 "us_each": ns[k] / cnt[k] / 1e3 if cnt[k] else 0.0}
            print(f"  {ph:8s} share {share:.4f} (clock {cshare:.4f})  {share * ms:9.4f} ms  "
                  f"{cnt[k] / probed:8.1f} a block  {res['phases'][ph]['us_each']:.3f} us each",
                  flush=True)
        out[item] = res
        del dk, off, on
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
