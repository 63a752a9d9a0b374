"""Where a block of the four-step round kernels K2-mm and K3-mm spends its
time, phase by phase, on the card.

    python tools/mm_spans.py [--root DIR] [--tag NAME] [--sets small_v2_tpu] [--batches 64,512]
        [--splits 1,2]

Copies ``DIR/redsec_tpu_torch`` (default: this checkout's) into
``build/spans_mm/<tag>/`` (gitignored) and inserts a span probe into the
copy's ``csrc/blind_mm.cu``; the shipped package has no such knob.  In every
block, thread 0 reads ``%globaltimer`` and ``clock64()`` at each phase
boundary and adds the span since the last one to a device buffer by phase:

    stage     the launch's start: the key ring's first rows issued, the
              accumulators and WC's limbs staged (the pair kernels: WC
              issued by cp.async, its wait in the forward phase)
    digits    the differences X^t acc - acc (K3-mm)
    forward   a prime's forward transforms (R-step, twiddle, C-step) to the
              barrier after them (from the previous prime's inverse on)
    mac       the MAC over the key rows (one block a ciphertext: with the
              sums' store as the inverse's operand and its barrier)
    sums      the pair kernels: the sums' store
    inverse   the inverse transforms (C-step and R-step) and their barrier
              (the pair kernels: the other half's residues stored into the
              CRT partner's shared memory)
    crt       the CRT and the stores of the outputs
    wait      the pair kernels: the cluster barrier before the CRT

A phase's span includes the barrier that ends it.  The probe is switched on
by a device flag, so the same build is timed with it off (CUDA events) and
then run once with it on.  K3-mm and K2-mm run at each batch of
``--batches`` on a seed-0 "matmul" key of each set, at each split of
``--splits`` where the checkout has both designs (else its one design).
Prints, for each, the share of block time of each phase, its us a block and
how often it ran a block, then one JSON line.  The anchors are statements
of ``blind_mm.cu``; the tool stops if one that its design has is missing.
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
PHASES = ("stage", "digits", "forward", "mac", "sums", "inverse", "crt", "wait")

PROBE = r"""
// ---- span probe (tools/mm_spans.py) ----
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
  __device__ SpanProbe() : on(threadIdx.x == 0 && g_spans_on) {
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
"""

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

# (pattern, replacement, count) applied to blind_mm.cu; \g<0> keeps the match.
# The one-a-block round (external_product_mm, also K4-mm's body, which
# passes no probe) and its two kernels:
ONE = [
    (r"// Geometry: N = R \* 128", PROBE + r"\n\g<0>", 1),
    (r"\n(\s+)uint32_t \(&delta\)\[2\]\[GeoMM<N>::E\]\) \{",
     r"\n\1uint32_t (&delta)[2][GeoMM<N>::E], SpanProbe* prb_ = nullptr) {", 1),
    (r"    mma_mod<N>\(sm\.ulo, sm\.uhi, M, wlo, whi, sm\.z, md, c8, c16\);\n    __syncthreads\(\);\n",
     r"\g<0>    if (prb_) prb_->mark(2);\n", 1),
    (r"    mma_mod<N>\(sm\.ulo, sm\.uhi, 8 \* R, wlo, whi, sm\.z, md, c8, c16\);",
     r"    if (prb_) prb_->mark(3);\n\g<0>", 1),
    (r"    inverse_post<N>\(tab, sm, pi == 0 \? sm\.r2 : sm\.r1, md\);\n    __syncthreads\(\);\n",
     r"\g<0>    if (prb_) prb_->mark(5);\n", 1),
    (r"  const KeyStream<N> ks\(sm, bk, 0, prime_stride, rows, 1\);",
     r"  SpanProbe pr_;\n\g<0>", 2),
    (r"  const RowDigits4<N> dig\{digits \+ m \* rows \* N\};", r"  pr_.mark(0);\n\g<0>", 1),
    (r"  rotate_diff<N>\(sm, t\[m\], g\.offset\);\n  const GadgetDigits4",
     r"  pr_.mark(0);\n  rotate_diff<N>(sm, t[m], g.offset);\n  pr_.mark(1);\n  const GadgetDigits4", 1),
    (r"external_product_mm<N>\(dig, rows, ks, 0, at, tabs, cs, sm, delta\);",
     r"external_product_mm<N>(dig, rows, ks, 0, at, tabs, cs, sm, delta, &pr_);", 2),
    (r"(make_int2\(sm\.acc\[k\] \+ delta\[u\]\[0\], sm\.acc\[k \+ 1\] \+ delta\[u\]\[1\]\);\n  \})",
     r"\1\n  pr_.mark(6);", 1),
    (r"(make_int2\(delta\[u\]\[0\], delta\[u\]\[1\]\);)\n\}", r"\1\n  pr_.mark(6);\n}", 1),
]
# The round on a cluster pair (split_round), where the checkout has it:
SPLIT = [
    (r"  const SmemMM<N> sm\(reinterpret_cast<unsigned char\*>\(smem_raw\), rows, PairBlock\{\}\);",
     r"\g<0>\n  SpanProbe pr_;", 1),
    (r"      sm\.acc\[k\] = static_cast<uint32_t>\(acc_in\[m \* 2 \* N \+ k\]\);\n  __syncthreads\(\);",
     r"\g<0>\n  pr_.mark(0);", 1),
    (r"(rotate_diff<N>\(sm, t\[m\], g\.offset\);)(\n    forward_pre<N>\(GadgetDigits4)",
     r"\1 pr_.mark(1);\2", 1),
    (r"  mma_mod<N>\(sm\.ulo, sm\.uhi, rows \* R, wlo, whi, sm\.z, md, c8, c16\);\n  __syncthreads\(\);",
     r"\g<0>\n  pr_.mark(2);", 1),
    (r"\n  // the 8 sums, in \[0, p\)", r"\n  pr_.mark(3);\g<0>", 1),
    (r"  __syncthreads\(\);\n  mma_mod<N>\(sm\.ulo, sm\.uhi, 8 \* R,", r"  pr_.mark(4);\n\g<0>", 1),
    (r"  inverse_post_split<N>\([^;]*;\n", r"\g<0>  pr_.mark(5);\n", 1),
    (r"(  cluster_arrive\(\);  // both primes' residues of each half are in place\n"
     r"  cluster_wait\(\);\n)", r"\1  pr_.mark(7);\n", 1),
    (r"(        make_int2\(static_cast<int>\(d0\), static_cast<int>\(d1\)\);\n  \}\n)\}",
     r"\1  pr_.mark(6);\n}", 1),
]


def patch(src: str) -> str:
    groups = [ONE] + ([SPLIT] if "split_round" in src else [])
    for group in groups:
        for i, (pat, rep, count) in enumerate(group):
            src, n = re.subn(pat, rep, src, count=count)
            if n != count:
                raise SystemExit(f"mm_spans: anchor {i} ({pat!r:.60}) found {n} times in "
                                 f"blind_mm.cu, expected {count}")
    return src + ENTRY


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout whose redsec_tpu_torch is probed")
    ap.add_argument("--tag", default="change", help="name of this checkout in the output")
    ap.add_argument("--sets", default="small_v2_tpu", help="comma-separated parameter sets")
    ap.add_argument("--batches", default="64,512", help="comma-separated ciphertext counts M")
    ap.add_argument("--splits", default="1,2",
                    help="blocks a ciphertext, where the checkout has both designs")
    ap.add_argument("--reps", type=int, default=20, help="launches timed with the probe off")
    args = ap.parse_args(argv)
    dest = os.path.join(REPO, "build", "spans_mm", args.tag)
    pkg = os.path.join(dest, "redsec_tpu_torch")
    root_pkg = os.path.join(os.path.abspath(args.root), "redsec_tpu_torch")
    with open(os.path.join(root_pkg, "csrc", "blind_mm.cu")) as f:
        want = patch(f.read())
    cu = os.path.join(pkg, "csrc", "blind_mm.cu")
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
        raise SystemExit("mm_spans measures the card: no CUDA device")
    assert os.path.abspath(K.MM_SOURCE) == os.path.abspath(cu), K.MM_SOURCE
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    K._mm_lib()  # builds and loads the probed library
    lib = ctypes.CDLL(K.library_path(K.MM_SOURCE))  # the same loaded file: its probe entry
    lib.redsec_spans.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.redsec_spans.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 24)()

    def spans(on: int, read: bool) -> list:
        code = lib.redsec_spans(buf if read else None, on)
        if code:
            raise SystemExit(f"mm_spans: CUDA error {code}")
        return list(buf)

    splits = ([int(s) for s in args.splits.split(",")] if hasattr(K, "_cmux_round_mm")
              else [None])
    dev = torch.device("cuda", 0)
    gen = np.random.default_rng(7)
    out = {"tag": args.tag, "card": card}
    print(f"{args.tag}: {card}", flush=True)
    for name in filter(None, args.sets.split(",")):
        P = get_params(name)
        _, cloud = kg.keygen(P, seed=0)
        mk = bs.prepare_cloud_key(cloud, device="cuda", ntt_flavor="matmul")
        bk0 = mk.bk[:, 0].contiguous()
        N, rows = P.N, P.decomp_rows
        for M in (int(b) for b in args.batches.split(",")):
            acc = torch.as_tensor(gen.integers(-2**31, 2**31, (M, 2, N)).astype(np.int32),
                                  device=dev)
            t = torch.as_tensor(gen.integers(0, 2 * N, (M,)).astype(np.int32), device=dev)
            digits = torch.as_tensor(
                gen.integers(-P.half_bg, P.half_bg, (M, rows, N)).astype(np.int32), device=dev)
            for split in splits:
                for kname, fn in (
                        ("cmux_round_mm", lambda: K._cmux_round_mm(acc, t, bk0, P, mk.plan, split)
                         if split else K.cmux_round_mm(acc, t, bk0, P, mk.plan)),
                        ("external_product_mm",
                         lambda: K._external_product_mm(digits, bk0, mk.plan, split)
                         if split else K.external_product_mm(digits, bk0, mk.plan))):
                    spans(0, False)
                    off = fn()
                    ms = cuda_ms(fn, args.reps)
                    spans(1, False)
                    on = fn()
                    raw = spans(0, True)
                    item = f"{name} {kname} M {M}" + ("" if split is None else f" split {split}")
                    if not torch.equal(on, off):
                        raise SystemExit(f"mm_spans: {item} differs with the probe on")
                    blocks = M * (split or 1)
                    ns, cyc, cnt = raw[:8], raw[8:16], raw[16:]
                    tot_ns, tot_cyc = sum(ns), sum(cyc)
                    res = {"ms": ms, "blocks": blocks, "block_us": tot_ns / blocks / 1e3,
                           "clock_ghz": tot_cyc / tot_ns if tot_ns else None, "phases": {}}
                    print(f"{args.tag} {item}: {ms:.4f} ms (probe off, events), {blocks} blocks, "
                          f"{res['block_us']:.2f} us a block", flush=True)
                    for k, ph in enumerate(PHASES):
                        if not cnt[k]:
                            continue
                        share = ns[k] / tot_ns if tot_ns else 0.0
                        res["phases"][ph] = {"share": share, "us_block": ns[k] / blocks / 1e3,
                                             "per_block": cnt[k] / blocks}
                        print(f"  {ph:8s} share {share:.4f}  {ns[k] / blocks / 1e3:8.3f} us a "
                              f"block  {cnt[k] / blocks:5.1f} a block", flush=True)
                    out[item] = res
        del mk, bk0
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
