"""Where a block of the schoolbook round kernel (S1-fft) spends its time,
phase by phase, on the card.

    python tools/sbfft_spans.py [--root DIR] [--tag NAME] [--shapes medium_v2@512,large_v2@512,medium_v2@4]

Copies ``DIR/redsec_tpu_torch`` (default: this checkout's) into
``build/spans/sbfft_<tag>/`` (gitignored) and inserts a span probe into the
copy's ``csrc/schoolbook_fft.cu``; the shipped package has no such knob.
In every block of every eighth ciphertext, thread 0 reads ``%globaltimer``
and ``clock64()`` at each phase boundary of ``schoolbook_round_kernel`` and
adds the span since the last one to a device buffer by phase:

    setup      the launch's start to the first digit row (pointers, cluster
               handles, the accumulators zeroed)
    digits     rotate, difference, digits, fold and twist of a row
    fwd_first  a forward transform's first pass (registers to shared memory)
    fwd_mid    its radix-8 passes in shared memory
    fwd_last   its last pass (shared memory to registers) and the store of
               the row's spectrum where the cluster reads it
    w_rows     the cluster barriers after the forward transforms
    mac        the multiply-accumulate against the key's spectra
    w_mac      the cluster barrier after the MAC
    gather     reading the accumulated spectrum the block inverts (from the
               cluster's slices, or from its own buffer where the MAC sent
               them)
    w_gather   the cluster barrier after the gather, where there is one
    inv_first, inv_mid, inv_last   the inverse transforms' passes
    round      untwist, rounding, and the hand-over of the high half
    w_hand     the cluster barrier after the hand-over
    store      the recombination, the add of acc and the store

A phase's span includes the barrier that ends it; a design without a phase
(the pair design of the kernel has no gather and no hand-over) reports 0.
Two designs are recognised by their source: a cluster pair a ciphertext
(``__cluster_dims__(1, 2, 1)``) and a cluster of four blocks for each of
its ciphertexts.  The
probe is switched on by a device flag, so the same build is timed with it
off (CUDA events, 5 launches) and then run once with it on; the result must
equal the probe-off one.  Each shape is ``set@batch`` with random
accumulators, exponents and a random raw BK round (its spectra by
``kernels.key_spectra``).  Prints, per shape, the share of block time of each
phase, its ms a launch (the share times the probe-off time) and how often it
ran a block, then one JSON line.  The anchors are statements of
``schoolbook_fft.cu``: the tool stops if one is missing.
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
PHASES = ("setup", "digits", "fwd_first", "fwd_mid", "fwd_last", "w_rows", "mac", "w_mac",
          "gather", "w_gather", "inv_first", "inv_mid", "inv_last", "round", "w_hand", "store")
P = {name: k for k, name in enumerate(PHASES)}
EVERY = 8  # the blocks of one ciphertext in EVERY are probed

PROBE = r"""
// ---- span probe (tools/sbfft_spans.py) ----
__device__ unsigned long long g_spans[3][16];  // globaltimer ns, clock64 cycles, count
__device__ int g_spans_on;
__device__ __forceinline__ unsigned long long spans_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
struct SpanProbe {
  unsigned long long g = 0, c = 0;
  bool on;
  __device__ explicit SpanProbe(int ct)
      : on(threadIdx.x == 0 && ct % EVERY_ == 0 && g_spans_on) {
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
  unsigned long long zero[3][16] = {};
  e = cudaMemcpyToSymbol(g_spans, zero, sizeof(zero));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaMemcpyToSymbol(g_spans_on, &on, sizeof(on)));
}
"""

# The transform: dft<M> takes the probe and the index of its first pass's
# phase (fwd_first or inv_first) and marks after each of its three parts.
DFT = [
    (r"\ntemplate <int M>\nstruct Shape", "\n" + PROBE + r"\g<0>"),
    (r"(__device__ __forceinline__ void dft\(double2 \(&x\)\[Shape<M>::PQ\], double2\* buf,\s*"
     r"const double2\* __restrict__ tw)\) \{",
     r"\1, SpanProbe* prb_ = nullptr, int pb_ = 0) {"),
    (r"(\n  first_pass<M>\(x, buf\);)", r"\1\n  if (prb_) prb_->mark(pb_);"),
    (r"(\n  last_pass<M>\(buf, tw, x\);)",
     r"\n  if (prb_) prb_->mark(pb_ + 1);\1\n  if (prb_) prb_->mark(pb_ + 2);"),
]

# The earlier design: a cluster pair a ciphertext (blockIdx.x), each block
# transforming every other digit row and multiplying both into its
# polynomial's two accumulating spectra.
PAIR = DFT + [
    (r"(const double2\* pxch = cluster\.map_shared_rank\(xch, 1 - u\);)",
     r"\1\n  SpanProbe pr_(b);"),
    (r"(\n#pragma unroll 1\n  for \(int s = 0; 2 \* s < rows; \+\+s\) \{)",
     rf"\n  pr_.mark({P['setup']});\1"),
    (r"(\n    dft<M>\(x, buf, tw)\);",
     rf"\n    pr_.mark({P['digits']});\1, &pr_, {P['fwd_first']});"),
    (r"(own\[threadIdx\.x \+ q \* T\] = x\[q\];\n    cluster\.sync\(\);)",
     r"own[threadIdx.x + q * T] = x[q];\n"
     rf"    pr_.mark({P['fwd_last']});\n    cluster.sync();\n    pr_.mark({P['w_rows']});"),
    (r"(mac\(2 \* s \+ 1 - u, .*\n)", rf"\1    pr_.mark({P['mac']});\n"),
    (r"(cluster\.sync\(\);  // the pair's last read[^\n]*)", rf"\1\n  pr_.mark({P['w_mac']});"),
    (r"(\n    dft<M>\(x, buf, tw)\);", rf"\1, &pr_, {P['inv_first']});"),
    (r"(res\[1\]\[q\] \+= [^\n]*\n    \})", rf"\1\n    pr_.mark({P['round']});"),
    (r"(out\[base \+ j \+ M\] = [^\n]*\n  \})", rf"\1\n  pr_.mark({P['store']});"),
]

# A cluster of four blocks for each of its ciphertexts (blockIdx.x = C
# cluster + c): the anchors are the kernel's phase comments and its two
# transforms (forward, then inverse).
CLUSTER = DFT + [
    (r"(\n  // --- phase: setup ---\n)", r"\n  SpanProbe pr_(b);\1"),
    (r"(\n\s*)// --- phase: forward ---", rf"\1pr_.mark({P['setup']});\g<0>"),
    (r"(\n(\s*)dft<M>\(x, buf, tw)\);", rf"\n\2pr_.mark({P['digits']});\1, &pr_, "
                                        rf"{P['fwd_first']});"),
    (r"(\n\s*)// --- phase: rows stored ---", rf"\1pr_.mark({P['fwd_last']});\g<0>"),
    (r"(\n\s*)// --- phase: mac ---", rf"\1pr_.mark({P['w_rows']});\g<0>"),
    (r"(\n\s*)// --- phase: mac done ---", rf"\1pr_.mark({P['mac']});\g<0>"),
    (r"(\n\s*)// --- phase: chunk done ---", rf"\1pr_.mark({P['w_mac']});\g<0>"),
    (r"(\n(\s*)dft<M>\(x, buf, tw)\);", rf"\n\2pr_.mark({P['gather']});\1, &pr_, "
                                        rf"{P['inv_first']});"),
    (r"(\n\s*)// --- phase: handed over ---", rf"\1pr_.mark({P['round']});\g<0>"),
    (r"(\n\s*)// --- phase: store ---", rf"\1pr_.mark({P['w_hand']});\g<0>"),
    (r"(\n\s*)// --- phase: end ---", rf"\1pr_.mark({P['store']});\g<0>"),
]


def design(src: str) -> str:
    return "pair" if "__cluster_dims__(1, 2, 1)" in src else "cluster"


def patch(src: str) -> str:
    for i, (pat, rep) in enumerate(PAIR if design(src) == "pair" else CLUSTER):
        src, n = re.subn(pat, rep, src, count=1)
        if n != 1:
            raise SystemExit(f"sbfft_spans: anchor {i} ({pat!r:.70}) not found in "
                             f"schoolbook_fft.cu ({design(src)} design)")
    return src + ENTRY


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout whose redsec_tpu_torch is probed")
    ap.add_argument("--tag", default="change", help="name of this checkout in the output")
    ap.add_argument("--shapes", default="medium_v2@512,large_v2@512,medium_v2@4",
                    help="comma-separated set@batch")
    ap.add_argument("--build-only", action="store_true",
                    help="patch and build the copy, measure nothing (a later run reuses the build)")
    args = ap.parse_args(argv)
    dest = os.path.join(REPO, "build", "spans", f"sbfft_{args.tag}")
    pkg = os.path.join(dest, "redsec_tpu_torch")
    root_pkg = os.path.join(os.path.abspath(args.root), "redsec_tpu_torch")
    with open(os.path.join(root_pkg, "csrc", "schoolbook_fft.cu")) as f:
        src = f.read()
    want, kind = patch(src), design(src)
    cu = os.path.join(pkg, "csrc", "schoolbook_fft.cu")
    if not os.path.exists(cu) or open(cu).read() != want:  # else keep the copy and its build
        shutil.rmtree(dest, ignore_errors=True)
        shutil.copytree(root_pkg, pkg, ignore=shutil.ignore_patterns("__pycache__"))
        with open(cu, "w") as f:
            f.write(want)
    sys.path.insert(0, dest)

    import numpy as np
    import torch

    from redsec_tpu_torch.crypto import kernels as K
    from redsec_tpu_torch.crypto.params import get_params
    from redsec_tpu_torch.device import cuda_ms

    if not torch.cuda.is_available():
        raise SystemExit("sbfft_spans measures the card: no CUDA device")
    assert os.path.abspath(K.SBFFT_SOURCE) == os.path.abspath(cu), K.SBFFT_SOURCE
    ptxas = K.build_library(K.SBFFT_SOURCE)
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"{args.tag} ptxas: {line.strip()}", flush=True)
    if args.build_only:
        return {}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    K._sbf_lib()  # builds and loads the probed library
    lib = ctypes.CDLL(K.library_path(K.SBFFT_SOURCE))  # the same loaded file: its probe entry
    lib.redsec_spans.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.redsec_spans.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 48)()

    def spans(on: int, read: bool) -> list:
        code = lib.redsec_spans(buf if read else None, on)
        if code:
            raise SystemExit(f"sbfft_spans: CUDA error {code}")
        return list(buf)

    dev = torch.device("cuda", 0)
    gen = np.random.default_rng(7)

    def ri(lo, hi, shape):
        return torch.as_tensor(gen.integers(lo, hi, size=shape, dtype=np.int64)
                               .astype(np.int32), device=dev)

    blocks_per_ct = 2 if kind == "pair" else 4
    out = {"tag": args.tag, "card": card, "design": kind, "every": EVERY}
    print(f"{args.tag}: {card}, {kind} design", flush=True)
    for item in filter(None, args.shapes.split(",")):
        name, _, b = item.partition("@")
        B = int(b or 512)
        Pr = get_params(name)
        N, rows = Pr.N, Pr.decomp_rows
        acc, t = ri(-2**31, 2**31, (B, 2, N)), ri(0, 2 * N, (B,))
        spec = K.key_spectra(ri(-2**31, 2**31, (rows, 2, N)))
        res = torch.empty_like(acc)
        spans(0, False)
        off = K.schoolbook_round(acc, t, spec, Pr)
        if not torch.equal(off, K.schoolbook_round_plain(acc, t, spec, Pr)):
            raise SystemExit(f"sbfft_spans: {item} differs from its twin")
        ms = cuda_ms(lambda: K.schoolbook_round(acc, t, spec, Pr, out=res), 5, warmup=2)
        spans(1, False)
        on = K.schoolbook_round(acc, t, spec, Pr)
        raw = spans(0, True)
        if not torch.equal(on, off):
            raise SystemExit(f"sbfft_spans: {item} differs with the probe on")
        probed = blocks_per_ct * ((B + EVERY - 1) // EVERY)
        ns, cyc, cnt = raw[:16], raw[16:32], raw[32:]
        tot_ns, tot_cyc = sum(ns), sum(cyc)
        rec = {"ms": ms, "batch": B, "rows": rows, "N": N, "probed_blocks": probed,
               "block_us": tot_ns / probed / 1e3,
               "clock_ghz": tot_cyc / tot_ns if tot_ns else None,
               "layout": K.schoolbook_round_layout(N), "phases": {}}
        print(f"{args.tag} {item} [{B}, {rows}, {N}]: {ms:.4f} ms (probe off), {probed} blocks "
              f"probed, {rec['block_us']:.2f} us a block, {rec['layout']}", flush=True)
        for k, ph in enumerate(PHASES):
            share = ns[k] / tot_ns if tot_ns else 0.0
            cshare = cyc[k] / tot_cyc if tot_cyc else 0.0
            rec["phases"][ph] = {"share": share, "share_clock": cshare, "ms": share * ms,
                                 "per_block": cnt[k] / probed,
                                 "us_each": ns[k] / cnt[k] / 1e3 if cnt[k] else 0.0}
            print(f"  {ph:9s} share {share:.4f} (clock {cshare:.4f})  {share * ms:9.5f} ms  "
                  f"{cnt[k] / probed:6.2f} a block  {rec['phases'][ph]['us_each']:.3f} us each",
                  flush=True)
        out[item] = rec
        del acc, t, spec, res, off, on
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
