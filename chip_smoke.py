#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the whole run (a few minutes on an H100)
    python3 chip_smoke.py --profile  # also trace one forward (device time by kernel)

Phases (any failure exits non-zero):

1. Print the card's name and power limit (``nvidia-smi``).
2. Build the CUDA kernels of ``redsec_tpu_torch/csrc/pbs.cu`` with ``nvcc``
   for ``sm_90a``; the compiler's register/shared-memory report goes to
   ``chiprun_out/ptxas.txt``.
3. Kernel phase, at ``small_v2_tpu`` shapes: each kernel against its plain
   PyTorch twin on the card, on the same inputs.  The NTT runs at every row
   count key preparation gives it, the blind rotation at every batch the
   forward gives it (full and partial PBS chunks); the round kernels, which
   the main path runs only inside the blind rotation, on 64 ciphertexts.
   Tolerance: exact equality (every kernel is integer arithmetic mod p or
   mod 2^32).  Prints each kernel's and twin's time (CUDA events) at the
   main path's largest shape and the least time the card could take for
   the same work.
4. Slice phase: keygen ``small_v2_tpu`` (seed 0) -> ``prepare_cloud_key`` on
   the card -> ``mnist/sign1024x1`` with the golden reference weights ->
   encrypt a batch of synthetic images (numpy seed 1) -> encrypted forward ->
   decrypt.  The launch counters are zeroed just before and read just
   after; the run fails unless the NTT kernel prepared the key and the
   blind-rotation kernel ran every PBS chunk.  The key prepared through the
   NTT twin must equal the kernel's, and the forward through the plain
   twins, on the first and the last image, must be bit-identical.  Argmax
   agreement with the plaintext oracle is printed for information: the real
   mod-switch noise flips near-boundary signs.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside this file, the script exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3 bytes/s
# and int32 instructions/s on the CUDA cores.  The data sheet's 67 TFLOP/s
# fp32 rate counts a fused multiply-add as 2 flops on 128 fp32 lanes per SM
# (132 SMs x 128 x 2 x 1.98 GHz); an SM has 64 int32 lanes, one instruction
# each per clock, so a quarter of that: 132 x 64 x 1.98 GHz.
PEAK_BYTES = 3.35e12
PEAK_INT32_OPS = 67e12 / 4
BATCH = 8  # images in the slice phase


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def default_arg(fn, name: str):
    """The default of ``fn``'s argument ``name`` (the main path's chunk sizes)."""
    return inspect.signature(fn).parameters[name].default


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean time of ``fn()`` on the card over ``reps`` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------- #
# Work counts: the least bytes and int32 operations each kernel's function    #
# needs, from its shapes.  Each input is read once and each output written    #
# once; a modular multiply, add or subtract counts as one operation, though   #
# it takes several instructions, so the bound is a least time.                #
# --------------------------------------------------------------------------- #


def ntt_ops(N: int) -> int:
    """One length-N negacyclic transform: N twist multiplies and N/2*log2 N
    butterflies of one multiply, one add and one subtract."""
    return N + 3 * (N // 2) * (N.bit_length() - 1)


def ext_product_ops(rows: int, N: int, primes: int = 2) -> int:
    """One ciphertext's external product: per prime, `rows` forward and 8
    inverse transforms, the row MAC (multiply + add per product), then the
    CRT (about 6 operations a value) and the limb recombination (2)."""
    per_prime = (rows + 8) * ntt_ops(N) + 2 * rows * 8 * N
    return primes * per_prime + 8 * N * 8


def cmux_ops(rows: int, N: int) -> int:
    """One CMUX round: rotate-diff (2N), decompose (3 per digit), external
    product, accumulate (2N)."""
    return 2 * N + 3 * rows * N + ext_product_ops(rows, N) + 2 * N


def bound(bytes_: float, ops: float) -> tuple[float, str]:
    tb, to = bytes_ / PEAK_BYTES * 1e3, ops / PEAK_INT32_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def profile_forward(fwd, ct, card: str) -> None:
    """Device time by kernel over one traced forward, and the share of the
    forward's wall time in which the device ran no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd(ct)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's entry repeats the time of the
    # kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    with open(os.path.join(OUT_DIR, "profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    print(f"profile: forward wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.4f} on {card}", flush=True)
    for key, ms, count in rows[:8]:
        print(f"  {ms:10.3f} ms {100 * ms / busy_ms:6.2f}% x{count:<6d} {key[:90]}")


# --------------------------------------------------------------------------- #


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace one more forward with torch.profiler: device time by "
                         "kernel and the device's idle share (chiprun_out/profile.txt)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this script measures the "
              "port on a CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "redsec_tpu_torch")):
        print("FAIL: the redsec_tpu_torch package is not beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    import numpy as np

    from redsec_tpu_torch.crypto import bootstrap as bs
    from redsec_tpu_torch.crypto import kernels as K
    from redsec_tpu_torch.crypto import keygen as kg
    from redsec_tpu_torch.crypto.params import SMALL_V2_TPU as P
    from redsec_tpu_torch.device import launches
    from redsec_tpu_torch.formats.image_io import pixels_to_signed
    from redsec_tpu_torch.models.spec import prep_model
    from redsec_tpu_torch.models.zoo import get_model
    from redsec_tpu_torch.runtime import ptxt
    from redsec_tpu_torch.runtime.encrypted import (
        build_encrypted_forward, decrypt_scores, encrypt_images,
    )
    from redsec_tpu_torch.utils.metrics import model_stats, summarize

    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- phase 1: the card
    card = card_line()
    print(card, flush=True)  # as nvidia-smi gives it: name, power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # ---- phase 2: build
    t0 = time.perf_counter()
    ptxas = K.build_library()
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        f.write(ptxas)
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {' '.join(K.NVCC_FLAGS)})",
          flush=True)
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- the model, keys (host numpy, outside the counted run) and the shapes
    # the main path gives each kernel
    model = get_model("mnist/sign1024x1")
    weights = os.path.join(HERE, "tests", "golden", "sign1024x1_var_prep_from_ref_wght.dat")
    mplan = prep_model(model, weights)
    pbs_per_image = summarize(mplan)["total_bootstraps"]
    t0 = time.perf_counter()
    sk, cloud = kg.keygen(P, seed=0)
    print(f"keygen {P.name}: {time.perf_counter() - t0:.1f} s (host)", flush=True)
    plan = bs.bootstrap_plan(P)
    N, n, rows = P.N, P.n, P.decomp_rows
    key_chunk = default_arg(bs.prepare_cloud_key, "chunk")
    pbs_chunk = default_arg(build_encrypted_forward, "pbs_chunk")
    # K1: one launch per prime and chunk of key bits, [chunk * rows * 8 limb-polys, N]
    ntt_rows = sorted({min(key_chunk, n - i) * rows * 2 * bs.BK_LIMBS
                       for i in range(0, n, key_chunk)}, reverse=True)
    # K4: one launch per chunk of a layer's PBS batch
    layer_pbs = [s.bootstraps * BATCH for s in model_stats(mplan) if s.bootstraps]
    k4_batches = sorted({min(pbs_chunk, b - i) for b in layer_pbs
                         for i in range(0, b, pbs_chunk)}, reverse=True)
    print(f"main-path shapes: ntt rows {ntt_rows}, blind_rotate batches {k4_batches}",
          flush=True)
    dkey = bs.prepare_cloud_key(cloud, device="cuda")
    torch.cuda.synchronize()

    # ---- phase 3: kernels against their twins
    gen = np.random.default_rng(7)
    rec = {}

    def report(name, shape, ms, plain_ms, bytes_, ops, replaces):
        b_ms, b_by = bound(bytes_, ops)
        rec[name] = dict(name=name, route="cuda", source="redsec_tpu_torch/csrc/pbs.cu",
                         replaces=replaces, launches=0, max_abs_err=0,
                         ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None, shape=shape)
        print(f"kernel {name} {shape}: bit-identical to twin; {ms:.4f} ms (twin "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}) on {card}", flush=True)

    def same(name, got, want):
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            diff = (got != want).nonzero()
            fail(f"{name}: kernel differs from its plain twin at {diff.shape[0]} "
                 f"positions, first {diff[:1].tolist()}")

    def ri(lo, hi, shape):
        return torch.as_tensor(gen.integers(lo, hi, size=shape, dtype=np.int64)
                               .astype(np.int32), device=dev)

    # K1: both primes, forward and inverse, at every row count of key preparation
    for M1 in ntt_rows:
        for pi, p in enumerate(plan.primes):
            x = ri(0, p, (M1, N))
            for inv in (False, True):
                same(f"ntt [{M1}, {N}] prime {p} inverse={inv}",
                     K.ntt(x, plan, pi, inverse=inv), K.ntt_plain(x, plan, pi, inverse=inv))
    M1 = ntt_rows[0]
    x0 = ri(0, plan.primes[0], (M1, N))
    ms = cuda_ms(lambda: K.ntt(x0, plan, 0), 20)
    pms = cuda_ms(lambda: K.ntt_plain(x0, plan, 0), 5)
    report("ntt", [M1, N], ms, pms, 2 * M1 * N * 4, M1 * ntt_ops(N),
           "redsec_tpu/crypto/pallas_ntt.py:147")

    # K2 and K3 on M = 64, with round 0's slice of the prepared key
    M = 64
    bk0 = dkey.bk[:, 0].contiguous()
    digits = ri(-P.half_bg, P.half_bg, (M, rows, N))
    same("external_product", K.external_product(digits, bk0, plan),
         K.external_product_plain(digits, bk0, plan))
    ms = cuda_ms(lambda: K.external_product(digits, bk0, plan), 20)
    pms = cuda_ms(lambda: K.external_product_plain(digits, bk0, plan), 3)
    report("external_product", [M, rows, N], ms, pms,
           digits.numel() * 4 + bk0.numel() * 2 + M * 2 * N * 4,
           M * ext_product_ops(rows, N), "redsec_tpu/crypto/pallas_round.py:98")

    acc = ri(-2**31, 2**31, (M, 2, N))
    t = ri(0, 2 * N, (M,))
    same("cmux_round", K.cmux_round(acc, t, bk0, P, plan),
         K.cmux_round_plain(acc, t, bk0, P, plan))
    ms = cuda_ms(lambda: K.cmux_round(acc, t, bk0, P, plan), 20)
    pms = cuda_ms(lambda: K.cmux_round_plain(acc, t, bk0, P, plan), 3)
    report("cmux_round", [M, 2, N], ms, pms,
           2 * acc.numel() * 4 + M * 4 + bk0.numel() * 2, M * cmux_ops(rows, N),
           "redsec_tpu/crypto/pallas_round.py:254")

    # K4 over all n rounds, at every batch the forward gives it; timed at the
    # full chunk
    for B4 in k4_batches:
        acc0 = ri(-2**31, 2**31, (B4, 2, N))
        abar = ri(0, 2 * N, (B4, n))
        got = K.blind_rotate(acc0, abar, dkey.bk, P, plan)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = K.blind_rotate_plain(acc0, abar, dkey.bk, P, plan)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        same(f"blind_rotate batch {B4}", got, want)
        if B4 == k4_batches[0]:
            ms = cuda_ms(lambda: K.blind_rotate(acc0, abar, dkey.bk, P, plan), 3)
            report("blind_rotate", [B4, 2, N], ms, pms,
                   dkey.bk.numel() * 2 + 2 * acc0.numel() * 4 + abar.numel() * 4,
                   B4 * n * cmux_ops(rows, N), "redsec_tpu/crypto/pallas_blind.py:60")
        else:
            print(f"kernel blind_rotate [{B4}, 2, {N}]: bit-identical to twin", flush=True)
    del acc0, abar, got, want

    # ---- phase 4: the slice through the port's entry points
    rng = np.random.default_rng(1)
    images = pixels_to_signed(rng.integers(0, 256, size=(BATCH, 28, 28, 1)))

    del dkey
    torch.cuda.empty_cache()
    launches.reset()
    t0 = time.perf_counter()
    dkey = bs.prepare_cloud_key(cloud, device="cuda")
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    fwd = build_encrypted_forward(mplan, dkey)
    ct = encrypt_images(sk, images, P, rng, gain=fwd.in_gain)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fwd(ct)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    scores = decrypt_scores(sk, out, P, fwd.out_gain, fwd.out_center)
    counts = dict(launches.counts)
    print(f"slice launches: {counts}", flush=True)
    want_ntt = len(plan.primes) * len(range(0, n, key_chunk))
    want_k4 = sum(len(range(0, b, pbs_chunk)) for b in layer_pbs)
    if counts.get("ntt", 0) != want_ntt:
        fail(f"prepare_cloud_key launched the ntt kernel {counts.get('ntt', 0)} "
             f"times, not {want_ntt}")
    if counts.get("blind_rotate", 0) != want_k4:
        fail(f"the forward launched the blind_rotate kernel "
             f"{counts.get('blind_rotate', 0)} times, not {want_k4}")
    for name, r in rec.items():
        r["launches"] = counts.get(name, 0)

    out_np = out.cpu().numpy()
    if out_np.shape != (BATCH, 10, n + 1):
        fail(f"score ciphertexts have shape {out_np.shape}")
    if scores.shape != (BATCH, 10) or not np.all(np.abs(scores) < P.msg_space):
        fail(f"decrypted scores out of range: {scores}")

    pbs = pbs_per_image * BATCH
    print(f"slice: {BATCH} images x {pbs_per_image} PBS in {t_fwd:.3f} s "
          f"(prepare_cloud_key {t_prep:.3f} s): {pbs / t_fwd:.2f} PBS/s, "
          f"{BATCH / t_fwd:.4f} images/s on {card}", flush=True)

    # the same key and forward with the plain twins in place of the kernels:
    # the key must be equal, and the first and last images' scores (the first
    # and the partial last PBS chunk of every layer) bit-identical
    with mock.patch.object(K, "ntt", K.ntt_plain):
        pkey = bs.prepare_cloud_key(cloud, device="cuda")
    if not torch.equal(pkey.bk, dkey.bk):
        fail("the key prepared through the ntt kernel differs from the plain one")
    pfwd = build_encrypted_forward(mplan, pkey)
    for i in (0, BATCH - 1):
        t0 = time.perf_counter()
        with mock.patch.object(K, "blind_rotate", K.blind_rotate_plain):
            plain = pfwd(ct[i:i + 1])
        torch.cuda.synchronize()
        print(f"plain forward, image {i}: {time.perf_counter() - t0:.3f} s", flush=True)
        if not torch.equal(plain.cpu(), out[i:i + 1].cpu()):
            fail(f"kernel path and plain path differ on image {i}")
    print(f"kernel path bit-identical to the plain path (key, images 0 and {BATCH - 1})",
          flush=True)
    del pkey, pfwd

    if args.profile:
        profile_forward(fwd, ct, card)

    preds = ptxt.predict(mplan, images, device="cuda")
    agree = float((scores.argmax(axis=1) == preds).mean())
    print(f"argmax agreement with the plaintext oracle: {agree:.3f} "
          f"(informational; mod-switch noise flips near-boundary signs)", flush=True)

    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": list(rec.values()), "slice": {
            "images": BATCH, "pbs_per_image": pbs_per_image, "forward_s": t_fwd,
            "prepare_s": t_prep, "pbs_per_s": pbs / t_fwd,
            "images_per_s": BATCH / t_fwd, "launches": counts,
            "argmax_agreement": agree}}, f, indent=1)
    print(json.dumps({"kernels": list(rec.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
