#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the whole run (a few minutes on an H100)
    python3 chip_smoke.py --profile  # also trace one forward per slice (device time by kernel)

Phases (any failure exits non-zero):

1. Print the card's name and power limit (``nvidia-smi``).
2. Build the CUDA kernels of ``redsec_tpu_torch/csrc/pbs.cu`` and
   ``csrc/probes.cu`` with ``nvcc`` for ``sm_90a``, one compiler per source,
   both started together (a thread each); the compiler's
   register/shared-memory report goes to ``chiprun_out/ptxas.txt``.
3. Kernel phase: each kernel against its plain PyTorch twin on the card, on
   the same inputs.  At ``small_v2_tpu`` shapes the NTT runs at every row
   count key preparation gives it, the blind rotation at every batch the
   forwards give it (full and partial PBS chunks); the round kernels, which
   the model paths run only inside the blind rotation, on 64 ciphertexts.
   The rotation probes (one block a row; a block per tile of 64 and of 256
   rows) run on [512, 2, 1024] and on a batch of 64, the Toeplitz probe on
   its one shape.  Tolerance: exact equality (every kernel is integer
   arithmetic mod p or mod 2^32).  Prints each kernel's and twin's time
   (CUDA events) at its path's largest shape, the least time the card could
   take for the same work and, for the probes, the time of the one PyTorch
   call that computes the same function (a gather over the doubled
   polynomial; ``torch.take`` with a fixed index table).
4. Sign slice: keygen ``small_v2_tpu`` (seed 0) -> ``prepare_cloud_key`` on
   the card -> ``mnist/sign1024x1`` with the golden reference weights ->
   encrypt a batch of synthetic images (numpy seed 1) -> encrypted forward ->
   decrypt.  The launch counters are zeroed just before and read just
   after; the run fails unless the NTT kernel prepared the key and the
   blind-rotation kernel ran every PBS chunk.  The key prepared through the
   NTT twin must equal the kernel's, and the forward through the plain
   twins, on the first and the last image, must be bit-identical.  Argmax
   agreement with the plaintext oracle is printed for information: the real
   mod-switch noise flips near-boundary signs.
5. Relu slice: ``mnist/relu1024x1`` with its trained weights and calibration
   artifact (``nets_trained/mnist/relu1024x1``), same key, the same raw
   pixels thinned to MNIST's share of ink and mapped to the relu nets'
   ternary input, once as calibrated (input gain, 1-PBS quarter-range relu with one test vector
   per ciphertext) and once with the 3-PBS full-range relu forced.  The
   resolved gains must equal the artifact's, the bootstraps counted at the
   kernel's door must equal ``summarize`` (1024 and 3 x 1024 an image), the
   blind-rotation kernel must have run exactly one launch per PBS chunk
   (counters zeroed before, read after), and the plain path must be
   bit-identical on the first and the last image.
6. Probe entry points: ``redsec_tpu_torch.scripts.bench_rotate`` and
   ``bench_schoolbook`` run through their ``main`` with the counters zeroed
   before; every candidate is checked equal inside them, and the run fails
   unless each probe kernel was launched as often as the scripts call it.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside this file, the script exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import concurrent.futures
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


def kernel_device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device time, per call of ``fn``, of the CUDA kernels whose name
    contains ``kernel`` over ``reps`` calls (torch.profiler): what the card
    spends, where CUDA events around a small kernel time the host's enqueue.
    A named kernel must run once a call; ``""`` sums every kernel of a
    PyTorch call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if kernel in e.key and e.device_type == torch.autograd.DeviceType.CUDA]
    seen = sum(e.count for e in evs)
    if seen == 0 or (kernel and seen != reps):
        fail(f"the profiler saw {seen} launches of {kernel or 'any kernel'} in {reps} calls")
    return sum(e.self_device_time_total for e in evs) / reps / 1e3


def profile_forward(fwd, ct, card: str, tag: str) -> None:
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
    with open(os.path.join(OUT_DIR, f"profile_{tag}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    print(f"profile {tag}: forward wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.4f} on {card}", flush=True)
    for key, ms, count in rows[:8]:
        print(f"  {ms:10.3f} ms {100 * ms / busy_ms:6.2f}% x{count:<6d} {key[:90]}")


# --------------------------------------------------------------------------- #


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace one more forward per slice with torch.profiler: device "
                         "time by kernel and the device's idle share "
                         "(chiprun_out/profile_<slice>.txt)")
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
    from redsec_tpu_torch.crypto import probe_kernels as PK
    from redsec_tpu_torch.crypto.params import SMALL_V2_TPU as P
    from redsec_tpu_torch.device import launches
    from redsec_tpu_torch.formats.image_io import pixel_transform_for
    from redsec_tpu_torch.models.spec import prep_model
    from redsec_tpu_torch.models.zoo import get_model
    from redsec_tpu_torch.models.spec import Activation
    from redsec_tpu_torch.runtime import calibration, ptxt
    from redsec_tpu_torch.runtime.encrypted import (
        build_encrypted_forward, decrypt_scores, encrypt_images,
    )
    from redsec_tpu_torch.runtime.ranges import resolve_pbs_ranges
    from redsec_tpu_torch.scripts import bench_rotate, bench_schoolbook
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
    sources = [K.SOURCE, PK.SOURCE]
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        ptxas = "".join(pool.map(K.build_library, sources))
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        f.write(ptxas)
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(sources)} sources in parallel "
          f"(nvcc {' '.join(K.NVCC_FLAGS)})", flush=True)
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- the model, keys (host numpy, outside the counted run) and the shapes
    # the main path gives each kernel
    model = get_model("mnist/sign1024x1")
    weights = os.path.join(HERE, "tests", "golden", "sign1024x1_var_prep_from_ref_wght.dat")
    mplan = prep_model(model, weights)
    pbs_per_image = summarize(mplan)["total_bootstraps"]
    relu_dir = os.path.join(HERE, "nets_trained", "mnist", "relu1024x1")
    rplan = prep_model(get_model("mnist/relu1024x1"), os.path.join(relu_dir, "var_prep.dat"))
    rmeta = calibration.load_calibration(os.path.join(relu_dir, "calibration.npz"), rplan)
    ropts = calibration.options_from_meta(rmeta)
    if rmeta["params"] != P.name:
        fail(f"relu1024x1 is calibrated for {rmeta['params']}, not {P.name}")
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
    # K4: one launch per chunk of a PBS dispatch (a layer's batch of
    # bootstraps; the full-range relu dispatches its layer three times)
    layer_pbs = [s.bootstraps * BATCH for s in model_stats(mplan) if s.bootstraps]

    def relu_dispatches(relu_mode):
        """PBS dispatch sizes of the relu1024x1 forward, and the PbsRanges."""
        info = resolve_pbs_ranges(rplan, P.msg_space, input_gain=ropts["input_gain"],
                                  sigma_units=P.mod_switch_sigma_units(),
                                  relu_mode=relu_mode or ropts["relu_mode"])
        sizes = []
        for i, (lp, st) in enumerate(zip(rplan.layers, model_stats(rplan))):
            if lp.maxpool is not None:
                fail("the relu slice's dispatch count assumes no maxpool layer")
            full = lp.quant.mode == Activation.RELU and info[i].relu_mode == "full"
            sizes += [st.bootstraps * BATCH] * (3 if full else 1) if st.bootstraps else []
        return sizes, info

    relu_runs = {"quarter": None, "full": "full"}  # name -> forced relu mode
    all_pbs = layer_pbs + [b for m in relu_runs.values() for b in relu_dispatches(m)[0]]
    k4_batches = sorted({min(pbs_chunk, b - i) for b in all_pbs
                         for i in range(0, b, pbs_chunk)}, reverse=True)
    print(f"main-path shapes: ntt rows {ntt_rows}, blind_rotate batches {k4_batches}",
          flush=True)
    dkey = bs.prepare_cloud_key(cloud, device="cuda")
    torch.cuda.synchronize()

    # ---- phase 3: kernels against their twins
    gen = np.random.default_rng(7)
    rec = {}

    def report(name, shape, err, ms, plain_ms, bytes_, ops, replaces, source="pbs.cu",
               library_ms=None, **extra):
        b_ms, b_by = bound(bytes_, ops)
        rec[name] = dict(name=name, route="cuda", source=f"redsec_tpu_torch/csrc/{source}",
                         replaces=replaces, launches=0, max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=library_ms, shape=shape, **extra)
        lib = "" if library_ms is None else (
            f", one PyTorch call {library_ms:.4f} ms, on the device alone "
            f"{extra['library_device_ms']:.4f} ms")
        if "device_ms" in extra:
            lib += f"; the kernel on the device alone {extra['device_ms']:.4f} ms"
        print(f"kernel {name} {shape}: max abs err {err} against twin; {ms:.4f} ms (twin "
              f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms by {b_by}{lib}) on {card}", flush=True)

    def same(name, got, want) -> int:
        """The largest absolute difference between kernel and twin, which
        must be 0; the run fails otherwise."""
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f"{name}: kernel gives shape {tuple(got.shape)}, twin {tuple(want.shape)}")
        err = int((got.long() - want.long()).abs().max())
        if err != 0:
            diff = (got != want).nonzero()
            fail(f"{name}: kernel differs from its plain twin at {diff.shape[0]} "
                 f"positions, first {diff[:1].tolist()}, max abs err {err}")
        return err

    def ri(lo, hi, shape):
        return torch.as_tensor(gen.integers(lo, hi, size=shape, dtype=np.int64)
                               .astype(np.int32), device=dev)

    # K1: both primes, forward and inverse, at every row count of key preparation
    err = 0
    for M1 in ntt_rows:
        for pi, p in enumerate(plan.primes):
            x = ri(0, p, (M1, N))
            for inv in (False, True):
                err = max(err, same(
                    f"ntt [{M1}, {N}] prime {p} inverse={inv}",
                    K.ntt(x, plan, pi, inverse=inv), K.ntt_plain(x, plan, pi, inverse=inv)))
    M1 = ntt_rows[0]
    x0 = ri(0, plan.primes[0], (M1, N))
    ms = cuda_ms(lambda: K.ntt(x0, plan, 0), 20)
    pms = cuda_ms(lambda: K.ntt_plain(x0, plan, 0), 5)
    report("ntt", [M1, N], err, ms, pms, 2 * M1 * N * 4, M1 * ntt_ops(N),
           "redsec_tpu/crypto/pallas_ntt.py:147")

    # K2 and K3 on M = 64, with round 0's slice of the prepared key
    M = 64
    bk0 = dkey.bk[:, 0].contiguous()
    digits = ri(-P.half_bg, P.half_bg, (M, rows, N))
    err = same("external_product", K.external_product(digits, bk0, plan),
               K.external_product_plain(digits, bk0, plan))
    ms = cuda_ms(lambda: K.external_product(digits, bk0, plan), 20)
    pms = cuda_ms(lambda: K.external_product_plain(digits, bk0, plan), 3)
    report("external_product", [M, rows, N], err, ms, pms,
           digits.numel() * 4 + bk0.numel() * 2 + M * 2 * N * 4,
           M * ext_product_ops(rows, N), "redsec_tpu/crypto/pallas_round.py:98")

    acc = ri(-2**31, 2**31, (M, 2, N))
    t = ri(0, 2 * N, (M,))
    err = same("cmux_round", K.cmux_round(acc, t, bk0, P, plan),
               K.cmux_round_plain(acc, t, bk0, P, plan))
    ms = cuda_ms(lambda: K.cmux_round(acc, t, bk0, P, plan), 20)
    pms = cuda_ms(lambda: K.cmux_round_plain(acc, t, bk0, P, plan), 3)
    report("cmux_round", [M, 2, N], err, ms, pms,
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
        err = same(f"blind_rotate batch {B4}", got, want)
        if B4 == k4_batches[0]:
            ms = cuda_ms(lambda: K.blind_rotate(acc0, abar, dkey.bk, P, plan), 3)
            report("blind_rotate", [B4, 2, N], err, ms, pms,
                   dkey.bk.numel() * 2 + 2 * acc0.numel() * 4 + abar.numel() * 4,
                   B4 * n * cmux_ops(rows, N), "redsec_tpu/crypto/pallas_blind.py:60")
        else:
            print(f"kernel blind_rotate [{B4}, 2, {N}]: bit-identical to twin", flush=True)
    del acc0, abar, got, want

    # K5, K6: the rotation probes at the bench script's shape and at a batch
    # of 64; K6 at both tiles the script runs, where the tile divides the batch
    for B5 in (512, 64):
        x5 = ri(-2**31, 2**31, (B5, 2, N))
        x5[:, 0, 0] = -2**31  # negates to itself
        t5 = ri(0, 2 * N, (B5,))
        t5[:6] = torch.tensor([0, 1, N - 1, N, N + 1, 2 * N - 1], dtype=torch.int32)
        want = PK.rotate_plain(x5, t5)
        err5 = same(f"rotate_rows batch {B5}", PK.rotate_rows(x5, t5), want)
        tiles = [T for T in (64, 256) if B5 % T == 0]
        err6 = max(same(f"rotate_tile batch {B5} tile {T}", PK.rotate_tile(x5, t5, T), want)
                   for T in tiles)
        if B5 != 512:
            print(f"kernel rotate_rows, rotate_tile {tiles} [{B5}, 2, {N}]: bit-identical "
                  f"to twin", flush=True)
            continue
        rot_bytes, rot_ops = 2 * x5.numel() * 4 + t5.numel() * 4, 2 * x5.numel()
        pms = cuda_ms(lambda: PK.rotate_plain(x5, t5), 50, warmup=3)
        lms = cuda_ms(lambda: bench_schoolbook.rot_gather(x5, t5), 50, warmup=3)
        ldev = kernel_device_ms(lambda: bench_schoolbook.rot_gather(x5, t5), "")
        ms = cuda_ms(lambda: PK.rotate_rows(x5, t5), 200, warmup=3)
        # these launches are short: CUDA events time the host's enqueue, so
        # the device's own time per launch is read from the profiler as well
        report("rotate_rows", [B5, 2, N], err5, ms, pms, rot_bytes, rot_ops,
               "scripts/bench_rotate.py:87", "probes.cu", lms, library_device_ms=ldev,
               device_ms=kernel_device_ms(lambda: PK.rotate_rows(x5, t5), "rotate_rows_kernel"))
        ms64 = cuda_ms(lambda: PK.rotate_tile(x5, t5, 64), 200, warmup=3)
        ms256 = cuda_ms(lambda: PK.rotate_tile(x5, t5, 256), 200, warmup=3)
        report("rotate_tile", [B5, 2, N], err6, ms64, pms, rot_bytes, rot_ops,
               "scripts/bench_rotate.py:109", "probes.cu", lms, library_device_ms=ldev,
               tile=64, ms_tile256=ms256,
               device_ms=kernel_device_ms(lambda: PK.rotate_tile(x5, t5, 64),
                                          "rotate_tile_kernel"),
               device_ms_tile256=kernel_device_ms(lambda: PK.rotate_tile(x5, t5, 256),
                                                  "rotate_tile_kernel"))
        print(f"kernel rotate_tile tile 256: {ms256:.4f} ms, on the device alone "
              f"{rec['rotate_tile']['device_ms_tile256']:.4f} ms ({B5 // 256} blocks for "
              f"the card's 132 SMs)", flush=True)

    # K7: the Toeplitz tile, its one shape
    w7 = ri(-2**31, 2**31, (1, 2 * PK.TOEPLITZ_TILE))
    err = same("toeplitz_tile", PK.toeplitz_tile(w7), PK.toeplitz_tile_plain(w7))
    ms = cuda_ms(lambda: PK.toeplitz_tile(w7), 200, warmup=3)
    pms = cuda_ms(lambda: PK.toeplitz_tile_plain(w7), 50, warmup=3)
    # the one PyTorch call: torch.take with the tile's fixed index table
    # (127 + k - j stays inside [0, 254], nothing wraps), built once
    kk = torch.arange(PK.TOEPLITZ_TILE, device=dev)
    idx7 = PK.TOEPLITZ_TILE - 1 + kk[None, :] - kk[:, None]
    if not torch.equal(torch.take(w7, idx7), PK.toeplitz_tile_plain(w7)):
        fail("torch.take over the fixed index table differs from the toeplitz_tile twin")
    lms = cuda_ms(lambda: torch.take(w7, idx7), 200, warmup=3)
    report("toeplitz_tile", [1, 2 * PK.TOEPLITZ_TILE], err, ms, pms,
           w7.numel() * 4 + PK.TOEPLITZ_TILE ** 2 * 4, PK.TOEPLITZ_TILE ** 2,
           "scripts/bench_schoolbook.py:254", "probes.cu", lms,
           library_device_ms=kernel_device_ms(lambda: torch.take(w7, idx7), ""),
           device_ms=kernel_device_ms(lambda: PK.toeplitz_tile(w7), "toeplitz_tile_kernel"))

    # the PBS's test-vector rotation at a full chunk: one vector broadcast
    # (sign) against one vector per ciphertext (relu)
    ops_ = bs.RoundOps(P)
    tv1 = ri(-2**31, 2**31, (N,)).expand(pbs_chunk, N)
    tvm = ri(-2**31, 2**31, (pbs_chunk, N))
    bb = ri(0, 2 * N, (pbs_chunk,))
    tv_rot = {"broadcast": cuda_ms(lambda: ops_.rotate(tv1, bb), 50, warmup=3),
              "per_ciphertext": cuda_ms(lambda: ops_.rotate(tvm, bb), 50, warmup=3)}
    print(f"test-vector rotate [{pbs_chunk}, {N}]: one broadcast vector "
          f"{tv_rot['broadcast']:.4f} ms, one per ciphertext "
          f"{tv_rot['per_ciphertext']:.4f} ms on {card}", flush=True)

    # ---- phase 4: the sign slice through the port's entry points
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 256, size=(BATCH, 28, 28, 1))
    images = pixel_transform_for(model.name)(raw)

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
    by_path = {"sign1024x1": counts}

    def check_scores(out, scores):
        if tuple(out.shape) != (BATCH, 10, n + 1):
            fail(f"score ciphertexts have shape {tuple(out.shape)}")
        if scores.shape != (BATCH, 10) or not np.all(np.abs(scores) < P.msg_space):
            fail(f"decrypted scores out of range: {scores}")

    def check_plain_path(tag, pfwd, ct, out):
        """The forward through the plain twin, on the first and the last
        image (the first and the last PBS chunk of every dispatch)."""
        for i in (0, BATCH - 1):
            t0 = time.perf_counter()
            with mock.patch.object(K, "blind_rotate", K.blind_rotate_plain):
                plain = pfwd(ct[i:i + 1])
            torch.cuda.synchronize()
            print(f"{tag}: plain forward, image {i}: {time.perf_counter() - t0:.3f} s",
                  flush=True)
            if not torch.equal(plain.cpu(), out[i:i + 1].cpu()):
                fail(f"{tag}: kernel path and plain path differ on image {i}")

    check_scores(out, scores)

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
    check_plain_path("sign1024x1", build_encrypted_forward(mplan, pkey), ct, out)
    print(f"kernel path bit-identical to the plain path (key, images 0 and {BATCH - 1})",
          flush=True)
    del pkey

    if args.profile:
        profile_forward(fwd, ct, card, "sign1024x1")

    preds = ptxt.predict(mplan, images, device="cuda")
    agree = float((scores.argmax(axis=1) == preds).mean())
    print(f"argmax agreement with the plaintext oracle: {agree:.3f} "
          f"(informational; mod-switch noise flips near-boundary signs)", flush=True)

    slices = {"sign1024x1": {
        "images": BATCH, "pbs_per_image": pbs_per_image, "forward_s": t_fwd,
        "prepare_s": t_prep, "pbs_per_s": pbs / t_fwd, "images_per_s": BATCH / t_fwd,
        "launches": counts, "argmax_agreement": agree}}
    del fwd, out

    # ---- phase 5: the relu slice, as calibrated and with the full-range relu
    # the relu nets take ternary pixels (p // 100 - 1), and the artifact was
    # calibrated on MNIST rows, mostly background: keep 19% of the pixels as
    # ink so the pre-activations stay inside the calibrated quarter range
    ink = np.random.default_rng(3).random(raw.shape) < 0.19
    rimages = pixel_transform_for(rplan.spec.name)(raw * ink)
    rpreds = ptxt.predict(rplan, rimages, device="cuda")
    for run, forced in relu_runs.items():
        tag = f"relu1024x1/{run}"
        sizes, info = relu_dispatches(forced)
        modes = {i: r.relu_mode for i, r in info.items() if r.relu_mode}
        if set(modes.values()) != {run}:
            fail(f"{tag}: resolved relu modes {modes}")
        if forced is None and (
                {str(i): [r.in_gain, r.out_gain] for i, r in info.items()} != rmeta["gains"]):
            fail(f"{tag}: resolved gains differ from the artifact's {rmeta['gains']}")
        rfwd = build_encrypted_forward(rplan, dkey, input_gain=ropts["input_gain"],
                                       relu_mode=forced or ropts["relu_mode"])
        if rfwd.in_gain != rmeta["in_gain"]:
            fail(f"{tag}: input gain {rfwd.in_gain}, the artifact says {rmeta['in_gain']}")
        rct = encrypt_images(sk, rimages, P, np.random.default_rng(2), gain=rfwd.in_gain)
        seen = []  # bootstraps at the kernel's door, one entry per launch

        def counting(acc0, *rest, _real=K.blind_rotate):
            seen.append(acc0.shape[0])
            return _real(acc0, *rest)

        launches.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(K, "blind_rotate", counting):
            rout = rfwd(rct)
        torch.cuda.synchronize()
        t_r = time.perf_counter() - t0
        rcounts = dict(launches.counts)
        by_path[tag] = rcounts
        rscores = decrypt_scores(sk, rout, P, rfwd.out_gain, rfwd.out_center)
        per_image = summarize(rplan)["total_bootstraps"] * (3 if run == "full" else 1)
        want_k4 = sum(len(range(0, b, pbs_chunk)) for b in sizes)
        print(f"{tag} launches: {rcounts}", flush=True)
        if sum(seen) != per_image * BATCH or sum(sizes) != per_image * BATCH:
            fail(f"{tag}: {sum(seen)} bootstraps reached the kernel, summarize says "
                 f"{per_image} an image x {BATCH}")
        if rcounts.get("blind_rotate", 0) != want_k4 or len(seen) != want_k4:
            fail(f"{tag}: the forward launched the blind_rotate kernel "
                 f"{rcounts.get('blind_rotate', 0)} times, not {want_k4}")
        check_scores(rout, rscores)
        ragree = float((rscores.argmax(axis=1) == rpreds).mean())
        print(f"{tag}: {BATCH} images x {per_image} PBS in {t_r:.3f} s: "
              f"{per_image * BATCH / t_r:.2f} PBS/s, {BATCH / t_r:.4f} images/s, gains "
              f"{rmeta['gains'] if forced is None else 'as calibrated'}, argmax agreement "
              f"with the plaintext oracle {ragree:.3f} (informational) on {card}", flush=True)
        check_plain_path(tag, rfwd, rct, rout)
        print(f"{tag}: kernel path bit-identical to the plain path (images 0 and "
              f"{BATCH - 1})", flush=True)
        if args.profile:
            profile_forward(rfwd, rct, card, tag.replace("/", "_"))
        slices[tag] = {"images": BATCH, "pbs_per_image": per_image, "forward_s": t_r,
                       "pbs_per_s": per_image * BATCH / t_r, "images_per_s": BATCH / t_r,
                       "launches": rcounts, "argmax_agreement": ragree}
        del rfwd, rout, rct

    # ---- phase 6: the probes' entry points (each checks its candidates equal)
    bench = {}
    for tag, mod, argv, expect in (
            ("bench_rotate", bench_rotate, ["--batch", "512", "--iters", "50"],
             {"rotate_rows": 1 + 2 * 50, "rotate_tile": 2 * (1 + 2 * 50)}),
            ("bench_schoolbook", bench_schoolbook, ["--batch", "1024", "--iters", "5"],
             {"toeplitz_tile": 1 + 2 * 5})):
        launches.reset()
        t0 = time.perf_counter()
        bench[tag] = mod.main(argv)
        torch.cuda.synchronize()
        pcounts = dict(launches.counts)
        by_path[tag] = pcounts
        print(f"{tag} {' '.join(argv)}: {time.perf_counter() - t0:.1f} s, launches {pcounts}",
              flush=True)
        # one launch per check, then a warm-up chain and a timed chain
        if pcounts != expect:
            fail(f"{tag} launched {pcounts}, expected {expect}")

    for name, r in rec.items():
        r["launches_by_path"] = {k: v[name] for k, v in by_path.items() if v.get(name)}
        r["launches"] = sum(r["launches_by_path"].values())
    never = [name for name, r in rec.items()
             if r["launches"] == 0 and name not in ("external_product", "cmux_round")]
    if never:  # the two round kernels are the body of blind_rotate on every path
        fail(f"kernels never launched on any driven path: {never}")

    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": list(rec.values()), "slices": slices,
                   "tv_rotate_ms": tv_rot, "bench": bench}, f, indent=1)
    print(json.dumps({"kernels": list(rec.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
