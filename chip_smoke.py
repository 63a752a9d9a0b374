#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the whole run (a few minutes on an H100)
    python3 chip_smoke.py --profile  # also trace one forward per slice and the CIFAR
                                     # forward (device time by kernel, idle share)

Phases (any failure exits non-zero):

1. Print the card's name and power limit (``nvidia-smi``).
2. Build the CUDA kernels of ``redsec_tpu_torch/csrc/pbs.cu``,
   ``csrc/blind_mm.cu``, ``csrc/probes.cu``, ``csrc/schoolbook.cu`` and
   ``csrc/schoolbook_fft.cu`` with ``nvcc`` for ``sm_90a``,
   one compiler per source, all started together (a thread each); the compiler's
   register/shared-memory report goes to ``chiprun_out/ptxas.txt``.
3. Kernel phase: each kernel against its plain PyTorch twin on the card, on
   the same inputs.  At ``small_v2_tpu`` shapes the NTT runs at every row
   count key preparation gives it, the blind rotation at every batch the
   forwards give it (full and partial PBS chunks) and at batches of 133, 5
   and 1 (a ragged last block; one ciphertext a block); the round kernels,
   which the model paths run only inside the blind rotation, on 64
   ciphertexts.  The rotation probes (one block a row; tiles of 64 and of
   256 rows, each dealt out over enough blocks to fill the card) run on
   [512, 2, 1024] and on a batch of 64, the Toeplitz probe on its one shape.
   The blind rotation also runs at ``small_v2``, the command line's default
   set (20 digit rows: two ciphertexts a block beyond one wave of blocks,
   with the rows in chunks of 12), at batches 512, 133, 5 and 1, timed at
   512: the ``kernels`` line's ``blind_rotate_small_v2``.  The NTT also runs
   at ``small``'s three primes (40961 above 2^15) and at N = 2048 (12289,
   40961: ``ntt_n2048``); the blind rotation at the instances of these keys,
   at batches 512, 133, 5 and 1, timed at 512: ``small_v2_n2048`` (N 2048),
   ``small`` (three primes), bundled ``small_v2_tpu``, ``small_v2_tpu2`` and
   ``small_v2_n2048`` (``bundle=2``: n/2 rounds of 3 x 2l digit rows; three
   primes at tpu2; at N 2048, and at tpu2 two ciphertexts a block, the
   accumulators on the MAC sums' region; at tpu2 two a block, the last
   prime's MAC sums on the differences).
   At every instance and batch the layout the library chooses must be
   ``kernels.k4_layout``'s; each record gives the ciphertexts a block and
   a key load serves (every block loads its own key rows), the chunk of
   digit rows, the shared bytes, registers and spills.  Every key
   prepared on the card in this phase (``small_v2`` and the five above) must
   equal, bit for bit, the same key prepared with the NTT twin in the
   kernel's place: that holds K1 at exactly the row counts each preparation
   launches it at.
   The four-step kernels of ``csrc/blind_mm.cu`` on "matmul" keys prepared
   from the same raw keys (K2-mm and K3-mm on 64 and 512 ciphertexts, at the
   split the wrapper picks, each record with its layout (blocks a
   ciphertext, cluster, shared bytes, registers, spills, ciphertexts at
   once: the library's held to ``kernels.round_mm_layout``) and its bound
   also priced on the SMs its grid occupies, ``bound_ms_occupied_sms``;
   the ``round_kernel`` paths of phase 12 launch them; K4-mm at
   ``small_v2_tpu`` at batches 512, 133, 5 and 1, its 512 output also equal
   to K4's on the radix-2 key, and at ``small_v2`` and plain
   ``small_v2_tpu2`` at 512 and 1; timed at 512 beside K4 in this process),
   their layout the library's own rule held to ``kernels.k4mm_layout`` (the
   records name the key ring: ``ring_rows``, ``ring_aliased``, ``ring_copy``,
   ``ring_bytes_in_flight`` a block); each
   record's bound is the function's with the four-step formulation's beside
   it (``bound_four_step_ms``: its int8 MACs at the tensor cores' rate plus
   its int32 work).
   Tolerance: exact equality (every kernel is integer arithmetic mod p or
   mod 2^32).  Prints each kernel's and twin's time (CUDA events) at its
   path's largest shape (the blind rotation's also at the smallest batch of
   the path, with the ciphertexts a block it chose, the registers and spills
   ptxas reports for that build, and the dynamic shared memory of the launch
   as the C entry computes it: ptxas sees none of it and reports 0), the
   least time the card could take for the same work and, for the probes, the
   time of the one PyTorch call that computes the same function (a gather
   over the doubled polynomial; ``torch.take`` with a fixed index table,
   timed in turns with the Toeplitz probe, both paced by the host).  The
   round kernels (K2, K3, K2-mm, K3-mm) and the probes also give their
   device time (profiler), and every wrapper its host microseconds a call
   (calls with no synchronize between them: the launch path's own cost),
   printed on one "launch path" line before the kernel phase ends.
4. Sign slice: keygen ``small_v2_tpu`` (seed 0) -> ``prepare_cloud_key`` on
   the card -> ``mnist/sign1024x1`` with the golden reference weights ->
   encrypt a batch of synthetic images (numpy seed 1) -> encrypted forward
   (timed after two one-image warm-up forwards, whose times are printed: the
   first pays the process's start-up on the card) -> decrypt.  The launch
   counters are zeroed just before and read just after; the run fails
   unless the NTT kernel prepared the key and the blind-rotation kernel ran
   every PBS chunk.  The key prepared through the NTT twin must equal the
   kernel's, and the forward through the plain twins, on the first and the
   last image, must be bit-identical.  Argmax agreement with the plaintext
   oracle is printed for information: the real mod-switch noise flips
   near-boundary signs.
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
6. The command line, in process (``cli.main``), at ``small_v2``: ``keygen``
   into ``build/smoke_cli``, ``encrypt-image`` of a written ``image.ptxt``,
   ``run-encrypted`` (its JSON line: bootstraps, K4 launches, seconds),
   ``decrypt-image``, ``stats``, ``ptxt`` on a CSV of the slice's images.
   The score ciphertexts ``run-encrypted`` wrote must be bit-identical to
   the library path's on the same ciphertext file, the class
   ``decrypt-image`` prints must be their argmax, and ``python -m
   redsec_tpu_torch decrypt-image`` in a subprocess must print it too.
7. ``cifar/binarynet`` at full width, one image (numpy seed 1), through the
   command line at ``small_v2_tpu`` with its trained weights and calibration
   (``nets_trained/cifar/binarynet``): the forward must report the JAX
   package's choice for it (staged), run
   exactly 521,216 bootstraps in 1,018 blind-rotation launches (counted at
   the kernel's door and by the counters), and its K4 share of the wall time
   is read from CUDA events around each launch.  The decrypted argmax is
   printed beside the plaintext oracle's, for information.
8. This slice's paths, ``mnist/sign1024x1`` at full width on the 8 images:
   the command line (keygen, encrypt-image, run-encrypted, decrypt-image)
   at ``small_v2_n2048`` and at ``small``, the score ciphertexts
   bit-identical to the library path's and the printed classes their
   argmax; bundled ``small_v2_tpu``, ``small_v2_tpu2`` and ``small_v2_n2048``
   keys through the library path (launch counts exact, agreement with the
   oracle printed);
   escalation: ``calibrate --escalate 1 --majority-plan 0:3`` (layer 1's
   signs through a same-seed ``small_v2_n2048`` key, layer 0's voted at
   k = 3), ``run-encrypted`` refusing it without ``--eval2`` and running it
   with, launches counted at the kernels' doors by key, the score
   ciphertexts bit-identical to the library path's.
9. ``utils.debug.layerwise_compare`` on sign1024x1, printed.  At
   ``small_v2_noiseless`` (``small_v2``'s shape with no sampled noise; four
   images) every leveled stage (conv, sumpool, bias) must equal the
   plaintext oracle exactly.  At ``small_v2_tpu`` (one image) a decrypted sum
   of noisy samples may round a few units off, so every leveled stage's
   largest distance from the oracle must stay inside the parameters' noise
   band (``noise_band_units``: five sigma of the mod-switch error), as must
   the pre-activation of every sign that flipped, at both sets.
10. Probe entry points: ``redsec_tpu_torch.scripts.bench_rotate`` and
   ``bench_schoolbook`` run through their ``main`` with the counters zeroed
   before; every candidate is checked equal inside them, and the run fails
   unless each probe kernel was launched as often as the scripts call it.
11. The schoolbook sets (no NTT primes, N >= 4096), through the schoolbook
   round kernel (S1-fft, ``csrc/schoolbook_fft.cu``: the whole CMUX round,
   one launch a round, on the key's prepared spectra); S1
   (``csrc/schoolbook.cu``), which the paths ran before, stays checked and
   timed beside it:
   - S1 (int8 tensor cores, ``wgmma`` u8 x s8) against its twin (a
     float64 FFT product) on random digits and key rows, each shape with its
     set's Bg/2: N 4096 with 6 and 8 digit rows (``medium``, ``medium_v2``),
     N 8192 with 6 and 8 (``large``, ``large_v2``), N 1024 with 12 and 20
     and N 256 with 20 (forced ``small_v2_tpu``, ``small_v2``,
     ``test_noiseless``), at batches 1, 4, 8, 9, 17, 33, 70, 196 and 512
     (the tile edges) and the full-width path's; then at extreme inputs
     (digits -Bg/2 and Bg/2 - 1, keys -2^31, -1, 0, 2^31 - 1 at N 8192).
     Timed at 512 at each N >= 1024 and rows, and at the path's batches;
     the twin timed beside it at ``medium_v2``'s [512, 8, 4096].  Its
     ``bound_ms`` is the smallest of three formulations' times: the exact
     float64 FFTs of its twin (``schoolbook_fft_flops`` at ``fp64_ms``), the
     int8 tensor-core MACs of the limb formulation S1 runs, and the int32
     multiply-adds of one CUDA-core MAC a tap (each beside it).  Registers and spills of every instance from the
     compiler's report.
   - S1-fft against its twin (the same twisted float64 transforms in torch,
     ``kernels.schoolbook_round_plain``) and against one round of S1 with its
     torch glue, bit for bit: ``medium``, ``medium_v2``, ``large``,
     ``large_v2``, ``small_v2_tpu`` and ``small_v2`` at batches 1, 4, 196,
     512 and 513 (and the path's at ``medium_v2``), at 4 with the digits at
     their worst-case norm (every digit -Bg/2), at 4 and 513 in place.
     Timed in turns with S1 alone and S1 with its glue (glue, kernel, S1,
     kernel, glue) at 512 at the four sets and at a gate's 4 at
     ``medium_v2``.  Each launched instance's cluster (blocks,
     ciphertexts), registers and spills from the compiler's report.  Its ``bound_ms`` is the larger of its bytes (acc read
     and written, the round's spectra) and its twisted-transform flops
     (``bound_twisted_fp64_ms``): the transforms at the least published
     flop count (``fft_flops``) and the fp64 vector rate, the
     multiply-accumulate at DMMA's rate (at the vector rate beside it, and
     the 2N-FFT count beside that).  At ``medium_v2`` at 4 and 512 each
     round's host microseconds a call and its traced device time; and the
     rounds' loop of the paths (``kernels.schoolbook_rounds``, n launches
     from one C loop) at a gate's 4 with n cut to 16, bit-identical to its
     twin's loop and counted 16 times, its events a round beside the
     device's.
   - The forced-schoolbook PBS (``prepare_cloud_key(..., schoolbook=True)``)
     bit-identical to K4's PBS on the ``small_v2_tpu`` key of phase 4 (real
     noise, n = 350), on 64 ciphertexts: 350 S1-fft launches.
   - ``medium``, ``large``, ``large_v2`` at full N and n cut to 16 (keys from
     ``keygen`` with real noise): the PBS of 8 ciphertexts through S1-fft
     bit-identical to the same PBS through its twin on the card; each key's
     a-priori rounding bound printed.
   - The full-width path: the README's client/server flow through the CLI
     at ``medium_v2`` (n 3072, N 4096, Bg 2^8, l 4, key switch 2 x 16) on
     one ``sign1024x1`` image: keygen, encrypt-image, run-encrypted,
     decrypt-image.  Exactly 1,220 PBS in 3 chunks of 3,072 S1-fft launches
     (none of S1), counted at the rounds' door (``schoolbook_rounds``, each
     call's rounds) and by the counters; 8 of
     layer 0's ciphertexts through the twin path on the card (3,072 rounds of
     the torch transforms) bit-identical to the kernel path's outputs for
     them; the printed class their argmax, and beside it the plaintext
     oracle's (informational).  With ``--profile``, the path's first
     512-chunk through the CLI's bootstrap traced once: device busy time,
     idle share, S1-fft's share and that of the torch glue around it.
   - ``GateSet`` on the card: the truth tables of the ten two-input gates
     and MUX at ``small_v2_tpu`` (K4), and AND at full ``medium_v2`` on the
     path's key (S1-fft, its n rounds from one C loop,
     ``kernels.schoolbook_rounds``): the AND's wall in ms beside its rounds'
     device time (one traced call) and the idle share.

12. ``phase12``: the calibration knobs through the command line, the
   agreement forecast beside a measured run, the "matmul" key flavour and the
   dp/tp forwards and poly-sharded PBS in an NCCL group of one rank.  The
   "matmul" path: ``sign1024x1`` at ``small_v2_tpu``, batch 8, full width,
   through K4-mm exactly as often as K4 runs on the radix-2 path (20
   launches, counted at the kernel's door and by the counters) and K4
   never, bit-identical to K4's forward; a 512-chunk PBS through K4-mm timed
   beside K4's in the same process; the same forward with
   ``round_kernel="full"`` and ``"partial"`` (the JAX package's
   ``REDSEC_ROUND_KERNEL=1`` / ``=partial``): 20 chunks x 350 rounds = 7,000
   launches of K3-mm (K2-mm) counted at the door and by the counters, no
   blind-rotation kernel, scores bit-identical to K4's; one image through
   ``run-encrypted --ntt-flavor matmul`` at ``small_v2``, whose score file
   must equal the ``--ntt-flavor radix2`` run's, and again with
   ``--round-kernel full``, each run's launches exact at the door.
13. ``phase13``: the BYON trainers and the native oracle.
   - The sign trainer at full ``cifar/binarynet`` on 100 synthetic images
     (numpy seed 1): one loss and gradient without noise on the card against
     the CPU's (loss within 1e-5 relative, each gradient within 1e-4 of its
     largest entry); 20 steps on the card, timed; every conv and FC sum of
     the trained net on the card an integer; export, ``weight_convert``,
     ``prep_model``, and the export's plaintext logits on the card equal to
     the CPU's.  The twin's agreement with the plaintext engine and its least
     |v| are printed: they hang on float rounding at near-tied boundaries.
   - The relu trainer at full ``mnist/relu1024x1`` on 64 synthetic ternary
     images, 20 steps on the card; the exported engine's logits equal to the
     float64 hard walk's (``logits_bit_exact``); calibrated on 16 other
     images, 8 images encrypted at ``small_v2_tpu`` through K4, every launch
     counted at the kernel's door and by the counters; the decrypted argmax
     against the plaintext engine printed.
   - The native CGGI core (``redsec_tpu_torch/native``) built with g++ on the
     chip's host: 64 PBS on the phase-4 key, bit-identical to K4's, its PBS/s
     and OpenMP threads beside K4's.
   - ``entry(device="cuda")``: the scores' shape.
14. ``phase14``: the JAX package's batch runner and validation scripts, ported
   (``redsec_tpu_torch/scripts/``).
   - ``run_encrypted_mnist`` at full width: ``mnist/sign1024x1``, golden
     weights, ``small_v2_tpu`` keys generated into ``build/smoke_runner``,
     batches of 8 from a synthetic 24-row CSV in the reference's layout
     (numpy seed 1).  16 images with a checkpoint; extended to 24 (exactly one
     new batch: its K4 launches at the door, twice with the warm-up pass, the
     old batches' predictions unchanged); batch 8 deleted from the file and
     run again (equal); ``--eval-offset 8 --images 8`` (batch 8's
     predictions); ``--input-gain`` against the file (refused: "different
     configuration").  Path ``runner/sign1024x1``; seconds a batch and PBS/s.
   - ``validate_noise_budget --quick --count 96 --seed 0``: every
     experiment's sigma, mean, decode errors and verdict equal, to the printed
     digits, the JAX run's table in ``results/noise_budget_validation.log``
     (native engine, same count and seed); each experiment's 96 PBS one K4
     launch at the door.  Paths ``noise/<experiment>``, counted with
     ``small_v2``'s records (``small_v2_tpu``'s for ``tpu2/total``: the
     same instance, two primes at N 1024).
   - ``validate_full_geometry`` at full-n ``medium``, 32 PBS (seed 0): its
     RESULT equals ``results/full_geometry_validation.log:26`` but for
     ``boots_per_s``; 3,072 S1-fft launches of 32 at the door; 4 outputs
     through the twin path on the card bit-identical.  Path ``fullgeo/medium``; host
     keygen, key preparation and PBS times.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside this file, the script exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import inspect
import io
import json
import os
import re
import shutil
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
# int8 tensor-core multiply-accumulates a second (1,979 dense int8 TOPS, two
# operations a MAC): the bound of the JAX package's int8 schoolbook product
PEAK_INT8_MACS = 1979e12 / 2
# float64 flops a second outside the tensor cores (data sheet: 34 TFLOP/s;
# 132 SMs x 64 fp64 lanes x 2 x 1.98 GHz), and on them (DMMA; data sheet:
# 67 TFLOP/s): the bounds of the schoolbook product through exact float64
# transforms, the formulation of its plain twin and of the round kernel
PEAK_FP64_FLOPS = 132 * 64 * 2 * 1.98e9
PEAK_FP64_TENSOR_FLOPS = 67e12
BATCH = 8  # images in the slice phase


def ms_text(v, digits: int = 4) -> str:
    """A device time for a line of output: ``"not measured"`` where the
    profiler's traces came up short (``device.device_ms``)."""
    return "not measured" if v is None else f"{v:.{digits}f} ms"


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
    """One ciphertext's external product over `rows` digit rows (3 * 2l for a
    bundled round): per prime, `rows` forward and 8 inverse transforms, the
    row MAC (multiply + add per product), then the CRT (about 6 operations a
    value a prime beyond the first) and the limb recombination (2)."""
    per_prime = (rows + 8) * ntt_ops(N) + 2 * rows * 8 * N
    return primes * per_prime + 8 * N * (6 * (primes - 1) + 2)


def cmux_ops(rows: int, N: int, primes: int = 2, bundle: int = 1) -> int:
    """One CMUX round: rotate-diff (2N), decompose (3 per digit), external
    product, accumulate (2N).  A bundled round (two key bits) makes three
    differences from four rotations (8N) and contracts 3 * rows digit rows."""
    if bundle == 2:
        return 8 * N + 9 * rows * N + ext_product_ops(3 * rows, N, primes) + 2 * N
    return 2 * N + 3 * rows * N + ext_product_ops(rows, N, primes) + 2 * N


def mm_transform_ops(N: int) -> int:
    """The int32 operations of one four-step transform outside the tensor
    cores (N = R x 128), counted as ``ntt_ops`` counts: the negacyclic
    R-point NTT of each of the 128 columns (R/2 log2 R butterflies of one
    multiply, one add and one subtract), the twiddle (N multiplies) and the
    recombination of the three limb accumulators (two multiplies and two
    adds an output)."""
    R = N // 128
    return 3 * (R // 2) * (R.bit_length() - 1) * 128 + N + 4 * N


def mm_ext_product_ops(rows: int, N: int, primes: int = 2) -> int:
    """``ext_product_ops`` with the four-step transform's int32 work."""
    per_prime = (rows + 8) * mm_transform_ops(N) + 2 * rows * 8 * N
    return primes * per_prime + 8 * N * (6 * (primes - 1) + 2)


def mm_ext_product_macs(rows: int, N: int, primes: int = 2) -> int:
    """int8 tensor-core MACs of one external product's C-steps: (rows + 8) R
    rows of 128 against a [128, 128] table a prime, four limb products."""
    return primes * (rows + 8) * N * 128 * 4


def four_step_bound_ms(calls: int, rows: int, N: int, round_: bool) -> float:
    """The least time of ``calls`` external products (CMUX rounds with
    ``round_``) in the four-step formulation the kernels of csrc/blind_mm.cu
    run: its int8 MACs at the tensor cores' rate plus its int32 operations
    at the CUDA cores' (the two are taken as not overlapping)."""
    ops = mm_ext_product_ops(rows, N) + (4 * N + 3 * rows * N if round_ else 0)
    return calls * (mm_ext_product_macs(rows, N) / PEAK_INT8_MACS + ops / PEAK_INT32_OPS) * 1e3


def schoolbook_ops(B: int, rows: int, N: int) -> int:
    """The schoolbook product on the CUDA cores: every digit tap against
    every key coefficient of both polynomials, one int32 multiply-add (one
    instruction, counted as one operation) each."""
    return B * 2 * rows * N * N


def schoolbook_int8_macs(B: int, rows: int, N: int, half_bg: int) -> int:
    """The same product as the JAX package's int8 convolution: 8 output
    channels (2 polynomials x 4 key limbs) x rows x N taps x N outputs, once
    per 8-bit digit limb (two where Bg/2 > 128)."""
    return B * 8 * rows * (1 if half_bg <= 128 else 2) * N * N


def fft_flops(M: int) -> int:
    """Real flops of one complex DFT of length M = 2^k at the least count
    published for a power of two: Johnson and Frigo's modified split radix
    ("A modified split-radix FFT with fewer arithmetic operations", IEEE
    Trans. Signal Process. 55 (2007)), 34/9 M k - 124/27 M - 2 k
    - 2/9 (-1)^k k + 16/27 (-1)^k + 8.  Split radix (4 M k - 6 M + 8) and
    radix 2 (5 M k) lie above it; so does every pass of the round kernel."""
    k = M.bit_length() - 1
    s = (-1) ** k
    return round((102 * M * k - 124 * M - 54 * k - 6 * s * k + 16 * s + 216) / 27)


def schoolbook_fft_flops(B: int, rows: int, N: int) -> tuple[int, int]:
    """The same product through float64 FFTs of length L = 2N, as its plain
    twin (``kernels.schoolbook_product_plain``) computes it exactly, as
    (transform flops, multiply-accumulate flops): a real forward transform
    of every digit row and of the key's 4 sign-balanced 16-bit halves a row,
    and B x 4 real inverse transforms, a real transform taken as half a
    complex one (``fft_flops``); B x rows x 4 x (N + 1) complex
    multiply-adds of 8 flops.  The fold, rounding and recombination (a few
    operations an output) are not counted."""
    L = 2 * N
    return (B * rows + 4 * rows + 4 * B) * fft_flops(L) // 2, 8 * B * rows * 4 * (N + 1)


def schoolbook_round_flops(B: int, rows: int, N: int) -> tuple[int, int]:
    """One schoolbook CMUX round as the round kernel computes it
    (``csrc/schoolbook_fft.cu``), as (transform flops, multiply-accumulate
    flops): the twisted transforms of length M = N / 2, rows forward and 4
    inverse a ciphertext (``fft_flops``), their twist or untwist (one
    complex product, 6 flops, a value), and the multiply-accumulate of every
    digit spectrum into 4 spectra (8 flops a complex multiply-add).  The
    key's spectra are prepared once a key and not counted; nor are the
    digits, rounding and recombination (integer work of a few operations a
    coefficient)."""
    M = N // 2
    return B * (rows + 4) * (fft_flops(M) + 6 * M), B * 8 * 4 * rows * M


def fp64_ms(flops: tuple[int, int], mac_rate: float | None = None) -> float:
    """The least time of (transform flops, multiply-accumulate flops): the
    transforms at the vector rate, the multiply-accumulate at ``mac_rate``,
    by default the faster of the vector and the DMMA rate (for each bin it
    is a [B x rows] x [rows x 4] complex matrix product, which DMMA runs);
    the two taken as not overlapping."""
    rate = max(PEAK_FP64_FLOPS, PEAK_FP64_TENSOR_FLOPS) if mac_rate is None else mac_rate
    return (flops[0] / PEAK_FP64_FLOPS + flops[1] / rate) * 1e3


def schoolbook_round_bytes(B: int, rows: int, N: int) -> int:
    """Bytes a round must move: acc read and written (int32 [B, 2, N] each),
    the exponents, and the round's key spectra (complex128 [rows, 2, 2, N/2])
    read once."""
    return 2 * B * 2 * N * 4 + B * 4 + rows * 4 * (N // 2) * 16


def bound(bytes_: float, ops: float) -> tuple[float, str]:
    tb, to = bytes_ / PEAK_BYTES * 1e3, ops / PEAK_INT32_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def ptxas_usage(ptxas: str, entry: str) -> tuple[int, int]:
    """Registers a thread and bytes spilled (stores + loads) that ``nvcc
    -Xptxas -v`` reports for the kernel whose mangled name contains ``entry``."""
    lines = ptxas.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and entry in line:
            block = "\n".join(lines[i:i + 5])
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
            if regs and spill:
                return int(regs.group(1)), int(spill.group(1)) + int(spill.group(2))
    fail(f"the compiler's report has no entry for {entry}")


def profile_forward(fwd, ct, card: str, tag: str, warmup=None) -> tuple:
    """Device time by kernel over one traced forward, and the share of the
    forward's wall time in which the device ran no kernel.  With ``warmup``
    the tracer starts one step early, as in ``device.device_ms``: a step
    running ``warmup()``, whose events it drops, then the forward.  Returns
    (wall ms, device busy ms, [(kernel, device ms, launches)])."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    sched = None if warmup is None else schedule(wait=0, warmup=1, active=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=sched) as prof:
        if warmup is not None:
            warmup()
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        fwd(ct)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's entry repeats the time of the
    # kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    with open(os.path.join(OUT_DIR, f"profile_{tag}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    print(f"profile {tag}: forward wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.4f} on {card}", flush=True)
    for key, ms, count in rows[:8]:
        print(f"  {ms:10.3f} ms {100 * ms / busy_ms:6.2f}% x{count:<6d} {key[:90]}")
    return wall_ms, busy_ms, rows


# --------------------------------------------------------------------------- #


def free_port() -> int:
    """A TCP port on localhost that no process holds (for the process
    group's rendezvous)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase12(c: dict) -> None:
    """Phase 12: the calibration knobs through the CLI, the agreement
    forecast, the "matmul" key flavour and the torch.distributed paths, at
    ``c["P"]`` (small_v2_tpu on the card) on the device ``c["dev"]``.

    ``c`` holds: the device, parameters, host keys (``sk``, ``cloud``) and
    the radix-2 key prepared from them (``dkey``); the sign net's plan and
    weights (``mplan``, ``weights``), its images, their raw pixels and the
    oracle's predictions (``images``, ``raw``, ``preds``); the relu net's
    raw pixels (``rraw``); ``run_cli``, a work directory, the card's line,
    the batch and PBS chunk, and the ``by_path`` / ``slices`` records it adds
    to.  Every path's launch counts are zeroed just before it and read just
    after."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from redsec_tpu_torch.crypto import bootstrap as bs
    from redsec_tpu_torch.crypto import kernels as K
    from redsec_tpu_torch.crypto.params import get_params
    from redsec_tpu_torch.device import launches
    from redsec_tpu_torch.formats import keys as kio
    from redsec_tpu_torch.formats.image_io import pixel_transform_for, write_image_ptxt
    from redsec_tpu_torch.models.spec import prep_model
    from redsec_tpu_torch.models.zoo import get_model
    from redsec_tpu_torch.parallel import mesh as pm
    from redsec_tpu_torch.parallel import ntt_shard as pns
    from redsec_tpu_torch.runtime import calibration, ptxt
    from redsec_tpu_torch.runtime.encrypted import (
        build_encrypted_forward, decrypt_scores, encrypt_images,
    )
    from redsec_tpu_torch.runtime.ranges import calibrate_ranges
    from redsec_tpu_torch.scripts import predict_agreement
    from redsec_tpu_torch.utils.metrics import StageTimer, model_stats, summarize

    P, dev, sk, cloud, dkey = c["P"], c["dev"], c["sk"], c["cloud"], c["dkey"]
    mplan, weights, images, raw, preds = (c["mplan"], c["weights"], c["images"], c["raw"],
                                          c["preds"])
    run_cli, card, batch, pbs_chunk = c["run_cli"], c["card"], c["batch"], c["pbs_chunk"]
    by_path, slices = c["by_path"], c["slices"]
    work = c["work"]
    os.makedirs(work, exist_ok=True)
    timer = StageTimer()
    rec = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def k4_launches(sizes):
        return sum(len(range(0, b, pbs_chunk)) for b in sizes if b)

    # -- the calibration knobs through the CLI: relu1024x1, batch 8, calibrated
    # on 16 other thinned synthetic images with --no-center, then with
    # --gain-mode max; run-encrypted --calib applies what each file records
    relu_name = "mnist/relu1024x1"
    relu_w = os.path.join(HERE, "nets_trained", "mnist", "relu1024x1", "var_prep.dat")
    kio.save_secret_key(os.path.join(work, "secret.key.npz"), sk)
    kio.save_cloud_key(os.path.join(work, "eval.key.npz"), cloud)
    crng = np.random.default_rng(12)
    craw = crng.integers(0, 256, size=(16, 28, 28, 1)) * (crng.random((16, 28, 28, 1)) < 0.19)
    ccsv, ecsv = os.path.join(work, "relu_calib.csv"), os.path.join(work, "relu_eval.csv")
    rplan0 = prep_model(get_model(relu_name), relu_w)
    rpreds = ptxt.predict(rplan0, pixel_transform_for(relu_name)(c["rraw"]), device=dev.type)
    for path, rows, labels in ((ccsv, craw, [0] * 16), (ecsv, c["rraw"], rpreds)):
        with open(path, "w") as f:
            for label, img in zip(labels, rows):
                f.write(f"{int(label)}," + ",".join(str(int(v)) for v in img.reshape(-1)) + "\n")
    for tag, flags, env in (("no_center", ["--no-center"], {"REDSEC_CENTER": "0"}),
                            ("gain_max", ["--gain-mode", "max"], {"REDSEC_GAIN_MODE": "max"})):
        cal = os.path.join(work, f"relu_{tag}.npz")
        run_cli("calibrate", "--model", relu_name, "--weights", relu_w, "--csv", ccsv,
                "--rows", "0:16", "--params", P.name, "--input-gain", *flags, "--out", cal,
                "--device", dev.type)
        rplan = prep_model(get_model(relu_name), relu_w)
        meta = calibration.load_calibration(cal, rplan)
        opts = calibration.options_from_meta(meta)
        if meta["env"] != {"REDSEC_INPUT_GAIN": "1", **env}:
            fail(f"knobs/{tag}: the calibration records {meta['env']}")
        lfwd = build_encrypted_forward(rplan, dkey, **opts)
        info = lfwd.info
        if tag == "no_center" and any(r.center is not None for r in info.values()):
            fail(f"knobs/{tag}: --no-center resolved a relu or final-layer center")
        run_cli("encrypt-image", "--secret", os.path.join(work, "secret.key.npz"), "--csv", ecsv,
                "--rows", f"0:{batch}", "--model", relu_name, "--calib", cal,
                "--out", os.path.join(work, "relu.ctxt.npz"))
        launches.reset()
        _, rrec = run_cli("run-encrypted", "--model", relu_name, "--weights", relu_w,
                          "--eval", os.path.join(work, "eval.key.npz"),
                          "--image", os.path.join(work, "relu.ctxt.npz"), "--calib", cal,
                          "--out", os.path.join(work, "relu.out.npz"), "--device", dev.type)
        sync()
        rcounts = dict(launches.counts)
        by_path[f"knobs/{tag}"] = (P.name, rcounts)
        # the full-range relu dispatches its layer three times
        mult = [3 if info[i].relu_mode == "full" else 1 for i in range(len(rplan.layers))]
        sizes = [st.bootstraps * batch for st in model_stats(rplan)]
        want = sum(k4_launches([b]) * m for b, m in zip(sizes, mult))
        if dev.type == "cuda" and (rrec["k4_launches"], rcounts.get("blind_rotate")) != (want,
                                                                                         want):
            fail(f"knobs/{tag}: run-encrypted reports {rrec}, counters {rcounts}; expected "
                 f"{want} K4 launches")
        if rrec["pbs"] != sum(b * m for b, m in zip(sizes, mult)):
            fail(f"knobs/{tag}: {rrec['pbs']} PBS reported for {sizes} x {mult}")
        lct = kio.load_ciphertexts(os.path.join(work, "relu.ctxt.npz"))[0]
        lout = lfwd(torch.as_tensor(lct.reshape(-1, 28, 28, 1, lct.shape[-1]), device=dev))
        if not np.array_equal(lout.cpu().numpy(),
                              kio.load_ciphertexts(os.path.join(work, "relu.out.npz"))[0]):
            fail(f"knobs/{tag}: the score ciphertexts run-encrypted wrote differ from the "
                 f"library path's under the same options")
        rscores = decrypt_scores(sk, lout, P, lfwd.out_gain, lfwd.out_center)
        ragree = float((rscores.argmax(axis=1) == rpreds).mean())
        gains = {i: (r.in_gain, r.out_gain) for i, r in info.items()}
        print(f"knobs/{tag}: calibrate {' '.join(flags)} recorded {meta['env']}; gains {gains}, "
              f"relu modes { {i: r.relu_mode for i, r in info.items() if r.relu_mode} }; "
              f"run-encrypted --calib {rrec['pbs']} PBS in {rrec['seconds']:.3f} s, "
              f"{rrec['pbs_per_s']:.2f} PBS/s, launches {rcounts}, scores bit-identical to the "
              f"library path's; argmax agreement with the plaintext oracle {ragree:.3f} "
              f"(informational) on {card}", flush=True)
        rec[f"knobs/{tag}"] = {**rrec, "env": meta["env"], "gains": gains,
                               "argmax_agreement": ragree}
    timer.mark("knobs")

    # -- the agreement forecast beside a measured run of the same
    # configuration: sign1024x1 calibrated on the slice's images, input gain
    refdir = os.path.join(work, "reference")
    os.makedirs(os.path.join(refdir, "nets", "mnist"))
    with open(os.path.join(refdir, "nets", "mnist", "mnist_data.csv"), "w") as f:
        for label, img in zip(preds, raw):
            f.write(f"{int(label)}," + ",".join(str(int(v)) for v in img.reshape(-1)) + "\n")
    launches.reset()
    forecast = predict_agreement.main(["--model", "mnist/sign1024x1", "--varprep", weights,
                                       "--reference", refdir, "--images", str(batch),
                                       "--params", P.name, "--trials", "5", "--per-layer",
                                       "--input-gain", "--device", dev.type])
    if dict(launches.counts):
        fail(f"predict_agreement launched kernels: {dict(launches.counts)}")
    cplan = prep_model(get_model("mnist/sign1024x1"), weights)
    calibrate_ranges(cplan, images, device=dev.type)
    cfwd = build_encrypted_forward(cplan, dkey, input_gain=True)
    cct = encrypt_images(sk, images, P, np.random.default_rng(13), gain=cfwd.in_gain)
    launches.reset()
    cout = cfwd(cct)
    sync()
    by_path["calibrated/sign1024x1"] = (P.name, dict(launches.counts))
    cscores = decrypt_scores(sk, cout, P, cfwd.out_gain, cfwd.out_center)
    measured = float((cscores.argmax(axis=1) == preds).mean())
    print(f"predict_agreement sign1024x1 at {P.name}, {batch} images, input gain, 5 trials: "
          f"forecast agreement {forecast['agreement_mean']:.4f} (min "
          f"{forecast['agreement_min']:.4f}), per-layer flip rates "
          f"{forecast['layer_flip_rates']}; measured on the card, same calibration: "
          f"{measured:.4f} ({forecast['seconds']} s for the forecast)", flush=True)
    rec["predict_agreement"] = {"forecast": forecast, "measured_agreement": measured}
    del cfwd, cout
    timer.mark("forecast")

    # -- the "matmul" key flavour: prepared from the same raw key; sign1024x1
    # at batch 8 through it, every PBS chunk through K4-mm (csrc/blind_mm.cu)
    # exactly as often as K4 runs on the radix-2 path and K4 never, counted at
    # the kernel's door and by the counters, bit-identical to K4's forward;
    # then one 512-chunk of PBS timed beside K4's, the outputs bit-identical
    sync()
    t0 = time.perf_counter()
    mkey = bs.prepare_cloud_key(cloud, device=dev.type, ntt_flavor="matmul")
    sync()
    t_mprep = time.perf_counter() - t0
    mfwd = build_encrypted_forward(mplan, mkey)
    kfwd = build_encrypted_forward(mplan, dkey)
    mct = encrypt_images(sk, images, P, np.random.default_rng(14), gain=mfwd.in_gain)
    want_k4 = k4_launches([s.bootstraps * batch for s in model_stats(mplan)])
    mdoor = [0]

    def door_mm(*args, _real=K.blind_rotate_mm):
        mdoor[0] += 1
        return _real(*args)

    kout = kfwd(mct)
    launches.reset()
    sync()
    t0 = time.perf_counter()
    with mock.patch.object(K, "blind_rotate_mm", door_mm):
        mout = mfwd(mct)
    sync()
    t_mfwd = time.perf_counter() - t0
    mcounts = dict(launches.counts)
    by_path["matmul/sign1024x1"] = (P.name, mcounts)
    if dev.type == "cuda" and (mdoor[0], mcounts.get("blind_rotate_mm"),
                               mcounts.get("blind_rotate", 0)) != (want_k4, want_k4, 0):
        fail(f"matmul/sign1024x1: {mdoor[0]} K4-mm calls at the door, counters {mcounts}; "
             f"expected {want_k4} of blind_rotate_mm (K4's count on the radix-2 path) and "
             f"no blind_rotate")
    if not torch.equal(mout, kout):
        fail("matmul/sign1024x1: the 'matmul' key's forward differs from K4's")
    print(f"matmul/sign1024x1 ({P.name}): {batch} images x "
          f"{summarize(mplan)['total_bootstraps']} PBS in {t_mfwd:.3f} s through K4-mm, "
          f"{mdoor[0]} launches at the door, counters {mcounts}; bit-identical to K4's "
          f"forward on {card}", flush=True)
    try:  # a 'matmul' key never reaches the radix-2 K4
        K.blind_rotate(torch.zeros((1, 2, P.N), dtype=torch.int32, device=dev),
                       torch.zeros((1, P.n), dtype=torch.int32, device=dev), mkey.bk, P,
                       mkey.plan)
        fail("the radix-2 blind-rotation kernel took a 'matmul' key")
    except ValueError:
        pass
    crng = np.random.default_rng(15)
    vals = crng.integers(-P.msg_space // 2, P.msg_space // 2, size=pbs_chunk)
    from redsec_tpu_torch.crypto import lwe

    ct512 = torch.as_tensor(lwe.encrypt_integers(sk.lwe_key, vals, P, crng), device=dev)
    tv = bs.const_test_vector(P, 1, P.msg_space)
    mpbs, kpbs = bs.make_batched_bootstrap(mkey), bs.make_batched_bootstrap(dkey)
    times = {}
    outs = {}
    for name, fn in (("k4", kpbs), ("matmul", mpbs), ("matmul2", mpbs), ("k4_2", kpbs)):
        sync()
        t0 = time.perf_counter()
        outs[name] = fn(ct512, tv)
        sync()
        times[name] = (time.perf_counter() - t0) * 1e3
    if not all(torch.equal(outs["k4"], o) for o in outs.values()):
        fail("matmul: the 'matmul' key's 512-chunk PBS differs from K4's")
    k4_ms, mm_ms = min(times["k4"], times["k4_2"]), min(times["matmul"], times["matmul2"])
    print(f"matmul/{P.name}: key prepared on the card in {t_mprep:.3f} s (the four-step "
          f"NTT in torch); a {pbs_chunk}-chunk PBS through K4-mm {mm_ms:.3f} ms against "
          f"K4's {k4_ms:.3f} ms in the same process ({mm_ms / k4_ms:.3f}x), outputs "
          f"bit-identical (host clock around a synchronize: {times}) on {card}", flush=True)
    rec["matmul"] = {"prepare_s": t_mprep, f"forward_{batch}_images_s": t_mfwd,
                     "k4mm_launches": mdoor[0], "pbs_512_ms": mm_ms, "k4_512_ms": k4_ms,
                     "ms": times}

    # -- the JAX package's per-round path (REDSEC_ROUND_KERNEL=1 / =partial)
    # as round_kernel="full" / "partial": the same forward on the same key
    # and ciphertexts, each blind rotation n launches of K3-mm (K2-mm and the
    # torch round around it), counted at the kernel's door and by the
    # counters, no K4-mm; the scores bit-identical to K4's forward
    for rk, kname in (("full", "cmux_round_mm"), ("partial", "external_product_mm")):
        rfwd = build_encrypted_forward(mplan, mkey, round_kernel=rk)
        rdoor = [0]

        def door_rk(*args, _real=getattr(K, kname), **kw):
            rdoor[0] += 1
            return _real(*args, **kw)

        launches.reset()
        sync()
        t0 = time.perf_counter()
        with mock.patch.object(K, kname, door_rk):
            rout = rfwd(mct)
        sync()
        t_rfwd = time.perf_counter() - t0
        rcounts = dict(launches.counts)
        by_path[f"round_{rk}/sign1024x1"] = (P.name, rcounts)
        want_rk = want_k4 * P.n
        if dev.type == "cuda" and (rdoor[0], rcounts.get(kname), rcounts.get("blind_rotate_mm", 0),
                                   rcounts.get("blind_rotate", 0)) != (want_rk, want_rk, 0, 0):
            fail(f"round_{rk}/sign1024x1: {rdoor[0]} {kname} calls at the door, counters "
                 f"{rcounts}; expected {want_rk} ({want_k4} chunks x {P.n} rounds) and no "
                 "blind rotation kernel")
        if not torch.equal(rout, kout):
            fail(f"round_{rk}/sign1024x1: the round_kernel={rk!r} forward differs from K4's")
        print(f"round_kernel={rk!r}/sign1024x1 ({P.name}): {batch} images x "
              f"{summarize(mplan)['total_bootstraps']} PBS in {t_rfwd:.3f} s (K4-mm's forward "
              f"{t_mfwd:.3f} s), {rdoor[0]} {kname} launches at the door, counters {rcounts}; "
              f"scores bit-identical to K4's and K4-mm's forward on {card}", flush=True)
        rec["matmul"][f"round_{rk}_forward_{batch}_images_s"] = t_rfwd
        rec["matmul"][f"round_{rk}_launches"] = rdoor[0]
        del rfwd, rout
    del mfwd, mout, kout, mct

    # -- one image through the CLI at small_v2 (the CLI's default set), with
    # --ntt-flavor radix2 and then matmul on the same key and ciphertext
    # files: the score files equal; each run's launches exact at the door
    cdir = os.path.join(work, "cli_matmul")
    run_cli("keygen", "--params", "small_v2", "--seed", 0, "--out-dir", cdir)
    write_image_ptxt(os.path.join(cdir, "image.ptxt"), 0, raw[0])
    run_cli("encrypt-image", "--secret", os.path.join(cdir, "secret.key.npz"),
            "--image-ptxt", os.path.join(cdir, "image.ptxt"),
            "--out", os.path.join(cdir, "image.ctxt.npz"))
    want1 = sum(len(range(0, s.bootstraps, pbs_chunk)) for s in model_stats(mplan)
                if s.bootstraps)
    cli_rec = {}
    for flavor, counter, key in (("radix2", "blind_rotate", "k4_launches"),
                                 ("matmul", "blind_rotate_mm", "k4mm_launches")):
        door = {"blind_rotate": 0, "blind_rotate_mm": 0}

        def at_door(name, real):
            def call(*args):
                door[name] += 1
                return real(*args)
            return call

        launches.reset()
        with mock.patch.object(K, "blind_rotate", at_door("blind_rotate", K.blind_rotate)), \
                mock.patch.object(K, "blind_rotate_mm", at_door("blind_rotate_mm",
                                                                 K.blind_rotate_mm)):
            _, crec = run_cli("run-encrypted", "--model", "mnist/sign1024x1", "--weights",
                              weights, "--eval", os.path.join(cdir, "eval.key.npz"),
                              "--image", os.path.join(cdir, "image.ctxt.npz"),
                              "--out", os.path.join(cdir, f"out_{flavor}.ctxt.npz"),
                              "--ntt-flavor", flavor)
        sync()
        counts = dict(launches.counts)
        by_path[f"cli_{flavor}/sign1024x1"] = ("small_v2", counts)
        other = "blind_rotate" if flavor == "matmul" else "blind_rotate_mm"
        if dev.type == "cuda" and (crec[key], door[counter], counts.get(counter), door[other],
                                   counts.get(other, 0)) != (want1, want1, want1, 0, 0):
            fail(f"cli_{flavor}/sign1024x1: run-encrypted reports {crec}, {door} calls at the "
                 f"doors, counters {counts}; expected {want1} of {counter} and none of {other}")
        cli_rec[flavor] = crec
        print(f"cli_{flavor}/sign1024x1 (small_v2, --ntt-flavor {flavor}): {crec['pbs']} PBS "
              f"in {crec['seconds']:.3f} s, {door[counter]} {counter} launches at the door, "
              f"counters {counts} on {card}", flush=True)
    a = np.load(os.path.join(cdir, "out_radix2.ctxt.npz"))
    b = np.load(os.path.join(cdir, "out_matmul.ctxt.npz"))
    if sorted(a.files) != sorted(b.files) or any(not np.array_equal(a[k], b[k])
                                                 for k in a.files):
        fail("cli_matmul/sign1024x1: the score file of --ntt-flavor matmul differs from "
             "the radix2 run's")
    print("cli_matmul/sign1024x1: --ntt-flavor matmul wrote the radix2 run's score file, "
          "bit for bit", flush=True)
    # the same with --round-kernel full: n K3-mm launches a chunk at 20 digit
    # rows, counted at the door and in the JSON line, the same score file
    rdoor = [0]

    def door_k3(*args, _real=K.cmux_round_mm, **kw):
        rdoor[0] += 1
        return _real(*args, **kw)

    launches.reset()
    with mock.patch.object(K, "cmux_round_mm", door_k3):
        _, crec = run_cli("run-encrypted", "--model", "mnist/sign1024x1", "--weights", weights,
                          "--eval", os.path.join(cdir, "eval.key.npz"),
                          "--image", os.path.join(cdir, "image.ctxt.npz"),
                          "--out", os.path.join(cdir, "out_round.ctxt.npz"),
                          "--ntt-flavor", "matmul", "--round-kernel", "full")
    sync()
    counts = dict(launches.counts)
    by_path["cli_round_full/sign1024x1"] = ("small_v2", counts)
    want_r = want1 * get_params("small_v2").n
    if dev.type == "cuda" and (crec["k3mm_launches"], rdoor[0], counts.get("cmux_round_mm"),
                               crec["k4mm_launches"]) != (want_r, want_r, want_r, 0):
        fail(f"cli_round_full/sign1024x1: run-encrypted reports {crec}, {rdoor[0]} calls at "
             f"the door, counters {counts}; expected {want_r} of cmux_round_mm and no K4-mm")
    b = np.load(os.path.join(cdir, "out_round.ctxt.npz"))
    if sorted(a.files) != sorted(b.files) or any(not np.array_equal(a[k], b[k])
                                                 for k in a.files):
        fail("cli_round_full/sign1024x1: the score file of --round-kernel full differs from "
             "the radix2 run's")
    cli_rec["round_full"] = crec
    print(f"cli_round_full/sign1024x1 (small_v2, --ntt-flavor matmul --round-kernel full): "
          f"{crec['pbs']} PBS in {crec['seconds']:.3f} s, {rdoor[0]} K3-mm launches at the door "
          f"({crec['k3mm_launches']} in its JSON line), the radix2 run's score file on {card}",
          flush=True)
    rec["cli_matmul"] = cli_rec
    timer.mark("matmul")

    # -- torch.distributed at world size 1 on this device's backend (NCCL on
    # the card): dp and tp forwards of sign1024x1 at batch 8 and the
    # poly-sharded PBS, each bit-identical to the single-device path
    pm.init_distributed(f"tcp://localhost:{free_port()}", 1, 0, device=dev.type)
    try:
        backend = dist.get_backend()
        mesh = pm.make_mesh(dev, tp=1)
        # the first collective sets the communicator up: outside the timed spans
        pm.all_reduce_int32(torch.zeros(1, dtype=torch.int32, device=dev), mesh.tp_group)
        pm.all_reduce_int32(torch.zeros(1, dtype=torch.int32, device=dev))
        bct = encrypt_images(sk, images, P, np.random.default_rng(16), gain=kfwd.in_gain)
        sync()
        t0 = time.perf_counter()
        want = kfwd(bct)
        sync()
        t_single = time.perf_counter() - t0
        per = summarize(mplan)["total_bootstraps"]
        want_k4 = k4_launches([s.bootstraps * batch for s in model_stats(mplan)])
        dist_rec = {"backend": backend, "world_size": dist.get_world_size(),
                    "single_forward_s": t_single}
        for tag, build in (("dp", pm.build_dp_encrypted_forward),
                           ("tp", pm.build_tp_encrypted_forward)):
            fwd = build(mplan, dkey, mesh)
            launches.reset()
            sync()
            t0 = time.perf_counter()
            got = pm.gather_ciphertext_batch(fwd(pm.shard_ciphertext_batch(bct, mesh)), mesh)
            sync()
            dt = time.perf_counter() - t0
            counts = dict(launches.counts)
            by_path[f"{tag}/sign1024x1"] = (P.name, counts)
            if not torch.equal(got, want):
                fail(f"{tag}/sign1024x1 ({backend}, world 1): differs from the single-device "
                     f"forward")
            if dev.type == "cuda" and counts.get("blind_rotate") != want_k4:
                fail(f"{tag}/sign1024x1: {counts} launches, expected {want_k4} of K4")
            print(f"{tag}/sign1024x1 ({backend}, world size 1): {batch} images x {per} PBS in "
                  f"{dt:.3f} s ({batch * per / dt:.2f} PBS/s) against the single-device "
                  f"forward's {t_single:.3f} s, bit-identical, launches {counts} on {card}",
                  flush=True)
            dist_rec[f"{tag}_forward_s"] = dt
        launches.reset()
        poly = pns.make_poly_sharded_bootstrap(mkey, mesh)
        sync()
        t0 = time.perf_counter()
        pout = poly(ct512, tv)
        sync()
        t_poly = time.perf_counter() - t0
        if not torch.equal(pout, outs["matmul"]):
            fail(f"poly-sharded PBS ({backend}, world 1) differs from the single-device one")
        if dict(launches.counts):
            fail(f"the poly-sharded PBS launched kernels: {dict(launches.counts)}")
        print(f"poly-sharded PBS ({backend}, world size 1, sp 1): {pbs_chunk} ciphertexts in "
              f"{t_poly * 1e3:.1f} ms against the single-device 'matmul' PBS's {mm_ms:.1f} ms, "
              f"bit-identical on {card}", flush=True)
        dist_rec["poly_pbs_512_ms"] = t_poly * 1e3
        rec["distributed"] = dist_rec
    finally:
        dist.destroy_process_group()
    timer.mark("distributed")
    rec["stages_s"] = dict(timer.stages)
    slices["phase12"] = rec
    print("phase 12 stages:\n" + timer.report(), flush=True)
    shutil.rmtree(work)


# phase 13's workloads: (model, synthetic images); the native oracle's batch
TRAIN_SIGN = ("cifar/binarynet", 100)
TRAIN_RELU = ("mnist/relu1024x1", 64)
NATIVE_BATCH = 64


def phase13(c: dict) -> None:
    """Phase 13: the BYON trainers on the card, trained weights through K4,
    the native CGGI oracle beside K4 and ``entry()``, at ``c["P"]``
    (small_v2_tpu) on the device ``c["dev"]``.

    ``c`` holds the device, parameters, host keys (``sk``, ``cloud``), the
    radix-2 key prepared from them (``dkey``), the card's line, the PBS
    chunk and the ``by_path`` / ``slices`` records it adds to.  Only what is
    deterministic is asserted: integer sums, the export's plaintext logits on
    both devices, the float64 relu walk against the integer engine, bit
    identity of two PBS implementations and launch counts.  The sign twin's
    agreement with the plaintext engine hangs on float rounding at near-tied
    boundaries and is printed."""
    import numpy as np
    import torch

    from redsec_tpu_torch import native
    from redsec_tpu_torch.compiler import train as tr
    from redsec_tpu_torch.compiler import train_relu as trr
    from redsec_tpu_torch.crypto import bootstrap as bs
    from redsec_tpu_torch.crypto import kernels as K
    from redsec_tpu_torch.crypto import lwe
    from redsec_tpu_torch.device import launches
    from redsec_tpu_torch.entry import entry
    from redsec_tpu_torch.formats.image_io import pixel_transform_for
    from redsec_tpu_torch.models.spec import prep_model
    from redsec_tpu_torch.models.zoo import get_model
    from redsec_tpu_torch.runtime import ptxt
    from redsec_tpu_torch.runtime.encrypted import (
        build_encrypted_forward, decrypt_scores, encrypt_images,
    )
    from redsec_tpu_torch.runtime.ranges import calibrate_ranges
    from redsec_tpu_torch.utils.metrics import StageTimer, model_stats

    P, dev, sk, cloud, dkey = c["P"], c["dev"], c["sk"], c["cloud"], c["dkey"]
    card, pbs_chunk, by_path, slices = c["card"], c["pbs_chunk"], c["by_path"], c["slices"]
    cpu = torch.device("cpu")
    timer = StageTimer()
    rec = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # -- a. the sign trainer at full width on synthetic images (numpy seed 1)
    name, count = TRAIN_SIGN
    spec = get_model(name)
    d = spec.input_dims
    rng = np.random.default_rng(1)
    px = pixel_transform_for(name)(rng.integers(0, 256, size=(count, d.h, d.w, d.in_dep)))
    labels = rng.integers(0, spec.layers[-1].out_depth, size=count)
    cfg = tr.TrainConfig(steps=20, log_every=10)
    params0 = tr.init_params(spec, cfg.seed)

    def loss_and_grads(device):
        forward, geom = tr.build_twin(spec)
        tp = tr.to_torch(params0, device, requires_grad=True)
        onehot = torch.nn.functional.one_hot(torch.as_tensor(labels, device=device),
                                             geom[-1]["shape"][3]).to(torch.float32)
        loss, _ = tr.sign_loss(forward, tp, torch.as_tensor(px, device=device), onehot, cfg)
        grads = torch.autograd.grad(loss, [t for p in tp for t in p.values()])
        return float(loss.detach()), [g.cpu() for g in grads]

    l_dev, g_dev = loss_and_grads(dev)
    sync()
    t0 = time.perf_counter()
    l_cpu, g_cpu = loss_and_grads(cpu)
    t_cpu = time.perf_counter() - t0
    if abs(l_dev - l_cpu) > 1e-5 * abs(l_cpu):
        fail(f"phase 13 train/{name}: loss without noise {l_dev} on {dev}, {l_cpu} on the CPU")
    grad_err = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(g_dev, g_cpu)]
    if max(grad_err) > 1e-4 or not all(bool(b.abs().max() > 0) for b in g_cpu):
        fail(f"phase 13 train/{name}: gradients on {dev} differ from the CPU's by "
             f"{grad_err} of their largest entries")
    sync()
    t0 = time.perf_counter()
    params, hist = tr.train(spec, px, labels, cfg, device=dev.type)
    sync()
    t_train = time.perf_counter() - t0
    sums = tr.stats_pass(spec, params, px, device=dev.type)
    if not all(torch.equal(s, torch.round(s)) for s, _, _ in sums):
        fail(f"phase 13 train/{name}: a conv or FC sum on {dev} is not an integer")
    raw, prep, report = tr.export_and_check(spec, params, hist, px, labels, device=dev.type)
    plan = prep_model(spec, prep)
    logits_dev = ptxt.build_forward(plan, dev.type)(px).cpu()
    logits_cpu = ptxt.build_forward(plan, "cpu")(px)
    if not torch.equal(logits_dev, logits_cpu):
        fail(f"phase 13 train/{name}: the export's plaintext logits on {dev} differ from "
             f"the CPU's")
    min_v = min(report["min_abs_margin"])
    print(f"train/{name}: {count} synthetic images, one loss and gradient without noise on "
          f"the card within {max(grad_err):.3e} of the CPU's (largest entries; loss "
          f"{l_dev:.6f} against {l_cpu:.6f}, CPU {t_cpu:.2f} s); {cfg.steps} steps in "
          f"{t_train:.3f} s ({t_train / cfg.steps:.4f} s a step, {cfg.steps / t_train:.3f} "
          f"steps/s) on {card}; every conv/FC sum integral; export -> weight_convert -> "
          f"prep_model, plaintext logits on the card equal the CPU's; twin against plaintext "
          f"agreement {report['twin_vs_ptxt_agreement']:.4f}, min |v| {min_v:.4g} "
          f"(informational)", flush=True)
    rec[f"train/{name}"] = {"images": count, "steps": cfg.steps, "train_s": t_train,
                            "s_per_step": t_train / cfg.steps, "loss_dev": l_dev,
                            "loss_cpu": l_cpu, "grad_err": grad_err,
                            "agreement": report["twin_vs_ptxt_agreement"], "min_abs_v": min_v}
    del sums, logits_dev, logits_cpu, g_dev, g_cpu
    timer.mark("sign trainer")

    # -- b. the relu trainer at full width, then the trained net through K4
    name, count = TRAIN_RELU
    spec = get_model(name)
    d = spec.input_dims
    rng = np.random.default_rng(2)

    def ternary(k):
        raw_px = rng.integers(0, 256, size=(k, d.h, d.w, d.in_dep))
        return pixel_transform_for(name)(raw_px * (rng.random(raw_px.shape) < 0.19))

    px, cal = ternary(count), ternary(16)
    labels = rng.integers(0, spec.layers[-1].out_depth, size=count)
    rcfg = trr.ReluTrainConfig(steps=20, log_every=10)
    sync()
    t0 = time.perf_counter()
    params, hist = trr.train_relu(spec, px, labels, rcfg, device=dev.type)
    sync()
    t_relu = time.perf_counter() - t0
    raw, prep, rreport = trr.export_and_check_relu(spec, params, hist, px, labels,
                                                  device=dev.type)
    if not rreport["logits_bit_exact"]:
        fail(f"phase 13 train/{name}: the exported engine's logits differ from the float64 "
             f"hard walk")
    plan = prep_model(spec, prep)
    calibrate_ranges(plan, cal, device=dev.type)
    fwd = build_encrypted_forward(plan, dkey, input_gain=True)
    batch = 8
    ct = torch.as_tensor(encrypt_images(sk, px[:batch], P, np.random.default_rng(3),
                                        gain=fwd.in_gain), device=dev)
    door = [0]

    def door_k4(*args, _real=K.blind_rotate):
        door[0] += 1
        return _real(*args)

    launches.reset()
    sync()
    t0 = time.perf_counter()
    with mock.patch.object(K, "blind_rotate", door_k4):
        out = fwd(ct)
    sync()
    t_enc = time.perf_counter() - t0
    counts = dict(launches.counts)
    by_path[f"trained/{name}"] = (P.name, counts)
    mult = [3 if fwd.info[i].relu_mode == "full" else 1 for i in range(len(plan.layers))]
    sizes = [st.bootstraps * batch for st in model_stats(plan)]
    want = sum(len(range(0, b, pbs_chunk)) * m for b, m in zip(sizes, mult) if b)
    if (door[0], counts.get("blind_rotate", 0)) != (want, want if dev.type == "cuda" else 0):
        fail(f"phase 13 trained/{name}: {door[0]} K4 calls at the door, counters {counts}; "
             f"expected {want}")
    scores = decrypt_scores(sk, out, P, fwd.out_gain, fwd.out_center)
    agree = float((scores.argmax(axis=1) == ptxt.predict(plan, px[:batch],
                                                         device=dev.type)).mean())
    pbs = sum(b * m for b, m in zip(sizes, mult))
    print(f"train/{name}: {count} synthetic images, {rcfg.steps} steps in {t_relu:.3f} s "
          f"({t_relu / rcfg.steps:.4f} s a step) on {card}; logits_bit_exact; calibrated on 16 "
          f"other images (input gain {fwd.in_gain}, relu "
          f"{sorted({r.relu_mode for r in fwd.info.values() if r.relu_mode})}); {batch} images "
          f"encrypted at {P.name}: {pbs} PBS in {t_enc:.3f} s, {door[0]} K4 launches at the "
          f"door, counters {counts}; decrypted argmax agreement with the plaintext engine "
          f"{agree:.3f} (informational)", flush=True)
    rec[f"train/{name}"] = {"images": count, "steps": rcfg.steps, "train_s": t_relu,
                            "s_per_step": t_relu / rcfg.steps, "encrypted_s": t_enc,
                            "pbs": pbs, "k4_launches": door[0], "argmax_agreement": agree}
    del fwd, out, ct
    timer.mark("relu trainer and K4")

    # -- c. the native oracle on this host beside K4, on the smoke's key
    t0 = time.perf_counter()
    lib = native.build()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = native.NativeEngine(cloud)
    t_engine = time.perf_counter() - t0
    rng = np.random.default_rng(4)
    vals = rng.integers(-P.msg_space // 2, P.msg_space // 2, size=NATIVE_BATCH)
    ct = lwe.encrypt_integers(sk.lwe_key, vals, P, rng)
    tv = bs.const_test_vector(P, 1, P.msg_space)
    t0 = time.perf_counter()
    nout = eng.bootstrap(ct, tv)
    t_native = time.perf_counter() - t0
    eng.close()
    pbs_fn = bs.make_batched_bootstrap(dkey)
    tct = torch.as_tensor(ct, device=dev)
    pbs_fn(tct, tv)  # the first call at this batch pays the setup
    launches.reset()
    sync()
    t0 = time.perf_counter()
    kout = pbs_fn(tct, tv)
    sync()
    t_k4 = time.perf_counter() - t0
    by_path[f"native/{P.name}"] = (P.name, dict(launches.counts))
    if not np.array_equal(nout, kout.cpu().numpy()):
        diff = np.argwhere(nout != kout.cpu().numpy())
        fail(f"phase 13 native/{P.name}: the native PBS differs from K4's at {len(diff)} "
             f"positions, first {diff[0].tolist()}")
    threads = native.num_threads()
    print(f"native/{P.name}: built in {t_build:.1f} s ({os.path.relpath(lib, HERE)}), engine "
          f"(BK to NTT domain, primes {eng.primes}) in {t_engine:.2f} s; {NATIVE_BATCH} PBS "
          f"in {t_native:.3f} s on {threads} OpenMP threads ({NATIVE_BATCH / t_native:.2f} "
          f"PBS/s), bit-identical to K4's {NATIVE_BATCH} in {t_k4 * 1e3:.3f} ms "
          f"({NATIVE_BATCH / t_k4:.1f} PBS/s) on {card}", flush=True)
    rec[f"native/{P.name}"] = {"build_s": t_build, "engine_s": t_engine, "pbs": NATIVE_BATCH,
                               "native_s": t_native, "native_pbs_per_s": NATIVE_BATCH / t_native,
                               "threads": threads, "k4_s": t_k4,
                               "k4_pbs_per_s": NATIVE_BATCH / t_k4}
    timer.mark("native oracle")

    # -- d. entry(): the small encrypted forward and its arguments
    launches.reset()
    fn, args = entry(device=dev.type)
    eout = fn(*args)
    sync()
    by_path["entry"] = ("test_noiseless", dict(launches.counts))
    if tuple(eout.shape) != (4, 10, 65):
        fail(f"phase 13 entry: scores of shape {tuple(eout.shape)}")
    print(f"entry(device={dev.type!r}): scores {tuple(eout.shape)}, launches "
          f"{dict(launches.counts)}", flush=True)
    timer.mark("entry")
    rec["stages_s"] = dict(timer.stages)
    slices["phase13"] = rec
    print("phase 13 stages:\n" + timer.report(), flush=True)


# phase 14: the runner's CSV rows and images a batch; the logs of the JAX
# package's runs that those scripts must reproduce
RUNNER_ROWS, RUNNER_BATCH = 24, 8
NOISE_LOG = os.path.join(HERE, "results", "noise_budget_validation.log")
FULLGEO_LOG, FULLGEO_LINE = os.path.join(HERE, "results", "full_geometry_validation.log"), 26
NOISE_ROW = re.compile(r"^(\S+/\S+)\s+[\d.]+\s+([\d.]+)\s+[\d.]+\s+([+-][\d.]+)\s+(\d+)\s+"
                       r"(PASS|FAIL)\b")


def logged_noise_rows(path: str) -> dict:
    """{experiment: (sigma, mean, decode errors, verdict)} of the table in a
    log of the JAX package's ``validate_noise_budget``, as printed."""
    with open(path) as f:
        return {m[1]: (m[2], m[3], int(m[4]), m[5])
                for m in map(NOISE_ROW.match, f) if m}


def phase14(c: dict) -> None:
    """Phase 14: the batch runner with its checkpoint, and the noise-budget
    and full-geometry scripts, on the card.

    ``c`` holds the card's line, the sign net's plan and weights (``mplan``,
    ``weights``), the PBS chunk, a work directory (removed at the end) and the
    ``by_path`` / ``slices`` records it adds to.  Every script runs in
    process through its ``main`` or its function, with the blind rotation
    (K4) and the schoolbook round (S1-fft) wrapped at their doors; the runner's
    keys are generated into the work directory."""
    import ast

    import numpy as np
    import torch

    from redsec_tpu_torch.crypto import kernels as K
    from redsec_tpu_torch.crypto.params import MEDIUM, SMALL_V2
    from redsec_tpu_torch.crypto.params import SMALL_V2_TPU as P
    from redsec_tpu_torch.device import launches
    from redsec_tpu_torch.formats import keys as kio
    from redsec_tpu_torch.scripts import run_encrypted_mnist as runner
    from redsec_tpu_torch.scripts import validate_full_geometry as vfg
    from redsec_tpu_torch.scripts import validate_noise_budget as vnb
    from redsec_tpu_torch.utils.metrics import StageTimer, model_stats

    card, pbs_chunk, by_path, slices = c["card"], c["pbs_chunk"], c["by_path"], c["slices"]
    work = c["work"]
    shutil.rmtree(work, ignore_errors=True)
    keys = os.path.join(work, "keys")
    os.makedirs(keys)
    timer = StageTimer()
    rec = {}
    k4_door, r_door = [], []

    def door_k4(acc0, *rest, _real=K.blind_rotate):
        k4_door.append(acc0.shape[0])
        return _real(acc0, *rest)

    def door_round(acc, ts, *rest, _real=K.schoolbook_rounds):
        # one call carries a PBS's rounds: each round's batch at the door
        r_door.extend([acc.shape[0]] * ts.shape[0])
        return _real(acc, ts, *rest)

    # -- a. the runner: mnist/sign1024x1 at small_v2_tpu on a synthetic
    # 24-row CSV in the reference's layout (numpy seed 1), batches of 8
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 256, size=(RUNNER_ROWS, 28 * 28))
    labels = rng.integers(0, 10, size=RUNNER_ROWS)
    os.makedirs(os.path.join(work, "nets", "mnist"))
    with open(os.path.join(work, "nets", "mnist", "mnist_data.csv"), "w") as f:
        f.writelines(f"{lb}," + ",".join(map(str, px)) + "\n" for lb, px in zip(labels, raw))
    ck = os.path.join(work, "run.ckpt.json")
    base = ["--model", c["mplan"].spec.name, "--varprep", c["weights"], "--params", P.name,
            "--batch", RUNNER_BATCH, "--reference", work]
    per_batch = sum(len(range(0, st.bootstraps * RUNNER_BATCH, pbs_chunk))
                    for st in model_stats(c["mplan"]) if st.bootstraps)

    def run(tag, *argv):
        """The runner's ``main``; -> (its dict, its output, K4 launches at
        the door).  Its lines go to chiprun_out/runner_<tag>.txt."""
        k4_door.clear()
        buf = io.StringIO()
        with mock.patch.object(kio, "keyset_dir", lambda base=None: keys), \
                mock.patch.object(K, "blind_rotate", door_k4), contextlib.redirect_stdout(buf):
            res = runner.main([str(a) for a in (*base, *argv)])
        torch.cuda.synchronize()
        text = buf.getvalue()
        with open(os.path.join(OUT_DIR, f"runner_{tag}.txt"), "w") as f:
            f.write(text)
        print(f"runner/{tag}: " + " | ".join(text.splitlines()[-2:]), flush=True)
        if res["launches"]["blind_rotate"] != len(k4_door):
            fail(f"runner/{tag}: the runner counts {res['launches']} K4 launches, the door "
                 f"{len(k4_door)}")
        return res, text, len(k4_door)

    def batches():
        with open(ck) as f:
            return json.load(f)["batches"]

    launches.reset()
    res16, _, n16 = run("16", "--images", 16, "--checkpoint", ck)
    b16 = batches()
    if sorted(b16) != ["0", "8"] or n16 != 3 * per_batch:
        fail(f"runner/16: batches {sorted(b16)}, {n16} K4 launches at the door; expected 0 "
             f"and 8 in 3 x {per_batch} (the warm-up pass and two batches)")
    res24, text, n24 = run("24", "--images", 24, "--checkpoint", ck)
    b24 = batches()
    if ("extended 16 -> 24 images" not in text or res24["batches_run"] != [16]
            or n24 != 2 * per_batch or any(b24[k]["preds"] != b16[k]["preds"] for k in b16)):
        fail(f"runner/24: ran batches {res24['batches_run']} in {n24} K4 launches at the door "
             f"(expected [16] in 2 x {per_batch}, the old batches unchanged)")
    with open(ck) as f:
        state = json.load(f)
    del state["batches"]["8"]
    with open(ck, "w") as f:
        json.dump(state, f)
    resr, text, nr = run("resume", "--images", 24, "--checkpoint", ck)
    b_r = batches()
    if resr["batches_run"] != [8] or nr != 2 * per_batch or b_r["8"]["preds"] != b16["8"]["preds"]:
        fail(f"runner/resume: batch 8 dropped and run again gives {b_r['8']['preds']} (was "
             f"{b16['8']['preds']}), batches {resr['batches_run']} in {nr} K4 launches")
    reso, text, no = run("offset", "--images", 8, "--eval-offset", 8, "--time-mode", "cold")
    if (f"encrypted preds: {b16['8']['preds']}" not in text or no != per_batch
            or reso["fingerprint"].get("eval_offset") != 8):
        fail(f"runner/offset: --eval-offset 8 gives {reso['preds']} in {no} K4 launches; batch 8 "
             f"of the checkpoint is {b16['8']['preds']} ({per_batch} launches)")
    try:
        run("refused", "--images", 24, "--checkpoint", ck, "--input-gain")
        refusal = None
    except SystemExit as exc:
        refusal = str(exc.code)
    if refusal is None or "different configuration" not in refusal or k4_door:
        fail(f"runner/refused: --input-gain against the checkpoint exits with {refusal!r} after "
             f"{len(k4_door)} K4 launches")
    torch.cuda.synchronize()
    by_path["runner/sign1024x1"] = (P.name, dict(launches.counts))
    s_batch = res16["s_per_image"] * RUNNER_BATCH
    print(f"runner/sign1024x1 at {P.name}: 16 images, resumed to 24, batch 8 dropped and run "
          f"again, --eval-offset 8, --input-gain refused; {per_batch} K4 launches a batch at the "
          f"door, twice with the warm-up pass; launches {dict(launches.counts)}; "
          f"{s_batch:.3f} s a batch of {RUNNER_BATCH}, {res16['bootstraps_per_s']:.1f} PBS/s, "
          f"oracle agreement {res16['oracle_agreement']:.3f} (informational) on {card}",
          flush=True)
    rec["runner/sign1024x1"] = {"params": P.name, "batch": RUNNER_BATCH,
                                "s_per_batch": s_batch, "s_per_image": res16["s_per_image"],
                                "pbs_per_s": res16["bootstraps_per_s"],
                                "k4_launches_per_batch": per_batch,
                                "oracle_agreement": res16["oracle_agreement"]}
    timer.mark("runner")

    # -- b. the noise-budget script, --quick --count 96 --seed 0, against the
    # JAX run's table (native engine, same count and seed)
    want = logged_noise_rows(NOISE_LOG)
    per_exp = {}

    def counted(p, n, *rest, _real=vnb.measure):
        k4_door.clear()
        launches.reset()
        out = _real(p, n, *rest)
        torch.cuda.synchronize()
        per_exp[p.name] = (dict(launches.counts), list(k4_door))
        return out

    buf = io.StringIO()
    with mock.patch.object(vnb, "measure", counted), \
            mock.patch.object(K, "blind_rotate", door_k4), contextlib.redirect_stdout(buf):
        nres = vnb.main(["--quick", "--count", "96", "--seed", "0"])
    print(buf.getvalue(), end="", flush=True)
    for row in nres["rows"]:
        counts, door = per_exp[row["params"]]
        got = (f"{row['sigma']:.4f}", f"{row['mean']:+.3f}", row["errors"],
               "PASS" if row["ok"] else "FAIL")
        if got != want.get(row["label"]):
            fail(f"noise/{row['label']}: sigma, mean, errors, verdict {got} on the card; the "
                 f"JAX run logged {want.get(row['label'])} ({os.path.relpath(NOISE_LOG, HERE)})")
        if door != [row["count"]] or counts.get("blind_rotate") != 1:
            fail(f"noise/{row['label']}: {door} ciphertexts at K4's door, counters {counts}; "
                 f"expected one launch of {row['count']}")
        pn = "small_v2_tpu2" if row["label"].startswith("tpu2") else SMALL_V2.name
        by_path[f"noise/{row['label']}"] = (pn, counts)
    if nres["result"]["experiments"] != len(want) or nres["result"]["fail"]:
        fail(f"noise: {nres['result']} against the log's {len(want)} experiments")
    rec["noise"] = {r["label"]: {k: r[k] for k in ("sigma", "mean", "errors", "pbs_s")}
                    for r in nres["rows"]}
    print(f"noise: {len(nres['rows'])} experiments equal the JAX run's sigma, mean and decode "
          f"errors to the printed digits ({os.path.relpath(NOISE_LOG, HERE)}); each PBS of "
          f"96 one K4 launch at the door", flush=True)
    timer.mark("noise budget")

    # -- c. full-n medium, 32 PBS through the schoolbook round kernel, against
    # the JAX run's RESULT
    with open(FULLGEO_LOG) as f:
        line = f.read().splitlines()[FULLGEO_LINE - 1]
    want = ast.literal_eval(line.split("RESULT ", 1)[1])
    r_door.clear()
    launches.reset()
    with mock.patch.object(K, "schoolbook_rounds", door_round):
        g = vfg.validate(MEDIUM, 32, 0, "cuda")
    torch.cuda.synchronize()
    counts = dict(launches.counts)
    by_path["fullgeo/medium"] = (MEDIUM.name, counts)
    got = {k: v for k, v in g["result"].items() if k != "boots_per_s"}
    if got != {k: v for k, v in want.items() if k != "boots_per_s"}:
        fail(f"fullgeo/medium: RESULT {g['result']} on the card; the JAX run logged {want} "
             f"({os.path.relpath(FULLGEO_LOG, HERE)}:{FULLGEO_LINE})")
    if r_door != [32] * MEDIUM.n or counts.get("schoolbook_round") != MEDIUM.n:
        fail(f"fullgeo/medium: {len(r_door)} schoolbook round launches at the door (batches "
             f"{sorted(set(r_door))}), counters {counts}; expected {MEDIUM.n} of 32")
    arr = g["arrays"]
    t0 = time.perf_counter()
    with mock.patch.object(K, "schoolbook_rounds", K.schoolbook_rounds_plain):
        twin = g["pbs"](arr["ct"][:4], arr["tv"])
    t_twin = time.perf_counter() - t0
    if not np.array_equal(twin, arr["out"][:4]):
        fail("fullgeo/medium: 4 outputs through the twin path differ from the kernel's")
    rec["fullgeo/medium"] = {**g["result"], "keygen_s": g["keygen_s"],
                             "prepare_s": g["prepare_s"], "pbs_s": g["pbs_s"],
                             "round_launches": len(r_door), "twin_check_s": t_twin}
    print(f"fullgeo/medium: RESULT equals {os.path.relpath(FULLGEO_LOG, HERE)}:{FULLGEO_LINE} "
          f"(boots_per_s aside); host keygen {g['keygen_s']:.1f} s, key preparation "
          f"{g['prepare_s']:.1f} s, 32 PBS in {g['pbs_s']:.3f} s ({32 / g['pbs_s']:.2f} PBS/s, "
          f"{len(r_door)} round launches at the door) on {card}; 4 outputs through the twin path "
          f"({MEDIUM.n} rounds, {t_twin:.1f} s) bit-identical", flush=True)
    del g, twin
    torch.cuda.empty_cache()
    shutil.rmtree(work)
    timer.mark("full geometry")
    rec["stages_s"] = dict(timer.stages)
    slices["phase14"] = rec
    print("phase 14 stages:\n" + timer.report(), flush=True)


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

    from redsec_tpu_torch import cli
    from redsec_tpu_torch.crypto import bootstrap as bs
    from redsec_tpu_torch.crypto import kernels as K
    from redsec_tpu_torch.crypto import keygen as kg
    from redsec_tpu_torch.crypto import probe_kernels as PK
    from redsec_tpu_torch.crypto.params import SMALL_V2 as P2
    from redsec_tpu_torch.crypto.params import SMALL_V2_NOISELESS as PQ
    from redsec_tpu_torch.crypto.params import SMALL_V2_TPU as P
    from redsec_tpu_torch.crypto.params import get_params
    from redsec_tpu_torch.device import cuda_ms, device_ms, host_us, launches
    from redsec_tpu_torch.formats import keys as kio
    from redsec_tpu_torch.formats.image_io import pixel_transform_for, write_image_ptxt
    from redsec_tpu_torch.models.spec import prep_model
    from redsec_tpu_torch.models.zoo import get_model
    from redsec_tpu_torch.models.spec import Activation
    from redsec_tpu_torch.runtime import calibration, ptxt
    from redsec_tpu_torch.runtime.encrypted import (
        build_encrypted_forward, decrypt_scores, encrypt_images, majority_ks,
    )
    from redsec_tpu_torch.runtime.ranges import resolve_pbs_ranges
    from redsec_tpu_torch.scripts import bench_rotate, bench_schoolbook
    from redsec_tpu_torch.utils.debug import LEVELED, format_reports, layerwise_compare
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
    sources = [K.SOURCE, K.MM_SOURCE, PK.SOURCE, K.SCHOOLBOOK_SOURCE, K.SBFFT_SOURCE]
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        ptxas = "".join(pool.map(lambda src: K.build_library(src, force=True), sources))
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
    t_kernels = time.perf_counter()
    gen = np.random.default_rng(7)
    rec = {}

    def report(name, shape, err, ms, plain_ms, bytes_, ops, replaces, source="pbs.cu",
               library_ms=None, ops_ms=None, **extra):
        # ops_ms: the least time of the operations where the function has a
        # cheaper formulation than the kernel's own instruction count
        b_ms, b_by = bound(bytes_, ops) if ops_ms is None else max(
            (bytes_ / PEAK_BYTES * 1e3, "bytes"), (ops_ms, "operations"))
        rec[name] = dict(name=name, route="cuda", source=f"redsec_tpu_torch/csrc/{source}",
                         replaces=replaces, launches=0, max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=library_ms, shape=shape, **extra)
        lib = "" if library_ms is None else (
            f", one PyTorch call {library_ms:.4f} ms, on the device alone "
            f"{ms_text(extra['library_device_ms'])}")
        if "device_ms" in extra:
            lib += (f"; the kernel on the device alone {ms_text(extra['device_ms'])} (profiler "
                    f"traces taken again: {extra['profiler_retries']})")
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

    def check_key(tag, cloud, dkey):
        """K1 at exactly the shapes a key's preparation launches it: the key
        prepared through the kernel must equal, bit for bit, the key prepared
        with the plain twin in its place."""
        rounds = dkey.bk.shape[1]
        rows_k = sorted({min(key_chunk, rounds - i) * dkey.bk.shape[2] * dkey.bk.shape[3]
                         for i in range(0, rounds, key_chunk)}, reverse=True)
        with mock.patch.object(K, "ntt", K.ntt_plain):
            pkey = bs.prepare_cloud_key(cloud, device="cuda")
        if not torch.equal(pkey.bk, dkey.bk):
            fail(f"{tag}: the key prepared through the ntt kernel differs from the plain one")
        print(f"key {tag}: prepared through the ntt kernel at rows {rows_k} x primes "
              f"{list(dkey.plan.primes)}, bit-identical to the plain preparation", flush=True)

    # K1: both primes, forward and inverse, at every row count of key preparation
    err = 0
    for M1 in ntt_rows:
        for pi, p in enumerate(plan.primes):
            x = ri(0, p, (M1, N))
            for inv in (False, True):
                err = max(err, same(
                    f"ntt [{M1}, {N}] prime {p} inverse={inv}",
                    K.ntt(x, plan, pi, inverse=inv), K.ntt_plain(x, plan, pi, inverse=inv)))
    # and at the three primes of small (40961 above 2^15), at its key's rows
    PS = get_params("small")
    plan_s = bs.bootstrap_plan(PS)
    M1s = min(key_chunk, PS.n) * PS.decomp_rows * 2 * bs.BK_LIMBS
    for pi, p in enumerate(plan_s.primes):
        x = ri(0, p, (M1s, N))
        x[0, :8] = p - 1
        for inv in (False, True):
            err = max(err, same(f"ntt [{M1s}, {N}] prime {p} inverse={inv}",
                                K.ntt(x, plan_s, pi, inverse=inv),
                                K.ntt_plain(x, plan_s, pi, inverse=inv)))
    M1 = ntt_rows[0]
    x0 = ri(0, plan.primes[0], (M1, N))
    ms = cuda_ms(lambda: K.ntt(x0, plan, 0), 20)
    pms = cuda_ms(lambda: K.ntt_plain(x0, plan, 0), 5)
    xw = ri(0, plan_s.primes[2], (M1, N))
    ms_w = cuda_ms(lambda: K.ntt(xw, plan_s, 2), 20)
    # the launch path: each wrapper's host microseconds a call at its shape here
    launch_us = {"ntt": host_us(lambda: K.ntt(x0, plan, 0))}
    # every set of the paths at N = 1024 (the bundled keys' too)
    report("ntt", [M1, N], err, ms, pms, 2 * M1 * N * 4, M1 * ntt_ops(N),
           "redsec_tpu/crypto/pallas_ntt.py:147", host_us=launch_us["ntt"],
           params=(P.name, P2.name, PS.name, f"{P.name}/bundle2", "small_v2_tpu2/bundle2",
                   "small_v2_tpu2"),
           primes=sorted(set(plan.primes) | set(plan_s.primes)), ms_prime40961=ms_w)
    print(f"kernel ntt [{M1}, {N}] at prime {plan_s.primes[2]}: {ms_w:.4f} ms", flush=True)

    # K2 and K3 on M = 64, with round 0's slice of the prepared key
    M = 64
    bk0 = dkey.bk[:, 0].contiguous()
    digits = ri(-P.half_bg, P.half_bg, (M, rows, N))
    err = same("external_product", K.external_product(digits, bk0, plan),
               K.external_product_plain(digits, bk0, plan))
    ms = cuda_ms(lambda: K.external_product(digits, bk0, plan), 20)
    pms = cuda_ms(lambda: K.external_product_plain(digits, bk0, plan), 3)
    dev2, _, _, re2 = device_ms(lambda: K.external_product(digits, bk0, plan),
                                "external_product_kernel", required=False)
    launch_us["external_product"] = host_us(lambda: K.external_product(digits, bk0, plan))
    report("external_product", [M, rows, N], err, ms, pms,
           digits.numel() * 4 + bk0.numel() * 2 + M * 2 * N * 4,
           M * ext_product_ops(rows, N), "redsec_tpu/crypto/pallas_round.py:98",
           device_ms=dev2, profiler_retries=re2, host_us=launch_us["external_product"])

    acc = ri(-2**31, 2**31, (M, 2, N))
    t = ri(0, 2 * N, (M,))
    err = same("cmux_round", K.cmux_round(acc, t, bk0, P, plan),
               K.cmux_round_plain(acc, t, bk0, P, plan))
    ms = cuda_ms(lambda: K.cmux_round(acc, t, bk0, P, plan), 20)
    pms = cuda_ms(lambda: K.cmux_round_plain(acc, t, bk0, P, plan), 3)
    dev3, _, _, re3 = device_ms(lambda: K.cmux_round(acc, t, bk0, P, plan),
                                "cmux_round_kernel", required=False)
    launch_us["cmux_round"] = host_us(lambda: K.cmux_round(acc, t, bk0, P, plan))
    report("cmux_round", [M, 2, N], err, ms, pms,
           2 * acc.numel() * 4 + M * 4 + bk0.numel() * 2, M * cmux_ops(rows, N),
           "redsec_tpu/crypto/pallas_round.py:254", device_ms=dev3, profiler_retries=re3,
           host_us=launch_us["cmux_round"])

    # K4's layout at every instance and batch below must be kernels.k4_layout's
    # (two ciphertexts a block, each key row loaded serving both, beyond one
    # wave of blocks wherever two fit)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def k4_layout_held(B4, params, plan_, bundle=1):
        cfg = K.blind_rotate_config(B4, params, plan_, bundle)
        want = K.k4_layout(B4, params, plan_, bundle, sms)
        if {k: cfg[k] for k in want} != want:
            fail(f"blind_rotate at {params.name}/{bundle} batch {B4}: the library's layout "
                 f"{cfg} is not kernels.k4_layout's {want}")
        return cfg

    def k4_layout_fields(cfg):
        regs, spill = ptxas_usage(ptxas, cfg["instance"])
        return dict(instance=cfg["instance"], ciphertexts_per_block=cfg["group"],
                    ciphertexts_per_key_load=cfg["group"],
                    chunk_rows=cfg["chunk_rows"], shared_bytes=cfg["shared_bytes"],
                    tables_resident=cfg["tables_resident"],
                    tables_refilled=cfg["tables_refilled"],
                    accumulators_on_r2=cfg["accumulators_on_r2"],
                    sums_on_differences=cfg["sums_on_differences"], registers=regs,
                    spill_bytes=spill)

    # K4 over all n rounds, at every batch the forward gives it and at batches
    # that take the one-ciphertext-a-block path (1, 5) or end on a ragged
    # block (133); timed at the full chunk and at the smallest of the path
    k4_timed = (k4_batches[0], k4_batches[-1])
    k4_ms, k4_cfg = {}, {}
    for B4 in k4_batches + [133, 5, 1]:
        acc0 = ri(-2**31, 2**31, (B4, 2, N))
        abar = ri(0, 2 * N, (B4, n))
        got = K.blind_rotate(acc0, abar, dkey.bk, P, plan)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = K.blind_rotate_plain(acc0, abar, dkey.bk, P, plan)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        err = same(f"blind_rotate batch {B4}", got, want)
        k4_cfg[B4] = k4_layout_held(B4, P, plan)
        if B4 in k4_timed:
            k4_ms[B4] = cuda_ms(lambda: K.blind_rotate(acc0, abar, dkey.bk, P, plan), 3)
        if B4 == k4_batches[0]:
            launch_us["blind_rotate"] = host_us(
                lambda: K.blind_rotate(acc0, abar, dkey.bk, P, plan), 5)
        if B4 == k4_batches[0]:
            k4_rec = dict(shape=[B4, 2, N], err=err, pms=pms,
                          bytes_=dkey.bk.numel() * 2 + 2 * acc0.numel() * 4 + abar.numel() * 4,
                          ops=B4 * n * cmux_ops(rows, N))
        print(f"kernel blind_rotate [{B4}, 2, {N}]: bit-identical to twin, "
              f"{k4_cfg[B4]['group']} ciphertexts a block" +
              (f", {k4_ms[B4]:.4f} ms" if B4 in k4_ms else ""), flush=True)
    build = {f"ciphertexts_per_block_{B4}": k4_cfg[B4]["group"] for B4 in k4_timed}
    for B4 in k4_timed:  # what ptxas says of each instantiation in use
        g = k4_cfg[B4]["group"]
        build[f"registers_g{g}"], build[f"spill_bytes_g{g}"] = ptxas_usage(
            ptxas, f"blind_rotate_kernelILi{N}ELi{g}ELi2ELi1E")
        build[f"shared_bytes_g{g}"] = k4_cfg[B4]["shared_bytes"]
    report("blind_rotate", k4_rec["shape"], k4_rec["err"], k4_ms[k4_timed[0]], k4_rec["pms"],
           k4_rec["bytes_"], k4_rec["ops"], "redsec_tpu/crypto/pallas_blind.py:60",
           params=(P.name, "small_v2_tpu2"), **{f"ms_batch{k4_timed[1]}": k4_ms[k4_timed[1]]},
           host_us=launch_us["blind_rotate"], **build)
    print(f"kernel blind_rotate build: {build}", flush=True)
    del acc0, abar, got, want

    # K4 at small_v2, the CLI's default set: 20 digit rows, two ciphertexts a
    # block with the rows in chunks of 12 beyond one wave of blocks
    _, cloud2 = kg.keygen(P2, seed=0)
    dkey2 = bs.prepare_cloud_key(cloud2, device="cuda")
    plan2, rows2 = dkey2.plan, P2.decomp_rows
    for B4 in (pbs_chunk, 133, 5, 1):
        acc0 = ri(-2**31, 2**31, (B4, 2, N))
        abar = ri(0, 2 * N, (B4, n))
        got = K.blind_rotate(acc0, abar, dkey2.bk, P2, plan2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = K.blind_rotate_plain(acc0, abar, dkey2.bk, P2, plan2)
        torch.cuda.synchronize()
        pms2 = (time.perf_counter() - t0) * 1e3
        err = same(f"blind_rotate {P2.name} batch {B4}", got, want)
        cfg2 = k4_layout_held(B4, P2, plan2)
        if B4 == pbs_chunk:
            ms2 = cuda_ms(lambda: K.blind_rotate(acc0, abar, dkey2.bk, P2, plan2), 3)
            k4_2 = dict(shape=[B4, 2, N], err=err, ms=ms2, pms=pms2, cfg=cfg2,
                        bytes_=dkey2.bk.numel() * 2 + 2 * acc0.numel() * 4 + abar.numel() * 4,
                        ops=B4 * n * cmux_ops(rows2, N))
        print(f"kernel blind_rotate {P2.name} [{B4}, 2, {N}], {rows2} digit rows: "
              f"bit-identical to twin, {cfg2}"
              + (f", {ms2:.4f} ms" if B4 == pbs_chunk else ""), flush=True)
    report("blind_rotate_small_v2", k4_2["shape"], k4_2["err"], k4_2["ms"], k4_2["pms"],
           k4_2["bytes_"], k4_2["ops"], "redsec_tpu/crypto/pallas_blind.py:60",
           params=P2.name, counter="blind_rotate", digit_rows=rows2,
           shared_bytes_g2=k4_2["cfg"]["shared_bytes_g2"], **k4_layout_fields(k4_2["cfg"]))
    check_key(P2.name, cloud2, dkey2)
    del acc0, abar, got, want, dkey2

    # K1 at N = 2048 and K4 at the instances of these keys: N = 2048 (primes
    # 12289 and 40961), three primes (small), bundled rounds (small_v2_tpu:
    # 36 digit rows; small_v2_tpu2: 30 rows, three primes, two a block in
    # chunks of 4 with the accumulators on r2 and the last prime's sums on the
    # differences; small_v2_n2048: 60 rows, the accumulators on r2); at
    # batches 512, 133, 5 and 1, timed at 512.  K1 at N = 2048 is held at the
    # plain key's rows here and at the bundled key's by its preparation
    # (check_key)
    PN = get_params("small_v2_n2048")
    P3 = get_params("small_v2_tpu2")
    new_keys = {}  # (set name, bundle) -> (secret key, cloud key), seed 0
    for Pn, bundle in ((PN, 1), (PS, 1), (P, 2), (P3, 2), (PN, 2)):
        t0 = time.perf_counter()
        new_keys[(Pn.name, bundle)] = kg.keygen(Pn, seed=0, bundle=bundle)
        dkn = bs.prepare_cloud_key(new_keys[(Pn.name, bundle)][1], device="cuda")
        print(f"keygen {Pn.name} bundle {bundle}: {time.perf_counter() - t0:.1f} s "
              f"(host, with the key's preparation)", flush=True)
        pn, Nn, Rn = dkn.plan, Pn.N, Pn.decomp_rows
        path = Pn.name if bundle == 1 else f"{Pn.name}/bundle2"
        check_key(path, new_keys[(Pn.name, bundle)][1], dkn)
        if Nn == 2048 and bundle == 1:
            M1n = min(key_chunk, Pn.n) * Rn * 2 * bs.BK_LIMBS
            err = 0
            for pi, p in enumerate(pn.primes):
                x = ri(0, p, (M1n, Nn))
                x[0, :8] = p - 1
                for inv in (False, True):
                    err = max(err, same(f"ntt [{M1n}, {Nn}] prime {p} inverse={inv}",
                                        K.ntt(x, pn, pi, inverse=inv),
                                        K.ntt_plain(x, pn, pi, inverse=inv)))
            ms = cuda_ms(lambda: K.ntt(x, pn, 1), 20)
            pms = cuda_ms(lambda: K.ntt_plain(x, pn, 1), 5)
            report("ntt_n2048", [M1n, Nn], err, ms, pms, 2 * M1n * Nn * 4, M1n * ntt_ops(Nn),
                   "redsec_tpu/crypto/pallas_ntt.py:147", params=(Pn.name, f"{Pn.name}/bundle2"),
                   primes=pn.primes,
                   counter="ntt", timed_prime=pn.primes[1])
            del x
        k4n = {}
        for B4 in (pbs_chunk, 133, 5, 1):
            acc0 = ri(-2**31, 2**31, (B4, 2, Nn))
            abar = ri(0, 2 * Nn, (B4, Pn.n))
            got = K.blind_rotate(acc0, abar, dkn.bk, Pn, pn)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = K.blind_rotate_plain(acc0, abar, dkn.bk, Pn, pn)
            torch.cuda.synchronize()
            pms = (time.perf_counter() - t0) * 1e3
            err = same(f"blind_rotate {path} batch {B4}", got, want)
            cfg = k4_layout_held(B4, Pn, pn, bundle)
            if B4 == pbs_chunk:
                k4n = dict(err=err, pms=pms, cfg=cfg,
                           ms=cuda_ms(lambda: K.blind_rotate(acc0, abar, dkn.bk, Pn, pn), 3),
                           bytes_=dkn.bk.numel() * 2 + 2 * acc0.numel() * 4 + abar.numel() * 4,
                           ops=B4 * (Pn.n // bundle) * cmux_ops(Rn, Nn, len(pn.primes), bundle))
            print(f"kernel blind_rotate {path} [{B4}, 2, {Nn}], {len(pn.primes)} primes "
                  f"{pn.primes}: bit-identical to twin ({pms:.0f} ms), {cfg}"
                  + (f", {k4n['ms']:.4f} ms" if B4 == pbs_chunk else ""), flush=True)
        D = 3 if bundle == 2 else 1
        report(f"blind_rotate_{Pn.name}" + ("_bundle2" if bundle == 2 else ""),
               [pbs_chunk, 2, Nn], k4n["err"], k4n["ms"], k4n["pms"], k4n["bytes_"],
               k4n["ops"], "redsec_tpu/crypto/pallas_blind.py:60", params=path,
               counter="blind_rotate", primes=pn.primes, bundle=bundle,
               digit_rows=Rn * D, rounds=Pn.n // bundle, **k4_layout_fields(k4n["cfg"]))
        del acc0, abar, got, want, dkn
        torch.cuda.empty_cache()

    # K2-mm, K3-mm, K4-mm: the four-step kernels (csrc/blind_mm.cu) on
    # "matmul" keys prepared from the same raw keys as the radix-2 ones; the
    # round kernels on 64 ciphertexts with round 0's slice; K4-mm at
    # small_v2_tpu at batches 512, 133, 5 and 1 (its 512 output also equal
    # to K4's on the radix-2 key), at small_v2 and plain small_v2_tpu2 at 512
    # and 1; timed at 512, beside K4 at small_v2_tpu (k4_ms, this process).
    # Each record's bound is the function's (K2's, K3's, K4's) with the
    # four-step formulation's beside it (int8 MACs plus its int32 work)
    mkey = bs.prepare_cloud_key(cloud, device="cuda", ntt_flavor="matmul")

    def mm_layout_held(params, plan_):
        lay, built = K.k4mm_layout(params, plan_), K.mm_layout(params)
        if any(built[k] != lay[k] for k in built):
            fail(f"the four-step kernels at {params.name}: the library's layout {built} is "
                 f"not kernels.k4mm_layout's {lay}")
        return lay

    def mm_fields(lay, kernel):
        # the key ring: its rows, whether it lies on the C-steps' operand
        # region, how a row is copied, and the key bytes a block has in flight
        instance = f"{kernel}ILi{N}E"
        regs, spill = ptxas_usage(ptxas, instance)
        return dict(instance=instance, ciphertexts_per_block=1, shared_bytes=lay["shared_bytes"],
                    rows_padded=lay["rows_padded"], registers=regs, spill_bytes=spill,
                    ring_rows=lay["ring_rows"], ring_aliased=lay["ring_aliased"],
                    ring_copy=lay["ring_copy"], ring_bytes_in_flight=lay["ring_bytes"])

    mlay = mm_layout_held(P, mkey.plan)
    mbk0 = mkey.bk[:, 0].contiguous()
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def round_mm_fields(Mx, full):
        # the split the wrapper picks at Mx, its layout (the library's answer
        # held against kernels.round_mm_layout), and the SMs its grid can
        # occupy: min(SMs, blocks / blocks an SM)
        kernel = "cmux_round_mm" if full else "external_product_mm"
        split = K.round_mm_split_on(0, N, rows, Mx, full)
        lay = K.round_mm_layout(P, split, mkey.plan, kernel)
        built = K.round_mm_built(N, rows, split, full)
        if any(built[k] != lay[k] for k in lay if k in built):
            fail(f"{kernel} split {split}: the library's layout {built} is not "
                 f"kernels.round_mm_layout's {lay}")
        per_sm = max(1, built["at_once"] * split // sms)
        occupied = min(sms, -(-Mx * split // per_sm))
        regs, spill = ptxas_usage(ptxas, lay["instance"])
        return dict(instance=lay["instance"], split=split, cluster=lay["cluster"],
                    shared_bytes=lay["shared_bytes"], rows_padded=lay["rows_padded"],
                    ring_rows=lay["ring_rows"],
                    blocks=Mx * split, at_once=built["at_once"], blocks_per_sm=per_sm,
                    occupied_sms=occupied, registers=regs, spill_bytes=spill,
                    registers_runtime=built["registers"], local_bytes=built["local_bytes"])

    # K2-mm and K3-mm at 64 ciphertexts and at a full chunk of 512 (the
    # round_kernel paths launch 512 and 32), round 0's slice; the bound also
    # priced on the SMs the grid occupies
    for name, full in (("external_product_mm", False), ("cmux_round_mm", True)):
        for Mx in (M, pbs_chunk):
            accx, tx = ri(-2**31, 2**31, (Mx, 2, N)), ri(0, 2 * N, (Mx,))
            digx = ri(-P.half_bg, P.half_bg, (Mx, rows, N))
            if full:
                def call(a=accx, t_=tx):
                    return K.cmux_round_mm(a, t_, mbk0, P, plan)

                def twin(a=accx, t_=tx):
                    return K.cmux_round_mm_plain(a, t_, mbk0, P, plan)
                bytes_ = 2 * accx.numel() * 4 + Mx * 4 + mbk0.numel() * 2
                ops, replaces = Mx * cmux_ops(rows, N), "redsec_tpu/crypto/pallas_round.py:254"
            else:
                def call(d=digx):
                    return K.external_product_mm(d, mbk0, plan)

                def twin(d=digx):
                    return K.external_product_mm_plain(d, mbk0, plan)
                bytes_ = digx.numel() * 4 + mbk0.numel() * 2 + Mx * 2 * N * 4
                ops, replaces = Mx * ext_product_ops(rows, N), "redsec_tpu/crypto/pallas_round.py:98"
            err = same(f"{name} [{Mx}]", call(), twin())
            ms = cuda_ms(call, 20)
            pms = cuda_ms(twin, 3)
            # a round of tens of us: events time the host's path beside it, so
            # the device time is read from the profiler too
            # (the name covers both designs: <N> and the pair kernel <N>)
            devx, _, _, rex = device_ms(call, name, required=False)
            fields = round_mm_fields(Mx, full)
            b_ms = bound(bytes_, ops)[0]
            at_shape = b_ms * sms / fields["occupied_sms"]
            key = name if Mx == M else f"{name}_{Mx}"
            if Mx == M:
                launch_us[name] = host_us(call)
            report(key, [Mx, 2 if full else rows, N], err, ms, pms, bytes_, ops, replaces,
                   "blind_mm.cu", counter=name,
                   bound_four_step_ms=four_step_bound_ms(Mx, rows, N, full),
                   bound_ms_occupied_sms=at_shape, device_ms=devx, profiler_retries=rex,
                   host_us=launch_us[name] if Mx == M else None, **fields)
            print(f"kernel {name} [{Mx}]: split {fields['split']} ({fields['instance']}, "
                  f"cluster {fields['cluster']}, {fields['shared_bytes']} B, "
                  f"{fields['registers']} registers, {fields['spill_bytes']} B spilled, "
                  f"{fields['at_once']} at once), {fields['blocks']} blocks on "
                  f"{fields['occupied_sms']} SMs: device {ms_text(devx)}, bound {b_ms:.6f} ms "
                  f"on the whole card, {at_shape:.6f} ms on the SMs the grid occupies "
                  + (f"({at_shape / devx:.1%})" if devx else ""), flush=True)
    del mbk0
    _, cloud3 = kg.keygen(P3, seed=0)  # plain small_v2_tpu2 (10 digit rows)
    mm_ms = {}
    for Pm, clm, batches in ((P, None, (pbs_chunk, 133, 5, 1)), (P2, cloud2, (pbs_chunk, 1)),
                             (P3, cloud3, (pbs_chunk, 1))):
        mk = mkey if clm is None else bs.prepare_cloud_key(clm, device="cuda",
                                                            ntt_flavor="matmul")
        lay = mm_layout_held(Pm, mk.plan)
        for B4 in batches:
            acc0 = ri(-2**31, 2**31, (B4, 2, N))
            abar = ri(0, 2 * N, (B4, Pm.n))
            got = K.blind_rotate_mm(acc0, abar, mk.bk, Pm, mk.plan)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = K.blind_rotate_mm_plain(acc0, abar, mk.bk, Pm, mk.plan)
            torch.cuda.synchronize()
            pms = (time.perf_counter() - t0) * 1e3
            err = same(f"blind_rotate_mm {Pm.name} batch {B4}", got, want)
            if Pm is P and B4 == pbs_chunk:
                same("blind_rotate_mm against blind_rotate on the same raw key", got,
                     K.blind_rotate(acc0, abar, dkey.bk, P, plan))
            if Pm is P and B4 == pbs_chunk:
                launch_us["blind_rotate_mm"] = host_us(
                    lambda: K.blind_rotate_mm(acc0, abar, mk.bk, Pm, mk.plan), 5)
            if B4 == pbs_chunk:
                mm_ms[Pm.name] = dict(
                    err=err, pms=pms, lay=lay,
                    ms=cuda_ms(lambda: K.blind_rotate_mm(acc0, abar, mk.bk, Pm, mk.plan), 3),
                    bytes_=mk.bk.numel() * 2 + 2 * acc0.numel() * 4 + abar.numel() * 4,
                    ops=B4 * Pm.n * cmux_ops(Pm.decomp_rows, N),
                    four=four_step_bound_ms(B4 * Pm.n, Pm.decomp_rows, N, True))
            print(f"kernel blind_rotate_mm {Pm.name} [{B4}, 2, {N}], {Pm.decomp_rows} digit "
                  f"rows: bit-identical to twin ({pms:.0f} ms)"
                  + (", and to blind_rotate on the radix-2 key of the same raw key"
                     if Pm is P and B4 == pbs_chunk else "")
                  + (f", {mm_ms[Pm.name]['ms']:.4f} ms, layout {lay}"
                     if B4 == pbs_chunk else ""), flush=True)
        del mk, acc0, abar, got, want
    m1, m3 = mm_ms[P.name], mm_ms[P3.name]
    report("blind_rotate_mm", [pbs_chunk, 2, N], m1["err"], m1["ms"], m1["pms"], m1["bytes_"],
           m1["ops"], "redsec_tpu/crypto/pallas_blind.py:60", "blind_mm.cu",
           params=(P.name, P3.name), counter="blind_rotate_mm",
           bound_four_step_ms=m1["four"], k4_ms_same_process=k4_ms[pbs_chunk],
           ms_small_v2_tpu2=m3["ms"], plain_ms_small_v2_tpu2=m3["pms"],
           bound_four_step_ms_small_v2_tpu2=m3["four"], host_us=launch_us["blind_rotate_mm"],
           **mm_fields(m1["lay"], "blind_rotate_mm_kernel"))
    print(f"kernel blind_rotate_mm {P.name} 512: {m1['ms']:.4f} ms against blind_rotate's "
          f"{k4_ms[pbs_chunk]:.4f} ms in this process ({m1['ms'] / k4_ms[pbs_chunk]:.3f}x)",
          flush=True)
    m2 = mm_ms[P2.name]
    report("blind_rotate_mm_small_v2", [pbs_chunk, 2, N], m2["err"], m2["ms"], m2["pms"],
           m2["bytes_"], m2["ops"], "redsec_tpu/crypto/pallas_blind.py:60", "blind_mm.cu",
           params=P2.name, counter="blind_rotate_mm", digit_rows=P2.decomp_rows,
           bound_four_step_ms=m2["four"], **mm_fields(m2["lay"], "blind_rotate_mm_kernel"))
    del mkey, cloud3
    torch.cuda.empty_cache()

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
        ldev, _, _, ldev_re = device_ms(lambda: bench_schoolbook.rot_gather(x5, t5), "",
                                        per_call=None, required=False)
        ms = cuda_ms(lambda: PK.rotate_rows(x5, t5), 200, warmup=3)
        # these launches are short: CUDA events time the host's enqueue, so
        # the device's own time per launch is read from the profiler as well
        # profiler_retries: the traces taken again for this record's device times
        dev5, _, _, re5 = device_ms(lambda: PK.rotate_rows(x5, t5), "rotate_rows_kernel")
        launch_us["rotate_rows"] = host_us(lambda: PK.rotate_rows(x5, t5))
        report("rotate_rows", [B5, 2, N], err5, ms, pms, rot_bytes, rot_ops,
               "scripts/bench_rotate.py:87", "probes.cu", lms, library_device_ms=ldev,
               device_ms=dev5, profiler_retries=ldev_re + re5, host_us=launch_us["rotate_rows"])
        ms64 = cuda_ms(lambda: PK.rotate_tile(x5, t5, 64), 200, warmup=3)
        ms256 = cuda_ms(lambda: PK.rotate_tile(x5, t5, 256), 200, warmup=3)
        dev64, _, _, re64 = device_ms(lambda: PK.rotate_tile(x5, t5, 64), "rotate_tile_kernel")
        dev256, _, _, re256 = device_ms(lambda: PK.rotate_tile(x5, t5, 256),
                                        "rotate_tile_kernel")
        launch_us["rotate_tile"] = host_us(lambda: PK.rotate_tile(x5, t5, 64))
        report("rotate_tile", [B5, 2, N], err6, ms64, pms, rot_bytes, rot_ops,
               "scripts/bench_rotate.py:109", "probes.cu", lms, library_device_ms=ldev,
               tile=64, ms_tile256=ms256, device_ms=dev64, device_ms_tile256=dev256,
               profiler_retries=ldev_re + re64 + re256, host_us=launch_us["rotate_tile"])
        print(f"kernel rotate_tile tile 256: {ms256:.4f} ms, on the device alone "
              f"{rec['rotate_tile']['device_ms_tile256']:.4f} ms ({B5 // 256} tiles, their "
              f"rows dealt out over two blocks an SM)", flush=True)

    # K7: the Toeplitz tile, its one shape
    w7 = ri(-2**31, 2**31, (1, 2 * PK.TOEPLITZ_TILE))
    err = same("toeplitz_tile", PK.toeplitz_tile(w7), PK.toeplitz_tile_plain(w7))
    pms = cuda_ms(lambda: PK.toeplitz_tile_plain(w7), 50, warmup=3)
    # the one PyTorch call: torch.take with the tile's fixed index table
    # (127 + k - j stays inside [0, 254], nothing wraps), built once
    kk = torch.arange(PK.TOEPLITZ_TILE, device=dev)
    idx7 = PK.TOEPLITZ_TILE - 1 + kk[None, :] - kk[:, None]
    if not torch.equal(torch.take(w7, idx7), PK.toeplitz_tile_plain(w7)):
        fail("torch.take over the fixed index table differs from the toeplitz_tile twin")
    # both are paced by the host: timed in turns (kernel, call, call, kernel),
    # 200 back-to-back calls between two events each
    k7_turns = {"kernel": [], "torch.take": []}
    for tag in ("kernel", "torch.take", "torch.take", "kernel"):
        k7_turns[tag].append(cuda_ms((lambda: PK.toeplitz_tile(w7)) if tag == "kernel"
                                     else (lambda: torch.take(w7, idx7)), 200, warmup=3))
    ms, lms = (sum(k7_turns[k]) / 2 for k in ("kernel", "torch.take"))
    ldev7, _, _, lre7 = device_ms(lambda: torch.take(w7, idx7), "", required=False)
    dev7, _, _, re7 = device_ms(lambda: PK.toeplitz_tile(w7), "toeplitz_tile_kernel")
    launch_us["toeplitz_tile"] = host_us(lambda: PK.toeplitz_tile(w7))
    launch_us["torch.take (library)"] = host_us(lambda: torch.take(w7, idx7))
    report("toeplitz_tile", [1, 2 * PK.TOEPLITZ_TILE], err, ms, pms,
           w7.numel() * 4 + PK.TOEPLITZ_TILE ** 2 * 4, PK.TOEPLITZ_TILE ** 2,
           "scripts/bench_schoolbook.py:254", "probes.cu", lms, library_device_ms=ldev7,
           device_ms=dev7, profiler_retries=lre7 + re7, ms_in_turns=k7_turns,
           host_us=launch_us["toeplitz_tile"], library_host_us=launch_us["torch.take (library)"])
    print(f"kernel toeplitz_tile against torch.take in turns (events, 200 calls each): kernel "
          f"{', '.join(f'{v:.4f}' for v in k7_turns['kernel'])} ms, torch.take "
          f"{', '.join(f'{v:.4f}' for v in k7_turns['torch.take'])} ms on {card}", flush=True)

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
    print(f"launch path, host us a call ({', '.join(f'{k} {v:.2f}' for k, v in launch_us.items())}"
          f"; calls with no synchronize between them) on {card}", flush=True)
    print(f"kernel phase: {time.perf_counter() - t_kernels:.1f} s", flush=True)

    # ---- phase 4: the sign slice through the port's entry points
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 256, size=(BATCH, 28, 28, 1))
    images = pixel_transform_for(model.name)(raw)

    # one image through the forward before the counted run, with the key the
    # kernel phase prepared: the first forward of a process pays for cuBLAS's
    # handle and the allocator's first blocks (a quarter of a second)
    wfwd = build_encrypted_forward(mplan, dkey)
    wct = encrypt_images(sk, images[:1], P, np.random.default_rng(9), gain=wfwd.in_gain)
    warm_s = []
    for _ in range(2):  # the first pays the start-up, the second is one image as it runs after
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wfwd(wct)
        torch.cuda.synchronize()
        warm_s.append(time.perf_counter() - t0)
    print(f"warm-up: first one-image forward {warm_s[0]:.3f} s, second {warm_s[1]:.3f} s "
          f"(start-up cost {warm_s[0] - warm_s[1]:.3f} s, outside the slice's timed span)",
          flush=True)
    del wct
    del wfwd, dkey
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
    by_path = {"sign1024x1": (P.name, counts)}

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
        by_path[tag] = (P.name, rcounts)
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

    # ---- phase 6: the README's client/server flow through the port's CLI,
    # in process (so the launch counters see it), at the CLI's default set
    work = os.path.join(HERE, "build", "smoke_cli")  # key files (70 MB): kept out of OUT_DIR
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    def run_cli(*argv):
        """``cli.main(argv)`` with its standard output captured and echoed."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ret = cli.main([str(a) for a in argv])
        text = buf.getvalue()
        print("\n".join(f"  | {line[:160]}" for line in text.splitlines()), flush=True)
        return text, ret

    def decrypted_class(text):
        found = re.findall(r"^Classification Result: (\d+)$", text, re.M)
        if len(found) != 1:
            fail(f"decrypt-image printed {len(found)} classification results")
        return int(found[0])

    def library_scores(wdir, model_plan, opts):
        """The same ciphertext file through the library path: its scores, the
        score ciphertexts, the forward, the key and the input ciphertexts."""
        lsk = kio.load_secret_key(os.path.join(wdir, "secret.key.npz"))
        lkey = bs.prepare_cloud_key(kio.load_cloud_key(os.path.join(wdir, "eval.key.npz")))
        lct, _, _, _, _ = kio.load_ciphertexts(os.path.join(wdir, "image.ctxt.npz"))
        lfwd = build_encrypted_forward(model_plan, lkey, **opts)
        lout = lfwd(lct.reshape(-1, *ptxt_shape(model_plan), lct.shape[-1]))
        return decrypt_scores(lsk, lout, lkey.params, lfwd.out_gain, lfwd.out_center), \
            lout, lfwd, lkey, lct

    def ptxt_shape(model_plan):
        d = model_plan.in_dim
        return d.h, d.w, d.in_dep

    cli_dir = os.path.join(work, "mnist")
    launches.reset()
    t0 = time.perf_counter()
    run_cli("keygen", "--params", P2.name, "--seed", 0, "--out-dir", cli_dir)
    write_image_ptxt(os.path.join(cli_dir, "image.ptxt"), 0, raw[0])
    run_cli("encrypt-image", "--secret", os.path.join(cli_dir, "secret.key.npz"),
            "--image-ptxt", os.path.join(cli_dir, "image.ptxt"),
            "--out", os.path.join(cli_dir, "image.ctxt.npz"))
    _, crec = run_cli("run-encrypted", "--model", model.name, "--weights", weights,
                      "--eval", os.path.join(cli_dir, "eval.key.npz"),
                      "--image", os.path.join(cli_dir, "image.ctxt.npz"),
                      "--out", os.path.join(cli_dir, "out.ctxt.npz"))
    torch.cuda.synchronize()
    ccounts = dict(launches.counts)
    by_path["cli/sign1024x1"] = (P2.name, ccounts)
    print(f"cli/sign1024x1 ({P2.name}) launches: {ccounts}, flow "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    want_k4 = sum(len(range(0, s.bootstraps, pbs_chunk)) for s in model_stats(mplan)
                  if s.bootstraps)
    if (crec["k4_launches"], ccounts.get("blind_rotate"), ccounts.get("ntt")) != (
            want_k4, want_k4, want_ntt):
        fail(f"cli/sign1024x1: {crec['k4_launches']} K4 launches reported, counters "
             f"{ccounts}; expected {want_k4} K4 and {want_ntt} NTT")
    if crec["pbs"] != pbs_per_image or crec["mode"] != "whole":
        fail(f"cli/sign1024x1: run-encrypted reports {crec}")
    text, _ = run_cli("decrypt-image", "--secret", os.path.join(cli_dir, "secret.key.npz"),
                      "--output", os.path.join(cli_dir, "out.ctxt.npz"))
    cls = decrypted_class(text)
    lscores, lout, _, _, _ = library_scores(cli_dir, mplan, {})
    cli_ct = kio.load_ciphertexts(os.path.join(cli_dir, "out.ctxt.npz"))[0]
    if not np.array_equal(lout.cpu().numpy(), cli_ct):
        fail("the score ciphertexts run-encrypted wrote differ from the library path's")
    if int(lscores[0].argmax()) != cls:
        fail(f"decrypt-image printed class {cls}, the library path gives "
             f"{int(lscores[0].argmax())}")
    text, _ = run_cli("stats", "--model", model.name, "--weights", weights)
    if json.loads(text)["total_bootstraps"] != pbs_per_image:
        fail("stats disagrees with summarize")
    csv = os.path.join(cli_dir, "data.csv")
    with open(csv, "w") as f:
        for label, img in zip(preds, raw):
            f.write(f"{int(label)}," + ",".join(str(int(v)) for v in img.reshape(-1)) + "\n")
    text, _ = run_cli("ptxt", "--model", model.name, "--weights", weights, "--csv", csv)
    if "Correct: 100.000000%" not in text:  # the labels are the oracle's own predictions
        fail("ptxt does not reproduce the oracle's predictions")
    sub = subprocess.run([sys.executable, "-m", "redsec_tpu_torch", "decrypt-image",
                          "--secret", os.path.join(cli_dir, "secret.key.npz"),
                          "--output", os.path.join(cli_dir, "out.ctxt.npz")],
                         capture_output=True, text=True, cwd=HERE, timeout=300,
                         env=dict(os.environ, PYTHONPATH=HERE))
    if sub.returncode != 0 or decrypted_class(sub.stdout) != cls:
        fail(f"python -m redsec_tpu_torch decrypt-image: {sub.returncode} {sub.stderr[-500:]}")
    print(f"cli/sign1024x1: out.ctxt.npz bit-identical to the library path's scores; "
          f"decrypt-image class {cls} = their argmax (also "
          f"through python -m); {crec['pbs']} PBS in {crec['seconds']:.3f} s, "
          f"{crec['pbs_per_s']:.2f} PBS/s on {card}", flush=True)
    slices["cli/sign1024x1"] = {"params": P2.name, **crec, "class": cls}

    # ---- phase 7: cifar/binarynet at full width, one image, through the CLI
    # with its trained weights and calibration (staged forward)
    cifar = os.path.join(HERE, "nets_trained", "cifar", "binarynet")
    cplan = prep_model(get_model("cifar/binarynet"), os.path.join(cifar, "var_prep.dat"))
    cmeta = calibration.load_calibration(os.path.join(cifar, "calibration.npz"), cplan)
    if cmeta["params"] != P.name:
        fail(f"cifar/binarynet is calibrated for {cmeta['params']}, not {P.name}")
    cdir = os.path.join(work, "cifar")
    craw = np.random.default_rng(1).integers(0, 256, size=(32, 32, 3))
    cstats = [s.bootstraps for s in model_stats(cplan) if s.bootstraps]
    want_pbs = sum(cstats)
    want_k4 = sum(len(range(0, b, pbs_chunk)) for b in cstats)
    k4_events, seen = [], []

    def timed_k4(acc0, *rest, _real=K.blind_rotate):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        res = _real(acc0, *rest)
        ev[1].record()
        k4_events.append(ev)
        seen.append(acc0.shape[0])
        return res

    launches.reset()
    t0 = time.perf_counter()
    run_cli("keygen", "--params", P.name, "--seed", 0, "--out-dir", cdir)
    write_image_ptxt(os.path.join(cdir, "image.ptxt"), 0, craw)
    text, _ = run_cli("encrypt-image", "--secret", os.path.join(cdir, "secret.key.npz"),
                      "--model", "cifar/binarynet", "--calib",
                      os.path.join(cifar, "calibration.npz"),
                      "--image-ptxt", os.path.join(cdir, "image.ptxt"),
                      "--out", os.path.join(cdir, "image.ctxt.npz"))
    if f"input gain {cmeta['in_gain']})" not in text:
        fail(f"encrypt-image did not apply the input gain {cmeta['in_gain']}")
    with mock.patch.object(K, "blind_rotate", timed_k4):
        _, frec = run_cli("run-encrypted", "--model", "cifar/binarynet",
                          "--weights", os.path.join(cifar, "var_prep.dat"),
                          "--eval", os.path.join(cdir, "eval.key.npz"),
                          "--image", os.path.join(cdir, "image.ctxt.npz"),
                          "--calib", os.path.join(cifar, "calibration.npz"),
                          "--out", os.path.join(cdir, "out.ctxt.npz"))
    torch.cuda.synchronize()
    fcounts = dict(launches.counts)
    by_path["cli/cifar_binarynet"] = (P.name, fcounts)
    k4_ms_total = sum(a.elapsed_time(b) for a, b in k4_events)
    print(f"cli/cifar_binarynet launches: {fcounts}, flow {time.perf_counter() - t0:.1f} s",
          flush=True)
    if (frec["mode"], frec["pbs"], frec["k4_launches"]) != ("staged", want_pbs, want_k4) or \
            fcounts.get("blind_rotate") != want_k4 or sum(seen) != want_pbs:
        fail(f"cifar/binarynet: run-encrypted reports {frec}, counters {fcounts}, "
             f"{sum(seen)} bootstraps at the kernel's door; expected staged, {want_pbs} "
             f"PBS, {want_k4} K4 launches")
    text, _ = run_cli("decrypt-image", "--secret", os.path.join(cdir, "secret.key.npz"),
                      "--output", os.path.join(cdir, "out.ctxt.npz"))
    ccls = decrypted_class(text)
    coracle = int(ptxt.predict(cplan, pixel_transform_for("cifar/binarynet")(craw[None]),
                               device="cuda")[0])
    k4_share = k4_ms_total / (frec["seconds"] * 1e3)
    print(f"cli/cifar_binarynet: 1 image x {frec['pbs']} PBS in {frec['seconds']:.3f} s "
          f"(staged, {frec['k4_launches']} K4 launches, K4 {k4_ms_total:.1f} ms = "
          f"{k4_share:.4f} of the forward's wall time): {frec['pbs_per_s']:.2f} PBS/s, "
          f"{1 / frec['seconds']:.4f} images/s on {card}; decrypted argmax {ccls}, "
          f"plaintext oracle {coracle} (informational)", flush=True)
    slices["cli/cifar_binarynet"] = {"params": P.name, **frec, "images_per_s":
                                     1 / frec["seconds"], "k4_ms": k4_ms_total,
                                     "k4_share": k4_share, "class": ccls,
                                     "oracle_class": coracle}
    if args.profile:
        copts = calibration.options_from_meta(cmeta)
        _, _, pfwd, pkey, pct = library_scores(cdir, cplan, copts)
        profile_forward(pfwd, pct.reshape(-1, 32, 32, 3, pct.shape[-1]), card,
                        "cifar_binarynet")
        del pfwd, pkey, pct

    # ---- phase 8: this slice's paths on sign1024x1 at full width, batch 8:
    # the CLI at small_v2_n2048 and at small, bundled keys through the library
    # path, and escalation with a majority-voted boundary through the CLI
    data_csv = os.path.join(work, "data.csv")  # the slice's images, labelled by the oracle
    with open(data_csv, "w") as f:
        for label, img in zip(preds, raw):
            f.write(f"{int(label)}," + ",".join(str(int(v)) for v in img.reshape(-1)) + "\n")

    def decrypted_classes(text):
        return [int(c) for c in re.findall(r"^Classification Result: (\d+)$", text, re.M)]

    def sign_k4_launches(per_image_boots):
        return sum(len(range(0, b * BATCH, pbs_chunk)) for b in per_image_boots if b)

    sign_boots = [s.bootstraps for s in model_stats(mplan)]
    for Pn in (PN, PS):
        tag = f"cli/{Pn.name}"
        ndir = os.path.join(work, Pn.name)
        launches.reset()
        t0 = time.perf_counter()
        run_cli("keygen", "--params", Pn.name, "--seed", 0, "--out-dir", ndir)
        run_cli("encrypt-image", "--secret", os.path.join(ndir, "secret.key.npz"),
                "--csv", data_csv, "--rows", f"0:{BATCH}",
                "--out", os.path.join(ndir, "image.ctxt.npz"))
        _, nrec = run_cli("run-encrypted", "--model", model.name, "--weights", weights,
                          "--eval", os.path.join(ndir, "eval.key.npz"),
                          "--image", os.path.join(ndir, "image.ctxt.npz"),
                          "--out", os.path.join(ndir, "out.ctxt.npz"))
        torch.cuda.synchronize()
        ncounts = dict(launches.counts)
        by_path[tag] = (Pn.name, ncounts)
        plan_n = bs.bootstrap_plan(Pn)
        want = (sign_k4_launches(sign_boots),
                len(plan_n.primes) * len(range(0, Pn.n, key_chunk)))
        print(f"{tag} launches: {ncounts}, flow {time.perf_counter() - t0:.1f} s", flush=True)
        if (nrec["k4_launches"], ncounts.get("blind_rotate"), ncounts.get("ntt")) != (
                want[0], want[0], want[1]) or nrec["pbs"] != pbs_per_image * BATCH:
            fail(f"{tag}: run-encrypted reports {nrec}, counters {ncounts}; expected "
                 f"{want[0]} K4 and {want[1]} NTT launches, {pbs_per_image * BATCH} PBS")
        text, _ = run_cli("decrypt-image", "--secret", os.path.join(ndir, "secret.key.npz"),
                          "--output", os.path.join(ndir, "out.ctxt.npz"))
        lscores, lout, _, _, _ = library_scores(ndir, mplan, {})
        if not np.array_equal(lout.cpu().numpy(),
                              kio.load_ciphertexts(os.path.join(ndir, "out.ctxt.npz"))[0]):
            fail(f"{tag}: the score ciphertexts run-encrypted wrote differ from the library "
                 f"path's")
        classes = decrypted_classes(text)
        if classes != [int(c) for c in lscores.argmax(axis=1)]:
            fail(f"{tag}: decrypt-image printed {classes}, the library path gives "
                 f"{lscores.argmax(axis=1).tolist()}")
        nagree = float((np.asarray(classes) == preds).mean())
        print(f"{tag}: out.ctxt.npz bit-identical to the library path's scores, decrypted "
              f"argmax {classes} = theirs; {BATCH} images x {pbs_per_image} PBS in "
              f"{nrec['seconds']:.3f} s, {nrec['pbs_per_s']:.2f} PBS/s, "
              f"{BATCH / nrec['seconds']:.4f} images/s; argmax agreement with the plaintext "
              f"oracle {nagree:.3f} (informational) on {card}", flush=True)
        slices[tag] = {"params": Pn.name, **nrec, "classes": classes, "argmax_agreement": nagree}
        del lout

    # bundled keys (keygen(..., bundle=2); the command line has no bundle
    # option, as the JAX package's has none) through the library path
    for Pn in (P, P3, PN):
        tag = f"bundled/{Pn.name}"
        bsk, bcloud = new_keys[(Pn.name, 2)]
        launches.reset()
        t0 = time.perf_counter()
        bkey = bs.prepare_cloud_key(bcloud, device="cuda")
        torch.cuda.synchronize()
        t_bprep = time.perf_counter() - t0
        bfwd = build_encrypted_forward(mplan, bkey)
        bct = encrypt_images(bsk, images, Pn, np.random.default_rng(1), gain=bfwd.in_gain)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bout = bfwd(bct)
        torch.cuda.synchronize()
        t_b = time.perf_counter() - t0
        bcounts = dict(launches.counts)
        by_path[tag] = (f"{Pn.name}/bundle2", bcounts)
        want = (sign_k4_launches(sign_boots),
                len(bkey.plan.primes) * len(range(0, Pn.n // 2, key_chunk)))
        if (bcounts.get("blind_rotate"), bcounts.get("ntt")) != want or bkey.bundle != 2:
            fail(f"{tag}: counters {bcounts}, expected {want[0]} K4 and {want[1]} NTT launches")
        bscores = decrypt_scores(bsk, bout, Pn, bfwd.out_gain, bfwd.out_center)
        check_scores(bout, bscores)
        bagree = float((bscores.argmax(axis=1) == preds).mean())
        print(f"{tag}: {BATCH} images x {pbs_per_image} PBS in {t_b:.3f} s (key prepared in "
              f"{t_bprep:.3f} s, primes {bkey.plan.primes}), {pbs_per_image * BATCH / t_b:.2f} "
              f"PBS/s, launches {bcounts}; argmax agreement with the plaintext oracle "
              f"{bagree:.3f} (informational: bundled and plain ciphertexts differ) on {card}",
              flush=True)
        slices[tag] = {"params": Pn.name, "bundle": 2, "images": BATCH, "forward_s": t_b,
                       "pbs_per_s": pbs_per_image * BATCH / t_b, "launches": bcounts,
                       "argmax_agreement": bagree}
        del bkey, bfwd, bout

    # escalation: a calibration (on 16 other synthetic images) that escalates
    # layer 1's 1,024 signs to a same-seed small_v2_n2048 key and votes layer
    # 0's 196 signs at k = 3; run-encrypted refuses it without --eval2
    edir = os.path.join(work, "escalation")
    os.makedirs(edir)
    ecsv = os.path.join(edir, "calib.csv")
    craw16 = np.random.default_rng(11).integers(0, 256, size=(16, 28, 28, 1))
    with open(ecsv, "w") as f:
        for img in craw16:
            f.write("0," + ",".join(str(int(v)) for v in img.reshape(-1)) + "\n")
    esc_layers, vote_plan = "1", "0:3"
    run_cli("calibrate", "--model", model.name, "--weights", weights, "--csv", ecsv,
            "--rows", "0:16", "--params", P.name, "--input-gain", "--escalate", esc_layers,
            "--escalate-params", PN.name, "--majority-plan", vote_plan,
            "--out", os.path.join(edir, "cal.npz"))
    run_cli("keygen", "--params", P.name, "--seed", 0, "--out-dir", edir)
    run_cli("encrypt-image", "--secret", os.path.join(edir, "secret.key.npz"), "--csv",
            data_csv, "--rows", f"0:{BATCH}", "--calib", os.path.join(edir, "cal.npz"),
            "--out", os.path.join(edir, "image.ctxt.npz"))
    erun = ["run-encrypted", "--model", model.name, "--weights", weights,
            "--eval", os.path.join(edir, "eval.key.npz"),
            "--image", os.path.join(edir, "image.ctxt.npz"),
            "--calib", os.path.join(edir, "cal.npz"), "--out", os.path.join(edir, "out.ctxt.npz")]
    try:
        run_cli(*erun)
        fail("run-encrypted ran an escalating calibration without --eval2")
    except SystemExit as e:
        if "--eval2" not in str(e):
            raise
    door = {}  # launches at the kernels' doors by parameter set

    def door_k4(acc0, abar, bk, params, plan_, _real=K.blind_rotate):
        door[("blind_rotate", params.name)] = door.get(("blind_rotate", params.name), 0) + 1
        return _real(acc0, abar, bk, params, plan_)

    def door_ntt(x, plan_, pi, inverse=False, _real=K.ntt):
        key = ("ntt", PN.name if plan_.N == 2048 else P.name)
        door[key] = door.get(key, 0) + 1
        return _real(x, plan_, pi, inverse)

    launches.reset()
    with mock.patch.object(K, "blind_rotate", door_k4), mock.patch.object(K, "ntt", door_ntt):
        _, erec = run_cli(*erun, "--eval2", os.path.join(work, PN.name, "eval.key.npz"))
    torch.cuda.synchronize()
    ecounts = dict(launches.counts)
    for pn in (P.name, PN.name):
        by_path[f"escalation/{pn}"] = (pn, {k: v for (k, q), v in door.items() if q == pn})
    if sum(v for (k, _), v in door.items() if k == "blind_rotate") != ecounts["blind_rotate"]:
        fail(f"escalation: {door} at the kernels' doors, counters {ecounts}")
    eplan = prep_model(model, weights)  # the calibration goes onto a plan of its own
    emeta = calibration.load_calibration(os.path.join(edir, "cal.npz"), eplan)
    eopts = calibration.options_from_meta(emeta)
    eks = majority_ks(eplan, eopts["majority"], eopts["majority_from"], eopts["majority_plan"])
    votes = {i: k for i, k in eks.items() if k > 1}
    # layer 0: k copies, then the vote sum's one PBS each; layer 1 at N = 2048
    want_esc = {P.name: len(range(0, 3 * sign_boots[0] * BATCH, pbs_chunk))
                + len(range(0, sign_boots[0] * BATCH, pbs_chunk)),
                PN.name: len(range(0, sign_boots[1] * BATCH, pbs_chunk))}
    got_esc = {pn: door.get(("blind_rotate", pn), 0) for pn in want_esc}
    want_pbs = BATCH * (sign_boots[0] * 4 + sign_boots[1])
    if (erec["mode"], erec["pbs"], got_esc, votes) != ("staged", want_pbs, want_esc, {0: 3}):
        fail(f"escalation: run-encrypted reports {erec}, K4 launches by key {got_esc}, votes "
             f"{votes}; expected staged, {want_pbs} PBS, {want_esc}, {{0: 3}}")
    # the library path on the same files: the same key pair and options
    e1 = bs.prepare_cloud_key(kio.load_cloud_key(os.path.join(edir, "eval.key.npz")))
    e2 = bs.prepare_cloud_key(kio.load_cloud_key(os.path.join(work, PN.name, "eval.key.npz")))
    layers_e, _ = calibration.escalation_from_meta(emeta)
    efwd = build_encrypted_forward(eplan, e1, **eopts, escalate=(layers_e, e2))
    ect = kio.load_ciphertexts(os.path.join(edir, "image.ctxt.npz"))[0]
    eout = efwd(ect.reshape(-1, 28, 28, 1, ect.shape[-1])).cpu().numpy()
    if not np.array_equal(eout, kio.load_ciphertexts(os.path.join(edir, "out.ctxt.npz"))[0]):
        fail("escalation: the score ciphertexts run-encrypted wrote differ from the library "
             "path's")
    text, _ = run_cli("decrypt-image", "--secret", os.path.join(edir, "secret.key.npz"),
                      "--output", os.path.join(edir, "out.ctxt.npz"))
    eclasses = decrypted_classes(text)
    esk = kio.load_secret_key(os.path.join(edir, "secret.key.npz"))
    escores = decrypt_scores(esk, eout, P, efwd.out_gain, efwd.out_center)
    if eclasses != [int(c) for c in escores.argmax(axis=1)]:
        fail(f"escalation: decrypt-image printed {eclasses}, the library path gives "
             f"{escores.argmax(axis=1).tolist()}")
    eagree = float((np.asarray(eclasses) == preds).mean())
    print(f"escalation: layer {esc_layers} through {PN.name} (--eval2), layer 0 voted at k=3: "
          f"{erec['pbs']} PBS in {erec['seconds']:.3f} s, {erec['pbs_per_s']:.2f} PBS/s, K4 "
          f"launches by key {got_esc}; out.ctxt.npz bit-identical to the library path's, "
          f"decrypted argmax {eclasses}; argmax agreement with the plaintext oracle "
          f"{eagree:.3f} (informational) on {card}", flush=True)
    slices["escalation"] = {"params": P.name, "escalate": {esc_layers: PN.name},
                            "majority_plan": vote_plan, **erec, "k4_launches_by_key": got_esc,
                            "classes": eclasses, "argmax_agreement": eagree}
    del e1, e2, efwd, eplan
    torch.cuda.empty_cache()

    # ---- phase 9: the reference's per-stage comparison on the card, at no
    # sampled noise (leveled stages exact) and at real noise (inside the band)
    def layerwise(tag, params, lkey, lsk, limages, exact):
        launches.reset()
        t0 = time.perf_counter()
        reports = layerwise_compare(mplan, lkey, lsk, limages, np.random.default_rng(5))
        # small_v2_noiseless gives the blind rotation small_v2's shape
        by_path[f"layerwise/{tag}"] = (P2.name if params is PQ else params.name,
                                       dict(launches.counts))
        band = params.noise_band_units()
        print(f"layerwise_compare sign1024x1 at {params.name}, {len(limages)} image(s) "
              f"({time.perf_counter() - t0:.1f} s; noise band {band} units):\n"
              + format_reports(reports), flush=True)
        stages = [(r.layer, r.stage) for r in reports]
        if stages != [(0, "sumpool"), (0, "sign"), (1, "conv"), (1, "sign"), (2, "conv"),
                      (2, "add_bias")]:
            fail(f"layerwise_compare reported {stages}")
        for r in reports:
            leveled = r.stage in LEVELED
            if leveled and exact and not r.exact:
                fail(f"{tag}: L{r.layer} {r.stage} is {r.max_abs_err} units off the "
                     f"plaintext oracle at {params.name}, which samples no noise")
            if (r.max_abs_err if leveled else r.max_mismatch_margin) > band:
                fail(f"{tag}: L{r.layer} {r.stage} is off the plaintext oracle by more "
                     f"than the noise band ({r.max_abs_err} units, flipped margin "
                     f"{r.max_mismatch_margin}, band {band})")
        return {f"L{r.layer}_{r.stage}": {"agreement": r.agreement, "max_abs_err":
                                          r.max_abs_err, "worst_margin":
                                          r.max_mismatch_margin} for r in reports}

    qsk, qcloud = kg.keygen(PQ, seed=0)
    qkey = bs.prepare_cloud_key(qcloud, device="cuda")
    slices["layerwise"] = {
        PQ.name: layerwise("sign1024x1_noiseless", PQ, qkey, qsk, images[:4], exact=True),
        P.name: layerwise("sign1024x1", P, dkey, sk, images[:1], exact=False)}
    del qkey
    shutil.rmtree(work)

    # ---- phase 10: the probes' entry points (each checks its candidates equal)
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
        by_path[tag] = (None, pcounts)
        print(f"{tag} {' '.join(argv)}: {time.perf_counter() - t0:.1f} s, launches {pcounts}",
              flush=True)
        # one launch per check, then a warm-up chain and a timed chain
        if pcounts != expect:
            fail(f"{tag} launched {pcounts}, expected {expect}")

    # ---- phase 11: the schoolbook sets through the schoolbook round kernel (S1-fft),
    # with the schoolbook product (S1) it took over from held and timed beside it
    from redsec_tpu_torch.crypto import gates
    from redsec_tpu_torch.crypto import lwe
    from redsec_tpu_torch.runtime import encrypted as renc

    PV = get_params("medium_v2")
    t_phase = time.perf_counter()

    # S1 against its twin at every shape the paths give it (the sets' N and
    # rows, each with its Bg/2) and at the tile edges of its batch (8, 16
    # and 32 ciphertexts a block, ragged grids, the full-width path's chunks);
    # then at extreme inputs.  Timed at 512 (and the path's batches at
    # medium_v2), the twin beside it at medium_v2's [512, 8, 4096]
    sb_path = {min(pbs_chunk, b - i) for b in sign_boots if b for i in range(0, b, pbs_chunk)}
    sb_shapes = [(4096, 6), (4096, 8), (8192, 6), (8192, 8), (1024, 12), (1024, 20), (256, 20)]
    # Bg/2 of medium/large, the v2 sets, small_v2_tpu, small_v2 and test_noiseless
    sb_half = {6: 512, 8: 128, 12: 16, 20: 4}
    sb_batches = {1, 4, 8, 9, 17, 33, 70, 196, 512}
    sb_ms, sb_tiles = {}, {}
    for Ns, rs in sb_shapes:
        hb = sb_half[rs]
        bk_s = ri(-2**31, 2**31, (rs, 2, Ns))
        bk_s[0, 0, :4] = -2**31
        is_v2 = (Ns, rs) == (PV.N, PV.decomp_rows)
        for Bs in sorted(sb_batches | (set(sb_path) if is_v2 else set())):
            dg = ri(-hb, hb, (Bs, rs, Ns))
            err = same(f"schoolbook_product [{Bs}, {rs}, {Ns}]",
                       K.schoolbook_product(dg, bk_s, hb), K.schoolbook_product_plain(dg, bk_s, hb))
            tile = K.schoolbook_tile(Bs, Ns, hb)
            sb_tiles[tile["instance"]] = sb_tiles.get(tile["instance"], 0) + 1
            if (Bs == 512 and Ns >= 1024) or (is_v2 and Bs in sb_path):
                sb_ms[(Ns, rs, Bs)] = cuda_ms(lambda: K.schoolbook_product(dg, bk_s, hb), 5)
            if is_v2 and Bs == 512:
                launch_us["schoolbook_product [512, 8, 4096]"] = host_us(
                    lambda: K.schoolbook_product(dg, bk_s, hb), 5)
                sb_rec = dict(err=err, pms=cuda_ms(
                    lambda: K.schoolbook_product_plain(dg, bk_s, hb), 5),
                    bytes_=dg.numel() * 4 + bk_s.numel() * 4 + Bs * 2 * Ns * 4)
            t_ms = sb_ms.get((Ns, rs, Bs))
            if t_ms is None:
                continue
            b_i32 = schoolbook_ops(Bs, rs, Ns) / PEAK_INT32_OPS * 1e3
            b_i8 = schoolbook_int8_macs(Bs, rs, Ns, hb) / PEAK_INT8_MACS * 1e3
            b_fft = fp64_ms(schoolbook_fft_flops(Bs, rs, Ns))
            b_ms = max((Bs * rs * Ns + rs * 2 * Ns + Bs * 2 * Ns) * 4 / PEAK_BYTES * 1e3,
                       min(b_fft, b_i8, b_i32))
            print(f"kernel schoolbook_product [{Bs}, {rs}, {Ns}] (Bg/2 {hb}, tile "
                  f"{tile['instance']}): bit-identical to twin, {t_ms:.4f} ms; bound "
                  f"{b_ms:.4f} ms ({b_ms / t_ms:.4f} of it; float64-FFT {b_fft:.4f}, int8 "
                  f"tensor-core {b_i8:.4f} ({b_i8 / t_ms:.4f} of it), int32 CUDA-core "
                  f"{b_i32:.4f}) on {card}", flush=True)
        print(f"kernel schoolbook_product [*, {rs}, {Ns}] (Bg/2 {hb}): bit-identical to twin "
              f"at batches {sorted(sb_batches | (set(sb_path) if is_v2 else set()))}",
              flush=True)
        del bk_s, dg
    # extreme inputs: digits all -Bg/2 or Bg/2 - 1 against keys all -2^31, -1
    # (every key byte 255), 0, 2^31 - 1, at the sets' widest N (accumulators
    # at their bound: large_v2 sums 128 x 255 x 8 x 8192 in one flush).  At
    # 16 rows a launch sums more rows than one run between flushes
    # (kernels.schoolbook_flush_rows: 7 at Bg/2 512, 8 at 128), so it flushes
    # mid-launch; there random digits and keys are held too
    for rs, hb in ((6, 512), (8, 128), (16, 512), (16, 128)):
        flushes = -(-rs // K.schoolbook_flush_rows(8192, hb))
        cases = [(dv, kv) for dv in (-hb, hb - 1) for kv in (-2**31, -1, 0, 2**31 - 1)]
        for dv, kv in cases + ([(None, None)] if flushes > 1 else []):
            if dv is None:
                dg, bk_s = ri(-hb, hb, (9, rs, 8192)), ri(-2**31, 2**31, (rs, 2, 8192))
            else:
                dg = torch.full((9, rs, 8192), dv, dtype=torch.int32, device=dev)
                bk_s = torch.full((rs, 2, 8192), kv, dtype=torch.int32, device=dev)
            same(f"schoolbook_product [9, {rs}, 8192] Bg/2 {hb} digits, key "
                 f"{'random' if dv is None else (dv, kv)}",
                 K.schoolbook_product(dg, bk_s, hb), K.schoolbook_product_plain(dg, bk_s, hb))
        print(f"kernel schoolbook_product [9, {rs}, 8192] (Bg/2 {hb}, {flushes} flushes a "
              f"launch): bit-identical to twin at extreme inputs (digits -Bg/2 and Bg/2 - 1, "
              f"keys -2^31, -1, 0, 2^31 - 1){' and random ones' if flushes > 1 else ''}",
              flush=True)
    del bk_s, dg
    # registers and spills of every instance the compiler built (template
    # <NT, MT, digit limbs>), and the instances these shapes launched
    sb_built = sorted(set(re.findall(r"schoolbook_mma_kernelILi\d+ELi\d+ELi\d+E", ptxas)))
    if len(sb_built) != 15 or not set(sb_tiles) <= set(sb_built):
        fail(f"the compiler's report has S1 instances {sb_built}; the shapes launched "
             f"{sorted(sb_tiles)}")
    sb_regs = {}
    for inst in sb_built:
        tag = inst.replace("schoolbook_mma_kernel", "").replace("ILi", "").replace("ELi", "_") \
            .rstrip("E")
        sb_regs[f"registers_{tag}"], sb_regs[f"spill_bytes_{tag}"] = ptxas_usage(ptxas, inst)
    Bm = 512
    v2_tile = K.schoolbook_tile(Bm, PV.N, PV.half_bg)["instance"]
    v2_ms, v2_twin = sb_ms[(PV.N, PV.decomp_rows, Bm)], sb_rec["pms"]
    print(f"kernel schoolbook_product [{Bm}, {PV.decomp_rows}, {PV.N}]: {v2_ms:.4f} ms, its "
          f"float64-FFT twin {v2_twin:.4f} ms in this process: "
          f"{'faster' if v2_ms < v2_twin else 'SLOWER'} than the twin ({v2_twin / v2_ms:.2f}x); "
          f"instance {v2_tile}, {ptxas_usage(ptxas, v2_tile)[0]} registers, "
          f"{ptxas_usage(ptxas, v2_tile)[1]} spill bytes, on {card}", flush=True)
    # bound_ms: the cheapest of the product's three formulations, at these
    # shapes the exact float64 FFTs of its twin; the int8 tensor-core one that
    # S1 runs and the int32 CUDA-core one beside it
    i8 = schoolbook_int8_macs(Bm, PV.decomp_rows, PV.N, PV.half_bg) / PEAK_INT8_MACS * 1e3
    i32 = schoolbook_ops(Bm, PV.decomp_rows, PV.N) / PEAK_INT32_OPS * 1e3
    f64 = fp64_ms(schoolbook_fft_flops(Bm, PV.decomp_rows, PV.N))
    print(f"kernel schoolbook_product [{Bm}, {PV.decomp_rows}, {PV.N}]: {v2_ms:.4f} ms is "
          f"{f64 / v2_ms:.4f} of the float64-FFT bound {f64:.4f} ms and {i8 / v2_ms:.4f} of "
          f"the int8 tensor-core bound {i8:.4f} ms on {card}", flush=True)
    report("schoolbook_product", [Bm, PV.decomp_rows, PV.N], sb_rec["err"],
           v2_ms, v2_twin, sb_rec["bytes_"],
           schoolbook_ops(Bm, PV.decomp_rows, PV.N), "redsec_tpu/crypto/bootstrap.py:538",
           "schoolbook.cu", ops_ms=min(f64, i8, i32), params=("medium_v2", "medium", "large",
                                                              "large_v2",
                                                              "small_v2_tpu/schoolbook"),
           bound_fp64_fft_ms=f64, bound_int32_cuda_core_ms=i32, bound_int8_tensor_core_ms=i8,
           ms_by_shape={f"N{k[0]}_rows{k[1]}_batch{k[2]}": v for k, v in sb_ms.items()},
           instance_medium_v2_512=v2_tile, instances_checked=sb_tiles, **sb_regs)
    print(f"kernel schoolbook_product build: {sb_regs}", flush=True)

    # S1-fft, the whole round on the key's spectra (csrc/schoolbook_fft.cu),
    # against its twin (the same transforms in torch) and against one round of
    # S1 with its glue, at the sets' N, rows and Bg/2 and the batches of the
    # tests and of the paths; at each set the digits also at their worst-case
    # norm (acc = offset / 2 rotated by N: every digit -Bg/2) and in place
    # (out = acc).  Then timed in turns at 512 (and a gate's 4) beside S1
    # alone and S1 with its glue
    r_sets = ["medium", "medium_v2", "large", "large_v2", "small_v2_tpu", "small_v2"]
    r_batches = {1, 4, 196, 512, 513}
    r_inst, r_err = {}, 0
    for name in r_sets:
        Pr = get_params(name)
        Nr, rr = Pr.N, Pr.decomp_rows
        bk_s = ri(-2**31, 2**31, (rr, 2, Nr))
        bk_s[0, 0, :4] = -2**31
        spec = K.key_spectra(bk_s)
        ops_r = bs.RoundOps(Pr)
        fill = bs.gadget_offset(Pr) // 2
        batches = sorted(r_batches | (set(sb_path) if name == PV.name else set()))
        for Bs in batches:
            acc_r, t_r = ri(-2**31, 2**31, (Bs, 2, Nr)), ri(0, 2 * Nr, (Bs,))
            if Bs == 4:  # the worst-case digits
                acc_r[:2] = fill - 2**32 if fill >= 2**31 else fill
                t_r[:2] = Nr
            want = K.schoolbook_round_plain(acc_r, t_r, spec, Pr)
            s1w = acc_r + K.schoolbook_product(ops_r.decompose(ops_r.rotate(acc_r, t_r) - acc_r),
                                               bk_s, Pr.half_bg)
            r_err = max(r_err, same(f"schoolbook_round {name} [{Bs}, {rr}, {Nr}]",
                                    K.schoolbook_round(acc_r, t_r, spec, Pr), want))
            same(f"schoolbook_round {name} [{Bs}, {rr}, {Nr}] against S1 and its glue", want, s1w)
            if Bs in (4, 513):
                K.schoolbook_round(acc_r, t_r, spec, Pr, out=acc_r)
                same(f"schoolbook_round {name} [{Bs}, {rr}, {Nr}] in place", acc_r, want)
        lay = K.schoolbook_round_layout(Nr, rr)
        r_inst[lay["instance"]] = lay
        lay = {k: lay[k] for k in ("cluster", "ciphertexts", "threads", "shared_bytes", "instance")}
        print(f"kernel schoolbook_round {name} [*, {rr}, {Nr}] (Bg/2 {Pr.half_bg}, layout {lay}): "
              f"bit-identical to its twin and to S1 with its glue at batches {batches}, "
              f"worst-case digits and in place", flush=True)
        del bk_s, spec, acc_r, want, s1w
    r_regs = {}
    for inst in sorted(r_inst):  # registers, spills and the cluster of every instance launched
        r_regs[f"registers_{inst}"], r_regs[f"spill_bytes_{inst}"] = ptxas_usage(ptxas, inst)
        r_regs[f"cluster_{inst}"] = r_inst[inst]["cluster"]
        r_regs[f"ciphertexts_per_cluster_{inst}"] = r_inst[inst]["ciphertexts"]
    r_ms, r_turns, r_dev = {}, {}, {}
    for name, Bs in (("medium_v2", 512), ("medium", 512), ("large_v2", 512), ("large", 512),
                     ("medium_v2", 4)):
        Pr = get_params(name)
        Nr, rr = Pr.N, Pr.decomp_rows
        bk_s = ri(-2**31, 2**31, (rr, 2, Nr))
        spec = K.key_spectra(bk_s)
        acc_r, t_r = ri(-2**31, 2**31, (Bs, 2, Nr)), ri(0, 2 * Nr, (Bs,))
        out_r = torch.empty_like(acc_r)
        ops_r = bs.RoundOps(Pr)
        dg = ops_r.decompose(ops_r.rotate(acc_r, t_r) - acc_r)

        def s1_glue():
            d_ = ops_r.decompose(ops_r.rotate(acc_r, t_r) - acc_r)
            return acc_r + K.schoolbook_product(d_, bk_s, Pr.half_bg)

        turns = {}
        for tag, f in (("s1_glue", s1_glue), ("round", lambda: K.schoolbook_round(
                acc_r, t_r, spec, Pr, out=out_r)), ("s1", lambda: K.schoolbook_product(
                dg, bk_s, Pr.half_bg)), ("round", lambda: K.schoolbook_round(
                acc_r, t_r, spec, Pr, out=out_r)), ("s1_glue", s1_glue)):
            turns.setdefault(tag, []).append(cuda_ms(f, 10, warmup=2))
        key = f"{name}_{Bs}"
        r_turns[key] = turns
        r_ms[key] = min(turns["round"])
        if name == "medium_v2":  # the launch path beside the device at a gate's 4 and at 512
            launch_us[f"schoolbook_round [{Bs}, {rr}, {Nr}]"] = host_us(
                lambda: K.schoolbook_round(acc_r, t_r, spec, Pr, out=out_r))
            r_dev[key] = device_ms(lambda: K.schoolbook_round(acc_r, t_r, spec, Pr, out=out_r),
                                   "schoolbook_round_kernel", required=False)
        if (name, Bs) == ("medium_v2", 512):
            r_twin = cuda_ms(lambda: K.schoolbook_round_plain(acc_r, t_r, spec, Pr), 3)
            r_bytes = schoolbook_round_bytes(Bs, rr, Nr)
        tw_flops = schoolbook_round_flops(Bs, rr, Nr)
        tw_ms, tw_vec = fp64_ms(tw_flops), fp64_ms(tw_flops, PEAK_FP64_FLOPS)
        by_ms = schoolbook_round_bytes(Bs, rr, Nr) / PEAK_BYTES * 1e3
        b2n = fp64_ms(schoolbook_fft_flops(Bs, rr, Nr))
        print(f"time schoolbook_round {name} [{Bs}, {rr}, {Nr}]: {turns['round'][0]:.4f}, "
              f"{turns['round'][1]:.4f} ms; S1 alone {turns['s1'][0]:.4f}; S1 and its glue "
              f"{turns['s1_glue'][0]:.4f}, {turns['s1_glue'][1]:.4f} (in turns); bound "
              f"{max(tw_ms, by_ms):.4f} ms by {'operations' if tw_ms >= by_ms else 'bytes'} "
              f"(twisted flops {tw_ms:.4f}: transforms {tw_flops[0]} flops at "
              f"{PEAK_FP64_FLOPS:.4g}/s, MAC {tw_flops[1]} flops at DMMA's "
              f"{PEAK_FP64_TENSOR_FLOPS:.4g}/s; {tw_vec:.4f} with the MAC at the vector rate; "
              f"bytes {by_ms:.4f}; the 2N-FFT flops {b2n:.4f}), "
              f"{max(tw_ms, by_ms) / r_ms[key]:.4f} of it, on {card}", flush=True)
        del bk_s, spec, acc_r, out_r, dg
    # the n rounds of a PBS from one C loop (schoolbook_rounds, the paths'
    # door) at a gate's 4, n cut to 16: against the twin's loop, 16 launches
    # at the door, and each round's events against its device time
    Pr, nr = PV, 16
    acc_r, ts_r = ri(-2**31, 2**31, (4, 2, Pr.N)), ri(0, 2 * Pr.N, (nr, 4))
    spec = K.key_spectra(ri(-2**31, 2**31, (nr, Pr.decomp_rows, 2, Pr.N)))
    before = launches.get("schoolbook_round")
    got_r = K.schoolbook_rounds(acc_r, ts_r, spec, Pr)
    if launches.get("schoolbook_round") != before + nr:
        fail(f"schoolbook_rounds counted {launches.get('schoolbook_round') - before} launches "
             f"for {nr} rounds")
    r_err = max(r_err, same(f"schoolbook_rounds {Pr.name} [4, {Pr.decomp_rows}, {Pr.N}] x {nr}",
                            got_r, K.schoolbook_rounds_plain(acc_r, ts_r, spec, Pr)))
    rounds_ms = cuda_ms(lambda: K.schoolbook_rounds(acc_r, ts_r, spec, Pr), 20, warmup=2) / nr
    launch_us[f"schoolbook_rounds [4, {Pr.decomp_rows}, {Pr.N}] x {nr}, a round"] = host_us(
        lambda: K.schoolbook_rounds(acc_r, ts_r, spec, Pr), 20) / nr
    rd_ms, _, rd_n, _ = device_ms(lambda: K.schoolbook_rounds(acc_r, ts_r, spec, Pr),
                                  "schoolbook_round_kernel", reps=5, per_call=nr, required=False)
    r_dev["rounds_medium_v2_4"] = (rd_ms and rd_ms / nr, None, rd_n)  # a round
    print(f"schoolbook_rounds {Pr.name} [4, {Pr.decomp_rows}, {Pr.N}] x {nr}: bit-identical to "
          f"the twin's loop, {nr} launches at the door; {rounds_ms:.4f} ms a round by events "
          f"(one call, 20 back to back), {ms_text(r_dev['rounds_medium_v2_4'][0])} a round on "
          f"the device ({rd_n} launches traced in 5 calls); a single round's events "
          f"{r_ms[f'{Pr.name}_4']:.4f} ms, device {ms_text(r_dev[f'{Pr.name}_4'][0])} "
          f"({r_dev[f'{Pr.name}_4'][2]} launches traced in 20 calls) on {card}", flush=True)
    print(f"launch path, host us a call, phase 11 "
          f"({', '.join(f'{k} {v:.2f}' for k, v in launch_us.items() if 'schoolbook' in k)}) "
          f"on {card}", flush=True)
    del acc_r, ts_r, spec, got_r
    Bm, Pv = 512, PV
    r_key = f"{Pv.name}_{Bm}"
    rf_flops = schoolbook_round_flops(Bm, Pv.decomp_rows, Pv.N)
    rf = fp64_ms(rf_flops)
    report("schoolbook_round", [Bm, Pv.decomp_rows, Pv.N], r_err, r_ms[r_key], r_twin, r_bytes,
           0, "redsec_tpu/crypto/bootstrap.py:538", "schoolbook_fft.cu", ops_ms=rf,
           params=("medium_v2", "medium", "large", "large_v2", "small_v2_tpu/schoolbook"),
           share_of_bound=max(rf, r_bytes / PEAK_BYTES * 1e3) / r_ms[r_key],
           bound_twisted_fp64_ms=rf, bound_twisted_mac_at_vector_rate_ms=fp64_ms(
               rf_flops, PEAK_FP64_FLOPS), transform_flops=rf_flops[0], mac_flops=rf_flops[1],
           fp64_vector_flops_per_s=PEAK_FP64_FLOPS, fp64_dmma_flops_per_s=PEAK_FP64_TENSOR_FLOPS,
           bound_fp64_fft_2n_ms=fp64_ms(schoolbook_fft_flops(Bm, Pv.decomp_rows, Pv.N)),
           ms_in_turns=r_turns, ms_by_shape=r_ms,
           host_us={k: v for k, v in launch_us.items() if k.startswith("schoolbook_round")},
           device_ms_traced={k: v[0] for k, v in r_dev.items()},
           rounds_a_launch_ms=rounds_ms,
           layout={k: v for k, v in K.schoolbook_round_layout(Pv.N, Pv.decomp_rows).items()
                   if k in ("cluster", "ciphertexts", "threads", "shared_bytes", "instance")},
           shared_bytes={i: lay_["shared_bytes"] for i, lay_ in r_inst.items()}, **r_regs)
    print(f"kernel schoolbook_round build: {r_regs}", flush=True)

    # the forced-schoolbook PBS against K4's on the small_v2_tpu key (real noise)
    sbkey = bs.prepare_cloud_key(cloud, device="cuda", schoolbook=True)
    ct64 = lwe.encrypt_integers(sk.lwe_key, np.random.default_rng(4).integers(-1500, 1500, 64),
                                P, np.random.default_rng(5))
    tv1 = bs.const_test_vector(P, 1, P.msg_space)
    launches.reset()
    got_sb = bs.make_batched_bootstrap(sbkey)(ct64, tv1)
    torch.cuda.synchronize()
    by_path["schoolbook/small_v2_tpu"] = (f"{P.name}/schoolbook", dict(launches.counts))
    want_k4 = bs.make_batched_bootstrap(dkey)(ct64, tv1)
    if launches.get("schoolbook_round") != n or not torch.equal(got_sb, want_k4):
        fail(f"the forced-schoolbook PBS at {P.name} differs from K4's "
             f"({launches.counts}, {ct64.shape[0]} ciphertexts)")
    print(f"schoolbook PBS at {P.name} (forced, {n} schoolbook round launches at "
          f"[{ct64.shape[0]}, {rows}, {N}]): bit-identical to K4's PBS on the same key and "
          f"ciphertexts; a-priori rounding bound of the key "
          f"{K.schoolbook_key_bound(sbkey.bk, P):.6g}", flush=True)
    del sbkey, got_sb, want_k4

    # the other sets at full N, n cut to 16: S1's path against the twin's
    for name in ("medium", "large", "large_v2"):
        Pr = dataclasses.replace(get_params(name), name=f"{name}_n16", n=16)
        t0 = time.perf_counter()
        rsk, rcloud = kg.keygen(Pr, seed=0)
        rkey = bs.prepare_cloud_key(rcloud, device="cuda")
        vals = np.random.default_rng(6).integers(-1500, 1500, size=8)
        rct = lwe.encrypt_integers(rsk.lwe_key, vals, Pr, np.random.default_rng(7))
        rtv = bs.const_test_vector(Pr, 1, Pr.msg_space)
        launches.reset()
        rout = bs.make_batched_bootstrap(rkey)(rct, rtv)
        torch.cuda.synchronize()
        by_path[f"reduced/{name}"] = (name, dict(launches.counts))
        with mock.patch.object(K, "schoolbook_rounds", K.schoolbook_rounds_plain):
            rplain = bs.make_batched_bootstrap(rkey)(rct, rtv)
        if launches.get("schoolbook_round") != Pr.n or not torch.equal(rout, rplain):
            fail(f"{Pr.name}: the PBS through the schoolbook round kernel differs from the "
                 f"twin's ({launches.counts})")
        dec = lwe.decrypt_integers(rsk.lwe_key, rout.cpu().numpy(), Pr)
        print(f"schoolbook PBS {Pr.name} (N {Pr.N}, {Pr.decomp_rows} digit rows, real noise): "
              f"8 ciphertexts through the schoolbook round kernel bit-identical to the twin "
              f"path (key bound {K.schoolbook_key_bound(rkey.bk, Pr):.6g}); signs "
              f"{float((dec == np.where(vals >= 0, 1, -1)).mean()):.3f} right (informational) "
              f"({time.perf_counter() - t0:.1f} s with keygen)", flush=True)
        del rkey, rout, rplain

    # the full-width path: the CLI at medium_v2 on one image; layer 0's first
    # 8 ciphertexts, its test vector, outputs and key are kept at the door
    work2 = os.path.join(HERE, "build", "smoke_schoolbook")  # a 1.6 GB eval key
    shutil.rmtree(work2, ignore_errors=True)
    vdir = os.path.join(work2, PV.name)
    kept, sb_door = {}, []

    def keeping(dkey_, chunk=512, round_kernel=None, _real=renc.make_chunked_bootstrap):
        run = _real(dkey_, chunk=chunk, round_kernel=round_kernel)

        def kept_run(ct_, tv_):
            out_ = run(ct_, tv_)
            if not kept:
                kept.update(dkey=dkey_, ct=torch.as_tensor(ct_)[:8].clone(), out=out_[:8].clone(),
                            tv=tv_ if np.ndim(tv_) == 1 else tv_[:8])
            if args.profile and "ct512" not in kept and len(ct_) >= 512:
                # the first full chunk of the path, traced below
                kept.update(ct512=torch.as_tensor(ct_)[:512].clone(),
                            tv512=tv_ if np.ndim(tv_) == 1 else tv_[:512])
            return out_
        return kept_run

    def door_round(acc, ts, spectra, params, _real=K.schoolbook_rounds):
        # one call carries a PBS chunk's rounds: each round's batch at the door
        sb_door.extend([acc.shape[0]] * ts.shape[0])
        return _real(acc, ts, spectra, params)

    launches.reset()
    t0 = time.perf_counter()
    run_cli("keygen", "--params", PV.name, "--seed", 0, "--out-dir", vdir)
    t_keygen = time.perf_counter() - t0
    write_image_ptxt(os.path.join(vdir, "image.ptxt"), 0, raw[0])
    run_cli("encrypt-image", "--secret", os.path.join(vdir, "secret.key.npz"),
            "--image-ptxt", os.path.join(vdir, "image.ptxt"),
            "--out", os.path.join(vdir, "image.ctxt.npz"))
    with mock.patch.object(renc, "make_chunked_bootstrap", keeping), \
            mock.patch.object(K, "schoolbook_rounds", door_round):
        _, vrec = run_cli("run-encrypted", "--model", model.name, "--weights", weights,
                          "--eval", os.path.join(vdir, "eval.key.npz"),
                          "--image", os.path.join(vdir, "image.ctxt.npz"),
                          "--out", os.path.join(vdir, "out.ctxt.npz"))
    torch.cuda.synchronize()
    vcounts = dict(launches.counts)
    by_path[f"cli/{PV.name}"] = (PV.name, vcounts)
    sb_chunks = sum(len(range(0, b, pbs_chunk)) for b in sign_boots if b)
    want_s1 = sb_chunks * PV.n
    if (vrec["pbs"], vrec["round_launches"], vrec["s1_launches"], vrec["k4_launches"],
            vcounts.get("schoolbook_round"), len(sb_door), sum(sb_door)) != (
            pbs_per_image, want_s1, 0, 0, want_s1, want_s1, PV.n * pbs_per_image):
        fail(f"cli/{PV.name}: run-encrypted reports {vrec}, counters {vcounts}, "
             f"{len(sb_door)} round launches at the door carrying {sum(sb_door)} "
             f"ciphertext-rounds; expected {pbs_per_image} PBS in {sb_chunks} chunks of "
             f"{PV.n} schoolbook round launches")
    text, _ = run_cli("decrypt-image", "--secret", os.path.join(vdir, "secret.key.npz"),
                      "--output", os.path.join(vdir, "out.ctxt.npz"))
    vcls = decrypted_class(text)
    vsk = kio.load_secret_key(os.path.join(vdir, "secret.key.npz"))
    vct = kio.load_ciphertexts(os.path.join(vdir, "out.ctxt.npz"))
    vscores = decrypt_scores(vsk, vct[0].reshape(-1, 10, PV.n + 1), PV, vct[3], vct[4])
    if int(vscores[0].argmax()) != vcls:
        fail(f"cli/{PV.name}: decrypt-image printed {vcls}, the scores' argmax is "
             f"{int(vscores[0].argmax())}")
    # layer 0's first 8 ciphertexts through the twin path, 3,072 rounds
    t0 = time.perf_counter()
    with mock.patch.object(K, "schoolbook_rounds", K.schoolbook_rounds_plain):
        vtwin = bs.make_batched_bootstrap(kept["dkey"])(kept["ct"], kept["tv"])
    torch.cuda.synchronize()
    t_twin = time.perf_counter() - t0
    if not torch.equal(vtwin, kept["out"]):
        fail(f"cli/{PV.name}: layer 0's first 8 PBS through the twin differ from the kernel's")
    print(f"cli/{PV.name}: layer 0's first 8 PBS through the twin path on the card "
          f"({PV.n} rounds, {t_twin:.1f} s) bit-identical to the kernel path's", flush=True)
    print(f"cli/{PV.name} keygen: {t_keygen:.1f} s (host numpy, key files written)", flush=True)
    print(f"cli/{PV.name} run: {vrec['seconds']:.3f} s for {vrec['pbs']} PBS", flush=True)
    print(f"cli/{PV.name} PBS/s: {vrec['pbs_per_s']:.4f} on {card}", flush=True)
    print(f"cli/{PV.name} class: decrypted {vcls}, plaintext oracle {int(preds[0])} "
          f"(informational)", flush=True)
    if args.profile:
        # one 512-chunk of the path through the CLI's bootstrap (n launches
        # of the schoolbook round kernel, and the PBS's torch glue around them)
        prof_run = renc.make_chunked_bootstrap(kept["dkey"], chunk=pbs_chunk)
        prof_run(kept["ct512"], kept["tv512"])
        torch.cuda.synchronize()
        # the tracer can miss launches right after it starts, and now and then
        # drops one of a long run (as in device.device_ms): it starts a step
        # early, and a trace short of the n launches is taken again
        for p_try in range(3):
            p_wall, p_busy, p_rows = profile_forward(
                lambda c: prof_run(c, kept["tv512"]), kept["ct512"], card,
                f"{PV.name}_chunk512", warmup=lambda: prof_run(
                    kept["ct512"][:1], kept["tv512"] if np.ndim(kept["tv512"]) == 1
                    else kept["tv512"][:1]))
            p_s1 = sum(ms for key, ms, _ in p_rows if "schoolbook_round" in key)
            p_s1_n = sum(c for key, _, c in p_rows if "schoolbook_round" in key)
            if p_s1_n == PV.n:
                break
            print(f"profile {PV.name}: trace {p_try + 1} holds {p_s1_n} round launches, not "
                  f"{PV.n}", flush=True)
        else:
            fail(f"profile {PV.name}: no trace of 3 holds the {PV.n} round launches")
        slices[f"profile/{PV.name}_chunk512"] = {
            "wall_ms": p_wall, "device_busy_ms": p_busy, "idle_share": 1 - p_busy / p_wall,
            "round_ms": p_s1, "round_share_of_busy": p_s1 / p_busy, "glue_ms": p_busy - p_s1,
            "glue_share_of_busy": (p_busy - p_s1) / p_busy}
        print(f"profile {PV.name}_chunk512: wall {p_wall:.3f} ms, device busy {p_busy:.3f} ms, "
              f"idle share {1 - p_busy / p_wall:.4f}; schoolbook round kernel {p_s1:.3f} ms "
              f"x{p_s1_n} ({p_s1 / p_busy:.4f} of busy), torch glue and key switch "
              f"{p_busy - p_s1:.3f} ms ({(p_busy - p_s1) / p_busy:.4f}) on {card}", flush=True)
    slices[f"cli/{PV.name}"] = {"params": PV.name, **vrec, "keygen_s": t_keygen,
                                "twin_check_s": t_twin, "class": vcls,
                                "oracle_class": int(preds[0]),
                                "round_launches_at_door": len(sb_door)}

    # GateSet: truth tables at small_v2_tpu (K4), AND at medium_v2 (S1-fft)
    a2, b2, s2 = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1]), np.array([1, 0, 1, 0])
    tables = {"AND": a2 & b2, "OR": a2 | b2, "NAND": 1 - (a2 & b2), "NOR": 1 - (a2 | b2),
              "XOR": a2 ^ b2, "XNOR": 1 - (a2 ^ b2), "ANDNY": (1 - a2) & b2,
              "ANDYN": a2 & (1 - b2), "ORNY": (1 - a2) | b2, "ORYN": a2 | (1 - b2)}
    for gname, gkey, gsk, names in ((P.name, dkey, sk, list(tables) + ["MUX"]),
                                    (PV.name, kept["dkey"], vsk, ["AND"])):
        gp = gkey.params
        gs = gates.GateSet(gkey)
        enc = [torch.as_tensor(gates.gate_encrypt_host(gsk.lwe_key, v, gp,
                                                       np.random.default_rng(i)), device=dev)
               for i, v in enumerate((a2, b2, s2))]
        launches.reset()
        t0 = time.perf_counter()
        for g in names:
            res = gs.MUX(enc[2], enc[0], enc[1]) if g == "MUX" else getattr(gs, g)(enc[0], enc[1])
            got_bits = gates.gate_decrypt_host(gsk.lwe_key, res.cpu().numpy(), gp)
            want_bits = np.where(s2, a2, b2) if g == "MUX" else tables[g]
            if not np.array_equal(got_bits, want_bits):
                fail(f"gates/{gname}: {g} gives {got_bits.tolist()}, want {want_bits.tolist()}")
        torch.cuda.synchronize()
        by_path[f"gates/{gname}"] = (gname, dict(launches.counts))
        print(f"gates/{gname}: {', '.join(names)} truth tables right on the card "
              f"({time.perf_counter() - t0:.1f} s, launches {dict(launches.counts)})", flush=True)
        if gname != PV.name:
            continue
        # the AND's wall (host clock around a call and a synchronize) beside
        # the device time of its n rounds and of every kernel (one traced
        # call, which must see all n round launches)
        and_walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            gs.AND(enc[0], enc[1])
            torch.cuda.synchronize()
            and_walls.append((time.perf_counter() - t1) * 1e3)
        r_all, busy, r_seen, _ = device_ms(lambda: gs.AND(enc[0], enc[1]),
                                           "schoolbook_round_kernel", reps=1, per_call=gp.n,
                                           required=False)
        wall = sum(and_walls) / len(and_walls)
        slices[f"gates/{gname}/AND"] = {
            "wall_ms": and_walls, "rounds_device_ms": r_all, "rounds_traced": r_seen,
            "device_busy_ms": busy, "wall_over_rounds": r_all and wall / r_all,
            "idle_share": busy and 1 - busy / wall}
        traced = ("not measured (the profiler never saw all its launches)" if r_all is None else
                  f"{r_all:.3f} ms on the device ({r_seen} launches traced), every kernel "
                  f"{busy:.3f} ms; wall {wall / r_all:.3f}x the rounds' device time, idle share "
                  f"{1 - busy / wall:.4f}")
        print(f"gates/{gname} AND [4 ciphertexts]: wall {', '.join(f'{w:.3f}' for w in and_walls)} "
              f"ms; its {gp.n} rounds {traced} on {card}", flush=True)
    del kept, vtwin
    shutil.rmtree(work2)
    torch.cuda.empty_cache()
    slices["schoolbook_phase_s"] = time.perf_counter() - t_phase
    print(f"schoolbook phase: {slices['schoolbook_phase_s']:.1f} s", flush=True)

    # ---- phase 12: the calibration knobs, the agreement forecast, the
    # "matmul" key flavour and torch.distributed at world size 1 (NCCL)
    t_phase = time.perf_counter()
    phase12({"P": P, "dev": dev, "sk": sk, "cloud": cloud, "dkey": dkey, "mplan": mplan,
             "weights": weights, "images": images, "raw": raw, "preds": preds,
             "rraw": raw * ink, "run_cli": run_cli, "card": card, "batch": BATCH,
             "pbs_chunk": pbs_chunk, "by_path": by_path, "slices": slices,
             "work": os.path.join(HERE, "build", "smoke_phase12")})
    slices["phase12_s"] = time.perf_counter() - t_phase
    print(f"phase 12: {slices['phase12_s']:.1f} s", flush=True)

    # ---- phase 13: the BYON trainers, trained weights through K4, the native
    # oracle and entry()
    t_phase = time.perf_counter()
    phase13({"P": P, "dev": dev, "sk": sk, "cloud": cloud, "dkey": dkey, "card": card,
             "pbs_chunk": pbs_chunk, "by_path": by_path, "slices": slices})
    slices["phase13_s"] = time.perf_counter() - t_phase
    print(f"phase 13: {slices['phase13_s']:.1f} s", flush=True)

    # ---- phase 14: the batch runner with its checkpoint, the noise-budget
    # and full-geometry scripts
    t_phase = time.perf_counter()
    phase14({"card": card, "mplan": mplan, "weights": weights, "pbs_chunk": pbs_chunk,
             "by_path": by_path, "slices": slices,
             "work": os.path.join(HERE, "build", "smoke_runner")})
    slices["phase14_s"] = time.perf_counter() - t_phase
    print(f"phase 14: {slices['phase14_s']:.1f} s", flush=True)

    # each kernel's launches on the paths of its parameter sets (the records
    # of one kernel's shapes share its counter; a bundled key's path is
    # "<set>/bundle2")
    for name, r in rec.items():
        counter, params = r.get("counter", name), r.get("params")
        sets = (params,) if params is None or isinstance(params, str) else tuple(params)
        r["launches_by_path"] = {k: c[counter] for k, (pn, c) in by_path.items()
                                 if c.get(counter) and (params is None or pn in sets)}
        r["launches"] = sum(r["launches_by_path"].values())
    never = [name for name, r in rec.items() if r["launches"] == 0 and name not in (
        "external_product", "cmux_round", "schoolbook_product")]
    if never:  # the radix-2 round kernels are the body of blind_rotate on every path, and
        # the schoolbook round kernel took S1's place on the schoolbook paths
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
