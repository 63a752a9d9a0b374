"""Time the blind-rotation kernels K1-K4 and the schoolbook product S1 of
one checkout on the card.

    python -m redsec_tpu_torch.scripts.time_kernels
    python redsec_tpu_torch/scripts/time_kernels.py --root build/parent --tag parent
    python -m redsec_tpu_torch.scripts.time_kernels --sets small_v2_n2048,small,small_v2_tpu/2

``--root`` names the checkout whose ``redsec_tpu_torch`` is imported (default:
the one this file lies in), so two checkouts can be timed one after the other
inside one call on one card, which is the only way their times compare.  Only
the wrappers' public signatures are used (the timer is this checkout's
``device.cuda_ms`` whichever checkout is timed).  Every kernel is first held
against its plain twin (exact equality), then timed with CUDA events: K1 at
[6144, 1024], K2 and K3 on 64 ciphertexts, K4 at a full chunk of 512 and at 32
at ``small_v2_tpu``, and at 512 at every other parameter set of ``--sets``
(``name`` or ``name/2`` for a bundled key; default ``small_v2``, the CLI's
set), with the layout the checkout's ``blind_rotate_config`` reports; S1,
where the checkout has it, at batch 512 at N 4096 and 8192 with 6 and 8 digit
rows (the schoolbook sets) and at 196 (``medium_v2``'s first sign1024x1
chunk) and 4 (a gate), with its float64-FFT twin timed beside it at [512, 8,
4096].  ``--flavor matmul`` (or ``radix2,matmul``, both in one process) times
instead, or as well, the four-step kernels on a "matmul" key prepared from
the same raw key (K2-mm and K3-mm on 64 ciphertexts, K4-mm at 512 and 32 at
``small_v2_tpu`` and at 512 at the sets of ``--sets`` that ``supported_mm``
takes), each held against its twin, and K4-mm at 512 against K4 on the
radix-2 key where both run.  ``--forward`` times as well the main path's
slice: ``mnist/sign1024x1`` with the golden weights of ``tests/golden`` at
``small_v2_tpu`` on 8 synthetic images (seed 1), one warm-up forward and then
``FORWARD_REPS`` timed ones (host clock around ``synchronize()``, the key
prepared beforehand), each with its PBS/s.  A set of ``--sets`` without
NTT primes (``medium``, ``large``, ``medium_v2``, ``large_v2``) times one
schoolbook CMUX round at 512 instead of K4: S1 with its torch glue (rotate,
difference, decompose, the add), and, where the checkout has it, the
schoolbook round kernel (``schoolbook_round``) beside it in turns, each held
against the other; ``--rounds-only`` times only those rounds, each item
``name@B`` at batch B (default 512), and the command line;
``--round-mm-only`` times only K2-mm and K3-mm, each item ``name@M1/M2``
at those batches (default 1, 32, 64, 133, 512) at every split the
checkout's kernels take (one block a ciphertext, a cluster pair) and at
the one its wrapper picks.  ``--cli SET``
times ``run-encrypted`` of the checkout's command line on one
``mnist/sign1024x1`` image at SET (its JSON record: seconds, PBS/s,
launches); the key files are made by the command line into ``--work`` on
first use and reused, so two checkouts run on the same key.  ``--paths``
times only the 512-batch paths: the forward of ``--forward``,
``run-encrypted`` of ``--cli medium_v2`` and of one ``cifar/binarynet``
image at ``small_v2_tpu`` with its trained weights and calibration (as
``chip_smoke.py`` runs it).  ``--launch``
times only the host path of a launch: for each wrapper (K1 at its smallest
main-path shape, K2, K3, K2-mm and K3-mm on 64 ciphertexts, K5 and K6 at
[512, 2, 1024], K7 beside ``torch.take`` over its fixed index table, the
schoolbook round kernel at ``medium_v2`` at a gate's 4 and at 512, and
``schoolbook_rounds`` at both where the checkout has it) the host
microseconds a call (``time.perf_counter_ns`` around calls with no
synchronize between them), that call by step (each step in a loop of its
own), CUDA events of back-to-back calls and the device time (profiler);
and the AND gate at full ``medium_v2``: its wall time, its rounds' device
time and the idle share; with ``--graph`` also K7 beside ``torch.take`` in
turns, 200 calls between one event pair and one CUDA-graph replay of 200
captured calls.  One JSON line per run ends the output.

    python redsec_tpu_torch/scripts/time_kernels.py --root build/parent --tag parent \
        --sets medium_v2,large --cli medium_v2
    python redsec_tpu_torch/scripts/time_kernels.py --rounds-only \
        --sets medium_v2,medium,large_v2,large,medium_v2@4 --cli medium_v2
    python redsec_tpu_torch/scripts/time_kernels.py --launch --root build/parent --tag parent
    python redsec_tpu_torch/scripts/time_kernels.py --launch
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
K4_BATCHES = (512, 32)  # a full PBS chunk and the smallest chunk of the model paths
K4_REPS = 3
FORWARD_REPS = 3
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(HERE)), "tests", "golden",
                       "sign1024x1_var_prep_from_ref_wght.dat")
# S1 shapes (N, digit rows, batch, Bg/2): medium_v2 at both chunk sizes of the
# sign1024x1 path and a gate's batch, medium, large, large_v2
S1_SHAPES = ((4096, 8, 512, 128), (4096, 8, 196, 128), (4096, 8, 4, 128),
             (4096, 6, 512, 512), (8192, 6, 512, 512), (8192, 8, 512, 128))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)),
                    help="checkout to import redsec_tpu_torch from")
    ap.add_argument("--tag", default="change", help="name of this checkout in the output")
    ap.add_argument("--sets", default="small_v2",
                    help="comma-separated parameter sets (name, or name/2 for a bundled "
                         "key) whose K4 is timed at batch 512 besides small_v2_tpu")
    ap.add_argument("--flavor", default="radix2",
                    help="comma-separated key flavours whose kernels are timed: radix2 (K1-K4, "
                         "S1), matmul (K2-mm, K3-mm, K4-mm)")
    ap.add_argument("--forward", action="store_true",
                    help="also time the sign1024x1 forward at small_v2_tpu on 8 images")
    ap.add_argument("--cli", default="",
                    help="also time run-encrypted on one sign1024x1 image at this set")
    ap.add_argument("--rounds-only", action="store_true",
                    help="time only the schoolbook rounds of --sets (set@batch, default batch "
                         "512) and --cli: no K1-K4, no S1 list")
    ap.add_argument("--round-mm-only", action="store_true",
                    help="time only K2-mm and K3-mm on a 'matmul' key of each item of --sets "
                         "(set@M1/M2/..., default batches 1/32/64/133/512) at every split")
    ap.add_argument("--launch", action="store_true",
                    help="time only the host path of a launch: each wrapper's host us a call and "
                         "by step, its events and device time, K7 beside torch.take, and the AND "
                         "gate at full medium_v2")
    ap.add_argument("--graph", action="store_true",
                    help="K7 and torch.take in turns, 200 calls between one event pair and in "
                         "one CUDA graph replay (alone, or after --launch's list)")
    ap.add_argument("--paths", action="store_true",
                    help="time only the 512-batch paths: the sign1024x1 forward at small_v2_tpu "
                         "(8 images), run-encrypted on one sign1024x1 image at medium_v2 and "
                         "on one cifar/binarynet image at small_v2_tpu")
    ap.add_argument("--work", default=os.path.join(os.path.dirname(os.path.dirname(HERE)),
                                                   "build", "time_kernels_cli"),
                    help="where --cli keeps its key and image files")
    args = ap.parse_args(argv)
    flavors = set(filter(None, args.flavor.split(",")))
    if not flavors or flavors - {"radix2", "matmul"}:
        ap.error(f"--flavor takes radix2 and matmul, got {args.flavor!r}")
    spec = importlib.util.spec_from_file_location(
        "time_kernels_device", os.path.join(os.path.dirname(HERE), "device.py"))
    own_device = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(own_device)
    ms = own_device.cuda_ms
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    from redsec_tpu_torch.crypto import bootstrap as bs
    from redsec_tpu_torch.crypto import kernels as K
    from redsec_tpu_torch.crypto import keygen as kg
    from redsec_tpu_torch.crypto.params import SMALL_V2_TPU as P
    from redsec_tpu_torch.crypto.params import get_params

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = np.random.default_rng(7)

    def ri(lo, hi, shape):
        return torch.as_tensor(gen.integers(lo, hi, size=shape, dtype=np.int64)
                               .astype(np.int32), device=dev)

    def same(name, got, want):
        if not torch.equal(got, want):
            raise SystemExit(f"{args.tag}: {name} differs from its plain twin")

    if args.paths:
        _, cloud = kg.keygen(P, seed=0)
        out = {"tag": args.tag, "card": card}
        _time_forward(args, out, P, bs.prepare_cloud_key(cloud, device="cuda"))
        _time_cli(args, out, get_params("medium_v2"))
        _time_cli(args, out, P, "cifar/binarynet")
        print(json.dumps(out), flush=True)
        return out
    if args.graph and not args.launch:  # K7 and torch.take alone
        from redsec_tpu_torch.crypto import probe_kernels as PK

        out = {"tag": args.tag, "card": card}
        w7 = ri(-2**31, 2**31, (1, 2 * PK.TOEPLITZ_TILE))
        kk = torch.arange(PK.TOEPLITZ_TILE, device=dev)
        idx7 = PK.TOEPLITZ_TILE - 1 + kk[None, :] - kk[:, None]
        same("toeplitz_tile", PK.toeplitz_tile(w7), torch.take(w7, idx7))
        _time_k7_graph(args, out, own_device, lambda: PK.toeplitz_tile(w7),
                       lambda: torch.take(w7, idx7))
        print(json.dumps(out), flush=True)
        return out
    if args.launch:
        out = {"tag": args.tag, "card": card}
        _time_launch(args, out, own_device, ri, same)
        _time_gate(args, out, own_device)
        print(json.dumps(out), flush=True)
        return out
    if args.rounds_only:
        out = {"tag": args.tag, "card": card}
        for item in filter(None, args.sets.split(",")):
            name, _, b = item.partition("@")
            _time_schoolbook_round(args, out, K, bs, get_params(name), ri, same, own_device,
                                   int(b or 512))
        if args.cli:
            _time_cli(args, out, get_params(args.cli))
        print(json.dumps(out), flush=True)
        return out
    if args.round_mm_only:
        out = {"tag": args.tag, "card": card}
        for item in filter(None, args.sets.split(",")):
            name, _, bs_ = item.partition("@")
            Pr = get_params(name)
            _, cloud_r = kg.keygen(Pr, seed=0)
            mk = bs.prepare_cloud_key(cloud_r, device="cuda", ntt_flavor="matmul")
            batches = tuple(int(b) for b in bs_.split("/")) if bs_ else ROUND_MM_BATCHES
            _time_round_mm(args, out, K, Pr, mk.plan, mk.bk[:, 0].contiguous(), ri, same,
                           own_device, batches)
            del mk
        print(json.dumps(out), flush=True)
        return out
    t0 = time.perf_counter()
    ptxas = K.build_library(K.SOURCE)
    if "matmul" in flavors:
        ptxas += K.build_library(K.MM_SOURCE)
    build_s = time.perf_counter() - t0
    for line in ptxas.splitlines():  # registers, spills and shared memory per kernel
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"{args.tag} ptxas: {line.strip()}", flush=True)
    _, cloud = kg.keygen(P, seed=0)
    dkey = bs.prepare_cloud_key(cloud, device="cuda")
    plan, N, n, rows = dkey.plan, P.N, P.n, P.decomp_rows
    out = {"tag": args.tag, "card": card, "build_s": build_s}
    if "radix2" in flavors:
        x = ri(0, plan.primes[0], (6144, N))
        same("ntt", K.ntt(x, plan, 0), K.ntt_plain(x, plan, 0))
        same("ntt inverse", K.ntt(x, plan, 0, True), K.ntt_plain(x, plan, 0, True))
        out["ntt_ms"] = ms(lambda: K.ntt(x, plan, 0), 50)
        bk0 = dkey.bk[:, 0].contiguous()
        digits = ri(-P.half_bg, P.half_bg, (64, rows, N))
        same("external_product", K.external_product(digits, bk0, plan),
             K.external_product_plain(digits, bk0, plan))
        out["external_product_ms"] = ms(lambda: K.external_product(digits, bk0, plan), 50)
        acc = ri(-2**31, 2**31, (64, 2, N))
        t = ri(0, 2 * N, (64,))
        same("cmux_round", K.cmux_round(acc, t, bk0, P, plan),
             K.cmux_round_plain(acc, t, bk0, P, plan))
        out["cmux_round_ms"] = ms(lambda: K.cmux_round(acc, t, bk0, P, plan), 50)
        runs = [("small_v2_tpu", 1, B) for B in K4_BATCHES]
        for item in filter(None, args.sets.split(",")):
            name, _, bundle = item.partition("/")
            runs.append((name, int(bundle or 1), 512))
        for name, bundle, B in runs:
            Pk = get_params(name)
            if bs.bootstrap_plan(Pk) is None:
                _time_schoolbook_round(args, out, K, bs, Pk, ri, same, own_device)
                continue
            if (name, bundle) != ("small_v2_tpu", 1):
                _, cl = kg.keygen(Pk, seed=0, bundle=bundle)
                dk = bs.prepare_cloud_key(cl, device="cuda")
            else:
                dk = dkey
            acc0, abar = ri(-2**31, 2**31, (B, 2, Pk.N)), ri(0, 2 * Pk.N, (B, Pk.n))
            # the twin on a prefix of the batch (it takes seconds a ciphertext at
            # the larger sets); every ciphertext of a block runs the same code
            m = B if (Pk.N, bundle, len(dk.plan.primes)) == (1024, 1, 2) else 64
            got = K.blind_rotate(acc0, abar, dk.bk, Pk, dk.plan)
            same(f"blind_rotate {name}/{bundle} batch {B}", got[:m],
                 K.blind_rotate_plain(acc0[:m], abar[:m], dk.bk, Pk, dk.plan))
            tag = (("" if name == "small_v2_tpu" else f"_{name}")
                   + ("_bundle2" if bundle == 2 else ""))
            out[f"blind_rotate_ms{tag}_{B}"] = ms(
                lambda: K.blind_rotate(acc0, abar, dk.bk, Pk, dk.plan), K4_REPS)
            cfg = K.blind_rotate_config(B, Pk, dk.plan, bundle)
            out[f"blind_rotate_layout{tag}_{B}"] = cfg
            print(f"{args.tag} K4 {name} bundle {bundle} batch {B}: "
                  f"{out[f'blind_rotate_ms{tag}_{B}']:.4f} ms, {cfg}", flush=True)
            del dk, got
            torch.cuda.empty_cache()
        if hasattr(K, "schoolbook_product"):
            for line in K.build_library(K.SCHOOLBOOK_SOURCE).splitlines():
                if "registers" in line or "spill" in line or "Compiling" in line:
                    print(f"{args.tag} ptxas: {line.strip()}", flush=True)
            # a checkout whose S1 takes Bg/2 (the limb plan of the int8 kernel)
            takes_half = len(inspect.signature(K.schoolbook_product).parameters) == 3
            for Ns, rs, B, half in S1_SHAPES:
                digits, bk = ri(-half, half, (B, rs, Ns)), ri(-2**31, 2**31, (rs, 2, Ns))
                extra = (half,) if takes_half else ()
                same(f"schoolbook_product [{B}, {rs}, {Ns}]",
                     K.schoolbook_product(digits, bk, *extra),
                     K.schoolbook_product_plain(digits, bk, *extra))
                key = f"schoolbook_ms_N{Ns}_rows{rs}_{B}"
                out[key] = ms(lambda: K.schoolbook_product(digits, bk, *extra), 5)
                print(f"{args.tag} S1 [{B}, {rs}, {Ns}]: {out[key]:.4f} ms", flush=True)
                if (Ns, rs, B) == (4096, 8, 512):
                    out["schoolbook_twin_ms_N4096_rows8_512"] = ms(
                        lambda: K.schoolbook_product_plain(digits, bk, *extra), 5)
                    print(f"{args.tag} S1 twin (float64 FFT) [{B}, {rs}, {Ns}]: "
                          f"{out['schoolbook_twin_ms_N4096_rows8_512']:.4f} ms", flush=True)
    if "matmul" in flavors:
        _time_matmul(args, out, K, bs, kg, get_params, cloud, dkey, ri, same, own_device)
    if args.forward:
        _time_forward(args, out, P, dkey)
    if args.cli:
        _time_cli(args, out, get_params(args.cli))
    print(json.dumps(out), flush=True)
    return out


def _time_schoolbook_round(args, out, K, bs, Pk, ri, same, dv, B: int = 512) -> None:
    """One schoolbook CMUX round at ``Pk`` on ``B`` random accumulators and
    exponents and a random raw BK round: S1 with the torch glue around it,
    and the checkout's round kernel where it has one, in turns (glue, kernel,
    kernel, glue), the kernel held against S1 with its glue.  With
    ``--rounds-only``, the round kernel alone, held against its twin and
    timed three times."""
    import torch

    ms = dv.cuda_ms
    N, rows = Pk.N, Pk.decomp_rows
    acc, t = ri(-2**31, 2**31, (B, 2, N)), ri(0, 2 * N, (B,))
    bk = ri(-2**31, 2**31, (rows, 2, N))
    ops = bs.RoundOps(Pk)
    if args.rounds_only:
        spectra, spare = K.key_spectra(bk), torch.empty_like(acc)
        same(f"schoolbook_round {Pk.name} [{B}, {rows}, {N}]",
             K.schoolbook_round(acc, t, spectra, Pk), K.schoolbook_round_plain(acc, t, spectra, Pk))
        key = f"round_ms_{Pk.name}_{B}"

        def one():
            K.schoolbook_round(acc, t, spectra, Pk, out=spare)

        out[key] = [ms(one, 20, warmup=3) for _ in range(3)]
        out[f"round_device_ms_{Pk.name}_{B}"] = dev = dv.device_ms(
            one, "schoolbook_round_kernel")[0]
        print(f"{args.tag} schoolbook round {Pk.name} [{B}, {rows}, {N}]: "
              f"{', '.join(f'{v:.4f}' for v in out[key])} ms (events); device {dev:.4f} ms",
              flush=True)
        return
    takes_half = len(inspect.signature(K.schoolbook_product).parameters) == 3
    extra = (Pk.half_bg,) if takes_half else ()

    def s1_glue():
        return acc + K.schoolbook_product(ops.decompose(ops.rotate(acc, t) - acc), bk, *extra)

    turns = [("s1_glue", s1_glue)]
    if hasattr(K, "schoolbook_round"):
        spectra, spare = K.key_spectra(bk), torch.empty_like(acc)
        same(f"schoolbook_round {Pk.name} [{B}, {rows}, {N}] against S1 and its glue",
             K.schoolbook_round(acc, t, spectra, Pk), s1_glue())
        turns += [("round", lambda: K.schoolbook_round(acc, t, spectra, Pk, out=spare))]
    for tag, f in turns + turns[::-1]:
        out.setdefault(f"{tag}_ms_{Pk.name}_{B}", []).append(ms(f, 10, warmup=2))
    print(f"{args.tag} schoolbook round {Pk.name} [{B}, {rows}, {N}] in turns: "
          + "; ".join(f"{tag} {', '.join(f'{v:.4f}' for v in out[f'{tag}_ms_{Pk.name}_{B}'])} ms"
                      for tag, _ in turns), flush=True)


LAUNCH_CALLS = 200  # calls of one host loop (no synchronize inside)
LAUNCH_ROUNDS = 16  # rounds of the schoolbook_rounds case


def _launch_steps(K, host_us, fn, calls: int = LAUNCH_CALLS) -> dict:
    """A wrapper call's host microseconds by step, each step in a loop of its
    own: ``body``, the wrapper with ``Library.launch`` made a no-op (its
    checks, constants, output allocation and pointers); ``launch``, the
    checkout's ``Library.launch`` on the arguments that call gave it (device
    check, stream handle, the C entry, the error check and the count); and
    ``entry``, the C entry alone through the checkout's binding on the
    arguments ``Library.launch`` gave it (argument conversion, the entry's
    own checks and set-up, the kernel launch).  Empty where the wrapper
    reaches no ``Library.launch``."""
    seen, c_args = [], []
    real = K.Library.launch

    def record(lib, entry, kernel, dev, *a, **kw):
        seen.append((lib, entry, kernel, dev, a, kw))

    K.Library.launch = record
    try:
        body = host_us(fn, calls)
    finally:
        K.Library.launch = real
    if not seen:
        return {}
    lib, entry, kernel, dev, a, kw = seen[0]
    c_fn = lib.fn[entry]

    def keep(*args):  # the C entry's own arguments, as launch passes them
        c_args.append(args)
        return c_fn(*args)

    lib.fn[entry] = keep
    try:
        lib.launch(entry, kernel, dev, *a, **kw)
    finally:
        lib.fn[entry] = c_fn
    return {"body": body,
            "launch": host_us(lambda: lib.launch(entry, kernel, dev, *a, **kw), calls),
            "entry": host_us(lambda: c_fn(*c_args[0]), calls)}


def _time_launch(args, out, dv, ri, same) -> None:
    """The host path of a launch, wrapper by wrapper, at the shapes of
    ``--launch``'s list: host microseconds a call (``device.host_us``, three
    loops), the same call by step (``_launch_steps``), CUDA events of
    back-to-back calls and the device time (profiler); K7 beside
    ``torch.take`` over the fixed index table; and the steps every launch
    shares (``torch.cuda.current_device``, the stream handle both ways, a
    call of the binding that reaches no CUDA, the launch count, an output's
    allocation three ways)."""
    import inspect

    import torch

    from redsec_tpu_torch.crypto import bootstrap as bs
    from redsec_tpu_torch.crypto import kernels as K
    from redsec_tpu_torch.crypto import keygen as kg
    from redsec_tpu_torch.crypto import probe_kernels as PK
    from redsec_tpu_torch.crypto.params import SMALL_V2_TPU as P
    from redsec_tpu_torch.crypto.params import get_params
    from redsec_tpu_torch.device import launches

    dev = torch.device("cuda", 0)
    _, cloud = kg.keygen(P, seed=0)
    dkey = bs.prepare_cloud_key(cloud, device="cuda")
    mkey = bs.prepare_cloud_key(cloud, device="cuda", ntt_flavor="matmul")
    plan, N, n, rows = dkey.plan, P.N, P.n, P.decomp_rows
    chunk = inspect.signature(bs.prepare_cloud_key).parameters["chunk"].default
    m1 = ((n - 1) % chunk + 1) * rows * 2 * bs.BK_LIMBS  # K1's smallest main-path rows
    x1 = ri(0, plan.primes[0], (m1, N))
    bk0, mbk0 = dkey.bk[:, 0].contiguous(), mkey.bk[:, 0].contiguous()
    digits = ri(-P.half_bg, P.half_bg, (64, rows, N))
    acc, t = ri(-2**31, 2**31, (64, 2, N)), ri(0, 2 * N, (64,))
    x5, t5 = ri(-2**31, 2**31, (512, 2, N)), ri(0, 2 * N, (512,))
    w7 = ri(-2**31, 2**31, (1, 2 * PK.TOEPLITZ_TILE))
    kk = torch.arange(PK.TOEPLITZ_TILE, device=dev)
    idx7 = PK.TOEPLITZ_TILE - 1 + kk[None, :] - kk[:, None]
    PV = get_params("medium_v2")
    NV, rv = PV.N, PV.decomp_rows
    spec = K.key_spectra(ri(-2**31, 2**31, (LAUNCH_ROUNDS, rv, 2, NV)))
    cases = [  # (name, kernel as the profiler names it, launches a call, call, its twin)
        (f"ntt [{m1}, {N}]", "ntt_kernel", 1, lambda: K.ntt(x1, plan, 0),
         lambda: K.ntt_plain(x1, plan, 0)),
        (f"external_product [64, {rows}, {N}]", "external_product_kernel", 1,
         lambda: K.external_product(digits, bk0, plan),
         lambda: K.external_product_plain(digits, bk0, plan)),
        (f"cmux_round [64, 2, {N}]", "cmux_round_kernel", 1,
         lambda: K.cmux_round(acc, t, bk0, P, plan),
         lambda: K.cmux_round_plain(acc, t, bk0, P, plan)),
        (f"external_product_mm [64, {rows}, {N}]", "external_product_mm_kernel", 1,
         lambda: K.external_product_mm(digits, mbk0, plan),
         lambda: K.external_product_mm_plain(digits, mbk0, plan)),
        (f"cmux_round_mm [64, 2, {N}]", "cmux_round_mm_kernel", 1,
         lambda: K.cmux_round_mm(acc, t, mbk0, P, plan),
         lambda: K.cmux_round_mm_plain(acc, t, mbk0, P, plan)),
        (f"rotate_rows [512, 2, {N}]", "rotate_rows_kernel", 1, lambda: PK.rotate_rows(x5, t5),
         lambda: PK.rotate_plain(x5, t5)),
        (f"rotate_tile [512, 2, {N}] tile 64", "rotate_tile_kernel", 1,
         lambda: PK.rotate_tile(x5, t5, 64), lambda: PK.rotate_plain(x5, t5)),
        ("toeplitz_tile [1, 256]", "toeplitz_tile_kernel", 1, lambda: PK.toeplitz_tile(w7),
         lambda: PK.toeplitz_tile_plain(w7)),
        ("torch.take [1, 256] -> [128, 128]", "", 1, lambda: torch.take(w7, idx7),
         lambda: PK.toeplitz_tile_plain(w7)),
    ]
    for B in (4, 512):
        accv, tv = ri(-2**31, 2**31, (B, 2, NV)), ri(0, 2 * NV, (B,))
        spare = torch.empty_like(accv)
        cases.append((f"schoolbook_round {PV.name} [{B}, {rv}, {NV}]", "schoolbook_round_kernel",
                      1, lambda a=accv, t_=tv, o=spare: K.schoolbook_round(a, t_, spec[0], PV,
                                                                           out=o),
                      lambda a=accv, t_=tv: K.schoolbook_round_plain(a, t_, spec[0], PV)))
        if hasattr(K, "schoolbook_rounds"):
            ts = ri(0, 2 * NV, (LAUNCH_ROUNDS, B))  # round i's exponents in row i

            def twin(a=accv, ts=ts):
                for i in range(LAUNCH_ROUNDS):
                    a = K.schoolbook_round_plain(a, ts[i], spec[i], PV)
                return a

            cases.append((f"schoolbook_rounds {PV.name} [{B}, {rv}, {NV}] x {LAUNCH_ROUNDS}",
                          "schoolbook_round_kernel", LAUNCH_ROUNDS,
                          lambda a=accv, ts=ts: K.schoolbook_rounds(a, ts, spec, PV), twin))
    res = {}
    for name, kernel, per_call, fn, twin in cases:
        same(name, fn(), twin())
        calls = max(5, 2 * LAUNCH_CALLS // per_call)  # at most 400 launches queued a loop
        r = {"host_us": [dv.host_us(fn, calls) for _ in range(3)],
             "steps_us": _launch_steps(K, dv.host_us, fn, calls),
             "events_ms": dv.cuda_ms(fn, calls, warmup=3),
             "device_ms": dv.device_ms(fn, kernel, per_call=per_call)[0]}
        res[name] = r
        st = ", ".join(f"{k} {v:.2f}" for k, v in r["steps_us"].items())
        print(f"{args.tag} launch {name}: host {', '.join(f'{v:.2f}' for v in r['host_us'])} us "
              f"a call (by step: {st or 'no Library.launch'}); events {r['events_ms']:.4f} ms, "
              f"device {r['device_ms']:.5f} ms", flush=True)
    out["launch"] = res
    lib = PK._lib()
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    shared = {"current_device": dv.host_us(torch.cuda.current_device),
              "current_device_raw": dv.host_us(torch._C._cuda_getDevice),
              "current_stream_object": dv.host_us(
                  lambda: torch.cuda.current_stream(dev).cuda_stream),
              "raw_stream": dv.host_us(lambda: raw(0)) if raw else None,
              "binding_no_cuda": dv.host_us(lambda: lib.lib.redsec_error_string(0)),
              "bump": dv.host_us(lambda: launches.bump("time_kernels_probe")),
              "empty_128x128": dv.host_us(lambda: torch.empty((128, 128), dtype=torch.int32,
                                                            device=dev)),
              "empty_like_128x128": dv.host_us(lambda: torch.empty_like(idx7)),
              "new_empty_128x128": dv.host_us(lambda: w7.new_empty((128, 128)))}
    launches.counts.pop("time_kernels_probe", None)
    out["launch_shared_steps_us"] = shared
    print(f"{args.tag} launch steps shared by every wrapper (us): "
          + ", ".join(f"{k} {'absent' if v is None else f'{v:.3f}'}" for k, v in shared.items()),
          flush=True)
    k7, take = res["toeplitz_tile [1, 256]"], res["torch.take [1, 256] -> [128, 128]"]
    print(f"{args.tag} K7 against torch.take: events {k7['events_ms']:.4f} / "
          f"{take['events_ms']:.4f} ms, device {k7['device_ms']:.5f} / {take['device_ms']:.5f} "
          f"ms, host {min(k7['host_us']):.2f} / {min(take['host_us']):.2f} us a call", flush=True)
    if args.graph:
        _time_k7_graph(args, out, dv, lambda: PK.toeplitz_tile(w7), lambda: torch.take(w7, idx7))


GRAPH_CALLS = 200  # K7 / torch.take launches between one event pair, or in one graph


def _time_k7_graph(args, out, dv, k7, take) -> None:
    """K7 beside ``torch.take``, in turns (K7, take, take, K7), two ways, ms
    a call: (a) ``GRAPH_CALLS`` calls between one event pair (the host paces
    back-to-back launches shorter than its path); (b) one replay of a CUDA
    graph that captured ``GRAPH_CALLS`` calls, all in this process (the
    host's path gone: what is left is the device's launch of each kernel and
    its run).  The graph is a measurement here, on no path of the port."""
    import torch

    fns = {"k7": k7, "take": take}
    graphs = {}
    for name, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up on a side stream, as capture asks
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(GRAPH_CALLS):
                fn()
    res = {name: {"events_ms": [], "graph_ms": []} for name in fns}
    for name in ("k7", "take", "take", "k7"):
        res[name]["events_ms"].append(dv.cuda_ms(fns[name], GRAPH_CALLS, warmup=3))
        res[name]["graph_ms"].append(dv.cuda_ms(graphs[name].replay, 5) / GRAPH_CALLS)
    out["k7_graph"] = res
    for way in ("events_ms", "graph_ms"):
        print(f"{args.tag} K7 against torch.take, {GRAPH_CALLS} calls "
              + ("between one event pair" if way == "events_ms" else "in one CUDA graph replay")
              + f", in turns: K7 {', '.join(f'{v:.5f}' for v in res['k7'][way])} ms a call, "
              f"torch.take {', '.join(f'{v:.5f}' for v in res['take'][way])}", flush=True)


def _time_gate(args, out, dv, reps: int = 5) -> None:
    """The AND gate (``GateSet.AND``) at full ``medium_v2`` on a gate's 4
    ciphertexts: wall ms of ``reps`` calls (host clock around each call and
    a ``synchronize()``), its schoolbook round launches, and one traced call
    (``device.device_ms``, which must see every round): the rounds' device
    time, every kernel's device time, and the idle share 1 - busy / untraced
    wall.  The key files are made by the command line into ``--work`` once."""
    import numpy as np
    import torch

    from redsec_tpu_torch import cli
    from redsec_tpu_torch.crypto import bootstrap as bs
    from redsec_tpu_torch.crypto import gates
    from redsec_tpu_torch.crypto.params import get_params
    from redsec_tpu_torch.device import launches
    from redsec_tpu_torch.formats import keys as kio

    Pg = get_params("medium_v2")
    work = os.path.join(args.work, Pg.name)
    if not os.path.exists(os.path.join(work, "eval.key.npz")):
        cli.main(["keygen", "--params", Pg.name, "--seed", "0", "--out-dir", work])
    sk = kio.load_secret_key(os.path.join(work, "secret.key.npz"))
    dkey = bs.prepare_cloud_key(kio.load_cloud_key(os.path.join(work, "eval.key.npz")),
                                device="cuda")
    gs = gates.GateSet(dkey)
    a2, b2 = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
    a, b = (torch.as_tensor(gates.gate_encrypt_host(sk.lwe_key, v, Pg, np.random.default_rng(i)),
                            device="cuda") for i, v in enumerate((a2, b2)))
    launches.reset()
    res = gs.AND(a, b)
    rounds = launches.get("schoolbook_round")
    if not np.array_equal(gates.gate_decrypt_host(sk.lwe_key, res.cpu().numpy(), Pg), a2 & b2):
        raise SystemExit(f"{args.tag}: the AND gate at {Pg.name} is wrong")
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gs.AND(a, b)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    rounds_ms, busy, seen, _ = dv.device_ms(lambda: gs.AND(a, b), "schoolbook_round_kernel",
                                            reps=1, per_call=rounds)
    wall = sum(walls) / len(walls)
    out[f"gate_and_{Pg.name}"] = {
        "wall_ms": walls, "round_launches": rounds, "rounds_device_ms": rounds_ms,
        "rounds_traced": seen, "device_busy_ms": busy,
        "idle_share": 1 - busy / wall, "wall_over_rounds": wall / rounds_ms}
    print(f"{args.tag} AND gate {Pg.name} [4 ciphertexts]: wall "
          f"{', '.join(f'{w:.3f}' for w in walls)} ms; {rounds} round launches; traced: rounds "
          f"{rounds_ms:.3f} ms on the device (x{seen}), every kernel "
          f"{busy:.3f} ms, idle share {1 - busy / wall:.4f}, wall / rounds' device time "
          f"{wall / rounds_ms:.3f}", flush=True)


CIFAR = os.path.join(os.path.dirname(os.path.dirname(HERE)), "nets_trained", "cifar", "binarynet")


def _time_cli(args, out, Pc, model: str = "mnist/sign1024x1") -> None:
    """``run-encrypted`` of the checkout's command line on one image of
    ``model`` at ``Pc`` (keygen and encrypt-image into ``--work`` once;
    ``cifar/binarynet`` with its trained weights and calibration, as
    ``chip_smoke.py`` runs it)."""
    import contextlib
    import io

    import numpy as np

    from redsec_tpu_torch import cli
    from redsec_tpu_torch.formats.image_io import write_image_ptxt

    cifar = model == "cifar/binarynet"
    work = os.path.join(args.work, Pc.name)
    name = "cifar." if cifar else ""
    files = {k: os.path.join(work, f) for k, f in (
        ("secret", "secret.key.npz"), ("eval", "eval.key.npz"), ("ptxt", f"{name}image.ptxt"),
        ("ctxt", f"{name}image.ctxt.npz"), ("out", f"{name}out.{args.tag}.ctxt.npz"))}
    model_args = (["--model", model, "--calib", os.path.join(CIFAR, "calibration.npz")]
                  if cifar else [])
    if not os.path.exists(files["ctxt"]):
        if not os.path.exists(files["eval"]):
            cli.main(["keygen", "--params", Pc.name, "--seed", "0", "--out-dir", work])
        raw = np.random.default_rng(1).integers(0, 256, size=(32, 32, 3) if cifar else (28, 28, 1))
        write_image_ptxt(files["ptxt"], 0, raw)
        cli.main(["encrypt-image", "--secret", files["secret"], "--image-ptxt", files["ptxt"],
                  *model_args, "--out", files["ctxt"]])
    weights = os.path.join(CIFAR, "var_prep.dat") if cifar else WEIGHTS
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["run-encrypted", "--model", model, "--weights", weights, "--eval", files["eval"],
                  "--image", files["ctxt"], *model_args[2:], "--out", files["out"]])
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    out[f"cli_{Pc.name}" + ("_cifar" if cifar else "")] = rec
    print(f"{args.tag} cli run-encrypted {model} {Pc.name}: {rec}", flush=True)


def _time_forward(args, out, P, dkey) -> None:
    """The sign1024x1 forward on 8 images through the checkout's entry
    points (``build_encrypted_forward``), as ``chip_smoke.py``'s slice runs
    it: seconds and PBS/s of each timed forward, and K4's launches in one."""
    import numpy as np
    import torch

    from redsec_tpu_torch.crypto import keygen as kg
    from redsec_tpu_torch.device import launches
    from redsec_tpu_torch.formats.image_io import pixel_transform_for
    from redsec_tpu_torch.models.spec import prep_model
    from redsec_tpu_torch.models.zoo import get_model
    from redsec_tpu_torch.runtime.encrypted import build_encrypted_forward, encrypt_images
    from redsec_tpu_torch.utils.metrics import summarize

    batch = 8
    model = get_model("mnist/sign1024x1")
    mplan = prep_model(model, WEIGHTS)
    per_image = summarize(mplan)["total_bootstraps"]
    sk, _ = kg.keygen(P, seed=0)  # the secret key of time_kernels' seed-0 key
    raw = np.random.default_rng(1).integers(0, 256, size=(batch, 28, 28, 1))
    fwd = build_encrypted_forward(mplan, dkey)
    ct = encrypt_images(sk, pixel_transform_for(model.name)(raw), P, np.random.default_rng(2),
                        gain=fwd.in_gain)
    fwd(ct)  # warm-up: cuBLAS's handle, the allocator's first blocks
    secs = []
    for _ in range(FORWARD_REPS):
        launches.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd(ct)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    k4 = launches.counts.get("blind_rotate", 0)
    out["forward_sign1024x1_s"] = secs
    out["forward_sign1024x1_pbs_per_s"] = [batch * per_image / s for s in secs]
    print(f"{args.tag} forward sign1024x1 ({P.name}, {batch} images x {per_image} PBS, "
          f"{k4} K4 launches): " + ", ".join(f"{s:.4f} s {batch * per_image / s:.2f} PBS/s"
                                             for s in secs), flush=True)


ROUND_MM_BATCHES = (1, 32, 64, 133, 512)  # K2-mm / K3-mm: the path's chunks (512, 32) and more


def _time_round_mm(args, out, K, P, plan, bk0, ri, same, dv,
                   batches=ROUND_MM_BATCHES) -> None:
    """K2-mm and K3-mm at set ``P`` at each batch of ``batches``, each held
    against its twin (on a prefix of 64 at most), then CUDA events of 50
    launches and the profiler's device time; where the checkout's kernels
    come in designs (``kernels._cmux_round_mm`` takes a ``split``, blocks a
    ciphertext), at the split the wrapper picks and at each split
    ``kernels.round_mm_fits`` takes, with the library's layout of each
    (``kernels.round_mm_built``: shared bytes, clusters or blocks at once,
    registers, spills).  Keys carry the set's name but for
    ``small_v2_tpu``."""
    N, rows = P.N, P.decomp_rows
    has_split = hasattr(K, "_cmux_round_mm")
    at = "" if P.name == "small_v2_tpu" else f"{P.name}_"
    for full in (False, True):
        name = "cmux_round_mm" if full else "external_product_mm"
        splits = [None] + ([s for s in K.ROUND_MM_SPLITS if K.round_mm_fits(N, rows, s)]
                           if has_split else [])
        if has_split:
            for s in splits[1:]:
                lay = K.round_mm_built(N, rows, s, full)
                out[f"{at}{name}_layout_split{s}"] = lay
                print(f"{args.tag} {P.name} {name} split {s}: {lay}", flush=True)
        for M in batches:
            acc, t = ri(-2**31, 2**31, (M, 2, N)), ri(0, 2 * N, (M,))
            digits = ri(-P.half_bg, P.half_bg, (M, rows, N))
            m = min(M, 64)
            for s in splits:
                if full:
                    def fn(s=s):
                        return (K.cmux_round_mm(acc, t, bk0, P, plan) if s is None
                                else K._cmux_round_mm(acc, t, bk0, P, plan, s))
                    same(f"{name} [{M}] split {s}", fn()[:m],
                         K.cmux_round_mm_plain(acc[:m], t[:m], bk0, P, plan))
                else:
                    def fn(s=s):
                        return (K.external_product_mm(digits, bk0, plan) if s is None
                                else K._external_product_mm(digits, bk0, plan, s))
                    same(f"{name} [{M}] split {s}", fn()[:m],
                         K.external_product_mm_plain(digits[:m], bk0, plan))
                key = f"{at}{name}_ms_{M}" + ("" if s is None else f"_split{s}")
                out[key] = dv.cuda_ms(fn, 50, warmup=3)
                # the name covers both designs (the <N> kernel and the pair kernel)
                out[key.replace("_ms_", "_device_ms_")] = dev_ms = dv.device_ms(
                    fn, name, required=False)[0]
                chosen = (f", picks split {K.round_mm_split_on(0, N, rows, M, full)}"
                          if has_split and s is None else "")
                print(f"{args.tag} {P.name} {name} [{M}] split {s or 'default'}: "
                      f"{out[key]:.4f} ms (events), device "
                      f"{dev_ms if dev_ms is None else f'{dev_ms:.4f}'} ms{chosen}", flush=True)


def _time_matmul(args, out, K, bs, kg, get_params, cloud, dkey, ri, same, dv) -> None:
    """The four-step kernels on a "matmul" key of the same raw key as
    ``dkey`` (``small_v2_tpu``), then of each set of ``--sets`` that
    ``supported_mm`` takes; K4-mm at 512 also against K4 on ``dkey``."""
    import torch

    from redsec_tpu_torch.crypto.params import SMALL_V2_TPU as P

    mkey = bs.prepare_cloud_key(cloud, device="cuda", ntt_flavor="matmul")
    plan, N, rows = mkey.plan, P.N, P.decomp_rows
    out["layout_mm"] = K.k4mm_layout(P, plan)
    built = K.mm_layout(P)  # the library's own rule against its mirror
    if any(built[k] != out["layout_mm"][k] for k in built):
        raise SystemExit(f"{args.tag}: the four-step layout {built} differs from k4mm_layout's")
    bk0 = mkey.bk[:, 0].contiguous()
    _time_round_mm(args, out, K, P, plan, bk0, ri, same, dv)
    runs = [("small_v2_tpu", B) for B in K4_BATCHES]
    runs += [(name, 512) for name in filter(None, args.sets.split(","))
             if "/" not in name and name != "small_v2_tpu"]
    for name, B in runs:
        Pk = get_params(name)
        if name != "small_v2_tpu":
            if not K.supported_mm(Pk, bs.bootstrap_plan(Pk)):
                print(f"{args.tag} K4-mm {name}: not a four-step kernel instance", flush=True)
                continue
            _, cl = kg.keygen(Pk, seed=0)
            mk = bs.prepare_cloud_key(cl, device="cuda", ntt_flavor="matmul")
        else:
            mk = mkey
        acc0, abar = ri(-2**31, 2**31, (B, 2, Pk.N)), ri(0, 2 * Pk.N, (B, Pk.n))
        m = min(B, 128)  # the twin on a prefix: every block runs the same code
        got = K.blind_rotate_mm(acc0, abar, mk.bk, Pk, mk.plan)
        same(f"blind_rotate_mm {name} batch {B}", got[:m],
             K.blind_rotate_mm_plain(acc0[:m], abar[:m], mk.bk, Pk, mk.plan))
        tag = "" if name == "small_v2_tpu" else f"_{name}"
        if name == "small_v2_tpu" and B == 512:
            same("blind_rotate_mm against blind_rotate on the same raw key", got,
                 K.blind_rotate(acc0, abar, dkey.bk, Pk, dkey.plan))
        out[f"blind_rotate_mm_ms{tag}_{B}"] = dv.cuda_ms(
            lambda: K.blind_rotate_mm(acc0, abar, mk.bk, Pk, mk.plan), K4_REPS)
        print(f"{args.tag} K4-mm {name} batch {B}: {out[f'blind_rotate_mm_ms{tag}_{B}']:.4f} ms, "
              f"{K.k4mm_layout(Pk, mk.plan)}", flush=True)
        del got
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
