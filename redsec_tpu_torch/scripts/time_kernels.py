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
``name@B`` at batch B (default 512), and the command line.  ``--cli SET`` times ``run-encrypted`` of the checkout's
command line on one ``mnist/sign1024x1`` image at SET (its JSON record:
seconds, PBS/s, launches); the key files are made by the command line into
``--work`` on first use and reused, so two checkouts run on the same key.
One JSON line per run ends the output.

    python redsec_tpu_torch/scripts/time_kernels.py --root build/parent --tag parent \
        --sets medium_v2,large --cli medium_v2
    python redsec_tpu_torch/scripts/time_kernels.py --rounds-only \
        --sets medium_v2,medium,large_v2,large,medium_v2@4 --cli medium_v2
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

    if args.rounds_only:
        out = {"tag": args.tag, "card": card}
        for item in filter(None, args.sets.split(",")):
            name, _, b = item.partition("@")
            _time_schoolbook_round(args, out, K, bs, get_params(name), ri, same, ms,
                                   int(b or 512))
        if args.cli:
            _time_cli(args, out, get_params(args.cli))
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
                _time_schoolbook_round(args, out, K, bs, Pk, ri, same, ms)
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
        _time_matmul(args, out, K, bs, kg, get_params, cloud, dkey, ri, same, ms)
    if args.forward:
        _time_forward(args, out, P, dkey)
    if args.cli:
        _time_cli(args, out, get_params(args.cli))
    print(json.dumps(out), flush=True)
    return out


def _time_schoolbook_round(args, out, K, bs, Pk, ri, same, ms, B: int = 512) -> None:
    """One schoolbook CMUX round at ``Pk`` on ``B`` random accumulators and
    exponents and a random raw BK round: S1 with the torch glue around it,
    and the checkout's round kernel where it has one, in turns (glue, kernel,
    kernel, glue), the kernel held against S1 with its glue.  With
    ``--rounds-only``, the round kernel alone, held against its twin and
    timed three times."""
    import torch

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
        out[f"round_device_ms_{Pk.name}_{B}"] = dev = _device_ms(one, "schoolbook_round_kernel")
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


def _device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device time a call of ``fn`` of the CUDA kernels whose name holds
    ``kernel`` (torch.profiler; CUDA events around a launch shorter than the
    wrapper's host time time the host).  The tracer starts a step early (it
    can miss the first launch after it starts) and must see ``reps``
    launches; a trace that saw fewer is taken again, up to 5 in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(5):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if kernel in e.key and e.device_type == torch.autograd.DeviceType.CUDA]
        if sum(e.count for e in evs) == reps:
            return sum(e.self_device_time_total for e in evs) / reps / 1e3
    raise SystemExit(f"the profiler saw {sum(e.count for e in evs)} launches of {kernel} "
                     f"in {reps} calls, 5 times")


def _time_cli(args, out, Pc) -> None:
    """``run-encrypted`` of the checkout's command line on one sign1024x1
    image at ``Pc`` (keygen and encrypt-image into ``--work`` once)."""
    import contextlib
    import io

    import numpy as np

    from redsec_tpu_torch import cli
    from redsec_tpu_torch.formats.image_io import write_image_ptxt

    work = os.path.join(args.work, Pc.name)
    files = {k: os.path.join(work, f) for k, f in (
        ("secret", "secret.key.npz"), ("eval", "eval.key.npz"), ("ptxt", "image.ptxt"),
        ("ctxt", "image.ctxt.npz"), ("out", f"out.{args.tag}.ctxt.npz"))}
    if not os.path.exists(files["ctxt"]):
        cli.main(["keygen", "--params", Pc.name, "--seed", "0", "--out-dir", work])
        raw = np.random.default_rng(1).integers(0, 256, size=(28, 28, 1))
        write_image_ptxt(files["ptxt"], 0, raw)
        cli.main(["encrypt-image", "--secret", files["secret"], "--image-ptxt", files["ptxt"],
                  "--out", files["ctxt"]])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["run-encrypted", "--model", "mnist/sign1024x1", "--weights", WEIGHTS,
                  "--eval", files["eval"], "--image", files["ctxt"], "--out", files["out"]])
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    out[f"cli_{Pc.name}"] = rec
    print(f"{args.tag} cli run-encrypted {Pc.name}: {rec}", flush=True)


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


def _time_matmul(args, out, K, bs, kg, get_params, cloud, dkey, ri, same, ms) -> None:
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
    digits = ri(-P.half_bg, P.half_bg, (64, rows, N))
    same("external_product_mm", K.external_product_mm(digits, bk0, plan),
         K.external_product_mm_plain(digits, bk0, plan))
    out["external_product_mm_ms"] = ms(lambda: K.external_product_mm(digits, bk0, plan), 50)
    acc = ri(-2**31, 2**31, (64, 2, N))
    t = ri(0, 2 * N, (64,))
    same("cmux_round_mm", K.cmux_round_mm(acc, t, bk0, P, plan),
         K.cmux_round_mm_plain(acc, t, bk0, P, plan))
    out["cmux_round_mm_ms"] = ms(lambda: K.cmux_round_mm(acc, t, bk0, P, plan), 50)
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
        out[f"blind_rotate_mm_ms{tag}_{B}"] = ms(
            lambda: K.blind_rotate_mm(acc0, abar, mk.bk, Pk, mk.plan), K4_REPS)
        print(f"{args.tag} K4-mm {name} batch {B}: {out[f'blind_rotate_mm_ms{tag}_{B}']:.4f} ms, "
              f"{K.k4mm_layout(Pk, mk.plan)}", flush=True)
        del got
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
