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
4096].  One JSON line per run ends the output.
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
    args = ap.parse_args(argv)
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
    t0 = time.perf_counter()
    ptxas = K.build_library(K.SOURCE)
    build_s = time.perf_counter() - t0
    for line in ptxas.splitlines():  # registers, spills and shared memory per kernel
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"{args.tag} ptxas: {line.strip()}", flush=True)
    _, cloud = kg.keygen(P, seed=0)
    dkey = bs.prepare_cloud_key(cloud, device="cuda")
    plan, N, n, rows = dkey.plan, P.N, P.n, P.decomp_rows
    gen = np.random.default_rng(7)

    def ri(lo, hi, shape):
        return torch.as_tensor(gen.integers(lo, hi, size=shape, dtype=np.int64)
                               .astype(np.int32), device=dev)

    def same(name, got, want):
        if not torch.equal(got, want):
            raise SystemExit(f"{args.tag}: {name} differs from its plain twin")

    out = {"tag": args.tag, "card": card, "build_s": build_s}
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
    same("cmux_round", K.cmux_round(acc, t, bk0, P, plan), K.cmux_round_plain(acc, t, bk0, P, plan))
    out["cmux_round_ms"] = ms(lambda: K.cmux_round(acc, t, bk0, P, plan), 50)
    runs = [("small_v2_tpu", 1, B) for B in K4_BATCHES]
    for item in filter(None, args.sets.split(",")):
        name, _, bundle = item.partition("/")
        runs.append((name, int(bundle or 1), 512))
    for name, bundle, B in runs:
        Pk = get_params(name)
        if (name, bundle) != ("small_v2_tpu", 1):
            _, cloud = kg.keygen(Pk, seed=0, bundle=bundle)
            dk = bs.prepare_cloud_key(cloud, device="cuda")
        else:
            dk = dkey
        acc0, abar = ri(-2**31, 2**31, (B, 2, Pk.N)), ri(0, 2 * Pk.N, (B, Pk.n))
        # the twin on a prefix of the batch (it takes seconds a ciphertext at
        # the larger sets); every ciphertext of a block runs the same code
        m = B if (Pk.N, bundle, len(dk.plan.primes)) == (1024, 1, 2) else 64
        got = K.blind_rotate(acc0, abar, dk.bk, Pk, dk.plan)
        same(f"blind_rotate {name}/{bundle} batch {B}", got[:m],
             K.blind_rotate_plain(acc0[:m], abar[:m], dk.bk, Pk, dk.plan))
        tag = ("" if name == "small_v2_tpu" else f"_{name}") + ("_bundle2" if bundle == 2 else "")
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
            same(f"schoolbook_product [{B}, {rs}, {Ns}]", K.schoolbook_product(digits, bk, *extra),
                 K.schoolbook_product_plain(digits, bk, *extra))
            key = f"schoolbook_ms_N{Ns}_rows{rs}_{B}"
            out[key] = ms(lambda: K.schoolbook_product(digits, bk, *extra), 5)
            print(f"{args.tag} S1 [{B}, {rs}, {Ns}]: {out[key]:.4f} ms", flush=True)
            if (Ns, rs, B) == (4096, 8, 512):
                out["schoolbook_twin_ms_N4096_rows8_512"] = ms(
                    lambda: K.schoolbook_product_plain(digits, bk, *extra), 5)
                print(f"{args.tag} S1 twin (float64 FFT) [{B}, {rs}, {Ns}]: "
                      f"{out['schoolbook_twin_ms_N4096_rows8_512']:.4f} ms", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
