"""Oracle-agreement forecast for an encrypted run, without a key.

Resolves ranges and gains as ``run-encrypted`` would, after calibrating on
the forecast's own images, then Monte-Carlo-simulates the encrypted pipeline
(``utils/noise_sim.py``) instead of running it: each PBS boundary gets the
mod-switch and ciphertext noise of the parameter set.  Use it before a long
CIFAR run to forecast agreement and find which bootstrap boundary flips
first.

    python -m redsec_tpu_torch.scripts.predict_agreement --model cifar/binarynet_small \\
        --reference <reference checkout> --images 16 --params small_v2_tpu --trials 5 [--per-layer]

The dataset is ``<reference>/nets/mnist/mnist_data.csv`` (or
``cifar/cifar_data.csv``) in ``load_csv_dataset``'s format; the weights are
``--varprep`` or ``<reference>/nets/<model>/var_prep.dat``.  Where the JAX
package's script reads ``REDSEC_INPUT_GAIN``, ``REDSEC_RELU_MODE`` and the
calibration knobs from the environment, this takes ``--input-gain``,
``--relu-mode`` and the flags of ``calibrate`` (``--no-center``,
``--no-tiebreak``, ``--gain-mode``, ``--cascade-w``, ``--max-flip``).  The
last line is ``PREDICT {json}`` (``ISOLATE {json}`` with ``--isolate``), with
the JAX package's keys and values.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def main(argv=None) -> dict:
    from ..cli import add_knob_args, knobs_from_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", type=int, default=16)
    ap.add_argument("--model", default="cifar/binarynet_small")
    ap.add_argument("--params", default="small_v2_tpu")
    ap.add_argument("--reference", required=True,
                    help="checkout of the reference: nets/<dataset>.csv and, without "
                         "--varprep, nets/<model>/var_prep.dat")
    ap.add_argument("--varprep", default="",
                    help="path to a var_prep.dat overriding the reference net's shipped "
                         "weights (BYON-trained weights)")
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--per-layer", action="store_true")
    ap.add_argument("--exact-layers", default="",
                    help="comma list of layer indices to simulate noiselessly "
                         "(what-if flip localization)")
    ap.add_argument("--isolate", action="store_true",
                    help="per-boundary ISOLATED flip rates: for each layer, one rollout "
                         "with every OTHER layer noiseless — separates local noise from "
                         "upstream cascade")
    ap.add_argument("--majority", type=int, default=1,
                    help="simulate k-copy majority voting on sign-type boundaries")
    ap.add_argument("--majority-from", type=int, default=0,
                    help="first layer index whose sign boundary is voted")
    ap.add_argument("--majority-plan", default="",
                    help="per-layer vote counts 'i:k,j:k' overriding --majority")
    ap.add_argument("--escalate", default="",
                    help="comma list of layer indices whose PBS runs at "
                         "--escalate-params geometry")
    ap.add_argument("--escalate-params", default="small_v2_n2048")
    ap.add_argument("--unit-gains", action="store_true",
                    help="forecast with encoding gains disabled (the reference's "
                         "hardwired +-1 message convention) — the mechanism-off baseline")
    ap.add_argument("--no-range-check", action="store_true",
                    help="resolve with strict=False: forecast nets whose margins trip "
                         "the flip-rate guard instead of refusing")
    ap.add_argument("--input-gain", action="store_true",
                    help="also assign a model-input encoding gain (REDSEC_INPUT_GAIN=1)")
    ap.add_argument("--relu-mode", choices=["quarter", "full"],
                    help="force one relu implementation (REDSEC_RELU_MODE)")
    add_knob_args(ap)
    ap.add_argument("--device", default="cuda",
                    help="where the plaintext ops run: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..crypto.params import get_params
    from ..formats.image_io import load_csv_dataset, pixel_transform_for
    from ..models.spec import prep_model
    from ..models.zoo import get_model
    from ..runtime.ptxt import build_forward
    from ..runtime.ranges import calibrate_ranges, resolve_pbs_ranges
    from ..utils import noise_sim as ns

    t0 = time.time()
    params = get_params(args.params)
    vp = args.varprep or os.path.join(args.reference, "nets", args.model, "var_prep.dat")
    plan = prep_model(get_model(args.model), vp)
    d = plan.in_dim
    dataset = ("cifar/cifar_data.csv" if args.model.startswith("cifar")
               else "mnist/mnist_data.csv")
    labels, px = load_csv_dataset(os.path.join(args.reference, "nets", dataset),
                                  d.h, d.w, d.in_dep, limit=args.images)
    x = pixel_transform_for(args.model)(px)
    in_gain_flag = "1" if args.input_gain else "0"

    calibrate_ranges(plan, x, device=args.device)
    info = resolve_pbs_ranges(plan, params.msg_space, strict=not args.no_range_check,
                              gains=not args.unit_gains, input_gain=args.input_gain,
                              sigma_units=params.mod_switch_sigma_units(),
                              relu_mode=args.relu_mode, **knobs_from_args(args))
    efr = {i: round(r.expected_flip_rate, 5) for i, r in info.items()
           if r.expected_flip_rate is not None}
    if efr:
        print(f"[{time.time()-t0:6.1f}s] predicted per-boundary flips: {efr}")
    print(f"[{time.time()-t0:6.1f}s] gains: "
          f"{ {i: (r.in_gain, r.out_gain) for i, r in info.items()} } "
          f"relu modes: { {i: r.relu_mode for i, r in info.items() if r.relu_mode} } "
          f"centers: { {i: int(np.abs(r.center).max()) for i, r in info.items() if r.center is not None} }")

    ptxt_preds = build_forward(plan, args.device)(x).cpu().numpy().argmax(1)
    acc = float((ptxt_preds == labels).mean())
    print(f"[{time.time()-t0:6.1f}s] plaintext oracle accuracy: {acc:.3f}")

    if args.isolate:
        trace = ns.trace_oracle(plan, x, args.device)
        nl = len(plan.layers)
        iso = {}
        for i in range(nl):
            rng = np.random.default_rng(args.seed)
            _, stats = ns.simulate_forward(plan, x, params, info, rng, oracle_trace=trace,
                                           exact_layers=set(range(nl)) - {i},
                                           device=args.device)
            for k in (f"L{i}", f"L{i}.mp"):
                if k in stats:
                    iso[k] = round(stats[k]["rate"], 6)
        res = {"model": args.model, "params": args.params, "input_gain": in_gain_flag,
               "isolated_flip_rates": iso,
               "gains": {i: (r.in_gain, r.out_gain) for i, r in info.items()},
               "seconds": round(time.time() - t0, 1)}
        print("ISOLATE " + json.dumps(res))
        return res

    exact = set(int(s) for s in args.exact_layers.split(",") if s != "") or None
    mplan = {int(i): int(k) for i, _, k in
             (it.partition(":") for it in args.majority_plan.split(",")) if i.strip()} or None
    esc = {int(s) for s in args.escalate.split(",") if s.strip()} or None
    esc_p = get_params(args.escalate_params) if esc else None
    if exact is None:
        res = ns.agreement_estimate(plan, x, params, info, trials=args.trials, seed=args.seed,
                                    per_layer=args.per_layer, majority=args.majority,
                                    majority_from=args.majority_from, majority_plan=mplan,
                                    escalate=esc, escalate_params=esc_p, device=args.device)
        if args.majority > 1:
            res["majority"] = args.majority
            res["majority_from"] = args.majority_from
        if mplan:
            res["majority_plan"] = {str(i): k for i, k in sorted(mplan.items())}
        if esc:
            res["escalate"] = sorted(esc)
            res["escalate_params"] = args.escalate_params
    else:
        trace = ns.trace_oracle(plan, x, args.device)
        agrees, layer_rates = [], {}
        for t in range(args.trials):
            rng = np.random.default_rng(args.seed + t)
            scores, stats = ns.simulate_forward(plan, x, params, info, rng, oracle_trace=trace,
                                                exact_layers=exact, device=args.device)
            agrees.append(float((scores.argmax(1) == ptxt_preds).mean()))
            for k, v in stats.items():
                layer_rates.setdefault(k, []).append(v["rate"])
        res = {"agreement_mean": float(np.mean(agrees)),
               "agreement_min": float(np.min(agrees)),
               "trials": args.trials, "images": int(x.shape[0]),
               "exact_layers": sorted(exact),
               "layer_flip_rates": {k: round(float(np.mean(v)), 5)
                                    for k, v in layer_rates.items()}}
    res.update(model=args.model, params=args.params, input_gain=in_gain_flag,
               oracle_accuracy=acc, seconds=round(time.time() - t0, 1))
    print("PREDICT " + json.dumps(res))
    return res


if __name__ == "__main__":
    main()
