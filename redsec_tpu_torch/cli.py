"""Command-line interface: the reference's client + nets make-target flows.

Subcommands (reference equivalents in parentheses):

- ``keygen``          (client: make keygen)         -> secret.key.npz / eval.key.npz
- ``encrypt-image``   (client: make encrypt-image)  image.ptxt/CSV row -> image.ctxt.npz
- ``run-encrypted``   (nets: make cpu-encrypt)      image.ctxt.npz -> network_output.ctxt.npz
- ``decrypt-image``   (client: make decrypt-image)  network_output.ctxt.npz -> class
- ``calibrate``       public calibration artifact from plaintext rows
- ``ptxt``            (nets: make ptxt)             plaintext accuracy over a CSV
- ``stats``           per-layer bootstrap/MAC counts
- ``weight-convert``  (nets: make weight_convert)   var.dat1 -> var_prep.dat
- ``netlist-wizard``  (REDsecNetlistGenerator.xlsm) interactive netlist CSV
- ``compile``         (compiler/compiler.py)        CSV netlist -> model spec JSON (+ training script)

The files are the JAX package's (``formats/keys.py``), so either package's
client can talk to either's server.  ``run-encrypted``, ``calibrate`` and
``ptxt`` run on ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain twins).

Example end-to-end flow:
  python -m redsec_tpu_torch keygen --out-dir ./wk
  python -m redsec_tpu_torch encrypt-image --csv nets/mnist/mnist_data.csv --row 0 \\
      --secret ./wk/secret.key.npz --out ./wk/image.ctxt.npz --model mnist/sign1024x1
  python -m redsec_tpu_torch run-encrypted --model mnist/sign1024x1 \\
      --weights .../var_prep.dat --eval ./wk/eval.key.npz \\
      --image ./wk/image.ctxt.npz --out ./wk/network_output.ctxt.npz
  python -m redsec_tpu_torch decrypt-image --secret ./wk/secret.key.npz \\
      --output ./wk/network_output.ctxt.npz
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _resolve_model(name_or_json: str):
    """Zoo name, or a path to a *_spec.json produced by `compile`."""
    if name_or_json.endswith(".json"):
        from .compiler.netlist import spec_from_json

        with open(name_or_json) as f:
            return spec_from_json(json.load(f))
    from .models.zoo import get_model

    return get_model(name_or_json)


def _parse_rows(spec: str):
    out = []
    for part in spec.split(","):
        if ":" in part:
            a, b = part.split(":")
            out.extend(range(int(a), int(b)))
        else:
            out.append(int(part))
    return out


def cmd_keygen(args):
    from .crypto import keygen as kg
    from .crypto.params import get_params
    from .formats import keys as kio

    params = get_params(args.params)
    t0 = time.time()
    sk, cloud = kg.keygen(params, seed=args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    kio.save_secret_key(os.path.join(args.out_dir, "secret.key.npz"), sk)
    kio.save_cloud_key(os.path.join(args.out_dir, "eval.key.npz"), cloud)
    print(f"keyset ({args.params}) written to {args.out_dir} in {time.time()-t0:.1f}s")


def cmd_calibrate(args):
    """Derive the public calibration artifact (gains / centers / tie-breaks
    / relu modes — runtime/ranges.py) from a plaintext-oracle pass over the
    given CSV rows, and persist it next to the weights.

    Deployment contract: the rows here must be DISJOINT from the images
    later evaluated (e.g. the net's training split, or held-out rows) —
    runtime/calibration.py records them for provenance.  The resulting
    .npz is public metadata: it is derived from plaintext weights and
    plaintext sample data only.  ``--input-gain``, ``--relu-mode``,
    ``--majority-plan``, ``--escalate``, ``--escalate-params``,
    ``--no-center``, ``--no-tiebreak``, ``--gain-mode``, ``--cascade-w`` and
    ``--max-flip`` are the JAX package's ``REDSEC_INPUT_GAIN``,
    ``REDSEC_RELU_MODE``, ``REDSEC_MAJORITY_PLAN``, ``REDSEC_ESCALATE``,
    ``REDSEC_ESCALATE_PARAMS``, ``REDSEC_CENTER=0``, ``REDSEC_TIEBREAK=0``,
    ``REDSEC_GAIN_MODE``, ``REDSEC_CASCADE_W`` and ``REDSEC_MAX_FLIP``,
    recorded in the artifact under those names (a per-layer plan states any
    vote count a global ``REDSEC_MAJORITY`` from a layer on would);
    ``run-encrypted --calib`` applies what the file records."""
    from .crypto.params import get_params
    from .formats import image_io
    from .models.spec import prep_model
    from .runtime.calibration import save_calibration
    from .runtime.ranges import calibrate_ranges, resolve_pbs_ranges

    plan = prep_model(_resolve_model(args.model), args.weights)
    d = plan.in_dim
    rows = _parse_rows(args.rows)
    labels, px = image_io.load_csv_dataset(args.csv, d.h, d.w, d.in_dep, limit=max(rows) + 1)
    x = image_io.pixel_transform_for(args.model)(px[rows])
    calibrate_ranges(plan, x, device=args.device)
    params = get_params(args.params)
    # resolve once strictly so a calibration that cannot pass the flip-rate
    # guard fails HERE (at the deployer's desk), not at serving time
    from .runtime.calibration import ESCALATE_PARAMS
    from .runtime.encrypted import majority_ks

    knobs = knobs_from_args(args)
    esc = None
    if args.escalate:
        esc = ({int(v) for v in args.escalate.split(",") if v.strip()},
               get_params(args.escalate_params or ESCALATE_PARAMS))
    resolve_pbs_ranges(plan, params.msg_space, strict=not args.no_guard,
                       input_gain=args.input_gain,
                       sigma_units=params.mod_switch_sigma_units(), relu_mode=args.relu_mode,
                       majority_ks=majority_ks(plan, majority_plan=args.majority_plan),
                       escalate=esc, **knobs)
    meta = save_calibration(args.out, plan, args.params, calib_rows=f"{args.csv}[{args.rows}]",
                            input_gain=args.input_gain, relu_mode=args.relu_mode,
                            majority_plan=args.majority_plan, escalate=args.escalate,
                            escalate_params=args.escalate_params, **knobs)
    print(f"calibration ({len(rows)} rows) -> {args.out}")
    print(json.dumps({k: meta[k] for k in
                      ("model", "params", "weights_sha", "in_gain", "gains",
                       "relu_modes", "local_flip_rates", "env")}, indent=2))


def cmd_encrypt_image(args):
    from .crypto import lwe
    from .formats import image_io
    from .formats import keys as kio

    sk = kio.load_secret_key(args.secret)
    if args.image_ptxt:
        label, px = image_io.read_image_ptxt(args.image_ptxt)
        px = px[None]
        labels = [label]
    else:
        h, w, c = (image_io.image_shape_for(args.format) if args.format
                   else image_io.shape_for_model(args.model))
        rows = _parse_rows(args.rows if args.rows else str(args.row))
        labels_all, imgs = image_io.load_csv_dataset(args.csv, h, w, c, limit=max(rows) + 1)
        labels = [int(labels_all[r]) for r in rows]
        px = imgs[rows]
    x = image_io.pixel_transform_for(args.model)(px)
    gain = 1
    if args.calib:
        # model-input encoding gain from the calibration artifact: pixels
        # encrypt as gain*p (runtime/ranges.py input_gain).  Read from the
        # meta only: the client needs no weights
        with np.load(args.calib) as z:
            meta = json.loads(bytes(z["meta"]).decode())
        gain = int(meta.get("in_gain", 1))
    x = np.asarray(x, np.int64) * gain
    rng = np.random.default_rng(args.seed)
    ct = lwe.encrypt_integers(sk.lwe_key, x, sk.params, rng)
    kio.save_ciphertexts(args.out, ct, sk.params, label=labels[0])
    print(f"encrypted {x.shape[0]} image(s) {x.shape} (labels {labels}, "
          f"input gain {gain}) -> {args.out}")


def cmd_run_encrypted(args):
    """Cloud side.  Besides the JAX package's lines it prints one JSON line:
    the forward's mode, images, bootstraps (``pbs``), blind-rotation kernel
    launches (``k4_launches``; ``k4mm_launches`` for the four-step kernel
    that a ``--ntt-flavor matmul`` key runs), schoolbook round kernel
    launches (``round_launches``, one a round at the sets without NTT
    primes) and schoolbook-product kernel launches (``s1_launches``, which no
    path launches since the round kernel took its place; all 0 on the CPU),
    ``seconds`` and ``pbs_per_s``; the same dict is returned to
    an in-process caller.  ``--ntt-flavor`` is the JAX package's
    ``REDSEC_NTT``: the NTT-domain order both keys are prepared in."""
    import torch

    from .crypto import bootstrap as bs
    from .device import launches, resolve_device
    from .formats import keys as kio
    from .models.spec import prep_model
    from .runtime.encrypted import build_encrypted_forward

    dev = resolve_device(args.device)
    cloud = kio.load_cloud_key(args.eval)
    t0 = time.time()
    dkey = bs.prepare_cloud_key(cloud, device=dev, ntt_flavor=args.ntt_flavor)
    print(f"evaluation key prepared in {time.time()-t0:.1f}s")
    plan = prep_model(_resolve_model(args.model), args.weights)
    opts = {}
    if args.calib:
        # restore the persisted calibration (gains / centers / tie-breaks /
        # relu modes / majority voting) and the options it was saved under,
        # so this process resolves exactly what was calibrated
        from .runtime.calibration import (escalation_from_meta, load_calibration,
                                          options_from_meta)

        meta = load_calibration(args.calib, plan)
        opts = options_from_meta(meta)
        print(f"calibration {args.calib}: in_gain={meta['in_gain']} options={opts}")
        esc_layers, esc_name = escalation_from_meta(meta)
        if esc_layers:
            if not args.eval2:
                raise SystemExit(
                    f"calibration escalates layers {sorted(esc_layers)} to "
                    f"{esc_name}: pass --eval2 <eval key at {esc_name} "
                    f"geometry, same-seed keygen>")
            dkey2 = bs.prepare_cloud_key(kio.load_cloud_key(args.eval2), device=dev,
                                         ntt_flavor=args.ntt_flavor)
            opts["escalate"] = (esc_layers, dkey2)
    ct, params, label, _, _ = kio.load_ciphertexts(args.image)
    d = plan.in_dim
    ct = ct.reshape(-1, d.h, d.w, d.in_dep, ct.shape[-1])
    fwd = build_encrypted_forward(plan, dkey, **opts)
    x = torch.as_tensor(ct, device=dev)
    k4_before, s1_before = launches.get("blind_rotate"), launches.get("schoolbook_product")
    mm_before, r_before = launches.get("blind_rotate_mm"), launches.get("schoolbook_round")
    t0 = time.time()
    scores = fwd(x).cpu().numpy()
    dt = time.time() - t0
    record = {"mode": fwd.mode, "images": int(ct.shape[0]),
              "pbs": fwd.pbs_per_image * int(ct.shape[0]),
              "k4_launches": launches.get("blind_rotate") - k4_before,
              "k4mm_launches": launches.get("blind_rotate_mm") - mm_before,
              "round_launches": launches.get("schoolbook_round") - r_before,
              "s1_launches": launches.get("schoolbook_product") - s1_before, "seconds": dt}
    record["pbs_per_s"] = record["pbs"] / dt
    kio.save_ciphertexts(args.out, scores, params, label=label, out_gain=fwd.out_gain,
                         out_center=fwd.out_center)
    print(f"Inference Time: {dt:.2f} seconds")  # matches reference's print (main.cu:72-78)
    print(f"encrypted scores -> {args.out}")
    print(json.dumps(record))
    return record


def cmd_decrypt_image(args):
    from .formats import keys as kio
    from .runtime.encrypted import decrypt_scores

    sk = kio.load_secret_key(args.secret)
    ct, params, label, out_gain, out_center = kio.load_ciphertexts(args.output)
    if ct.ndim == 2:
        ct = ct[None]
    scores = decrypt_scores(sk, ct, sk.params, out_gain, out_center)
    for srow in scores:
        print(f"Classification Result: {int(srow.argmax())}")  # client/decrypt_image.cpp:63
    if label >= 0:
        print(f"(first true label: {label}, scores[0]: {scores[0].tolist()})")


def cmd_ptxt(args):
    from .formats import image_io
    from .models.spec import prep_model
    from .runtime.ptxt import predict

    plan = prep_model(_resolve_model(args.model), args.weights)
    d = plan.in_dim
    labels, px = image_io.load_csv_dataset(args.csv, d.h, d.w, d.in_dep, limit=args.limit)
    x = image_io.pixel_transform_for(args.model)(px)
    preds = predict(plan, x, device=args.device)
    correct = int((preds == labels).sum())
    print(f"Correct: {100.0 * correct / len(labels):f}%")  # main.cpp:111 format


def cmd_stats(args):
    from .models.spec import prep_model
    from .utils.metrics import summarize

    plan = prep_model(_resolve_model(args.model), args.weights)
    print(json.dumps(summarize(plan), indent=2))


def cmd_weight_convert(args):
    from .compiler.weight_convert import weight_convert

    blob = weight_convert(_resolve_model(args.model), args.raw)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"packed weights ({len(blob)} bytes) -> {args.out}")


def cmd_netlist_wizard(args):
    from .compiler.wizard import run_wizard

    csv = run_wizard(sys.stdin, sys.stdout)
    with open(args.out, "w") as f:
        f.write(csv)
    print(f"netlist written to {args.out}; compile it with: "
          f"python -m redsec_tpu_torch compile {args.out} <name>")


def cmd_compile(args):
    from .compiler.netlist import compile_netlist

    out = compile_netlist(args.netlist, args.name, out_dir=args.out_dir)
    print(json.dumps(out, indent=2, default=str))


def add_knob_args(p: argparse.ArgumentParser) -> None:
    """The calibration knobs of ``resolve_pbs_ranges`` as flags, in place of
    the JAX package's environment variables."""
    from .runtime.ranges import CASCADE_W, GAIN_MODES, MAX_FLIP

    p.add_argument("--no-center", action="store_true",
                   help="no relu or final-layer centering (REDSEC_CENTER=0)")
    p.add_argument("--no-tiebreak", action="store_true",
                   help="no parity tie-break on sign layers (REDSEC_TIEBREAK=0)")
    p.add_argument("--gain-mode", choices=GAIN_MODES, default="flip",
                   help="flip-optimal gains (default) or the max-bound power-of-two "
                        "rule (REDSEC_GAIN_MODE)")
    p.add_argument("--cascade-w", type=float, default=CASCADE_W,
                   help=f"weight of the modeled upstream-flip cascade (REDSEC_CASCADE_W; "
                        f"default {CASCADE_W})")
    p.add_argument("--max-flip", type=float, default=MAX_FLIP,
                   help=f"largest predicted local flip rate the guard accepts "
                        f"(REDSEC_MAX_FLIP; default {MAX_FLIP})")


def knobs_from_args(args) -> dict:
    """``resolve_pbs_ranges``'s knob arguments from ``add_knob_args``' flags."""
    return dict(center=not args.no_center, tiebreak=not args.no_tiebreak,
                gain_mode=args.gain_mode, cascade_w=args.cascade_w, max_flip=args.max_flip)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="redsec_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device_arg(p):
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu (the kernels' plain twins)")

    p = sub.add_parser("keygen", help="generate secret + evaluation keys")
    p.add_argument("--params", default="small_v2")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-dir", default=".")
    p.set_defaults(fn=cmd_keygen)

    p = sub.add_parser("encrypt-image", help="encrypt one image")
    p.add_argument("--secret", required=True)
    p.add_argument("--model", default="mnist/sign1024x1")
    p.add_argument("--format", choices=["mnist", "cifar-10", "imagenet"],
                   help="dataset geometry override (client/image_converter.py:10-21)")
    p.add_argument("--image-ptxt")
    p.add_argument("--csv")
    p.add_argument("--row", type=int, default=0)
    p.add_argument("--rows", help="row list/ranges, e.g. 0:8 or 1,5,9 (batch)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="image.ctxt.npz")
    p.add_argument("--calib", help="calibration artifact (applies its "
                                   "model-input encoding gain)")
    p.set_defaults(fn=cmd_encrypt_image)

    p = sub.add_parser("run-encrypted", help="run encrypted inference (cloud side)")
    p.add_argument("--model", required=True)
    p.add_argument("--weights", required=True)
    p.add_argument("--eval", required=True)
    p.add_argument("--eval2", help="second eval key for the layers the calibration "
                                   "escalates (same-seed keygen at the escalation set)")
    p.add_argument("--image", required=True)
    p.add_argument("--calib", help="calibration artifact from `calibrate` — "
                                   "enables the production accuracy "
                                   "mechanism (gains/centers/tie-breaks)")
    p.add_argument("--out", default="network_output.ctxt.npz")
    p.add_argument("--ntt-flavor", choices=["radix2", "matmul"], default="radix2",
                   help="NTT-domain order of the prepared keys (the JAX package's REDSEC_NTT): "
                        "radix2 runs the radix-2 blind-rotation kernel, matmul the four-step "
                        "one where it takes the set (else the four-step loop in torch)")
    device_arg(p)
    p.set_defaults(fn=cmd_run_encrypted)

    p = sub.add_parser("calibrate",
                       help="derive + persist the public calibration "
                            "artifact from plaintext rows (disjoint from "
                            "later evaluation)")
    p.add_argument("--model", required=True)
    p.add_argument("--weights", required=True)
    p.add_argument("--csv", required=True)
    p.add_argument("--rows", default="50:100",
                   help="calibration row list/ranges, e.g. 50:100")
    p.add_argument("--params", default="small_v2")
    p.add_argument("--out", default="calibration.npz")
    p.add_argument("--no-guard", action="store_true",
                   help="skip the strict flip-rate guard at save time")
    p.add_argument("--input-gain", action="store_true",
                   help="also assign a model-input encoding gain (the JAX "
                        "package's REDSEC_INPUT_GAIN=1)")
    p.add_argument("--relu-mode", choices=["quarter", "full"],
                   help="force one relu implementation (REDSEC_RELU_MODE)")
    p.add_argument("--majority-plan",
                   help="per-layer vote counts, e.g. 5:5,7:7 (REDSEC_MAJORITY_PLAN)")
    p.add_argument("--escalate",
                   help="layers whose bootstraps run through the --eval2 key, e.g. 6,7 "
                        "(REDSEC_ESCALATE)")
    p.add_argument("--escalate-params",
                   help="parameter set of the escalation key (REDSEC_ESCALATE_PARAMS; "
                        "default small_v2_n2048)")
    add_knob_args(p)
    device_arg(p)
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("decrypt-image", help="decrypt class scores")
    p.add_argument("--secret", required=True)
    p.add_argument("--output", default="network_output.ctxt.npz")
    p.set_defaults(fn=cmd_decrypt_image)

    p = sub.add_parser("ptxt", help="plaintext accuracy harness")
    p.add_argument("--model", required=True)
    p.add_argument("--weights", required=True)
    p.add_argument("--csv", required=True)
    p.add_argument("--limit", type=int, default=100)
    device_arg(p)
    p.set_defaults(fn=cmd_ptxt)

    p = sub.add_parser("stats", help="per-layer bootstrap/MAC counts for a model")
    p.add_argument("--model", required=True)
    p.add_argument("--weights", required=True)
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser("weight-convert", help="float var.dat1 -> packed var_prep.dat")
    p.add_argument("--model", required=True)
    p.add_argument("--raw", required=True, help="var.dat1 float dump")
    p.add_argument("--out", default="var_prep.dat")
    p.set_defaults(fn=cmd_weight_convert)

    p = sub.add_parser("netlist-wizard",
                       help="interactive netlist generator (role of "
                            "REDsecNetlistGenerator.xlsm)")
    p.add_argument("--out", default="netlist.csv")
    p.set_defaults(fn=cmd_netlist_wizard)

    p = sub.add_parser("compile", help="compile a CSV netlist to a model spec")
    p.add_argument("netlist")
    p.add_argument("name")
    p.add_argument("--out-dir", default=".")
    p.set_defaults(fn=cmd_compile)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
