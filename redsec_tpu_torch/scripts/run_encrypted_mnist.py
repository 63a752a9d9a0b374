"""Encrypted inference over rows of a dataset, batch by batch, with a
checkpoint to resume from: client encrypt -> cloud forward -> client decrypt,
compared with the plaintext oracle's predictions.  Works for any zoo model
(``mnist/sign*``, ``mnist/relu*``, ``cifar/*``).

    python -m redsec_tpu_torch.scripts.run_encrypted_mnist --reference <reference checkout> \\
        --model cifar/binarynet --params small_v2_tpu --images 100 --batch 4 \\
        --checkpoint build/binarynet.ckpt.json [--device cpu]

The dataset is ``<reference>/nets/mnist/mnist_data.csv`` (or
``cifar/cifar_data.csv``); the weights are ``--varprep`` or
``<reference>/nets/<model>/var_prep.dat``.  Keys come from
``formats.keys.ensure_keyset`` (cached raw under the repository's
``.keys/``, seed 0), prepared on ``--device`` (default ``cuda``).

The checkpoint is the JAX package's file, key for key: a fingerprint of the
configuration and each finished batch's predictions and seconds under its
first row.  A batch's encryption randomness is seeded by its absolute first
row, so a resumed run, a run extended to more ``--images`` and a run at an
``--eval-offset`` give the same ciphertexts for the same rows as one
uninterrupted run; either package resumes or extends the other's file.

Where the JAX package's script reads ``REDSEC_INPUT_GAIN``,
``REDSEC_MAJORITY_PLAN``, ``REDSEC_ESCALATE``, ``REDSEC_ESCALATE_PARAMS``,
``REDSEC_TIME_MODE`` and the calibration knobs from the environment, this
takes ``--input-gain``, ``--majority-plan``, ``--escalate``,
``--escalate-params``, ``--time-mode`` and the flags of ``calibrate``
(``--no-center``, ``--no-tiebreak``, ``--gain-mode``, ``--cascade-w``,
``--max-flip``).  Under ``--load-calib`` the knobs are this run's flags, not
the ones the artifact records: the JAX script takes them from its run's
environment and replays nothing, so the same flags give the same ciphertexts
in both packages (the CLI's ``run-encrypted --calib`` does otherwise).  The
JAX script's ``--pbs-macro`` and its staged program split bound a TPU
compiler's programs and have no counterpart here: one eager forward serves
every model.  ``--jit`` is only a label, kept in the fingerprint so that a
checkpoint of either package resumes in the other.

The last line is the JAX script's ``RESULT ...``; the line before it gives
the blind-rotation (K4), schoolbook round (S1-fft) and schoolbook-product
(S1) launches counted at the kernels' doors over the batches this run
encrypted.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def fingerprint_for(args, nb: int, vp: str, calib_tag: str) -> dict:
    """The checkpoint's configuration record, with the JAX script's keys and
    value formats: ``calib`` and ``eval_offset`` only where engaged, so files
    written before either existed keep resuming."""
    fp = {"model": args.model, "params": args.params, "images": args.images,
          "batch": nb, "jit": args.jit, "input_gain": "1" if args.input_gain else "0",
          "majority_plan": args.majority_plan, "escalate": args.escalate, "varprep": vp}
    if args.calib_rows or args.load_calib:
        fp["calib"] = calib_tag
    if args.eval_offset:
        fp["eval_offset"] = args.eval_offset
    return fp


def resume_checkpoint(path: str, fingerprint: dict) -> tuple:
    """-> (checkpoint dict, the previous fingerprint or None).  Refuses a file
    written by another configuration; a file differing only by fewer
    ``images`` is extended."""
    if not (path and os.path.exists(path)):
        return {"fingerprint": fingerprint, "batches": {}}, None
    with open(path) as f:
        prev = json.load(f)
    pf = dict(prev.get("fingerprint") or {})
    extend_ok = (pf.get("images") is not None and pf["images"] <= fingerprint["images"]
                 and {**pf, "images": fingerprint["images"]} == fingerprint)
    if pf != fingerprint and not extend_ok:
        raise SystemExit(f"checkpoint {path} was written by a different configuration:\n"
                         f"  {pf}\nvs\n  {fingerprint}")
    prev["fingerprint"] = fingerprint
    return prev, pf


def save_checkpoint(path: str, ck: dict) -> None:
    """Write ``ck`` to ``path`` through a ``.tmp`` file and ``os.replace``."""
    if not path:
        return
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(ck, f)
    os.replace(tmp, path)


def build_parser() -> argparse.ArgumentParser:
    from ..cli import add_knob_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", type=int, default=8)
    ap.add_argument("--model", default="mnist/sign1024x1")
    ap.add_argument("--params", default="small_v2")
    ap.add_argument("--reference", required=True,
                    help="checkout of the reference: nets/<dataset>.csv and, without "
                         "--varprep, nets/<model>/var_prep.dat")
    ap.add_argument("--varprep", default="",
                    help="path to a var_prep.dat overriding the reference net's shipped "
                         "weights (e.g. the BYON-trained output of train_cifar_small)")
    ap.add_argument("--batch", type=int, default=0,
                    help="images per encrypted batch (0 = all at once)")
    ap.add_argument("--jit", default="auto",
                    help="a label kept in the checkpoint's fingerprint (the JAX script's "
                         "compile mode; one eager forward runs here)")
    ap.add_argument("--pbs-chunk", type=int, default=512)
    ap.add_argument("--no-range-check", action="store_true",
                    help="accept reference-style silent wrapping (toy params)")
    ap.add_argument("--checkpoint", default="",
                    help="JSON path: each batch's decrypted results, written after every "
                         "batch, so a killed run resumes at the next batch")
    ap.add_argument("--eval-offset", type=int, default=0,
                    help="first evaluated row (eval set = offset .. offset+images-1)")
    ap.add_argument("--calib-rows", default="",
                    help="row spec (e.g. 50:100) to calibrate on INSTEAD of the evaluated "
                         "rows; must be disjoint from them")
    ap.add_argument("--save-calib", default="",
                    help="persist the calibration as a public artifact "
                         "(runtime/calibration.py) for the command line's flow")
    ap.add_argument("--load-calib", default="",
                    help="restore the calibration from an artifact instead of computing it")
    ap.add_argument("--input-gain", action="store_true",
                    help="also assign a model-input encoding gain (REDSEC_INPUT_GAIN=1)")
    ap.add_argument("--majority-plan", default="",
                    help="per-layer vote counts 'i:k,j:k' (REDSEC_MAJORITY_PLAN)")
    ap.add_argument("--escalate", default="",
                    help="comma list of layers whose PBS runs through a second key at "
                         "--escalate-params geometry (REDSEC_ESCALATE)")
    ap.add_argument("--escalate-params", default="",
                    help="the second key's parameter set (REDSEC_ESCALATE_PARAMS; default "
                         "small_v2_n2048)")
    ap.add_argument("--time-mode", choices=["warm", "cold"], default="warm",
                    help="warm (default): run the first pending batch once before the timed "
                         "loop; cold: time it with its start-up (REDSEC_TIME_MODE)")
    add_knob_args(ap)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain twins)")
    return ap


def main(argv=None) -> dict:
    from ..cli import _parse_rows, knobs_from_args

    args = build_parser().parse_args(argv)

    eval_rows = range(args.eval_offset, args.eval_offset + args.images)
    calib_rows = _parse_rows(args.calib_rows) if args.calib_rows else None
    if calib_rows is not None:
        overlap = sorted(set(calib_rows) & set(eval_rows))
        if overlap:
            raise SystemExit(
                f"--calib-rows overlaps the evaluated rows {eval_rows.start}:{eval_rows.stop}: "
                f"{overlap} — held-out calibration must be disjoint")

    import torch

    from ..device import launches, resolve_device
    from ..formats.image_io import load_csv_dataset, pixel_transform_for
    from ..formats.keys import ensure_keyset
    from ..models.spec import prep_model
    from ..models.zoo import get_model
    from ..runtime.calibration import ESCALATE_PARAMS, load_calibration, save_calibration
    from ..runtime.encrypted import (
        build_encrypted_forward, decrypt_scores, encrypt_images, model_in_gain, model_out_center,
        model_out_gain,
    )
    from ..runtime.ptxt import build_forward
    from ..runtime.ranges import calibrate_ranges
    from ..utils.metrics import summarize

    dev = resolve_device(args.device)
    knobs = knobs_from_args(args)
    t0 = time.time()
    sk, dkey = ensure_keyset(args.params, seed=0, device=args.device)
    print(f"[{time.time()-t0:6.1f}s] keys ready ({args.params})")

    vp = args.varprep or os.path.join(args.reference, "nets", args.model, "var_prep.dat")
    plan = prep_model(get_model(args.model), vp)
    stats = summarize(plan)
    print(f"[{time.time()-t0:6.1f}s] model {args.model}: "
          f"{stats['total_bootstraps']} bootstraps/image")

    d = plan.in_dim
    dataset = "cifar/cifar_data.csv" if args.model.startswith("cifar") else "mnist/mnist_data.csv"
    n_load = max([eval_rows.stop] + ([max(calib_rows) + 1] if calib_rows else []))
    labels_all, px_all = load_csv_dataset(os.path.join(args.reference, "nets", dataset),
                                          d.h, d.w, d.in_dep, limit=n_load)
    x_all = pixel_transform_for(args.model)(px_all)
    labels = labels_all[eval_rows.start:eval_rows.stop]
    x = x_all[eval_rows.start:eval_rows.stop]
    ptxt_preds = build_forward(plan, args.device)(x).cpu().numpy().argmax(1)

    # three calibration modes: a persisted artifact, held-out rows, or the
    # evaluated rows themselves (leakage-prone, flagged in the RESULT line)
    if args.load_calib:
        meta = load_calibration(args.load_calib, plan)
        calib_tag = f"artifact:{os.path.basename(args.load_calib)}"
        print(f"[{time.time()-t0:6.1f}s] calibration restored from {args.load_calib} "
              f"(rows: {meta.get('calib_rows')})")
    elif calib_rows is not None:
        calibrate_ranges(plan, x_all[calib_rows], device=args.device)
        calib_tag = f"heldout:{args.calib_rows}"
        print(f"[{time.time()-t0:6.1f}s] calibrated on {len(calib_rows)} HELD-OUT rows "
              f"({args.calib_rows}), disjoint from eval {eval_rows.start}:{eval_rows.stop}")
    else:
        calibrate_ranges(plan, x, device=args.device)
        calib_tag = "eval-rows(leaky)"
    if args.save_calib:
        save_calibration(args.save_calib, plan, args.params,
                         calib_rows=f"{dataset}[{args.calib_rows or 'eval'}]",
                         input_gain=args.input_gain, majority_plan=args.majority_plan or None,
                         escalate=args.escalate or None,
                         escalate_params=args.escalate_params or None, **knobs)
        print(f"[{time.time()-t0:6.1f}s] calibration artifact -> {args.save_calib}")

    # per-layer escalation: those layers' PBS through a same-seed key at the
    # second geometry, which shares the client's LWE key
    escalate = None
    esc_layers = {int(s) for s in args.escalate.split(",") if s.strip()}
    if esc_layers:
        esc_name = args.escalate_params or ESCALATE_PARAMS
        sk2, dkey2 = ensure_keyset(esc_name, seed=0, device=args.device)
        if not np.array_equal(sk2.lwe_key, sk.lwe_key):
            raise SystemExit("escalation keyset does not share the client LWE key")
        escalate = (esc_layers, dkey2)
        print(f"[{time.time()-t0:6.1f}s] escalation: layers {sorted(esc_layers)} -> {esc_name}")

    fwd = build_encrypted_forward(plan, dkey, pbs_chunk=args.pbs_chunk,
                                  range_check=not args.no_range_check,
                                  input_gain=args.input_gain,
                                  majority_plan=args.majority_plan or None, escalate=escalate,
                                  **knobs)
    info = fwd.info
    efr = {i: round(r.expected_flip_rate, 5) for i, r in info.items()
           if r.expected_flip_rate is not None}
    if efr:
        print(f"[{time.time()-t0:6.1f}s] flip-optimal gains; predicted per-boundary flip "
              f"rates: {efr}")
    modes = {i: r.relu_mode for i, r in info.items() if r.relu_mode}
    if modes:
        print(f"[{time.time()-t0:6.1f}s] relu modes: {modes}")
    print(f"[{time.time()-t0:6.1f}s] encoding gains: "
          f"{ {i: (r.in_gain, r.out_gain) for i, r in info.items()} }"
          f" centers: { {i: int(np.abs(r.center).max()) for i, r in info.items() if r.center is not None} }")
    in_gain, out_gain, out_center = (model_in_gain(info), model_out_gain(info),
                                     model_out_center(info))
    nb = args.batch or args.images

    def run_batch(xb, i0):
        """Encrypt -> forward -> decrypt one batch; -> (preds, seconds).  The
        decrypt's copy to the host ends the forward's work on the card."""
        rng = np.random.default_rng(1_000_003 + i0 + args.eval_offset)
        ct = torch.as_tensor(encrypt_images(sk, xb, dkey.params, rng, gain=in_gain), device=dev)
        t1 = time.time()
        scores = decrypt_scores(sk, fwd(ct), dkey.params, out_gain, out_center)
        return scores.argmax(1), time.time() - t1

    fingerprint = fingerprint_for(args, nb, vp, calib_tag)
    ck, pf = resume_checkpoint(args.checkpoint, fingerprint)
    if pf is not None:
        done = sorted(int(k) for k in ck["batches"])
        print(f"[{time.time()-t0:6.1f}s] resuming: {len(done)} batch(es) already done {done}"
              + (f" (extended {pf['images']} -> {fingerprint['images']} images)"
                 if pf.get("images") != fingerprint["images"] else ""))

    cold = args.time_mode == "cold"
    pending = [i0 for i0 in range(0, args.images, nb) if str(i0) not in ck["batches"]]
    doors = ("blind_rotate", "schoolbook_round", "schoolbook_product")
    before = {k: launches.get(k) for k in doors}
    if not cold and pending:
        _, t_first = run_batch(x[pending[0]:pending[0] + nb], pending[0])
        print(f"[{time.time()-t0:6.1f}s] first (start-up+run) batch: {t_first:.1f}s")
    all_preds, dt, n_resumed = [], 0.0, 0
    for i0 in range(0, args.images, nb):
        if str(i0) in ck["batches"]:
            rec = ck["batches"][str(i0)]
            p, step = np.asarray(rec["preds"]), rec["secs"]
            n_resumed += 1
        else:
            p, step = run_batch(x[i0:i0 + nb], i0)
            ck["batches"][str(i0)] = {"preds": p.tolist(), "secs": step}
            save_checkpoint(args.checkpoint, ck)
            print(f"[{time.time()-t0:6.1f}s] batch {i0 // nb}: {step:.1f}s "
                  f"({step / max(len(p), 1):.1f} s/image)", flush=True)
        all_preds.append(p)
        dt += step
    counted = {k: launches.get(k) - before[k] for k in doors}
    preds = np.concatenate(all_preds)[:args.images]
    per_img = dt / args.images

    agree = float((preds == ptxt_preds).mean())
    acc = float((preds == labels).mean())
    boots_rate = stats["total_bootstraps"] / per_img
    print(f"Inference Time: {dt:.2f} seconds for {args.images} images "
          f"({per_img:.2f} s/image, {boots_rate:.0f} bootstraps/s)")
    print(f"encrypted preds: {preds.tolist()}")
    print(f"plaintext preds: {ptxt_preds.tolist()}")
    print(f"labels:          {labels.tolist()}")
    print(f"launches: {json.dumps(counted)}")
    print(f"RESULT model={args.model} params={args.params} images={args.images} "
          f"s_per_image={per_img:.3f} bootstraps_per_s={boots_rate:.0f} "
          f"oracle_agreement={agree:.3f} accuracy={acc:.3f} "
          f"calib={calib_tag}"
          + (f" eval_offset={args.eval_offset}" if args.eval_offset else "")
          + (" timing=cold(compile-inclusive)" if cold else "")
          + (f" resumed_batches={n_resumed}" if n_resumed else ""), flush=True)
    return {"preds": preds.tolist(), "batches_run": pending, "resumed_batches": n_resumed,
            "launches": counted, "s_per_image": per_img, "bootstraps_per_s": boots_rate,
            "oracle_agreement": agree, "accuracy": acc, "calib": calib_tag,
            "fingerprint": fingerprint}


if __name__ == "__main__":
    main()
