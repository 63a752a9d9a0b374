"""Train margin-healthy sign-BNN weights (default ``cifar/binarynet_small``)
through the BYON toolchain: train -> var.dat1 -> weight_convert ->
var_prep.dat (the reference's flow, compiler/README.md:29-53; it trains a
Larq twin, nets/cifar/binarynet_small/net.cpp:118-209 is the inference side).

    python -m redsec_tpu_torch.scripts.train_cifar_small --reference <reference checkout> \\
        [--steps 1500] [--model cifar/binarynet_small] [--device cuda|cpu] [--out-dir DIR]

Trains on every row of ``<reference>/nets/cifar/cifar_data.csv`` (or
``mnist/mnist_data.csv`` for an mnist model) and writes ``var.dat1``,
``var_prep.dat`` and ``train_report.json`` to ``--out-dir`` (default
``nets_trained/<model>`` in the repository).  The line ``TRAINREPORT {json}``
prints the report without its history; the script fails unless the exported
plaintext pipeline predicts what the trainer's hard forward predicts on every
row.  TF32 is switched off for the run.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..compiler.train import TrainConfig, train_and_export
from ..formats.image_io import load_csv_dataset, pixel_transform_for
from ..models.zoo import get_model

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def write_outputs(out: str, raw: bytes, prep: bytes, report: dict) -> None:
    """``var.dat1``, ``var_prep.dat`` and ``train_report.json`` into ``out``."""
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "var.dat1"), "wb") as f:
        f.write(raw)
    with open(os.path.join(out, "var_prep.dat"), "wb") as f:
        f.write(prep)
    with open(os.path.join(out, "train_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out}/var.dat1 ({len(raw)} B), var_prep.dat ({len(prep)} B)")
    print("TRAINREPORT " + json.dumps({k: v for k, v in report.items() if k != "history"}))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--margin", type=float, default=6.0)
    ap.add_argument("--bound", type=float, default=80.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", default="cifar/binarynet_small")
    ap.add_argument("--reference", required=True,
                    help="checkout of the reference: nets/<dataset>.csv")
    ap.add_argument("--out-dir", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--scan-chunk", type=int, default=0,
                    help="steps per history record (0: one every 100 steps and the last)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    spec = get_model(args.model)
    d = spec.input_dims
    dataset = ("cifar/cifar_data.csv" if args.model.startswith("cifar")
               else "mnist/mnist_data.csv")
    labels, px = load_csv_dataset(os.path.join(args.reference, "nets", dataset),
                                  d.h, d.w, d.in_dep, limit=None)
    x = pixel_transform_for(args.model)(px)
    print(f"training {args.model} on {len(labels)} rows")

    cfg = TrainConfig(steps=args.steps, lr=args.lr, margin=args.margin,
                      bound=args.bound, seed=args.seed, scan_chunk=args.scan_chunk)
    raw, prep, report = train_and_export(spec, x, labels, cfg, device=args.device)
    write_outputs(args.out_dir or os.path.join(REPO, "nets_trained", args.model),
                  raw, prep, report)
    if report["twin_vs_ptxt_agreement"] != 1.0:
        raise SystemExit("exported ptxt pipeline disagrees with the trainer's hard forward")
    return report


if __name__ == "__main__":
    main()
