"""Train a margin-healthy relu net (default ``mnist/relu1024x1``) through the
DoReFa/relu BYON leg: the staircase-STE trainer (``compiler/train_relu.py``),
exported through var.dat1 -> weight_convert -> var_prep.dat (the reference's
Larq emitter covers relu twins, compiler/compiler.py:310-328).

    python -m redsec_tpu_torch.scripts.train_relu_mnist --reference <reference checkout> \\
        [--steps 800] [--device cuda|cpu] [--out-dir DIR]

Trains on every row of ``<reference>/nets/mnist/mnist_data.csv`` and writes
``var.dat1``, ``var_prep.dat`` and ``train_report.json`` to ``--out-dir``
(default ``nets_trained/<model>`` in the repository).  The line
``TRAINREPORT {json}`` prints the report without its history; the script
fails unless the exported plaintext pipeline reproduces the trainer's hard
walk's logits bit for bit.  TF32 is switched off for the run.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..compiler.train_relu import ReluTrainConfig, train_and_export_relu
from ..formats.image_io import load_csv_dataset, pixel_transform_for
from ..models.zoo import get_model
from .train_cifar_small import REPO, write_outputs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--edge-margin", type=float, default=0.35)
    ap.add_argument("--lam-edge", type=float, default=1.0)
    ap.add_argument("--logit-margin", type=float, default=24.0)
    ap.add_argument("--hidden-noise", type=float, default=1.0)
    ap.add_argument("--bound", type=float, default=900.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", default="mnist/relu1024x1")
    ap.add_argument("--reference", required=True,
                    help="checkout of the reference: nets/mnist/mnist_data.csv")
    ap.add_argument("--out-dir", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    spec = get_model(args.model)
    d = spec.input_dims
    labels, px = load_csv_dataset(os.path.join(args.reference, "nets", "mnist/mnist_data.csv"),
                                  d.h, d.w, d.in_dep, limit=None)
    x = pixel_transform_for(args.model)(px)
    print(f"training {args.model} on {len(labels)} rows")

    cfg = ReluTrainConfig(steps=args.steps, lr=args.lr, edge_margin=args.edge_margin,
                          bound=args.bound, lam_edge=args.lam_edge,
                          logit_margin=args.logit_margin,
                          hidden_noise=args.hidden_noise, seed=args.seed)
    raw, prep, report = train_and_export_relu(spec, x, labels, cfg, device=args.device)
    write_outputs(args.out_dir or os.path.join(REPO, "nets_trained", args.model),
                  raw, prep, report)
    if not report["logits_bit_exact"]:
        raise SystemExit("exported ptxt pipeline does not bit-match the trainer's hard walk")
    return report


if __name__ == "__main__":
    main()
