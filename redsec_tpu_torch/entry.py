"""A small encrypted forward and its example arguments: ``entry()`` returns
them as ``__graft_entry__.py::entry`` does for the JAX package.

    python -m redsec_tpu_torch.entry [--device cpu]   # prints the scores' shape
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .device import resolve_device


def _tiny_setup(device: str):
    """``test_noiseless`` keys prepared on ``device`` and a mini sign model
    (sumpool -> 3x3 conv -> FC16 -> FC10 on 8x8x1) with random ternary
    weights (numpy seed 0)."""
    from .crypto import bootstrap as bs
    from .crypto import keygen as kg
    from .crypto.params import TEST_NOISELESS
    from .formats.varprep import VarPrepWriter
    from .models.dims import Dimensions
    from .models.spec import (
        Activation, BiasKind, ConvKind, ConvParams, Domain, LayerSpec, ModelSpec, PoolKind,
        PoolParams, prep_model,
    )

    rng = np.random.default_rng(0)
    spec = ModelSpec(
        "entry/mini_sign",
        Dimensions(h=8, w=8, in_dep=1, in_bits=5, up_bound=30, scale=15.0),
        [
            LayerSpec(Domain.INT, ConvKind.NONE, 1, PoolKind.SUM, Activation.SIGN,
                      BiasKind.NONE, pool_params=PoolParams((2, 2), (2, 2))),
            LayerSpec(Domain.BIN, ConvKind.CONV, 4, PoolKind.NONE, Activation.SIGN,
                      BiasKind.BNORM, conv_params=ConvParams((3, 3), (1, 1), True)),
            LayerSpec(Domain.BIN, ConvKind.FC, 16, PoolKind.NONE, Activation.SIGN,
                      BiasKind.BNORM),
            LayerSpec(Domain.BIN, ConvKind.FC_FINAL, 10, PoolKind.NONE,
                      Activation.NONE, BiasKind.NONE),
        ],
    )
    wr = VarPrepWriter()
    wr.write_i32(np.array([0]))
    wr.write_tern(rng.choice([-1, 0, 1], size=3 * 3 * 1 * 4))
    wr.write_i32(rng.integers(-3, 4, size=4))
    wr.write_tern(rng.choice([-1, 0, 1], size=4 * 4 * 4 * 16))
    wr.write_i32(rng.integers(-3, 4, size=16))
    wr.write_tern(rng.choice([-1, 0, 1], size=16 * 10))
    wr.write_i32(rng.integers(-3, 4, size=10))
    plan = prep_model(spec, wr.getvalue())

    sk, cloud = kg.keygen(TEST_NOISELESS, seed=0)
    dkey = bs.prepare_cloud_key(cloud, device=device)
    return sk, dkey, plan, rng


def entry(device: str = "cuda"):
    """The encrypted forward of a small sign BNN (conv + fc + batched
    bootstraps) at ``test_noiseless`` and its example arguments, four
    encrypted 8x8 images on ``device``: returns ``(fn, (ct,))``, and
    ``fn(ct)`` gives score ciphertexts [4, 10, n+1]."""
    from .crypto.params import TEST_NOISELESS
    from .runtime.encrypted import build_encrypted_forward, encrypt_images

    dev = resolve_device(device)
    sk, dkey, plan, rng = _tiny_setup(dev.type)
    fwd = build_encrypted_forward(plan, dkey)
    x = rng.integers(-15, 16, size=(4, 8, 8, 1)).astype(np.int32)
    ct = torch.as_tensor(encrypt_images(sk, x, TEST_NOISELESS, rng), device=dev)
    return fwd, (ct,)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    fn, args = entry(ap.parse_args().device)
    print("entry ok:", tuple(fn(*args).shape))
