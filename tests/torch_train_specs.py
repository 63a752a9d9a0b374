"""Mini specs and data of the port's trainer tests (those of
tests/test_train.py and tests/test_train_relu.py), importable without JAX:
tests/test_torch_imports.py runs the trainers with JAX blocked."""

import numpy as np

from redsec_tpu_torch.models.dims import Dimensions
from redsec_tpu_torch.models.spec import (
    Activation, BiasKind, ConvKind, ConvParams, Domain, LayerSpec, ModelSpec, PoolKind,
    PoolParams,
)


def mini_spec():
    """tests/test_train.py's mini spec: sumpool -> 3x3 conv 8 + maxpool ->
    FC32 -> FC4 on 8x8x1."""
    return ModelSpec(
        "test/mini_train",
        Dimensions(h=8, w=8, in_dep=1, in_bits=9, up_bound=255, scale=255.0),
        [
            LayerSpec(Domain.INT, ConvKind.NONE, 1, PoolKind.SUM,
                      Activation.SIGN, BiasKind.NONE,
                      pool_params=PoolParams((2, 2), (2, 2))),
            LayerSpec(Domain.BIN, ConvKind.CONV, 8, PoolKind.MAX,
                      Activation.SIGN, BiasKind.BNORM,
                      conv_params=ConvParams((3, 3), (1, 1), True, tern_thresh=0.05),
                      pool_params=PoolParams((2, 2), (2, 2))),
            LayerSpec(Domain.BIN, ConvKind.FC, 32, PoolKind.NONE,
                      Activation.SIGN, BiasKind.BNORM,
                      conv_params=ConvParams(tern_thresh=0.05)),
            LayerSpec(Domain.BIN, ConvKind.FC_FINAL, 4, PoolKind.NONE,
                      Activation.NONE, BiasKind.NONE,
                      conv_params=ConvParams(tern_thresh=0.05)),
        ])


def sign_data(seed=3, n=24):
    rng = np.random.default_rng(seed)
    px = rng.integers(-255, 256, size=(n, 8, 8, 1)).astype(np.int32)
    labels = rng.integers(0, 4, size=n).astype(np.int32)
    return px, labels


def mini_relu_spec():
    """8x8 ternary input -> SumPool2x2 -> FC32 BNORM RELU(sh=3) ->
    FC16 BNORM RELU(sh=4) -> FC3 (tests/test_train_relu.py's)."""
    return ModelSpec(
        "test/mini_relu",
        Dimensions(h=8, w=8, in_dep=1, in_bits=2, up_bound=2, scale=1.0),
        [
            LayerSpec(Domain.INT, ConvKind.NONE, 1, PoolKind.SUM,
                      Activation.NONE, BiasKind.NONE,
                      pool_params=PoolParams((2, 2), (2, 2))),
            LayerSpec(Domain.INT, ConvKind.FC, 32, PoolKind.NONE,
                      Activation.RELU, BiasKind.BNORM,
                      conv_params=ConvParams(tern_thresh=0.1), shift_bits=3),
            LayerSpec(Domain.INT, ConvKind.FC, 16, PoolKind.NONE,
                      Activation.RELU, BiasKind.BNORM,
                      conv_params=ConvParams(tern_thresh=0.1), shift_bits=4),
            LayerSpec(Domain.INT, ConvKind.FC, 3, PoolKind.NONE,
                      Activation.NONE, BiasKind.NONE,
                      conv_params=ConvParams(tern_thresh=0.1)),
        ],
    )


def relu_data(n=48, seed=3):
    rng = np.random.default_rng(seed)
    px = rng.integers(-1, 2, size=(n, 8, 8, 1)).astype(np.int32)
    labels = rng.integers(0, 3, size=n)
    return px, labels


def write_csv(path, labels, px):
    """A dataset CSV in load_csv_dataset's format: label, then the pixels."""
    with open(path, "w") as f:
        for label, img in zip(labels, px):
            f.write(f"{int(label)}," + ",".join(str(int(v)) for v in img.reshape(-1)) + "\n")
