"""Shipped model zoo: the architectures generated into ``nets/`` by the reference.

Each spec function mirrors the corresponding generated ``net.cpp`` constructor chain
so the shipped ``var_prep.dat`` files load unchanged:

- mnist/sign1024x{1,2,3}  : nets/mnist/sign1024x1/net.cpp:85-93 (and x2/x3)
- mnist/relu1024x{1,2,3}  : nets/mnist/relu1024x2/net.cpp:114-160
- cifar/binarynet         : nets/cifar/binarynet/net.cpp:114-210
- cifar/binarynet_small   : nets/cifar/binarynet_small/net.cpp:114-209
- sample/sample           : nets/sample/sample/net.cpp:112-144
"""

from __future__ import annotations

from typing import Callable, Dict

from .dims import Dimensions, cifar_input_dims, mnist_input_dims, mnist_relu_input_dims
from .spec import (
    Activation,
    BiasKind,
    ConvKind,
    ConvParams,
    Domain,
    LayerSpec,
    ModelSpec,
    PoolKind,
    PoolParams,
)


def _mnist_sign(n_hidden: int) -> ModelSpec:
    pool22 = PoolParams(window=(2, 2), stride=(2, 2), same_pad=False)
    layers = [
        # Layer 0: SumPool 2x2 -> Sign  (IntLayer(E_NO_CONV, E_SUMPOOL, SIGN))
        LayerSpec(
            domain=Domain.INT,
            conv=ConvKind.NONE,
            out_depth=1,
            pool=PoolKind.SUM,
            activation=Activation.SIGN,
            bias=BiasKind.NONE,
            pool_params=pool22,
        )
    ]
    for _ in range(n_hidden):
        layers.append(
            LayerSpec(
                domain=Domain.BIN,
                conv=ConvKind.FC,
                out_depth=1024,
                activation=Activation.SIGN,
                bias=BiasKind.BNORM,
                conv_params=ConvParams(tern_thresh=0.05),
            )
        )
    layers.append(
        LayerSpec(
            domain=Domain.BIN,
            conv=ConvKind.FC_FINAL,
            out_depth=10,
            activation=Activation.NONE,
            bias=BiasKind.NONE,
            conv_params=ConvParams(tern_thresh=0.05),
        )
    )
    return ModelSpec(f"mnist/sign1024x{n_hidden}", mnist_input_dims(), layers)


def _mnist_relu(n_hidden: int) -> ModelSpec:
    pool22 = PoolParams(window=(2, 2), stride=(2, 2), same_pad=False)
    layers = [
        # Layer 0: SumPool 2x2, no activation (IntLayer(E_NO_CONV, E_SUMPOOL, NONE))
        LayerSpec(
            domain=Domain.INT,
            conv=ConvKind.NONE,
            out_depth=1,
            pool=PoolKind.SUM,
            activation=Activation.NONE,
            bias=BiasKind.NONE,
            pool_params=pool22,
        )
    ]
    for _ in range(n_hidden):
        layers.append(
            LayerSpec(
                domain=Domain.INT,
                conv=ConvKind.FC,
                out_depth=1024,
                activation=Activation.RELU,
                bias=BiasKind.BNORM,
                conv_params=ConvParams(tern_thresh=0.1),
                shift_bits=4,
            )
        )
    layers.append(
        LayerSpec(
            domain=Domain.INT,
            conv=ConvKind.FC,
            out_depth=10,
            activation=Activation.NONE,
            bias=BiasKind.NONE,
            conv_params=ConvParams(tern_thresh=0.1),
        )
    )
    return ModelSpec(f"mnist/relu1024x{n_hidden}", mnist_relu_input_dims(), layers)


def _cifar_binarynet(small: bool) -> ModelSpec:
    convs = [64, 64, 128, 128, 256, 256] if small else [128, 128, 256, 256, 512, 512]
    fcs = [512, 512] if small else [1024, 1024]
    conv33 = ConvParams(window=(3, 3), same_pad=True, tern_thresh=0.05)
    pool22 = PoolParams(window=(2, 2), stride=(2, 2), same_pad=False)
    layers = [
        # Layer 0: passthrough sign on the 8-bit pixels
        LayerSpec(
            domain=Domain.INT,
            conv=ConvKind.NONE,
            out_depth=3,
            activation=Activation.SIGN,
            bias=BiasKind.NONE,
        )
    ]
    for i, depth in enumerate(convs):
        layers.append(
            LayerSpec(
                domain=Domain.BIN,
                conv=ConvKind.CONV,
                out_depth=depth,
                pool=PoolKind.MAX if i % 2 == 1 else PoolKind.NONE,
                activation=Activation.SIGN,
                bias=BiasKind.BNORM,
                conv_params=conv33,
                pool_params=pool22,
            )
        )
    for depth in fcs:
        layers.append(
            LayerSpec(
                domain=Domain.BIN,
                conv=ConvKind.FC,
                out_depth=depth,
                activation=Activation.SIGN,
                bias=BiasKind.BNORM,
                conv_params=ConvParams(tern_thresh=0.05),
            )
        )
    layers.append(
        LayerSpec(
            domain=Domain.BIN,
            conv=ConvKind.FC_FINAL,
            out_depth=10,
            activation=Activation.NONE,
            bias=BiasKind.NONE,
            conv_params=ConvParams(tern_thresh=0.05),
        )
    )
    name = "cifar/binarynet_small" if small else "cifar/binarynet"
    return ModelSpec(name, cifar_input_dims(), layers)


def _sample() -> ModelSpec:
    pool22 = PoolParams(window=(2, 2), stride=(2, 2), same_pad=False)
    dims = Dimensions(h=28, w=28, in_dep=1, in_bits=8, up_bound=2 * 255, scale=255.0)
    layers = [
        LayerSpec(
            domain=Domain.INT,
            conv=ConvKind.NONE,
            out_depth=1,
            pool=PoolKind.SUM,
            activation=Activation.SIGN,
            bias=BiasKind.NONE,
            pool_params=pool22,
        )
    ]
    for _ in range(3):
        layers.append(
            LayerSpec(
                domain=Domain.BIN,
                conv=ConvKind.FC,
                out_depth=1024,
                activation=Activation.SIGN,
                bias=BiasKind.BNORM,
                conv_params=ConvParams(tern_thresh=0.05),
            )
        )
    layers.append(
        LayerSpec(
            domain=Domain.BIN,
            conv=ConvKind.FC,
            out_depth=10,
            activation=Activation.NONE,
            bias=BiasKind.NONE,
            conv_params=ConvParams(tern_thresh=0.05),
        )
    )
    return ModelSpec("sample/sample", dims, layers)


MODELS: Dict[str, Callable[[], ModelSpec]] = {
    "mnist/sign1024x1": lambda: _mnist_sign(1),
    "mnist/sign1024x2": lambda: _mnist_sign(2),
    "mnist/sign1024x3": lambda: _mnist_sign(3),
    "mnist/relu1024x1": lambda: _mnist_relu(1),
    "mnist/relu1024x2": lambda: _mnist_relu(2),
    "mnist/relu1024x3": lambda: _mnist_relu(3),
    "cifar/binarynet": lambda: _cifar_binarynet(False),
    "cifar/binarynet_small": lambda: _cifar_binarynet(True),
    "sample/sample": _sample,
}


def get_model(name: str) -> ModelSpec:
    try:
        return MODELS[name]()
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODELS)}") from None
