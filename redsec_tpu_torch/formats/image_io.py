"""Pixel-domain conversion of raw 0..255 images (model-specific):

- sign / cifar nets: ``2*p - 255``  (nets/mnist/sign1024x1/main.cpp:155)
- relu nets:         ``p // 100 - 1``  (nets/mnist/relu1024x2/main.cpp:203)
"""

from __future__ import annotations

import numpy as np


def pixels_to_signed(pixels: np.ndarray) -> np.ndarray:
    """2p - 255 mapping used by sign/cifar nets and the client encryptor
    (client/encrypt_image.cpp:76)."""
    return (2 * pixels.astype(np.int32) - 255).astype(np.int32)


def pixels_to_ternary(pixels: np.ndarray) -> np.ndarray:
    """p//100 - 1 mapping used by the relu nets (nets/mnist/relu1024x2/main.cpp:203)."""
    return (pixels.astype(np.int32) // 100 - 1).astype(np.int32)


def pixel_transform_for(model_name: str):
    return pixels_to_ternary if "relu" in model_name else pixels_to_signed
