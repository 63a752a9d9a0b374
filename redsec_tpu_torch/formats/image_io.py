"""Image I/O: CSV datasets and the client ``image.ptxt`` preamble format.

- Dataset CSVs (nets/mnist/mnist_data.csv, nets/cifar/cifar_data.csv): one image
  per row, ``label,p0,p1,...`` with raw pixel values 0..255 flattened in
  (h, w, channel) order.
- Client ``image.ptxt`` (client/image_converter.py:9-42): single line
  ``label,h,w,c,p0,p1,...,``.

Pixel-domain conversion is model-specific:
- sign / cifar nets: ``2*p - 255``  (nets/mnist/sign1024x1/main.cpp:155)
- relu nets:         ``p // 100 - 1``  (nets/mnist/relu1024x2/main.cpp:203)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_csv_dataset(path: str, h: int, w: int, c: int, limit: int | None = None):
    """Load a REDsec dataset CSV -> (labels [N], pixels [N,h,w,c] raw uint8 range)."""
    labels, images = [], []
    n = h * w * c
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or not line[0].isdigit():
                continue
            vals = line.split(",")
            labels.append(int(vals[0]))
            px = np.array([int(v) for v in vals[1 : n + 1]], dtype=np.int32)
            images.append(px.reshape(h, w, c))
            if limit is not None and len(labels) >= limit:
                break
    return np.array(labels, dtype=np.int32), np.stack(images)


# Dataset geometries of the reference client (client/image_converter.py:10-21)
DATASET_SHAPES = {
    "mnist": (28, 28, 1),
    "cifar-10": (32, 32, 3),
    "imagenet": (224, 224, 3),
}


def image_shape_for(fmt: str) -> Tuple[int, int, int]:
    """(h, w, c) for a named dataset format (mnist | cifar-10 | imagenet)."""
    try:
        return DATASET_SHAPES[fmt]
    except KeyError:
        raise KeyError(
            f"unknown image format {fmt!r}; available: {sorted(DATASET_SHAPES)}"
        ) from None


def shape_for_model(model_name: str) -> Tuple[int, int, int]:
    """Infer the dataset geometry from a model name (mnist/* -> 28x28x1,
    cifar/* -> 32x32x3, imagenet/* -> 224x224x3)."""
    if "imagenet" in model_name:
        return DATASET_SHAPES["imagenet"]
    if "mnist" in model_name:
        return DATASET_SHAPES["mnist"]
    return DATASET_SHAPES["cifar-10"]


def pixels_to_signed(pixels: np.ndarray) -> np.ndarray:
    """2p - 255 mapping used by sign/cifar nets and the client encryptor
    (client/encrypt_image.cpp:76)."""
    return (2 * pixels.astype(np.int32) - 255).astype(np.int32)


def pixels_to_ternary(pixels: np.ndarray) -> np.ndarray:
    """p//100 - 1 mapping used by the relu nets (nets/mnist/relu1024x2/main.cpp:203)."""
    return (pixels.astype(np.int32) // 100 - 1).astype(np.int32)


def pixel_transform_for(model_name: str):
    return pixels_to_ternary if "relu" in model_name else pixels_to_signed


def write_image_ptxt(path: str, label: int, pixels: np.ndarray) -> None:
    """Write the client's ``image.ptxt`` single-line format
    (client/image_converter.py:26-42)."""
    h, w, c = pixels.shape
    flat = pixels.reshape(-1)
    with open(path, "w") as f:
        f.write(f"{label},{h},{w},{c},")
        f.write(",".join(str(int(v)) for v in flat))
        f.write(",")


def read_image_ptxt(path: str) -> Tuple[int, np.ndarray]:
    with open(path) as f:
        vals = [v for v in f.read().strip().split(",") if v != ""]
    label, h, w, c = (int(v) for v in vals[:4])
    px = np.array([int(v) for v in vals[4 : 4 + h * w * c]], dtype=np.int32)
    return label, px.reshape(h, w, c)
