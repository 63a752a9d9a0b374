"""The one traffic generator: reads a mix's parameters from its data file
(``benchmark/traffic/<name>.json``) and makes the image pool and the order of
requests from the run's seed.

Keys of a mix file:
  ``images_per_request``  images a request carries (its batch);
  ``pool_images``         distinct images encrypted at set-up, taken in turn;
  ``clients``, ``loop``   1 and "closed": the next request goes once the last
                          one's scores are back on the host;
  ``ink_share``           share of a synthetic image's pixels that are ink;
  ``trace_seconds``       how long a traced block of requests lasts, about.

Images are synthetic 28 x 28 greyscale: background 0 and ``ink_share`` of
the pixels at a uniform 1..255.  The repository holds no dataset and none
can be fetched; an encrypted forward does the same work on any image.
"""

from __future__ import annotations

import json

import numpy as np


def load(path: str) -> dict:
    with open(path) as f:
        mix = json.load(f)
    if mix.get("clients") != 1 or mix.get("loop") != "closed":
        raise ValueError(f"{path}: this generator drives one client in a closed loop")
    if mix["images_per_request"] < 1 or mix["pool_images"] < mix["images_per_request"]:
        raise ValueError(f"{path}: a request needs 1 to pool_images images")
    return mix


def pool_images(mix: dict, cfg: dict, seed: int) -> np.ndarray:
    """The pool's images as message-space integers [P, H, W, C]: raw pixels
    through the configuration's ``pixel_transform`` (a, b): a p + b."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 0x7261666669])
    shape = (mix["pool_images"], *cfg["input"])
    ink = rng.random(shape) < mix["ink_share"]
    pixels = np.where(ink, rng.integers(1, 256, shape), 0)
    a, b = cfg["pixel_transform"]
    return (a * pixels + b).astype(np.int64)


def request_images(mix: dict, r: int) -> list:
    """Pool indices of request r: the next images in turn."""
    k, P = mix["images_per_request"], mix["pool_images"]
    return [(r * k + i) % P for i in range(k)]
