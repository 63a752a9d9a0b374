"""Torus32 arithmetic helpers.

The torus T = R/Z is represented by 32-bit integers with wraparound
(``Torus32`` in TFHE): the int32 value ``t`` denotes the real ``t / 2^32``.
Host-side helpers use numpy uint64 for exact TFHE-compatible rounding; the
device-side mod-switch (used inside the bootstrap) exploits power-of-two
message spaces and reduces to a shift-round (see bootstrap.py).
"""

from __future__ import annotations

import numpy as np


def mod_switch_to_torus32(mu, msize: int) -> np.ndarray:
    """TFHE ``modSwitchToTorus32``: value ``mu`` in Z_msize -> nearest torus32.

    interv = ((2^63 / msize) * 2); phase = mu * interv (mod 2^64) >> 32.
    """
    interv = ((1 << 63) // msize) * 2
    mu_u = np.asarray(mu).astype(np.int64).astype(np.uint64)
    phase = (mu_u * np.uint64(interv)) >> np.uint64(32)
    return phase.astype(np.uint32).astype(np.int32)


def mod_switch_from_torus32(phase, msize: int) -> np.ndarray:
    """TFHE ``modSwitchFromTorus32``: torus32 -> rounded value in [0, msize)."""
    interv = ((1 << 63) // msize) * 2
    half = interv // 2
    ph = np.asarray(phase).astype(np.int64).astype(np.uint64) << np.uint64(32)
    return ((ph + np.uint64(half)) // np.uint64(interv)).astype(np.int64) % msize


def decode_signed(phase, msize: int) -> np.ndarray:
    """Decode a torus32 phase to a signed integer in [-msize/2, msize/2)
    (client decrypt recentering, client/decrypt_image.cpp:52-58)."""
    v = mod_switch_from_torus32(phase, msize)
    return np.where(v >= msize // 2, v - msize, v).astype(np.int64)
