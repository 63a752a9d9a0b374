"""LWE primitives (host side) and ciphertext tensor conventions.

A ciphertext is a plain int32 array ``[..., n+1]``: columns ``[:n]`` hold the
mask ``a`` and column ``n`` holds the body ``b = <a,s> + mu + e`` — the direct
tensorization of TFHE's ``LweSample``.  Batch = leading dims.  All leveled
operations (lweAddTo / lweSubTo / lweAddMulTo / lweNoiselessTrivial, used by
the reference at lib/BinOps_enc.cpp:121-143) are ordinary int32 vector adds
with two's-complement wraparound, which is exactly torus arithmetic.
"""

from __future__ import annotations

import numpy as np

from .params import TfheParams
from .torus import mod_switch_to_torus32


def gaussian_torus32(rng: np.random.Generator, alpha: float, shape) -> np.ndarray:
    """Gaussian noise with stddev ``alpha`` (torus units) rounded to torus32."""
    if alpha == 0.0:
        return np.zeros(shape, dtype=np.int32)
    e = rng.normal(0.0, alpha, size=shape)
    return np.round(e * (2.0**32)).astype(np.int64).astype(np.uint32).astype(np.int32)


def lwe_key_gen(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 2, size=n, dtype=np.int64).astype(np.int32)


def lwe_encrypt(
    key: np.ndarray, mu: np.ndarray, alpha: float, rng: np.random.Generator
) -> np.ndarray:
    """Encrypt torus32 messages ``mu`` [...] -> ciphertexts [..., n+1]."""
    mu = np.asarray(mu, dtype=np.int32)
    n = key.shape[0]
    a = rng.integers(0, 1 << 32, size=mu.shape + (n,), dtype=np.uint64).astype(
        np.uint32
    ).astype(np.int32)
    e = gaussian_torus32(rng, alpha, mu.shape)
    b = (a.astype(np.int64) * key.astype(np.int64)).sum(axis=-1).astype(np.int32)
    b = (b + mu + e).astype(np.int32)
    return np.concatenate([a, b[..., None]], axis=-1)


def lwe_phase(key: np.ndarray, ct: np.ndarray) -> np.ndarray:
    """b - <a, s> (torus32)."""
    a = ct[..., :-1]
    b = ct[..., -1]
    dot = (a.astype(np.int64) * key.astype(np.int64)).sum(axis=-1).astype(np.int32)
    return (b - dot).astype(np.int32)


def lwe_decrypt_signed(key: np.ndarray, ct: np.ndarray, msize: int) -> np.ndarray:
    """Decrypt and recenter to [-msize/2, msize/2) (client/decrypt_image.cpp:52-58)."""
    from .torus import decode_signed

    return decode_signed(lwe_phase(key, ct), msize)


def encrypt_integers(
    key: np.ndarray, values: np.ndarray, params: TfheParams, rng: np.random.Generator,
    alpha: float | None = None,
) -> np.ndarray:
    """Encrypt small signed integers in the REDsec message space
    (client/encrypt_image.cpp:76-77: lweSymEncrypt(modSwitchToTorus32(v, 4096), 2^-15))."""
    mu = mod_switch_to_torus32(np.asarray(values), params.msg_space)
    return lwe_encrypt(key, mu, params.alpha_enc if alpha is None else alpha, rng)


def decrypt_integers(key: np.ndarray, ct: np.ndarray, params: TfheParams) -> np.ndarray:
    return lwe_decrypt_signed(key, ct, params.msg_space)
