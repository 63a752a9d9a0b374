"""Key/ciphertext file formats.

The reference serializes keys/ciphertexts with TFHE v1.1's stream format
(``secret.key`` / ``eval.key`` / ``image.ctxt`` / ``network_output.ctxt``,
client/gen_secure_keyset.cpp:107-115, client/encrypt_image.cpp:82-85).  These
artifacts carry the same roles and pipeline positions in an npz container
(self-describing, versioned).  The container, its keys and ``FORMAT_VERSION``
are the JAX package's, so the secret-key, evaluation-key and ciphertext files
of either package load in the other.

The JAX package's prepared (NTT-domain) key cache has no counterpart: the
port prepares the key on the card at every load, which takes tens of
milliseconds.
"""

from __future__ import annotations

import os

import numpy as np

from ..crypto.keygen import CloudKey, SecretKey
from ..crypto.params import TfheParams, get_params
from ..device import resolve_device

FORMAT_VERSION = 1


def save_secret_key(path: str, sk: SecretKey) -> None:
    np.savez_compressed(path, version=FORMAT_VERSION, params=sk.params.name,
                        lwe_key=sk.lwe_key, rlwe_key=sk.rlwe_key)


def load_secret_key(path: str) -> SecretKey:
    d = np.load(path, allow_pickle=False)
    return SecretKey(get_params(str(d["params"])), d["lwe_key"], d["rlwe_key"])


def save_cloud_key(path: str, ck: CloudKey) -> None:
    extra = {} if ck.bk_pair is None else {"bk_pair": ck.bk_pair}
    if ck.rerand is not None:
        extra["rerand"] = ck.rerand
    np.savez(path, version=FORMAT_VERSION, params=ck.params.name, bk=ck.bk, ksk=ck.ksk,
             **extra)


def load_cloud_key(path: str) -> CloudKey:
    d = np.load(path, allow_pickle=False)
    pair = d["bk_pair"] if "bk_pair" in d else None
    rerand = d["rerand"] if "rerand" in d else None  # keys saved before the pool: None
    return CloudKey(get_params(str(d["params"])), d["bk"], d["ksk"], pair, rerand=rerand)


def save_ciphertexts(path: str, ct: np.ndarray, params: TfheParams, label=None,
                     out_gain: int = 1, out_center=None) -> None:
    """Ciphertext container (role of image.ctxt / network_output.ctxt).
    ``out_gain``: encoding gain carried by network outputs (runtime/ranges.py);
    the decryptor divides it back out.  ``out_center``: per-class decrypt-
    centering shift (or None); the decryptor subtracts it after decode."""
    np.savez(
        path, version=FORMAT_VERSION, params=params.name, ct=ct.astype(np.int32),
        label=-1 if label is None else int(label), out_gain=int(out_gain),
        out_center=(np.zeros(0, np.int64) if out_center is None
                    else np.asarray(out_center, np.int64)),
    )


def load_ciphertexts(path: str):
    """-> (ct int32, params, label, out_gain, out_center or None)."""
    d = np.load(path, allow_pickle=False)
    gain = int(d["out_gain"]) if "out_gain" in d else 1
    center = d["out_center"] if "out_center" in d else np.zeros(0, np.int64)
    center = None if center.size == 0 else center
    return d["ct"], get_params(str(d["params"])), int(d["label"]), gain, center


def keyset_dir(base: str | None = None) -> str:
    d = base or os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".keys")
    os.makedirs(d, exist_ok=True)
    return d


def ensure_keyset(params_name: str = "small_v2", seed: int = 0, base: str | None = None,
                  device: str = "cuda"):
    """Generate-or-load a cached keyset; returns (SecretKey, DeviceCloudKey).

    Only the raw keys are cached on disk, under the JAX package's file names
    (``secret_<params>_s<seed>.npz``, ``cloud_...``); the NTT-domain key is
    prepared on ``device`` from them at every call."""
    from ..crypto import bootstrap as bs
    from ..crypto import keygen as kg
    from ..crypto.lwe import lwe_encrypt

    resolve_device(device)  # before keygen, which takes seconds
    d = keyset_dir(base)
    tag = f"{params_name}_s{seed}"
    sk_path = os.path.join(d, f"secret_{tag}.npz")
    ck_path = os.path.join(d, f"cloud_{tag}.npz")
    if os.path.exists(sk_path) and os.path.exists(ck_path):
        sk = load_secret_key(sk_path)
        cloud = load_cloud_key(ck_path)
        if cloud.rerand is None:
            # cached before the re-randomization pool existed: the pool is
            # client-side material (it needs the secret key, which the cache
            # holds), drawn deterministically as the JAX package does
            rng = np.random.default_rng(seed ^ 0x5EED)
            cloud.rerand = lwe_encrypt(sk.lwe_key, np.zeros(kg.RERAND_POOL, np.int32),
                                       cloud.params.alpha_enc, rng)
            save_cloud_key(ck_path, cloud)
    else:
        sk, cloud = kg.keygen(get_params(params_name), seed=seed)
        save_secret_key(sk_path, sk)
        save_cloud_key(ck_path, cloud)
    return sk, bs.prepare_cloud_key(cloud, device=device)
