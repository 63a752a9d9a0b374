"""The client's side, made from the run's seed on the device: keys and the
encrypted image pool.

The distributions are those of TFHE v1.1 with k = 1, as the port's keygen
draws them: binary LWE and RLWE keys; a bootstrapping key of TGSW samples
(uniform masks, Gaussian noise of standard deviation ``alpha_bk`` on the
torus, plus s_i times the gadget 2^(32 - (j+1) bg_bit)); a multiply-form
key-switching key (uniform masks, noise ``alpha_ks``, message
K_i 2^(32 - (j+1) ks_basebit)); fresh encryptions at ``alpha_enc``.  A
server never makes the evaluation key, it receives it: making it here from
the seed stands for that, and keeps the set-up to seconds.

Every draw comes from one ``torch.Generator`` on ``device``, in a fixed
order and in large calls, so one seed gives the same keys and ciphertexts on
one device.  The keys go back to the host as int32 numpy arrays: the form in
which a loaded key reaches the program.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.tfhe import Twisted, halves, torus, wrap32

_CHUNK = 1 << 24  # elements a draw: bounds the int64 and float64 transients


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def uniform32(g: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform torus32 words."""
    out = torch.empty(shape, dtype=torch.int32, device=device)
    flat = out.view(-1)
    for i0 in range(0, flat.numel(), _CHUNK):
        m = min(_CHUNK, flat.numel() - i0)
        flat[i0:i0 + m] = torch.randint(-(1 << 31), 1 << 31, (m,), generator=g,
                                        dtype=torch.int64, device=device).to(torch.int32)
    return out


def gaussian32(g: torch.Generator, alpha: float, shape, device) -> torch.Tensor:
    """Gaussian torus noise of standard deviation alpha, rounded to torus32."""
    out = torch.empty(shape, dtype=torch.int32, device=device)
    flat = out.view(-1)
    for i0 in range(0, flat.numel(), _CHUNK):
        m = min(_CHUNK, flat.numel() - i0)
        e = torch.randn((m,), generator=g, dtype=torch.float64, device=device)
        flat[i0:i0 + m] = wrap32(torch.round(e * (alpha * 2.0 ** 32)).to(torch.int64))
    return out


def binary_key(g: torch.Generator, size: int, device) -> torch.Tensor:
    return torch.randint(0, 2, (size,), generator=g, dtype=torch.int64, device=device)


def negacyclic_binary(a: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """a(X) * K(X) mod (X^N + 1, 2^32) for a int32 [P, N] and a binary key
    [N], exact: each 16-bit half's product is an integer below 2^15 N."""
    N = a.shape[-1]
    fft = Twisted(N, a.device)
    ks = fft.forward(key)
    out = torch.empty_like(a)
    for i0 in range(0, a.shape[0], 4096):
        v = torch.round(fft.inverse(fft.forward(halves(a[i0:i0 + 4096])) * ks)).to(torch.int64)
        out[i0:i0 + 4096] = wrap32(v[:, 0] + (v[:, 1] << 16))
    return out


def lwe_body(a: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """<a, s> mod 2^32 over the last axis of a int32 [..., n]."""
    flat = a.reshape(-1, a.shape[-1])
    out = torch.empty(flat.shape[0], dtype=torch.int32, device=a.device)
    step = max(1, _CHUNK // a.shape[-1])
    for i0 in range(0, flat.shape[0], step):
        out[i0:i0 + step] = wrap32((flat[i0:i0 + step].to(torch.int64) * key).sum(-1))
    return out.reshape(a.shape[:-1])


def keygen(p: dict, g: torch.Generator, device) -> dict:
    """Secret keys and the evaluation key of parameter set ``p`` (plain
    numbers): {"lwe_key" [n], "rlwe_key" [N], "bk" [n, 2l, 2, N],
    "ksk" [N, t, n+1]}, each an int32 numpy array."""
    n, N, l, bg_bit = p["n"], p["N"], p["l"], p["bg_bit"]
    t, basebit = p["ks_t"], p["ks_basebit"]
    rows = 2 * l
    s = binary_key(g, n, device)
    K = binary_key(g, N, device)
    a = uniform32(g, (n, rows, N), device)
    b = negacyclic_binary(a.view(-1, N), K).view(n, rows, N)
    b = wrap32(b.to(torch.int64) + gaussian32(g, p["alpha_bk"], (n, rows, N), device))
    bk = torch.stack([a, b], dim=2)  # [n, rows, 2, N]
    del a, b
    for bloc in range(2):
        for j in range(l):
            h = 1 << (32 - (j + 1) * bg_bit)
            r = bloc * l + j
            bk[:, r, bloc, 0] = wrap32(bk[:, r, bloc, 0].to(torch.int64) + s * h)
    shifts = torch.tensor([32 - (j + 1) * basebit for j in range(t)], device=device)
    msg = wrap32(K[:, None] << shifts[None, :])  # [N, t]
    ka = uniform32(g, (N, t, n), device)
    kb = wrap32(lwe_body(ka, s).to(torch.int64) + msg
                + gaussian32(g, p["alpha_ks"], (N, t), device))
    ksk = torch.cat([ka, kb[..., None]], dim=-1)
    del ka, kb
    return {"lwe_key": s.to(torch.int32).cpu().numpy(),
            "rlwe_key": K.to(torch.int32).cpu().numpy(),
            "bk": bk.cpu().numpy(), "ksk": ksk.cpu().numpy()}


def encrypt(values: np.ndarray, lwe_key: np.ndarray, p: dict, g: torch.Generator,
            device) -> np.ndarray:
    """Message-space integers [...] -> LWE ciphertexts int32 [..., n+1]:
    uniform mask, body <a, s> + torus(v) + noise at ``alpha_enc``."""
    v = torch.as_tensor(np.asarray(values, np.int64), device=device)
    s = torch.as_tensor(lwe_key, dtype=torch.int64, device=device)
    a = uniform32(g, tuple(v.shape) + (p["n"],), device)
    e = gaussian32(g, p["alpha_enc"], tuple(v.shape), device)
    b = wrap32(lwe_body(a, s).to(torch.int64) + torus(v, p["msg_space"]).to(torch.int64) + e)
    return torch.cat([a, b[..., None]], dim=-1).cpu().numpy()


def decrypt(ct: np.ndarray, lwe_key: np.ndarray, msg_space: int) -> np.ndarray:
    """LWE ciphertexts [..., n+1] -> the nearest message-space integers,
    signed (the client's decryption)."""
    ct = np.asarray(ct, np.int64)
    phase = (ct[..., -1] - (ct[..., :-1] * np.asarray(lwe_key, np.int64)).sum(-1)) % (1 << 32)
    step = (1 << 32) // msg_space
    v = ((phase + step // 2) // step) % msg_space
    return np.where(v >= msg_space // 2, v - msg_space, v)
