"""The encrypted forward of a REDsec sign network, in plain PyTorch.

The network is described by a configuration's ``net`` list, in layer order:
``{"sumpool": w, "activation": "sign"}`` (a w x w window sum, stride w) or
``{"fc": out, "activation": "sign" | "none"}`` (a ternary fully connected
layer over the flattened (h, w, c) activations), each followed by its
per-channel integer bias.  The weights file is REDsec's ``var_prep.dat``
(lib/BinOps.cpp:28-36, 289-314): per layer the ternary weights of an fc
layer, then its int32 biases, each section a tag byte and its payload.

Encoding, as the port's published rule states it: activations are +-g on the
message space, where g is the largest power of two that keeps the next
layer's worst-case |pre-activation| (+-1 inputs: sum |w| + |bias|) within a
quarter of the message space; the network's input pixels are encrypted at
gain 1, and a layer's bias is added to the body scaled by its input's gain.
A leveled sum is exact mod 2^32: the float64 products below hold integers
under 2^53.

Imports nothing but numpy, torch and the reference's own TFHE.
"""

from __future__ import annotations

import numpy as np
import torch

from .tfhe import Reference, torus, wrap32

TERN, BIN, UINT32, INT32 = 2, 1, 3, 4


class WeightsReader:
    """Sequential reader of a ``var_prep.dat`` byte string."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def _take(self, nbytes: int) -> bytes:
        if self.pos + nbytes > len(self.data):
            raise ValueError("weights file ends early")
        out = self.data[self.pos:self.pos + nbytes]
        self.pos += nbytes
        return out

    def ternary(self, count: int) -> np.ndarray:
        """A ternary (2 bits: sign, is-zero) or binary (1 bit: sign) section."""
        tag = self._take(1)[0]
        if tag not in (TERN, BIN):
            raise ValueError(f"section tag {tag}, want a weight section")
        bits_each = 2 if tag == TERN else 1
        bits = np.unpackbits(np.frombuffer(self._take((count * bits_each + 7) // 8), np.uint8))
        bits = bits[:count * bits_each].reshape(count, bits_each)
        w = np.where(bits[:, 0] == 1, 1, -1).astype(np.int64)
        return np.where(bits[:, 1] == 1, 0, w) if tag == TERN else w

    def int32(self, count: int) -> np.ndarray:
        tag = self._take(1)[0]
        if tag not in (INT32, UINT32):
            raise ValueError(f"section tag {tag}, want an integer section")
        return np.frombuffer(self._take(4 * count), "<i4").astype(np.int64)

    def done(self) -> bool:
        return self.pos == len(self.data)


def read_net(path: str, net: list, in_shape: list) -> list:
    """[(ternary weights [in, out] or None, bias [depth])] of each layer."""
    with open(path, "rb") as f:
        reader = WeightsReader(f.read())
    h, w, c = in_shape
    layers = []
    for layer in net:
        if "sumpool" in layer:
            k = layer["sumpool"]
            h, w = h // k, w // k
            layers.append((None, reader.int32(c)))
        else:
            fan_in, out = h * w * c, layer["fc"]
            wt = reader.ternary(fan_in * out).reshape(fan_in, out)
            h, w, c = 1, 1, out
            layers.append((wt, reader.int32(out)))
    if not reader.done():
        raise ValueError(f"{path}: bytes left after the last layer")
    return layers


def gains(net: list, layers: list, msg_space: int) -> list:
    """Output gain of each layer: a sign layer's +-g, as the module says; a
    layer without activation passes its input's gain on."""
    out, g_in = [], 1
    for i, spec in enumerate(net):
        if spec["activation"] == "sign":
            nxt_w, nxt_b = layers[i + 1]
            if nxt_w is None:
                raise ValueError("a sign layer must feed a fully connected layer")
            bound = int((np.abs(nxt_w).sum(axis=0) + np.abs(nxt_b)).max())
            g = 1
            while bound * g * 2 <= msg_space // 4:
                g *= 2
            out.append(g)
        else:
            out.append(g_in)
        g_in = out[-1]
    return out


def _leveled_fc(x: torch.Tensor, wt: np.ndarray) -> torch.Tensor:
    """[B, K, R] ciphertexts x ternary [K, O] -> [B, O, R], exact mod 2^32
    (|sum| < K 2^31 < 2^53)."""
    if x.shape[1] * (1 << 31) >= 1 << 53:
        raise ValueError("fan-in too wide for an exact float64 sum")
    w = torch.as_tensor(wt, dtype=torch.float64, device=x.device)
    y = torch.matmul(x.to(torch.float64).transpose(1, 2), w)  # [B, R, O]
    return wrap32(y.to(torch.int64)).transpose(1, 2).contiguous()


def _add_body(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x[..., -1] = wrap32(x[..., -1].to(torch.int64) + mu.to(x.device))
    return x


def forward(ref: Reference, net: list, layers: list, msg_space: int,
            ct: torch.Tensor) -> torch.Tensor:
    """Encrypted images ct int32 [B, H, W, C, n+1] -> class scores [B, classes, n+1]."""
    g = gains(net, layers, msg_space)
    B, R = ct.shape[0], ct.shape[-1]
    x, g_in = ct.to(ref.device), 1
    for i, (spec, (wt, bias)) in enumerate(zip(net, layers)):
        if "sumpool" in spec:
            k = spec["sumpool"]
            _, H, W, C, _ = x.shape
            x = x[:, :H // k * k, :W // k * k].reshape(B, H // k, k, W // k, k, C, R)
            x = wrap32(x.to(torch.int64).sum(dim=(2, 4)))  # [B, H/k, W/k, C, R]
        else:
            x = _leveled_fc(x.reshape(B, -1, R), wt)  # [B, out, R]
        bias_t = torch.as_tensor(bias, dtype=torch.int64, device=x.device) * g_in
        x = _add_body(x, torus(bias_t, msg_space))
        if spec["activation"] == "sign":
            tv = torus(torch.full((ref.N,), g[i], dtype=torch.int64), msg_space)
            x = ref.bootstrap(x.reshape(-1, R), tv).reshape(x.shape)
        g_in = g[i]
    return x.reshape(B, -1, R)
