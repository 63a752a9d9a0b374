"""Plain CGGI/TFHE in PyTorch: the programmable bootstrap the benchmark holds
the port's encrypted answers against.

Written from TFHE v1.1's definitions (k = 1, torus32): mod switch to the 2N
rotation grid, blind rotation of n CMUX rounds (X^a rotation, signed gadget
decomposition, external product with the bootstrapping key), sample extract
of coefficient 0, key switch with the multiply-form key (one LWE sample per
coefficient and level, scaled by the digit).  Every sum is exact mod 2^32, so
a sound program gives these words bit for bit.

The external product runs through the twisted negacyclic FFT: a real
polynomial a of degree < N is folded to the M = N/2 complex values
(a_j + i a_{j+M}) zeta^j, zeta = exp(i pi / N), which makes X^N + 1 the cyclic
ring of length M (X^M = i there).  Key polynomials are split into
sign-balanced 16-bit halves, so each product's exact integer lies far inside
float64's 53 bits; ``rounding_bound`` bounds the error a priori, and the
rounding distance actually seen is tracked (``Reference.max_rounding``).
``precision="float32"`` computes the same transforms in complex64: the
benchmark's control, which must come out wrong.

Imports nothing but torch: neither the program under test nor JAX.
"""

from __future__ import annotations

import math

import torch

PRECISIONS = {"float64": (torch.float64, torch.complex128),
              "float32": (torch.float32, torch.complex64)}
_EPS = {"float64": 2.0 ** -53, "float32": 2.0 ** -24}


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int32 keeping the low 32 bits (two's complement)."""
    x = x.to(torch.int64)
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def torus(values: torch.Tensor, msg_space: int) -> torch.Tensor:
    """Message-space integers -> torus32 (TFHE's modSwitchToTorus32 for a
    power-of-two message space: v * 2^32 / msg_space mod 2^32)."""
    if msg_space & (msg_space - 1) or msg_space > 1 << 31:
        raise ValueError(f"message space must be a power of two up to 2^31, got {msg_space}")
    return wrap32(values.to(torch.int64) * ((1 << 32) // msg_space))


def rotate(polys: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """X^t * p mod X^N + 1 for polys [B, ..., N] and exponents t [B] in
    [0, 2N): out[j] = +p[src] if src < N else -p[src - N], src = (j - t) mod 2N."""
    N = polys.shape[-1]
    j = torch.arange(N, device=polys.device)
    src = (j[None, :] - t.to(torch.int64)[:, None]) % (2 * N)
    sign = torch.where(src < N, 1, -1).to(torch.int64)
    shape = (polys.shape[0],) + (1,) * (polys.ndim - 2) + (N,)
    idx = (src % N).reshape(shape).expand(polys.shape)
    return wrap32(torch.gather(polys.to(torch.int64), -1, idx) * sign.reshape(shape))


class Twisted:
    """The twisted negacyclic transform of length N at one precision."""

    def __init__(self, N: int, device, precision: str = "float64"):
        self.N, self.M = N, N // 2
        self.real, self.cplx = PRECISIONS[precision]
        ang = torch.arange(self.M, dtype=torch.float64, device=device) * (math.pi / N)
        tw = torch.polar(torch.ones_like(ang), ang)
        self.twist = tw.to(self.cplx)
        self.untwist = tw.conj().to(self.cplx)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Integer or real [..., N] -> spectrum [..., M]."""
        x = x.to(self.real)
        return torch.fft.fft(torch.complex(x[..., :self.M], x[..., self.M:]) * self.twist)

    def inverse(self, s: torch.Tensor) -> torch.Tensor:
        """Spectrum [..., M] -> the real negacyclic product [..., N], unrounded."""
        z = torch.fft.ifft(s) * self.untwist
        return torch.cat([z.real, z.imag], dim=-1)


def halves(k: torch.Tensor) -> torch.Tensor:
    """int32 [..., N] -> int64 [..., 2, N]: sign-balanced 16-bit halves lo, hi
    with k = lo + 2^16 hi and |lo|, |hi| <= 2^15."""
    k = k.to(torch.int64)
    lo = ((k + (1 << 15)) & 0xFFFF) - (1 << 15)
    return torch.stack([lo, (k - lo) >> 16], dim=-2)


def rounding_bound(N: int, rows: int, half_bg: int, half_norm_sum: float,
                   precision: str = "float64") -> float:
    """A priori bound on the error of one rounded coefficient of an external
    product: a digit row's 2-norm is at most half_bg sqrt(N), and the rows'
    key halves sum to ``half_norm_sum`` in 2-norm.  Percival's bound for a
    cyclic convolution through three FFTs of length 2^k (Math. Comp. 72,
    2003, Theorem 5.1), with one more rounded product for each twist, the
    rows summed in the frequency domain, and twiddles taken as off by 8 units
    in the last place."""
    e = _EPS[precision]
    k = (N // 2).bit_length() - 1
    log_factor = ((3 * k + 3 + rows) * math.log1p(e) + (3 * k + 1) * math.log1p(5 ** 0.5 * e)
                  + (3 * k + 3) * math.log1p(8 * e))
    return half_bg * math.sqrt(N) * half_norm_sum * math.expm1(log_factor)


class Reference:
    """TFHE under one evaluation key (raw ``bk`` int32 [n, rows, 2, N],
    ``ksk`` int32 [N, t, n+1], both as the benchmark made them) on ``device``.

    ``p``: the parameter set as plain numbers (n, N, bg_bit, l, ks_basebit,
    ks_t, msg_space).  ``precision``: "float64" (the reference) or "float32"
    (the control)."""

    def __init__(self, p: dict, bk: torch.Tensor, ksk: torch.Tensor, device,
                 precision: str = "float64", chunk: int = 4096):
        self.p, self.device, self.precision, self.chunk = p, device, precision, chunk
        n, N, l = p["n"], p["N"], p["l"]
        self.n, self.N, self.rows = n, N, 2 * l
        self.fft = Twisted(N, device, precision)
        bk = torch.as_tensor(bk, device=device)
        if tuple(bk.shape) != (n, self.rows, 2, N):
            raise ValueError(f"bk shape {tuple(bk.shape)}, want {(n, self.rows, 2, N)}")
        # spectra of the key's halves: [n, rows, 2 (poly), 2 (half), M]
        spec, norm = [], 0.0
        for i0 in range(0, n, 64):
            h = halves(bk[i0:i0 + 64])
            norm = max(norm, float(h.to(torch.float64).norm(dim=-1).sum(dim=1).amax()))
            spec.append(self.fft.forward(h))
        self.spectra = torch.cat(spec)
        self.bound = rounding_bound(N, self.rows, 1 << (p["bg_bit"] - 1), norm, precision)
        if precision == "float64" and not self.bound < 0.25:
            raise ValueError(f"reference rounding bound {self.bound:.3g} is not below 1/4")
        t, n1 = p["ks_t"], n + 1
        ksk = torch.as_tensor(ksk, device=device)
        if tuple(ksk.shape) != (N, t, n1):
            raise ValueError(f"ksk shape {tuple(ksk.shape)}, want {(N, t, n1)}")
        # every digit x word product and their sum over N t rows stay below
        # 2^53, so the float64 product is the exact integer
        if N * t * ((1 << p["ks_basebit"]) - 1) * (1 << 31) >= 1 << 53:
            raise ValueError("key switch sums exceed float64's exact range")
        self.ksk = ksk.reshape(N * t, n1).to(torch.float64)
        self.max_rounding = torch.zeros((), dtype=torch.float64, device=device)

    # -- one PBS stage at a time ------------------------------------------
    def mod_switch(self, x: torch.Tensor) -> torch.Tensor:
        """torus32 -> the nearest point of the 2N grid, in [0, 2N)."""
        s = 32 - (2 * self.N).bit_length() + 1
        u = (x.to(torch.int64) & 0xFFFFFFFF) + (1 << (s - 1))
        return (u >> s) % (2 * self.N)

    def decompose(self, x: torch.Tensor) -> torch.Tensor:
        """Signed gadget decomposition: [B, 2, N] -> digits [B, 2l, N] in
        [-Bg/2, Bg/2), row = polynomial * l + level."""
        bg_bit, l = self.p["bg_bit"], self.p["l"]
        half = 1 << (bg_bit - 1)
        offset = sum(half << (32 - (j + 1) * bg_bit) for j in range(l)) & 0xFFFFFFFF
        u = ((x.to(torch.int64) & 0xFFFFFFFF) + offset) & 0xFFFFFFFF
        d = torch.stack([((u >> (32 - (j + 1) * bg_bit)) & ((1 << bg_bit) - 1)) - half
                         for j in range(l)], dim=2)  # [B, 2, l, N]
        return d.reshape(x.shape[0], self.rows, self.N)

    def external_product(self, digits: torch.Tensor, i: int) -> torch.Tensor:
        """sum over rows of digits[:, r] * bk[i, r, u], exact mod 2^32 -> [B, 2, N]."""
        D = self.fft.forward(digits)  # [B, rows, M]
        K = self.spectra[i]  # [rows, 2, 2, M]
        acc = D[:, 0, None, None, :] * K[0]
        for r in range(1, self.rows):
            acc = acc + D[:, r, None, None, :] * K[r]
        v = self.fft.inverse(acc)  # [B, 2, 2, N]
        rv = torch.round(v)
        self.max_rounding = torch.maximum(self.max_rounding,
                                          (v - rv).abs().amax().to(torch.float64))
        w = rv.to(torch.int64)
        return wrap32(w[:, :, 0] + (w[:, :, 1] << 16))

    def blind_rotate(self, acc: torch.Tensor, abar: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            diff = wrap32(rotate(acc, abar[:, i]).to(torch.int64) - acc)
            acc = wrap32(acc.to(torch.int64) + self.external_product(self.decompose(diff), i))
        return acc

    def key_switch(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """LWE_N (a [B, N], b [B]) -> LWE_n [B, n+1] through the key-switching key."""
        basebit, t = self.p["ks_basebit"], self.p["ks_t"]
        kbits = basebit * t
        prec = (1 << (31 - kbits)) if kbits < 32 else 0
        u = ((a.to(torch.int64) & 0xFFFFFFFF) + prec) & 0xFFFFFFFF
        dig = torch.stack([(u >> (32 - (j + 1) * basebit)) & ((1 << basebit) - 1)
                           for j in range(t)], dim=-1).reshape(a.shape[0], -1)
        s = (dig.to(torch.float64) @ self.ksk).to(torch.int64)  # exact: see __init__
        out = -s
        out[:, self.n] += b.to(torch.int64)
        return wrap32(out)

    def bootstrap(self, ct: torch.Tensor, testvect: torch.Tensor) -> torch.Tensor:
        """Programmable bootstrap of ct [B, n+1] with one test vector [N]."""
        outs = []
        for c in torch.split(ct, self.chunk):
            abar = self.mod_switch(c[:, :self.n])
            bbar = self.mod_switch(c[:, self.n])
            tv = testvect.to(self.device).reshape(1, self.N).expand(c.shape[0], self.N)
            acc_b = rotate(tv, (2 * self.N - bbar) % (2 * self.N))
            acc = torch.stack([torch.zeros_like(acc_b), acc_b], dim=1)
            acc = self.blind_rotate(acc, abar)
            a = acc[:, 0]
            a_ext = torch.cat([a[:, :1], wrap32(-a[:, 1:].flip(-1).to(torch.int64))], dim=-1)
            outs.append(self.key_switch(a_ext, acc[:, 1, 0]))
        return torch.cat(outs)
