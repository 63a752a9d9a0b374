"""The yardstick's work counts and the card's peaks: the least time one H100
needs for an image's work, from shapes alone.

A frozen copy of the counts in ``chip_smoke.py`` (``ntt_ops`` through
``fp64_ms``): a blind rotation is counted in the formulation its
configuration fixes, so a program that replaces a kernel does not move the
yardstick.  ``"ntt"``: each CMUX round as an exact CRT-NTT external product
(int32 operations: forward and inverse transforms per prime, the row MAC,
CRT and limb recombination, rotate, decompose and add), at the int32 rate.
``"twisted_fft"``: each round as exact float64 twisted transforms of length
N/2 (Johnson and Frigo's least flop count) and their multiply-accumulate, at
the float64 rates.  The key switch and the leveled layers count as int32
multiply-adds at the int32 rate.
"""

from __future__ import annotations

# H100 SXM (NVIDIA data sheet, dense, 700 W).  The int32 rate is derived,
# not read from the sheet: 132 SMs x 64 int32 lanes x 1.98 GHz, a quarter of
# the 67 TFLOP/s fp32 figure (128 lanes, a fused multiply-add as 2 flops).
# Bytes bound nothing here: at every batch these cells launch a round's
# operations take longer at these rates than its bytes at 3.35 TB/s.
PEAK_INT32_OPS = 67e12 / 4
PEAK_FP64_FLOPS = 132 * 64 * 2 * 1.98e9  # outside the tensor cores (sheet: 34 TFLOP/s)
PEAK_FP64_TENSOR_FLOPS = 67e12  # DMMA


def ntt_ops(N: int) -> int:
    """One length-N negacyclic transform: N twist multiplies and N/2*log2 N
    butterflies of one multiply, one add and one subtract."""
    return N + 3 * (N // 2) * (N.bit_length() - 1)


def ext_product_ops(rows: int, N: int, primes: int = 2) -> int:
    """One ciphertext's external product over ``rows`` digit rows: per prime,
    ``rows`` forward and 8 inverse transforms and the row MAC (a multiply and
    an add a product), then the CRT (about 6 operations a value a prime
    beyond the first) and the limb recombination (2)."""
    per_prime = (rows + 8) * ntt_ops(N) + 2 * rows * 8 * N
    return primes * per_prime + 8 * N * (6 * (primes - 1) + 2)


def cmux_ops(rows: int, N: int, primes: int = 2) -> int:
    """One CMUX round: rotate-difference (2N), decompose (3 a digit), the
    external product, accumulate (2N)."""
    return 2 * N + 3 * rows * N + ext_product_ops(rows, N, primes) + 2 * N


def fft_flops(M: int) -> int:
    """Real flops of one complex DFT of length M = 2^k at the least count
    published (Johnson and Frigo, IEEE Trans. Signal Process. 55, 2007)."""
    k = M.bit_length() - 1
    s = (-1) ** k
    return round((102 * M * k - 124 * M - 54 * k - 6 * s * k + 16 * s + 216) / 27)


def schoolbook_round_flops(B: int, rows: int, N: int) -> tuple[int, int]:
    """One round through twisted transforms of length M = N/2, as (transform
    flops, multiply-accumulate flops): rows forward and 4 inverse transforms a
    ciphertext with their twists (6 flops a value), and every digit spectrum
    into 4 spectra (8 flops a complex multiply-add)."""
    M = N // 2
    return B * (rows + 4) * (fft_flops(M) + 6 * M), B * 8 * 4 * rows * M


def fp64_ms(flops: tuple[int, int]) -> float:
    """Least ms of (transform flops, MAC flops): transforms at the vector
    rate, the MAC at the faster of the vector and DMMA rates."""
    rate = max(PEAK_FP64_FLOPS, PEAK_FP64_TENSOR_FLOPS)
    return (flops[0] / PEAK_FP64_FLOPS + flops[1] / rate) * 1e3


def round_ms(cfg: dict, batch: int = 1) -> float:
    """Least ms of one blind-rotation round for ``batch`` ciphertexts."""
    p, how = cfg["params"], cfg["blind_rotation"]
    rows = 2 * p["l"]
    if how["formulation"] == "ntt":
        return batch * cmux_ops(rows, p["N"], how["primes"]) / PEAK_INT32_OPS * 1e3
    if how["formulation"] == "twisted_fft":
        return fp64_ms(schoolbook_round_flops(batch, rows, p["N"]))
    raise ValueError(f"unknown blind-rotation formulation {how['formulation']!r}")


def net_shapes(cfg: dict) -> list:
    """(kind, fan-in, outputs, activation) of each layer of the configuration's net."""
    h, w, c = cfg["input"]
    out = []
    for layer in cfg["net"]:
        if "sumpool" in layer:
            k = layer["sumpool"]
            fan_in, h, w = k * k, h // k, w // k
            out.append(("sumpool", fan_in, h * w * c, layer["activation"]))
        else:
            fan_in, c = h * w * c, layer["fc"]
            h = w = 1
            out.append(("fc", fan_in, c, layer["activation"]))
    return out


def pbs_per_image(cfg: dict) -> int:
    return sum(outs for _, _, outs, act in net_shapes(cfg) if act == "sign")


def least_ms_per_image(cfg: dict) -> dict:
    """{"blind_rotation", "key_switch", "leveled", "total"}: least ms an image."""
    p = cfg["params"]
    pbs = pbs_per_image(cfg)
    br = pbs * p["n"] * round_ms(cfg)
    ks = pbs * p["N"] * p["ks_t"] * (p["n"] + 1) / PEAK_INT32_OPS * 1e3
    lev = sum(f * o * (p["n"] + 1) for _, f, o, _ in net_shapes(cfg)) / PEAK_INT32_OPS * 1e3
    return {"blind_rotation": br, "key_switch": ks, "leveled": lev, "total": br + ks + lev}
