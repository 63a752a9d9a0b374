"""S1's arithmetic on the int8 tensor cores, modelled on the CPU.

``csrc/schoolbook.cu`` computes delta[b, u] = sum_r digits[b, r] * bk[r, u]
in Z[X]/(X^N + 1) mod 2^32 as int8 products: the negacyclic Toeplitz
generator ext = [uint32(-bk) | bk] split into four unsigned bytes e_l, each
digit into signed s8 limbs (one where Bg/2 <= 128; lo in [-128, 127] and
hi in [-2, 2] up to 512), int32 sums of D_dl x T(e_l) for dl + l < 4, one
accumulator a shift s = dl + l, recombined as sum_s acc_s << 8 s mod 2^32.

- ``limb_model`` (torch int64) is exactly that split.  It equals the
  kernel's float64-FFT twin ``schoolbook_product_plain`` and the int64
  schoolbook product at every parameter set's (N, rows, Bg/2), N cut to
  1024 where a set's is larger, and at extreme inputs; every accumulator
  stays inside the bound the kernel's flush relies on, and that bound is
  below 2^31 over all rows of every set (one flush a launch).
- ``emulate_kernel`` (numpy) runs the kernel's data path lane by lane: the
  byte planes of reversed ext, A fragments as funnel shifts of two words,
  their reuse two m-tiles down a step, s8 packing of the digits into
  wgmma's core matrices and the descriptor's reading of them, the register
  layouts of A (each warp's 16 rows, as m16n8k32's) and of the
  accumulators, and the flush into the uint32 total.  It equals the twin for every tile shape the kernel is built for,
  so the index logic is rehearsed here before the card runs it.

Tolerance everywhere: exact equality of int32 arrays.
"""

import numpy as np
import pytest
import torch

from redsec_tpu_torch.crypto import kernels
from redsec_tpu_torch.crypto.ntt import negacyclic_mul_host
from redsec_tpu_torch.crypto.params import PARAM_SETS

torch.set_num_threads(2)

MASK = 0xFFFFFFFF
N_CUT = 1024  # the model's dense Toeplitz matrices are N x N int64


def _int32(x):
    return ((np.asarray(x, np.int64) & MASK).astype(np.uint32)).astype(np.int32)


def ext_bytes(bk: np.ndarray) -> np.ndarray:
    """int32 [rows, 2, N] -> int64 [rows, 2, 4, 2N]: byte l of the uint32
    sequence ext(m), m = -N .. N - 1, at index m + N; the negated half is
    negated in uint32."""
    b = bk.astype(np.int64) & MASK
    ext = np.concatenate([(-b) & MASK, b], axis=-1)
    return np.stack([(ext >> (8 * l)) & 255 for l in range(4)], axis=2)


def digit_limbs(digits: np.ndarray, half_bg: int) -> list:
    """The s8 limbs of digits in [-half_bg, half_bg): [d] or [lo, hi] with
    d = lo + 256 hi, never a negated int8."""
    lo = ((digits.astype(np.int64) + 128) & 255) - 128
    if kernels.schoolbook_digit_limbs(half_bg) == 1:
        assert np.array_equal(lo, digits)
        return [lo]
    hi = (digits - lo) >> 8
    assert lo.min() >= -128 and lo.max() <= 127 and hi.min() >= -2 and hi.max() <= 2
    return [lo, hi]


def limb_model(digits: np.ndarray, bk: np.ndarray, half_bg: int):
    """(delta int32 [B, 2, N], the largest |int32 accumulator| over rows)."""
    B, rows, N = digits.shape
    E = torch.as_tensor(ext_bytes(bk))
    D = [torch.as_tensor(x) for x in digit_limbs(digits, half_bg)]
    jk = (torch.arange(N)[None, :] - torch.arange(N)[:, None]) + N  # T[j, k] = e(k - j)
    total = torch.zeros((B, 2, N), dtype=torch.int64)
    peak = 0
    for u in range(2):
        for s in range(4):
            acc = torch.zeros((B, N), dtype=torch.int64)
            for r in range(rows):
                for dl in range(len(D)):
                    if s - dl >= 0:
                        acc += D[dl][:, r] @ E[r, u, s - dl][jk]
                peak = max(peak, int(acc.abs().max()))
            total[:, u] += acc << (8 * s)
    return _int32(total.numpy()), peak


def _sets():
    return [(p.name, p.N, p.decomp_rows, p.half_bg) for p in PARAM_SETS.values()]


def _int64_schoolbook(digits, bk):
    B, rows, N = digits.shape
    out = np.zeros((B, 2, N), np.int64)
    for b in range(B):
        for u in range(2):
            out[b, u] = sum(negacyclic_mul_host(digits[b, r], bk[r, u], N).astype(np.int64)
                            for r in range(rows))
    return _int32(out)


@pytest.mark.parametrize("name,N,rows,half_bg", _sets())
def test_limb_model_equals_twin_and_int64_schoolbook(name, N, rows, half_bg):
    n = min(N, N_CUT)
    rng = np.random.default_rng(rows * 1000 + half_bg)
    digits = rng.integers(-half_bg, half_bg, size=(3, rows, n)).astype(np.int32)
    digits[0, 0, :3] = [-half_bg, half_bg - 1, -half_bg]
    bk = rng.integers(-2**31, 2**31, size=(rows, 2, n), dtype=np.int64).astype(np.int32)
    bk[0, 0, :4] = [-2**31, -1, 0, 2**31 - 1]
    got, peak = limb_model(digits, bk, half_bg)
    twin = kernels.schoolbook_product_plain(torch.as_tensor(digits), torch.as_tensor(bk),
                                            half_bg).numpy()
    np.testing.assert_array_equal(got, twin)
    if n <= 256 or name == "medium_v2":  # the int64 schoolbook is slow
        np.testing.assert_array_equal(got, _int64_schoolbook(digits, bk))
    assert peak <= kernels.schoolbook_tap_bound(half_bg) * rows * n


@pytest.mark.parametrize("name,N,rows,half_bg", _sets())
def test_partial_sums_stay_inside_int32_at_every_set(name, N, rows, half_bg):
    """The kernel's int32 accumulators sum up to flush_rows x N taps of at
    most ``schoolbook_tap_bound`` each; for every set that covers all of its
    rows, so a launch flushes once, and no sum reaches 2^31."""
    tap = kernels.schoolbook_tap_bound(half_bg)
    assert tap == (128 if half_bg <= 128 else 130) * 255
    F = kernels.schoolbook_flush_rows(N, half_bg)
    assert tap * F * N < 2**31 <= tap * (F + 1) * N
    assert F >= rows
    assert tap * rows * N < 2**31
    if name == "large_v2":  # the tightest set
        assert 128 * 255 * rows * N == 2_139_095_040


@pytest.mark.parametrize("half_bg", [128, 512])
@pytest.mark.parametrize("dval", ["low", "high"])
@pytest.mark.parametrize("kval", [-2**31, -1, 0, 2**31 - 1])
def test_limb_model_at_extreme_inputs(half_bg, dval, kval):
    """Digits all -Bg/2 or all Bg/2 - 1 against keys all -2^31, -1 (every
    key byte 255), 0 or 2^31 - 1, at 8 rows."""
    N, rows = 256, 8
    d = -half_bg if dval == "low" else half_bg - 1
    digits = np.full((2, rows, N), d, np.int32)
    bk = np.full((rows, 2, N), kval, np.int32)
    got, peak = limb_model(digits, bk, half_bg)
    np.testing.assert_array_equal(got, _int64_schoolbook(digits, bk))
    np.testing.assert_array_equal(
        got, kernels.schoolbook_product_plain(torch.as_tensor(digits), torch.as_tensor(bk),
                                              half_bg).numpy())
    bound = kernels.schoolbook_tap_bound(half_bg) * rows * N
    assert peak <= bound
    if (d, kval, half_bg) == (-128, -1, 128):  # the bound is reached
        assert peak == bound


def test_twin_rejects_digits_outside_the_domain():
    digits = torch.zeros((1, 2, 256), dtype=torch.int32)
    bk = torch.zeros((2, 2, 256), dtype=torch.int32)
    digits[0, 1, 7] = 128
    with pytest.raises(ValueError, match="outside"):
        kernels.schoolbook_product_plain(digits, bk, 128)
    digits[0, 1, 7] = -129
    with pytest.raises(ValueError, match="outside"):
        kernels.schoolbook_product(digits, bk, 128)
    with pytest.raises(ValueError, match="Bg/2"):
        kernels.schoolbook_digit_limbs(513)


# --------------------------------------------------------------------------- #
# The kernel's data path, lane by lane                                        #
# --------------------------------------------------------------------------- #

CHUNK, CORE, PLANE_PAD = 256, 128, 8  # schoolbook.cu's kChunk, kCoreBytes, kPlanePad
GROUP = CHUNK // 16 * CORE  # kGroupBytes: 8 ciphertexts x a chunk's taps
LANE = np.arange(32)
G, TQ = LANE >> 2, LANE & 3  # groupID, threadID_in_group


def plane_words(bk_ru: np.ndarray, k0: int, TK: int, N: int) -> np.ndarray:
    """int64 [4, PW]: word w of limb l holds bytes rev[4 w .. 4 w + 3] with
    rev[y] = byte l of ext(k0 + TK - 1 - y), zero below m = -N + 1."""
    PW = (N + TK) // 4 + PLANE_PAD
    m = k0 + TK - 1 - np.arange(4 * PW)
    b = bk_ru.astype(np.int64) & MASK
    x = np.where(m >= 0, b[np.clip(m, 0, N - 1)],
                 np.where(m > -N, (-b[np.clip(m + N, 0, N - 1)]) & MASK, 0))
    by = np.stack([(x >> (8 * l)) & 255 for l in range(4)]).reshape(4, PW, 4)
    return by[..., 0] | by[..., 1] << 8 | by[..., 2] << 16 | by[..., 3] << 24


def fragment_registers(p: np.ndarray, w: np.ndarray, sh: np.ndarray) -> list:
    """schoolbook.cu's build_fragment: four registers a lane, each one
    unaligned 4-byte read (words w', w' + 1 through a funnel shift right by
    sh) at bytes y, y - 8, y + 16, y + 8."""
    def fs(lo, hi):
        return ((p[hi] << 32 | p[lo]) >> sh) & MASK
    return [fs(w, w + 1), fs(w - 2, w - 1), fs(w + 4, w + 5), fs(w + 2, w + 3)]


def a_tile(regs: list) -> np.ndarray:
    """The 16 x 32 u8 A matrix that m16n8k32 reads from these registers:
    register 0 row g, columns 4t .. 4t + 3; 1 row g + 8; 2 columns + 16;
    3 both."""
    A = np.zeros((16, 32), np.int64)
    for reg, (dr, dc) in zip(regs, [(0, 0), (8, 0), (0, 16), (8, 16)]):
        for q in range(4):
            A[G + dr, 4 * TQ + q + dc] = (reg >> (8 * q)) & 255
    return A


def lane_fragment_map(MT: int, k0: int, jb: int, i: int):
    """Which plane word and shift each lane's A fragment reads for m-tile i
    at taps jb: (w [32], sh [32])."""
    TK = 16 * MT
    ybase = TK - 1 - G + 4 * TQ
    return (ybase >> 2) + jb // 4 - 4 * i, 8 * (ybase & 3)


@pytest.mark.parametrize("MT", [2, 4, 8])
@pytest.mark.parametrize("N", [256, 512])
def test_fragment_index_map_equals_dense_toeplitz(MT, N):
    """Every A fragment the lanes build equals the Toeplitz tile
    T[jb + col, k0 + 16 i + row] of each key byte, at every m-tile, tap step
    and block position; and a step's fragment of m-tile i is the previous
    step's of m-tile i - 2 (the kernel's register reuse)."""
    rng = np.random.default_rng(N + MT)
    bk = rng.integers(-2**31, 2**31, size=N, dtype=np.int64).astype(np.int32)
    bk[:2] = [-2**31, -1]
    e = ext_bytes(bk[None, None])[0, 0]  # [4, 2N]
    TK = 16 * MT
    for k0 in sorted({0, TK, N - TK}):
        P = plane_words(bk, k0, TK, N)
        prev = None
        for jb in range(0, N, 32):
            tiles = []
            for i in range(MT):
                w, sh = lane_fragment_map(MT, k0, jb, i)
                for l in range(4):
                    A = a_tile(fragment_registers(P[l], w, sh))
                    k = k0 + 16 * i + np.arange(16)[:, None]
                    j = jb + np.arange(32)[None, :]
                    np.testing.assert_array_equal(A, e[l][k - j + N])
                    if l == 0:
                        tiles.append(A)
            if prev is not None:
                for i in range(2, MT):
                    np.testing.assert_array_equal(tiles[i], prev[i - 2])
            prev = tiles


def _pack(chunk: np.ndarray):
    """The kernel's packing pass: int32 [TB, 256] -> two byte arrays (the
    low and high s8 limbs: lo = d mod 2^8; hi = (d - int8(d)) >> 8), each in
    wgmma's core-matrix layout: ciphertext b, tap k at (b / 8) * GROUP +
    (k / 16) * CORE + (b % 8) * 16 + k % 16."""
    c = chunk.astype(np.int64)
    limbs = (c & 255, ((c - ((c + 128) % 256 - 128)) >> 8) & 255)
    b, k = np.meshgrid(np.arange(c.shape[0]), np.arange(CHUNK), indexing="ij")
    off = (b // 8) * GROUP + (k // 16) * CORE + (b % 8) * 16 + k % 16
    out = []
    for limb in limbs:
        buf = np.zeros(c.shape[0] * CHUNK, np.int64)
        buf[off] = limb
        out.append(buf)
    return out


def _b_tile(buf: np.ndarray, start: int, TB: int) -> np.ndarray:
    """The 32 x TB s8 B matrix one wgmma reads through the kernel's
    descriptor (start byte ``start``, LBO = CORE along K, SBO = GROUP along
    the batch; the layout ``csrc/wgmma_check.cu`` confirms on the card)."""
    k, n = np.meshgrid(np.arange(32), np.arange(TB), indexing="ij")
    v = buf[start + (n // 8) * GROUP + (k // 16) * CORE + (n % 8) * 16 + k % 16]
    return np.where(v >= 128, v - 256, v)


def _wgmma(acc: np.ndarray, A: np.ndarray, Bm: np.ndarray) -> np.ndarray:
    """This warp's 16 rows of wgmma m64nTBk32: acc int64 [TB / 2, 32], lane
    l's register 4 j + e at row g + 8 (e / 2), column 8 j + 2 t + e % 2;
    returns acc + A B, asserting no int32 wrap."""
    TB = Bm.shape[1]
    rows_ = np.array([G + 8 * ((e & 3) >> 1) for e in range(TB // 2)])
    cols_ = np.array([8 * (e >> 2) + 2 * TQ + (e & 1) for e in range(TB // 2)])
    D = acc + (A @ Bm)[rows_, cols_]
    assert np.abs(D).max() < 2**31
    return D


def emulate_kernel(digits, bk, half_bg, NT, MT, flush_rows):
    """schoolbook_mma_kernel<NT, MT, limbs> on numpy, block by block and
    warp by warp, in the kernel's order of work."""
    B, rows, N = digits.shape
    limbs = kernels.schoolbook_digit_limbs(half_bg)
    TB, TK = 8 * NT, 16 * MT
    out = np.zeros((B, 2, N), np.int64)
    zero = np.zeros((16, 32), np.int64)
    for bt in range(-(-B // TB)):
        b0 = bt * TB
        dpad = np.zeros((TB, rows, N), np.int64)
        dpad[:min(TB, B - b0)] = digits[b0:b0 + TB]
        packed = [[_pack(dpad[:, r, c * CHUNK:(c + 1) * CHUNK]) for c in range(N // CHUNK)]
                  for r in range(rows)]
        for kt in range(N // TK):
            k0 = kt * TK
            planes = [[plane_words(bk[r, u], k0, TK, N) for u in range(2)] for r in range(rows)]
            tot = np.zeros((2, TB, TK), np.int64)
            for warp in range(8):
                u, s = warp >> 2, warp & 3
                ybase = TK - 1 - G + 4 * TQ
                wb, sh = ybase >> 2, 8 * (ybase & 3)
                acc = np.zeros((MT, TB // 2, 32), np.int64)
                fa, fb = [None] * MT, [None] * MT
                for r in range(rows):
                    pa, pb = planes[r][u][s], planes[r][u][max(s - 1, 0)]
                    for c in range(N // CHUNK):
                        lo, hi = packed[r][c]
                        if c == 0:
                            for i in range(MT):
                                fa[i] = a_tile(fragment_registers(pa, wb - 4 * i, sh))
                                fb[i] = (a_tile(fragment_registers(pb, wb - 4 * i, sh))
                                         if s > 0 else zero)
                        for st in range(CHUNK // 32):
                            bl = _b_tile(lo, st * 2 * CORE, TB)
                            bh = _b_tile(hi, st * 2 * CORE, TB)
                            for i in range(MT):
                                acc[i] = _wgmma(acc[i], fa[i], bl)
                                if limbs == 2:  # warp 0's high-limb fragment is zero
                                    acc[i] = _wgmma(acc[i], fb[i], bh)
                            # past the row's end the new fragments read the
                            # plane's pad (inside it: numpy would raise) and
                            # are not used
                            wn = wb + (c * CHUNK + 32 * st + 32) // 4
                            fa = [a_tile(fragment_registers(pa, wn, sh)),
                                  a_tile(fragment_registers(pa, wn - 4, sh))] + fa[:MT - 2]
                            if s > 0:
                                fb = [a_tile(fragment_registers(pb, wn, sh)),
                                      a_tile(fragment_registers(pb, wn - 4, sh))] + fb[:MT - 2]
                    if (r + 1) % flush_rows == 0 or r + 1 == rows:
                        for i in range(MT):
                            for e in range(TB // 2):
                                kk = 16 * i + G + 8 * ((e & 3) >> 1)
                                bb = 8 * (e >> 2) + 2 * TQ + (e & 1)
                                tot[u, bb, kk] = (tot[u, bb, kk] + (
                                    (acc[i, e] & MASK) << (8 * s))) & MASK
                        acc[:] = 0
            nb = min(TB, B - b0)
            out[b0:b0 + nb, :, k0:k0 + TK] = tot[:, :nb].transpose(1, 0, 2)
    return _int32(out)


# every (NT, MT, limbs) instance the kernel is built for: two limbs take NT <= 2
INSTANCES = [(nt, batch, mt, half_bg) for half_bg in (128, 512)
             for nt, batch in ((1, 5), (2, 9), (4, 20)) if half_bg <= 128 or nt <= 2
             for mt in (2, 4, 8)]


@pytest.mark.parametrize("NT,batch,MT,half_bg", INSTANCES)
def test_kernel_emulation_equals_twin(NT, batch, MT, half_bg):
    """Ragged batches, 2 digit rows, at N = 512 (two chunks a row: the A
    fragments carry across the chunk) where a warp keeps 4 or 8 m-tiles, at
    N = 256 with 2 (every fragment is read anew each step); two limbs flush
    every row, one limb once."""
    N, rows = (256 if MT == 2 else 512), 2
    rng = np.random.default_rng(NT * 100 + MT + half_bg)
    digits = rng.integers(-half_bg, half_bg, size=(batch, rows, N)).astype(np.int32)
    digits[0, 0, :2] = [-half_bg, half_bg - 1]
    bk = rng.integers(-2**31, 2**31, size=(rows, 2, N), dtype=np.int64).astype(np.int32)
    bk[0, 1, :3] = [-2**31, -1, 2**31 - 1]
    flush = 1 if half_bg > 128 else kernels.schoolbook_flush_rows(N, half_bg)
    got = emulate_kernel(digits, bk, half_bg, NT, MT, flush)
    want = kernels.schoolbook_product_plain(torch.as_tensor(digits), torch.as_tensor(bk),
                                            half_bg).numpy()
    np.testing.assert_array_equal(got, want)
