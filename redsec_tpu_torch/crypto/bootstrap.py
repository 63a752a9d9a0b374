"""Batched programmable (gate) bootstrapping on the device.

Every activation gets one PBS:

    mod-switch -> blind rotation (n CMUX rounds of TGSW external products in
    the CRT-NTT domain) -> sample extract -> key switch

The blind rotation is the whole cost.  On CUDA it runs as ONE launch of the
``blind_rotate`` kernel (csrc/pbs.cu, bound in crypto/kernels.py), which keeps
each ciphertext's accumulator on chip for all n rounds; on the CPU the same
wrapper runs its plain PyTorch twin.  Mod-switch, sample extract and the key
switch stay plain torch (XLA ops outside any Pallas kernel in the JAX
package).

The parameter sets without NTT primes (N >= 4096: ``medium``, ``large``,
``medium_v2``, ``large_v2``), and any set prepared with ``schoolbook=True``,
run the JAX package's schoolbook branch instead: n CMUX rounds in one call
of ``kernels.schoolbook_rounds``, each round one launch of the round kernel
from a loop in C (csrc/schoolbook_fft.cu: rotate, difference, decompose,
exact float64 transforms against the key's prepared spectra, the add) or,
on a CPU tensor, one call of ``kernels.schoolbook_round``'s plain twin, the
same transforms in torch.  Its output is the exact product, as the JAX package's
``bootstrap_host`` has it, and equals the loop of the JAX package's own
formulation (rotate, difference and decompose around S1,
``kernels.schoolbook_product`` on the raw BK), which the tests keep as a
reference; the JAX
package's int8 convolution wraps the negated digit -(-128) at Bg/2 = 128
(``medium_v2``, ``large_v2``), where the two differ.

All arithmetic is exact, so the output is bit-identical to the JAX package's
``make_batched_bootstrap`` for the same key and ciphertexts, whatever the
NTT-domain order.  The port prepares its BK in the radix-2 bit-reversed order
of ``ntt.ntt_device`` (flavour ``"radix2"``, the main path) unless the caller
asks for the four-step order of ``ntt_matmul`` (flavour ``"matmul"``, the JAX
package's ``REDSEC_NTT=matmul``, the layout its Pallas round and
blind-rotation kernels and ``parallel/ntt_shard.py`` take).  A "matmul" key
runs the four-step blind-rotation kernel (``kernels.blind_rotate_mm``,
csrc/blind_mm.cu: one launch, its 128-point stages on the int8 tensor cores)
where ``kernels.supported_mm`` takes its shape: exactly where the JAX package
runs its Pallas kernel (two primes below 2^15, N = 256 or 1024,
unbundled).  The other "matmul" keys (bundled ones, N = 2048, three
primes), where the JAX package runs its XLA loop, run that loop in torch
(``kernels.blind_rotate_mm_plain``: n rounds of rotate, decompose, four-step
transforms per prime, the exact MAC, inverse, CRT).

The JAX package's per-round Pallas kernels (its ``REDSEC_ROUND_KERNEL=1`` and
``=partial``) are the argument ``round_kernel`` here: ``"full"`` runs the
blind rotation as n launches of the one-round CMUX kernel
(``kernels.cmux_round_mm``), ``"partial"`` as n rounds of rotate and decompose
in torch, the external-product kernel (``kernels.external_product_mm``) and
the add.  Both take a "matmul" key inside ``kernels.supported_mm`` (the JAX
package's envelope for them on the sets the kernels are built for) and raise
for any other key; the output is the same.

A numpy oracle of the whole pipeline (``bootstrap_host``) is kept for tests.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..device import int32_matmul, resolve_device
from . import kernels
from . import ntt as ntt_mod
from . import ntt_matmul
from .keygen import CloudKey, _crt_host
from .params import TfheParams
from .torus import mod_switch_to_torus32

BK_LIMB_BITS = 8  # 4 x 8-bit limbs: keeps the row-accumulated external
# product provably inside the 2-prime CRT range (see ntt.primes_for)
BK_LIMBS = 32 // BK_LIMB_BITS


@dataclasses.dataclass(frozen=True)
class DeviceCloudKey:
    """Device-resident evaluation key.

    With an NTT ``plan`` (flavour ``"radix2"``):
    ``bk``: int16 [P, n, rows, 2*limbs, N], the BK's sign-balanced 8-bit limbs
    forward-NTT'd per CRT prime, in the streaming layout the blind-rotation
    kernel reads one round slice at a time.  Residues are below 2^16 and kept
    as 16-bit patterns (40961 does not fit a signed int16): every reader
    zero-extends them (``kernels.residues``).  With ``bundle`` 2 the key
    carries interleaved pair entries for the 2-bit bundled blind rotation:
    [P, n/2, 3*rows, 2*limbs, N], per pair the rows of TGSW(s_2i),
    TGSW(s_2i+1) and TGSW(s_2i * s_2i+1).  Without one (``plan`` None,
    flavour ``"schoolbook"``): ``bk`` int32 [n, rows, 2, N], the raw
    coefficient-domain BK (exact as it is; the JAX package keeps reversed-tap
    int8 limbs of it for its int8 convolution), and ``spectra`` complex128
    [n, rows, 2, 2, N/2], its 16-bit halves' twisted spectra, which the
    schoolbook round kernel reads a round at a time.  Flavour ``"matmul"``: the same residues in the
    four-step [k1, k2] order of ``ntt_matmul``, held as int16
    [P, n', R, 2*limbs, R4, C4] (N = R4 * C4): a shape the radix-2 kernels
    refuse and the four-step ones (``kernels.*_mm``) take.  ``ksk``: int32
    [N*t, n+1] multiply-form key-switching key."""

    params: TfheParams
    plan: Optional[ntt_mod.NttPlan]
    bk: torch.Tensor
    ksk: torch.Tensor
    rerand: Optional[torch.Tensor] = None
    bundle: int = 1
    # NTT-domain order the BK was transformed with ("schoolbook": not
    # transformed); the kernels and their twins check it (a key in another
    # order is garbage to them)
    ntt_flavor: str = "radix2"
    # flavour "schoolbook" only: complex128 [n, rows, 2, 2, N/2], each raw
    # BK row's sign-balanced 16-bit halves [u][half] as the spectra of their
    # twisted folds (kernels.key_spectra), the operand of every schoolbook
    # round (kernel and twin); the raw ``bk`` stays for S1
    spectra: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.bk.device


def bootstrap_plan(p: TfheParams, bundled: bool = False,
                   schoolbook: bool = False) -> ntt_mod.NttPlan | None:
    """NTT plan for the parameter set, or None when no int32-range NTT primes
    exist for N (>= 4096) or ``schoolbook`` asks for none (the JAX package's
    ``REDSEC_FORCE_SCHOOLBOOK``): those run the schoolbook external product.
    The CRT range must cover the digit x limb products accumulated in the NTT
    domain with sign-balanced limbs: ``rows`` of them for a plain round,
    ``3*rows`` for a bundled one (which is why bundled ``small_v2_tpu2`` takes
    a third prime)."""
    if schoolbook:
        return None
    try:
        return ntt_mod.make_plan(
            p.N, max_operand=p.half_bg, limb_bits=BK_LIMB_BITS,
            accum=(3 if bundled else 1) * p.decomp_rows, balanced=True,
        )
    except ValueError:
        return None


def int8_limbs(x: torch.Tensor) -> list[torch.Tensor]:
    """int32 [...] -> 4 sign-balanced limbs (int32 tensors in [-128, 127]).

    Recombination sum(l_i * 256^i) is exact mod 2^32 (the top limb is
    mod-256-balanced, which suffices: its excess is a multiple of 2^32)."""
    limbs, cur = [], x
    for _ in range(4):
        lo = ((cur + 128) & 255) - 128
        limbs.append(lo)
        cur = (cur - lo) >> 8
    return limbs


def _upload(a: np.ndarray, dev: torch.device, chunk: int) -> torch.Tensor:
    """int32 copy of the host array ``a`` on ``dev``, ``chunk`` leading rows
    at a time (a key of gigabytes never has a second whole copy on the host)."""
    out = torch.empty(a.shape, dtype=torch.int32, device=dev)
    for i0 in range(0, a.shape[0], chunk):
        out[i0:i0 + chunk] = torch.from_numpy(np.ascontiguousarray(a[i0:i0 + chunk], np.int32))
    return out


def _rerand(cloud: CloudKey, dev: torch.device) -> Optional[torch.Tensor]:
    return None if cloud.rerand is None else torch.as_tensor(
        cloud.rerand.astype(np.int32), device=dev)


NTT_FLAVORS = ("radix2", "matmul")


def prepare_cloud_key(cloud: CloudKey, device: str = "cuda", chunk: int = 64,
                      schoolbook: bool = False, ntt_flavor: str = "radix2") -> DeviceCloudKey:
    """Upload the raw CloudKey and transform the BK into the CRT-NTT domain
    on the device (through the ``ntt`` kernel on CUDA), ``chunk`` key bits at
    a time to bound the working set.

    Every branch of the JAX package is ported: two or three primes, N up to
    2048, plain and bundled (``bk_pair``) keys; and, for the sets without
    NTT primes (N >= 4096) or with ``schoolbook`` (the JAX package's
    ``REDSEC_FORCE_SCHOOLBOOK``), the schoolbook key: the raw BK uploaded
    ``chunk`` key bits at a time, flavour ``"schoolbook"``, with its spectra
    made on the device ``chunk`` rounds at a time
    (``kernels.prepare_key_spectra``, which raises unless the round's
    a-priori rounding bound is below 1/2).  As in the JAX
    package, a schoolbook key ignores ``bk_pair`` (it runs unbundled).  On
    CUDA an NTT combination the kernels are not built for
    (``kernels.supported``) raises: nothing falls back.

    ``ntt_flavor="matmul"`` (the JAX package's ``REDSEC_NTT=matmul``)
    transforms the limbs with the four-step ``ntt_matmul`` pair on the device
    instead of the NTT kernel, and the key's PBS runs the four-step kernels
    (or, outside ``kernels.supported_mm``, the torch loop of that flavour); N
    must be one ``ntt_matmul.supported`` takes."""
    if ntt_flavor not in NTT_FLAVORS:
        raise ValueError(f"ntt_flavor must be one of {NTT_FLAVORS}, got {ntt_flavor!r}")
    dev = resolve_device(device)
    p = cloud.params
    bundled = cloud.bk_pair is not None
    plan = bootstrap_plan(p, bundled, schoolbook)
    ksk = _upload(cloud.ksk.reshape(-1, p.n + 1), dev, 4096)
    if plan is None:
        if ntt_flavor != "radix2":
            raise ValueError(f"{p.name}: a schoolbook key (no NTT plan) has no "
                             f"{ntt_flavor!r} flavour")
        bk = _upload(cloud.bk, dev, chunk)
        return DeviceCloudKey(params=p, plan=None, bk=bk, ksk=ksk, rerand=_rerand(cloud, dev),
                              ntt_flavor="schoolbook",
                              spectra=kernels.prepare_key_spectra(bk, p, chunk))
    bundle = 2 if bundled else 1
    matmul = ntt_flavor == "matmul"
    if matmul and not ntt_matmul.supported(p.N):
        raise ValueError(f"{p.name}: the four-step NTT does not take N={p.N}")
    if dev.type == "cuda" and not matmul and not kernels.supported(p, plan, bundle):
        raise ValueError(
            f"{p.name}: primes {plan.primes} at N={p.N}, bundle {bundle}, are outside "
            "what the CUDA kernels take (2 or 3 primes < 2^16, N in 256..2048)")
    N = p.N
    bk_host = cloud.bk
    if bundled:
        # interleave per pair: [bk(s_2i) rows | bk(s_2i+1) rows | bk(pair)] so
        # one round slice feeds the bundled round's single 3*rows contraction
        rows, n2 = p.decomp_rows, p.n // 2
        bk_host = np.concatenate([cloud.bk.reshape(n2, 2, rows, 2, N),
                                  cloud.bk_pair[:, None]], axis=1).reshape(n2, 3 * rows, 2, N)
    bk_raw = torch.as_tensor(bk_host.astype(np.int32), device=dev)  # [n', R, 2, N]
    n_rounds, R = bk_raw.shape[0], bk_raw.shape[1]
    parts = [[] for _ in plan.primes]
    for i0 in range(0, n_rounds, chunk):
        bk = bk_raw[i0:i0 + chunk]
        limbs = torch.stack(int8_limbs(bk), dim=3)  # [c, R, 2, limbs, N]
        for pi, prime in enumerate(plan.primes):
            lmod = (limbs + prime * (limbs < 0).to(torch.int32)).reshape(-1, N)
            res = (ntt_matmul.ntt_device_mm(lmod, plan, pi) if matmul
                   else kernels.ntt(lmod.contiguous(), plan, pi))
            # residues up to 2^16 - 1 keep their 16-bit pattern
            parts[pi].append(res.to(torch.int16).reshape(bk.shape[0], R, 2 * BK_LIMBS, N))
    bk_ntt = torch.stack([torch.cat(ps, dim=0) for ps in parts]).contiguous()
    if matmul:
        bk_ntt = bk_ntt.unflatten(-1, ntt_matmul._split_rc(N))
    return DeviceCloudKey(params=p, plan=plan, bk=bk_ntt, ksk=ksk, rerand=_rerand(cloud, dev),
                          bundle=bundle, ntt_flavor=ntt_flavor)


def const_test_vector(params: TfheParams, value: int, msize: int) -> np.ndarray:
    """Test vector for the sign bootstrap: all coefficients = mu, giving
    +-mu depending on the sign of the phase (binarize_int/unbinarize_int,
    lib/BinOps_enc.cpp:182-192)."""
    mu = int(mod_switch_to_torus32(value, msize))
    return np.full(params.N, mu, dtype=np.int32)


def function_test_vector(params: TfheParams, fn: Callable[[np.ndarray], np.ndarray],
                         msize: int) -> np.ndarray:
    """Programmable test vector: output value fn(v) for input value v, where v
    ranges over the message space.  fn must satisfy the negacyclic constraint
    fn(v + msize/2) = -fn(v); inputs are assumed confined accordingly.

    Coefficient j of the test vector holds the output for phases that
    mod-switch to j, i.e. input value v ~= j * msize / (2N).
    """
    N, msz = params.N, msize
    j = np.arange(N)
    v = np.round(j * msz / (2 * N)).astype(np.int64)
    out = fn(v)
    return mod_switch_to_torus32(np.asarray(out), msz).astype(np.int32)


def gadget_offset(p: TfheParams) -> int:
    """TFHE v1.1 signed-decomposition offset: sum_j (Bg/2) * 2^(32-(j+1)*Bgbit)
    (as uint32).  Adding it makes each masked bit-field a balanced digit after
    subtracting Bg/2."""
    off = 0
    for j in range(p.l):
        off = (off + ((p.bg // 2) << (32 - (j + 1) * p.bg_bit))) & 0xFFFFFFFF
    return off


def _as_i32(u: int) -> int:
    """uint32 value -> the int32 with the same bits."""
    return u - (1 << 32) if u >= (1 << 31) else u


class RoundOps:
    """Per-round primitives in torch: mod-switch, negacyclic rotate, gadget
    decompose, sample extract, key switch.

    torch has no usable uint32 arithmetic; where the JAX package shifts
    uint32, these shift int32 arithmetically and mask.  That is exact because
    every mask is no wider than 32 minus its shift (the bits above the field
    are the only ones the sign extension touches)."""

    def __init__(self, p: TfheParams):
        self.p = p
        self._two_n = 2 * p.N
        self._ms_shift = 32 - p.log2_2N
        self._offset = _as_i32(gadget_offset(p))
        self._dec_shifts = [32 - (j + 1) * p.bg_bit for j in range(p.l)]
        self._ks_shifts = [32 - (j + 1) * p.ks_basebit for j in range(p.ks_t)]
        kbits = p.ks_basebit * p.ks_t
        self._prec_offset = (1 << (32 - 1 - kbits)) if kbits < 32 else 0

    def mod_switch(self, x: torch.Tensor) -> torch.Tensor:
        """torus int32 -> rotation exponent in [0, 2N) (rounded)."""
        u = x + (1 << (self._ms_shift - 1))
        return (u >> self._ms_shift) & (self._two_n - 1)

    def rotate(self, polys: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """X^t * poly (negacyclic) for per-batch exponents t [B] in [0, 2N):
        out[..., j] = sign(j - t) * polys[..., (j - t) mod N]."""
        N = self.p.N
        j = torch.arange(N, device=polys.device, dtype=torch.int32)
        src = (j[None, :] - t[:, None].to(torch.int32)) % self._two_n
        sign = torch.where(src >= N, -1, 1).to(torch.int32)
        shape = [polys.shape[0]] + [1] * (polys.ndim - 2) + [N]
        idx = (src % N).reshape(shape).expand(polys.shape).to(torch.int64)
        return torch.gather(polys, -1, idx) * sign.reshape(shape)

    def decompose(self, x: torch.Tensor) -> torch.Tensor:
        """TFHE signed gadget decomposition: x [B, 2, N] torus -> digits
        [B, rows, N] int32 in [-Bg/2, Bg/2), row = bloc * l + level."""
        u = x + self._offset
        d = torch.stack([(u >> s) & (self.p.bg - 1) for s in self._dec_shifts], dim=2)
        return (d - self.p.half_bg).reshape(x.shape[0], self.p.decomp_rows, self.p.N)

    def sample_extract(self, acc: torch.Tensor):
        a_poly = acc[:, 0, :]
        a_ext = torch.cat([a_poly[:, :1], -a_poly[:, 1:].flip(-1)], dim=-1)
        return a_ext, acc[:, 1, 0]

    def ks_digits(self, a_n: torch.Tensor) -> torch.Tensor:
        """Key-switch digit decomposition: [B, N] -> [B, N*t] in [0, base)."""
        u = a_n + self._prec_offset
        dig = torch.stack([(u >> s) & (self.p.ks_base - 1) for s in self._ks_shifts],
                          dim=-1)
        return dig.reshape(a_n.shape[0], -1)

    def key_switch(self, a_n: torch.Tensor, b_n: torch.Tensor,
                   ksk: torch.Tensor) -> torch.Tensor:
        """Subtract digit-scaled rows of the multiply-form KSK [N*t, n+1]:
        one exact digit x KSK product (limbs of the KSK in fp32, in chunks of
        the N*t rows that keep each partial sum below 2^24)."""
        dig = self.ks_digits(a_n)
        ssum = int32_matmul(ksk.T, dig.T, self.p.ks_base - 1).T  # [B, n+1]
        out = -ssum
        out[:, self.p.n] += b_n
        return out


def _test_vectors(testvect, B: int, N: int, device) -> torch.Tensor:
    """int32 [B, N] view of one test vector [N] or one per ciphertext [B, N]."""
    tv = torch.as_tensor(np.asarray(testvect, np.int32) if not isinstance(
        testvect, torch.Tensor) else testvect, device=device).to(torch.int32)
    return tv.reshape(-1, N).expand(B, N)


ROUND_KERNELS = (None, "full", "partial")


def _check_round_kernel(round_kernel: Optional[str], p: TfheParams,
                        plan: Optional[ntt_mod.NttPlan], ntt_flavor: str,
                        bundle: Optional[int] = None) -> None:
    """``round_kernel`` (None, "full" or "partial") must be None or lie inside
    the envelope of the one-round kernels: a "matmul" key's flavour, a plan
    ``kernels.supported_mm`` takes and, where known, bundle 1.  Raises
    otherwise: the JAX package's ``REDSEC_ROUND_KERNEL`` falls quietly back
    to its loop outside it, the argument does not."""
    if round_kernel not in ROUND_KERNELS:
        raise ValueError(f"round_kernel must be one of {ROUND_KERNELS}, got {round_kernel!r}")
    if round_kernel is None:
        return
    if ntt_flavor != "matmul" or plan is None:
        raise ValueError(f"round_kernel={round_kernel!r} runs the four-step one-round kernels, "
                         f"which take 'matmul' keys only; this key's flavour is "
                         f"{'schoolbook' if plan is None else ntt_flavor!r}")
    if not kernels.supported_mm(p, plan, 1 if bundle is None else bundle):
        raise ValueError(f"round_kernel={round_kernel!r}: {p.name} (N={p.N}, primes "
                         f"{plan.primes}, {p.decomp_rows} digit rows, bundle "
                         f"{1 if bundle is None else bundle}) lies outside the one-round "
                         "kernels' envelope (kernels.supported_mm: bundle 1, two primes "
                         f"< 2^15, N in {kernels.MM_KERNEL_N})")


def make_bootstrap_impl(p: TfheParams, plan: Optional[ntt_mod.NttPlan],
                        ntt_flavor: str = "radix2", round_kernel: Optional[str] = None):
    """``impl(dkey, ct [B, n+1], testvect [N]|[B, N]) -> [B, n+1]``.  With an
    NTT plan the blind rotation is ``kernels.blind_rotate`` (the CUDA kernel
    on a CUDA tensor, its plain twin on a CPU tensor), plain or bundled as the
    key is; for ``ntt_flavor="matmul"`` it is ``kernels.blind_rotate_mm``
    where ``kernels.supported_mm`` takes the set and the key's bundling, else
    the torch loop ``kernels.blind_rotate_mm_plain``.  Without
    one (``plan`` None) it is the JAX package's schoolbook body: its n
    rounds on the key's spectra in one call of ``kernels.schoolbook_rounds``
    (on CUDA one C loop of n launches of the round kernel; on the CPU n calls
    of ``kernels.schoolbook_round``).  The impl checks every key it is given
    against ``ntt_flavor``.  ``round_kernel`` ("full" or "partial"; see the
    module's docstring and ``_check_round_kernel``) runs a "matmul" key's n
    rounds one launch a round, on a CPU tensor through the kernels' twins;
    the set's envelope is checked here once, the key's bundling by the
    builders that know the key (``make_batched_bootstrap``,
    ``make_chunked_bootstrap``)."""
    N, n = p.N, p.n
    ops = RoundOps(p)
    _check_round_kernel(round_kernel, p, plan, ntt_flavor)

    def blind_rotate_rounds(acc: torch.Tensor, abar: torch.Tensor,
                            dkey: DeviceCloudKey) -> torch.Tensor:
        # round i reads the key's slice bk[:, i] in place (each prime's
        # [rows, 8, R, C] contiguous) and the exponents abar[:, i]
        ts = abar.t().contiguous()
        for i in range(n):
            if round_kernel == "full":
                acc = kernels.cmux_round_mm(acc, ts[i], dkey.bk[:, i], p, plan)
            else:
                digits = ops.decompose(ops.rotate(acc, ts[i]) - acc)
                acc = acc + kernels.external_product_mm(digits, dkey.bk[:, i], plan)
        return acc

    def blind_rotate_schoolbook(acc: torch.Tensor, abar: torch.Tensor,
                                dkey: DeviceCloudKey) -> torch.Tensor:
        # one schoolbook round a key bit: round i's exponents in row i
        return kernels.schoolbook_rounds(acc, abar.t().contiguous(), dkey.spectra, p)

    want = "schoolbook" if plan is None else ntt_flavor

    def impl(dkey: DeviceCloudKey, ct: torch.Tensor, testvect) -> torch.Tensor:
        _check_key(dkey, want)
        abar = ops.mod_switch(ct[:, :n]).contiguous()
        bbar = ops.mod_switch(ct[:, n])
        tv = _test_vectors(testvect, ct.shape[0], N, ct.device)
        acc_b = ops.rotate(tv, (2 * N - bbar) % (2 * N))
        acc = torch.stack([torch.zeros_like(acc_b), acc_b], dim=1).contiguous()
        if plan is None:
            acc = blind_rotate_schoolbook(acc, abar, dkey)
        elif round_kernel is not None:
            acc = blind_rotate_rounds(acc, abar, dkey)
        elif ntt_flavor == "matmul":
            # the shape rule: the four-step kernel takes what the JAX package's
            # Pallas kernel takes (two primes < 2^15, N = 256 or 1024, bundle
            # 1); bundled keys, N = 2048 and three primes run the loop in
            # torch, as the JAX package runs its XLA loop there
            if kernels.supported_mm(p, plan, dkey.bundle):
                acc = kernels.blind_rotate_mm(acc, abar, dkey.bk, p, plan)
            else:
                acc = kernels.blind_rotate_mm_plain(acc, abar, dkey.bk, p, plan)
        else:
            acc = kernels.blind_rotate(acc, abar, dkey.bk, p, plan)
        a_n, b_n = ops.sample_extract(acc)
        return ops.key_switch(a_n, b_n, dkey.ksk)

    return impl


def _check_key(dkey: DeviceCloudKey, need: Optional[str] = None) -> None:
    """The key's flavour must be one its plan allows ("radix2" or "matmul"
    with an NTT plan, "schoolbook" without), its BK must have that flavour's
    shape, and ``need`` (when given) must be its flavour: a key in one
    NTT-domain order is garbage to code written for another.  A schoolbook
    key runs unbundled, as the JAX package requires (``make_bootstrap_impl``,
    bundle=2 without a plan raises there)."""
    allowed = NTT_FLAVORS if dkey.plan is not None else ("schoolbook",)
    if dkey.ntt_flavor not in allowed:
        raise ValueError(
            f"device key has NTT flavour {dkey.ntt_flavor!r}, but its plan allows {allowed}")
    if need is not None and dkey.ntt_flavor != need:
        raise ValueError(f"device key has NTT flavour {dkey.ntt_flavor!r}, but this path "
                         f"needs {need!r}; prepare the key with ntt_flavor={need!r}")
    ndim = {"radix2": 5, "matmul": 6, "schoolbook": 4}[dkey.ntt_flavor]
    if dkey.bk.ndim != ndim:
        raise ValueError(f"a {dkey.ntt_flavor!r}-flavour key's BK has {ndim} dimensions, this one "
                         f"{tuple(dkey.bk.shape)}")
    if dkey.ntt_flavor == "schoolbook":
        p = dkey.params
        want = (p.n, p.decomp_rows, 2, 2, p.N // 2)
        if dkey.spectra is None or tuple(dkey.spectra.shape) != want:
            raise ValueError(f"a schoolbook key needs its spectra complex128 {list(want)} "
                             "(prepare it with prepare_cloud_key); this one has "
                             f"{None if dkey.spectra is None else tuple(dkey.spectra.shape)}")
    if dkey.plan is None and dkey.bundle != 1:
        raise ValueError("bundle=2 requires an NTT plan (the schoolbook path for the "
                         "medium/large parameter sets runs unbundled)")


def make_batched_bootstrap(dkey: DeviceCloudKey, round_kernel: Optional[str] = None):
    """Batched PBS bound to a device key: ``(ct [B, n+1], testvect [N]|[B, N])
    -> [B, n+1]`` int32 on the key's device.  ``round_kernel``: see
    ``make_bootstrap_impl``; raises here for a key outside its envelope."""
    _check_key(dkey)
    _check_round_kernel(round_kernel, dkey.params, dkey.plan, dkey.ntt_flavor, dkey.bundle)
    impl = make_bootstrap_impl(dkey.params, dkey.plan, dkey.ntt_flavor, round_kernel)

    def bootstrap(ct, testvect):
        ct = torch.as_tensor(ct, dtype=torch.int32, device=dkey.device)
        return impl(dkey, ct, testvect)

    return bootstrap


def make_chunked_bootstrap(dkey: DeviceCloudKey, chunk: int = 512,
                           round_kernel: Optional[str] = None):
    """Batched PBS that runs batches larger than ``chunk`` as consecutive
    ``chunk``-sized slices (bounds the working set of the plain path and of
    the leveled glue around the kernel); ``round_kernel`` as for
    ``make_batched_bootstrap``."""
    _check_key(dkey)
    _check_round_kernel(round_kernel, dkey.params, dkey.plan, dkey.ntt_flavor, dkey.bundle)
    impl = make_bootstrap_impl(dkey.params, dkey.plan, dkey.ntt_flavor, round_kernel)
    N = dkey.params.N

    def run(ct, testvect):
        ct = torch.as_tensor(ct, dtype=torch.int32, device=dkey.device)
        m = ct.shape[0]
        if m <= chunk:
            return impl(dkey, ct, testvect)
        tv = _test_vectors(testvect, m, N, ct.device)
        return torch.cat([impl(dkey, ct[i0:i0 + chunk], tv[i0:i0 + chunk])
                          for i0 in range(0, m, chunk)], dim=0)

    return run


# --------------------------------------------------------------------------- #
# Host reference (numpy, exact) — the test oracle for the device path         #
# --------------------------------------------------------------------------- #


def _rotate_host(poly: np.ndarray, t: int, N: int) -> np.ndarray:
    ext = np.concatenate([poly, -poly], axis=-1)
    j = np.arange(N)
    return ext[..., (j - t) % (2 * N)]


def bootstrap_host(cloud: CloudKey, ct: np.ndarray, testvect: np.ndarray) -> np.ndarray:
    """Single-sample reference bootstrap in numpy int64 (exact)."""
    p = cloud.params
    N, n, l, bg_bit = p.N, p.n, p.l, p.bg_bit
    plan = bootstrap_plan(p)
    half_bg, mask = p.half_bg, p.bg - 1
    offset = gadget_offset(cloud.params)

    def mod_switch(x):
        u = np.int64(x) & 0xFFFFFFFF
        return int(((u + (1 << (31 - p.log2_2N))) >> (32 - p.log2_2N)) & (2 * N - 1))

    def decompose(x):
        u = (x.astype(np.int64) & 0xFFFFFFFF) + offset
        digs = []
        for j in range(l):
            digs.append(((u >> (32 - (j + 1) * bg_bit)) & mask) - half_bg)
        return np.stack(digs)  # [l, N]

    def poly_mul_torus(d, c):
        """digit poly x torus poly -> torus poly (exact via limbs + CRT;
        int64 schoolbook when the parameter set has no NTT primes)."""
        if plan is None:
            return ntt_mod.negacyclic_mul_host(d, c, N)
        c_u = c.astype(np.uint32)
        out = np.zeros(N, dtype=np.int64)
        for sh in range(0, 32, BK_LIMB_BITS):
            limb = ((c_u >> np.uint32(sh)) & np.uint32((1 << BK_LIMB_BITS) - 1)).astype(np.int64)
            residues = []
            for pi, prime in enumerate(plan.primes):
                yd = ntt_mod.ntt_host(d % prime, plan, pi)
                yl = ntt_mod.ntt_host(limb, plan, pi)
                residues.append(ntt_mod.intt_host(yd * yl % prime, plan, pi))
            out += _crt_host(residues, plan) << sh
        return out.astype(np.uint64).astype(np.uint32).astype(np.int32)

    abar = [mod_switch(v) for v in ct[:n]]
    bbar = mod_switch(ct[n])
    acc = np.stack(
        [np.zeros(N, dtype=np.int32),
         _rotate_host(testvect.astype(np.int32), (2 * N - bbar) % (2 * N), N)]
    )
    for i in range(n):
        rot = _rotate_host(acc, abar[i], N)
        diff = (rot - acc).astype(np.int32)
        delta = np.zeros((2, N), dtype=np.int32)
        for bloc in range(2):
            digs = decompose(diff[bloc])  # [l, N]
            for j in range(l):
                row = bloc * l + j
                for u in range(2):
                    delta[u] = (
                        delta[u] + poly_mul_torus(digs[j], cloud.bk[i, row, u])
                    ).astype(np.int32)
        acc = (acc + delta).astype(np.int32)

    a_ext = np.concatenate([acc[0, :1], -acc[0, :0:-1]]).astype(np.int32)
    b_ext = acc[1, 0]

    t, base, basebit = p.ks_t, p.ks_base, p.ks_basebit
    prec = (1 << (32 - 1 - basebit * t)) if basebit * t < 32 else 0
    out = np.zeros(n + 1, dtype=np.int32)
    out[n] = b_ext
    for i in range(N):
        u = (int(a_ext[i]) & 0xFFFFFFFF) + prec
        for j in range(t):
            dig = (u >> (32 - (j + 1) * basebit)) & (base - 1)
            # multiply-form KSK: subtract digit * ksk[i, j] (int32 wraparound)
            out = (out.astype(np.int64) - dig * cloud.ksk[i, j].astype(np.int64)).astype(np.int32)
    return out
