"""Polynomial-dimension sharding of the bootstrap over ``torch.distributed``
ranks (the JAX package's ``parallel/ntt_shard.py``).

Each bootstrap's N-point polynomials are split over the sp ranks of a tp row,
inside every CMUX round, on the four-step factorization N = R * C of
``crypto/ntt_matmul.py``, with exactly ONE all-to-all per direction:

  coefficient domain, sharded over j2 (column blocks of the [R, C] view)
    -> twist (pointwise, local)
    -> NTT_R (product contracting j1, local)
    -> twiddle w^(k1*j2) (pointwise, local)
    -> all-to-all (re-shard: split k1, concatenate j2)
    -> NTT_C (product contracting j2, local)
  frequency domain, sharded over k1 (contiguous blocks of the flat N axis)

The bootstrapping key lives frequency-sharded over k1: each rank holds N/sp of
every BK polynomial of a "matmul" key (whose four-step order makes the shard a
plain block slice), and the key-switching key's limbs for its block of
coefficients, whose partial products are all-reduced (the JAX package's
``psum``).  The accumulator stays
replicated in the coefficient domain, where the data-dependent rotation is a
local permutation; each round's delta is all-gathered.  The arithmetic is
the single-device "matmul" PBS's, exact, so the output is bit-identical to it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..crypto import kernels
from ..crypto import ntt_matmul as mm
from ..crypto.bootstrap import BK_LIMBS, DeviceCloudKey, RoundOps, _check_key, _test_vectors
from ..crypto.ntt import _mulmod_device
from .mesh import Mesh, all_reduce_int32


def poly_shard_viable(N: int, sp: int) -> bool:
    """The poly axis must divide both four-step factors: R (frequency k1
    blocks) and C (coefficient j2 blocks)."""
    if not mm.supported(N):
        return False
    R, C = mm._split_rc(N)
    return R % sp == 0 and C % sp == 0


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x [sp, ...]: block j goes to rank j of ``group``; returns [sp, ...],
    block j from rank j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def fwd_local(x_loc: torch.Tensor, plan, pi: int, group, sp: int, ti: int) -> torch.Tensor:
    """Forward sharded NTT: x_loc int32 [B, R, C/sp] in [0, p) (coefficient
    order, j2-sharded) -> [B, R/sp, C] (frequency, k1-sharded)."""
    p = plan.primes[pi]
    t = mm.tables(plan, pi, x_loc.device)
    R, C = t["R"], t["C"]
    Rl, Cl = R // sp, C // sp
    cols = slice(ti * Cl, (ti + 1) * Cl)
    m = _mulmod_device(x_loc, t["twist"][None, :, cols], p)
    a = mm._matmul_left(m, t["WR"], p)  # [B, k1 = R, j2_loc]
    a = _mulmod_device(a, t["TW"][None, :, cols], p)
    B = a.shape[0]
    # re-shard from j2 to k1: block j of the k1 axis to rank j
    a = _all_to_all(a.reshape(B, sp, Rl, Cl).transpose(0, 1), group)  # [sp (j2), B, Rl, Cl]
    a = a.permute(1, 2, 0, 3).reshape(B, Rl, C)
    return mm._matmul_right(a, t["WC"], p)  # [B, R/sp, k2 = C]


def inv_local(y_loc: torch.Tensor, plan, pi: int, group, sp: int, ti: int) -> torch.Tensor:
    """Inverse sharded NTT: y_loc int32 [B, R/sp, C] (frequency,
    k1-sharded) -> [B, R, C/sp] (coefficient order, j2-sharded)."""
    p = plan.primes[pi]
    t = mm.tables(plan, pi, y_loc.device)
    R, C = t["R"], t["C"]
    Rl, Cl = R // sp, C // sp
    b = mm._matmul_right(y_loc, t["WCi"], p)  # [B, k1_loc, j2]
    b = _mulmod_device(b, t["TWi"][None, ti * Rl:(ti + 1) * Rl], p)
    B = b.shape[0]
    # re-shard from k1 back to j2: block j of the j2 axis to rank j
    b = _all_to_all(b.reshape(B, Rl, sp, Cl).permute(2, 0, 1, 3), group)  # [sp (k1), B, Rl, Cl]
    b = b.transpose(0, 1).reshape(B, R, Cl)
    x = mm._matmul_left(b, t["WRi"], p)  # [B, j1, j2_loc]
    return _mulmod_device(x, t["untwist"][None, :, ti * Cl:(ti + 1) * Cl], p)


@dataclasses.dataclass(frozen=True)
class PolyShardedKey:
    """A rank's share of an evaluation key for poly-sharded evaluation: its
    k1 block of every BK polynomial, int16 [P, n, rows, 8, R/sp, C], and the
    key-switching key's limbs for its block of N/sp coefficients, int8
    ``kernels.ksk_shape(N/sp, params)`` (a block of the full key's k-steps,
    ``kernels.ksk_tiles``)."""

    bk: torch.Tensor
    ksk_limbs: torch.Tensor


def shard_cloud_key_poly(dkey: DeviceCloudKey, mesh: Mesh) -> PolyShardedKey:
    """This rank's block of a "matmul" key over the mesh's tp axis: the BK's
    frequency axis in contiguous k1 blocks and the KSK's limbs for the
    matching contiguous block of coefficients (a block of its k-steps).  A radix-2 key is refused
    (its bit-reversed frequency order does not block-shard), as is a bundled
    one, as in the JAX package, and a block of coefficients that does not
    fill the key switch's chunks of 16."""
    if dkey.ntt_flavor != "matmul":
        raise ValueError(f"poly sharding needs a four-step-ordered key (flavour 'matmul'); "
                         f"this key is {dkey.ntt_flavor!r}: prepare it with "
                         f"ntt_flavor='matmul'")
    _check_key(dkey, "matmul")
    if dkey.bundle != 1:
        raise ValueError("poly sharding does not take bundled (bundle=2) keys")
    sp, ti = mesh.tp, mesh.tp_index
    if not poly_shard_viable(dkey.params.N, sp):
        raise ValueError(f"N={dkey.params.N} cannot shard over {sp} ranks")
    if (dkey.params.N // sp) % kernels.KS_CHUNK:
        raise ValueError(f"N={dkey.params.N} over {sp} ranks leaves blocks of coefficients "
                         f"that are not whole chunks of {kernels.KS_CHUNK}")
    Rl = dkey.bk.shape[-2] // sp
    steps = dkey.ksk_limbs.shape[1] // sp
    return PolyShardedKey(bk=dkey.bk[..., ti * Rl:(ti + 1) * Rl, :].contiguous(),
                          ksk_limbs=dkey.ksk_limbs[:, ti * steps:(ti + 1) * steps].contiguous())


def exchange_bytes_per_round(p, plan, sp: int) -> dict:
    """Per-ciphertext traffic between ranks in ONE CMUX round of the
    poly-sharded bootstrap (bytes that leave a rank, i.e. (sp-1)/sp of each
    re-sharded tensor):

    - forward all-to-all: decomposed digits, rows x N x 4 B per prime
    - inverse all-to-all: products, 2 polys x limbs x N x 4 B per prime
    - delta all-gather: 2 polys x N x 4 B x (sp-1)"""
    N, rows = p.N, p.decomp_rows
    np_ = len(plan.primes)
    f = (sp - 1) / sp
    fwd = rows * N * 4 * np_ * f
    inv = 2 * BK_LIMBS * N * 4 * np_ * f
    gather = 2 * N * 4 * (sp - 1)
    return {"fwd_all_to_all": int(fwd), "inv_all_to_all": int(inv),
            "delta_all_gather": int(gather), "total": int(fwd + inv + gather)}


def make_poly_sharded_bootstrap(dkey: DeviceCloudKey, mesh: Mesh):
    """Batched PBS with the polynomial dimension sharded over the mesh's tp
    ranks: ``fn(ct_local [B_l, n+1], tv [N] | [B_l, N]) -> [B_l, n+1]``, with
    ``ct_local`` this rank's batch block (replicated over tp; every rank of a
    tp row returns the same output).

    Per CMUX round each rank rotates and decomposes the replicated
    accumulator, forward-transforms its j2 column block of the digits,
    exchanges once, multiplies against its k1 block of the BK, transforms
    back, exchanges back, and all-gathers the coefficient delta.  The key
    switch contracts this rank's coefficient block against its KSK rows and
    all-reduces the partial sums.  ``fn.sharded_key`` is this rank's share."""
    p, plan = dkey.params, dkey.plan
    if plan is None:
        raise ValueError("poly sharding requires an NTT parameter set")
    skey = shard_cloud_key_poly(dkey, mesh)
    sp, ti, group = mesh.tp, mesh.tp_index, mesh.tp_group
    N, n, rows = p.N, p.n, p.decomp_rows
    R, C = mm._split_rc(N)
    Rl, Cl, Nl = R // sp, C // sp, N // sp
    ops = RoundOps(p)
    bk = kernels.residues(skey.bk)  # [P, n, rows, 8, Rl, C] int32

    def run(ct, tv) -> torch.Tensor:
        ct = torch.as_tensor(ct, dtype=torch.int32, device=dkey.device)
        B = ct.shape[0]
        abar = ops.mod_switch(ct[:, :n])
        bbar = ops.mod_switch(ct[:, n])
        acc_b = ops.rotate(_test_vectors(tv, B, N, ct.device), (2 * N - bbar) % (2 * N))
        acc = torch.stack([torch.zeros_like(acc_b), acc_b], dim=1)  # [B, 2, N]
        for i in range(n):
            digits = ops.decompose(ops.rotate(acc, abar[:, i]) - acc)  # [B, rows, N]
            d_loc = digits.reshape(B * rows, R, C)[..., ti * Cl:(ti + 1) * Cl]
            conv = []  # per prime: [B, 2, limbs, R, Cl], coefficient j2-sharded
            for pi, prime in enumerate(plan.primes):
                dmod = d_loc + prime * (d_loc < 0).to(torch.int32)
                dn = fwd_local(dmod, plan, pi, group, sp, ti).reshape(B, rows, Nl)
                s = kernels.mac_rows(dn, bk[pi, i].reshape(rows, 2 * BK_LIMBS, Nl), prime)
                inv = inv_local(s.reshape(-1, Rl, C), plan, pi, group, sp, ti)
                conv.append(inv.reshape(B, 2, BK_LIMBS, R, Cl))
            delta_loc = kernels.recombine_limbs(conv, plan)  # [B, 2, R, Cl]
            parts = [torch.empty_like(delta_loc) for _ in range(sp)]
            dist.all_gather(parts, delta_loc.contiguous(), group=group)
            acc = acc + torch.cat(parts, dim=3).reshape(B, 2, N)
        a_n, b_n = ops.sample_extract(acc)
        # sharded key switch: this rank's coefficient block against its limbs
        # (-ssum of the block), summed over the ranks, then b
        part = kernels.key_switch(a_n[:, ti * Nl:(ti + 1) * Nl].contiguous(),
                                  torch.zeros_like(b_n), skey.ksk_limbs, p)
        out = all_reduce_int32(part, group)
        out[:, n] += b_n
        return out

    run.sharded_key = skey
    return run


def make_ntt_poly_sharded(plan, pi: int, mesh: Mesh):
    """Standalone sharded transforms (tests and measurements), as ranks of the
    mesh's tp row: ``fwd(x_loc [B, R, C/sp]) -> [B, N/sp]`` (four-step order,
    this rank's contiguous block) and its exact inverse ``inv(y_loc [B, N/sp])
    -> [B, R, C/sp]``.  Bit-identical to ``ntt_matmul.ntt_device_mm`` /
    ``intt_device_mm`` on the whole polynomial."""
    sp, ti, group = mesh.tp, mesh.tp_index, mesh.tp_group
    if not poly_shard_viable(plan.N, sp):
        raise ValueError(f"N={plan.N} cannot shard over {sp} ranks")
    R, C = mm._split_rc(plan.N)

    def fwd(x_loc):
        z = fwd_local(x_loc, plan, pi, group, sp, ti)
        return z.reshape(z.shape[0], -1)

    def inv(y_loc):
        return inv_local(y_loc.reshape(y_loc.shape[0], R // sp, C), plan, pi, group, sp, ti)

    return fwd, inv

