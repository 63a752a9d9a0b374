"""K4's layout rule (``redsec_tpu_torch/csrc/pbs.cu``: ``Smem``, ``k4_chunk``,
``k4_config``) through its Python mirror, ``kernels.k4_layout``, on the CPU.

The mirror is held to the built library on the card by
``tests/test_torch_cuda.py`` (``_config_equals_mirror``); here it is held to
what the rule must give: every layout fits the 232,448 bytes a block may
have, every instance of the shipped sets where two ciphertexts fit a block
shares each key load between them at a full chunk of 512 on the H100's 132
SMs (the two N = 2048 ones, where they do not, keep one a block, for the
measured reason named at ``ONE_A_BLOCK``), the byte counts the design was
chosen from, where one prime's tables are refilled, and a rule that reads
nothing but the shape.  Exact integers throughout.
"""

import dataclasses
import types

import pytest

from redsec_tpu_torch.crypto import bootstrap as bs
from redsec_tpu_torch.crypto import kernels as K
from redsec_tpu_torch.crypto.params import get_params

SMS = 132  # the H100 SXM
MAX = 232448
PRIMES = {2: (12289, 18433), 3: (12289, 18433, 40961)}


def _instance(N, primes, bundle):
    """A parameter set and plan at N with ``primes`` NTT primes: small_v2's
    gadget (20 digit rows, 60 in a bundled round) with N and n set."""
    params = dataclasses.replace(get_params("small_v2"), N=N, n=16)
    plan = types.SimpleNamespace(N=N, primes=PRIMES[primes][:primes] if N < 2048
                                 else (12289, 40961))
    return params, plan


# every (N, primes, bundle) that kernels.supported takes: N = 2048 has two
# primes, plain and bundled
INSTANCES = [(N, P, b) for N in (256, 512, 1024, 2048) for P in (2, 3) for b in (1, 2)
             if N < 2048 or P == 2]


def test_instances_are_what_supported_takes():
    for N in (256, 512, 1024, 2048):
        for P in (2, 3):
            for b in (1, 2):
                params, plan = _instance(N, P, b)
                if N == 2048 and P == 3:
                    continue  # no three NTT primes below 2^16 at N = 2048
                assert K.supported(params, plan, b) == ((N, P, b) in INSTANCES)


@pytest.mark.parametrize("N,P,bundle", INSTANCES)
@pytest.mark.parametrize("batch", [1, 5, 132, 133, 512])
def test_every_layout_fits_a_block(N, P, bundle, batch):
    params, plan = _instance(N, P, bundle)
    lay = K.k4_layout(batch, params, plan, bundle, SMS)
    rows = params.decomp_rows * (3 if bundle == 2 else 1)
    polys = 8 if N <= 1024 else 4
    assert lay["shared_bytes"] <= MAX
    assert 1 <= lay["chunk_rows"] <= rows
    # all rows, or whole batches of transforms of the block's ciphertexts
    assert (lay["chunk_rows"] == rows
            or lay["chunk_rows"] * lay["group"] % polys == 0)
    # one ciphertext a block up to one wave of blocks; beyond it two where
    # two fit a block at the smallest chunk in the layout that gives up the
    # most: one prime's tables, the accumulators on r2 and (bundled) the
    # last prime's sums on the differences
    D = 3 if bundle == 2 else 1
    two_fit = K.k4_shared_bytes(N, 2, P, D, polys // 2, 1, True, D == 3) <= MAX
    assert lay["group"] == (2 if batch > SMS and two_fit else 1)
    # a larger chunk would not fit (the rule takes the largest)
    tables = P if lay["tables_resident"] else 1
    alias, on_diff = lay["accumulators_on_r2"], lay["sums_on_differences"]
    if lay["chunk_rows"] < rows:
        step = polys // lay["group"]
        assert K.k4_shared_bytes(N, lay["group"], P, D, lay["chunk_rows"] + step, tables,
                                 alias, on_diff) > MAX
    # the accumulators lie on r2 only where their own words do not fit, the
    # sums on the differences only where that does not fit either
    smallest = polys // lay["group"]
    assert alias == (K.k4_shared_bytes(N, lay["group"], P, D, smallest, tables) > MAX)
    assert on_diff == (alias and K.k4_shared_bytes(N, lay["group"], P, D, smallest, tables,
                                                   True) > MAX)
    assert not on_diff or D == 3  # only a bundled round's differences hold the sums
    # every prime's tables stay unless they do not fit beside the smallest chunk
    assert lay["tables_resident"] == (N <= 1024 and K.k4_shared_bytes(
        N, lay["group"], P, D, smallest, P) <= MAX)
    # else the one prime's tables are refilled off the block's path, at every N
    assert lay["tables_refilled"] == (not lay["tables_resident"])


SHIPPED = [("small_v2", 1), ("small_v2_n2048", 1), ("small", 1), ("small_v2_tpu", 2),
           ("small_v2_tpu2", 2), ("small_v2_tpu", 1), ("small_v2_n2048", 2)]
# (group, chunk rows, shared bytes, every prime's tables stay, one prime's
# refilled off the path) at batch 512 on 132 SMs: small, bundled
# small_v2_tpu and bundled small_v2_tpu2 at two a block and the two
# N = 2048 instances hold one prime's tables (249,856 and 233,472 bytes with
# every prime's at the smallest chunk for the first two) and refill each half with
# the next prime's by cp.async; bundled small_v2_n2048 takes 217,088 only
# with its accumulators on r2, bundled small_v2_tpu2 at two a block only
# with those and its last prime's MAC sums on the differences (chunks of 4)
WANT = {
    ("small_v2", 1): (2, 12, 217088, True, False),
    ("small_v2_n2048", 1): (1, 12, 217088, False, True),
    ("small", 1): (2, 6, 217088, False, True),
    ("small_v2_tpu", 2): (2, 8, 217088, False, True),
    ("small_v2_tpu2", 2): (2, 4, 217088, False, True),
    ("small_v2_tpu", 1): (2, 12, 217088, True, False),
    ("small_v2_n2048", 2): (1, 8, 217088, False, True),
}
# Where two ciphertexts do not fit a block even at the smallest chunk with
# one prime's tables, the accumulators on r2 and (bundled) the last prime's
# sums on the differences (266,240 and 282,624 bytes at N = 2048), a cluster
# of two blocks that loaded each key row once for both, by one multicast
# bulk copy, was measured slower than one ciphertext a block on the H100
# (80GB HBM3, 700 W; PERF.md): 132.76 against 100.62 ms at small_v2_n2048
# and 94.11 against 55.63 ms at bundled small_v2_tpu2 (which now fits two a
# block).  Such a ring, one copy a key row that both blocks must have read
# before the slot is refilled, moves rows at 2.36e12 (N = 1024) and 4.41e12
# B/s (N = 2048) into the pair's shared memory against 5.38e12 and 8.55e12
# for one block's own cp.async ring (tools/l2_rate.py).  So they keep one a
# block, and a block's own key stream was made cheaper instead: the rows
# copied past L1 in 16-byte runs, the first rows of a chunk started before
# the barrier that ends its forward transforms, and the one prime's stage
# tables refilled off the block's path (88 and 117 ms against 100 and 137,
# PERF.md), the same stream every N <= 1024 instance runs.
ONE_A_BLOCK = {("small_v2_n2048", 1), ("small_v2_n2048", 2)}


@pytest.mark.parametrize("name,bundle", SHIPPED)
def test_shipped_sets_share_every_key_load_at_a_full_chunk(name, bundle):
    params = get_params(name)
    plan = bs.bootstrap_plan(params, bundle == 2)
    lay = K.k4_layout(512, params, plan, bundle, SMS)
    want_shared = 1 if (name, bundle) in ONE_A_BLOCK else 2
    assert lay["group"] == want_shared
    got = (lay["group"], lay["chunk_rows"], lay["shared_bytes"], lay["tables_resident"],
           lay["tables_refilled"])
    assert got == WANT[(name, bundle)]
    N, P, D = params.N, len(plan.primes), 3 if bundle == 2 else 1
    assert lay["instance"] == f"blind_rotate_kernelILi{N}ELi{want_shared}ELi{P}ELi{D}E"
    smallest = (8 if N <= 1024 else 4) // 2
    tables_one = K.k4_shared_bytes(N, 2, P, D, smallest, 1)
    assert (tables_one > MAX) == ((name, bundle) in ONE_A_BLOCK | {("small_v2_tpu2", 2)})
    # nor with the accumulators on r2 and the last prime's sums on the differences
    least = K.k4_shared_bytes(N, 2, P, D, smallest, 1, True, D == 3)
    assert (least > MAX) == ((name, bundle) in ONE_A_BLOCK)
    # the forward's smallest chunk (batch 32) and one ciphertext: one a block
    for batch in (1, 32):
        small = K.k4_layout(batch, params, plan, bundle, SMS)
        assert small["group"] == 1
        assert small["shared_bytes"] <= MAX


# The shared bytes of each instance with every prime's stage tables resident
# (N <= 1024), as the design was chosen from them: (set, bundle) -> one a
# block at its chunk, two a block with all rows, two at the smallest chunk
TABLE = {
    ("small_v2", 1): ((20, 176128), 249856, 200704),
    ("small", 1): ((6, 184320), 249856, 249856),
    ("small_v2_n2048", 1): ((12, 217088), 397312, 299008),
    ("small_v2_tpu", 2): ((36, 225280), 348160, 233472),
    ("small_v2_tpu2", 2): ((16, 217088), 372736, 282624),
}


@pytest.mark.parametrize("name,bundle", list(TABLE))
def test_mirror_reproduces_the_byte_counts(name, bundle):
    params = get_params(name)
    plan = bs.bootstrap_plan(params, bundle == 2)
    N, P, D = params.N, len(plan.primes), 3 if bundle == 2 else 1
    rows = D * params.decomp_rows
    tables = P if N <= 1024 else 1
    (cr1, one), two_all, two_min = TABLE[(name, bundle)]
    assert K.k4_shared_bytes(N, 1, P, D, cr1, tables) == one
    assert K.k4_layout(1, params, plan, bundle, SMS)["chunk_rows"] == cr1
    assert K.k4_shared_bytes(N, 2, P, D, rows, tables) == two_all
    smallest = (8 if N <= 1024 else 4) // 2
    assert K.k4_shared_bytes(N, 2, P, D, smallest, tables) == two_min
    if name == "small_v2":  # two a block in chunks of 12: 24 polynomials, 3 full batches
        assert K.k4_shared_bytes(N, 2, P, D, 12, tables) == 217088
        assert K.k4_shared_bytes(N, 2, P, D, 16, tables) > MAX


def test_rule_reads_only_the_shape():
    """The same shape gives the same layout, whatever was asked before, and
    the SM count decides where two ciphertexts share a load."""
    params = get_params("small_v2")
    plan = bs.bootstrap_plan(params)
    first = [K.k4_layout(b, params, plan, 1, SMS) for b in (512, 1, 133, 512)]
    assert first[0] == first[3]
    assert K.k4_layout(133, params, plan, 1, 144)["group"] == 1
    assert K.k4_layout(145, params, plan, 1, 144)["group"] == 2
    # a bundled key at N = 2048 has a layout; one of an odd number of rounds
    # cannot be paired
    assert K.k4_layout(512, get_params("small_v2_n2048"), None, 2, SMS)["group"] == 1
    with pytest.raises(ValueError):
        K.k4_layout(512, dataclasses.replace(params, n=351), plan, 2, SMS)


def test_bundled_n2048_fits_only_with_its_accumulators_on_r2():
    """Bundled small_v2_n2048: 60 digit rows, one prime's stage tables at a
    time, refilled half by half with the next prime's while the block runs
    on.  With the accumulators in their own words the smallest chunk takes
    233,472 B, 1,024 over what a block may have; on r2 (32 KB of inverse
    results, idle between rounds, holding 16 KB of accumulators) rows run in
    chunks of 8: 32 + 68 + 48 + 32 + 32 KB."""
    params = get_params("small_v2_n2048")
    plan = bs.bootstrap_plan(params, True)
    assert plan.primes == (12289, 40961) and 3 * params.decomp_rows == 60
    assert K.k4_shared_bytes(2048, 1, 2, 3, 4, 1) == 233472 == MAX + 1024
    lay = K.k4_layout(512, params, plan, 2, SMS)
    assert lay["accumulators_on_r2"] and lay["chunk_rows"] == 8
    assert lay["tables_refilled"] and not lay["tables_resident"]
    assert lay["shared_bytes"] == K.k4_shared_bytes(2048, 1, 2, 3, 8, 1, True) == 217088
    assert 217088 == 32768 + 69632 + 49152 + 32768 + 32768
    assert K.k4_shared_bytes(2048, 1, 2, 3, 12, 1, True) > MAX  # chunks of 12 do not fit
    assert (2 - 1) * 8 * 2048 * 2 >= 2 * 2048 * 4  # r2 holds the accumulators


@pytest.mark.parametrize("N,P,bundle", [i for i in INSTANCES if i != (2048, 2, 2)])
def test_every_earlier_instance_keeps_its_bytes(N, P, bundle):
    """Every instance built before the bundled N = 2048 one keeps its
    accumulators in their own words, so its layout and bytes are unchanged;
    the one exception is the instance built since, bundled N = 1024 at three
    primes and two ciphertexts a block, which fits only with the accumulators
    on r2 and the last prime's sums on the differences."""
    params, plan = _instance(N, P, bundle)
    D = 3 if bundle == 2 else 1
    for batch in (1, 5, 132, 133, 512):
        lay = K.k4_layout(batch, params, plan, bundle, SMS)
        tables = P if lay["tables_resident"] else 1
        if (N, P, bundle, lay["group"]) == (1024, 3, 2, 2):
            assert lay["accumulators_on_r2"] and lay["sums_on_differences"]
            assert lay["shared_bytes"] == K.k4_shared_bytes(N, 2, P, D, lay["chunk_rows"], 1,
                                                            True, True)
            continue
        assert not lay["accumulators_on_r2"] and not lay["sums_on_differences"]
        assert lay["shared_bytes"] == K.k4_shared_bytes(N, lay["group"], P, D,
                                                        lay["chunk_rows"], tables)


def test_bundled_tpu2_fits_two_a_block_only_with_its_sums_on_the_differences():
    """Bundled small_v2_tpu2 at two ciphertexts a block: 30 digit rows, three
    primes, one prime's stage tables at a time.  With the accumulators on r2
    the smallest chunk still takes 233,472 B, 1,024 over what a block may
    have, because the digit rows' region holds the G * 8 MAC sums (8 rows a
    ciphertext against a chunk's 4); with the last prime's sums on the three
    differences (dead once that prime's last forward transforms have cut
    their digits; the other primes' sums on r2) it holds the chunk's rows
    only: 16 + 68 + 48 + 16 + 64 KB in chunks of 4."""
    params = get_params("small_v2_tpu2")
    plan = bs.bootstrap_plan(params, True)
    assert len(plan.primes) == 3 and 3 * params.decomp_rows == 30
    assert K.k4_shared_bytes(1024, 2, 3, 3, 4, 1, True) == 233472 == MAX + 1024
    lay = K.k4_layout(512, params, plan, 2, SMS)
    assert (lay["group"], lay["chunk_rows"]) == (2, 4)
    assert lay["accumulators_on_r2"] and lay["sums_on_differences"]
    assert lay["tables_refilled"] and not lay["tables_resident"]
    assert lay["shared_bytes"] == K.k4_shared_bytes(1024, 2, 3, 3, 4, 1, True, True) == 217088
    assert 217088 == 16384 + 69632 + 49152 + 16384 + 65536
    assert K.k4_shared_bytes(1024, 2, 3, 3, 8, 1, True, True) > MAX  # chunks of 8 do not fit
    assert 3 * 2 * 2 * 1024 * 4 >= 2 * 8 * 1024 * 2  # the differences hold the sums
    # at one ciphertext a block (up to the SM count) every prime's tables stay
    one = K.k4_layout(132, params, plan, 2, SMS)
    assert (one["group"], one["chunk_rows"], one["tables_resident"]) == (1, 16, True)
    assert not one["accumulators_on_r2"] and not one["sums_on_differences"]


@pytest.mark.parametrize("name,bundle", [("small", 1), ("small_v2_tpu", 2),
                                         ("small_v2_tpu2", 2), ("small_v2_tpu", 1),
                                         ("small_v2", 1)])
def test_where_tables_are_refilled_at_n1024(name, bundle):
    """At N = 1024 one prime's tables, refilled by cp.async, where every
    prime's do not fit beside the smallest chunk: small, bundled
    small_v2_tpu and small_v2_tpu2 at two ciphertexts a block; every prime's
    stay at one a block and at small_v2_tpu and small_v2 (two primes)."""
    params = get_params(name)
    plan = bs.bootstrap_plan(params, bundle == 2)
    refilled = (name, bundle) in {("small", 1), ("small_v2_tpu", 2), ("small_v2_tpu2", 2)}
    lay = K.k4_layout(512, params, plan, bundle, SMS)
    assert lay["tables_refilled"] == refilled == (not lay["tables_resident"])
    N, P, D = params.N, len(plan.primes), 3 if bundle == 2 else 1
    assert (K.k4_shared_bytes(N, 2, P, D, 4, P) > MAX) == refilled
    for batch in (1, 32, 132):
        small = K.k4_layout(batch, params, plan, bundle, SMS)
        assert small["group"] == 1 and small["tables_resident"] and not small["tables_refilled"]
