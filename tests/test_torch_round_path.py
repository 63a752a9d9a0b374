"""The JAX package's per-round Pallas path (``REDSEC_ROUND_KERNEL=1`` and
``=partial``) in the port: ``round_kernel="full"`` and ``"partial"`` of
``make_bootstrap_impl`` and the entry points above it, against the JAX
package on the CPU (where the wrappers run their twins), the refusals
outside the one-round kernels' envelope, and the round kernels' layout rule
(``kernels.round_mm_layout``, the mirror of ``csrc/blind_mm.cu``'s
``split_smem_bytes``) with the rule that picks blocks a ciphertext.  The
kernels themselves are held against their twins on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redsec_tpu.crypto import bootstrap as jbs
from redsec_tpu.crypto import keygen as jkg
from redsec_tpu.crypto import params as jparams
from redsec_tpu_torch import cli
from redsec_tpu_torch.crypto import bootstrap as bs
from redsec_tpu_torch.crypto import kernels as K
from redsec_tpu_torch.crypto import keygen as kg
from redsec_tpu_torch.crypto import lwe
from redsec_tpu_torch.crypto.params import (
    MEDIUM, SMALL_V2, SMALL_V2_N2048, SMALL_V2_TPU, SMALL_V2_TPU2, TEST_NOISELESS,
)
from redsec_tpu_torch.models.spec import prep_model
from redsec_tpu_torch.runtime.encrypted import build_encrypted_forward
from test_torch_cli import _run, work  # noqa: F401  (the CLI fixture)
from test_torch_relu import mini_maxpool_model

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def noiseless():
    """TEST_NOISELESS keys of both packages (seed 7), the port's "matmul"
    key, 6 ciphertexts (numpy seed 3) and the constant test vector."""
    P = TEST_NOISELESS
    sk, cloud = kg.keygen(P, seed=7)
    _, jcloud = jkg.keygen(jparams.TEST_NOISELESS, seed=7)
    mk = bs.prepare_cloud_key(cloud, device="cpu", ntt_flavor="matmul")
    rng = np.random.default_rng(3)
    ct = lwe.encrypt_integers(sk.lwe_key, rng.integers(-300, 300, size=6), P, rng)
    return cloud, jcloud, mk, ct, bs.const_test_vector(P, 1, P.msg_space)


def _jax_pbs(jcloud, ct, tv, monkeypatch, round_kernel: str | None = None):
    monkeypatch.setenv("REDSEC_NTT", "matmul")
    if round_kernel is not None:
        monkeypatch.setenv("REDSEC_ROUND_KERNEL", round_kernel)
    jdkey = jbs.prepare_cloud_key(jcloud)
    assert jdkey.ntt_flavor == "matmul"
    return np.asarray(jbs.make_batched_bootstrap(jdkey)(jnp.asarray(ct), jnp.asarray(tv)))


@pytest.mark.parametrize("round_kernel", ["full", "partial"])
def test_round_kernel_pbs_equals_jax(noiseless, monkeypatch, round_kernel):
    """One launch (on the CPU one twin call) a round: n calls of K3-mm for
    "full", of K2-mm for "partial", none of K4-mm; the PBS equals the JAX
    package's on the same "matmul" key bit for bit."""
    _, jcloud, mk, ct, tv = noiseless
    want = _jax_pbs(jcloud, ct, tv, monkeypatch)
    calls = {"cmux_round_mm": 0, "external_product_mm": 0, "blind_rotate_mm": 0}

    def door(name):
        real = getattr(K, name)

        def spy(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return spy

    for name in calls:
        monkeypatch.setattr(K, name, door(name))
    got = bs.make_batched_bootstrap(mk, round_kernel=round_kernel)(torch.as_tensor(ct), tv)
    np.testing.assert_array_equal(got.numpy(), want)
    n = TEST_NOISELESS.n
    assert calls == {"cmux_round_mm": n if round_kernel == "full" else 0,
                     "external_product_mm": n if round_kernel == "partial" else 0,
                     "blind_rotate_mm": 0}


def test_chunked_round_kernel_equals_batched(noiseless):
    """``make_chunked_bootstrap`` runs the same rounds chunk by chunk."""
    _, _, mk, ct, tv = noiseless
    want = bs.make_batched_bootstrap(mk)(torch.as_tensor(ct), tv)
    got = bs.make_chunked_bootstrap(mk, chunk=4, round_kernel="full")(torch.as_tensor(ct), tv)
    assert torch.equal(got, want)


@pytest.mark.slow
@pytest.mark.parametrize("env,round_kernel", [("1", "full"), ("partial", "partial")])
def test_round_kernel_equals_jax_pallas_round_kernels(noiseless, monkeypatch, env,
                                                      round_kernel):
    """The JAX package's own per-round Pallas kernels in interpret mode
    (``REDSEC_ROUND_KERNEL``, tile 4) against the port's argument."""
    _, jcloud, mk, ct, tv = noiseless
    monkeypatch.setenv("REDSEC_ROUND_TILE", "4")
    want = _jax_pbs(jcloud, ct[:4], tv, monkeypatch, env)
    got = bs.make_batched_bootstrap(mk, round_kernel=round_kernel)(torch.as_tensor(ct[:4]), tv)
    np.testing.assert_array_equal(got.numpy(), want)


def _key(P, flavor="matmul", bundle=1):
    if P.n > 16:
        P = dataclasses.replace(P, n=2 * bundle)
    _, cloud = kg.keygen(P, seed=0, bundle=bundle)
    return bs.prepare_cloud_key(cloud, device="cpu", ntt_flavor=flavor)


@pytest.mark.parametrize("case", ["radix2", "schoolbook", "bundled", "n2048", "value"])
def test_round_kernel_refused_outside_its_envelope(case):
    """A radix-2 key, a schoolbook key (no NTT plan), a bundled "matmul" key,
    a "matmul" key at N = 2048 (no one-round kernel instance), and a value
    other than None, "full", "partial": each raises, where the JAX package's
    variable falls quietly back to its loop."""
    key = {"radix2": lambda: _key(TEST_NOISELESS, "radix2"),
           "schoolbook": lambda: _key(dataclasses.replace(MEDIUM, n=2), "radix2"),
           "bundled": lambda: _key(TEST_NOISELESS, bundle=2),
           "n2048": lambda: _key(SMALL_V2_N2048),
           "value": lambda: _key(TEST_NOISELESS)}[case]()
    rk = "fast" if case == "value" else "full"
    with pytest.raises(ValueError):
        bs.make_batched_bootstrap(key, round_kernel=rk)
    with pytest.raises(ValueError):
        bs.make_chunked_bootstrap(key, round_kernel="partial" if case != "value" else rk)
    if case != "bundled":  # the impl knows the key's bundling only at its call
        with pytest.raises(ValueError):
            bs.make_bootstrap_impl(key.params, key.plan, key.ntt_flavor, rk)


def test_round_kernel_with_escalation_needs_both_keys_inside(noiseless, tmp_path):
    """``escalate`` routes layers through a second key: a second key outside
    the envelope (radix-2 here) raises when the forward is built."""
    _, _, mk, _, _ = noiseless
    spec, blob = mini_maxpool_model(np.random.default_rng(0))
    path = tmp_path / "w.dat"
    path.write_bytes(blob)
    plan = prep_model(spec, str(path))
    build_encrypted_forward(plan, mk, round_kernel="full", range_check=False)
    radix = _key(TEST_NOISELESS, "radix2")
    with pytest.raises(ValueError):
        build_encrypted_forward(plan, mk, round_kernel="full", range_check=False,
                                escalate=({0}, radix))
    build_encrypted_forward(plan, mk, round_kernel="full", range_check=False,
                            escalate=({0}, mk))


def test_run_encrypted_round_kernel_equals_k4mm(work, capsys):  # noqa: F811
    """``run-encrypted --ntt-flavor matmul --round-kernel full`` writes the
    score file of the K4-mm run (itself equal to the radix-2 run's and
    JAX's, tests/test_torch_blind_mm.py); its JSON line counts K3-mm and
    K2-mm launches (0 on the CPU); refused with radix-2 keys ("partial" is
    held to JAX PBS by PBS above)."""
    d = work[0]
    common = ["--model", d / "mini_spec.json", "--weights", d / "weights.dat",
              "--eval", d / "j" / "eval.key.npz", "--device", "cpu"]
    _run(cli.main, capsys, "encrypt-image", "--secret", d / "j" / "secret.key.npz",
         "--image-ptxt", d / "img.ptxt", "--seed", "6", "--out", d / "rk_img.npz")
    recs = {}
    for rk in (None, "full"):
        extra = [] if rk is None else ["--round-kernel", rk]
        _, recs[rk] = _run(cli.main, capsys, "run-encrypted", *common, "--image",
                           d / "rk_img.npz", "--out", d / f"rk_{rk}.npz", "--ntt-flavor",
                           "matmul", *extra)
    a, b = np.load(d / "rk_None.npz"), np.load(d / "rk_full.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert recs["full"]["pbs"] == recs[None]["pbs"] == 16 + 64 + 16 + 6
    assert recs["full"]["k3mm_launches"] == recs["full"]["k2mm_launches"] == 0  # the CPU
    with pytest.raises(ValueError):  # --ntt-flavor radix2, the default
        cli.main(["run-encrypted", *map(str, common), "--image", str(d / "rk_img.npz"),
                  "--out", str(d / "rk_refused.npz"), "--round-kernel", "full"])


# --------------------------------------------------------------------------- #
# The layout rule and the split                                               #
# --------------------------------------------------------------------------- #


def test_round_mm_layout_bytes():
    """The byte counts csrc/blind_mm.cu's header states for the pair blocks,
    the ring at each set, and what each split takes."""
    lay = {(P.name, s): K.round_mm_layout(P, s)
           for P in (SMALL_V2_TPU, SMALL_V2, SMALL_V2_TPU2, TEST_NOISELESS) for s in (1, 2)}
    assert {k: v["shared_bytes"] for k, v in lay.items()} == {
        ("small_v2_tpu", 1): 225792, ("small_v2_tpu", 2): 188928,
        ("small_v2", 1): 212480, ("small_v2", 2): 224768,
        ("small_v2_tpu2", 1): 216832, ("small_v2_tpu2", 2): 179968,
        ("test_noiseless", 1): 129280, ("test_noiseless", 2): 88320}
    assert all(v["ring_rows"] == 4 for (_, s), v in lay.items() if s == 2)
    assert lay[("small_v2_tpu", 2)]["instance"] == "cmux_round_mm_pair_kernelILi1024EE"
    assert lay[("small_v2_tpu", 1)]["instance"] == "cmux_round_mm_kernelILi1024EE"
    assert lay[("small_v2", 2)]["rows_padded"] == 160  # 20 rows x R 8
    assert lay[("small_v2_tpu2", 2)]["rows_padded"] == 80  # the 8 inverse rows x R 8
    with pytest.raises(ValueError):
        K.round_mm_layout(SMALL_V2_N2048, 2)
    assert not K.round_mm_fits(1024, 12, 4)  # one block or a pair a ciphertext, no more


@pytest.mark.parametrize("N,rows", [(1024, r) for r in range(1, 27)]
                         + [(256, r) for r in (1, 2, 10, 20, 32, 64)])
def test_round_mm_splits_keep_the_envelope(N, rows):
    """Wherever one block a ciphertext fits, a pair fits (a block holds one
    prime's WC and its own ring of at least one row), within the card's
    232,448 B."""
    if not K.round_mm_fits(N, rows, 1):
        return
    assert K.round_mm_fits(N, rows, 2)
    assert not K.round_mm_fits(N, rows, 4)
    depth = K.round_mm_ring(N, rows)
    assert 1 <= depth <= min(K.MM_SPLIT_RING_MAX, rows)
    assert K.round_mm_shared_bytes(N, rows, 2) <= K.K4_MAX_SHARED


@pytest.mark.parametrize("M,want", [(1, 2), (3, 2), (30, 2), (31, 2), (32, 2), (64, 2),
                                    (66, 2), (67, 1), (132, 1), (133, 2), (264, 1), (512, 1)])
def test_round_mm_split_rule(M, want):
    """The rule at the H100's answers (132 blocks, 66 pairs at once, from its
    occupancy calculator): the least waves times a block's relative cost,
    ties to one block a ciphertext."""
    assert K.round_mm_split(M, {1: 132, 2: 66}) == want
