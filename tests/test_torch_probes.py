"""The port's rotation and Toeplitz probes (plain twins of the CUDA kernels
in csrc/probes.cu, and the candidates of its two bench scripts) against the
JAX package's bench scripts on the same numpy-seeded inputs.  Tolerance: exact
equality of int32 arrays.

The JAX scripts' Pallas kernels take no interpret flag, so the JAX side of
the kernels' functions is ``rot_select11`` (what the script itself checks
them against) and, for the Toeplitz tile, the script's index loop."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redsec_tpu_torch.crypto import bootstrap as bs
from redsec_tpu_torch.crypto import probe_kernels as pk
from redsec_tpu_torch.crypto.params import SMALL_V2_TPU
from redsec_tpu_torch.device import launches
from redsec_tpu_torch.scripts import bench_rotate, bench_schoolbook

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1024
INT32_MIN = -2**31


@pytest.fixture(scope="module")
def jrot():
    """scripts/bench_rotate.py of the JAX package, imported by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_rotate", os.path.join(REPO, "scripts", "bench_rotate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed=0, extra=4):
    """Rows with t in {0, 1, N-1, N, N+1, 2N-1} plus random ones; INT32_MIN
    and INT32_MAX planted in every row."""
    rng = np.random.default_rng(seed)
    t = np.array([0, 1, N - 1, N, N + 1, 2 * N - 1]
                 + list(rng.integers(0, 2 * N, size=extra)), np.int32)
    x = rng.integers(-2**31, 2**31, size=(t.size, 2, N), dtype=np.int64).astype(np.int32)
    x[:, 0, 0] = INT32_MIN
    x[:, 1, N - 1] = INT32_MIN
    x[:, 0, 1] = 2**31 - 1
    return x, t


PORT_ROTATIONS = {
    "rotate_plain": pk.rotate_plain,
    "rotate_rows": pk.rotate_rows,  # on the CPU: the wrapper takes the twin
    "rotate_tile": lambda x, t: pk.rotate_tile(x, t, tile=5),
    "rot_select11": bench_rotate.rot_select11,
    "rot_select_r4": bench_rotate.rot_select_r4,
    "rot_ext_circ": bench_rotate.rot_ext_circ,
    "rot_gather": bench_schoolbook.rot_gather,
}


@pytest.mark.parametrize("name", sorted(PORT_ROTATIONS))
def test_rotation_equals_the_jax_script(jrot, name):
    x, t = _inputs()
    want = np.asarray(jrot.rot_select11(jnp.asarray(x), jnp.asarray(t)))
    before = dict(launches.counts)
    got = PORT_ROTATIONS[name](torch.as_tensor(x), torch.as_tensor(t)).numpy()
    np.testing.assert_array_equal(got, want)
    assert dict(launches.counts) == before  # a twin's run counts as no launch
    # INT32_MIN negates to itself: row 3 (t = N) is -x exactly
    assert got[3, 0, 0] == INT32_MIN and got[3, 0, 1] == -(2**31 - 1)


@pytest.mark.parametrize("name", ["rot_select_r4", "rot_ext_circ"])
def test_script_candidates_equal_their_jax_counterparts(jrot, name):
    x, t = _inputs(seed=1)
    want = np.asarray(getattr(jrot, name)(jnp.asarray(x), jnp.asarray(t)))
    got = getattr(bench_rotate, name)(torch.as_tensor(x), torch.as_tensor(t)).numpy()
    np.testing.assert_array_equal(got, want)


def test_rotate_plain_is_the_bootstrap_rotation_and_takes_any_t():
    x, t = _inputs(seed=2)
    xt, tt = torch.as_tensor(x), torch.as_tensor(t)
    assert torch.equal(pk.rotate_plain(xt, tt), bs.RoundOps(SMALL_V2_TPU).rotate(xt, tt))
    # any int32 exponent acts as t mod 2N
    assert torch.equal(pk.rotate_plain(xt, tt - 2 * N), pk.rotate_plain(xt, tt))
    assert torch.equal(pk.rotate_plain(xt, tt + 6 * N), pk.rotate_plain(xt, tt))


def test_rotate_tile_refuses_a_batch_its_tile_does_not_divide():
    x, t = _inputs()
    with pytest.raises(ValueError, match="multiple of the tile"):
        pk.rotate_tile(torch.as_tensor(x), torch.as_tensor(t), tile=4)
    with pytest.raises(ValueError, match="multiple of the tile"):
        pk.rotate_tile(torch.as_tensor(x), torch.as_tensor(t), tile=0)


def test_toeplitz_tile_plain_equals_the_jax_scripts_index_loop():
    w = np.random.default_rng(3).integers(-100, 100, size=(1, 256)).astype(np.int32)
    w[0, :2] = [INT32_MIN, 2**31 - 1]
    want = np.empty((128, 128), np.int32)
    for j in range(128):
        for k in range(128):
            want[j, k] = w[0, (127 + k - j) % 256]
    for fn in (pk.toeplitz_tile_plain, pk.toeplitz_tile):
        got = fn(torch.as_tensor(w))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    # the TPU kernel's formulation: row j is w rolled right by 129 + j
    rolled = np.stack([np.roll(w[0], 129 + j)[:128] for j in range(128)])
    np.testing.assert_array_equal(want, rolled)


def test_gen_toeplitz_and_the_round_equal_the_direct_product():
    rng = np.random.default_rng(4)
    n = 128
    be = torch.as_tensor(rng.integers(-128, 128, size=(3, 8, 2 * n)).astype(np.int8))
    m = bench_schoolbook.gen_toeplitz(be)
    assert m.shape == (3, 8, n, n)
    for j in (0, 1, n - 1):
        assert torch.equal(m[:, :, j, :], be[:, :, 1 + j: 1 + j + n])
    dig = torch.as_tensor(rng.integers(-4, 5, size=(2, 3, n)).astype(np.int8))
    got = dig.reshape(2, 3 * n).long() @ bench_schoolbook.toeplitz_matrix(be).long()
    want = bench_schoolbook.negacyclic_direct(dig.flip(-1), be)
    assert torch.equal(got.reshape(2, 8, n), want)


def test_rot_onehot_equals_select_on_values_bf16_holds():
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.integers(-256, 257, size=(7, 2, 256)).astype(np.int32))
    t = torch.as_tensor(np.array([0, 1, 127, 128, 255, 256, 511], np.int32))
    got = bench_schoolbook.rot_onehot(x, t, bench_schoolbook.onehot_tables(x.device))
    assert torch.equal(got, bench_rotate.rot_select11(x, t))


def test_bench_rotate_main_runs_to_the_end_on_the_cpu(capsys):
    times = bench_rotate.main(["--device", "cpu", "--batch", "8", "--iters", "1"])
    assert set(times) == {"select11", "select-r4", "ext-circ", "cuda-rows"}
    out = capsys.readouterr().out
    assert "cuda-tile64 not run" in out and "cuda-rows correct: True" in out
    times = bench_rotate.main(["--device", "cpu", "--batch", "64", "--iters", "1"])
    assert "cuda-tile64" in times and "cuda-tile256" not in times


def test_bench_schoolbook_main_runs_to_the_end_on_the_cpu(capsys, monkeypatch):
    """At N = 128: the full-width operands (hundreds of MB) belong on the card."""
    monkeypatch.setattr(bench_schoolbook, "N", 128)
    times = bench_schoolbook.main(["--device", "cpu", "--batch", "8", "--iters", "1"])
    expect = {"mm-bf16", "gen-shear-int8", "round-bf16", "conv-bf16", "rot-select",
              "rot-gather", "rot-onehot", "toeplitz-cuda"}
    if bench_schoolbook.has_int_mm(torch.device("cpu")):
        expect |= {"mm-int8", "round-int8"}
    assert set(times) == expect
    out = capsys.readouterr().out
    for line in ("gen_toeplitz == sliding windows: True", "rot gather == select: True",
                 "rot onehot == select", "toeplitz_tile correct: True"):
        assert line in out


def test_bench_scripts_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    for mod in (bench_rotate, bench_schoolbook):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main([])
