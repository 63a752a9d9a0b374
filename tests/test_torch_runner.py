"""The port's batch runner (``redsec_tpu_torch/scripts/run_encrypted_mnist.py``)
against the JAX package's ``scripts/run_encrypted_mnist.py``: checkpoint,
resume, extension, evaluation offset, the refusal of another configuration,
and the fingerprint, key for key.

A synthetic reference in the reference's layout: ``mnist/sign1024x1`` packed
weights (the real 196 -> 1024 -> 10 geometry, written with the port's
``formats/varprep`` writer) and a 4-row ``mnist_data.csv`` of near-gray
pixels, so the noiseless ``test_noiseless`` set's 1024-slot message space
holds every boundary.  Random weights have near-zero margins, so every run
passes ``--max-flip 1`` (the JAX script's ``REDSEC_MAX_FLIP=1``): the
contract here is determinism, not agreement.  Runs go in the cold time mode
(no warm-up pass) to keep the file short; the key cache of both packages is
this module's temporary directory, never the repository's ``.keys/``.

The JAX script writes a 2-image checkpoint in a subprocess; the port extends
it to 4 images and leaves the JAX batch untouched.  Most checks read the
runs of that one file, made once for the module.  Held-out and persisted
calibration are in ``test_torch_runner_calib.py``, so that the two files'
PBS run in parallel under ``pytest -n``.
"""

import ast
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from redsec_tpu_torch.formats import keys as kio
from redsec_tpu_torch.formats.varprep import VarPrepWriter
from redsec_tpu_torch.scripts import run_encrypted_mnist as runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "mnist/sign1024x1"

torch.set_num_threads(2)

# runs the JAX script with the JAX package's key cache in argv[1]
JAX_RUN = (
    "import os, runpy, sys\n"
    "import redsec_tpu.formats.keys as k\n"
    "d = sys.argv.pop(1)\n"
    "k.keyset_dir = lambda base=None: (os.makedirs(d, exist_ok=True), d)[1]\n"
    "sys.argv[0] = os.path.join({repo!r}, 'scripts', 'run_encrypted_mnist.py')\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n"
).format(repo=REPO)


def make_reference(root, rng):
    """``root/nets/mnist/sign1024x1/var_prep.dat`` (layer 0 pool/sign bias,
    then ternary weights and int32 biases of both FC layers) and a 4-row
    ``root/nets/mnist/mnist_data.csv``."""
    net = root / "nets" / "mnist" / "sign1024x1"
    net.mkdir(parents=True)
    wr = VarPrepWriter()
    wr.write_i32(np.array([0]))
    wr.write_tern(rng.choice([-1, 0, 1], size=196 * 1024, p=[0.2, 0.6, 0.2]))
    wr.write_i32(rng.integers(-8, 9, size=1024))
    wr.write_tern(rng.choice([-1, 0, 1], size=1024 * 10, p=[0.2, 0.6, 0.2]))
    wr.write_i32(rng.integers(-8, 9, size=10))
    (net / "var_prep.dat").write_bytes(wr.getvalue())
    rows = [f"{i % 10}," + ",".join(str(v) for v in rng.integers(120, 136, size=28 * 28))
            for i in range(4)]
    (root / "nets" / "mnist" / "mnist_data.csv").write_text("\n".join(rows) + "\n")


@contextlib.contextmanager
def reference(tmp_path_factory):
    """A synthetic reference under a new temporary directory, with the port's
    key cache (``keyset_dir``) pointed into it; -> (root, key directory)."""
    root = tmp_path_factory.mktemp("runner")
    make_reference(root, np.random.default_rng(7))
    keys = root / "keys"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kio, "keyset_dir", lambda base=None: (os.makedirs(keys, exist_ok=True),
                                                         str(keys))[1])
        yield root, keys


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The reference, this module's key cache and the JAX script's 2-image
    checkpoint."""
    with reference(tmp_path_factory) as (root, keys):
        yield jax_checkpoint(root, keys)


def jax_checkpoint(root, keys):
    jck = root / "jax.ckpt.json"
    jenv = {k: v for k, v in os.environ.items() if not k.startswith("REDSEC_")}
    jenv.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", REDSEC_DEVICE="cpu",
                REDSEC_ROUND_KERNEL="0", REDSEC_MAX_FLIP="1", REDSEC_TIME_MODE="cold")
    res = subprocess.run([sys.executable, "-c", JAX_RUN, str(keys), *base_args(root, 2),
                          "--checkpoint", str(jck)],
                         capture_output=True, text=True, cwd=str(root), env=jenv, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return {"root": root, "jck": jck, "jax_state": json.loads(jck.read_text()), "jenv": jenv,
            "keys": keys}


def base_args(root, images, batch=2):
    return ["--images", str(images), "--batch", str(batch), "--model", MODEL,
            "--params", "test_noiseless", "--reference", str(root)]


def run(root, images, *extra, batch=2):
    """The port's runner in process on the CPU; -> (returned dict, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = runner.main([*base_args(root, images, batch), "--max-flip", "1",
                           "--time-mode", "cold", "--device", "cpu", *extra])
    return res, buf.getvalue()


def batches(path):
    return {k: v["preds"] for k, v in json.loads(path.read_text())["batches"].items()}


@pytest.fixture(scope="module")
def extended(env):
    """The port extends a copy of the JAX script's checkpoint to 4 images."""
    ck = env["root"] / "extended.ckpt.json"
    shutil.copy(env["jck"], ck)
    res, out = run(env["root"], 4, "--checkpoint", str(ck))
    return {"ck": ck, "res": res, "out": out, "state": json.loads(ck.read_text())}


@pytest.fixture(scope="module")
def resumed(env, extended):
    """The extended file with the JAX batch dropped, resumed by the port."""
    ck = env["root"] / "resumed.ckpt.json"
    state = json.loads(extended["ck"].read_text())
    del state["batches"]["0"]
    ck.write_text(json.dumps(state))
    res, out = run(env["root"], 4, "--checkpoint", str(ck))
    return {"ck": ck, "res": res, "out": out}


def test_port_extends_a_jax_checkpoint_and_leaves_its_batch_untouched(env, extended):
    jstate, state = env["jax_state"], extended["state"]
    assert "extended 2 -> 4 images" in extended["out"]
    assert sorted(state["batches"]) == ["0", "2"]
    assert state["batches"]["0"] == jstate["batches"]["0"]  # preds and seconds
    assert state["fingerprint"] == {**jstate["fingerprint"], "images": 4}
    assert extended["res"]["batches_run"] == [2]
    assert extended["res"]["preds"][:2] == jstate["batches"]["0"]["preds"]
    assert "resumed_batches=1" in extended["out"].splitlines()[-1]


def test_a_fresh_port_run_gives_the_jax_batch_and_resume_is_bit_identical(env, extended,
                                                                          resumed):
    """Dropping the JAX batch and resuming recomputes those 2 images from
    scratch in the port: the same predictions as the JAX script's, and the
    port's own batch kept as it was."""
    got = batches(resumed["ck"])
    assert got == {k: v["preds"] for k, v in extended["state"]["batches"].items()}
    assert got["0"] == env["jax_state"]["batches"]["0"]["preds"]
    assert "resuming: 1 batch(es) already done [2]" in resumed["out"]
    assert resumed["res"]["batches_run"] == [0]
    keep = ("oracle_", "accuracy", "resumed_")
    res1, res2 = extended["out"].splitlines()[-1], resumed["out"].splitlines()[-1]
    assert [f for f in res1.split() if f.startswith(keep)] == \
        [f for f in res2.split() if f.startswith(keep)]


def test_eval_offset_reproduces_rows_2_to_4(env, extended):
    res, out = run(env["root"], 2, "--eval-offset", "2")
    line = [ln for ln in out.splitlines() if ln.startswith("encrypted preds")][0]
    assert line.split(":")[1].strip() == str(extended["state"]["batches"]["2"]["preds"])
    assert res["fingerprint"]["eval_offset"] == 2
    assert out.splitlines()[-1].startswith("RESULT ") and "eval_offset=2" in out


def test_another_configuration_is_refused(env, extended):
    with pytest.raises(SystemExit, match="different configuration"):
        run(env["root"], 4, "--checkpoint", str(extended["ck"]), "--input-gain")
    with pytest.raises(SystemExit, match="different configuration"):
        run(env["root"], 4, "--checkpoint", str(extended["ck"]), batch=4)


def test_fingerprint_equals_jax_key_for_key(env):
    """Both packages refuse the JAX script's checkpoint under the same other
    configuration, and print the same fingerprint for it; the default
    configuration's fingerprint is the one the JAX script wrote."""
    root, jck = env["root"], env["jck"]
    args = runner.build_parser().parse_args(base_args(root, 2))
    vp = os.path.join(str(root), "nets", MODEL, "var_prep.dat")
    assert runner.fingerprint_for(args, 2, vp, "eval-rows(leaky)") == \
        env["jax_state"]["fingerprint"]

    other = ["--eval-offset", "2", "--calib-rows", "0:2", "--jit", "layer"]
    jenv = dict(env["jenv"], REDSEC_INPUT_GAIN="1", REDSEC_MAJORITY_PLAN="0:3")
    res = subprocess.run([sys.executable, "-c", JAX_RUN, str(env["keys"]), *base_args(root, 2),
                          *other, "--checkpoint", str(jck)],
                         capture_output=True, text=True, cwd=str(root), env=jenv, timeout=600)
    assert res.returncode != 0 and "different configuration" in res.stderr
    want = ast.literal_eval(res.stderr.strip().splitlines()[-1].strip())
    with pytest.raises(SystemExit) as exc:
        run(root, 2, *other, "--input-gain", "--majority-plan", "0:3", "--checkpoint", str(jck))
    got = ast.literal_eval(str(exc.value.code).strip().splitlines()[-1].strip())
    assert got == want
    assert list(got) == list(want)
    assert want["calib"] == "heldout:0:2" and want["eval_offset"] == 2
    assert (want["input_gain"], want["majority_plan"], want["jit"]) == ("1", "0:3", "layer")
