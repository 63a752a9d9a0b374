"""The port's command line against the JAX package's, both called in process
(``cli.main([...])``) at ``test_noiseless`` on a compiled mini spec: the same
key files, ciphertexts, score ciphertexts and printed lines, and files of
either side loading in the other.  Tolerance: exact equality."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from redsec_tpu import cli as jcli
from redsec_tpu.formats import keys as jkio
from redsec_tpu.models.spec import prep_model as jprep
from redsec_tpu.runtime import calibration as jcal
from redsec_tpu_torch import cli
from redsec_tpu_torch.compiler.netlist import spec_to_json
from redsec_tpu_torch.formats import keys as kio
from redsec_tpu_torch.formats.image_io import write_image_ptxt
from test_torch_relu import mini_maxpool_model
from test_torch_slice import jax_spec

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBCOMMANDS = ["keygen", "encrypt-image", "run-encrypted", "calibrate", "decrypt-image",
               "ptxt", "stats", "weight-convert", "netlist-wizard", "compile"]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A mini conv-sign-maxpool spec and weights, a CSV of 6 of its 8x8
    images, an MNIST-geometry CSV, one 8x8 image.ptxt, and a keyset written
    by each package's keygen."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    spec, blob = mini_maxpool_model(rng)
    (d / "weights.dat").write_bytes(blob)
    with open(d / "mini_spec.json", "w") as f:
        json.dump(spec_to_json(spec), f)
    with open(d / "data.csv", "w") as f:
        for label in range(6):
            f.write(f"{label}," + ",".join(str(v) for v in rng.integers(100, 156, size=64))
                    + "\n")
    with open(d / "mnist.csv", "w") as f:
        for label in range(3):
            f.write(f"{label}," + ",".join(str(v) for v in rng.integers(0, 256, size=784))
                    + "\n")
    write_image_ptxt(str(d / "img.ptxt"), 3, rng.integers(110, 145, size=(8, 8, 1)))
    for tag, main in (("t", cli.main), ("j", jcli.main)):
        main(["keygen", "--params", "test_noiseless", "--seed", "5", "--out-dir",
              str(d / tag)])
    return d, spec, blob


def _run(main, capsys, *argv):
    capsys.readouterr()
    ret = main([str(a) for a in argv])
    return capsys.readouterr().out, ret


def test_keygen_writes_the_same_key_files(work):
    d = work[0]
    for name in ("secret.key.npz", "eval.key.npz"):
        a, b = np.load(d / "t" / name), np.load(d / "j" / name)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}:{k}")


@pytest.mark.parametrize("source", ["ptxt", "csv"])
def test_encrypt_image_gives_equal_ciphertexts(work, capsys, source):
    d = work[0]
    src = (["--image-ptxt", d / "img.ptxt"] if source == "ptxt" else
           ["--csv", d / "mnist.csv", "--rows", "1,2", "--format", "mnist"])
    outs = {}
    for tag, main in (("t", cli.main), ("j", jcli.main)):
        outs[tag] = _run(main, capsys, "encrypt-image", "--secret", d / "j" / "secret.key.npz",
                         *src, "--seed", "9", "--out", d / f"{tag}_img.npz")[0]
    assert outs["t"].replace("t_img", "j_img") == outs["j"]
    a, b = kio.load_ciphertexts(d / "t_img.npz"), jkio.load_ciphertexts(d / "j_img.npz")
    np.testing.assert_array_equal(a[0], b[0])
    assert a[0].shape == ((1, 8, 8, 1, 65) if source == "ptxt" else (2, 28, 28, 1, 65))
    assert a[2] == b[2] == (3 if source == "ptxt" else 1)


def test_run_encrypted_on_jax_keys_equals_jax_and_the_rest_prints_the_same(work, capsys):
    d, spec, blob = work
    common = ["--model", d / "mini_spec.json", "--weights", d / "weights.dat"]
    # the client: an image encrypted by the JAX package
    _run(jcli.main, capsys, "encrypt-image", "--secret", d / "j" / "secret.key.npz",
         "--image-ptxt", d / "img.ptxt", "--out", d / "batch.npz")
    out_t, rec = _run(cli.main, capsys, "run-encrypted", *common, "--eval",
                      d / "j" / "eval.key.npz", "--image", d / "batch.npz",
                      "--out", d / "t_out.npz", "--device", "cpu")
    out_j, _ = _run(jcli.main, capsys, "run-encrypted", *common, "--eval",
                    d / "j" / "eval.key.npz", "--image", d / "batch.npz",
                    "--out", d / "j_out.npz")
    a, b = np.load(d / "t_out.npz"), np.load(d / "j_out.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["ct"].shape == (1, 3, 65)
    assert "Inference Time:" in out_t and "Inference Time:" in out_j
    assert json.loads(out_t.strip().splitlines()[-1]) == rec
    assert (rec["mode"], rec["images"], rec["k4_launches"]) == ("whole", 1, 0)
    assert rec["pbs"] == 16 + 64 + 16 + 6  # sign, conv sign, maxpool, fc sign

    # the client again: each package decrypts the other's scores alike
    for out in ("t_out.npz", "j_out.npz"):
        lines = [_run(main, capsys, "decrypt-image", "--secret", d / "j" / "secret.key.npz",
                      "--output", d / out)[0] for main in (cli.main, jcli.main)]
        assert lines[0] == lines[1] and lines[0].count("Classification Result:") == 1
    # and the plaintext side
    for argv in (["stats", *common], ["ptxt", *common, "--csv", d / "data.csv"]):
        got = _run(cli.main, capsys, *argv, *(["--device", "cpu"] if argv[0] == "ptxt"
                                              else []))[0]
        assert got == _run(jcli.main, capsys, *argv)[0]


def test_calibrate_writes_an_artifact_jax_loads(work, capsys):
    d, spec, blob = work
    argv = ["calibrate", "--model", d / "mini_spec.json", "--weights", d / "weights.dat",
            "--csv", d / "data.csv", "--rows", "0:6", "--params", "test_noiseless"]
    out_t = _run(cli.main, capsys, *argv, "--out", d / "t_cal.npz", "--device", "cpu")[0]
    out_j = _run(jcli.main, capsys, *argv, "--out", d / "j_cal.npz")[0]
    assert out_t.replace("t_cal", "j_cal") == out_j
    jplan = jprep(jax_spec(spec), blob)
    meta = jcal.load_calibration(str(d / "t_cal.npz"), jplan)
    assert meta == jcal.load_calibration(str(d / "j_cal.npz"), jprep(jax_spec(spec), blob))
    a, b = np.load(d / "t_cal.npz"), np.load(d / "j_cal.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_eval2_raises_and_the_module_offers_the_ten_subcommands(work, capsys):
    """A calibration that escalates needs --eval2: without it run-encrypted
    stops with the JAX package's message (tests/test_torch_escalation.py runs
    it with the second key)."""
    d = work[0]
    common = ["--model", d / "mini_spec.json", "--weights", d / "weights.dat"]
    _run(cli.main, capsys, "calibrate", *common, "--csv", d / "data.csv", "--rows", "0:6",
         "--params", "test_noiseless", "--escalate", "1", "--no-guard",
         "--out", d / "esc_cal.npz", "--device", "cpu")
    _run(jcli.main, capsys, "encrypt-image", "--secret", d / "j" / "secret.key.npz",
         "--image-ptxt", d / "img.ptxt", "--out", d / "esc_img.npz")
    with pytest.raises(SystemExit, match="pass --eval2 <eval key at small_v2_n2048"):
        cli.main([str(a) for a in ["run-encrypted", *common, "--eval", d / "j" / "eval.key.npz",
                                   "--image", d / "esc_img.npz", "--calib", d / "esc_cal.npz",
                                   "--device", "cpu"]])
    res = subprocess.run([sys.executable, "-m", "redsec_tpu_torch", "--help"],
                         capture_output=True, text=True, cwd=REPO, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    listed = res.stdout.split("{", 1)[1].split("}", 1)[0].split(",")
    assert sorted(listed) == sorted(SUBCOMMANDS)
