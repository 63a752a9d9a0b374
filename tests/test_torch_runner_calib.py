"""The port's batch runner (``redsec_tpu_torch/scripts/run_encrypted_mnist.py``):
``--calib-rows`` refused where it overlaps the evaluated rows, a held-out
calibration saved with ``--save-calib``, and a run that restores it with
``--load-calib`` giving the same predictions.  The synthetic reference and the
in-process runs are ``test_torch_runner.py``'s (``test_noiseless``, the real
``sign1024x1`` geometry, the key cache in a temporary directory); this file
holds only what needs no JAX checkpoint, so that it runs beside that one."""

import pytest
import torch

from test_torch_runner import reference, run

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    with reference(tmp_path_factory) as (root, _):
        yield root


def test_calib_rows_overlap_is_refused_and_held_out_calibration_persists(root, tmp_path):
    with pytest.raises(SystemExit, match="overlaps the evaluated rows"):
        run(root, 2, "--calib-rows", "1:3")
    art = tmp_path / "calib.npz"
    saved, out = run(root, 1, "--calib-rows", "2:4", "--save-calib", str(art), batch=1)
    assert "calibrated on 2 HELD-OUT rows (2:4)" in out and art.exists()
    assert saved["calib"] == "heldout:2:4" and saved["fingerprint"]["calib"] == "heldout:2:4"
    loaded, out = run(root, 1, "--load-calib", str(art), batch=1)
    assert loaded["calib"] == "artifact:calib.npz"
    assert loaded["preds"] == saved["preds"]
    assert "calib=artifact:calib.npz" in out.splitlines()[-1]
