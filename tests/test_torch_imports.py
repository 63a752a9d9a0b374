"""The port stands alone: importing it pulls in neither JAX nor anything of
the JAX package, its entry points default to CUDA and raise without it, and
torch's int32 arithmetic wraps the way the torus arithmetic relies on."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import redsec_tpu_torch
from redsec_tpu_torch import device
from redsec_tpu_torch.crypto import bootstrap as bs
from redsec_tpu_torch.crypto import keygen as kg
from redsec_tpu_torch.crypto.params import TEST_NOISELESS
from redsec_tpu_torch.models.spec import prep_model
from redsec_tpu_torch.models.zoo import get_model
from redsec_tpu_torch.runtime import ptxt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(redsec_tpu_torch.__file__)


def test_import_leaves_jax_and_the_jax_package_out():
    code = (
        "import sys\n"
        "import redsec_tpu_torch, redsec_tpu_torch.convert\n"
        "import redsec_tpu_torch.runtime.encrypted, redsec_tpu_torch.crypto.kernels\n"
        "import redsec_tpu_torch.runtime.calibration, redsec_tpu_torch.crypto.probe_kernels\n"
        "import redsec_tpu_torch.scripts.bench_rotate, redsec_tpu_torch.scripts.bench_schoolbook\n"
        "import redsec_tpu_torch.cli, redsec_tpu_torch.__main__, redsec_tpu_torch.formats.keys\n"
        "import redsec_tpu_torch.formats.image_io, redsec_tpu_torch.utils.debug\n"
        "import redsec_tpu_torch.compiler.netlist, redsec_tpu_torch.compiler.weight_convert\n"
        "import redsec_tpu_torch.compiler.wizard, redsec_tpu_torch.crypto.gates\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'redsec_tpu' or m.startswith('redsec_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""


def test_no_source_file_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax|redsec_tpu)(?:\.|\s|$)", re.M)
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                if pat.search(open(path).read()):
                    offenders.append(os.path.relpath(path, REPO))
    assert offenders == []


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve_device()
    _, cloud = kg.keygen(TEST_NOISELESS, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        bs.prepare_cloud_key(cloud)
    plan = prep_model(get_model("mnist/sign1024x1"), os.path.join(
        REPO, "tests", "golden", "sign1024x1_var_prep_from_ref_wght.dat"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ptxt.build_forward(plan)
    assert device.resolve_device("cpu") == torch.device("cpu")


def test_torch_int32_add_and_mul_wrap_mod_2_32():
    rng = np.random.default_rng(0)
    a = rng.integers(-2**31, 2**31, size=4096, dtype=np.int64)
    b = rng.integers(-2**31, 2**31, size=4096, dtype=np.int64)
    a[:4] = [2**31 - 1, -2**31, 2**31 - 1, -2**31]
    b[:4] = [1, -1, 2**31 - 1, -2**31]

    def wrap(x):
        return ((x + 2**31) % 2**32 - 2**31).astype(np.int32)

    ta, tb = torch.as_tensor(wrap(a)), torch.as_tensor(wrap(b))
    np.testing.assert_array_equal((ta + tb).numpy(), wrap(a + b))
    np.testing.assert_array_equal((ta - tb).numpy(), wrap(a - b))
    prod = (a.astype(object) * b.astype(object))
    np.testing.assert_array_equal((ta * tb).numpy(),
                                  np.array([((int(v) + 2**31) % 2**32) - 2**31 for v in prod],
                                           np.int32))
    np.testing.assert_array_equal((-ta).numpy(), wrap(-a))
    # arithmetic right shift on int32 (the masked-shift decompositions rely on it)
    np.testing.assert_array_equal((ta >> 7).numpy(), (wrap(a).astype(np.int64) >> 7))
