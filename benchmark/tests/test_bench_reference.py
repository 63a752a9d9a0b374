"""The reference against the port, on the CPU: the same PBS words at four
parameter sets (both blind-rotation paths), the same weights, the same
encoding gains; and it imports nothing of the program."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import keys
from benchmark.reference import net as refnet
from benchmark.reference.tfhe import Reference
from benchmark.tests import helpers
from redsec_tpu_torch.crypto.bootstrap import make_batched_bootstrap, prepare_cloud_key
from redsec_tpu_torch.crypto.keygen import CloudKey
from redsec_tpu_torch.crypto.params import TfheParams, get_params
from redsec_tpu_torch.models.spec import prep_model
from redsec_tpu_torch.models.zoo import get_model
from redsec_tpu_torch.runtime.encrypted import build_encrypted_forward

WEIGHTS = os.path.join(helpers.REPO, "benchmark", "weights", "sign1024x1_var_prep.dat")
NET = [{"sumpool": 2, "activation": "sign"}, {"fc": 1024, "activation": "sign"},
       {"fc": 10, "activation": "none"}]


def _params(name: str, n: int) -> dict:
    p = get_params(name)
    return {f: getattr(p, f) for f in ("name", "n", "N", "k", "bg_bit", "l", "ks_basebit",
                                       "ks_t", "alpha_ks", "alpha_bk", "alpha_enc",
                                       "msg_space")} | {"n": n}


@pytest.mark.parametrize("name,n", [("test_noiseless", 6), ("small_v2_tpu", 3), ("small_v2", 2),
                                    ("medium_v2", 2)])
def test_pbs_equals_the_port(name, n):
    p = _params(name, n)
    g = keys.generator(11, "cpu")
    k = keys.keygen(p, g, "cpu")
    ct = keys.uniform32(g, (37, n + 1), "cpu")
    tv = keys.uniform32(g, (p["N"],), "cpu")
    dkey = prepare_cloud_key(CloudKey(TfheParams(**p), k["bk"], k["ksk"]), "cpu")
    got = make_batched_bootstrap(dkey)(ct, tv)
    ref = Reference(p, k["bk"], k["ksk"], "cpu")
    assert torch.equal(ref.bootstrap(ct, tv), got)
    assert float(ref.max_rounding) < 1e-3


def test_weights_and_gains_equal_the_port():
    plan = prep_model(get_model("mnist/sign1024x1"), WEIGHTS)
    layers = refnet.read_net(WEIGHTS, NET, [28, 28, 1])
    assert layers[0][0] is None and np.array_equal(layers[0][1], plan.layers[0].quant.bias)
    for i in (1, 2):
        w = plan.layers[i].conv.weights
        assert np.array_equal(layers[i][0], w.reshape(-1, w.shape[-1]))
        assert np.array_equal(layers[i][1], plan.layers[i].quant.bias)
    p = _params("small_v2_tpu", 2)
    dkey = prepare_cloud_key(CloudKey(TfheParams(**p), *[keys.keygen(
        p, keys.generator(3, "cpu"), "cpu")[x] for x in ("bk", "ksk")]), "cpu")
    info = build_encrypted_forward(plan, dkey).info
    assert refnet.gains(NET, layers, 4096) == [info[i].out_gain for i in range(3)] == [4, 1, 1]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.net, benchmark.reference.tfhe, "
            "benchmark.keys, benchmark.counts, benchmark.traffic, benchmark.trace; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('redsec_tpu_torch', "
            "'redsec_tpu', 'jax')]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=helpers.REPO, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": helpers.REPO})
    assert res.returncode == 0, res.stdout + res.stderr
