"""The port's BYON toolchain (netlist wizard, netlist compiler, weight
convert) against the JAX package's on the same inputs.  Tolerance: identical
text and bytes (the Larq script apart from its header comment)."""

import io
import json
import os

import numpy as np
import pytest

from redsec_tpu.compiler import netlist as jnetlist
from redsec_tpu.compiler import weight_convert as jwc
from redsec_tpu.compiler import wizard as jwizard
from redsec_tpu.models.zoo import get_model as jget_model
from redsec_tpu_torch.compiler import netlist, weight_convert, wizard
from redsec_tpu_torch.models.zoo import get_model
from test_torch_slice import jax_spec
from test_weight_convert import synthetic_var_dat1

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a conv net: 16x16x1 input, conv+maxpool, conv+sumpool+relu, fc+relu, classifier
ANSWERS = ["16", "16", "1", "8", "4",
           "conv", "8", "3", "3", "y", "0.05", "max", "y", "sign",
           "conv", "8", "3", "3", "n", "0.1", "sum", "y", "relu", "3",
           "fc", "32", "0.05", "none", "y", "relu", "2",
           "10"]


def _wizard(mod):
    out = io.StringIO()
    csv = mod.run_wizard(io.StringIO("\n".join(ANSWERS) + "\n"), out)
    return csv, out.getvalue()


def test_both_wizards_write_the_same_netlist_from_the_same_stdin():
    csv, prompts = _wizard(wizard)
    assert (csv, prompts) == _wizard(jwizard)
    assert csv.count("\n") == 4 and "MaxPooling" in csv and "ReLU(3)" in csv
    # an all-default session too
    blank = io.StringIO("\n" * 40)
    assert wizard.run_wizard(blank, io.StringIO()) == jwizard.run_wizard(
        io.StringIO("\n" * 40), io.StringIO())


def test_both_wizards_enforce_the_style_guide():
    for mod in (wizard, jwizard):
        with pytest.raises(ValueError, match="MaxPool requires Sign"):
            mod.build_netlist((8, 8, 1, 8), [mod.WizardLayer("conv", 4, pool="max",
                                                             activation="relu"),
                                             mod.WizardLayer("fc", 10, bnorm=False)])


def test_parse_and_compile_give_equal_specs(tmp_path):
    csv, _ = _wizard(wizard)
    path = tmp_path / "net.csv"
    path.write_text(csv)
    spec = netlist.parse_netlist(str(path), "byon")
    jspec = jnetlist.parse_netlist(str(path), "byon")
    d = netlist.spec_to_json(spec)
    assert d == jnetlist.spec_to_json(jspec)
    assert netlist.spec_to_json(netlist.spec_from_json(json.loads(json.dumps(d)))) == d
    assert jnetlist.spec_to_json(jax_spec(netlist.spec_from_json(d))) == d

    out = {}
    for tag, mod in (("t", netlist), ("j", jnetlist)):
        res = mod.compile_netlist(str(path), "byon", out_dir=str(tmp_path / tag))
        assert res["layers"] == 4
        out[tag] = (open(res["spec"]).read(), open(res["train_script"]).read().splitlines())
    assert out["t"][0] == out["j"][0]
    assert out["t"][1][0] == "# Auto-generated by redsec_tpu_torch.compiler (Larq training twin)"
    assert out["t"][1][1:] == out["j"][1][1:]


@pytest.mark.parametrize("name", ["mnist/sign1024x1", "mnist/relu1024x1",
                                  "cifar/binarynet_small"])
def test_weight_convert_gives_identical_bytes(name):
    raw = synthetic_var_dat1(jget_model(name), seed=7)
    got = weight_convert.weight_convert(get_model(name), raw)
    assert got == jwc.weight_convert(jget_model(name), raw)
    if name.startswith("cifar"):  # and the committed trained dump gives the committed file
        net = os.path.join(REPO, "nets_trained", name)
        got = weight_convert.weight_convert(get_model(name), os.path.join(net, "var.dat1"))
        assert got == open(os.path.join(net, "var_prep.dat"), "rb").read()
    arrays = [np.frombuffer(raw, "<f4")[:100], np.arange(5, dtype=np.float64)]
    assert weight_convert.export_var_dat1(arrays) == jwc.export_var_dat1(arrays)
