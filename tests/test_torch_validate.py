"""The port's validation scripts against the JAX package's scripts, exactly:
``validate_noise_budget.measure`` on the port's PBS (CPU twins) and on the
port's native core against the JAX script's own ``measure`` (its native
engine) at ``small_v2`` and the ``gadget21`` isolation variant with n cut to
16; the full-geometry function at ``medium`` with n cut to 16 against the
JAX script's ``main`` on the same cut set; and the experiment list, the count
caps, the PASS rule and the printed table against the JAX script's ``main``
with its measurement replaced by a fixed one.

Tolerance: exact equality.  The sigma values are floats computed the same way
from identical integers (keygen and encryption are the same seeded numpy in
both packages; a PBS is exact)."""

import ast
import contextlib
import dataclasses
import importlib.util
import io
import os
import sys

import pytest
import torch

from redsec_tpu import native as jnative
from redsec_tpu.crypto import params as jparams
from redsec_tpu_torch import native
from redsec_tpu_torch.crypto.params import MEDIUM
from redsec_tpu_torch.scripts import validate_full_geometry as vfg
from redsec_tpu_torch.scripts import validate_noise_budget as vnb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


def jax_script(name):
    """The JAX package's ``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_params(p):
    """The JAX package's TfheParams with the port's field values."""
    return jparams.TfheParams(**{f.name: getattr(p, f.name) for f in dataclasses.fields(p)
                                 if f.init})


def fields(p) -> dict:
    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}


@pytest.fixture
def needs_gxx():
    if not native.available():
        pytest.skip("no g++ on PATH: the native cores cannot be built")


@pytest.mark.parametrize("label", ["sv2/total", "sv2/gadget21"])
def test_measure_equals_jax_on_the_plain_path_and_the_native_core(label, needs_gxx):
    p = dataclasses.replace(dict((lb, q) for lb, q, _ in vnb.experiments(True))[label], n=16)
    want = jax_script("validate_noise_budget").measure(jax_params(p), 24, seed=3)
    for engine in vnb.ENGINES:
        got = vnb.measure(p, 24, 3, "cpu", engine)
        assert got[:3] == want[:3], engine
    assert want[2] > 0 or label == "sv2/total"  # gadget21's truncation decodes wrong


def test_full_geometry_equals_jax_at_medium_with_n_cut(needs_gxx, monkeypatch):
    """On the plain path (the schoolbook round's float64 twin) and on
    the port's native core."""
    p = dataclasses.replace(MEDIUM, n=16)
    jp = jax_params(p)
    monkeypatch.setattr(jparams, "get_params", lambda name: jp)
    monkeypatch.setattr(sys, "argv", ["validate_full_geometry.py", "--set", "medium",
                                      "--count", "12", "--seed", "2"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_script("validate_full_geometry").main()
    lines = buf.getvalue().splitlines()
    want = ast.literal_eval(lines[-1].split(" ", 1)[1])
    for engine in vnb.ENGINES:
        logged = []
        got = vfg.validate(p, 12, 2, "cpu", engine, log=logged.append)
        assert {k: v for k, v in got["result"].items() if k != "boots_per_s"} == \
            {k: v for k, v in want.items() if k != "boots_per_s"}, engine
        assert list(got["result"]) == list(want)
    signs = [ln for ln in lines if ln.startswith("signs:")]
    assert [ln for ln in logged if ln.startswith("signs:")] == signs
    assert [ln for ln in logged if ln.startswith(("output noise", "decode budget"))] == \
        [ln for ln in lines if ln.startswith(("output noise", "decode budget"))]
    got_signs, want_signs = (ast.literal_eval(part.strip().split(" -> ")[0])
                             for part in signs[0][len("signs: got"):].split(" want "))
    assert got["decode_errors"] == sum(a != b for a, b in zip(got_signs, want_signs))


@pytest.mark.parametrize("quick", [True, False])
def test_experiments_caps_and_table_equal_jax(quick, monkeypatch):
    """Both ``main``s with every measurement fixed at (0.05 slots, +0.001,
    1 error, 1 s): the same experiments, counts, predictions, verdicts and
    RESULT line, character for character."""
    mod = jax_script("validate_noise_budget")
    seen = []

    def fixed(p, n, *rest):
        seen.append((fields(p), n))
        return 0.05, 0.001, 1, 1.0

    monkeypatch.setattr(mod, "measure", fixed)
    monkeypatch.setattr(jnative, "available", lambda: True)
    argv = ["--count", "100"] + (["--quick"] if quick else [])
    monkeypatch.setattr(sys, "argv", ["validate_noise_budget.py", *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    want_out, want_seen = buf.getvalue(), list(seen)

    seen.clear()
    monkeypatch.setattr(vnb, "measure", fixed)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = vnb.main([*argv, "--device", "cpu"])
    assert buf.getvalue() == want_out
    assert seen == want_seen
    assert [n for _, n in seen] == [100] * 7 + ([] if quick else [64, 48])
    assert res["result"]["experiments"] == (7 if quick else 9)
