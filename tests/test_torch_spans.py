"""The port's spans and its upload counter (``device.span``,
``device.spans``, ``device.upload``): nothing recorded and no
``record_function`` entered while no profiler records; while one records,
every layer of the encrypted forward in a ``redsec/`` range of the
profiler's trace, nested in ``redsec/forward``, and kept in the store with
its parent and one request id a forward; the forward's output unchanged.

The forward is REDsec's ``mnist/sign1024x1`` with its own weights at a
noiseless set with n cut to 4 (the benchmark's CPU set), on the CPU."""

import json
import os

import numpy as np
import pytest
import torch
import torch.autograd.profiler as profiler
from torch.profiler import ProfilerActivity, profile, schedule

from redsec_tpu_torch import device
from redsec_tpu_torch.crypto import bootstrap as bs
from redsec_tpu_torch.crypto import keygen as kg
from redsec_tpu_torch.crypto.params import TfheParams
from redsec_tpu_torch.formats.varprep import VarPrepWriter
from redsec_tpu_torch.models.dims import Dimensions
from redsec_tpu_torch.models.spec import (
    Activation, BiasKind, ConvKind, Domain, LayerSpec, ModelSpec, PoolKind, PoolParams,
    prep_model,
)
from redsec_tpu_torch.models.zoo import get_model
from redsec_tpu_torch.runtime.encrypted import build_encrypted_forward, encrypt_images

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "tests", "golden", "sign1024x1_var_prep_from_ref_wght.dat")
TINY = TfheParams(name="tiny", n=4, N=256, k=1, bg_bit=3, l=10, ks_basebit=3, ks_t=9,
                  alpha_ks=0.0, alpha_bk=0.0, alpha_enc=0.0, msg_space=4096)
LEAVES = {"leveled", "pbs.prologue", "pbs.blind_rotate", "pbs.extract", "pbs.key_switch",
          "pbs.concat"}
# sign1024x1's host arrays a forward uploads: the input; layer 0 (sumpool 2x2, sign): the
# window gather's fill scalar, the bias row, the sign's test vector; layer 1 (FC 1024,
# sign): the fill scalar, the ternary weights, the bias row, the test vector; layer 2
# (FC 10): the fill scalar, the weights, the bias row
SIGN1024X1_UPLOADS = 1 + 3 + 4 + 3
# its spans: forward, L0-L2; six leveled; L0's PBS of 196 (pbs and its four stages),
# L1's of 1,024 in two chunks of 512 (pbs, twice four stages, the concatenation)
SIGN1024X1_SPANS = 1 + 3 + 6 + 5 + 10


@pytest.fixture(scope="module")
def dkey_sk():
    sk, cloud = kg.keygen(TINY, seed=0)
    return bs.prepare_cloud_key(cloud, device="cpu"), sk


@pytest.fixture(scope="module")
def sign1024x1(dkey_sk):
    dkey, sk = dkey_sk
    fwd = build_encrypted_forward(prep_model(get_model("mnist/sign1024x1"), WEIGHTS), dkey)
    img = np.random.default_rng(0).integers(0, 256, size=(1, 28, 28, 1))
    return fwd, encrypt_images(sk, img, TINY, np.random.default_rng(1))


@pytest.fixture(scope="module")
def runs(sign1024x1, tmp_path_factory):
    """The forward once with no profiler, ``record_function`` counted, and
    once under a CPU profiler: outputs, what the store gained in each, the
    profiler's exported events."""
    fwd, ct = sign1024x1
    real, entered = profiler.record_function, []

    def counted(*args, **kwargs):
        entered.append(args)
        return real(*args, **kwargs)

    before = (len(device.spans.requests), device.spans._next)
    profiler.record_function = counted
    try:
        off = fwd(ct)
    finally:
        profiler.record_function = real
    after_off = (len(device.spans.requests), device.spans._next)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = fwd(ct)
    got = device.spans.read(1)
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return {"off": off, "on": on, "entered": entered, "before": before,
            "after_off": after_off, "read": got, "events": events}


def test_off_path_records_nothing(runs):
    assert runs["entered"] == []
    assert runs["after_off"] == runs["before"]
    assert device.span("forward") is device.span("leveled")  # one shared object, no record
    n = len(device.spans.requests)
    device.upload(np.arange(3), "cpu")
    assert len(device.spans.requests) == n


def test_spans_leave_the_forward_bit_identical(runs):
    assert runs["on"].dtype == torch.int32 and torch.equal(runs["off"], runs["on"])


def test_spans_of_one_forward(runs):
    (req,) = runs["read"].requests
    spans = req["spans"]
    assert req["root"] == "forward" and spans[0]["parent"] is None
    assert len(spans) == SIGN1024X1_SPANS <= 40
    assert [s["name"] for s in spans if s["parent"] == 0] == ["L0", "L1", "L2"]
    parents = {s["parent"] for s in spans}
    leaves = [s["name"] for i, s in enumerate(spans) if i not in parents]
    assert set(leaves) == LEAVES and leaves.count("pbs.blind_rotate") == 3
    for i, s in enumerate(spans[1:], 1):
        assert s["parent"] < i and spans[s["parent"]]["host_ms"] >= s["host_ms"] >= 0
        assert s["device_ms"] is None  # a CPU forward records no events
    assert runs["read"].device_ms == {}
    assert runs["read"].host_ms["forward"] == spans[0]["host_ms"]


def test_forward_uploads_counted(runs):
    assert runs["read"].counters == {device.UPLOADS: SIGN1024X1_UPLOADS}
    assert runs["read"].requests[0]["counters"] == {device.UPLOADS: SIGN1024X1_UPLOADS}


def test_profiler_trace_nests_every_span_in_the_forward(runs):
    ann = [e for e in runs["events"] if e.get("cat") == "user_annotation"
           and e.get("name", "").startswith(device.SPAN_PREFIX)]
    names = {e["name"][len(device.SPAN_PREFIX):] for e in ann}
    assert names == {"forward", "L0", "L1", "L2", "pbs"} | LEAVES
    assert len(ann) == SIGN1024X1_SPANS
    (fwd,) = [e for e in ann if e["name"] == "redsec/forward"]
    for e in ann:
        assert fwd["ts"] <= e["ts"] and e["ts"] + e["dur"] <= fwd["ts"] + fwd["dur"]


def _mini_sign_model(rng):
    """sumpool 2x2 + sign -> FC 8 + sign -> FC 3 on 4x4x1 inputs."""
    spec = ModelSpec(
        "test/spans_mini",
        Dimensions(h=4, w=4, in_dep=1, in_bits=5, up_bound=30, scale=15.0),
        [
            LayerSpec(Domain.INT, ConvKind.NONE, 1, PoolKind.SUM, Activation.SIGN,
                      BiasKind.NONE, pool_params=PoolParams((2, 2), (2, 2))),
            LayerSpec(Domain.BIN, ConvKind.FC, 8, PoolKind.NONE, Activation.SIGN,
                      BiasKind.BNORM),
            LayerSpec(Domain.BIN, ConvKind.FC_FINAL, 3, PoolKind.NONE, Activation.NONE,
                      BiasKind.NONE),
        ],
    )
    wr = VarPrepWriter()
    wr.write_i32(np.array([0]))
    wr.write_tern(rng.choice([-1, 0, 1], size=4 * 8))
    wr.write_i32(rng.integers(-3, 4, size=8))
    wr.write_tern(rng.choice([-1, 0, 1], size=8 * 3))
    wr.write_i32(rng.integers(-3, 4, size=3))
    return spec, wr.getvalue()


def test_schedule_records_the_active_step_only(dkey_sk):
    dkey, sk = dkey_sk
    spec, blob = _mini_sign_model(np.random.default_rng(2))
    fwd = build_encrypted_forward(prep_model(spec, blob), dkey, range_check=False)
    img = np.random.default_rng(3).integers(0, 16, size=(1, 4, 4, 1))
    ct = encrypt_images(sk, img, TINY, np.random.default_rng(4))
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        n0 = device.spans._next
        fwd(ct)  # the warm-up step: the profiler prepares, records nothing
        assert device.spans._next == n0
        prof.step()
        fwd(ct)
        fwd(ct)
    assert device.spans._next == n0 + 2
    reqs = device.spans.read(2).requests
    assert [r["id"] for r in reqs] == [n0, n0 + 1]
    for r in reqs:
        names = [s["name"] for s in r["spans"]]
        assert r["root"] == "forward" and names.count("forward") == 1
        assert [s["parent"] for s in r["spans"]][:2] == [None, 0] and names[1] == "L0"
        assert r["counters"] == {device.UPLOADS: 1 + 3 + 4 + 3}
    fwd(ct)
    assert device.spans._next == n0 + 2  # the session is over


def test_store_reads_the_last_requests_and_nests_no_span_in_its_own_name():
    store = device.SpanStore(keep=3)
    for rid in range(5):
        store.open("forward", "cpu")
        store.bump("forward.uploads", 2)
        store.open("leveled", None)
        store.close()
        store.close()
    got = store.read(10)
    assert [r["id"] for r in got.requests] == [2, 3, 4]  # the store keeps three
    assert got.counters == {"forward.uploads": 6} and got.device_ms == {}
    assert set(got.host_ms) == {"forward", "leveled"}
    assert [r["id"] for r in store.read(1).requests] == [4] and store.read(0).requests == []
    store.open("forward", "cpu")  # an open request is not read
    assert [r["id"] for r in store.read(2).requests] == [3, 4]
    store.close()
    store.bump("forward.uploads")  # no request open: nothing to count
    assert store.read(1).counters == {}
    with profile(activities=[ProfilerActivity.CPU]):
        assert device.span("leveled") is not device._NO_SPAN
        with device.span("leveled"):
            assert device.span("leveled") is device._NO_SPAN
            assert device.span("pbs") is not device._NO_SPAN


def test_annotation_rows_are_not_device_operations():
    assert device.is_annotation("redsec/pbs.key_switch")
    assert device.is_annotation("ProfilerStep#2")
    assert not device.is_annotation("blind_rotate_kernel<1024, 2, 2, 1>")


@pytest.mark.cuda
def test_cuda_forward_records_event_pairs():
    """On the card: every span of a CUDA forward has a device interval, and a
    child's lies within its parent's."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    sk, cloud = kg.keygen(TINY, seed=0)
    dkey = bs.prepare_cloud_key(cloud, device="cuda")
    spec, blob = _mini_sign_model(np.random.default_rng(2))
    fwd = build_encrypted_forward(prep_model(spec, blob), dkey, range_check=False)
    img = np.random.default_rng(3).integers(0, 16, size=(1, 4, 4, 1))
    ct = encrypt_images(sk, img, TINY, np.random.default_rng(4))
    want = fwd(ct).cpu()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = fwd(ct).cpu()
    assert torch.equal(want, got)
    (req,) = device.spans.read(1).requests
    spans = req["spans"]
    assert all(s["device_ms"] is not None and s["device_ms"] >= 0 for s in spans)
    for s in spans[1:]:
        assert s["device_ms"] <= spans[s["parent"]]["device_ms"] + 1e-3
