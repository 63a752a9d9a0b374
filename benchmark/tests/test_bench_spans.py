"""The readers of the program's spans and counters (``benchmark/spans.py``
and its five metrics) on a synthetic store: their values, and nothing read
where the run was not traced, the program keeps no spans, or the store's
requests are not the traced block's; and the unedited trace reader naming an
idle gap by the innermost host event, a span's range among them."""

import types

import pytest

from benchmark import harness, trace
from benchmark.tests import helpers
from redsec_tpu_torch import device

READERS = ("key_switch_span_ms_per_image", "leveled_span_ms_per_image",
           "pbs_edges_span_ms_per_image", "forward_host_ms_per_request",
           "blocking_uploads_per_request")


def _request(rid, root="forward"):
    return {"id": rid, "root": root, "spans": [], "counters": {}}


class FakeStore:
    """A store whose ``read(k)`` gives the last k of ``requests`` with fixed
    sums: 2 requests of 4 images."""

    def __init__(self, requests):
        self.requests = requests

    def read(self, k):
        reqs = self.requests[-k:]
        return device.SpanRead(
            requests=reqs,
            host_ms={"forward": 150.0, "pbs.key_switch": 1.0},
            device_ms={"forward": 149.0, "pbs.key_switch": 8.0, "leveled": 2.0,
                       "pbs.prologue": 1.0, "pbs.extract": 0.5, "pbs.concat": 0.5},
            counters={device.UPLOADS: 22})


def _run(requests=2, images=4, traced=True):
    tr = trace.Trace(window_s=0.15, busy_s=0.14, kernels={}, gaps={}, counters={},
                     requests=requests, images=images) if traced else None
    return types.SimpleNamespace(trace=tr, device="cuda")


@pytest.fixture
def store(monkeypatch):
    fake = FakeStore([_request(i) for i in range(5)])
    monkeypatch.setattr(device, "spans", fake)
    return fake


def test_values_from_the_store(store):
    read = {name: harness.reader(helpers.REPO, name) for name in READERS}
    run = _run()
    assert read["key_switch_span_ms_per_image"](run) == pytest.approx(8.0 / 4)
    assert read["leveled_span_ms_per_image"](run) == pytest.approx(2.0 / 4)
    assert read["pbs_edges_span_ms_per_image"](run) == pytest.approx((1.0 + 0.5 + 0.5) / 4)
    assert read["forward_host_ms_per_request"](run) == pytest.approx(150.0 / 2)
    assert read["blocking_uploads_per_request"](run) == pytest.approx(22 / 2)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(store, monkeypatch, name):
    read = harness.reader(helpers.REPO, name)
    assert read(_run(traced=False)) is None
    # fewer requests kept than the block held
    assert read(_run(requests=6)) is None
    # a request of the block that is not a forward
    store.requests[-1] = _request(4, root="pbs")
    assert read(_run()) is None
    # a program without spans (the parent of the commit that added them)
    monkeypatch.delattr(device, "spans")
    assert read(_run()) is None


def test_device_metrics_need_device_times(monkeypatch):
    """A store read with no CUDA events (a CPU forward) has no device ms."""
    class CpuStore(FakeStore):
        def read(self, k):
            got = super().read(k)
            got.device_ms = {}
            return got

    monkeypatch.setattr(device, "spans", CpuStore([_request(0), _request(1)]))
    for name in READERS[:3]:
        assert harness.reader(helpers.REPO, name)(_run()) is None
    assert harness.reader(helpers.REPO, "forward_host_ms_per_request")(_run()) == 75.0


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_trace_names_idle_gaps_by_the_innermost_span_or_op():
    events = [
        _ev("user_annotation", "request", 0, 1000),
        _ev("user_annotation", "redsec/forward", 1, 999),
        _ev("user_annotation", "redsec/pbs.prologue", 10, 390),
        _ev("cpu_op", "aten::where", 50, 100),
        _ev("cuda_runtime", "cudaLaunchKernel", 60, 5, corr=1),
        _ev("kernel", "elementwise_kernel", 200, 100, corr=1) | {"tid": 7},
        _ev("cuda_runtime", "cudaLaunchKernel", 600, 5, corr=2),
        _ev("kernel", "blind_rotate_kernel<1024, 2, 2, 1>", 700, 300, corr=2) | {"tid": 7},
    ]
    t = trace.read(events, {}, window_s=0.001, requests=1, images=1)
    assert isinstance(t, trace.Trace)
    # [0, 200): midpoint 100 inside aten::where, itself inside the span
    assert t.gaps["aten::where"] == pytest.approx(200e-6)
    # [300, 700): midpoint 500 after the prologue's range, inside redsec/forward only
    assert t.gaps["redsec/forward"] == pytest.approx(400e-6)
    shifted = [dict(e, dur=590) if e["name"] == "redsec/pbs.prologue" else e for e in events]
    t = trace.read(shifted, {}, window_s=0.001, requests=1, images=1)
    # now the prologue's range covers the midpoint 500: the span names the gap
    assert t.gaps["redsec/pbs.prologue"] == pytest.approx(400e-6)
