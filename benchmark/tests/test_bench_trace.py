"""The trace reader on a synthetic Chrome trace: busy time, idle gaps by host
activity, kernel names, and the refusal of a partial trace."""

from benchmark import trace


def _ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _events():
    return [
        _ev("user_annotation", "request", 0, 1000),
        _ev("cpu_op", "aten::cat", 100, 300),
        _ev("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernelExC", 120, 5, corr=2),
        _ev("kernel", "void (anonymous namespace)::blind_rotate_kernel<1024, 2, 2, 1>(int const*)",
            200, 400, corr=1, tid=7),
        _ev("kernel", "void at::native::elementwise_kernel<128, 4>(int, float)", 500, 200, corr=2,
            tid=7),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 800, 50, corr=3, tid=7),
        _ev("cpu_op", "aten::copy_", 750, 200),
    ]


def test_reads_a_complete_trace():
    t = trace.read(_events(), {"blind_rotate": 1}, window_s=0.001, requests=1, images=1)
    assert isinstance(t, trace.Trace)
    n, s = t.kernels["blind_rotate_kernel<1024, 2, 2, 1>"]
    assert n == 1 and abs(s - 400e-6) < 1e-12
    assert abs(t.busy_s - 550e-6) < 1e-12  # [200, 700) and [800, 850)
    # idle: [0, 200) under aten::cat, [700, 800) under aten::copy_ at its midpoint 750,
    # [850, 1000) under aten::copy_
    assert abs(t.gaps["aten::cat"] - 200e-6) < 1e-12
    assert abs(t.gaps["aten::copy_"] - 250e-6) < 1e-12


def test_refuses_a_dropped_record():
    ev = [e for e in _events() if e["args"].get("correlation") != 2 or e["cat"] != "kernel"]
    assert "no kernel record" in trace.read(ev, {}, 0.001, 1, 1)


def test_refuses_a_count_short_of_the_counter():
    assert "records of blind_rotate_kernel" in trace.read(_events(), {"blind_rotate": 2},
                                                            0.001, 1, 1)
