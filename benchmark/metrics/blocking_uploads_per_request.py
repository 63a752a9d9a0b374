"""Host arrays the port's forward turns into device tensors (its
``forward.uploads`` counter; on CUDA each a copy that waits for the stream) in
a traced block, a request."""

from benchmark import spans


def read(run):
    got = spans.read(run)
    if got is None:
        return None
    return got.counters.get("forward.uploads", 0) / run.trace.requests
