"""The host's time inside the port's ``forward`` span (from the input's upload
to the return of the last layer's tensor; the blocking uploads inside it wait
for the device) in a traced block, in ms a request."""

from benchmark import spans


def read(run):
    got = spans.read(run)
    if got is None or "forward" not in got.host_ms:
        return None
    return got.host_ms["forward"] / run.trace.requests
