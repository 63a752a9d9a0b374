"""The 95th percentile of every request's latency in the window (host clock,
from the request's start to its scores on the host), in ms."""

import statistics


def read(run):
    lat = run.window["latencies_s"]
    if len(lat) < 2:
        return lat[0] * 1e3
    return statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3
