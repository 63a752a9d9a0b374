"""The program's own spans and counters over a traced block.

With ``system.py`` the only module of the benchmark that reads the program,
and it does so only after the run: the per-layer readers call ``read(run)``
once the window, the traced block and the check are over.  The port's
``redsec_tpu_torch.device.spans`` keeps the spans of every request that ran
while a profiler recorded, so the last ``run.trace.requests`` of them are the
traced block's (``trace.capture`` records only that block).
"""

from __future__ import annotations

import importlib


def read(run):
    """The port's ``SpanRead`` of the traced block's requests, or None where
    the run was not traced, the program keeps no spans, or the spans found
    are not one ``forward`` for each of the block's requests."""
    if run.trace is None:
        return None
    store = getattr(importlib.import_module("redsec_tpu_torch.device"), "spans", None)
    if store is None:
        return None
    got = store.read(run.trace.requests)
    if len(got.requests) != run.trace.requests or any(
            r["root"] != "forward" for r in got.requests):
        return None
    return got


def device_ms_per_image(run, names) -> "float | None":
    """Device interval of the spans named ``names``, summed, in ms an image of
    the traced block; None where the spans have no device times (a CPU run)
    or none of ``names`` ran."""
    got = read(run)
    if got is None or not any(n in got.device_ms for n in names):
        return None
    return sum(got.device_ms.get(n, 0.0) for n in names) / run.trace.images
