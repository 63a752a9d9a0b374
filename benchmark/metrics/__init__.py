"""One reader a metric, in a file named after it: ``read(run)`` returns the
metric's value from the run (``harness.run_cell``'s ``run``: its
configuration, device type ("cuda" or "cpu"), set-up seconds, window, launch
counters, least times from ``counts`` and, in a traced run, its
``trace.Trace``), or None where the run holds nothing for it to read."""
