"""The benchmark of the PyTorch/CUDA port (``redsec_tpu_torch``): encrypted
MNIST images served one request at a time on one H100.

``run.py`` runs one cell once; ``harness.py`` drives it; ``keys.py`` and
``traffic.py`` make the inputs from the seed; ``system.py`` is the only
contact with the program; ``reference/`` recomputes the answers in plain
PyTorch; ``counts.py`` holds the work counts and peaks; ``trace.py`` reads
the profiler's trace; ``metrics/``, ``configs/`` and ``traffic/`` hold one
file a metric, configuration and mix; ``control.py`` reads the control's and
the program's check numbers at a cell's own size."""
