"""Run one cell of the benchmark once, on the card of this machine:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result's JSON; the numbers compared for ``correct`` are the last lines of
standard error.  Exits 2 without a CUDA card (or with fewer than the cell
asks for) and 3 if JAX or the JAX package was loaded, printing no result.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # the checkout's root: the program and the benchmark import from it
# the caches a run may fill, at fixed paths inside the checkout (the program
# builds its kernels into build/kernels/ there itself)
for _var, _sub in (("CUDA_CACHE_PATH", "nv"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, "build", "benchmark_cache", _sub)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], ROOT, T_START))
