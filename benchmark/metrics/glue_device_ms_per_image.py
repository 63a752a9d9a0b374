"""Device time of every operation of a traced block outside the blind
rotation (the PBS glue: mod switch, test-vector rotation, sample extract, key
switch; the leveled layers; copies), in ms an image."""

from benchmark.metrics.blind_rotation_roofline import KERNELS


def read(run):
    tr = run.trace
    if tr is None:
        return None
    rest = sum(s for name, (_, s) in tr.kernels.items() if not any(k in name for k in KERNELS))
    return rest * 1e3 / tr.images
