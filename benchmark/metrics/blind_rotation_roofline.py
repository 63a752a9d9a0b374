"""The blind rotation's share of its roofline in a traced block: its least
time for the block's images (``counts``) over the device time of the kernels
that do it, in %.  A kernel does blind rotation when its name holds one of
KERNELS; none traced, nothing to read."""

KERNELS = ("blind_rotate", "schoolbook_round", "cmux_round", "external_product",
           "schoolbook_mma")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    busy = sum(s for name, (_, s) in tr.kernels.items() if any(k in name for k in KERNELS))
    if busy <= 0:
        return None
    return 100.0 * run.least_ms["blind_rotation"] * 1e-3 * tr.images / busy
