"""Device interval of the key switch (the port's ``pbs.key_switch`` spans:
``RoundOps.key_switch``, digits and the limb GEMMs of ``device.int32_matmul``
against the key-switching key) in a traced block, in ms an image."""

from benchmark import spans


def read(run):
    return spans.device_ms_per_image(run, ("pbs.key_switch",))
