"""Device interval of the leveled layers (the port's ``leveled`` spans: the
conv/FC limb GEMMs, sumpool, bias and centering adds, test-vector uploads) in
a traced block, in ms an image."""

from benchmark import spans


def read(run):
    return spans.device_ms_per_image(run, ("leveled",))
