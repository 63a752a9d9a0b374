"""Device interval of the bootstrap outside its blind rotation and key switch
(the port's ``pbs.prologue``, ``pbs.extract`` and ``pbs.concat`` spans: mod
switch, test vectors, the accumulator's rotation, sample extract, the chunks'
concatenation) in a traced block, in ms an image."""

from benchmark import spans


def read(run):
    return spans.device_ms_per_image(run, ("pbs.prologue", "pbs.extract", "pbs.concat"))
