"""Launches of the blind-rotation kernels an image over the window, from the
program's own launch counters (exact)."""

COUNTERS = ("blind_rotate", "blind_rotate_mm", "schoolbook_round", "cmux_round",
            "cmux_round_mm", "external_product", "external_product_mm", "schoolbook_product")


def read(run):
    n = sum(run.window["launches"].get(c, 0) for c in COUNTERS)
    return n / run.window["images"] if n else None
