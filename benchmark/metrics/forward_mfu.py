"""The whole forward's share of the card's peak: the least time the card
needs for the window's images (``counts.least_ms_per_image``: blind
rotation in its configuration's formulation, key switch and leveled layers
as int32 multiply-adds) over the window's length, in %.  A share of the
H100's peak: nothing to read in a run on another device."""


def read(run):
    if run.device != "cuda":
        return None
    least_s = run.least_ms["total"] * 1e-3 * run.window["images"]
    return 100.0 * least_s / run.window["seconds"]
