"""Images completed a second over the whole window (host clock)."""


def read(run):
    return run.window["images"] / run.window["seconds"]
