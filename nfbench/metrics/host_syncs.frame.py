"""Host syncs per rendered frame: the program's `sync.*` spans inside the
window's `frame` spans, over the frames."""

from nfbench import spans


def read(run):
    if run.unit != "frame":
        return None
    return spans.count_per_unit(run, "sync")
