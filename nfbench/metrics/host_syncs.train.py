"""Host syncs per train step: the program's `sync.*` spans (each a call
that blocks the host until the device drains its queue) inside the
window's `step.*` spans, over the steps."""

from nfbench import spans


def read(run):
    if run.unit != "step":
        return None
    return spans.count_per_unit(run, "sync")
