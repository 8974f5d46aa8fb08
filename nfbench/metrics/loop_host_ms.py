"""Host milliseconds per train step inside the trainer's own loop around
its train step: the union of the `loop.*` spans (the frame's data, the
pixel draw and the copies to the card; the log and its host Pred2GT)
inside the window's steps, over the steps. None where the window holds
no such span (a program without it)."""

from nfbench import spans


def read(run):
    if run.unit != "step":
        return None
    found = spans.window_spans(run)
    if found is None:
        return None
    merged = spans.union((s.start_ns, s.end_ns) for s in found[1]
                         if spans.in_layer(s.name, "loop"))
    if not merged:
        return None
    return 1e-6 * sum(e - s for s, e in merged) / run.units
