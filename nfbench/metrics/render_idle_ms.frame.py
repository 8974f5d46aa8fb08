"""Device-idle milliseconds per frame while the host was in a render
(`render` spans: RenderNet's passes over the frame's ray chunks): the
device trace's idle gaps whose middle lies inside such a span, over the
frames."""

from nfbench import spans


def read(run):
    if run.unit != "frame":
        return None
    return spans.idle_ms_per_unit(run, "render")
