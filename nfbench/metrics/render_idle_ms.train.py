"""Device-idle milliseconds per train step while the host was in a
render (`render` spans: RenderNet's coarse and fine passes, their
features and NeRF calls): the device trace's idle gaps whose middle lies
inside such a span, over the steps."""

from nfbench import spans


def read(run):
    if run.unit != "step":
        return None
    return spans.idle_ms_per_unit(run, "render")
