"""Device-idle milliseconds per train step while the host was in the
backward pass (the `backward` span around `loss.backward()`): the device
trace's idle gaps whose middle lies inside it, over the steps."""

from nfbench import spans


def read(run):
    if run.unit != "step":
        return None
    return spans.idle_ms_per_unit(run, "backward")
