"""The share of the traced training window in which no operation ran on
the device, in percent."""


def read(run):
    if run.unit != "step":
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.window_s)
