"""The share of the traced frame-rendering window in which no operation
ran on the device, in percent."""


def read(run):
    if run.unit != "frame":
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.window_s)
