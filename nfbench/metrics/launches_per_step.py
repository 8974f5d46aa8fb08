"""Kernels launched per train step: every kernel of the traced window
(copies and sets left out) over the steps completed in it."""


def read(run):
    if run.unit != "step":
        return None
    n = run.trace.launches()
    return n / run.units if n else None
