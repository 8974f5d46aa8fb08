"""A rendered frame's share of the card's peak: the NeRF operations of a
whole frame (`work.py`) times the frames of the traced window, over the
window and the configuration's peak, in percent."""


def read(run):
    ops = run.work.get("model_ops")
    if run.unit != "frame" or not ops:
        return None
    return 100.0 * ops * run.units / (run.window_s * run.config["peak_flops"])
