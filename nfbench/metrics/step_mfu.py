"""The train step's share of the card's peak: the model's operations per
step (`work.py`: convs, dense layers, NeRF, forward and backward) times
the steps of the traced window, over the window and the configuration's
peak, in percent."""


def read(run):
    ops = run.work.get("model_ops")
    if run.unit != "step" or not ops:
        return None
    return 100.0 * ops * run.units / (run.window_s * run.config["peak_flops"])
