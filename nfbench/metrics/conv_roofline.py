"""The conv kernels' share of their roofline: the least time the card
could take for the steps' continuous convs (`work.conv_work`: bytes at
3.35 TB/s or operations at the configuration's peak, whichever is
longer) over the device time of K1/K2 or K1d/K2d and their products
(`work.CONV_KERNELS`), in percent."""

from nfbench import work


def read(run):
    if "conv_ops" not in run.work:
        return None
    t = run.trace.kernel_s(work.CONV_KERNELS)
    if t <= 0:
        return None
    bound = work.bound_s(run.work["conv_bytes"], run.work["conv_ops"],
                         run.config["peak_flops"]) * run.units
    return 100.0 * bound / t
