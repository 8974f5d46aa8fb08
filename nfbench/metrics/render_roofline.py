"""The render kernels' share of their roofline: the bytes K3-K6 have to
move in the window's renders (`work.render_kernel_bytes`, at 3.35 TB/s;
their operations, a few per selected pair, are far below it) over their
device time (`work.RENDER_KERNELS`), in percent."""

from nfbench import work


def read(run):
    if run.unit != "step" or "render_bytes" not in run.work:
        return None
    t = run.trace.kernel_s(work.RENDER_KERNELS)
    if t <= 0:
        return None
    bound = work.bound_s(run.work["render_bytes"], run.work["render_ops"],
                         run.config["peak_flops"]) * run.units
    return 100.0 * bound / t
