"""Device milliseconds per step in the library's dense products (cuBLAS
and CUTLASS kernels: the NeRF's and ParticleNet's dense layers), not the
port's own conv product (`split_gemm_kernel`, `sum_splits_kernel`)."""

DENSE = r"gemm|gemv|cutlass|xmma|splitK"
OWN = r"split_gemm|sum_splits"


def read(run):
    if run.unit != "step":
        return None
    t = run.trace.kernel_s(DENSE, exclude=OWN)
    return 1e3 * t / run.units if t > 0 else None
