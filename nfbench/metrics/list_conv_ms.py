"""Device milliseconds per train step in the list conv's products and
their adjoint: the cuBLAS and CUTLASS kernels that `dense_gemm_ms`
matches (per layer the tap matrix's `bmm` with the gathered rows and the
product with the filter, forward and backward; ParticleNet's dense
layers run under 1% of that time) and K8 (`segment_sum_kernel`, the
gathers' adjoint). The gathers are left out: the grid search's gathers
run the same kernel. None where none of these ran."""

from nfbench.metrics.dense_gemm_ms import DENSE, OWN

K8 = r"segment_sum_kernel"


def read(run):
    if run.unit != "step":
        return None
    t = run.trace.kernel_s(DENSE, exclude=OWN) + run.trace.kernel_s(K8)
    return 1e3 * t / run.units if t > 0 else None
