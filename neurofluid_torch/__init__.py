"""NeuroFluid in PyTorch with hand-written Hopper (sm_90a) kernels.

The JAX package `neurofluid_tpu` is the reference; this package holds the
same models and ops in PyTorch. Eight kernels carry its paths, each in
`csrc/` beside a plain PyTorch version of the same math:

- K1, K2 `csrc/fused_cconv.cu`: the fused continuous convolution and its
  backward (`ops/fused_cconv.py`), five launches each per ParticleNet step
  on the `fused_cconv` search backend; at `conv_precision='default'` K1d
  and K2d, `csrc/fused_cconv_bf16.cu`;
- K3, K4 `csrc/ball_features.cu`: the renderer's ball-query feature sums
  and their backward (`ops/ball_features.py`), one launch per render pass;
- K5, K6 `csrc/composite.cu`: the volume-rendering weights and their
  backward (`ops/composite.py`), one launch per render pass;
- K7 `csrc/fused_query.cu`: the compact neighbour lists of the `fused`
  search backend (`ops/fused_query.py`), two launches per ParticleNet step;
- K8 `csrc/segment_sum.cu`: the segment sum, the adjoint of every neighbour
  gather on that backend (`ops/segment_ops.py`).

Importing the package builds nothing: `cuda.py` compiles a kernel's source
with nvcc the first time a CUDA tensor reaches its wrapper. CPU tensors go to
the plain versions, which is how the tests run.
"""
