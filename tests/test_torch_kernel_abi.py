"""The ctypes signature of every kernel entry point against its C
declaration in neurofluid_torch/csrc/*.cu. ctypes cannot see the C side:
an argument list that disagrees with it fails only when the card calls it,
or passes a value in the wrong slot, so the two are held together here."""

import ctypes
import re

import pytest

from neurofluid_torch import cuda
from neurofluid_torch.ops import (
    ball_features, composite, dense_layer, encode, fused_cconv, fused_query,
    segment_ops,
)

_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float}


def _kernels():
    """Every Kernel handle of the modules, those in a dict of handles
    (`fused_cconv.BF16_KERNELS`) too."""
    found = []
    for mod in (ball_features, composite, dense_layer, encode, fused_cconv,
                fused_query, segment_ops):
        for v in vars(mod).values():
            for k in v.values() if isinstance(v, dict) else (v,):
                if isinstance(k, cuda.Kernel):
                    found.append(k)
    return found


def _c_signature(source: str, symbol: str) -> list:
    text = (cuda.CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert m, f"no extern \"C\" {symbol} in {source}"
    types = []
    for param in m.group(1).split(","):
        assert param.split(), f"an empty parameter in {symbol}"
        decl = " ".join(param.split()[:-1])  # drop the parameter name
        types.append(ctypes.c_void_p if "*" in param
                     else _C_TYPES[decl.replace("const ", "")])
    return types


def test_every_module_declares_its_kernels():
    names = sorted(k.symbol for k in _kernels())
    assert names == sorted([
        "nf_ball_query_compact", "nf_ball_sums", "nf_ball_sums_bwd",
        "nf_composite_weights", "nf_composite_weights_bwd",
        "nf_dense_layer_bwd", "nf_dense_layer_chain", "nf_dense_layer_prep",
        "nf_encode_bwd", "nf_encode_fwd",
        "nf_fused_cconv_bwd", "nf_fused_cconv_bwd_bf16",
        "nf_fused_cconv_fwd", "nf_fused_cconv_fwd_bf16",
        "nf_segment_sum_accumulate", "nf_split_gemm", "nf_split_gemm_bf16"])


@pytest.mark.parametrize("kernel", _kernels(), ids=lambda k: k.symbol)
def test_argtypes_match_the_c_declaration(kernel):
    # the stream is the last C parameter; Kernel appends it to argtypes
    assert _c_signature(kernel.source, kernel.symbol) == [
        *kernel.argtypes, ctypes.c_void_p]
