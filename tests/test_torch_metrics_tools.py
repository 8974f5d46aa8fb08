"""Port parity: the chamfer distance, LPIPS and the profiling helpers
against neurofluid_tpu (same seeded numpy inputs, f32 on the CPU).

- `chamfer_distance` / `nearest_neighbor_dists` against ops.chamfer (the
  same |x|^2 + |y|^2 - 2 x.y expansion; 1e-6 of the distances' scale) and
  against scipy's cKDTree in float64;
- `LPIPSEvaluator` on a random-weight `.npz` in the documented format
  (tests/test_torch_cuda.py's `lpips_weights`), written to tmp_path, at
  32 x 32 against the JAX evaluator (1e-5 of the distance), through
  `get_evaluator` / NF_LPIPS_WEIGHTS and `metrics.lpips`;
- `trace`."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurofluid_tpu.ops import chamfer as jchamfer
from neurofluid_tpu.utils import lpips as jlpips
from neurofluid_tpu.utils import metrics as jmetrics
from neurofluid_torch.ops import chamfer as tchamfer
from neurofluid_torch.utils import lpips as tlpips
from neurofluid_torch.utils import metrics as tmetrics
from neurofluid_torch.utils import profiling
from test_torch_cuda import lpips_weights


def _clouds(rng, n=700, m=500):
    x = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    y = (x[:m] + rng.normal(size=(m, 3)) * 0.02).astype(np.float32)
    return x, y


@pytest.mark.parametrize("chunk", [4096, 128])
def test_chamfer_matches_jax_and_kdtree(rng, chunk):
    from scipy.spatial import cKDTree

    x, y = _clouds(rng)
    got = float(tchamfer.chamfer_distance(torch.from_numpy(x),
                                          torch.from_numpy(y), chunk=chunk))
    want = float(jchamfer.chamfer_distance(jnp.asarray(x), jnp.asarray(y),
                                           chunk=chunk))
    exact = jmetrics.chamfer_distance_np(x.astype(np.float64),
                                         y.astype(np.float64))
    assert tmetrics.chamfer_distance_np(x, y) == pytest.approx(exact)
    # f32 expansions of |x - y|^2 with |x|^2 up to 3: ~1e-7 per entry
    assert abs(got - want) <= 1e-6 and abs(got - exact) <= 1e-6
    nn_t = tchamfer.nearest_neighbor_dists(torch.from_numpy(y),
                                           torch.from_numpy(x), chunk=chunk)
    nn_j = jchamfer.nearest_neighbor_dists(jnp.asarray(y), jnp.asarray(x),
                                           chunk=chunk)
    assert nn_t.shape == (y.shape[0],)
    # sqrt of a rounding-level d^2 near 0 is ~3e-4: compare the squares
    np.testing.assert_allclose(nn_t.numpy() ** 2, np.asarray(nn_j) ** 2,
                               rtol=0, atol=1e-6)
    d_tree, _ = cKDTree(x.astype(np.float64)).query(y.astype(np.float64))
    np.testing.assert_allclose(nn_t.numpy() ** 2, d_tree ** 2, rtol=0,
                               atol=1e-6)


def test_lpips_matches_jax(tmp_path, monkeypatch):
    path = lpips_weights(tmp_path / "lpips_vgg.npz")
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(32, 32, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.1, 0, 1).astype(np.float32)
    ev = tlpips.LPIPSEvaluator(path, device="cpu")
    got, want = ev(a, b), jlpips.LPIPSEvaluator(path)(a, b)
    assert want > 0 and ev(a, a) == 0.0
    assert got == pytest.approx(want, rel=1e-5)
    # the metric entry point and the environment variable reach the same
    # evaluator, loaded once per file and device
    monkeypatch.setenv("NF_LPIPS_WEIGHTS", path)
    assert tmetrics.lpips(a, b, device="cpu") == pytest.approx(got, rel=1e-6)
    assert tlpips.get_evaluator(device="cpu") is tlpips.get_evaluator(
        path, device="cpu")
    bad = dict(np.load(path))
    bad["lin2_weight"] = bad["lin2_weight"][:10]
    np.savez(tmp_path / "bad.npz", **bad)
    with pytest.raises(ValueError, match="lin2_weight has 10 channels"):
        tlpips.LPIPSEvaluator(str(tmp_path / "bad.npz"), device="cpu")
    monkeypatch.delenv("NF_LPIPS_WEIGHTS")
    with pytest.raises(FileNotFoundError, match="NF_LPIPS_WEIGHTS"):
        tlpips.get_evaluator(device="cpu")
    with pytest.raises(FileNotFoundError, match="not found"):
        tlpips.LPIPSEvaluator(str(tmp_path / "none.npz"), device="cpu")


def test_trace_writes_a_profile(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    files = [f for f in os.listdir(logdir) if f.endswith(".json")]
    assert len(files) == 1
