"""Port parity, the host tools: `neurofluid_torch.data_generation`, the
`native` loader, the `cli` tools (convert_particles, evaluate_images,
generate_data, import_torch_ckpt) and the four functions ported with them
(`ray_ops.point_to_ray_distance`, `assign_particles_to_rays`,
`losses.ema_update`, `cconv.continuous_conv`), each against the JAX
package's on the same seeded inputs, as tests/test_cli_utils.py,
test_data_generation.py and test_native.py pin those: equal arrays, and
equal bytes where the writer is deterministic (bgeo, ply, obj, the scene
files)."""

import filecmp
import json
import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurofluid_tpu import native as jnative
from neurofluid_tpu.cli import convert_particles as jconvert
from neurofluid_tpu.cli import evaluate_images as jevaluate
from neurofluid_tpu.cli import generate_data as jgenerate
from neurofluid_tpu.data_generation import bgeo as jbgeo
from neurofluid_tpu.data_generation import physics_scenes as jscenes
from neurofluid_tpu.data_generation import surface_meshes as jmeshes
from neurofluid_tpu.ops import cconv as jcconv
from neurofluid_tpu.ops import neighbor_search as jns
from neurofluid_tpu.ops import ray_ops as jray
from neurofluid_tpu.train import losses as jlosses
from neurofluid_tpu.utils import torch_import
from neurofluid_torch import native
from neurofluid_torch.cli import convert_particles, evaluate_images
from neurofluid_torch.cli import generate_data, import_torch_ckpt
from neurofluid_torch.data import BlenderDataset
from neurofluid_torch.data_generation import bgeo, physics_scenes
from neurofluid_torch.data_generation import surface_meshes
from neurofluid_torch.models.particle_net import ParticleNet
from neurofluid_torch.models.render_net import RenderNet
from neurofluid_torch.ops import cconv
from neurofluid_torch.ops import neighbor_search as ns
from neurofluid_torch.ops import ray_ops
from neurofluid_torch.train import checkpoint as ckpt
from neurofluid_torch.train import losses
from neurofluid_torch.utils.params import (
    renderer_state_from_flax, transition_state_from_flax,
)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _same_tree(a, b):
    """Two directory trees hold the same files with the same bytes."""
    cmp = filecmp.dircmp(a, b)
    assert not (cmp.left_only or cmp.right_only or cmp.funny_files), (
        cmp.left_only, cmp.right_only)
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files,
                                           shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    for sub in cmp.common_dirs:
        _same_tree(osp.join(a, sub), osp.join(b, sub))


# ---- the four functions


def test_point_to_ray_distance_and_assignment_match_jax(rng):
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    o = rng.normal(size=(7, 3)).astype(np.float32)
    d = rng.normal(size=(7, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = ray_ops.point_to_ray_distance(_t(pts), _t(o), _t(d)).numpy()
    want = np.asarray(jray.point_to_ray_distance(jnp.asarray(pts),
                                                 jnp.asarray(o),
                                                 jnp.asarray(d)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    rays = np.concatenate([o, d], -1)
    np.testing.assert_array_equal(
        ray_ops.assign_particles_to_rays(_t(pts), _t(rays)).numpy(),
        np.asarray(jray.assign_particles_to_rays(jnp.asarray(pts),
                                                 jnp.asarray(rays))))
    # the closed form of tests/test_cli_utils.py: distance 5 to the z axis
    d5 = ray_ops.point_to_ray_distance(torch.tensor([[3.0, 4.0, 10.0]]),
                                       torch.zeros(1, 3),
                                       torch.tensor([[0.0, 0.0, 1.0]]))
    assert float(d5[0, 0]) == pytest.approx(5.0, rel=1e-6)


@pytest.mark.parametrize("step", [0, 3, 10_000])
def test_ema_update_matches_jax(rng, step):
    teacher = {"w": rng.normal(size=(4, 3)).astype(np.float32),
               "b": rng.normal(size=3).astype(np.float32)}
    student = {k: rng.normal(size=v.shape).astype(np.float32)
               for k, v in teacher.items()}
    got = losses.ema_update({k: _t(v) for k, v in teacher.items()},
                            {k: _t(v) for k, v in student.items()}, step)
    want = jlosses.ema_update(teacher, student, step)
    for k in teacher:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


def test_continuous_conv_matches_jax(rng):
    """One conv in one call over the same neighbour list (brute force,
    nearest 12 within r), filters (4, 4, 4, 5, 7); relative to the largest
    output entry."""
    pts = rng.uniform(-0.2, 0.2, (90, 3)).astype(np.float32)
    qs = rng.uniform(-0.2, 0.2, (30, 3)).astype(np.float32)
    feats = rng.normal(size=(90, 5)).astype(np.float32)
    filters = rng.normal(size=(4, 4, 4, 5, 7)).astype(np.float32)
    extent = 0.2
    nb = ns.radius_search_brute(_t(qs), _t(pts), extent / 2, 12)
    jnb = jns.radius_search_brute(jnp.asarray(qs), jnp.asarray(pts),
                                  extent / 2, 12)
    np.testing.assert_array_equal(nb.idx.numpy(), np.asarray(jnb.idx))
    got = cconv.continuous_conv(_t(filters), _t(pts), _t(feats), _t(qs), nb,
                                extent).numpy()
    want = np.asarray(jcconv.continuous_conv(
        jnp.asarray(filters), jnp.asarray(pts), jnp.asarray(feats),
        jnp.asarray(qs), jnb, extent))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ---- data_generation


def test_bgeo_files_byte_equal_and_read_back(tmp_path, rng):
    pos = rng.normal(size=(11, 3)).astype(np.float32)
    attrs = {"velocity": rng.normal(size=(11, 3)).astype(np.float32),
             "id": np.arange(11, dtype=np.int32)}
    a, b = str(tmp_path / "port.bgeo"), str(tmp_path / "jax.bgeo")
    bgeo.write_bgeo(a, pos, attrs)
    jbgeo.write_bgeo(b, pos, attrs)
    assert filecmp.cmp(a, b, shallow=False)
    got_pos, got = bgeo.read_bgeo(b)
    want_pos, want = jbgeo.read_bgeo(a)
    np.testing.assert_array_equal(got_pos, want_pos)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    (tmp_path / "bad.bgeo").write_bytes(b"NOPE" + b"\0" * 40)
    with pytest.raises(ValueError, match="not a classic Bgeo"):
        bgeo.read_bgeo(str(tmp_path / "bad.bgeo"))


def test_scene_sampling_matches_jax():
    box, nrm = physics_scenes.sample_box_surface((-1, -1, -1), (1, 1, 1), 0.25)
    jbox, jnrm = jscenes.sample_box_surface((-1, -1, -1), (1, 1, 1), 0.25)
    np.testing.assert_array_equal(box, jbox)
    np.testing.assert_array_equal(nrm, jnrm)
    fluid = physics_scenes.sample_fluid_block((0, 0, 0), (0.2, 0.2, 0.2), 0.05)
    np.testing.assert_array_equal(
        fluid, jscenes.sample_fluid_block((0, 0, 0), (0.2, 0.2, 0.2), 0.05))
    assert (physics_scenes.build_scene_description([fluid], (-1,) * 3,
                                                   (1,) * 3)
            == jscenes.build_scene_description([fluid], (-1,) * 3, (1,) * 3))
    for s in (0.0, 0.5, 1.0):
        np.testing.assert_array_equal(
            physics_scenes.random_rotation_matrix(np.random.default_rng(3), s),
            jscenes.random_rotation_matrix(np.random.default_rng(3), s))


def test_generated_scenes_byte_equal(tmp_path):
    """The simulator-free fallback scene and a random scene, written by
    both packages from the same seed: the same files, byte for byte."""
    kw = dict(fluid_lower=(-0.1, -0.1, 0.4), fluid_upper=(0.1, 0.1, 0.6),
              n_frames=4)
    a = physics_scenes.generate_scene(str(tmp_path / "port" / "scene"), **kw)
    b = jscenes.generate_scene(str(tmp_path / "jax" / "scene"), **kw)
    _same_tree(a, b)
    info = physics_scenes.create_random_scene(
        str(tmp_path / "port" / "sim_0001"), seed=1, n_frames=3,
        export_zst=False)
    jinfo = jscenes.create_random_scene(
        str(tmp_path / "jax" / "sim_0001"), seed=1, n_frames=3,
        export_zst=False)
    _same_tree(str(tmp_path / "port" / "sim_0001"),
               str(tmp_path / "jax" / "sim_0001"))
    assert info["n_particles"] == jinfo["n_particles"]


def test_convert_bgeo_sequence_matches_jax(tmp_path, rng):
    pos = rng.normal(size=(10, 3)).astype(np.float32)
    vel = rng.normal(size=(10, 3)).astype(np.float32)
    perm = rng.permutation(10).astype(np.int32)
    bdir = tmp_path / "bgeo"
    bdir.mkdir()
    jbgeo.write_bgeo(str(bdir / "f_0.bgeo"), pos[perm],
                     {"velocity": vel[perm], "id": perm})
    assert physics_scenes.convert_bgeo_sequence(str(bdir),
                                                str(tmp_path / "p")) == 1
    assert jscenes.convert_bgeo_sequence(str(bdir), str(tmp_path / "j")) == 1
    _same_tree(str(tmp_path / "p"), str(tmp_path / "j"))
    np.testing.assert_array_equal(
        np.load(str(tmp_path / "p" / "fluid_0000.npz"))["pos"], pos)


def test_surface_meshes_match_jax(tmp_path, rng):
    pts = rng.uniform(0, 0.2, size=(200, 3)).astype(np.float32)
    grid, origin = surface_meshes.particle_density_grid(pts, 0.04, 0.08)
    jgrid, jorigin = jmeshes.particle_density_grid(pts, 0.04, 0.08)
    np.testing.assert_array_equal(grid, jgrid)
    np.testing.assert_array_equal(origin, jorigin)
    a = surface_meshes.mesh_particle_frame(pts, str(tmp_path / "p.ply"),
                                           voxel_size=0.04,
                                           kernel_radius=0.08)
    b = jmeshes.mesh_particle_frame(pts, str(tmp_path / "j.ply"),
                                    voxel_size=0.04, kernel_radius=0.08)
    assert filecmp.cmp(a, b, shallow=False)
    assert open(a).read(3) == "ply"


# ---- native


@pytest.fixture
def native_lib():
    if not native.available():
        pytest.skip("g++ unavailable; the native library cannot be built")
    return native


def test_native_library_builds_under_build_dir(native_lib):
    path = native_lib.library_path()
    assert path.exists() and path.parent.name == "neurofluid_torch"
    assert path.parent.parent.name == "build"


def test_native_matches_scipy_and_jax_loader(native_lib, rng):
    from scipy.spatial import cKDTree

    from neurofluid_torch.utils.metrics import chamfer_distance_np

    points = rng.uniform(-1, 1, size=(3000, 3)).astype(np.float32)
    queries = rng.uniform(-1.2, 1.2, size=(500, 3)).astype(np.float32)
    d, i = native_lib.nearest_neighbor_distances(points, queries)
    d_ref, _ = cKDTree(points).query(queries)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-6)
    jd, ji = jnative.nearest_neighbor_distances(points, queries)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(i, ji)

    x, y = points[:800], queries[:600]
    np.testing.assert_allclose(native_lib.chamfer(x, y),
                               chamfer_distance_np(x, y), rtol=1e-4)
    assert native_lib.chamfer(x, y) == jnative.chamfer(x, y)

    counts = native_lib.radius_counts(points, points, 0.2, exclude_self=True)
    tree = cKDTree(points)
    ref = np.asarray([len(tree.query_ball_point(p, 0.2)) - 1 for p in points],
                     np.int32)
    np.testing.assert_array_equal(counts, ref)
    np.testing.assert_array_equal(
        counts, jnative.radius_counts(points, points, 0.2, exclude_self=True))

    d0, i0 = native_lib.nearest_neighbor_distances(
        np.zeros((0, 3), np.float32), np.zeros((5, 3), np.float32))
    assert np.all(np.isinf(d0)) and np.all(i0 == -1)


# ---- cli tools


@pytest.mark.parametrize("record_type", ["ply", "obj"])
def test_convert_particles_cli_byte_equal(tmp_path, rng, record_type):
    src = tmp_path / "src"
    src.mkdir()
    pos = rng.normal(size=(9, 3)).astype(np.float32)
    np.savez(str(src / "5.npz"), pos=pos, vel=np.zeros_like(pos))
    for mod, dst in ((convert_particles, "p"), (jconvert, "j")):
        mod.main(["--data_path", str(src), "--dst_path", str(tmp_path / dst),
                  "--record_type", record_type])
    _same_tree(str(tmp_path / "p"), str(tmp_path / "j"))


def test_evaluate_images_cli_matches_jax(tmp_path, rng):
    from PIL import Image

    pred, gt = tmp_path / "pred", tmp_path / "gt"
    pred.mkdir()
    gt.mkdir()
    for i in range(4):
        img = (rng.uniform(size=(16, 16, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(str(gt / f"{i:05d}.png"))
        noisy = np.clip(img.astype(int) + 10, 0, 255).astype(np.uint8)
        Image.fromarray(noisy).save(str(pred / f"{i:05d}.png"))
    got = evaluate_images.evaluate_dirs(str(pred), str(gt), rollout=2,
                                        device="cpu")
    want = jevaluate.evaluate_dirs(str(pred), str(gt), rollout=2)
    assert got["summary"].keys() == want["summary"].keys()
    for k, v in want["summary"].items():
        assert got["summary"][k] == pytest.approx(v, rel=1e-6), k
    out = tmp_path / "summary.json"
    evaluate_images.main(["--pred", str(pred), "--gt", str(gt), "--rollout",
                          "2", "--out", str(out)])
    assert json.loads(out.read_text())["summary"]["frames"] == 4


def test_generate_data_cli_byte_equal_and_loadable(tmp_path):
    args = ["--frames", "3", "--img-size", "16", "--n-side", "3", "--raw"]
    generate_data.main(["--out", str(tmp_path / "p" / "scene"), *args])
    jgenerate.main(["--out", str(tmp_path / "j" / "scene"), *args])
    _same_tree(str(tmp_path / "p"), str(tmp_path / "j"))
    ds = BlenderDataset(str(tmp_path / "p" / "scene"), img_wh=(16, 16),
                        view_names=["view_1"], end_index=3)
    assert ds[0]["rays"].shape == (1, 256, 6)


def _reference_checkpoint(path, layout):
    """A `.pt` in one of the reference's three layouts, from seeded port
    modules (upstream state_dict layout) plus the `gravity` buffer and an
    Open3D-style buffer the port does not have."""
    ren = RenderNet(device="cpu", generator=torch.Generator().manual_seed(3))
    net = ParticleNet(device="cpu", generator=torch.Generator().manual_seed(4))
    tsd = dict(net.state_dict())
    tsd["gravity"] = torch.tensor([0.0, -9.81, 0.0])
    tsd["conv0_fluid.offset"] = torch.zeros(3)
    raw = {"step": 7, "optimizer_state_dict": {}}
    if layout in ("e2e", "warmup"):
        raw["renderer_state_dict"] = ren.state_dict()
    if layout == "e2e":
        raw["transition_model_state_dict"] = tsd
    if layout == "transition":
        raw["model_state_dict"] = tsd
    torch.save(raw, path)
    return raw


@pytest.mark.parametrize("layout", ["e2e", "warmup", "transition"])
def test_import_torch_ckpt_matches_jax_import(tmp_path, layout):
    """The port's import equals JAX's `torch_import.import_checkpoint_file`
    carried back by `*_state_from_flax`; the CLI writes `<out>/<step>.pt`
    that the trainers' loaders read."""
    src = str(tmp_path / "ref.pt")
    _reference_checkpoint(src, layout)
    got = import_torch_ckpt.import_checkpoint_file(src)
    want = torch_import.import_checkpoint_file(src)
    assert got["step"] == want["step"] == 7
    assert set(got) == set(want)
    for key, conv in (("renderer", renderer_state_from_flax),
                      ("transition", transition_state_from_flax)):
        if key not in want:
            continue
        expected = conv(want[key])
        assert set(got[key]) == set(expected), key
        for name, v in expected.items():
            np.testing.assert_array_equal(got[key][name].numpy(), v.numpy(),
                                          err_msg=name)

    out = str(tmp_path / "models")
    import_torch_ckpt.main(["--ckpt", src, "--out", out])
    loaded, step = ckpt.restore_checkpoint(out)
    assert step == 7 and osp.exists(osp.join(out, "7.pt"))
    if "transition" in loaded:
        ParticleNet(device="cpu").load_state_dict(
            ckpt.transition_state(loaded["transition"]))
    if "renderer" in loaded:
        RenderNet(device="cpu").load_state_dict(loaded["renderer"])


def test_import_torch_ckpt_rejects_empty(tmp_path):
    path = str(tmp_path / "empty.pt")
    torch.save({"step": 1}, path)
    with pytest.raises(ValueError, match="contains no"):
        import_torch_ckpt.import_checkpoint_file(path)

