"""Port parity: the data layer (neurofluid_torch.data) against
neurofluid_tpu.data on scenes written to tmp_path.

The scene writers are copies, so from one seed both packages write the same
files: the same names, byte-equal images, pickles and json, and equal arrays
in every .npz (an .npz's zip entries carry the time they were written). The
datasets read the same arrays from one scene, exactly for everything read
from disk and within 1e-6 for the rays (each package rotates the pixel
directions by its own matmul), and `ParticleDataset` draws the same
z-rotations from the same seed."""

import json
import os
import os.path as osp
import shutil

import numpy as np
import pytest

from neurofluid_tpu import data as jdata
from neurofluid_torch import data as tdata

SCENE = dict(n_frames=4, n_side=3, img_wh=(16, 16),
             train_views=("view_1", "view_2"), test_views=("view_5",))


def _files(root):
    return sorted(osp.relpath(osp.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_same_files(a, b):
    names = _files(a)
    assert names == _files(b) and names
    for name in names:
        pa, pb = osp.join(a, name), osp.join(b, name)
        if name.endswith(".npz"):
            za, zb = np.load(pa), np.load(pb)
            assert sorted(za.files) == sorted(zb.files), name
            for key in za.files:
                np.testing.assert_array_equal(za[key], zb[key],
                                              err_msg=f"{name}:{key}")
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), name


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The same Blender-layout scene written by each package."""
    roots = {}
    for name, pkg in (("torch", tdata), ("jax", jdata)):
        root = str(tmp_path_factory.mktemp(f"scene_{name}"))
        meta = pkg.synthetic.generate_blender_scene(root, seed=3, **SCENE)
        roots[name] = (root, meta)
    return roots


def test_blender_scene_writers_write_the_same_files(scenes):
    (rt, mt), (rj, mj) = scenes["torch"], scenes["jax"]
    _assert_same_files(rt, rj)
    assert mt.keys() == mj.keys()
    for key in ("positions", "velocities", "box", "box_normals", "focal"):
        np.testing.assert_array_equal(mt[key], mj[key], err_msg=key)
    with open(osp.join(rt, "view_1", "transforms_train.json")) as f:
        meta = json.load(f)
    assert len(meta["frames"]) == SCENE["n_frames"]


@pytest.mark.parametrize("method", ["ballistic", "pbf"])
def test_raw_dataset_writers_write_the_same_files(tmp_path, method):
    roots = [str(tmp_path / name) for name in ("torch", "jax")]
    for root, pkg in zip(roots, (tdata, jdata)):
        if method == "pbf":
            pkg.synthetic.generate_pbf_raw_dataset(root, n_sims=2, n_frames=3,
                                                   n_side=3, seed=4)
        else:
            pkg.synthetic.generate_raw_dataset(root, n_sims=2, n_frames=4,
                                               n_side=3, seed=4)
    _assert_same_files(*roots)


@pytest.mark.parametrize("split,views", [
    ("train", ("view_1", "view_2")), ("test", ("view_5",))])
def test_blender_dataset_matches_jax(scenes, split, views):
    root = scenes["jax"][0]
    kw = dict(img_wh=SCENE["img_wh"], view_names=views, split=split,
              start_index=0, end_index=SCENE["n_frames"])
    t = tdata.BlenderDataset(root, **kw)
    j = jdata.BlenderDataset(root, **kw)
    assert len(t) == len(j) == SCENE["n_frames"] - 1
    for name in ("rgbs", "cw", "focal", "particles_pos", "particles_vel",
                 "box", "box_normals"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    assert t.rays.shape == j.rays.shape == (len(views), SCENE["n_frames"],
                                            16, 16, 6)
    assert t.rays.dtype == np.float32
    np.testing.assert_allclose(t.rays, j.rays, rtol=0, atol=1e-6)
    for i in (0, len(t) - 1):
        bt, bj = t[i], j[i]
        assert bt.keys() == bj.keys()
        for key in bt:
            if key.startswith("rays"):
                np.testing.assert_allclose(bt[key], bj[key], rtol=0,
                                           atol=1e-6, err_msg=key)
            else:
                np.testing.assert_array_equal(bt[key], bj[key], err_msg=key)
    with pytest.raises(IndexError):
        t[len(t)]


@pytest.mark.parametrize("data_type,random_rot", [
    ("raw", True), ("raw", False), ("blender_all", True), ("blender", False)])
def test_particle_dataset_matches_jax(scenes, tmp_path, data_type,
                                      random_rot):
    """The same windows, in the same order, and (with `random_rot`) the
    same z-rotation angle from the same seed, sample by sample."""
    if data_type == "raw":
        root = str(tmp_path / "raw")
        jdata.synthetic.generate_raw_dataset(root, n_sims=2, n_frames=5,
                                             n_side=3, seed=6)
    elif data_type == "blender":  # the layout reads view_0 alone
        root = str(tmp_path / "scene")
        shutil.copytree(scenes["jax"][0], root)
        os.rename(osp.join(root, "view_1"), osp.join(root, "view_0"))
    else:
        root = scenes["jax"][0]
    kw = dict(data_type=data_type, random_rot=random_rot, seed=11, window=3)
    t = tdata.ParticleDataset(root, **kw)
    j = jdata.ParticleDataset(root, **kw)
    assert len(t) == len(j) > 0
    assert t.sequence_lengths == j.sequence_lengths
    for i in list(range(len(t))) * 2:  # draws continue across passes
        st, sj = t[i], j[i]
        assert st.keys() == sj.keys()
        for key in st:
            np.testing.assert_array_equal(st[key], sj[key], err_msg=key)
    if random_rot:  # the rotation moved the sample, preserving lengths
        raw = t.items[0]["particles_pos_0"]
        rot = t[0]["particles_pos_0"]
        assert not np.allclose(rot, raw)
        np.testing.assert_allclose(np.linalg.norm(rot[:, :2], axis=1),
                                   np.linalg.norm(raw[:, :2], axis=1),
                                   rtol=1e-5)


def test_io_round_trips_match_jax(tmp_path):
    """The copied readers read what either package's writers wrote."""
    rng = np.random.default_rng(12)
    pos = rng.normal(size=(9, 3)).astype(np.float32)
    vel = rng.normal(size=(9, 3)).astype(np.float32)
    tdata.io.write_particles_npz(str(tmp_path / "p.npz"), pos, vel)
    jdata.io.write_box_npz(str(tmp_path / "b.npz"), pos, vel)
    for pkg in (tdata, jdata):
        p, v = pkg.io.read_particles(str(tmp_path / "p.npz"))
        b, n = pkg.io.read_box(str(tmp_path / "b.npz"))
        for got, want in ((p, pos), (v, vel), (b, pos), (n, vel)):
            np.testing.assert_array_equal(got, want)
    with open(tmp_path / "c.obj", "w") as f:
        tdata.io.write_obj_pointcloud(pos, f)
    np.testing.assert_array_equal(
        tdata.io.read_obj_pointcloud(str(tmp_path / "c.obj")),
        jdata.io.read_obj_pointcloud(str(tmp_path / "c.obj")))
