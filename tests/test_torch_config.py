"""Port parity, the config loader: neurofluid_torch.utils.config (a copy)
against neurofluid_tpu.utils.config over the repository's shared
configs/*.yaml, and the port's metrics copies against JAX's."""

import os

import numpy as np
import pytest
import yaml

from neurofluid_tpu.utils import config as jconfig
from neurofluid_tpu.utils import metrics as jmetrics
from neurofluid_torch.utils import config as tconfig
from neurofluid_torch.utils import metrics as tmetrics

STAGES = ("warmup", "transmodel", "end2end")


@pytest.mark.parametrize("stage", STAGES)
def test_stage_config_matches_jax(stage, tmp_path):
    """A stage with a dataset block from a --dataset_config file and every
    CLI flag: both packages assemble the same config and archive the same
    config.yaml."""
    blocks = jconfig.dataset_config()
    blocks["tiny"] = dict(blocks["watercube"].to_dict(),
                          train=dict(start_index=2, end_index=7, path="p",
                                     views=dict(warmup=["view_1"],
                                                dynamic=["view_1"])))
    ds = tmp_path / "dataset.yaml"
    ds.write_text(yaml.safe_dump(blocks.to_dict()))
    argv = ["--expdir", str(tmp_path / "exps"), "--expname", stage,
            "--dataset", "tiny", "--dataset_config", str(ds),
            "--resume_from", "exps/x/models"]
    archived = os.path.join(tmp_path, "exps", stage, "config.yaml")
    want = jconfig.stage_config(stage, argv)
    want_text = open(archived).read()
    os.remove(archived)
    got = tconfig.stage_config(stage, argv)
    assert got.to_dict() == want.to_dict()
    assert open(archived).read() == want_text
    assert got.train.start_index == 2 and got.resume_from == "exps/x/models"
    with pytest.raises(AttributeError, match="frozen"):
        got.TRAIN.seed = 1


@pytest.mark.parametrize("stage", STAGES)
def test_shipped_configs_validate(stage):
    for mod in (jconfig, tconfig):
        cfg = mod.load_config(stage)
        cfg.merge(mod.dataset_config()["watercube"])
        cfg.merge(dict(expdir="exps", expname="x", dataset="watercube",
                       config="", dataset_config="", resume_from=""))
        mod.validate_keys(cfg, stage)  # must not raise
    assert tconfig.load_config(stage).to_dict() == \
        jconfig.load_config(stage).to_dict()


@pytest.mark.parametrize("edit", ["typo", "section"])
def test_unknown_key_raises_in_both(edit):
    messages = []
    for mod in (jconfig, tconfig):
        cfg = mod.load_config("end2end")
        if edit == "typo":
            cfg.RENDERER.encoding["smoothed_po"] = True
        else:
            cfg.merge({"RENDERR": {"use_mask": True}})
        with pytest.raises(ValueError) as err:
            mod.validate_keys(cfg, "end2end")
        messages.append(str(err.value))
    assert ("smoothed_po" if edit == "typo" else "RENDERR") in messages[1]
    assert messages[1] == messages[0].replace("neurofluid_tpu",
                                              "neurofluid_torch")


def test_metrics_match_jax(rng):
    pred = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    gt = pred + rng.normal(size=pred.shape).astype(np.float32) * 0.01
    fe_t, fe_j = tmetrics.FluidErrors(), jmetrics.FluidErrors()
    assert fe_t.cal_errors(pred, gt, 1) == fe_j.cal_errors(pred, gt, 1)
    assert fe_t.errors == fe_j.errors
    nan = pred.copy()
    nan[0, 0] = np.nan
    assert fe_t.cal_errors(nan, gt, 2) is None
    img_a = rng.uniform(size=(20, 20, 3))
    img_b = np.clip(img_a + rng.normal(size=img_a.shape) * 0.05, 0, 1)
    assert tmetrics.psnr(img_a, img_b) == jmetrics.psnr(img_a, img_b)
    assert tmetrics.ssim(img_a, img_b) == jmetrics.ssim(img_a, img_b)
    assert tmetrics.chamfer_distance_np(pred, gt) == \
        jmetrics.chamfer_distance_np(pred, gt)
    # LPIPS is ported: with no weights configured both refuse alike
    for mod in (tmetrics, jmetrics):
        with pytest.raises(FileNotFoundError, match="NF_LPIPS_WEIGHTS"):
            mod.lpips(img_a, img_b, weights_path="")
