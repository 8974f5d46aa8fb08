"""Config system: nested attribute-accessible nodes + YAML + CLI (a copy
of neurofluid_tpu/utils/config.py, which the port cannot import: importing
that package imports JAX).

Plays the role of yacs + argparse in the reference (reference
configs/__init__.py:10-159): per-stage YAML defaults merged with a dataset
YAML block and command-line overrides, frozen, and archived into the
experiment directory. Both packages read the same `configs/*.yaml` of the
repository. Implemented dependency-free on top of pyyaml.
"""

from __future__ import annotations

import argparse
import copy
import os
import os.path as osp

import yaml


class ConfigNode(dict):
    """dict with attribute access, recursive merge, and freeze support."""

    __frozen = False

    def __init__(self, data: dict | None = None):
        super().__init__()
        for k, v in (data or {}).items():
            self[k] = ConfigNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        if name.endswith("__frozen"):
            super().__setattr__(name, value)
            return
        if self.__frozen:
            raise AttributeError(f"config is frozen; cannot set {name}")
        self[name] = ConfigNode(value) if isinstance(value, dict) else value

    def __setitem__(self, key, value):
        if self.__frozen:
            raise AttributeError(f"config is frozen; cannot set {key}")
        super().__setitem__(key, ConfigNode(value) if isinstance(value, dict) else value)

    def merge(self, other: dict) -> "ConfigNode":
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), ConfigNode):
                self[k].merge(v)
            else:
                self[k] = ConfigNode(v) if isinstance(v, dict) else v
        return self

    def merge_from_file(self, path: str) -> "ConfigNode":
        with open(path) as f:
            return self.merge(yaml.safe_load(f) or {})

    def freeze(self) -> "ConfigNode":
        self.__frozen = True
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()
        return self

    def clone(self) -> "ConfigNode":
        return ConfigNode(copy.deepcopy(self.to_dict()))

    def to_dict(self) -> dict:
        return {
            k: v.to_dict() if isinstance(v, ConfigNode) else v for k, v in self.items()
        }

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)


CONFIG_DIR = osp.join(osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))), "configs")

_STAGE_FILES = {
    "warmup": "warmup.yaml",
    "transmodel": "transmodel.yaml",
    "end2end": "end2end.yaml",
}

# Keys that are legal on top of the stage-default YAML schema: CLI flags,
# dataset-block keys (configs/dataset.yaml), and optional knobs the trainers
# consume via .get(). Anything NOT in the default YAML and not listed here is
# rejected by `validate_keys` — unknown keys silently doing nothing is how
# config lies happen.
_EXTRA_KEYS = {
    "": {
        "expdir", "expname", "dataset", "config", "dataset_config",
        "resume_from", "data_type", "near", "far", "gravity", "train", "test",
    },
    "train": {"start_index", "end_index", "path", "views"},
    "train.views": {"warmup", "dynamic"},
    "test": {"start_index", "end_index", "path", "views"},
    "TRAIN": {
        "search_backend", "on_search_overflow", "gravity", "epochs",
        "N_iters", "precrop_iters", "log_interval", "save_interval",
        "grad_clip_value", "particle_radius", "partial_load",
        "pretrained", "pretrained_renderer", "pretrained_transition_model",
        "seperate_render_transition", "loss_weight", "imgW", "imgH", "scale",
    },
    "TEST": {"save_obj", "seed", "datapath", "datatype", "gravity",
             "start_index", "end_index", "camera_angle_x", "near", "far"},
    "RENDERER": {"bf16"},
    "RENDERER.ray": {"eval_ray_chunk"},
    "RENDERER.NN_search": {"selection"},
}


def _schema_paths(node: dict, prefix: str = "") -> set:
    paths = set()
    for k, v in node.items():
        p = f"{prefix}.{k}" if prefix else str(k)
        paths.add(p)
        if isinstance(v, dict):
            paths |= _schema_paths(v, p)
    return paths


def validate_keys(cfg: "ConfigNode", stage: str) -> None:
    """Reject unknown config keys (fail-loudly config contract).

    The reference's yacs `cfg.merge_from_file` silently accepts any key the
    code never reads; here every key must be either in the stage's default
    YAML schema or in the documented extras table. Raises ValueError naming
    the offending path(s).
    """
    defaults = load_config(stage)
    allowed = _schema_paths(defaults.to_dict())
    extras = set()
    for prefix, names in _EXTRA_KEYS.items():
        for n in names:
            extras.add(f"{prefix}.{n}" if prefix else n)
    allowed |= extras

    unknown = []

    def walk(node: dict, prefix: str):
        for k, v in node.items():
            p = f"{prefix}.{k}" if prefix else str(k)
            if p not in allowed:
                # subtrees rooted at a dict-valued extra (e.g. TRAIN.datapath
                # in a stage whose defaults lack it) are accepted wholesale
                if not any(p.startswith(e + ".") for e in extras):
                    unknown.append(p)
                continue
            if isinstance(v, dict):
                walk(v, p)

    walk(cfg.to_dict(), "")
    if unknown:
        raise ValueError(
            f"unknown config key(s) for stage '{stage}': {sorted(unknown)}. "
            "Every key must be consumed; add it to the stage YAML schema or "
            "neurofluid_torch.utils.config._EXTRA_KEYS if it is real."
        )


def load_config(stage: str, config_file: str = "") -> ConfigNode:
    """Load the per-stage default YAML (or an explicit file)."""
    path = config_file or osp.join(CONFIG_DIR, _STAGE_FILES[stage])
    return ConfigNode().merge_from_file(path)


def dataset_config(config_file: str = "") -> ConfigNode:
    path = config_file or osp.join(CONFIG_DIR, "dataset.yaml")
    return ConfigNode().merge_from_file(path)


def build_arg_parser() -> argparse.ArgumentParser:
    """CLI flags of the reference entry points (reference configs/__init__.py:10-15)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--expdir", type=str, default="exps")
    parser.add_argument("--expname", type=str, default="debug")
    parser.add_argument("--dataset", type=str, default="")
    parser.add_argument("--config", type=str, default="")
    parser.add_argument("--dataset_config", type=str, default="",
                        help="alternative dataset.yaml with scene blocks")
    parser.add_argument("--resume_from", type=str, default="")
    return parser


def stage_config(stage: str, argv=None) -> ConfigNode:
    """Full config assembly: stage YAML + dataset block + CLI, archived to the
    experiment dir (reference configs/__init__.py:66-159)."""
    args = vars(build_arg_parser().parse_args(argv))
    cfg = load_config(stage, args["config"])
    if args["dataset"]:
        cfg.merge(dataset_config(args["dataset_config"])[args["dataset"]])
    cfg.merge({k: v for k, v in args.items()})
    validate_keys(cfg, stage)

    expdir = osp.join(args["expdir"], args["expname"])
    os.makedirs(expdir, exist_ok=True)
    with open(osp.join(expdir, "config.yaml"), "w") as f:
        f.write(cfg.dump())
    return cfg.freeze()
