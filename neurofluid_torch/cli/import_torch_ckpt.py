"""Import a reference PyTorch `.pt` checkpoint as a checkpoint of the port's
trainers (the counterpart of neurofluid_tpu/cli/import_torch_ckpt.py and
its `utils/torch_import.py`, which convert to flax; the port keeps the
upstream state_dict layout, so nothing is converted).

    python -m neurofluid_torch.cli.import_torch_ckpt \
        --ckpt path/to/100000.pt --out exps/watercube/imported/models

Reads the three reference layouts: {step, renderer_state_dict,
transition_model_state_dict, optimizer_state_dict} (e2e,
trainer/trainer_e2e.py:152-158), {step, renderer_state_dict, ...} (warm-up,
trainer_renderer.py:68-72) and {step, model_state_dict, ...} (transition,
trainer_transmodel.py:216-220). Each state_dict is loaded strictly into the
port's `RenderNet` / `ParticleNet` (the `gravity` buffer stripped by
`train.checkpoint.transition_state`, as the reference's own loader does;
keys the port's module does not have, such as Open3D's internal buffers, are
skipped and reported), and the result is written as `<out>/<step>.pt` by
`train.checkpoint.save_checkpoint`, where `TRAIN.pretrained_renderer`,
`TRAIN.pretrained_transition_model` and `TRAIN.pretrained` read it.
"""

from __future__ import annotations

import argparse

import torch

from neurofluid_torch.models.particle_net import ParticleNet
from neurofluid_torch.models.render_net import RenderNet
from neurofluid_torch.train import checkpoint as ckpt


def _strict_state(module: torch.nn.Module, state: dict, skipped: list) -> dict:
    """`state` loaded strictly into `module` (keys it lacks skipped and
    listed in `skipped`); returns the module's state_dict."""
    own = module.state_dict()
    skipped += [k for k in state if k not in own]
    module.load_state_dict({k: torch.as_tensor(v, dtype=torch.float32)
                            for k, v in state.items() if k in own})
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def import_checkpoint_file(path: str) -> dict:
    """{"step", "renderer"?, "transition"?} of a reference `.pt`, each a
    state_dict that the port's module (built on the CPU at the reference's
    default widths) loaded strictly. Reports skipped keys on stdout."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    state: dict = {"step": int(raw.get("step", 0))}
    skipped: list = []
    if "renderer_state_dict" in raw:
        state["renderer"] = _strict_state(
            RenderNet(device="cpu"),
            raw["renderer_state_dict"], skipped)
    tsd = raw.get("transition_model_state_dict", raw.get("model_state_dict"))
    if tsd is not None:
        state["transition"] = _strict_state(
            ParticleNet(device="cpu"),
            ckpt.transition_state(tsd), skipped)
    if skipped:
        print(f"import_torch_ckpt: skipped {len(skipped)} keys the port's "
              f"modules lack: {sorted(skipped)}")
    if len(state) == 1:
        raise ValueError(f"{path} contains no renderer_state_dict / "
                         "transition_model_state_dict / model_state_dict")
    return state


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True, help="reference .pt checkpoint")
    ap.add_argument("--out", required=True, help="output models directory")
    ap.add_argument("--step", type=int, default=None,
                    help="override the step number (default: from the .pt)")
    args = ap.parse_args(argv)

    state = import_checkpoint_file(args.ckpt)
    if args.step is not None:
        state["step"] = args.step
    path = ckpt.save_checkpoint(args.out, state["step"], state)
    kinds = [k for k in ("renderer", "transition") if k in state]
    print(f"imported {args.ckpt} ({' + '.join(kinds)}) -> {path}")


if __name__ == "__main__":
    main()
