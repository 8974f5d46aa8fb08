"""Renderer evaluation (counterpart of reference eval_renderer.py):
renders the GT-particle sequence from a fixed camera with a warm-up
checkpoint, on the card.

Usage:
    python -m neurofluid_torch.cli.eval_renderer --expdir exps --expname render_eval \
        --dataset watercube --resume_from exps/warmup/models
"""

import sys

from neurofluid_torch.train.evaluation import RendererEvaluator
from neurofluid_torch.utils.config import stage_config


def main(argv=None):
    cfg = stage_config("warmup", argv)
    RendererEvaluator(cfg).eval()


if __name__ == "__main__":
    main(sys.argv[1:])
