"""Warm-up stage (counterpart of reference train_renderer.py), on the card.

Usage:
    python -m neurofluid_torch.cli.train_renderer --expdir exps --expname warmup --dataset watercube
"""

import sys

from neurofluid_torch.train.warmup import WarmupTrainer
from neurofluid_torch.utils.config import stage_config


def main(argv=None):
    cfg = stage_config("warmup", argv)
    WarmupTrainer(cfg).train()


if __name__ == "__main__":
    main(sys.argv[1:])
