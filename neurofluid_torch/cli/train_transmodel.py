"""Transition-model stage (counterpart of reference train_transmodel.py), on the card.

Usage:
    python -m neurofluid_torch.cli.train_transmodel --expdir exps --expname trans
"""

import sys

from neurofluid_torch.train.transition import TransitionTrainer
from neurofluid_torch.utils.config import stage_config


def main(argv=None):
    cfg = stage_config("transmodel", argv)
    TransitionTrainer(cfg).train()


if __name__ == "__main__":
    main(sys.argv[1:])
