"""End-to-end stage (counterpart of reference train_e2e.py), on the card.

Usage:
    python -m neurofluid_torch.cli.train_e2e --expdir exps --expname e2e --dataset watercube
"""

import sys

from neurofluid_torch.train.e2e import E2ETrainer
from neurofluid_torch.utils.config import stage_config


def main(argv=None):
    cfg = stage_config("end2end", argv)
    E2ETrainer(cfg).train()


if __name__ == "__main__":
    main(sys.argv[1:])
