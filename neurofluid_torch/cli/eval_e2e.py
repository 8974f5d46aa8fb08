"""End-to-end evaluation (counterpart of reference eval_e2e.py), on the card.

Usage:
    python -m neurofluid_torch.cli.eval_e2e --expdir exps --expname e2e_eval --dataset watercube \
        --resume_from exps/e2e/models
"""

import sys

from neurofluid_torch.train.evaluation import E2EEvaluator
from neurofluid_torch.utils.config import stage_config


def main(argv=None):
    cfg = stage_config("end2end", argv)
    E2EEvaluator(cfg).eval()


if __name__ == "__main__":
    main(sys.argv[1:])
