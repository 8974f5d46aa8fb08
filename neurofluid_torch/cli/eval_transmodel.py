"""Transition-model evaluation (counterpart of reference
eval_transmodel.py), on the card.

Usage:
    python -m neurofluid_torch.cli.eval_transmodel --expdir exps --expname trans_eval \
        --resume_from exps/trans/models
"""

import sys

from neurofluid_torch.train.evaluation import TransitionEvaluator
from neurofluid_torch.utils.config import stage_config


def main(argv=None):
    cfg = stage_config("transmodel", argv)
    TransitionEvaluator(cfg).eval()


if __name__ == "__main__":
    main(sys.argv[1:])
