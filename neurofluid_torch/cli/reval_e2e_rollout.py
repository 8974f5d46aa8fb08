"""Re-evaluate the protocol run's post-e2e rollout from the saved e2e
checkpoint (counterpart of tools/reval_e2e_rollout.py), on the card.

    python -m neurofluid_torch.cli.reval_e2e_rollout

Reads the same PROTO_* knobs as `full_protocol_run`, resumes the e2e
checkpoint under PROTO_ROOT, reruns `rollout_with_retry` and the
reference's Pred2GT windows, and replaces `pred2gt_mm` in the record
(PROTOCOL_TORCH.json at the repo root by default), noting that the row
was re-evaluated; every other entry of the record stays as it was.
"""

from __future__ import annotations

import json
import os.path as osp

from neurofluid_torch.cli import full_protocol_run as fpr
from neurofluid_torch.train.e2e import E2ETrainer


def main(n_frames=61, img=400, device="cuda", record=None):
    """The re-evaluation over the scene `full_protocol_run.main` wrote with
    the same `n_frames` and `img`. Returns the new row."""
    k = fpr.knobs()
    exps = osp.join(k["root"], "exps")
    e2e_models = osp.join(exps, "e2e", "models")
    proto_json = str(record or fpr.RECORD)

    et = E2ETrainer(fpr.e2e_cfg(
        k, k["scene"], img, n_frames, "e2e_reval",
        osp.join(exps, "warmup", "models"),
        osp.join(exps, "transition", "models"), epochs=0), device=device)
    et.resume(e2e_models)
    print(f"resumed e2e checkpoint from {e2e_models} "
          f"(step {et.start_step - 1})", flush=True)

    row, _ = fpr.eval_row(et, et.transition, len(et.test_dataset),
                          lambda m: print(m, flush=True))
    row["note"] = "re-evaluated from the saved e2e checkpoint"
    print(json.dumps(row, indent=1), flush=True)

    with open(proto_json) as f:
        proto = json.load(f)
    proto["pred2gt_mm"] = row
    with open(proto_json, "w") as f:
        json.dump(proto, f, indent=2)
    print(f"patched pred2gt_mm in {proto_json}", flush=True)
    return row


if __name__ == "__main__":
    main()
