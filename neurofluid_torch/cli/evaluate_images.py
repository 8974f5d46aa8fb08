"""Offline image-quality evaluation over rendered frame directories; a copy
of neurofluid_tpu/cli/evaluate_images.py over the port's `utils.metrics`
(reference utils/evaluate_images.ipynb cells 2-7).

MSE / PSNR / SSIM (and LPIPS, on the card unless --device says otherwise,
when a weights file is given) between same-named PNGs of a prediction and a
GT directory, split into 'trained' (all but the last `rollout` frames) and
'rollout' windows.

Usage:
    python -m neurofluid_torch.cli.evaluate_images \
        --pred exps/e2e_eval/images/fine/view_5/Pred \
        --gt   exps/e2e_eval/images/fine/view_5/GT --rollout 10
"""

from __future__ import annotations

import argparse
import glob
import json
import os.path as osp

import numpy as np

from neurofluid_torch.utils import metrics


def evaluate_dirs(pred_dir: str, gt_dir: str, rollout: int = 10,
                  lpips_weights: str = "", device="cuda") -> dict:
    from PIL import Image

    pred_paths = sorted(glob.glob(osp.join(pred_dir, "*.png")))
    if not pred_paths:
        raise FileNotFoundError(f"no PNGs in {pred_dir}")
    keys = ["mse", "psnr", "ssim"]
    if lpips_weights:
        keys.append("lpips")
    rows = []
    for p in pred_paths:
        g = osp.join(gt_dir, osp.basename(p))
        pred = np.asarray(Image.open(p), np.float32)[..., :3] / 255.0
        gt = np.asarray(Image.open(g), np.float32)[..., :3] / 255.0
        row = {
            "frame": osp.basename(p),
            "mse": float(np.mean((pred - gt) ** 2)),
            "psnr": metrics.psnr(pred, gt),
            "ssim": metrics.ssim(pred, gt),
        }
        if lpips_weights:
            row["lpips"] = metrics.lpips(pred, gt, weights_path=lpips_weights,
                                         device=device)
        rows.append(row)

    def window(rs, name):
        return {f"{name}_{k}": float(np.mean([r[k] for r in rs]))
                for k in keys} if rs else {}

    trained = rows[:-rollout] if rollout and len(rows) > rollout else rows
    roll = rows[-rollout:] if rollout and len(rows) > rollout else []
    summary = {"frames": len(rows)}
    summary.update(window(trained, "trained"))
    summary.update(window(roll, "rollout"))
    return {"summary": summary, "per_frame": rows}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pred", required=True)
    p.add_argument("--gt", required=True)
    p.add_argument("--rollout", type=int, default=10)
    p.add_argument("--lpips_weights", default="",
                   help="LPIPS weights .npz (utils/lpips.py); enables LPIPS")
    p.add_argument("--device", default="cuda", help="LPIPS's device")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    result = evaluate_dirs(args.pred, args.gt, args.rollout,
                           lpips_weights=args.lpips_weights,
                           device=args.device)
    print(json.dumps(result["summary"], indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)


if __name__ == "__main__":
    main()
