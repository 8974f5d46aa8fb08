"""Experiment observability: scalars/histograms/images (a copy of
neurofluid_tpu/utils/logging.py).

The reference logs to TensorBoard (reference trainer/basetrainer.py:29,
trainer_e2e.py:247-302). Here: a JSONL event stream is always written (cheap,
grep-able, no deps), plus TensorBoard mirroring through torch's
SummaryWriter when TensorBoard is installed, imported when a logger is
made, never when the module is imported. Image artifacts are PNG dumps as in
the reference's `visualization` (basetrainer.py:312-333).
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time

import numpy as np


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


class MetricsLogger:
    def __init__(self, logdir: str, use_tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._jsonl = open(osp.join(logdir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # TensorBoard not installed: JSONL only
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir=logdir)

    def scalar(self, tag: str, value, step: int):
        value = float(value)
        self._jsonl.write(
            json.dumps({"t": time.time(), "tag": tag, "value": value, "step": step})
            + "\n"
        )
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def histogram(self, tag: str, values, step: int):
        values = np.asarray(values)
        summary = {
            "t": time.time(), "tag": tag, "step": step,
            "hist": {
                "mean": float(values.mean()), "std": float(values.std()),
                "min": float(values.min()), "max": float(values.max()),
            },
        }
        self._jsonl.write(json.dumps(summary) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_histogram(tag, values, step)

    def image(self, tag: str, image_hwc: np.ndarray, step: int):
        if self._tb is not None:
            self._tb.add_image(tag, np.transpose(to8b(image_hwc), (2, 0, 1)), step)

    def save_image(self, filename: str, image_hwc: np.ndarray):
        from PIL import Image

        Image.fromarray(to8b(image_hwc)).save(osp.join(self.logdir, filename))

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
