"""The readings that a cell's limits are set from, on many seeds in one
process: for each seed the program's numbers (set-up, a short window of
the cell's own units with its window step, the comparison with the
reference, as a run makes them) and the control's (the reference computed
at the configuration's control precision, in the program's place).

    python3 -m nfbench.readings --workload <cell> --seeds 1 2 3 \
        [--seconds 2] [--control] [--fault half]

With `--fault` the program's numbers are those of the program with that
fault planted (`nfbench/faults.py`).

One JSON line per seed on standard output. Runs on the card only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

from nfbench import harness
from nfbench.faults import FAULTS, planted


def read(workload: str, seed: int, seconds: float, control: bool,
         fault: str | None = None, device="cuda") -> dict:
    parts = harness.load_parts(Path.cwd(), workload)
    dev = torch.device(device)
    entry = harness.make_entry(parts, seed, dev)
    t0 = time.perf_counter()
    with planted(fault) if fault else contextlib.nullcontext():
        entry.setup()
        harness.window(entry, seconds, dev)
    entry.release()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    out = {"seed": seed, "failed": entry.failed, "fault": fault,
           "program": entry.numbers()}
    if hasattr(entry, "worst"):
        out["worst"] = entry.worst
    if control:
        out["control"] = entry.control_numbers()
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=FAULTS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("nfbench.readings: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        print(json.dumps(read(args.workload, seed, args.seconds,
                              args.control, args.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
