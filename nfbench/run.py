"""The benchmark of `neurofluid_torch` on one NVIDIA GPU.

    python3 -m nfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints one JSON line last on standard output
(`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
also `breakdown`, and `checks`, each number compared beside its limit)
and the same checks as the last lines on standard error. Exits non-zero,
printing no result, without a CUDA device, or when JAX or the JAX package
was imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from nfbench import harness

    parts = harness.load_parts(Path.cwd(), args.workload)
    chips = parts.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"nfbench: the cell needs {chips} CUDA device(s); the benchmark "
              f"runs on the card only", file=sys.stderr)
        return 2
    result, lines = harness.run(parts, args.seed, args.seconds,
                                bool(args.trace), t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"nfbench: the run imported {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
