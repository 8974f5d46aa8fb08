#!/usr/bin/env python3
"""Time the port's tensor-core product (`split_gemm_cuda`, the contractions
of K1 and K2) at the shapes of its five uses at the bench point, beside
`torch.matmul` in f32 and the least time the card could take, on one CUDA
card.

    python3 tools/split_gemm_bench.py [--root DIR] [--reps N] [--sweep 1,2,4]
                                      [--precision default]

`--root` imports `neurofluid_torch` from another checkout (for example a
`git archive` of an earlier commit unpacked under build/), so that two
versions of the product are timed on the same card in one call: run the
earlier one, this one, this one, the earlier one. Each use runs in the splits
of k that its caller gives it in that checkout (`product_splits` where the
checkout has it, else K1's fold unsplit and K2's dW in `dw_split`). Each
line holds the error against a float64 product relative to sum |a||b|,
CUDA-event ms (median of `--reps` after a warm-up, a spin kernel queued
ahead of each), `torch.matmul` ms and the bound; the last line is one JSON
object of the same numbers. `--sweep` also times each use in each of the
given numbers of splits of k. `--precision default` times the product's
bf16 mode (conv_precision 'default') instead: its error against a float64
product of the bf16-rounded inputs, beside cuBLAS in bf16 (`torch.mm` with
an f32 result where this torch has it, else `torch.matmul` on bf16
tensors), its bound at the dense bf16 rate; A is then bf16 where the
checkout's product takes it so (`nf_split_gemm_bf16`: the walks write their
rows in bf16), f32 before.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_TF32_PER_S = 495e12    # dense TF32 tensor-core rate
PEAK_BF16_PER_S = 989e12    # dense bf16 tensor-core rate
TF32_PASSES = 3
# (use, rows of the bench point's scratch chunk, Cin, Cout): 14,336 sorted
# fluid rows in chunks of scratch_chunk_rows
USES = (("K1 fold", 14336, 96, 64), ("K1 fold", 14336, 64, 64),
        ("K2 d_acc", 14336, 96, 64), ("K2 dW", 14336, 96, 64),
        ("K2 dW", 14336, 64, 3))


def event_ms(torch, fn, reps):
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sweep", default="",
                    help="comma-separated numbers of splits to time")
    ap.add_argument("--precision", default="highest",
                    choices=("highest", "default"))
    args = ap.parse_args()
    bf16 = args.precision == "default"
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("split_gemm_bench: no CUDA device", file=sys.stderr)
        return 1
    from neurofluid_torch.ops import fused_cconv as fc

    if not Path(fc.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {fc.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | root {root}",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(3)
    rows_out = []
    for use, n_rows, cin, cout in USES:
        klen = 64 * cin
        rows = min(n_rows, fc.scratch_chunk_rows(n_rows, klen))
        m, k, n, trans = {"K1 fold": (rows, klen, cout, False),
                          "K2 d_acc": (rows, cout, klen, False),
                          "K2 dW": (klen, rows, cout, True)}[use]
        a = torch.randn((k, m) if trans else (m, k), device=dev, generator=gen)
        b = torch.randn((k, n), device=dev, generator=gen)
        if hasattr(fc, "product_splits"):
            n_split, per = fc.product_splits(m, n, k)
        elif trans:
            n_split, per = fc.dw_split(k, m, n)
        else:
            n_split, per = 1, 0
        kw = dict(trans_a=trans, n_split=n_split, k_per_split=per)
        if bf16:
            kw["precision"] = "default"
            if fc.BF16_KERNELS["product"].symbol == "nf_split_gemm_bf16":
                a = a.to(torch.bfloat16)
        got = fc.split_gemm_cuda(a, b, **kw)
        torch.cuda.synchronize()
        a_op = a.t() if trans else a
        a64, b64 = ((fc.bf16_round(a_op), fc.bf16_round(b)) if bf16
                    else (a_op, b))
        want = a64.double() @ b64.double()
        scale = a64.double().abs() @ b64.double().abs()
        err = float(((got.double() - want).abs() / scale).max())
        ms = event_ms(torch, lambda: fc.split_gemm_cuda(a, b, **kw), args.reps)
        if bf16:
            a_bf, b_bf = a_op.to(torch.bfloat16), b.to(torch.bfloat16)
            try:
                torch.mm(a_bf, b_bf, out_dtype=torch.float32)
                lib = lambda: torch.mm(a_bf, b_bf, out_dtype=torch.float32)  # noqa: E731
            except (TypeError, RuntimeError):
                lib = lambda: torch.matmul(a_bf, b_bf)  # noqa: E731
        else:
            lib = lambda: a_op @ b  # noqa: E731
        lib_ms = event_ms(torch, lib, args.reps)
        t_bytes = (a.element_size() * m * k + 4.0 * (k * n + m * n)) \
            / PEAK_BYTES_PER_S * 1e3
        t_ops = (2.0 * m * k * n / PEAK_BF16_PER_S * 1e3 if bf16 else
                 TF32_PASSES * 2.0 * m * k * n / PEAK_TF32_PER_S * 1e3)
        row = dict(use=use, m=m, k=k, n=n, splits=n_split, err=err, ms=ms,
                   matmul_ms=lib_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        for want_split in [int(x) for x in args.sweep.split(",") if x]:
            per_s = -(k // -want_split // 32) * 32  # ceil(ceil(k / s) / 32)
            kw_s = dict(trans_a=trans, n_split=-(-k // per_s),
                        k_per_split=per_s)
            row.setdefault("sweep", {})[kw_s["n_split"]] = event_ms(
                torch, lambda: fc.split_gemm_cuda(a, b, **kw_s), args.reps)
        rows_out.append(row)
        print(f"{use} ({m} x {k}) x ({k} x {n}), {n_split} splits: err "
              f"{err:.3e} ms {ms:.4f} "
              f"{'cuBLAS bf16' if bf16 else 'torch.matmul'} {lib_ms:.4f} bound "
              f"{row['bound_ms']:.4f} ({row['bound_by']}) share "
              f"{row['bound_ms'] / ms:.2f}"
              + (f" sweep (splits: ms) {row['sweep']}" if "sweep" in row
                 else ""), flush=True)
        del a, b, got, want, scale, a_op
    print(json.dumps({"root": str(root), "device": torch.cuda.get_device_name(0),
                      "smi": smi, "precision": args.precision,
                      "products": rows_out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
