"""Generate synthetic scenes on disk with the port's `data.synthetic` (a
copy of neurofluid_tpu/cli/generate_data.py; the SPlisHSPlasH scene runner is
`neurofluid_torch.data_generation`).

Usage:
    python -m neurofluid_torch.cli.generate_data --out data/synthetic/watercube \
        --frames 60 --img-size 400 --n-side 24
"""

import argparse

from neurofluid_torch.data import synthetic


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--img-size", type=int, default=400)
    p.add_argument("--n-side", type=int, default=24, help="blob is n^3 particles")
    p.add_argument("--seed", type=int, default=10)
    p.add_argument("--raw", action="store_true", help="also write raw sim layout")
    args = p.parse_args(argv)

    synthetic.generate_blender_scene(
        args.out, n_frames=args.frames, n_side=args.n_side,
        img_wh=(args.img_size, args.img_size), seed=args.seed,
    )
    if args.raw:
        synthetic.generate_raw_dataset(
            args.out + "_raw", n_sims=2, n_frames=args.frames,
            n_side=max(4, args.n_side // 2), seed=args.seed,
        )
    print("wrote", args.out)


if __name__ == "__main__":
    main()
