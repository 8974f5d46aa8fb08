"""Convert particle dumps between formats (pkl/npz -> obj/ply); a copy of
neurofluid_tpu/cli/convert_particles.py over the port's `data.io`
(reference utils/particles_utils.py:45-69).

Usage:
    python -m neurofluid_torch.cli.convert_particles \
        --data_path dumps/ --dst_path out/ --record_type ply
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp

from neurofluid_torch.data import io as data_io


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", required=True)
    p.add_argument("--dst_path", required=True)
    p.add_argument("--record_type", default="ply", choices=["ply", "obj"])
    args = p.parse_args(argv)
    os.makedirs(args.dst_path, exist_ok=True)

    paths = sorted(glob.glob(osp.join(args.data_path, "*.pkl"))
                   + glob.glob(osp.join(args.data_path, "*.npz")))
    for path in paths:
        kind = "blender" if path.endswith(".pkl") else "splishsplash"
        pos, _vel = data_io.read_particles(path, kind)
        stem = osp.splitext(osp.basename(path))[0]
        dst = osp.join(args.dst_path, f"{stem}.{args.record_type}")
        if args.record_type == "ply":
            data_io.write_ply_pointcloud(pos, dst)
        else:
            with open(dst, "w") as fp:
                data_io.write_obj_pointcloud(pos, fp)
    print(f"converted {len(paths)} files -> {args.dst_path}")


if __name__ == "__main__":
    main()
