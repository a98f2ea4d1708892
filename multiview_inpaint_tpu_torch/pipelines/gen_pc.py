"""Dump a downsampled colored xyz point cloud — reference ``gen_pc.py``.

Writes ``xyz.ply`` (10k random points with SH-DC colors) for bounding-box
placement in external tools.

    python -m multiview_inpaint_tpu_torch.pipelines.gen_pc -m output/<scene>

Port of ``multiview_inpaint_tpu/pipelines/gen_pc.py``. It does no device
work: the PLY is read and subsampled in numpy with the same draw
(``default_rng(0)``), so both packages write the same file.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..gs import ply_io
from ..utils import sh as sh_utils


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--iteration", type=int, default=30000)
    parser.add_argument("--sh_degree", type=int, default=0)
    parser.add_argument("--sample_num", type=int, default=10000)
    args = parser.parse_args(argv)

    src = os.path.join(args.model_path, "point_cloud",
                       f"iteration_{args.iteration}", "point_cloud.ply")
    d = ply_io.load_gaussian_ply(src, args.sh_degree)
    xyz = d["xyz"]
    color = np.clip(sh_utils.C0 * d["features_dc"][:, 0] + 0.5, 0, 1)
    if len(xyz) > args.sample_num:
        idx = np.random.default_rng(0).permutation(len(xyz))[
            :args.sample_num]
        xyz, color = xyz[idx], color[idx]
    dst = os.path.join(args.model_path, "xyz.ply")
    ply_io.store_point_cloud(dst, xyz, color * 255)
    print(f"wrote {len(xyz)} points -> {dst}")


if __name__ == "__main__":
    main()
