"""OBB object deletion — reference ``gs-simp/del.py``.

Removes all gaussians inside the user-placed deletion box
(``bds/del/<scene>.obj``) from the iteration-30000 checkpoint and writes
``point_cloud/del/point_cloud.ply``. Point-in-box test = bidirectional
+-x ray hit, identical semantics to ``del.py:105-117``.

    python -m multiview_inpaint_tpu_torch.pipelines.delete -m output/<scene> \
        --box bds/del/<scene>.obj [--device cuda|cpu]

Port of ``multiview_inpaint_tpu/pipelines/delete.py``: the test runs on
the device in chunks of 65,536 points; the removed rows leave ``live``
and only live rows are written.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from ..gs import gaussians as g_mod
from ..gs import obb as obb_mod
from ..utils.device import resolve_device
from . import common


def delete_in_box(params, box, chunk: int = 65536):
    """(params with the rows inside ``box`` dead, number removed)."""
    inside = torch.cat([obb_mod.contains(box, params.xyz[i:i + chunk])
                        for i in range(0, params.capacity, chunk)])
    removed = int((params.live & inside).sum())
    return dataclasses.replace(params, live=params.live & ~inside), removed


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--box", required=True,
                        help="deletion OBB obj file")
    parser.add_argument("--iteration", type=int, default=30000)
    parser.add_argument("--sh_degree", type=int, default=0)
    common.add_device_arg(parser)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    src = os.path.join(args.model_path, "point_cloud",
                       f"iteration_{args.iteration}", "point_cloud.ply")
    params = g_mod.load_ply(src, args.sh_degree, device=dev)
    box = obb_mod.load_obb(args.box)
    with torch.no_grad():
        params, n_removed = delete_in_box(params, box)
    dst = os.path.join(args.model_path, "point_cloud", "del",
                       "point_cloud.ply")
    g_mod.save_ply(params, dst)
    print(f"removed {n_removed} gaussians inside box; "
          f"{int(params.num_live())} remain -> {dst}")


if __name__ == "__main__":
    main()
