"""Split logged 4x4 sample grids into per-view frames + preview video.

Reference ``svd_inpaint1/divide_test.py:20-86``: slices the padded grid
(pad=2) back into 14 frames per (scene, ctrl, mode) and writes
``inpainted/<scene>/<ctrl>/<mode>/NN.png`` plus a GIF preview (x1
reversed without its first frame, then x2). ``svd_test`` already writes
the frames directly; this exists for parity with externally produced
grids. Copy of ``multiview_inpaint_tpu/pipelines/divide_test.py`` (numpy
and PIL only; no device work).

    python -m multiview_inpaint_tpu_torch.pipelines.divide_test \
        --grid_dir logs/test/log_img/test --out gs/inpainted \
        --items toy_case:ctrl_0:x1 ...
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..gs import scene_io


def split_grid(grid: np.ndarray, frame_hw, num_frames: int = 14,
               ncol: int = 4, pad: int = 2):
    h, w = frame_hw
    frames = []
    for i in range(num_frames):
        r, c = divmod(i, ncol)
        y = pad + r * (h + pad)
        x = pad + c * (w + pad)
        frames.append(grid[y:y + h, x:x + w])
    return frames


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--grid_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--items", nargs="+", required=True,
                   help="scene:ctrl:mode per grid, in grid file order")
    p.add_argument("--frame_size", type=int, nargs=2, default=[512, 384],
                   help="H W of each frame inside the grid")
    p.add_argument("--num_frames", type=int, default=14)
    args = p.parse_args(argv)

    grids = sorted(f for f in os.listdir(args.grid_dir)
                   if f.startswith("samples") and f.endswith(".png"))
    if len(grids) != len(args.items):
        raise SystemExit(f"{len(grids)} grids vs {len(args.items)} items")
    by_case: dict = {}
    for fname, item in zip(grids, args.items):
        scene, ctrl, mode = item.split(":")
        grid = scene_io.load_image(os.path.join(args.grid_dir, fname))
        frames = split_grid(grid, args.frame_size, args.num_frames)
        out_dir = os.path.join(args.out, scene, ctrl, mode)
        for i, fr in enumerate(frames):
            scene_io.save_image(os.path.join(out_dir, f"{i:02d}.png"), fr)
        by_case.setdefault((scene, ctrl), {})[mode] = frames
        print(f"{fname} -> {out_dir} ({len(frames)} frames)")

    # Preview video per case, reference frame order (divide_test.py:68-86):
    # x1 played backwards (dropping its first frame) then x2 forwards.
    from PIL import Image
    for (scene, ctrl), modes in by_case.items():
        seq = list(reversed(modes.get("x1", [])[1:])) + modes.get("x2", [])
        if not seq:
            continue
        vids = os.path.join(args.out, "vis_video", scene)
        os.makedirs(vids, exist_ok=True)
        imgs = [Image.fromarray((np.clip(f, 0, 1) * 255).astype(np.uint8))
                for f in seq]
        path = os.path.join(vids, f"{ctrl}.gif")
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=100, loop=0)
        print(f"preview -> {path} ({len(imgs)} frames)")


if __name__ == "__main__":
    main()
