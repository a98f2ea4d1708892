"""Frames -> animated GIF/video — reference ``gs-simp/vis.py`` (AVI).

    python -m multiview_inpaint_tpu_torch.pipelines.vis \
        --frames_dir vis/vis_video/inpainted/<scene_case>/ctrl_0/renders \
        [--out video.gif] [--fps 10]

Port of ``multiview_inpaint_tpu/pipelines/vis.py``: PIL only, no device
work.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames_dir", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--fps", type=int, default=10)
    args = p.parse_args(argv)

    from PIL import Image
    files = sorted(f for f in os.listdir(args.frames_dir)
                   if f.endswith(".png"))
    if not files:
        raise SystemExit(f"no frames in {args.frames_dir}")
    frames = [Image.open(os.path.join(args.frames_dir, f)).convert("RGB")
              for f in files]
    out = args.out or os.path.join(os.path.dirname(args.frames_dir.rstrip("/")),
                                   "video.gif")
    frames[0].save(out, save_all=True, append_images=frames[1:],
                   duration=int(1000 / args.fps), loop=0)
    print(f"{len(frames)} frames -> {out}")


if __name__ == "__main__":
    main()
