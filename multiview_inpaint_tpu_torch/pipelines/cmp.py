"""Evaluation loop over rendered comparisons — reference ``metrics/cmp.py``.

Port of ``multiview_inpaint_tpu/pipelines/cmp.py``: walks
``vis/cmp/<exp>/{inpainted,src}/<scene>/ours_<iter>/renders`` (the layout
the ``render`` CLI writes under its model path), scores ``--n_frame``
frames per scene (every ``len // n_frame``-th) and writes a JSON report
with a global ``mean``: sharpness always, PSNR against the source scene
(``<scene>`` up to its first ``_``) where it exists, MUSIQ and WaDIQaM
when their weights are given (npz files in the JAX ``save_params``
layout, read by ``diffusion/checkpoint.load_params``). The networks run
on ``--device``; like the JAX CLI it has no CLIP metric flag.

    python -m multiview_inpaint_tpu_torch.pipelines.cmp --root vis/cmp/exp1 \\
        --out report.json [--musiq_ckpt m.npz] [--wadiqam_ckpt w.npz] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..gs import scene_io
from ..metrics import metrics as M
from ..utils.device import resolve_device
from . import common


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True)
    p.add_argument("--iteration", type=int, default=30000)
    p.add_argument("--n_frame", type=int, default=10)
    p.add_argument("--out", default="metrics.json")
    p.add_argument("--musiq_ckpt", default=None,
                   help="npz MUSIQ weights (convert torch ckpts with "
                        "metrics.musiq.import_musiq); adds the "
                        "reference's no-reference quality score")
    p.add_argument("--wadiqam_ckpt", default=None,
                   help="npz WaDIQaM-NR weights (convert torch ckpts "
                        "with metrics.wadiqam.import_wadiqam); adds the "
                        "reference's second no-reference score "
                        "(metrics.py WADIQMA)")
    common.add_device_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    musiq_score = None
    if args.musiq_ckpt:
        from ..diffusion.checkpoint import load_params
        from ..metrics.musiq import MUSIQScorer
        musiq_score = MUSIQScorer(load_params(args.musiq_ckpt), device=dev)
    wadiqam_score = None
    if args.wadiqam_ckpt:
        from ..diffusion.checkpoint import load_params
        from ..metrics.wadiqam import WaDIQaMScorer
        wadiqam_score = WaDIQaMScorer(load_params(args.wadiqam_ckpt),
                                      device=dev)

    inp_root = os.path.join(args.root, "inpainted")
    src_root = os.path.join(args.root, "src")
    report = {}
    for scene in sorted(os.listdir(inp_root)):
        rdir = os.path.join(inp_root, scene, f"ours_{args.iteration}",
                            "renders")
        if not os.path.isdir(rdir):
            continue
        files = sorted(os.listdir(rdir))
        step = max(1, len(files) // args.n_frame)
        frames = [scene_io.load_image(os.path.join(rdir, f))
                  for f in files[::step][:args.n_frame]]
        entry = {"sharpness": float(np.mean(
            [M.laplacian_sharpness(f) for f in frames]))}
        if musiq_score is not None:
            entry["musiq"] = float(np.mean(
                [musiq_score(f) for f in frames]))
        if wadiqam_score is not None:
            entry["wadiqam"] = float(np.mean(
                [wadiqam_score(f) for f in frames]))
        sdir = os.path.join(src_root, scene.split("_")[0],
                            f"ours_{args.iteration}", "renders")
        if os.path.isdir(sdir):
            sfiles = sorted(os.listdir(sdir))
            src_frames = [scene_io.load_image(os.path.join(sdir, f))
                          for f in sfiles[::step][:args.n_frame]]
            n = min(len(frames), len(src_frames))
            entry["psnr_vs_src"] = float(np.mean(
                [M.psnr(frames[i], src_frames[i]) for i in range(n)]))
        report[scene] = entry
    if report:
        keys = set().union(*(set(v) for v in report.values()))
        report["mean"] = {k: float(np.mean(
            [v[k] for v in report.values() if isinstance(v, dict)
             and k in v])) for k in keys}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report.get("mean", {}), indent=1))


if __name__ == "__main__":
    main()
