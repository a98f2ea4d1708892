"""Object segmentation masks for recomposition — reference stage 3.

Port of ``multiview_inpaint_tpu/pipelines/seg_masks.py``. It writes
``inpaint/sam_mask/<scene_case>/ctrl_<k>/<mode>/NN.png``:

- ``--import_dir``: copy externally produced SAM masks into the layout
  (the reference workflow, with any segmenter);
- ``--auto``: segment the inserted object as the box-constrained
  difference between the inpainted frames and the original renders,
  after a per-channel affine colour fit over the outside-box background
  (``--no_bg_fit`` turns it off); ``--propagate`` adds temporal mask
  propagation along the orbit through the known poses and the box-centre
  plane (the stand-in for the reference's AOT tracker,
  ``seg_gs.py:141-160``), unioned with each frame's own evidence;
- ``--ground``: keep only the difference components that overlap the
  CLIP-grounded window of each frame (``guidance/grounding``); the
  towers come from ``--clip_ckpt`` (the JAX npz layout: ``vision/...``,
  ``text/...``, optional ``vit_cfg/...`` and ``text_features``), a
  plain-text query needs the text tower and ``--bpe_vocab``. The grounder
  runs on ``--device`` (default ``cuda``; it raises without a card unless
  ``--device cpu``). The mask arithmetic is float64 numpy, as in the JAX
  package, on every device.

    python -m multiview_inpaint_tpu_torch.pipelines.seg_masks \\
        --scene_id <scene>_<case> --ctrl_id 0 --auto --propagate \\
        --fovx <rad> --fovy <rad> [--modes x1 x2]
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from ..gs import scene_io
from ..gs.scene import Workspace
from . import common


def _binary_cleanup(mask: np.ndarray, iters: int = 2) -> np.ndarray:
    """Cheap 3x3 morphological close/open via min/max filters."""
    def dilate(m):
        p = np.pad(m, 1)
        return np.max([p[dy:dy + m.shape[0], dx:dx + m.shape[1]]
                       for dy in range(3) for dx in range(3)], axis=0)

    def erode(m):
        p = np.pad(m, 1, constant_values=1)
        return np.min([p[dy:dy + m.shape[0], dx:dx + m.shape[1]]
                       for dy in range(3) for dx in range(3)], axis=0)

    for _ in range(iters):
        mask = erode(dilate(mask))   # close
    for _ in range(iters):
        mask = dilate(erode(mask))   # open
    return mask


def _fit_background(inpainted: np.ndarray, render: np.ndarray,
                    bg_sel: np.ndarray) -> np.ndarray:
    """Per-channel affine fit ``inpainted ~ a*render + b`` over the
    background (outside-box) pixels; returns the corrected render."""
    out = render.copy()
    if bg_sel.sum() < 16:
        return out
    for c in range(render.shape[-1]):
        x = render[..., c][bg_sel]
        y = inpainted[..., c][bg_sel]
        var = float(x.var())
        if var < 1e-8:
            a, b = 1.0, float(y.mean() - x.mean())
        else:
            a = float(((x - x.mean()) * (y - y.mean())).mean() / var)
            b = float(y.mean() - a * x.mean())
        out[..., c] = a * render[..., c] + b
    return out


def propagate_mask(mask: np.ndarray, pose_a: np.ndarray,
                   pose_b: np.ndarray, k_mat: np.ndarray,
                   center: np.ndarray) -> np.ndarray:
    """Project frame-a's object mask into frame b's image through the
    plane at the box center (normal to a's view axis): unproject each
    masked a-pixel to the center-plane depth, transform a->world->b,
    forward-splat into b, close splat holes."""
    h, w = mask.shape
    pa = np.eye(4, dtype=np.float64)
    pa[:pose_a.shape[0]] = pose_a
    pb = np.eye(4, dtype=np.float64)
    pb[:pose_b.shape[0]] = pose_b
    c_a = (np.linalg.inv(pa) @ np.append(center, 1.0))[:3]
    z0 = float(c_a[2])
    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    x = (jj - k_mat[0, 2]) / k_mat[0, 0] * z0
    y = (ii - k_mat[1, 2]) / k_mat[1, 1] * z0
    pts = np.stack([x, y, np.full_like(x, z0, dtype=np.float64),
                    np.ones_like(x, dtype=np.float64)], 0).reshape(4, -1)
    cam_b = np.linalg.inv(pb) @ (pa @ pts)
    z = cam_b[2]
    zs = np.where(np.abs(z) > 1e-9, z, 1e-9)
    u = np.round(cam_b[0] / zs * k_mat[0, 0] + k_mat[0, 2]).astype(int)
    v = np.round(cam_b[1] / zs * k_mat[1, 1] + k_mat[1, 2]).astype(int)
    sel = ((mask.reshape(-1) > 0.5) & (z > 1e-6)
           & (u >= 0) & (u < w) & (v >= 0) & (v < h))
    out = np.zeros_like(mask)
    out[v[sel], u[sel]] = 1.0
    # close the splatting holes (forward warp is not surjective)
    return _binary_cleanup(out, iters=1)


def _sub(flat, name):
    """The entries of flat npz params under ``name/``, prefix stripped."""
    pre = name + "/"
    return {k[len(pre):]: v for k, v in flat.items() if k.startswith(pre)}


def load_grounder(clip_ckpt: str, bpe_vocab, device):
    """(grounder, text_features row or None) from a ``--clip_ckpt`` npz in
    the JAX layout."""
    from ..diffusion.checkpoint import load_params
    from ..diffusion.clip_vit import ViTConfig
    from ..guidance.grounding import CLIPGrounder

    clip = load_params(clip_ckpt)
    vit_cfg = None
    cfg = _sub(clip, "vit_cfg")
    if cfg:   # non-default tower geometry in the npz
        vit_cfg = ViTConfig(**{k: int(v) for k, v in cfg.items()})
    text = _sub(clip, "text") or None
    grounder = CLIPGrounder.from_jax_params(
        _sub(clip, "vision"), vit_cfg=vit_cfg, text_params=text,
        bpe_path=bpe_vocab, device=device)
    return grounder, clip.get("text_features")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene_id", required=True)
    p.add_argument("--ctrl_id", type=int, default=0)
    p.add_argument("--modes", nargs="+", default=["x1", "x2"])
    p.add_argument("--frames", type=int, default=14)
    p.add_argument("--iteration", type=int, default=30000)
    p.add_argument("--workspace", default=".")
    p.add_argument("--inpaint_root", default="inpaint",
                   help="inpaint hand-off dir (abs or relative to workspace)")
    p.add_argument("--import_dir", default=None,
                   help="directory of externally produced masks "
                        "(<mode>/NN.png)")
    p.add_argument("--auto", action="store_true",
                   help="difference-based native segmentation")
    p.add_argument("--threshold", type=float, default=0.08)
    p.add_argument("--no_bg_fit", action="store_true",
                   help="disable the affine background color fit")
    p.add_argument("--propagate", action="store_true",
                   help="temporal mask propagation along the orbit "
                        "(needs poses.npy/cam_center.npy in the seq dir "
                        "and --fovx/--fovy)")
    p.add_argument("--fovx", type=float, default=None,
                   help="horizontal fov (radians) of the seq renders")
    p.add_argument("--fovy", type=float, default=None)
    p.add_argument("--ground", default=None,
                   help="object name/description: keep only difference "
                        "components overlapping the CLIP-grounded "
                        "window per frame (the reference grounds with "
                        "Grounding-DINO, seg_gs.py:94-117); needs "
                        "--clip_ckpt")
    p.add_argument("--clip_ckpt", default=None,
                   help="npz with 'vision' (+'text') CLIP tower params "
                        "in the JAX layout")
    p.add_argument("--bpe_vocab", default=None,
                   help="CLIP BPE merges file (for plain-text --ground; "
                        "an npz text-embedding row in --clip_ckpt "
                        "['text_features'] works without it)")
    p.add_argument("--ground_min_overlap", type=float, default=0.05)
    common.add_device_arg(p)
    args = p.parse_args(argv)
    if args.ground and not args.clip_ckpt:
        raise SystemExit("--ground needs --clip_ckpt")
    if args.propagate and (args.fovx is None or args.fovy is None):
        raise SystemExit("--propagate needs --fovx and --fovy")

    grounder = None
    text_query = None
    if args.ground:
        from ..guidance.grounding import box_to_mask, filter_components
        grounder, features = load_grounder(args.clip_ckpt, args.bpe_vocab,
                                           args.device)
        # precomputed prompt embedding beats needing the BPE file
        text_query = features if features is not None else args.ground
        if isinstance(text_query, str) and (
                grounder.text is None or not args.bpe_vocab):
            raise SystemExit(
                "--ground with a plain-text query needs either a "
                "'text_features' row in --clip_ckpt or 'text' tower "
                "params + --bpe_vocab")

    ws = Workspace(args.workspace, args.inpaint_root)
    for mode in args.modes:
        out_dir = ws.sam_mask_dir(args.scene_id, args.ctrl_id, mode)
        os.makedirs(out_dir, exist_ok=True)
        if args.import_dir:
            src = os.path.join(args.import_dir, mode)
            for f in sorted(os.listdir(src)):
                shutil.copy(os.path.join(src, f), os.path.join(out_dir, f))
            print(f"imported {mode} masks -> {out_dir}")
            continue
        if not args.auto:
            raise SystemExit("pass --import_dir or --auto")
        seq = ws.seq_dir(args.scene_id, mode, args.iteration)
        inp = ws.inpainted_dir(args.scene_id, args.ctrl_id, mode)
        masks, boxes = [], []
        for i in range(args.frames):
            v = f"{i:02d}"
            inpainted = scene_io.load_image(os.path.join(inp, f"{v}.png"))
            # renders/box masks are at gen_seq's (SVD input) resolution;
            # compare at the inpainted frames' resolution
            res = (inpainted.shape[1], inpainted.shape[0])
            render = scene_io.load_image(os.path.join(seq, "renders",
                                                      f"{v}.png"),
                                         resolution=res)
            box = scene_io.load_image(os.path.join(seq, "mask",
                                                   f"{v}.png"),
                                      resolution=res, grayscale=True)
            if not args.no_bg_fit:
                render = _fit_background(inpainted, render, box <= 0.5)
            diff = np.abs(inpainted - render).mean(axis=-1)
            mask = ((diff > args.threshold) & (box > 0.5)).astype(
                np.float32)
            mask = _binary_cleanup(mask)
            if grounder is not None:
                gbox, _ = grounder(inpainted, text_query)
                mask = filter_components(
                    mask, box_to_mask(gbox, *mask.shape),
                    min_overlap=args.ground_min_overlap)
            masks.append(mask)
            boxes.append(box)

        if args.propagate:
            poses = np.load(os.path.join(seq, "poses.npy"))
            center = np.load(os.path.join(seq, "cam_center.npy"))[0]
            h, w = masks[0].shape
            k_mat = np.array(
                [[0.5 * w / np.tan(args.fovx / 2), 0.0, w / 2],
                 [0.0, 0.5 * h / np.tan(args.fovy / 2), h / 2],
                 [0.0, 0.0, 1.0]])
            for i in range(1, len(masks)):
                prop = propagate_mask(masks[i - 1], poses[i - 1],
                                      poses[i], k_mat, center)
                masks[i] = _binary_cleanup(np.maximum(
                    masks[i], prop * (boxes[i] > 0.5)))

        for i, mask in enumerate(masks):
            scene_io.save_image(os.path.join(out_dir, f"{i:02d}.png"),
                                mask)
        print(f"auto {mode} masks -> {out_dir}")


if __name__ == "__main__":
    main()
