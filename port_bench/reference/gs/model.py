"""The plain reference of the splat spine: render, loss and Adam.

Frozen copies of the port's plain math (this folder: ``geometry``,
``binning`` with ``keys``, ``composite``, ``sh``, ``losses``): activate
and project every splat, cut the tile rects, one sort of the pair keys,
gather the packed attributes in pair order, composite front to back by
128-splat chunks, add the background and the depth sentinel. The
backward is the plain composite backward walking each tile from its
start (it owes nothing to the forward's saved state), and autograd
through the gather and the projection. ``train_steps`` is graphdeco's
step as the port's ``gs_trainer.train_step`` takes it: the full
(1 - 0.2) L1 + 0.2 (1 - SSIM) loss, then the grouped Adam (eps 1e-15,
torch-style bias correction, non-finite gradient entries zeroed).

``lowp=True`` is the control: the step below float32, bfloat16, for
the per-splat arithmetic: the parameters rounded to bfloat16 at each
step, the projected and packed attributes rounded to bfloat16, and the
gradients rounded to bfloat16 before Adam. Compositing accumulates in
float32 in both.
"""

from __future__ import annotations

import math

import torch

from . import binning, composite, geometry, losses

FIELDS = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
          "rotation")
B1, B2, EPS = 0.9, 0.999, 1e-15
TILE = 16


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attrs, seg_start, counts, size):
        tiles8 = composite.composite_segments(attrs, seg_start, counts,
                                              *size)
        ctx.save_for_backward(attrs, seg_start, counts, tiles8)
        ctx.size = size
        return tiles8

    @staticmethod
    def backward(ctx, grad):
        attrs, seg_start, counts, tiles8 = ctx.saved_tensors
        d = composite.composite_segments_bwd(attrs, seg_start, counts,
                                             tiles8, grad.contiguous(),
                                             *ctx.size, None)
        return d, None, None, None


def pack(means2d, conic, opacity, color, depth):
    n = means2d.shape[0]
    return torch.cat([means2d, conic, opacity[:, None], color,
                      depth[:, None],
                      composite.alpha_gate(opacity)[:, None],
                      torch.zeros((n, composite.NROWS - 11),
                                  dtype=torch.float32,
                                  device=means2d.device)], dim=1)


def assemble(tiles, tiles_x, tiles_y, width, height):
    ch = tuple(tiles.shape[2:])
    img = tiles.reshape((tiles_y, tiles_x, TILE, TILE) + ch)
    img = torch.movedim(img, 2, 1)
    img = img.reshape((tiles_y * TILE, tiles_x * TILE) + ch)
    return img[:height, :width]


def render(fields: dict, cam, bg, sh_degree: int, lowp: bool = False):
    """(rgb [H, W, 3], depth [H, W]) of every splat in ``fields``."""
    f = {k: (_bf16(v) if lowp else v) for k, v in fields.items()}
    n = f["xyz"].shape[0]
    live = torch.ones(n, dtype=torch.bool, device=f["xyz"].device)
    scaling = torch.exp(torch.minimum(
        f["scaling"], torch.tensor(20.0, device=f["scaling"].device)))
    rot = f["rotation"]
    rot = rot / torch.sqrt(torch.sum(rot * rot, -1, keepdim=True)).clamp(
        min=1e-12)
    proj = geometry.project_gaussians(
        f["xyz"], torch.cat([f["features_dc"], f["features_rest"]], 1),
        torch.sigmoid(f["opacity"])[:, 0], scaling, rot, live,
        cam.world_view, cam.full_proj, cam.campos, cam.tan_fovx,
        cam.tan_fovy, cam.width, cam.height, sh_degree)
    tiles_x = -(-cam.width // TILE)
    tiles_y = -(-cam.height // TILE)
    bins = binning.bin_gaussians(proj.means2d.detach(), proj.radius,
                                 proj.depth.detach(), tiles_x, tiles_y,
                                 TILE, TILE, extent=proj.extent)
    packed = pack(proj.means2d, proj.conic, proj.opacity, proj.color,
                  proj.depth)
    if lowp:
        packed = _bf16(packed)
    attrs = packed[bins.order[bins.gid_sorted]]
    tiles8 = _Composite.apply(attrs, bins.seg_start, bins.counts,
                              (tiles_x, tiles_y, TILE, TILE))
    t_fin = tiles8[:, 4, :]
    rgb = torch.stack([tiles8[:, c, :] + t_fin * bg[c] for c in range(3)],
                      -1)
    depth = tiles8[:, 3, :] + t_fin * composite.DEPTH_EMPTY
    return (assemble(rgb, tiles_x, tiles_y, cam.width, cam.height),
            assemble(depth, tiles_x, tiles_y, cam.width, cam.height))


def loss_of(rgb, target, lambda_dssim):
    pred, gt = rgb.permute(2, 0, 1), target.permute(2, 0, 1)
    l1 = losses.l1_loss(pred, gt)
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * (
        1.0 - losses.ssim(pred, gt))


def _expon_lr(step, lr_init, lr_final, max_steps, delay_mult):
    # lr_delay_steps is 0 in the train step: no delay ramp
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def group_lrs(opt: dict, step: int, spatial_lr_scale: float) -> dict:
    return {"xyz": _expon_lr(step, opt["position_lr_init"]
                             * spatial_lr_scale, opt["position_lr_final"]
                             * spatial_lr_scale, opt["position_lr_max_steps"],
                             opt["position_lr_delay_mult"]),
            "features_dc": opt["feature_lr"],
            "features_rest": opt["feature_lr"] / 20.0,
            "opacity": opt["opacity_lr"], "scaling": opt["scaling_lr"],
            "rotation": opt["rotation_lr"]}


def train_steps(fields: dict, cams, targets, bg, opt: dict,
                spatial_lr_scale: float, sh_degree: int, steps: int,
                lowp: bool = False) -> dict:
    """``steps`` train steps from ``fields`` on views 0, 1, ... Returns
    {"losses": [...], "grads": {field: first step's gradient},
    "fields": {field: after the last step}}."""
    p = {k: v.detach().clone() for k, v in fields.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    out = {"losses": []}
    for i in range(steps):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        rgb, _ = render(leaves, cams[i], bg, sh_degree, lowp)
        loss = loss_of(rgb, targets[i], opt["lambda_dssim"])
        grads = torch.autograd.grad(loss, [leaves[k] for k in FIELDS])
        out["losses"].append(float(loss.detach()))
        step = i + 1
        lrs = group_lrs(opt, step, spatial_lr_scale)
        bc1, bc2 = 1.0 - B1 ** step, 1.0 - B2 ** step
        with torch.no_grad():
            for k, g in zip(FIELDS, grads):
                g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
                if lowp:
                    g = _bf16(g)
                if i == 0:
                    out.setdefault("grads", {})[k] = g.clone()
                mu[k] = B1 * mu[k] + (1 - B1) * g
                nu[k] = B2 * nu[k] + (1 - B2) * g * g
                p[k] = p[k] - lrs[k] * (mu[k] / bc1) / (
                    torch.sqrt(nu[k] / bc2) + EPS)
    out["fields"] = p
    return out
