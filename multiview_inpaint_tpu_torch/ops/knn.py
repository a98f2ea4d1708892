"""K-nearest-neighbour mean squared distance for gaussian scale init.

Port of ``multiview_inpaint_tpu/ops/knn.py`` (the reference's CUDA
``simple-knn`` / ``distCUDA2``): the mean squared distance from each point
to its 3 nearest other points, used once at init to size new gaussians.
Exact brute force in query chunks: ``torch.cdist`` gives a [chunk, N]
distance block and ``topk`` its 3 smallest entries, so memory stays at
[chunk, N].
"""

from __future__ import annotations

import torch


def knn_mean_sq_dist(points: torch.Tensor, k: int = 3,
                     chunk: int = 4096) -> torch.Tensor:
    """[N, 3] points -> [N] mean squared distance to the k nearest others."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=pts.device)
    for lo in range(0, n, chunk):
        q = pts[lo:lo + chunk]
        d2 = torch.cdist(q, pts).square()
        rows = torch.arange(q.shape[0], device=pts.device)
        d2[rows, rows + lo] = float("inf")      # exclude the point itself
        out[lo:lo + chunk] = torch.topk(d2, k, dim=1,
                                        largest=False).values.mean(dim=1)
    return out
