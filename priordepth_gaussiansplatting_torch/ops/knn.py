"""Mean squared distance to the 3 nearest neighbours, for scale seeding at
initialisation (counterpart of the JAX package's ``ops/knn.py``).

A chunked brute-force search: ||a - b||^2 = ||a||^2 + ||b||^2 - 2 a.b with
the (chunk, N) product as one matrix multiply, then the k smallest per row.
It runs once per scene at init time, so plain PyTorch is enough.
"""

from __future__ import annotations

import torch


def mean_knn_sq_dist(points: torch.Tensor, k: int = 3,
                     chunk: int = 1024) -> torch.Tensor:
    """(N, 3) points -> (N,) mean squared distance to the k nearest
    neighbours, self excluded (distCUDA2 semantics; the caller clamps)."""
    n = points.shape[0]
    sq = torch.sum(points * points, dim=-1)
    cols = torch.arange(n, device=points.device)
    out = []
    for s in range(0, n, chunk):
        p = points[s:s + chunk]
        d2 = (torch.sum(p * p, dim=-1)[:, None] + sq[None, :]
              - 2.0 * p @ points.T)
        rows = cols[s:s + chunk]
        d2 = torch.where(cols[None, :] == rows[:, None],
                         torch.full_like(d2, float("inf")), d2)
        near = torch.topk(d2, k, dim=1, largest=False).values
        out.append(torch.mean(torch.clamp_min(near, 0.0), dim=-1))
    return torch.cat(out)
