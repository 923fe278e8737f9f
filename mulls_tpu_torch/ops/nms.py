"""Non-max suppression "sharpening" of feature clouds — port of
``mulls_tpu/ops/nms.py``.

The reference greedily walks points in descending saliency and suppresses
everything within a radius (`cfilter.hpp:1183-1312`).  Here, as in the JAX
package, it is the fixed-point iteration of matrix-NMS:

    keep[i]  <-  not exists j: salience_j > salience_i, d_ij < r, keep[j]

starting from keep = valid; 2-3 iterations match greedy on LiDAR feature
clouds to within a few points per thousand.  Plain PyTorch over
[chunk, N] blocks (the reference has no fused kernel for it).
"""

from __future__ import annotations

import torch

from mulls_tpu_torch.ops.neighbors import pairwise_sqdist


def non_max_suppress(xyz: torch.Tensor, salience: torch.Tensor,
                     mask: torch.Tensor, radius: float, iterations: int = 3,
                     chunk: int = 2048) -> torch.Tensor:
    """Returns the keep mask. Ties broken by index (earlier wins), which
    mirrors the reference's stable sort order."""
    n = xyz.shape[0]
    r2 = radius * radius
    idx = torch.arange(n, dtype=torch.int64, device=xyz.device)
    # strict priority: larger salience wins; ties -> smaller index wins
    prio = torch.where(mask, salience, -float("inf"))

    def stronger_neighbor_exists(keep):
        keep_f = keep & mask
        parts = []
        for s in range(0, n, chunk):
            qx, qp, qi = xyz[s:s + chunk], prio[s:s + chunk], idx[s:s + chunk]
            close = pairwise_sqdist(qx, xyz) < r2
            stronger = (prio[None, :] > qp[:, None]) | (
                (prio[None, :] == qp[:, None]) & (idx[None, :] < qi[:, None]))
            parts.append(torch.any(close & stronger & keep_f[None, :], dim=1))
        return torch.cat(parts)

    keep = mask
    for _ in range(iterations):
        keep = mask & ~stronger_neighbor_exists(keep)
    return keep
