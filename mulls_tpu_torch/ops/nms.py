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
    mirrors the reference's stable sort order.  Leading dimensions of
    ``xyz`` [..., n, 3] are batch entries, each suppressed on its own."""
    n = xyz.shape[-2]
    r2 = radius * radius
    idx = torch.arange(n, dtype=torch.int64, device=xyz.device)
    # strict priority: larger salience wins; ties -> smaller index wins
    prio = torch.where(mask, salience, -float("inf"))

    def stronger_neighbor_exists(keep):
        keep_f = (keep & mask)[..., None, :]
        pr = prio[..., None, :]
        parts = []
        for s in range(0, n, chunk):
            qx, qi = xyz[..., s:s + chunk, :], idx[s:s + chunk, None]
            qp = prio[..., s:s + chunk, None]
            close = pairwise_sqdist(qx, xyz) < r2
            stronger = (pr > qp) | ((pr == qp) & (idx < qi))
            parts.append(torch.any(close & stronger & keep_f, dim=-1))
        return torch.cat(parts, dim=-1)

    keep = mask
    for _ in range(iterations):
        keep = mask & ~stronger_neighbor_exists(keep)
    return keep
