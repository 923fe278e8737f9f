"""The work that a radius kernel's inputs need: the pairs of query and
valid support point within the query's radius (hits), counted by the
benchmark itself over [chunk, P] blocks with the kernels' own squared
distance, ``((q-p)_x^2 + (q-p)_y^2) + (q-p)_z^2``."""

from __future__ import annotations

from typing import Optional

import torch


def hits(q_xyz: torch.Tensor, p_xyz: torch.Tensor, p_mask: torch.Tensor,
         r2: torch.Tensor, close_r2: Optional[torch.Tensor] = None,
         chunk: int = 2048) -> tuple:
    """(hits, hits within ``min(r2, close_r2)``) over every batch entry."""
    qn, pn = q_xyz.shape[-2], p_xyz.shape[-2]
    n = q_xyz.numel() // (3 * qn) if qn else 0
    q, p = q_xyz.reshape(n, qn, 3), p_xyz.reshape(n, pn, 3)
    pm, r = p_mask.reshape(n, pn), r2.reshape(n, qn)
    c = close_r2.reshape(n, qn) if close_r2 is not None else None
    total = torch.zeros((), dtype=torch.float64, device=q_xyz.device)
    close = torch.zeros_like(total)
    for e in range(n):
        for s in range(0, qn, chunk):
            d = q[e, s:s + chunk, None, :] - p[e, None, :, :]
            d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
                + d[..., 2] * d[..., 2]
            adj = pm[e, None, :] & (d2 <= r[e, s:s + chunk, None])
            total += adj.sum()
            if c is not None:
                close += (adj & (d2 <= c[e, s:s + chunk, None])).sum()
    return float(total), float(close)
