"""The three neighbourhood operations of the step in plain PyTorch: 1-NN,
radius moments and query-centred PCA moments, each over blocks of a full
distance matrix (brute force), with no kernel library behind them.

A frozen copy of the plain versions that sit beside the port's CUDA
kernels.  The squared distance is ``((q-p)_x^2 + (q-p)_y^2) + (q-p)_z^2``
with every operation rounded on its own, so the adjacency and the argmin
are those that the port's kernels promise bit for bit; the sums differ
from a kernel's only in their order.

The operands are rounded as ``mulls_ref.precision`` says: float32
unchanged (the reference) or TF32 (the control).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from mulls_ref import precision as _p

_BIG = 3.0e38


def _low(*ts):
    """The operands in the working precision (the radii, which are
    compared and not multiplied, stay as given)."""
    if _p.precision() == "fp32":
        return list(ts)
    return [t if t is None or not t.is_floating_point() else _p.to_tf32(t)
            for t in ts]


def sqdist_direct(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """[Q,3] x [P,3] -> [Q,P]: ((dx*dx + dy*dy) + dz*dz), d = q - p."""
    dx = q[:, 0:1] - p[None, :, 0]
    dy = q[:, 1:2] - p[None, :, 1]
    dz = q[:, 2:3] - p[None, :, 2]
    return dx * dx + dy * dy + dz * dz


def _per_entry(fn, args, point_dims: int):
    """``fn`` on each batch entry of ``args`` (the batch dimensions are all
    but the last ``point_dims`` of the first argument), outputs stacked."""
    lead = args[0].shape[:args[0].dim() - point_dims]
    n = math.prod(lead)
    flat = [None if a is None else a.reshape(n, *a.shape[len(lead):])
            for a in args]
    outs = [fn(*[None if a is None else a[b] for a in flat])
            for b in range(n)]
    return tuple(None if o[0] is None else
                 torch.stack(o).reshape(*lead, *o[0].shape)
                 for o in zip(*outs))


def nn_plain(q_xyz: torch.Tensor, q_mask: torch.Tensor, p_xyz: torch.Tensor,
             p_mask: torch.Tensor, chunk: int = 2048
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN over [chunk, P] distance blocks, each batch entry on its own:
    (idx int32, squared distance); ties go to the lowest support index,
    invalid queries get 3.0e38."""
    if q_xyz.dim() > 2:
        return _per_entry(nn_plain, (q_xyz, q_mask, p_xyz, p_mask), 2)
    idx_parts, d2_parts = [], []
    for s in range(0, max(q_xyz.shape[0], 1), chunk):  # Q = 0: one block
        d2 = sqdist_direct(q_xyz[s:s + chunk], p_xyz)
        d2 = torch.where(p_mask[None, :], d2, _BIG)
        idx = torch.argmin(d2, dim=1)  # first minimum: lowest index wins
        idx_parts.append(idx.to(torch.int32))
        d2_parts.append(torch.gather(d2, 1, idx[:, None])[:, 0])
    idx = torch.cat(idx_parts)
    d2 = torch.where(q_mask, torch.cat(d2_parts), _BIG)
    return idx, d2


def nn(q_xyz, q_mask, p_xyz, p_mask):
    q_xyz, p_xyz = _low(q_xyz, p_xyz)
    return nn_plain(q_xyz, q_mask, p_xyz, p_mask)


NnProblem = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def nn_grouped(problems: Sequence[NnProblem]
               ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    return [nn(*pr) for pr in problems]


def moments_plain(q_xyz: torch.Tensor, p_xyz: torch.Tensor,
                  p_mask: torch.Tensor, r2: torch.Tensor,
                  feat_stack: torch.Tensor,
                  close_r2: Optional[torch.Tensor] = None, chunk: int = 1024
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``adj @ feat_stack`` over [chunk, P] blocks, each batch entry on its
    own; the second output sums over d2 <= min(r2, close_r2)."""
    if q_xyz.dim() > 2:
        return _per_entry(
            lambda q, p, m, r, f, c: moments_plain(q, p, m, r, f, c, chunk),
            (q_xyz, p_xyz, p_mask, r2, feat_stack, close_r2), 2)
    sums, csums = [], []
    for s in range(0, q_xyz.shape[0], chunk):
        d2 = sqdist_direct(q_xyz[s:s + chunk], p_xyz)
        adj = p_mask[None, :] & (d2 <= r2[s:s + chunk, None])
        sums.append(adj.to(torch.float32) @ feat_stack)
        if close_r2 is not None:
            close = adj & (d2 <= close_r2[s:s + chunk, None])
            csums.append(close.to(torch.float32) @ feat_stack)
    if not sums:  # no queries
        sums = [feat_stack.new_zeros((0, feat_stack.shape[1]))]
        csums = sums
    return (torch.cat(sums),
            torch.cat(csums) if close_r2 is not None else None)


def moments(q_xyz, p_xyz, p_mask, r2, feat_stack, close_r2=None):
    q_xyz, p_xyz, feat_stack = _low(q_xyz, p_xyz, feat_stack)
    return moments_plain(q_xyz, p_xyz, p_mask, r2, feat_stack, close_r2)


def pca_moments_plain(q_xyz: torch.Tensor, p_xyz: torch.Tensor,
                      p_mask: torch.Tensor, r2: torch.Tensor,
                      chunk: int = 512
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(count, sum(p - q), upper sum((p - q)(p - q)^T)) over valid support
    within each query's radius, over [chunk, P] blocks."""
    if q_xyz.dim() > 2:
        return _per_entry(
            lambda q, p, m, r: pca_moments_plain(q, p, m, r, chunk),
            (q_xyz, p_xyz, p_mask, r2), 2)
    cnt, s1, s2 = [], [], []
    for s in range(0, q_xyz.shape[0], chunk):
        qc = q_xyz[s:s + chunk]
        d2 = sqdist_direct(qc, p_xyz)
        a = (p_mask[None, :] & (d2 <= r2[s:s + chunk, None])).to(
            torch.float32)
        ex = p_xyz[None, :, 0] - qc[:, 0:1]
        ey = p_xyz[None, :, 1] - qc[:, 1:2]
        ez = p_xyz[None, :, 2] - qc[:, 2:3]
        ax, ay, az = a * ex, a * ey, a * ez
        cnt.append(a.sum(1))
        s1.append(torch.stack([ax.sum(1), ay.sum(1), az.sum(1)], -1))
        s2.append(torch.stack([(ax * ex).sum(1), (ax * ey).sum(1),
                               (ax * ez).sum(1), (ay * ey).sum(1),
                               (ay * ez).sum(1), (az * ez).sum(1)], -1))
    if not cnt:  # no queries
        z = q_xyz.new_zeros
        return z((0,)), z((0, 3)), z((0, 6))
    return torch.cat(cnt), torch.cat(s1), torch.cat(s2)


def pca_moments(q_xyz, p_xyz, p_mask, r2):
    q_xyz, p_xyz = _low(q_xyz, p_xyz)
    return pca_moments_plain(q_xyz, p_xyz, p_mask, r2)
