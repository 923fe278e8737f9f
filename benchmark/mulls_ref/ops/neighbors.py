"""Neighborhood queries without kd-trees — port of
``mulls_tpu/ops/neighbors.py``.

Every nearest-neighbor / radius query of the reference (PCA neighborhoods
`pca.hpp:294-354`, ICP correspondences `cregistration.hpp:1701-1835`,
dynamic removal `map_manager.cpp:145-256`) is a tiled brute-force distance
computation.  Radius queries never materialize neighbor lists: PCA needs
only sums over the neighborhood (count, sum x, sum xx^T), and any per-point
attribute sum (class one-hots for the NCC descriptor) is the same masked
sum ``S = A @ F``.  The fused work runs in the CUDA kernels of
:mod:`mulls_ref.ops.kernels` on the card and in their plain versions
on the CPU.  Every function takes leading batch dimensions (``[S, Q, 3]``
queries against ``[S, P, 3]`` support), each entry its own problem, and
launches its kernel once for all of them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mulls_ref.ops import kernels

_BIG = 3.0e38


def _rows_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., Q,3] x [..., P,3] -> [..., Q,P] dot products, one matmul a
    batch entry: a batched matmul may add in another order than the
    entry's own (``tools/batch_bits.py``)."""
    if a.dim() == 2:
        return a @ b.T
    lead = a.shape[:-2]
    a2 = a.reshape(-1, *a.shape[-2:])
    b2 = b.reshape(-1, *b.shape[-2:])
    return torch.stack([x @ y.T for x, y in zip(a2, b2)]).reshape(
        *lead, a.shape[-2], b.shape[-2])


def pairwise_sqdist(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """[..., Q,3] x [..., P,3] -> [..., Q,P] squared distances (f32 matmul
    path)."""
    q2 = torch.sum(q * q, dim=-1, keepdim=True)
    p2 = torch.sum(p * p, dim=-1, keepdim=True).transpose(-1, -2)
    cross = _rows_dot(q, p)
    return torch.clamp(q2 + p2 - 2.0 * cross, min=0.0)


def _per_query(x, shape, device) -> torch.Tensor:
    """A radius (a number, or a tensor of ``shape`` or of its leading
    dimensions) as a contiguous tensor of ``shape``."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if 0 < x.dim() < len(shape):
        x = x.reshape(x.shape + (1,) * (len(shape) - x.dim()))
    return torch.broadcast_to(x, shape).contiguous()


def radius_moments(q_xyz: torch.Tensor, q_mask: torch.Tensor,
                   p_xyz: torch.Tensor, p_mask: torch.Tensor, radius,
                   p_feats: Optional[torch.Tensor] = None,
                   close_r2=None) -> dict:
    """Masked neighbor counts and feature sums for all queries.

    Args:
      q_xyz/q_mask: [Q,3]/[Q] query points.
      p_xyz/p_mask: [P,3]/[P] support points.
      radius: scalar or [Q] per-query radius (distance-adaptive PCA,
        `pca.hpp:314-324`).
      p_feats: optional [P,F] per-support features to sum over neighbors.
      close_r2: if set, absolute squared close radius, scalar or [Q]: also
        returns sums over the close set d^2 <= min(r^2, close_r2).

    Returns dict with: count [Q], feat_sum [Q,F] (if p_feats), and
    close_count / close_feat_sum (if close_r2).  Coordinate moments for PCA
    come from :func:`kernels.pca_moments` instead.
    """
    dev = q_xyz.device
    shape = q_xyz.shape[:-1]
    r2 = _per_query(radius, shape, dev) ** 2
    with_close = close_r2 is not None
    if with_close:
        close_r2 = _per_query(close_r2, shape, dev)

    cols = [torch.ones((*p_xyz.shape[:-1], 1), dtype=torch.float32,
                       device=dev)]
    if p_feats is not None:
        cols.append(p_feats.to(torch.float32))
    feat_stack = torch.cat(cols, dim=-1).contiguous()
    sums, csums = kernels.moments(q_xyz.contiguous(), p_xyz.contiguous(),
                                  p_mask.contiguous(), r2, feat_stack,
                                  close_r2)
    qmask_f = q_mask.to(torch.float32)[..., None]
    sums = sums * qmask_f
    out = {"count": sums[..., 0]}
    if p_feats is not None:
        out["feat_sum"] = sums[..., 1:]
    if with_close:
        csums = csums * qmask_f
        out["close_count"] = csums[..., 0]
        if p_feats is not None:
            out["close_feat_sum"] = csums[..., 1:]
    return out


def cov_from_moments(count: torch.Tensor, sum_xyz: torch.Tensor,
                     sum_outer: torch.Tensor) -> torch.Tensor:
    """[..., Q] count, [..., Q,3] sum x, [..., Q,6] sum xx^T (upper) ->
    [..., Q,3,3] covariance."""
    n = torch.clamp(count, min=1.0)[..., None]
    mean = sum_xyz / n
    exx = sum_outer / n
    xx, xy, xz, yy, yz, zz = (exx[..., i] for i in range(6))
    mx, my, mz = mean[..., 0], mean[..., 1], mean[..., 2]
    return torch.stack([
        xx - mx * mx, xy - mx * my, xz - mx * mz,
        xy - mx * my, yy - my * my, yz - my * mz,
        xz - mx * mz, yz - my * mz, zz - mz * mz,
    ], dim=-1).reshape(*count.shape, 3, 3)


def nearest_neighbor_grouped(problems) -> list:
    """Brute-force 1-NN for each ``(q_xyz, q_mask, p_xyz, p_mask)`` of
    ``problems``, in one kernel launch (per 48 problems, a batch entry
    counting as one) on the card:
    ``[(idx [Q] int32, sqdist [Q] f32), ...]``.  Invalid queries and
    queries without valid support get sqdist = the 3.0e38 sentinel."""
    return kernels.nn_grouped([tuple(t.contiguous() for t in pr)
                               for pr in problems])


def normal_shooting_neighbor(q_xyz: torch.Tensor, q_dir: torch.Tensor,
                             q_mask: torch.Tensor, p_xyz: torch.Tensor,
                             p_mask: torch.Tensor, gate_r,
                             chunk: int = 2048
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normal-shooting correspondence (`cregistration.hpp:1729-1737`): for
    each query, the support point with minimum PERPENDICULAR distance to
    the line through the query along its normal, among supports within
    ``gate_r`` Euclidean.  Returns (idx [Q] int32, EUCLIDEAN sqdist [Q] f32
    of the chosen pair).  Plain PyTorch: the reference has no fused kernel
    for it either."""
    gate2 = float(gate_r) ** 2 if not torch.is_tensor(gate_r) \
        else gate_r.to(torch.float32) ** 2
    if torch.is_tensor(gate2) and gate2.dim() > 0:  # one per batch entry
        gate2 = gate2[..., None, None]
    inval = torch.where(p_mask, 0.0, _BIG)[..., None, :]
    idx_parts, best_parts = [], []
    for s in range(0, q_xyz.shape[-2], chunk):
        qc, nc = q_xyz[..., s:s + chunk, :], q_dir[..., s:s + chunk, :]
        d2 = pairwise_sqdist(qc, p_xyz)
        proj = _rows_dot(nc, p_xyz) - torch.sum(nc * qc, dim=-1,
                                                 keepdim=True)
        perp2 = torch.clamp(d2 - proj * proj, min=0.0)
        score = perp2 + torch.where(d2 > gate2, _BIG, 0.0) + inval
        idx = torch.argmin(score, dim=-1)
        best_d2 = torch.gather(d2, -1, idx[..., None])[..., 0]
        best_sc = torch.gather(score, -1, idx[..., None])[..., 0]
        idx_parts.append(idx.to(torch.int32))
        best_parts.append(torch.where(best_sc >= _BIG, _BIG, best_d2))
    best = torch.where(q_mask, torch.cat(best_parts, -1), _BIG)
    return torch.cat(idx_parts, -1), best


def knn_class_counts(q_xyz: torch.Tensor, q_mask: torch.Tensor,
                     p_xyz: torch.Tensor, p_mask: torch.Tensor,
                     radius, k: int, class_onehot: torch.Tensor,
                     p_intensity: torch.Tensor, close_r2: float) -> dict:
    """K-capped radius neighborhood category statistics.

    Parity target: the reference's ``radiusSearch(..., max_nn=k)``
    neighborhoods (`pca.hpp:326`) consumed by ``encode_stable_points``
    (`cfilter.hpp:1093-1163`).  The cap is realized statistically by a
    TWO-PASS radius shrink through the fused moments kernel: pass 1
    measures the in-radius density, pass 2 re-measures with the radius
    scaled so the expected count equals K (r'^2 = r^2 * K/count).  The
    close/far split keeps the reference's absolute 0.64 r_base^2 boundary.

    Returns dict with ``count [Q]``, ``close_counts [Q,C]``,
    ``far_counts [Q,C]``, ``int_sum [Q]``.
    """
    dev = q_xyz.device
    r = _per_query(radius, q_xyz.shape[:-1], dev)
    r2 = r ** 2
    m1 = radius_moments(q_xyz, q_mask, p_xyz, p_mask, r)
    count1 = torch.clamp(m1["count"], min=1.0)
    r2s = r2 * torch.clamp(float(k) / count1, max=1.0)
    feats = torch.cat([class_onehot.to(torch.float32),
                       p_intensity[..., None]], dim=-1)
    m2 = radius_moments(q_xyz, q_mask, p_xyz, p_mask, torch.sqrt(r2s),
                        p_feats=feats,
                        close_r2=torch.clamp(r2s, max=float(close_r2)))
    n_c = class_onehot.shape[-1]
    total_c = m2["feat_sum"][..., :n_c]
    close_c = m2["close_feat_sum"][..., :n_c]
    qf = q_mask.to(torch.float32)
    return {
        "count": m2["count"] * qf,
        "close_counts": close_c * qf[..., None],
        "far_counts": (total_c - close_c) * qf[..., None],
        "int_sum": m2["feat_sum"][..., n_c] * qf,
    }
