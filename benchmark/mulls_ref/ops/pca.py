"""Batched neighborhood PCA — port of ``mulls_tpu/ops/pca.py`` (the
reference's `pca.hpp`).

The neighborhood second moments come from the query-centred moments
kernel (:func:`mulls_ref.ops.kernels.pca_moments`) and the
eigenproblem is the closed-form symmetric 3x3 eigendecomposition of the
reference — not ``torch.linalg.eigh``: its eigenvalue order and degenerate
fallbacks are part of the result.

Outputs mirror `pca_feature_t` (`pca.hpp:37-54`): eigenvalues l1>=l2>=l3,
principal / normal directions, curvature l3/sum, linearity (l1-l2)/l1,
planarity (l2-l3)/l1 (`pca.hpp:416-430`), neighbor count.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mulls_ref.ops import kernels
from mulls_ref.ops import neighbors as nbr

_EPS = 1e-12


def _part1by1(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of v to even bit positions."""
    v = v & 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def morton_order(xyz: torch.Tensor, res: float = 4.0) -> torch.Tensor:
    """Permutation placing spatially-adjacent points in adjacent rows (2D
    Morton curve over ``res``-metre cells), stable like ``jnp.argsort``."""
    gx = torch.clamp((xyz[..., 0] + 512.0) / res, 0, 65535).to(torch.int32)
    gy = torch.clamp((xyz[..., 1] + 512.0) / res, 0, 65535).to(torch.int32)
    code = (_part1by1(gx) << 1) | _part1by1(gy)
    return torch.argsort(code, dim=-1, stable=True)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _unit(shape_like: torch.Tensor, axis: int) -> torch.Tensor:
    e = torch.zeros_like(shape_like)
    e[..., axis] = 1.0
    return e


def eigh_sym3x3(A: torch.Tensor):
    """Closed-form eigendecomposition of symmetric [..., 3, 3] matrices.

    Returns (eigvals [..., 3] descending, eigvecs [..., 3, 3] with
    eigvecs[..., :, k] the k-th eigenvector), trigonometric method
    (Smith 1961) + cross-product eigenvectors with degeneracy fallbacks.
    """
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    q = (a00 + a11 + a22) / 3.0
    p1 = a01 ** 2 + a02 ** 2 + a12 ** 2
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=_EPS))

    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detB = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    l1 = q + 2.0 * p * torch.cos(phi)
    l3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l2 = 3.0 * q - l1 - l3
    isotropic = p2 < 1e-10 * torch.clamp(q * q, min=1e-20)
    vals = torch.stack([l1, l2, l3], dim=-1)
    vals = torch.where(isotropic[..., None], torch.stack([q, q, q], -1), vals)

    def eigvec_for(lam):
        # rows of (A - lam I); eigenvector is orthogonal to two independent
        # rows -> take the largest-norm cross product of row pairs
        r0 = torch.stack([a00 - lam, a01, a02], -1)
        r1 = torch.stack([a01, a11 - lam, a12], -1)
        r2 = torch.stack([a02, a12, a22 - lam], -1)
        c01 = _cross(r0, r1)
        c02 = _cross(r0, r2)
        c12 = _cross(r1, r2)
        n01 = torch.sum(c01 * c01, -1)
        n02 = torch.sum(c02 * c02, -1)
        n12 = torch.sum(c12 * c12, -1)
        best = torch.argmax(torch.stack([n01, n02, n12], -1), dim=-1)
        v = torch.where((best == 0)[..., None], c01,
                        torch.where((best == 1)[..., None], c02, c12))
        norm = torch.linalg.norm(v, dim=-1, keepdim=True)
        # degenerate (repeated eigenvalue): fall back to a fixed axis
        return torch.where(norm > 1e-12, v / torch.clamp(norm, min=1e-20),
                           _unit(v, 2))

    v1 = eigvec_for(l1)
    v3 = eigvec_for(l3)
    # enforce orthogonality: v2 = v3 x v1; re-orthogonalize v3 against v1
    v3 = v3 - torch.sum(v3 * v1, -1, keepdim=True) * v1
    v3n = torch.linalg.norm(v3, dim=-1, keepdim=True)
    alt = _cross(v1, _unit(v1, 0))
    altn = torch.linalg.norm(alt, dim=-1, keepdim=True)
    alt2 = _cross(v1, _unit(v1, 1))
    alt2n = torch.linalg.norm(alt2, dim=-1, keepdim=True)
    alt = torch.where(altn > 1e-6, alt / torch.clamp(altn, min=1e-20),
                      alt2 / torch.clamp(alt2n, min=1e-20))
    v3 = torch.where(v3n > 1e-6, v3 / torch.clamp(v3n, min=1e-20), alt)
    v2 = _cross(v3, v1)
    vecs = torch.stack([v1, v2, v3], dim=-1)  # columns
    return vals, vecs


class PcaFeatures(NamedTuple):
    """Per-query PCA features (pca_feature_t parity)."""

    count: torch.Tensor  # [Q] neighbor count (incl. self)
    eigvals: torch.Tensor  # [Q, 3] descending
    principal: torch.Tensor  # [Q, 3] eigvec of l1
    normal: torch.Tensor  # [Q, 3] eigvec of l3
    curvature: torch.Tensor  # [Q] l3 / sum
    linearity: torch.Tensor  # [Q] (l1-l2)/l1   (linear_2)
    planarity: torch.Tensor  # [Q] (l2-l3)/l1   (planar_2)
    sphericity: torch.Tensor  # [Q] l3/l1
    valid: torch.Tensor  # [Q] bool (count > min_k and query valid)


def pca_features(q_xyz: torch.Tensor, q_mask: torch.Tensor,
                 p_xyz: torch.Tensor, p_mask: torch.Tensor, radius: float,
                 min_k: int, distance_adaptive: bool = False,
                 unit_dist: float = 30.0) -> PcaFeatures:
    """Radius PCA of every query against the support set (all points within
    the radius — the reference's documented deviation from its K cap).
    Leading dimensions are batch entries: one ``pca_moments`` launch for
    all of them."""
    r = torch.full(q_xyz.shape[:-1], radius, dtype=torch.float32,
                   device=q_xyz.device)
    if distance_adaptive:
        # r' = sqrt(d/unit) * r for d > unit (`pca.hpp:314-324`)
        d = torch.linalg.norm(q_xyz, dim=-1)
        r = r * torch.sqrt(torch.clamp(d / unit_dist, min=1.0))
    cnt, sx, so = kernels.pca_moments(q_xyz.contiguous(), p_xyz.contiguous(),
                                      p_mask.contiguous(), r * r)
    qf = q_mask.to(torch.float32)
    count = cnt * qf
    cov = nbr.cov_from_moments(count, sx * qf[..., None], so * qf[..., None])
    # the closed form in float64, then back to float32: in float32 its
    # arccos near a repeated eigenvalue (a plane's l1 ~ l2) turns the last
    # ulp of the covariance into ~1e-4 of curvature, so the order in which
    # the moments were summed would pick features
    vals, vecs = eigh_sym3x3(cov.double())
    vals, vecs = vals.float(), vecs.float()
    vals = torch.clamp(vals, min=0.0)
    s = torch.clamp(vals[..., 0] + vals[..., 1] + vals[..., 2], min=_EPS)
    l1 = torch.clamp(vals[..., 0], min=_EPS)
    return PcaFeatures(
        count=count,
        eigvals=vals,
        principal=vecs[..., 0],
        normal=vecs[..., 2],
        curvature=vals[..., 2] / s,
        linearity=(vals[..., 0] - vals[..., 1]) / l1,
        planarity=(vals[..., 1] - vals[..., 2]) / l1,
        sphericity=vals[..., 2] / l1,
        valid=q_mask & (count > min_k),
    )
