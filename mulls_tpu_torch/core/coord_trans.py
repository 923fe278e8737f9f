"""Coordinate-system adjustment between control-point lists — port of
``mulls_tpu/core/coord_trans.py`` (the reference's geo-referencing extras,
`cregistration.hpp:2927-3384`):

* :func:`coord_tran_4dof` — 4-DoF similarity (x/y translation + yaw +
  scale) linear least squares (`coord_system_tran_4dof_lls`)
* :func:`coord_tran_6dof_svd` — rigid SE(3) via the Umeyama/SVD closed
  form (`coord_system_tran_6dof_svd`)
* :func:`coord_tran_7dof` — 7-DoF Helmert (3 translations, 3 small
  rotations, scale) linear least squares (`coord_system_tran_7dof`)

All run as plain torch on small tensors (control-point lists are tiny),
in float32 like the reference, on the inputs' device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

f32 = torch.float32


def coord_tran_4dof(src: torch.Tensor, dst: torch.Tensor,
                    weights: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plane similarity: dst_xy = s * R(yaw) @ src_xy + t, dst_z = src_z + tz.
    Returns ([4,4] transform embedding s*R, scale)."""
    n = src.shape[0]
    dev = src.device
    w = torch.ones((n,), dtype=f32, device=dev) if weights is None \
        else weights
    wsum = torch.sum(w)
    # parameters p = (a, b, tx, ty) with a = s cos(yaw), b = s sin(yaw)
    # dst_x = a sx - b sy + tx ; dst_y = b sx + a sy + ty
    sx, sy = src[:, 0], src[:, 1]
    zeros = torch.zeros_like(sx)
    ones = torch.ones_like(sx)
    A = torch.cat([torch.stack([sx, -sy, ones, zeros], -1),
                   torch.stack([sy, sx, zeros, ones], -1)], 0)
    b = torch.cat([dst[:, 0], dst[:, 1]])
    ww = torch.cat([w, w])
    ATA = torch.einsum("n,ni,nj->ij", ww, A, A)
    ATb = torch.einsum("n,ni,n->i", ww, A, b)
    p = torch.linalg.solve(ATA + 1e-9 * torch.eye(4, device=dev), ATb)
    a, bb, tx, ty = p
    s = torch.sqrt(a * a + bb * bb)
    tz = torch.sum(w * (dst[:, 2] - src[:, 2])) / wsum
    T = torch.eye(4, dtype=f32, device=dev)
    T[0, 0], T[0, 1] = a, -bb
    T[1, 0], T[1, 1] = bb, a
    T[0, 3], T[1, 3], T[2, 3] = tx, ty, tz
    return T, s


def coord_tran_6dof_svd(src: torch.Tensor, dst: torch.Tensor,
                        with_scale: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rigid (optionally similarity) alignment dst ~ s R src + t, Umeyama
    closed form.  Returns ([4,4], scale)."""
    dev = src.device
    mu_s = torch.mean(src, 0)
    mu_d = torch.mean(dst, 0)
    cs = src - mu_s
    cd = dst - mu_d
    H = cs.T @ cd / src.shape[0]
    U, S, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vt.T @ U.T))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = Vt.T @ D @ U.T
    if with_scale:
        var_s = torch.mean(torch.sum(cs * cs, -1))
        s = torch.sum(S * torch.diagonal(D)) / torch.clamp(var_s, min=1e-12)
    else:
        s = torch.tensor(1.0, dtype=f32, device=dev)
    t = mu_d - s * R @ mu_s
    T = torch.eye(4, dtype=f32, device=dev)
    T[:3, :3] = s * R
    T[:3, 3] = t
    return T, s


def coord_tran_7dof(src: torch.Tensor, dst: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Small-angle 7-parameter Helmert transform
    (dx, dy, dz, rx, ry, rz, mu) solved linearly:
    dst = (1+mu) (I + skew(r)) src + t."""
    dev = src.device
    x, y, z = src[:, 0], src[:, 1], src[:, 2]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    # eq x: dx + 0 + 0 + 0*rx + z*ry - y*rz + x*mu = dst_x - x
    A = torch.cat([torch.stack([ones, zeros, zeros, zeros, z, -y, x], -1),
                   torch.stack([zeros, ones, zeros, -z, zeros, x, y], -1),
                   torch.stack([zeros, zeros, ones, y, -x, zeros, z], -1)], 0)
    b = torch.cat([dst[:, 0] - x, dst[:, 1] - y, dst[:, 2] - z])
    p = torch.linalg.solve(A.T @ A + 1e-9 * torch.eye(7, device=dev),
                           A.T @ b)
    t, r, mu = p[:3], p[3:6], p[6]
    zero = torch.zeros_like(mu)
    R = torch.eye(3, device=dev) + torch.stack([
        torch.stack([zero, -r[2], r[1]]),
        torch.stack([r[2], zero, -r[0]]),
        torch.stack([-r[1], r[0], zero])])
    T = torch.eye(4, dtype=f32, device=dev)
    T[:3, :3] = (1.0 + mu) * R
    T[:3, 3] = t
    return T, 1.0 + mu
