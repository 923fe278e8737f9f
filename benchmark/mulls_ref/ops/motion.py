"""Motion compensation (scan undistortion) — port of
``mulls_tpu/ops/motion.py`` (reference `cfilter.hpp:412-549`, applied in
the main loop after registration, `mulls_slam.cpp:704-715`).

Per-point in-frame timestamp ratios come either from sensor timestamps
(``RawCloud.ts_ratio``) or from the azimuth fallback
(`cfilter.hpp:429-467`).  Undistortion interpolates each point's pose
between the frame-start and frame-end poses: quaternion slerp for rotation
+ linear interpolation for translation (`cfilter.hpp:470-516`), batched
over the cloud.  Every function takes leading batch dimensions (``[S, N,
3]`` clouds, ``[S, 4, 4]`` motions), each entry on its own.
"""

from __future__ import annotations

import math

import torch

from mulls_ref.core import se3
from mulls_ref.core.batch import matvec


def timestamp_ratio_from_azimuth(xyz: torch.Tensor,
                                 mask: torch.Tensor) -> torch.Tensor:
    """[..., N,3] -> [..., N] ratio in [0,1]: unwrapped clockwise azimuth
    swept since the first valid return (`cfilter.hpp:429-467`)."""
    az = torch.atan2(xyz[..., 1], xyz[..., 0])  # (-pi, pi]
    first = torch.argmax(mask.to(torch.int32), dim=-1, keepdim=True)
    az0 = torch.gather(az, -1, first)  # at the first valid index
    # most spinning LiDARs sweep clockwise (decreasing azimuth)
    swept = torch.remainder(az0 - az, 2.0 * math.pi)
    ratio = swept / (2.0 * math.pi)
    return torch.where(mask, ratio, 0.0)


def _quat_pow(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Quaternion power q^w for unit q=[..., 4] (w, x, y, z) and w [..., N]
    in [0,1] — the slerp between identity and q.  Returns [..., N, 4]."""
    q = q[..., None, :]  # one quaternion for the N points
    qw = torch.clamp(q[..., :1], -1.0, 1.0)
    angle = torch.arccos(torch.abs(qw))
    sign = torch.where(qw < 0, -1.0, 1.0)  # shortest arc
    axis_norm = torch.linalg.norm(q[..., 1:], dim=-1, keepdim=True)
    axis = q[..., 1:] / torch.clamp(axis_norm, min=1e-12)
    new_angle = angle * w[..., None]  # [..., N, 1]
    out = torch.cat([torch.cos(new_angle),
                     torch.sin(new_angle) * axis * sign], dim=-1)
    # q ~ identity: fall back to lerp-normalize (numerically stable)
    w = w[..., None]
    lerp = torch.cat([1.0 - w + w * qw * sign, w * q[..., 1:] * sign],
                     dim=-1)
    lerp = lerp / torch.clamp(torch.linalg.norm(lerp, dim=-1, keepdim=True),
                              min=1e-12)
    return torch.where(axis_norm < 1e-6, lerp, out)


def undistort(xyz: torch.Tensor, ts_ratio: torch.Tensor, mask: torch.Tensor,
              T_rel: torch.Tensor, min_range: float = 0.0) -> torch.Tensor:
    """Undistort a scan given the in-frame motion ``T_rel`` (sensor pose at
    sweep end expressed in the sweep-start frame): a point captured at
    ratio ``s`` is mapped by ``T_rel^s`` into the sweep-start frame
    (`cfilter.hpp:470-516`)."""
    q = se3.quat_from_rotation(T_rel[..., :3, :3])
    t = T_rel[..., None, :3, 3]
    w = torch.clamp(ts_ratio, 0.0, 1.0)
    Rs = se3.rotation_from_quat(_quat_pow(q, w))  # [..., N,3,3]
    out = matvec(Rs, xyz) + w[..., None] * t
    keep = mask & (torch.linalg.norm(xyz, dim=-1) > min_range)
    return torch.where(keep[..., None], out, xyz)


def vertical_intrinsic_calibration(xyz: torch.Tensor,
                                   var_vertical_ang_deg: float
                                   ) -> torch.Tensor:
    """Regenerate a cloud whose scanner vertical angles are biased by a
    constant intrinsic error (`cfilter.hpp:250-292`): each return keeps its
    range and azimuth but its elevation is shifted by
    ``var_vertical_ang_deg``.  A value >= 180 is the reference's sentinel
    for z-inversion (PANDAR XT).  No-op when the correction is 0."""
    if var_vertical_ang_deg == 0.0:
        return xyz
    if var_vertical_ang_deg >= 180.0:
        return xyz * torch.tensor([1.0, 1.0, -1.0], dtype=xyz.dtype,
                                  device=xyz.device)
    dang = float(torch.tensor(var_vertical_ang_deg * math.pi / 180.0,
                              dtype=torch.float32))
    dist = torch.linalg.norm(xyz, dim=-1)
    safe = torch.clamp(dist, min=1e-12)
    v_ang = torch.arcsin(torch.clamp(xyz[..., 2] / safe, -1.0, 1.0))
    v_ang_c = v_ang + dang
    hor_scale = torch.cos(v_ang_c) / torch.clamp(torch.cos(v_ang), min=1e-12)
    out = torch.stack([xyz[..., 0] * hor_scale, xyz[..., 1] * hor_scale,
                       dist * torch.sin(v_ang_c)], -1)
    return torch.where(dist[..., None] > 0, out, xyz)
