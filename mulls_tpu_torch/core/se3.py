"""SE(3) / SO(3) utilities (f32, fully batched) — port of
``mulls_tpu/core/se3.py``.

Euler conventions follow the reference: roll-pitch-yaw about x, y', z''
(``R = Rz(yaw) @ Ry(pitch) @ Rx(roll)``), matching the reference's
``construct_trans_a`` (`cregistration.hpp:2740-2764`) and the quaternion
variance-propagation Jacobian ``get_quat_euler_jacobi``
(`cregistration.hpp:2795-2836`).

Every function takes leading batch dimensions; the small products of
:func:`inverse`, :func:`transform_points`, :func:`rotate_vectors` and
:func:`orthonormalize` go through :mod:`mulls_tpu_torch.core.batch`, so a
batch entry gets the bits of its call alone.
"""

from __future__ import annotations

import torch

from mulls_tpu_torch.core.batch import matmul, matvec, rotate


def _bottom_row(top: torch.Tensor) -> torch.Tensor:
    bottom = torch.zeros_like(top[..., :1, :])
    # a slice, not one element: a scalar stored into one element of a
    # card's tensor is a host-to-device copy, which syncs
    bottom[..., 3:] = 1.0
    return bottom


def euler_to_rotation(euler: torch.Tensor) -> torch.Tensor:
    """roll-pitch-yaw (x, y', z'') -> 3x3 rotation. euler: [..., 3]."""
    a, b, g = euler[..., 0], euler[..., 1], euler[..., 2]
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cg, sg = torch.cos(g), torch.sin(g)
    row0 = torch.stack([cg * cb, -sg * ca + cg * sb * sa,
                        sg * sa + cg * sb * ca], -1)
    row1 = torch.stack([sg * cb, cg * ca + sg * sb * sa,
                        -cg * sa + sg * sb * ca], -1)
    row2 = torch.stack([-sb, cb * sa, cb * ca], -1)
    return torch.stack([row0, row1, row2], -2)


def make_transform(tran: torch.Tensor, euler: torch.Tensor) -> torch.Tensor:
    """[..., 3] translation + [..., 3] euler -> [..., 4, 4] SE(3)."""
    rot = euler_to_rotation(euler)
    top = torch.cat([rot, tran[..., :, None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def from_x(x: torch.Tensor) -> torch.Tensor:
    """LLS solution vector [tx ty tz roll pitch yaw] -> exact SE(3) (parity
    with the reference's post-solve exact rebuild `cregistration.hpp:1333`)."""
    return make_transform(x[..., :3], x[..., 3:6])


def identity(device=None) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device)


def inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -matvec(Rt, t)
    top = torch.cat([Rt, ti[..., :, None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def transform_points(T: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Apply [4,4] (or batched) SE(3) to [..., N, 3] points."""
    return rotate(T[..., :3, :3], xyz) + T[..., None, :3, 3]


def rotate_vectors(T: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    return rotate(T[..., :3, :3], vec)


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """|angle| of the rotation, radians."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    return torch.arccos(c)


def translation_norm(T: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(T[..., :3, 3], dim=-1)


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation onto SO(3) (SVD), keeping det=+1."""
    u, _, vt = torch.linalg.svd(R)
    d = torch.linalg.det(matmul(u, vt))
    s = torch.ones(R.shape[:-2] + (3,), dtype=R.dtype, device=R.device)
    s[..., 2] = d
    return matmul(u * s[..., None, :], vt)


def quat_euler_jacobi(euler: torch.Tensor) -> torch.Tensor:
    """d(imaginary quaternion)/d(euler rpy) — parity with the reference
    `get_quat_euler_jacobi` (`cregistration.hpp:2795-2820`, xyz sequence).
    euler: [..., 3] -> [..., 3, 3]."""
    sr, sp, sy = (torch.sin(0.5 * euler[..., i]) for i in range(3))
    cr, cp, cy = (torch.cos(0.5 * euler[..., i]) for i in range(3))
    j00 = cr * cp * cy + sr * sp * sy
    j01 = -sr * sp * cy - cr * cp * sy
    j02 = -sr * cp * sy - cr * sp * cy
    j10 = -sr * sp * cy + cr * cp * sy
    j11 = cr * cp * cy - sr * sp * sy
    j12 = -cr * sp * sy + sr * cp * cy
    j20 = -sr * cp * sy - cr * sp * cy
    j21 = -cr * sp * sy - sr * cp * cy
    j22 = cr * cp * cy + sr * sp * sy
    J = torch.stack(
        [torch.stack([j00, j01, j02], -1),
         torch.stack([j10, j11, j12], -1),
         torch.stack([j20, j21, j22], -1)], -2)
    return 0.5 * J


# --- quaternions (w, x, y, z) ----------------------------------------------


def quat_from_rotation(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion [w, x, y, z] (Shepperd's method,
    branchless: compute all four candidates, pick the best-conditioned)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                      m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1.0 - m00 - m11 + m22], -1)
    cands = torch.stack([qw, qx, qy, qz], -2)  # [..., 4, 4]
    scores = torch.stack([tr, m00, m11, m22], -1)
    idx = torch.argmax(scores, dim=-1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        *idx.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    # canonical sign: w >= 0
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = (q1[..., i] for i in range(4))
    w2, x2, y2, z2 = (q2[..., i] for i in range(4))
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], -1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def rotation_from_quat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = (q[..., i] for i in range(4))
    r0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                      2 * (x * z + w * y)], -1)
    r1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                      2 * (y * z - w * x)], -1)
    r2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                      1 - 2 * (x * x + y * y)], -1)
    return torch.stack([r0, r1, r2], -2)


# --- so(3) exponential map ---------------------------------------------------


def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues. w: [..., 3] -> [..., 3, 3], numerically safe near 0."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)
    theta = torch.clamp(theta, min=1e-12)
    k = w / theta
    K = skew(k)
    th = theta[..., None]
    s, c = torch.sin(th), torch.cos(th)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    R = eye + s * K + (1.0 - c) * (K @ K)
    small = theta[..., None] < 1e-7
    return torch.where(small, eye + skew(w), R)


def se3_boxplus(T: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative update: T' = Exp([dt, dw]) * T.  delta: [..., 6]."""
    R = so3_exp(delta[..., 3:6])
    top = torch.cat([R, delta[..., :3, None]], -1)
    dT = torch.cat([top, _bottom_row(top)], -2)
    return dT @ T
