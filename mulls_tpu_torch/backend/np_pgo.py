"""Pure-numpy pose-graph Gauss-Newton/LM — the end-of-run refinement
solver (`mulls_slam.cpp:876-927` inner-submap ceres problems).

A copy of ``mulls_tpu/backend/np_pgo.py`` (host code, no JAX) with only
its imports rewritten, so both packages refine with the same arithmetic.
The refinement graphs are tiny chains (tens of nodes, solved once at the
end of a run), for which a host solver with no compile step is the
cheapest option.

Residual convention matches `pgo.py` exactly (and the reference's
`graph_optimizer.h:98-145`): per edge (a, b) with measurement
T_ab = Ta^-1 Tb,  r = [t_ab_est - t_ab_meas ; 2 * vec(q_meas (x)
q_ab_est^-1)], left-multiplicative local perturbations, per-node bound
clamping like ceres SetParameterBounds (`graph_optimizer.cpp:594-657`).
Jacobians are central differences on the exact residual, vectorized over
edges (the jax twin uses jacfwd; both are exact to O(eps^2)).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_W = np.array([1.0, -1.0, -1.0, -1.0])


def quat_conj(q):
    return q * _W


def quat_mul(a, b):
    w1, x1, y1, z1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    w2, x2, y2, z2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def quat_from_rotation(R):
    """Batched rotation matrix -> unit quaternion [w,x,y,z] (numpy)."""
    R = np.asarray(R, np.float64)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = np.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = np.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                   m02 + m20], -1)
    qy = np.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                   m12 + m21], -1)
    qz = np.stack([m10 - m01, m02 + m20, m12 + m21,
                   1.0 - m00 - m11 + m22], -1)
    cands = np.stack([qw, qx, qy, qz], -2)
    scores = np.stack([tr, m00, m11, m22], -1)
    idx = np.argmax(scores, axis=-1)
    quat = np.take_along_axis(cands, idx[..., None, None].repeat(4, -1),
                              axis=-2)[..., 0, :]
    quat = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    return quat * np.where(quat[..., :1] < 0, -1.0, 1.0)


def rotation_from_quat(q):
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r0 = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)], -1)
    r1 = np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)], -1)
    r2 = np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)], -1)
    return np.stack([r0, r1, r2], -2)


def _perturb(t, q, d):
    """Apply local perturbation d [...,6] = (dt, dtheta) to (t, q)."""
    dq = np.concatenate([np.ones(d.shape[:-1] + (1,)), 0.5 * d[..., 3:]],
                        -1)
    qn = quat_mul(dq, q)
    qn = qn / np.linalg.norm(qn, axis=-1, keepdims=True)
    return t + d[..., :3], qn


def _residual(ta, qa, tb, qb, tm, qm):
    """[E, 6] residuals."""
    qa_inv = quat_conj(qa)
    t_ab = np.einsum("eij,ej->ei", rotation_from_quat(qa_inv), tb - ta)
    q_ab = quat_mul(qa_inv, qb)
    r_t = t_ab - tm
    r_q = 2.0 * quat_mul(qm, quat_conj(q_ab))[..., 1:4]
    return np.concatenate([r_t, r_q], -1)


def _res_jac(ta, qa, tb, qb, tm, qm, eps: float = 1e-5):
    """Residual + central-difference Jacobians wrt the 6-dof local
    perturbations of both endpoint nodes, vectorized over edges.
    Returns (r [E,6], Ja [E,6,6], Jb [E,6,6])."""
    e = ta.shape[0]
    r = _residual(ta, qa, tb, qb, tm, qm)
    Ja = np.empty((e, 6, 6))
    Jb = np.empty((e, 6, 6))
    d = np.zeros((e, 6))
    for k in range(6):
        d[:, k] = eps
        tp, qp = _perturb(ta, qa, d)
        tn, qn = _perturb(ta, qa, -d)
        Ja[:, :, k] = (_residual(tp, qp, tb, qb, tm, qm)
                       - _residual(tn, qn, tb, qb, tm, qm)) / (2 * eps)
        tp, qp = _perturb(tb, qb, d)
        tn, qn = _perturb(tb, qb, -d)
        Jb[:, :, k] = (_residual(ta, qa, tp, qp, tm, qm)
                       - _residual(ta, qa, tn, qn, tm, qm)) / (2 * eps)
        d[:, k] = 0.0
    return r, Ja, Jb


def _sqrt_psd(info):
    w, v = np.linalg.eigh(info)
    w = np.maximum(w, 0.0)
    return (v * np.sqrt(w)[..., None, :]) @ np.swapaxes(v, -1, -2)


def _clamp(t_new, q_new, t0, q0, t_limit, r_limit):
    """Numpy twin of `pgo._clamp_to_bounds`."""
    if t_limit is not None:
        off = np.clip(t_new - t0, -t_limit[:, None], t_limit[:, None])
        t_new = t0 + off
    if r_limit is not None:
        dq = quat_mul(q_new, quat_conj(q0))
        s = np.sign(dq[:, :1])
        dq = dq * np.where(s == 0, 1.0, s)
        vn = np.linalg.norm(dq[:, 1:4], axis=-1)
        ang = 2.0 * np.arctan2(vn, dq[:, 0])
        cap = 2.0 * r_limit
        scale = np.minimum(1.0, cap / np.maximum(ang, 1e-9))
        half = 0.5 * ang * scale
        axis = dq[:, 1:4] / np.maximum(vn, 1e-12)[:, None]
        dq_c = np.concatenate([np.cos(half)[:, None],
                               np.sin(half)[:, None] * axis], 1)
        q_c = quat_mul(dq_c, q0)
        q_new = q_c / np.linalg.norm(q_c, axis=-1, keepdims=True)
    return t_new, q_new


def optimize_pose_graph_np(node_t, node_q, edge_i, edge_j, edge_t, edge_q,
                           edge_info, fixed,
                           t_limit: Optional[np.ndarray] = None,
                           r_limit: Optional[np.ndarray] = None,
                           iterations: int = 15,
                           lm_lambda: float = 1e-4):
    """Adaptive-LM solve; returns (node_t [M,3], node_q [M,4], chi2)."""
    m = len(node_t)
    t = np.asarray(node_t, np.float64).copy()
    q = np.asarray(node_q, np.float64).copy()
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    t0_init, q0_init = t.copy(), q.copy()
    ii = np.asarray(edge_i, np.int64)
    jj = np.asarray(edge_j, np.int64)
    tm = np.asarray(edge_t, np.float64)
    qm = np.asarray(edge_q, np.float64)
    qm = qm / np.linalg.norm(qm, axis=-1, keepdims=True)
    sq = _sqrt_psd(np.asarray(edge_info, np.float64))
    free = ~np.asarray(fixed, bool)

    def cost(t_, q_):
        r = _residual(t_[ii], q_[ii], t_[jj], q_[jj], tm, qm)
        rw = np.einsum("eij,ej->ei", sq, r)
        return float(np.sum(rw * rw))

    lam = lm_lambda
    best = cost(t, q)
    for _ in range(iterations):
        r, Ja, Jb = _res_jac(t[ii], q[ii], t[jj], q[jj], tm, qm)
        rW = np.einsum("eij,ej->ei", sq, r)
        JaW = sq @ Ja
        JbW = sq @ Jb
        H = np.zeros((m, m, 6, 6))
        g = np.zeros((m, 6))
        np.add.at(g, ii, np.einsum("eki,ek->ei", JaW, rW))
        np.add.at(g, jj, np.einsum("eki,ek->ei", JbW, rW))
        np.add.at(H, (ii, ii), np.einsum("eki,ekj->eij", JaW, JaW))
        np.add.at(H, (jj, jj), np.einsum("eki,ekj->eij", JbW, JbW))
        np.add.at(H, (ii, jj), np.einsum("eki,ekj->eij", JaW, JbW))
        np.add.at(H, (jj, ii), np.einsum("eki,ekj->eij", JbW, JaW))
        Hd = H.transpose(0, 2, 1, 3).reshape(6 * m, 6 * m)
        gd = g.reshape(6 * m)
        # fixed nodes: huge diagonal pin (zero update), like the jax twin
        diag = np.ones(6 * m) * lam
        pin = np.repeat(~free, 6)
        diag = diag + np.where(pin, 1e12, 0.0)
        Hd = Hd + np.diag(diag + 1e-9)
        try:
            dx = np.linalg.solve(Hd, -gd).reshape(m, 6)
        except np.linalg.LinAlgError:
            lam *= 10.0
            continue
        dx[~free] = 0.0
        t_new, q_new = _perturb(t, q, dx)
        t_new, q_new = _clamp(t_new, q_new, t0_init, q0_init,
                              t_limit, r_limit)
        c = cost(t_new, q_new)
        if c < best:  # trust-region style acceptance
            t, q, best = t_new, q_new, c
            lam = max(lam * 0.3, 1e-8)
        else:
            lam = min(lam * 10.0, 1e6)
    return t, q, best
