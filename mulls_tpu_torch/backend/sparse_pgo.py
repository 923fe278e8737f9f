"""Sparse-direct pose-graph solver — the g2o-architecture backend.

A copy of ``mulls_tpu/backend/sparse_pgo.py`` (numpy + scipy host code)
with only its imports rewritten; the text below is the original's.

The reference's `--pose_graph_optimization_method=g2o` path links a real
sparse optimizer: g2o `VertexSE3`/`EdgeSE3` Levenberg-Marquardt over a
block-sparse Hessian factored by CHOLMOD each iteration, Huber kernels on
every edge, anchors hard-fixed (removed from the system, no parameter-
bound trick) — `src/graph_optimizer.cpp:143-384`.  This module is the
TPU-build equivalent with the same architecture, genuinely distinct from
both of the repo's other solvers:

* `pgo.optimize_pose_graph` (ceres selection) — DENSE (6M)^2 Hessian +
  `linalg.solve` on device, node limiting via bounds;
* `pgo.optimize_pose_graph_cg` (gtsam selection) — matrix-free
  block-Jacobi-preconditioned CG, no Hessian ever materialized;
* this module (g2o selection) — block-SPARSE Hessian in CSC, ONE
  symbolic analysis + per-iteration numeric sparse LU factorization
  (SuperLU with COLAMD fill-reducing ordering — the CHOLMOD role),
  fixed nodes eliminated from the system, Huber IRLS.

It runs on the HOST (numpy + scipy.sparse): a sparse direct factorization
is pointer-chasing work the TPU's MXU cannot express, and the pose graph
at submap granularity is a few thousand nodes — host-side O(nnz^1.5)
beats shipping a mostly-zero (6M)^2 dense system to the device once M is
a few hundred (measured crossover in docs/PERF.md).  No jit anywhere:
this is exactly the latency-critical shape-varying host path the repo
keeps off XLA (`backend/np_pgo.py` precedent).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from mulls_tpu_torch.backend.np_pgo import (_perturb, _res_jac, _residual,
                                      _sqrt_psd)


def _huber_weights(rW: np.ndarray, delta: float) -> np.ndarray:
    """IRLS sqrt-weights per edge for a Huber kernel on ||sqrt_info r||
    (g2o `RobustKernelHuber`, `graph_optimizer.cpp:275-277`)."""
    rn = np.linalg.norm(rW, axis=-1)
    return np.sqrt(np.where(rn > delta, delta / np.maximum(rn, 1e-12), 1.0))


def optimize_pose_graph_sparse(
        node_t: np.ndarray, node_q: np.ndarray,
        edge_i: np.ndarray, edge_j: np.ndarray,
        edge_t: np.ndarray, edge_q: np.ndarray,
        edge_info: np.ndarray, fixed: np.ndarray,
        edge_mask: Optional[np.ndarray] = None,
        iterations: int = 15, lm_lambda: float = 1e-4,
        robust_kernel: bool = True, huber_delta: float = 1.0,
        ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Sparse-LM solve; returns (node_t [M,3], node_q [M,4], chi2).

    Same quaternion BetweenFactor residual as the device solvers
    (`graph_optimizer.h:98-133`): r = [R_a^T (t_b - t_a) - t_meas;
    2 vec(q_meas (q_a^-1 q_b)^-1)], sqrt-information weighted.  The
    Hessian is assembled ONCE per iteration as 6x6 blocks in COO form
    (vectorized index arithmetic, no Python per-edge loop) over the FREE
    nodes only — fixed anchors are eliminated, not pinned — and factored
    by `splu`.  Adaptive damping with cost-gated acceptance matches the
    other solvers so cross-backend tests compare like with like.
    """
    from scipy.sparse import csc_matrix
    from scipy.sparse.linalg import splu

    m = len(node_t)
    t = np.asarray(node_t, np.float64).copy()
    q = np.asarray(node_q, np.float64).copy()
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    ii = np.asarray(edge_i, np.int64)
    jj = np.asarray(edge_j, np.int64)
    tm = np.asarray(edge_t, np.float64)
    qm = np.asarray(edge_q, np.float64)
    qm = qm / np.linalg.norm(qm, axis=-1, keepdims=True)
    keep = (np.ones(len(ii), bool) if edge_mask is None
            else np.asarray(edge_mask, bool))
    ii, jj, tm, qm = ii[keep], jj[keep], tm[keep], qm[keep]
    sq = _sqrt_psd(np.asarray(edge_info, np.float64)[keep])
    free = ~np.asarray(fixed, bool)

    # dof renumbering: node -> position among free nodes (fixed -> -1)
    free_pos = np.cumsum(free) - 1
    free_pos[~free] = -1
    n_free = int(free.sum())
    if n_free == 0 or len(ii) == 0:
        r = _residual(t[ii], q[ii], t[jj], q[jj], tm, qm)
        rw = np.einsum("eij,ej->ei", sq, r)
        return t, q, float(np.sum(rw * rw))

    # static block-sparsity pattern: per edge up to 4 blocks (aa, bb, ab,
    # ba), dropped where an endpoint is fixed; plus the damping diagonal.
    # COO rows/cols are computed once — only the data vector changes per
    # iteration, and splu re-runs its (cached-ordering) factorization.
    blk_r, blk_c, blk_sel = [], [], []  # block row, block col, which term
    a_free = free[ii]
    b_free = free[jj]
    pa = free_pos[ii]
    pb = free_pos[jj]
    terms = (("aa", a_free, pa, pa), ("bb", b_free, pb, pb),
             ("ab", a_free & b_free, pa, pb),
             ("ba", a_free & b_free, pb, pa))

    off = np.arange(6)

    def _expand(rows_blk, cols_blk):
        """6x6 block indices -> scalar COO indices."""
        r0 = (rows_blk[:, None, None] * 6 + off[None, :, None])
        c0 = (cols_blk[:, None, None] * 6 + off[None, None, :])
        return (np.broadcast_to(r0, (len(rows_blk), 6, 6)).ravel(),
                np.broadcast_to(c0, (len(rows_blk), 6, 6)).ravel())

    sel_by_term = {}
    for name, sel, prow, pcol in terms:
        e_idx = np.nonzero(sel)[0]
        sel_by_term[name] = e_idx
        r_, c_ = _expand(prow[e_idx], pcol[e_idx])
        blk_r.append(r_)
        blk_c.append(c_)
    diag_idx = np.arange(6 * n_free)
    rows = np.concatenate(blk_r + [diag_idx])
    cols = np.concatenate(blk_c + [diag_idx])

    def cost(t_, q_):
        r = _residual(t_[ii], q_[ii], t_[jj], q_[jj], tm, qm)
        rw = np.einsum("eij,ej->ei", sq, r)
        if robust_kernel:
            rn = np.linalg.norm(rw, axis=-1)
            per = np.where(rn > huber_delta,
                           huber_delta * (2.0 * rn - huber_delta), rn * rn)
            return float(np.sum(per))
        return float(np.sum(rw * rw))

    lam = lm_lambda
    best = cost(t, q)
    for _ in range(iterations):
        r, Ja, Jb = _res_jac(t[ii], q[ii], t[jj], q[jj], tm, qm)
        rW = np.einsum("eij,ej->ei", sq, r)
        JaW = sq @ Ja
        JbW = sq @ Jb
        if robust_kernel:
            w = _huber_weights(rW, huber_delta)
            rW = rW * w[:, None]
            JaW = JaW * w[:, None, None]
            JbW = JbW * w[:, None, None]

        g = np.zeros((n_free, 6))
        np.add.at(g, pa[a_free],
                  np.einsum("eki,ek->ei", JaW[a_free], rW[a_free]))
        np.add.at(g, pb[b_free],
                  np.einsum("eki,ek->ei", JbW[b_free], rW[b_free]))

        blocks = {
            "aa": np.einsum("eki,ekj->eij", JaW, JaW),
            "bb": np.einsum("eki,ekj->eij", JbW, JbW),
            "ab": np.einsum("eki,ekj->eij", JaW, JbW),
        }
        blocks["ba"] = np.swapaxes(blocks["ab"], -1, -2)
        data = np.concatenate(
            [blocks[name][sel_by_term[name]].ravel()
             for name, _, _, _ in terms]
            + [np.full(6 * n_free, lam + 1e-9)])
        H = csc_matrix((data, (rows, cols)),
                       shape=(6 * n_free, 6 * n_free))
        try:
            dx_free = splu(H).solve(-g.ravel()).reshape(n_free, 6)
        except RuntimeError:  # singular factorization
            lam = min(lam * 10.0, 1e6)
            continue
        dx = np.zeros((m, 6))
        dx[free] = dx_free
        t_new, q_new = _perturb(t, q, dx)
        c = cost(t_new, q_new)
        if c < best:
            t, q, best = t_new, q_new, c
            lam = max(lam * 0.3, 1e-8)
        else:
            lam = min(lam * 10.0, 1e6)

    r = _residual(t[ii], q[ii], t[jj], q[jj], tm, qm)
    rw = np.einsum("eij,ej->ei", sq, r)
    return t, q, float(np.sum(rw * rw))


def wrong_edge_check_np(node_t, node_q, edge_i, edge_j, edge_t, edge_q,
                        edge_mask, tran_thre: float,
                        rot_thre_deg: float) -> np.ndarray:
    """Host twin of `pgo.wrong_edge_check` (`graph_optimizer.cpp:713-754`)
    for the sparse backend: flag edges whose optimized relative pose moved
    beyond (tran_thre, rot_thre_deg) from their measurement."""
    from mulls_tpu_torch.backend.np_pgo import (quat_conj, quat_mul,
                                          rotation_from_quat)
    t = np.asarray(node_t, np.float64)
    q = np.asarray(node_q, np.float64)
    ii = np.asarray(edge_i, np.int64)
    jj = np.asarray(edge_j, np.int64)
    qa_inv = quat_conj(q[ii])
    t_ab = np.einsum("eij,ej->ei", rotation_from_quat(qa_inv),
                     t[jj] - t[ii])
    q_ab = quat_mul(qa_inv, q[jj])
    dt = np.linalg.norm(t_ab - np.asarray(edge_t, np.float64), axis=-1)
    dq = quat_mul(np.asarray(edge_q, np.float64), quat_conj(q_ab))
    ang = 2.0 * np.arccos(np.clip(np.abs(dq[:, 0]), -1.0, 1.0))
    return (np.asarray(edge_mask, bool)
            & ((dt > tran_thre) | (ang > np.radians(rot_thre_deg))))
