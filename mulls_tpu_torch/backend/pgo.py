"""Pose graph optimization — port of ``mulls_tpu/backend/pgo.py``: batched
Gauss-Newton / Levenberg-Marquardt on SE(3) with the reference's residual
convention (`include/pgo/graph_optimizer.h:98-145`): per edge (a = target,
b = source) with measurement T_ab = Ta^-1 Tb,

    r = [ t_ab_est - t_ab_meas ; 2 * vec(q_meas * q_ab_est^-1) ]

weighted by the square root of the information matrix.  Jacobians are
derivatives of the exact residual to float32 accuracy (the reference's
``jacfwd``; see :func:`_edge_res_and_jac`).  The dense solver factors the
6M x 6M normal system on the graph's device (``linalg.solve_ex``, no host sync); the matrix-free
solver runs block-Jacobi-preconditioned CG with edge-local products.  Both
keep the reference's fp32, its cost-gated adaptive damping and its
per-node bounds (`graph_optimizer.cpp:594-657`).  The reference's
``lax.scan`` / ``while_loop`` iterations are Python loops whose accept /
converge decisions stay on the device as masks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mulls_tpu_torch.core import se3
from mulls_tpu_torch.ops.segment import segment_sum

f32 = torch.float32


class PoseGraph(NamedTuple):
    """Fixed-capacity pose graph (masked edges)."""

    node_t: torch.Tensor  # [M, 3]
    node_q: torch.Tensor  # [M, 4] unit quaternion (w,x,y,z)
    edge_i: torch.Tensor  # [E] int64 node a (target / block1)
    edge_j: torch.Tensor  # [E] int64 node b (source / block2)
    edge_t: torch.Tensor  # [E, 3] measured t_ab
    edge_q: torch.Tensor  # [E, 4] measured q_ab
    edge_info: torch.Tensor  # [E, 6, 6] information matrix
    edge_mask: torch.Tensor  # [E] bool
    fixed: torch.Tensor  # [M] bool (frozen nodes)
    # per-node bounds around the INITIAL pose (the reference's ceres
    # SetParameter{Lower,Upper}Bound trick); None = unbounded
    t_limit: Optional[torch.Tensor] = None  # [M] metres (per component)
    r_limit: Optional[torch.Tensor] = None  # [M] quaternion-component bound

    @property
    def num_nodes(self) -> int:
        return self.node_t.shape[0]


def _sqrt_psd(info: torch.Tensor) -> torch.Tensor:
    """Symmetric square root via eigendecomposition (6x6, batched)."""
    w, v = torch.linalg.eigh(info)
    w = torch.clamp(w, min=0.0)
    return (v * torch.sqrt(w)[..., None, :]) @ v.transpose(-1, -2)


def _perturb(t, q, dt, dth):
    one = torch.ones(dth.shape[:-1] + (1,), dtype=dth.dtype,
                     device=dth.device)
    dq = torch.cat([one, 0.5 * dth], -1)
    qn = se3.quat_mul(dq, q)
    qn = qn / torch.linalg.norm(qn, dim=-1, keepdim=True)
    return t + dt, qn


def _edge_residual(dt_a, dq_a, dt_b, dq_b, ta, qa, tb, qb, t_meas, q_meas):
    """Residual with local perturbations (t + delta, dq (x) q) applied;
    any leading batch shape."""
    ta_p, qa_p = _perturb(ta, qa, dt_a, dq_a)
    tb_p, qb_p = _perturb(tb, qb, dt_b, dq_b)
    qa_inv = se3.quat_conj(qa_p)
    Ra_inv = se3.rotation_from_quat(qa_inv)
    t_ab = torch.einsum("...ij,...j->...i", Ra_inv, tb_p - ta_p)
    q_ab = se3.quat_mul(qa_inv, qb_p)
    r_t = t_ab - t_meas
    r_q = 2.0 * se3.quat_mul(q_meas, se3.quat_conj(q_ab))[..., 1:4]
    return torch.cat([r_t, r_q], -1)


def _edge_res_and_jac(node_t, node_q, graph: PoseGraph):
    """(residuals [E,6] f32, Ja [E,6,6], Jb [E,6,6]) at zero perturbation.
    The Jacobians are central differences of the exact residual evaluated
    in float64 (step 1e-6: truncation ~1e-12, rounding ~1e-10, both far
    below float32's resolution), all edges and all 12 perturbation
    directions in one batched evaluation, then cast to float32: the
    reference's ``jacfwd`` to float32 accuracy.  ``torch.func.vmap`` of
    ``jacfwd`` (and eager forward-mode AD) gave the same numbers but
    dispatched per operation: ~190 ms (~100 ms) an LM step on a 16-node
    graph."""
    ii, jj = graph.edge_i, graph.edge_j
    e = ii.shape[0]
    f64 = torch.float64
    h = 1e-6
    eye = torch.eye(12, dtype=f64, device=node_t.device)
    steps = torch.cat([h * eye, -h * eye])[:, None, :].expand(24, e, 12)
    args = [a.to(f64).expand((24,) + tuple(a.shape)) for a in (
        node_t[ii], node_q[ii], node_t[jj], node_q[jj], graph.edge_t,
        graph.edge_q)]
    r = _edge_residual(steps[..., 0:3], steps[..., 3:6], steps[..., 6:9],
                       steps[..., 9:12], *args)  # [24, E, 6]
    J = ((r[:12] - r[12:]) / (2.0 * h)).permute(1, 2, 0).to(f32)
    return _residuals(node_t, node_q, graph), J[..., :6], J[..., 6:]


def _residuals(node_t, node_q, graph: PoseGraph):
    ii, jj = graph.edge_i, graph.edge_j
    z = torch.zeros_like(graph.edge_t)
    return _edge_residual(z, z, z, z, node_t[ii], node_q[ii], node_t[jj],
                          node_q[jj], graph.edge_t, graph.edge_q)


def _clamp_to_bounds(t_new, q_new, init_t, init_q, t_limit, r_limit):
    """Pull node poses back inside their per-node bounds around the initial
    values (ceres `fix_node_ceres` equivalent, `graph_optimizer.cpp:
    639-657`): per-component translation bounds, and the rotation from the
    initial orientation capped at ~2 r (small-angle) in the tangent
    space."""
    if t_limit is not None:
        off = torch.clamp(t_new - init_t, -t_limit[:, None],
                          t_limit[:, None])
        t_new = init_t + off
    if r_limit is not None:
        dq = se3.quat_mul(q_new, se3.quat_conj(init_q))
        dq = dq * torch.sign(torch.where(dq[:, :1] == 0.0, 1.0, dq[:, :1]))
        vn = torch.linalg.norm(dq[:, 1:4], dim=-1)
        ang = 2.0 * torch.atan2(vn, dq[:, 0])
        cap = 2.0 * r_limit
        scale = torch.clamp(cap / torch.clamp(ang, min=1e-9), max=1.0)
        half = 0.5 * ang * scale
        axis = dq[:, 1:4] / torch.clamp(vn, min=1e-12)[:, None]
        dq_c = torch.cat([torch.cos(half)[:, None],
                          torch.sin(half)[:, None] * axis], dim=1)
        q_c = se3.quat_mul(dq_c, init_q)
        q_new = q_c / torch.linalg.norm(q_c, dim=-1, keepdim=True)
    return t_new, q_new


def _huber_cost(r, sqrt_info, mask, robust_kernel: bool, delta: float):
    """Total (optionally Huber-robustified) cost — the LM acceptance
    metric: rho(x) = x^2 for |x| <= delta, delta (2|x| - delta) beyond."""
    rw = torch.einsum("eij,ej->ei", sqrt_info, r)
    rn = torch.linalg.norm(rw, dim=-1)
    if robust_kernel:
        cost = torch.where(rn <= delta, rn * rn, delta * (2.0 * rn - delta))
    else:
        cost = rn * rn
    return torch.sum(cost * mask.to(f32))


def _weighted(r, Ja, Jb, sqrt_info, mask, robust_kernel, huber_delta):
    """(rW, JaW, JbW): residual and Jacobians whitened by the square-root
    information, times sqrt of the Huber IRLS weight (so that H and g get
    the weight once)."""
    w_edge = mask.to(f32)
    rw = torch.einsum("eij,ej->ei", sqrt_info, r)
    if robust_kernel:
        rn = torch.linalg.norm(rw, dim=-1)
        w_edge = w_edge * torch.sqrt(torch.where(
            rn > huber_delta, huber_delta / torch.clamp(rn, min=1e-9), 1.0))
    return (rw * w_edge[:, None], sqrt_info @ Ja * w_edge[:, None, None],
            sqrt_info @ Jb * w_edge[:, None, None])


def _lm_update(node_t, node_q, delta, graph: PoseGraph):
    m = node_t.shape[0]
    one = torch.ones((m, 1), dtype=f32, device=node_t.device)
    dq = torch.cat([one, 0.5 * delta[:, 3:6]], dim=1)
    q_new = se3.quat_mul(dq, node_q)
    q_new = q_new / torch.linalg.norm(q_new, dim=-1, keepdim=True)
    t_new = node_t + delta[:, :3]
    return _clamp_to_bounds(t_new, q_new, graph.node_t, graph.node_q,
                            graph.t_limit, graph.r_limit)


def _accept(state, t_new, q_new, new_cost):
    """Cost-gated acceptance: accepted steps shrink lambda, rejected steps
    keep the poses and grow it."""
    node_t, node_q, lam, best_cost = state
    accept = new_cost < best_cost
    return (torch.where(accept, t_new, node_t),
            torch.where(accept, q_new, node_q),
            torch.where(accept, torch.clamp(lam / 3.0, min=1e-7),
                        torch.clamp(lam * 5.0, max=1e3)),
            torch.where(accept, new_cost, best_cost))


def _normal_equations(node_t, node_q, graph: PoseGraph, sqrt_info,
                      robust_kernel: bool, huber_delta: float):
    """(H [M, 6, M, 6], g [M, 6]) of the graph's (masked, whitened,
    optionally Huber-weighted) edges at the given poses."""
    m = node_t.shape[0]
    ii, jj = graph.edge_i, graph.edge_j
    r, Ja, Jb = _edge_res_and_jac(node_t, node_q, graph)
    rW, JaW, JbW = _weighted(r, Ja, Jb, sqrt_info, graph.edge_mask,
                             robust_kernel, huber_delta)
    # dense H (6M x 6M): the 6x6 blocks summed into block (i, j), one
    # segment id i * M + j each, in a fixed order
    Haa = torch.einsum("eki,ekj->eij", JaW, JaW)
    Hbb = torch.einsum("eki,ekj->eij", JbW, JbW)
    Hab = torch.einsum("eki,ekj->eij", JaW, JbW)
    H = segment_sum(
        torch.cat([Haa, Hbb, Hab, Hab.transpose(-1, -2)]),
        torch.cat([ii * m + ii, jj * m + jj, ii * m + jj, jj * m + ii]),
        m * m).reshape(m, m, 6, 6)
    g = segment_sum(torch.cat([torch.einsum("eki,ek->ei", JaW, rW),
                               torch.einsum("eki,ek->ei", JbW, rW)]),
                    torch.cat([ii, jj]), m)
    return H.permute(0, 2, 1, 3), g


def optimize_pose_graph(graph: PoseGraph, iterations: int = 20,
                        lm_lambda: float = 1e-4, equal_weight: bool = False,
                        diagonal_information: bool = False,
                        robust_kernel: bool = False,
                        huber_delta: float = 1.0):
    """Adaptive Levenberg-Marquardt on the dense normal system; returns
    (node_t, node_q, final_chi2).  Options mirror `pgo_param_t`
    (`utility.hpp:743-792`); fixed nodes get a 1e10 diagonal pin."""
    m = graph.num_nodes
    dev = graph.node_t.device
    info = graph.edge_info
    if equal_weight:
        info = torch.eye(6, dtype=f32, device=dev).expand(info.shape)
    elif diagonal_information:
        info = torch.eye(6, dtype=f32, device=dev) \
            * torch.diagonal(info, dim1=-2, dim2=-1)[..., None, :]
    sqrt_info = _sqrt_psd(info)
    eye = torch.eye(m * 6, dtype=f32, device=dev)
    pin = torch.repeat_interleave(
        torch.where(graph.fixed, 1e10, 0.0).to(f32), 6)

    def cost_at(node_t, node_q):
        return _huber_cost(_residuals(node_t, node_q, graph), sqrt_info,
                           graph.edge_mask, robust_kernel, huber_delta)

    state = (graph.node_t, graph.node_q,
             torch.tensor(lm_lambda, dtype=f32, device=dev),
             cost_at(graph.node_t, graph.node_q))
    for _ in range(iterations):
        node_t, node_q, lam, _ = state
        H, g = _normal_equations(node_t, node_q, graph, sqrt_info,
                                 robust_kernel, huber_delta)
        # freeze nodes + LM damping (+1e-8 keeps unconstrained nodes
        # solvable)
        Hd = H.reshape(m * 6, m * 6) + torch.diag(pin) \
            + lam * eye + 1e-8 * eye
        delta = torch.linalg.solve_ex(Hd, -g.reshape(-1))[0].reshape(m, 6)
        delta = torch.where(graph.fixed[:, None], 0.0, delta)
        t_new, q_new = _lm_update(node_t, node_q, delta, graph)
        state = _accept(state, t_new, q_new, cost_at(t_new, q_new))
    t, q = state[0], state[1]
    # final chi2 (plain weighted SSE) at the returned poses
    rW = torch.einsum("eij,ej->ei", sqrt_info, _residuals(t, q, graph)) \
        * graph.edge_mask.to(f32)[:, None]
    return t, q, torch.sum(rW * rW)


def optimize_pose_graph_sharded(graph: PoseGraph, mesh,
                                iterations: int = 20,
                                lm_lambda: float = 1e-4, axis: str = "data",
                                robust_kernel: bool = False,
                                huber_delta: float = 1.0):
    """Multi-device PGO (``parallel/mesh.py::Mesh``): the EDGES go to the
    mesh's entries in contiguous blocks (the edge count a multiple of the
    mesh size: pad with ``edge_mask``), each entry builds the Hessian /
    gradient / cost of its edges on its device, and the reduced 6M x 6M
    system is solved replicated.  ``Mesh.reduce_sum`` stands for the
    reference's three ``psum``s (`mulls_tpu/backend/pgo.py:460,489-490,
    522`): local entries in order, then ``all_reduce`` across ranks, so
    every rank sees the same reduced cost and makes the same LM accept /
    reject decision.  Huber kernel and adaptive damping as the local
    solver.  Returns (node_t, node_q, chi2) on ``mesh.devices[0]``."""
    if axis != mesh.axis_name:
        raise ValueError(f"axis {axis!r} is not the mesh's "
                         f"{mesh.axis_name!r}")
    m = graph.num_nodes
    dev = mesh.devices[0]
    graph = PoseGraph(*[None if x is None else x.to(dev) for x in graph])
    sqrt_info = _sqrt_psd(graph.edge_info)
    # one graph per local entry: its block of edges on its device
    shards = []
    for d, (lo, hi) in zip(mesh.devices, mesh.blocks(
            graph.edge_i.shape[0])):
        blk = graph._replace(
            edge_i=graph.edge_i[lo:hi], edge_j=graph.edge_j[lo:hi],
            edge_t=graph.edge_t[lo:hi], edge_q=graph.edge_q[lo:hi],
            edge_info=graph.edge_info[lo:hi],
            edge_mask=graph.edge_mask[lo:hi])
        shards.append((d, PoseGraph(*[None if x is None else x.to(d)
                                      for x in blk]),
                       sqrt_info[lo:hi].to(d)))
    eye = torch.eye(m * 6, dtype=f32, device=dev)
    pin = torch.repeat_interleave(
        torch.where(graph.fixed, 1e10, 0.0).to(f32), 6)

    def cost_at(t, q):
        return mesh.reduce_sum([_huber_cost(
            _residuals(t.to(d), q.to(d), g), s, g.edge_mask, robust_kernel,
            huber_delta) for d, g, s in shards])

    state = (graph.node_t, graph.node_q,
             torch.tensor(lm_lambda, dtype=f32, device=dev),
             cost_at(graph.node_t, graph.node_q))
    for _ in range(iterations):
        t, q, lam, _ = state
        parts = [_normal_equations(t.to(d), q.to(d), g, s, robust_kernel,
                                   huber_delta) for d, g, s in shards]
        # the collective: the partial normal equations reduced over the
        # mesh
        H = mesh.reduce_sum([h for h, _ in parts])
        g = mesh.reduce_sum([gg for _, gg in parts])
        Hd = H.reshape(m * 6, m * 6) + torch.diag(pin) + (lam + 1e-8) * eye
        delta = torch.linalg.solve_ex(Hd, -g.reshape(-1))[0].reshape(m, 6)
        delta = torch.where(graph.fixed[:, None], 0.0, delta)
        t_new, q_new = _lm_update(t, q, delta, graph)
        state = _accept(state, t_new, q_new, cost_at(t_new, q_new))
    t, q = state[0], state[1]
    # final chi2 at the returned poses
    chi2 = []
    for d, g, s in shards:
        rW = torch.einsum("eij,ej->ei", s, _residuals(t.to(d), q.to(d), g)) \
            * g.edge_mask.to(f32)[:, None]
        chi2.append(torch.sum(rW * rW))
    return t, q, mesh.reduce_sum(chi2)


def _cg(Av, Mv, b, maxiter: int, tol: float):
    """``jax.scipy.sparse.linalg.cg`` from x0 = 0 (scipy's tolerance rule:
    stop once |r|^2 <= tol^2 |b|^2); iterations after convergence are
    masked, which equals the early exit."""
    bs = torch.sum(b * b)
    atol2 = torch.clamp(tol * tol * bs, min=0.0)
    x = torch.zeros_like(b)
    r = b.clone()
    z = Mv(r)
    p = z
    gamma = torch.sum(r * z)
    for _ in range(maxiter):
        live = torch.sum(r * r) > atol2
        Ap = Av(p)
        alpha = gamma / torch.sum(p * Ap)
        x_ = x + alpha * p
        r_ = r - alpha * Ap
        z_ = Mv(r_)
        gamma_ = torch.sum(r_ * z_)
        p_ = z_ + (gamma_ / gamma) * p
        x = torch.where(live, x_, x)
        r = torch.where(live, r_, r)
        p = torch.where(live, p_, p)
        gamma = torch.where(live, gamma_, gamma)
    return x


def optimize_pose_graph_cg(graph: PoseGraph, iterations: int = 15,
                           cg_iters: int = 80, lm_lambda: float = 1e-4,
                           robust_kernel: bool = False,
                           huber_delta: float = 1.0):
    """Frame-scale PGO: matrix-free Gauss-Newton/LM whose normal equations
    are solved by block-Jacobi-preconditioned CG with the operator applied
    edge-locally (O(E) memory and work per CG step).  Same cost-gated
    damping and bound clamping as the dense solver.  Returns (node_t,
    node_q, final_chi2)."""
    m = graph.num_nodes
    dev = graph.node_t.device
    sqrt_info = _sqrt_psd(graph.edge_info)
    ii, jj = graph.edge_i, graph.edge_j
    free = (~graph.fixed).to(f32)[:, None]  # [M,1]
    eye6 = torch.eye(6, dtype=f32, device=dev)

    def cost_at(node_t, node_q):
        return _huber_cost(_residuals(node_t, node_q, graph), sqrt_info,
                           graph.edge_mask, robust_kernel, huber_delta)

    def scatter(rows_a, rows_b, shape):
        return segment_sum(torch.cat([rows_a, rows_b]), torch.cat([ii, jj]),
                           shape[0])

    state = (graph.node_t, graph.node_q,
             torch.tensor(lm_lambda, dtype=f32, device=dev),
             cost_at(graph.node_t, graph.node_q))
    for _ in range(iterations):
        node_t, node_q, lam, _ = state
        r, Ja, Jb = _edge_res_and_jac(node_t, node_q, graph)
        rW, JaW, JbW = _weighted(r, Ja, Jb, sqrt_info, graph.edge_mask,
                                 robust_kernel, huber_delta)
        g = scatter(torch.einsum("eki,ek->ei", JaW, rW),
                    torch.einsum("eki,ek->ei", JbW, rW), (m, 6)) * free
        D = scatter(torch.einsum("eki,ekj->eij", JaW, JaW),
                    torch.einsum("eki,ekj->eij", JbW, JbW), (m, 6, 6))
        Dinv = torch.linalg.inv_ex(D + (lam + 1e-6) * eye6)[0]

        def Hv(v, lam=lam, JaW=JaW, JbW=JbW):
            vp = v * free
            ua = (torch.einsum("ekj,ej->ek", JaW, vp[ii])
                  + torch.einsum("ekj,ej->ek", JbW, vp[jj]))
            out = scatter(torch.einsum("eki,ek->ei", JaW, ua),
                          torch.einsum("eki,ek->ei", JbW, ua), (m, 6))
            return (out + lam * vp) * free + v * (1.0 - free)

        def Mv(v, Dinv=Dinv):
            return torch.einsum("mij,mj->mi", Dinv, v) * free \
                + v * (1.0 - free)

        delta = _cg(Hv, Mv, -g, cg_iters, 1e-6) * free
        t_new, q_new = _lm_update(node_t, node_q, delta, graph)
        state = _accept(state, t_new, q_new, cost_at(t_new, q_new))
    t, q = state[0], state[1]
    rW = torch.einsum("eij,ej->ei", sqrt_info, _residuals(t, q, graph)) \
        * graph.edge_mask.to(f32)[:, None]
    return t, q, torch.sum(rW * rW)


def wrong_edge_check(graph: PoseGraph, node_t, node_q, tran_thre: float,
                     rot_thre_deg: float) -> torch.Tensor:
    """Post-solve wrong-edge detection (`graph_optimizer.cpp:713-754`): an
    edge whose optimized relative pose moved beyond (tran_thre,
    rot_thre_deg) from its measurement is flagged."""
    qa, qb = node_q[graph.edge_i], node_q[graph.edge_j]
    ta, tb = node_t[graph.edge_i], node_t[graph.edge_j]
    qa_inv = se3.quat_conj(qa)
    t_ab = torch.einsum("eij,ej->ei", se3.rotation_from_quat(qa_inv), tb - ta)
    q_ab = se3.quat_mul(qa_inv, qb)
    dt = torch.linalg.norm(t_ab - graph.edge_t, dim=-1)
    dq = se3.quat_mul(graph.edge_q, se3.quat_conj(q_ab))
    ang = 2.0 * torch.arccos(torch.clamp(torch.abs(dq[:, 0]), -1.0, 1.0))
    rot = torch.deg2rad(torch.tensor(rot_thre_deg, dtype=f32,
                                     device=ang.device))
    return graph.edge_mask & ((dt > tran_thre) | (ang > rot))


def _packed(graph, t, q, chi2, tran_thre, rot_thre_deg) -> torch.Tensor:
    """[7M + 1 + E] f32: t[M,3] | q[M,4] | chi2 | bad[E] — one transfer for
    the host."""
    bad = wrong_edge_check(graph, t, q, tran_thre, rot_thre_deg)
    return torch.cat([t.reshape(-1), q.reshape(-1), chi2.reshape(1),
                      bad.to(f32)])


def optimize_and_check(graph: PoseGraph, iterations: int = 20,
                       equal_weight: bool = False,
                       diagonal_information: bool = False,
                       robust_kernel: bool = False, tran_thre: float = 2.0,
                       rot_thre_deg: float = 10.0) -> torch.Tensor:
    """Dense PGO solve + wrong-edge check, packed into one [7M + 1 + E]
    vector (t | q | chi2 | bad)."""
    t, q, chi2 = optimize_pose_graph(
        graph, iterations=iterations, equal_weight=equal_weight,
        diagonal_information=diagonal_information,
        robust_kernel=robust_kernel)
    return _packed(graph, t, q, chi2, tran_thre, rot_thre_deg)


def optimize_and_check_cg(graph: PoseGraph, iterations: int = 20,
                          cg_iters: int = 80, robust_kernel: bool = False,
                          tran_thre: float = 2.0,
                          rot_thre_deg: float = 10.0) -> torch.Tensor:
    """The matrix-free (gtsam selection) solve + wrong-edge check in the
    packed layout of :func:`optimize_and_check`; every boundary's solve
    warm-starts from the previously optimized node poses."""
    t, q, chi2 = optimize_pose_graph_cg(graph, iterations=iterations,
                                        cg_iters=cg_iters,
                                        robust_kernel=robust_kernel)
    return _packed(graph, t, q, chi2, tran_thre, rot_thre_deg)
