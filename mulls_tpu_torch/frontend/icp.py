"""MULLS-ICP: multi-metric linear-least-squares ICP — port of
``mm_lls_icp`` in ``mulls_tpu/frontend/icp.py`` (reference
`cregistration.hpp:1114-1440`).

* correspondences: brute-force 1-NN of every feature class in one grouped
  launch of the ``nn`` CUDA kernel per iteration (`determine_corres`
  parity: candidate gate at 2.5x threshold,
  one-source-per-target duplicate rejection, annealed per-class distance
  thresholds, normal/principal-direction consistency gate —
  `cregistration.hpp:1701-1835`)
* one joint 6x6 normal-equation system per iteration accumulating
  point-to-plane, point-to-line and point-to-point rows with the
  reference's weighting schemes (`cregistration.hpp:1869-2275, 2686-2737`)
* the reference's ``lax.while_loop`` becomes a Python loop of ``max_iter``
  steps; once ``done`` is set, a mask on the device freezes the state, so
  there is no host sync per iteration and the result equals an early exit
* the normal equations are built in coordinates centred on the source
  correspondences, which conditions ATPA so f32 suffices; the solution and
  information matrix are mapped back to the uncentred frame exactly.

Everything is masked: invalid correspondences contribute weight 0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple

import torch

from mulls_tpu_torch.config import RegConfig
from mulls_tpu_torch.core import se3, trace
from mulls_tpu_torch.core.batch import (expand_like, fsum, matmul, matvec,
                                        offsets, take, where)
from mulls_tpu_torch.core.cloud import FeatureCloud, masked_max, masked_min
from mulls_tpu_torch.core.tree import Struct
from mulls_tpu_torch.ops import kernels
from mulls_tpu_torch.ops.neighbors import (nearest_neighbor_grouped,
                                           normal_shooting_neighbor)

CLASS_ORDER = ("ground", "pillar", "facade", "beam", "roof", "vertex")
_PLANAR = {"ground": True, "facade": True, "roof": True,
           "pillar": False, "beam": False, "vertex": False}
# feature-type bitstring index (used_feature_type, `mulls_slam.cpp` order)
_TYPE_IDX = {"ground": 0, "pillar": 1, "facade": 2, "beam": 3, "roof": 4,
             "vertex": 5}
_INT32_MAX = (1 << 31) - 1


@dataclass
class RegResult(Struct):
    transform: torch.Tensor  # [...,4,4] source -> target
    information: torch.Tensor  # [...,6,6] (tx,ty,tz,qx,qy,qz) parameters
    sigma: torch.Tensor  # posterior unit-weight std (m)
    confidence: torch.Tensor  # necessary-corr ratio
    process_code: torch.Tensor  # 1 ok | -1 diverged | -2 few corr | -3 sigma
    iterations: torch.Tensor

    @staticmethod
    def not_run(T: torch.Tensor) -> "RegResult":
        """Structure-matching placeholder (code 0 = not run), one per batch
        entry of ``T`` [..., 4, 4]."""
        dev = T.device
        lead = tuple(T.shape[:-2])
        return RegResult(
            transform=T,
            information=torch.eye(6, device=dev).expand(*lead, 6, 6).clone(),
            sigma=torch.ones(lead, device=dev),
            confidence=torch.zeros(lead, device=dev),
            process_code=torch.zeros(lead, dtype=torch.int32, device=dev),
            iterations=torch.zeros(lead, dtype=torch.int32, device=dev))


class _Corr(NamedTuple):
    t_idx: torch.Tensor  # [..., S] int64 target index of the 1-NN
    valid: torch.Tensor  # [..., S] bool
    sqdist: torch.Tensor  # [..., S]


def _find_corres(found, s_xyz, s_dir, s_mask, target: FeatureCloud,
                 dis_thre, cos_bearing: float, normal_check: bool,
                 duplicate_check: bool = True) -> _Corr:
    """determine_corres parity (`cregistration.hpp:1701-1835`) on the
    candidates ``found = (idx, d2)`` of the 1-NN or normal-shooting search
    of ``s_xyz`` in ``target``; ``dis_thre`` is a number or one per batch
    entry."""
    t_cap = target.capacity
    idx, d2 = found
    idx = idx.to(torch.int64)
    thre = expand_like(dis_thre, d2)
    cand = s_mask & (d2 <= (2.5 * thre) ** 2)
    if duplicate_check:
        # one source per target: keep the minimum-distance source (segment
        # min of the distance, then of the source ordinal as tie-break),
        # each batch entry in its own table
        n = s_xyz.shape[-2]
        dev = s_xyz.device
        lead = tuple(idx.shape[:-1])
        off = offsets(lead, t_cap + 1, dev) if lead else 0
        seg = torch.where(cand, idx, t_cap) + off
        n_tab = math.prod(lead) * (t_cap + 1)
        best_d2 = torch.full((n_tab,), float("inf"), device=dev)
        best_d2.scatter_reduce_(0, seg.reshape(-1),
                                torch.where(cand, d2, float("inf")).reshape(-1),
                                "amin", include_self=False)
        tied = cand & (d2 <= best_d2[idx + off])
        ordinal = torch.arange(n, dtype=torch.int64, device=dev)
        best_ord = torch.full((n_tab,), _INT32_MAX, dtype=torch.int64,
                              device=dev)
        best_ord.scatter_reduce_(
            0, (torch.where(tied, idx, t_cap) + off).reshape(-1),
            torch.where(tied, ordinal, 1 << 30).reshape(-1), "amin",
            include_self=False)
        cand = tied & (best_ord[idx + off] == ordinal)
    keep = cand & (d2 <= thre ** 2)
    if normal_check:
        tn = take(target.normal, idx)
        cosang = torch.abs(torch.sum(s_dir * tn, dim=-1))
        keep = keep & (cosang >= cos_bearing)
    return _Corr(t_idx=idx, valid=keep, sqdist=d2)


def _normal_rows(J, rhs, w):
    """``[J^T W J | J^T W rhs]`` [..., 6, 7] for rows ``J`` [..., N, (k,)
    6] with right-hand sides ``rhs`` [..., N, (k)] and weights ``w`` [...,
    N]: every product summed over the rows in :func:`fsum`'s fixed order,
    so a batch entry gets the bits of its solve alone."""
    M = torch.cat([J, rhs[..., None]], -1)
    Jw = J * expand_like(w, J) if J.dim() == w.dim() + 1 else \
        J * w[..., None, None]
    P = Jw[..., :, None] * M[..., None, :]  # [..., N, (k,) 6, 7]
    if J.dim() == w.dim() + 2:  # k rows a point: sum the N*k rows
        P = P.reshape(*P.shape[:-4], -1, 6, 7)
    return fsum(P, dim=-3)


def _pt2pl_system(p, q, nt, w):
    """J = [n | p x n-ish], rhs d = n.(q-p) (`cregistration.hpp:2066-2156`)."""
    a = nt[..., 2] * p[..., 1] - nt[..., 1] * p[..., 2]
    b = nt[..., 0] * p[..., 2] - nt[..., 2] * p[..., 0]
    c = nt[..., 1] * p[..., 0] - nt[..., 0] * p[..., 1]
    J = torch.stack([nt[..., 0], nt[..., 1], nt[..., 2], a, b, c],
                    dim=-1)  # [..., N, 6]
    d = torch.sum(nt * (q - p), dim=-1)
    sys = _normal_rows(J, d, w)
    return sys[..., :6], sys[..., 6], J, d


def _pt2li_rows(p, v):
    """A [..., N,3,6] for the cross-product point-to-line residual
    (`cregistration.hpp:2195-2224`)."""
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(px)
    return torch.stack([
        torch.stack([zero, -vz, vy, vy * py + vz * pz, -vy * px, -vz * px],
                    -1),
        torch.stack([vz, zero, -vx, -vx * py, vz * pz + vx * px, -vz * py],
                    -1),
        torch.stack([-vy, vx, zero, -vx * pz, -vy * pz, vx * px + vy * py],
                    -1),
    ], dim=-2)


def _pt2li_rhs(p, q, v):
    d = p - q
    bx = -v[..., 1] * d[..., 2] + v[..., 2] * d[..., 1]
    by = -v[..., 2] * d[..., 0] + v[..., 0] * d[..., 2]
    bz = -v[..., 0] * d[..., 1] + v[..., 1] * d[..., 0]
    return torch.stack([bx, by, bz], dim=-1)


def _pt2pt_rows(p):
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    zero = torch.zeros_like(px)
    one = torch.ones_like(px)
    return torch.stack([
        torch.stack([one, zero, zero, zero, pz, -py], -1),
        torch.stack([zero, one, zero, -pz, zero, px], -1),
        torch.stack([zero, zero, one, py, -px, zero], -1),
    ], dim=-2)


def _rows_system(A, b, w):
    sys = _normal_rows(A, b, w)
    return sys[..., :6], sys[..., 6]


def _weight_by_dist_adaptive(dist, iter_num, cfg: RegConfig):
    b = min(cfg.dist_weight_base_min + cfg.dist_weight_base_step * iter_num,
            cfg.dist_weight_base_max)
    w = b + (1.0 - b) * dist / cfg.dist_weight_unit_dist
    return torch.clamp(w, min=0.01)


def _weight_by_residual(res, window):
    # Huber (`cregistration.hpp:2710-2722`, delta=1)
    return torch.where(res > window,
                       (2.0 * res * window - window * window)
                       / torch.clamp(res * res, min=1e-12),
                       1.0)


def _weight_by_intensity(pi, qi, scale):
    return torch.exp(-torch.abs(pi - qi) / scale)


def _translation(c: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] translations by ``c`` [..., 3]."""
    T = torch.eye(4, dtype=c.dtype, device=c.device).expand(
        *c.shape[:-1], 4, 4).clone()
    T[..., :3, 3] = c
    return T


def mm_lls_icp(source: Dict[str, FeatureCloud],
               target: Dict[str, FeatureCloud], cfg: RegConfig,
               init_guess: torch.Tensor, max_iter: int,
               dis_thre_add=0.0) -> RegResult:
    """Register source onto target; returns T such that T @ source ~ target.

    ``cfg.used_feature_type`` selects classes.  ``dis_thre_add`` (float or
    tensor) widens the initial correspondence gate — the reference's
    ``add_length`` recovery (`mulls_slam.cpp:650-657, 686-693`).

    Clouds with a leading batch dimension (``[S, N, 3]``, ``init_guess``
    [S, 4, 4], ``dis_thre_add`` a number or [S]) are S registrations run
    as one: one grouped ``nn`` launch an iteration for every class of every
    entry, each entry frozen once done, each with the result of its call
    alone (the reference's batched ``while_loop`` freezes an entry the same
    way).
    """
    dev = init_guess.device
    f32 = torch.float32
    lead = tuple(init_guess.shape[:-2])
    used = [n for n in CLASS_ORDER
            if cfg.used_feature_type[_TYPE_IDX[n]] == "1" and n in source]
    cos_bearing = math.cos(math.radians(cfg.normal_bearing))
    strategy = cfg.corr_weight_strategy
    converge_rot = math.radians(cfg.converge_rot_d)
    max_rot = math.radians(cfg.max_bearable_rotation_d)
    add = torch.as_tensor(dis_thre_add, dtype=f32, device=dev)
    max_tran = 2.0 * (cfg.corr_dis_thre_init + add)
    eye6 = torch.eye(6, dtype=f32, device=dev)

    s_counts = {n: source[n].count for n in used}
    src_feature_count = sum(s_counts[n] for n in ("pillar", "facade", "beam")
                            if n in s_counts)
    src_feature_count = torch.clamp(
        torch.as_tensor(src_feature_count, device=dev), min=1)

    # intersection (bbx) filter (`cregistration.hpp:1186-1188, 2894`)
    if cfg.apply_intersection_filter:
        tmin = torch.full((*lead, 3), float("inf"), device=dev)
        tmax = torch.full((*lead, 3), -float("inf"), device=dev)
        for n in used:
            tmin = torch.minimum(tmin, masked_min(
                target[n].xyz, target[n].mask[..., None], dim=-2))
            tmax = torch.maximum(tmax, masked_max(
                target[n].xyz, target[n].mask[..., None], dim=-2))
        bbx_pad = 2.0 * cfg.corr_dis_thre_init
        tmin = (tmin - bbx_pad)[..., None, :]
        tmax = (tmax + bbx_pad)[..., None, :]
    else:
        tmin = tmax = None

    it = torch.zeros(lead, dtype=torch.int32, device=dev)
    T = init_guess.to(f32)
    thre = torch.full((*lead, len(used)), cfg.corr_dis_thre_init, dtype=f32,
                      device=dev) + add[..., None]
    done = torch.zeros(lead, dtype=torch.bool, device=dev)
    code = torch.zeros(lead, dtype=torch.int32, device=dev)
    sigma2 = torch.ones(lead, dtype=f32, device=dev)
    info = eye6.expand(*lead, 6, 6)
    conf = torch.ones(lead, dtype=f32, device=dev)

    shooting = [n for n in used if cfg.normal_shooting_on and _PLANAR[n]]
    for k in range(max_iter):
        with trace.span("reg.iter"):
            # transform every class, then ONE grouped 1-NN launch for the
            # classes that do not use normal shooting (and every batch entry)
            s_pts, s_dirs, s_masks = {}, {}, {}
            for name in used:
                sc = source[name]
                s_xyz = se3.transform_points(T, sc.xyz)
                s_mask = sc.mask
                if tmin is not None:
                    s_mask = s_mask & torch.all(
                        (s_xyz >= tmin) & (s_xyz <= tmax), dim=-1)
                s_pts[name] = s_xyz
                s_dirs[name] = se3.rotate_vectors(T, sc.normal)
                s_masks[name] = s_mask
            nearest = [n for n in used if n not in shooting]
            found = dict(zip(nearest, nearest_neighbor_grouped(
                [(s_pts[n], s_masks[n], target[n].xyz, target[n].mask)
                 for n in nearest])))
            corrs = {}
            for ci, name in enumerate(used):
                if name in shooting:
                    found[name] = normal_shooting_neighbor(
                        s_pts[name], s_dirs[name], s_masks[name],
                        target[name].xyz, target[name].mask,
                        2.5 * thre[..., ci])
                corrs[name] = _find_corres(
                    found[name], s_pts[name], s_dirs[name], s_masks[name],
                    target[name], thre[..., ci], cos_bearing,
                    normal_check=(name != "vertex"))

            cnt = {n: torch.sum(corrs[n].valid, -1) for n in used}
            total = sum(cnt.values())
            necessary = sum(cnt[n] for n in ("pillar", "facade", "beam")
                            if n in cnt)
            necessary = torch.as_tensor(necessary, device=dev)
            conf_new = necessary / src_feature_count
            too_few = ((total < cfg.min_total_corr_num)
                       | (necessary < cfg.min_neccessary_corr_num)
                       | (conf_new < cfg.min_neccessary_corr_ratio))

            # x,y,z balance weight (`cregistration.hpp:1892-1900`)
            m1 = cnt.get("ground", 0) + cnt.get("roof", 0)
            m2, m3, m4 = (cnt.get("facade", 0), cnt.get("pillar", 0),
                          cnt.get("beam", 0))
            if strategy[0] == "1":
                w_ground = torch.clamp(
                    cfg.z_xy_balance_ratio * (m2 + 2 * m3 - m4)
                    / (1e-4 + 2.0 * m1), min=0.01)
            else:
                w_ground = torch.ones(lead, device=dev)
            class_w = {n: (w_ground[..., None] if n in ("ground", "roof")
                           else 1.0) for n in used}

            # centred normal equations
            wsum = torch.full(lead, 1e-6, dtype=f32, device=dev)
            csum = torch.zeros((*lead, 3), dtype=f32, device=dev)
            for name in used:
                v = corrs[name].valid
                wsum = wsum + torch.sum(v, -1)
                csum = csum + fsum(torch.where(v[..., None], s_pts[name], 0.0),
                                   dim=-2)
            center = csum / wsum[..., None]

            ATA = torch.zeros((*lead, 6, 6), dtype=f32, device=dev)
            ATb = torch.zeros((*lead, 6), dtype=f32, device=dev)
            vtpv = torch.zeros(lead, dtype=f32, device=dev)
            nobs = torch.zeros(lead, dtype=f32, device=dev)
            per_class = {}
            late = (it > cfg.residual_weight_after_iter)[..., None]
            for name in used:
                sc, tc, corr = source[name], target[name], corrs[name]
                p = s_pts[name] - center[..., None, :]
                q_abs = take(tc.xyz, corr.t_idx)
                q = q_abs - center[..., None, :]
                tn = take(tc.normal, corr.t_idx)
                pi, qi = sc.intensity, take(tc.intensity, corr.t_idx)
                w = torch.where(corr.valid, class_w[name], 0.0)
                if strategy[2] == "1":
                    w = w * _weight_by_dist_adaptive(
                        torch.linalg.norm(q_abs, dim=-1), k, cfg)
                if strategy[3] == "1":
                    w = w * _weight_by_intensity(pi, qi, cfg.intensity_scale)
                if _PLANAR[name]:
                    d = torch.sum(tn * (q - p), dim=-1)
                    if strategy[1] == "1":
                        rw = _weight_by_residual(torch.abs(d),
                                                 cfg.pt2pl_res_window)
                        w = w * torch.where(late, rw, 1.0)
                    ata, atb, J, d = _pt2pl_system(p, q, tn, w)
                    per_class[name] = ("pl", J, d, w)
                elif name == "vertex":
                    A = _pt2pt_rows(p)
                    b = -(p - q)
                    if strategy[1] == "1":
                        rw = _weight_by_residual(
                            torch.linalg.norm(p - q, dim=-1),
                            cfg.pt2pt_res_window)
                        w = w * torch.where(late, rw, 1.0)
                    ata, atb = _rows_system(A, b, w)
                    per_class[name] = ("li", A, b, w)
                else:  # pillar / beam: point-to-line via primary direction
                    A = _pt2li_rows(p, tn)
                    b = _pt2li_rhs(p, q, tn)
                    if strategy[1] == "1":
                        rw = _weight_by_residual(torch.linalg.norm(b, dim=-1),
                                                 cfg.pt2li_res_window)
                        w = w * torch.where(late, rw, 1.0)
                    ata, atb = _rows_system(A, b, w)
                    per_class[name] = ("li", A, b, w)
                ATA = ATA + ata
                ATb = ATb + atb

            # solve (ridge epsilon keeps the all-masked case finite)
            ATA_r = ATA + 1e-6 * eye6
            x = torch.linalg.solve_ex(ATA_r, ATb)[0]

            # degeneracy-aware solution remapping (extension of the reference
            # package): whiten by the diagonal, zero the update along
            # eigendirections with eigenvalue < degeneracy_thre
            if cfg.degeneracy_thre > 0.0:
                tr_t = ATA_r[..., 0, 0] + ATA_r[..., 1, 1] + ATA_r[..., 2, 2]
                tr_r = ATA_r[..., 3, 3] + ATA_r[..., 4, 4] + ATA_r[..., 5, 5]
                rho = torch.sqrt(torch.clamp(tr_r, min=1e-9)
                                 / torch.clamp(tr_t, min=1e-9))
                s_bal = torch.cat(
                    [torch.ones((*lead, 3), dtype=f32, device=dev),
                     rho[..., None].expand(*lead, 3)], -1)
                norm = torch.clamp(tr_t / 3.0, min=1e-9)
                Ahat = (ATA_r / s_bal[..., :, None] / s_bal[..., None, :]
                        / norm[..., None, None])
                with trace.sync("eigh"):
                    lam, Vh = torch.linalg.eigh(Ahat)
                keep = (lam >= cfg.degeneracy_thre).to(f32)
                z = s_bal * x
                x = matvec(Vh, keep * matvec(Vh.transpose(-1, -2), z)) / s_bal

            # residuals at the solution -> posterior sigma^2
            for name in used:
                kind, A_or_J, b_or_d, w = per_class[name]
                if kind == "pl":
                    r = matvec(A_or_J, x) - b_or_d
                    vtpv = vtpv + fsum(w * r * r, -1)
                    nobs = nobs + torch.sum(w > 0, -1)
                else:
                    r = matvec(A_or_J, x[..., None, :]) - b_or_d
                    vtpv = vtpv + fsum(w * torch.sum(r * r, -1), -1)
                    nobs = nobs + 3.0 * torch.sum(w > 0, -1)
            sigma2_new = vtpv / torch.clamp(nobs - 6.0, min=1.0)

            # un-centre: T_step = Trans(c) @ T'(x) @ Trans(-c)
            Tp = se3.from_x(x)
            T_step = matmul(matmul(_translation(center), Tp),
                            _translation(-center))

            # information matrix in the uncentred frame:
            # ATA_unc = G^-T ATA G^-1
            Ginv = eye6.expand(*lead, 6, 6).clone()
            Ginv[..., :3, 3:] = -se3.skew(center)
            ATA_unc = matmul(matmul(Ginv.transpose(-1, -2), ATA_r), Ginv)
            # euler -> quaternion covariance propagation
            # (`cregistration.hpp:1953-1964, 2795-2836`)
            Jbig = eye6.expand(*lead, 6, 6).clone()
            Jbig[..., 3:, 3:] = se3.quat_euler_jacobi(x[..., 3:6])
            cof = torch.linalg.inv_ex(ATA_unc)[0]
            cof_q = matmul(matmul(Jbig, cof), Jbig.transpose(-1, -2))
            info_new = torch.linalg.inv_ex(cof_q + 1e-12 * eye6)[0] \
                / torch.clamp(sigma2_new, min=1e-12)[..., None, None]

            step_t = torch.linalg.norm(T_step[..., :3, 3], dim=-1)
            step_r = se3.rotation_angle(T_step[..., :3, :3])
            diverged = (step_t > max_tran) | (step_r > max_rot)
            converged = (it > 2) & (step_t < cfg.converge_tran) & \
                (step_r < converge_rot)
            last_iter = it >= max_iter - 1

            # status codes (`cregistration.hpp:1131-1136`)
            sigma_bad = torch.sqrt(sigma2_new) >= cfg.sigma_thre
            stop = converged | last_iter
            code_new = torch.where(
                too_few, -2,
                torch.where(diverged, -1,
                            torch.where(stop & sigma_bad, -3,
                                        torch.where(stop, 1, 0)))
            ).to(torch.int32)
            done_new = too_few | diverged | converged | last_iter

            apply_step = ~(too_few | diverged)
            T_new = where(apply_step, matmul(T_step, T), T)
            # anneal thresholds for the next iteration
            thre_new = torch.clamp(thre / cfg.dis_thre_update_rate,
                                   min=cfg.corr_dis_thre_min)

            # freeze once done: the masked update equals the early exit
            live = ~done
            it = torch.where(live, it + 1, it)
            T = where(live, T_new, T)
            thre = where(live, thre_new, thre)
            code = torch.where(live, code_new, code)
            sigma2 = torch.where(live & apply_step, sigma2_new, sigma2)
            info = where(live & apply_step, info_new, info)
            conf = torch.where(live, conf_new.to(f32), conf)
            done = done | done_new

    # re-orthonormalize the accumulated rotation
    T = T.clone()
    T[..., :3, :3] = se3.orthonormalize(T[..., :3, :3])
    return RegResult(transform=T, information=info, sigma=torch.sqrt(sigma2),
                     confidence=conf, process_code=code, iterations=it)


def ground_3dof_estimate(source_ground: FeatureCloud,
                         target_ground: FeatureCloud, cfg: RegConfig,
                         init_guess: torch.Tensor,
                         max_iter: int = 10) -> RegResult:
    """LeGO-LOAM-style two-step variant: estimate only (tz, roll, pitch)
    from ground point-to-plane correspondences (`lls_icp_3dof_ground`,
    `cregistration.hpp:1443-1582, 2278-2320`).  The reference's
    ``while_loop`` is a loop of ``max_iter`` steps that freezes its state
    once done, as in :func:`mm_lls_icp`; each step's 1-NN is one launch of
    the ``nn`` kernel on the card."""
    dev = init_guess.device
    f32 = torch.float32
    cos_bearing = math.cos(math.radians(cfg.normal_bearing))
    cols = torch.tensor([2, 3, 4], device=dev)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    t_xyz = target_ground.xyz.contiguous()

    it = torch.tensor(0, dtype=torch.int32, device=dev)
    T = init_guess.to(f32)
    thre = torch.tensor(cfg.corr_dis_thre_init, dtype=f32, device=dev)
    done = torch.tensor(False, device=dev)
    sigma2 = torch.tensor(1.0, dtype=f32, device=dev)
    for _ in range(max_iter):
        s_xyz = se3.transform_points(T, source_ground.xyz)
        s_dir = se3.rotate_vectors(T, source_ground.normal)
        found = kernels.nn(s_xyz.contiguous(), source_ground.mask, t_xyz,
                           target_ground.mask)
        corr = _find_corres(found, s_xyz, s_dir, source_ground.mask,
                            target_ground, thre, cos_bearing,
                            normal_check=True)
        q = target_ground.xyz[corr.t_idx]
        tn = target_ground.normal[corr.t_idx]
        w = corr.valid.to(f32)
        _, _, J, d = _pt2pl_system(s_xyz, q, tn, w)
        # columns (tz, alpha, beta) of the full 6-dof jacobian
        J3 = J[:, cols]
        ATA = (J3 * w[:, None]).T @ J3 + 1e-6 * eye3
        ATb = (J3 * w[:, None]).T @ d
        x3 = torch.linalg.solve_ex(ATA, ATb)[0]
        x6 = torch.zeros((6,), dtype=f32, device=dev).index_copy(0, cols, x3)
        r = J3 @ x3 - d
        nobs = torch.clamp(torch.sum(w) - 3.0, min=1.0)
        sigma2_new = torch.sum(w * r * r) / nobs
        T_new = se3.from_x(x6) @ T
        done_new = (it >= 2) & (torch.linalg.norm(x3) < cfg.converge_tran)
        thre_new = torch.clamp(thre / cfg.dis_thre_update_rate,
                               min=cfg.corr_dis_thre_min)
        # freeze once done: the masked update equals the early exit
        live = ~done
        it = torch.where(live, it + 1, it)
        T = torch.where(live, T_new, T)
        thre = torch.where(live, thre_new, thre)
        sigma2 = torch.where(live, sigma2_new, sigma2)
        done = done | done_new
    T = T.clone()
    T[:3, :3] = se3.orthonormalize(T[:3, :3])
    return RegResult(transform=T, information=torch.eye(6, device=dev),
                     sigma=torch.sqrt(sigma2),
                     confidence=torch.tensor(1.0, dtype=f32, device=dev),
                     process_code=torch.tensor(1, dtype=torch.int32,
                                               device=dev),
                     iterations=it)


def mm_lls_icp_4dof_global(source: Dict[str, FeatureCloud],
                           target: Dict[str, FeatureCloud], cfg: RegConfig,
                           heading_step_d: float = 15.0, max_iter: int = 12):
    """TLS-style global registration: brute-force heading sweep, one
    MULLS-ICP per trial yaw, keep the best (sigma, confidence) score
    (`mm_lls_icp_4dof_global`, `cregistration.hpp:1584-1681`).  The
    headings run one after another.  Returns the reference's 3-tuple
    (RegResult of the best heading, its seed yaw in degrees, its score)."""
    dev = next(iter(source.values())).xyz.device
    f32 = torch.float32
    n_try = max(int(round(360.0 / heading_step_d)), 1)
    yaws = torch.tensor([math.radians(k * heading_step_d)
                         for k in range(n_try)], dtype=f32, device=dev)
    zero3 = torch.zeros(3, dtype=f32, device=dev)
    results = []
    for yaw in yaws:
        init = se3.make_transform(zero3, torch.stack([0.0 * yaw, 0.0 * yaw,
                                                      yaw]))
        results.append(mm_lls_icp(source, target, cfg, init,
                                  max_iter=max_iter))
    code = torch.stack([r.process_code for r in results])
    conf = torch.stack([r.confidence for r in results])
    sigma = torch.stack([r.sigma for r in results])
    score = torch.where(code == 1, conf / torch.clamp(sigma, min=1e-4),
                        -1.0)
    best = int(torch.argmax(score))  # the first maximum, as jnp.argmax
    return results[best], torch.rad2deg(yaws[best]), score[best]
