"""Registration and map insertion, written plainly in float64 for one
sequence at a time: the part of the reference that is not a copy of the
program.

It follows the semantics of MULLS-ICP (the reference's
``cregistration.hpp:1114-1440``, as this repository's configuration sets
it: 1-NN correspondences with a 2.5x candidate gate, one source a target,
annealed per-class thresholds and the normal gate; point-to-plane,
point-to-line and point-to-point rows with the x-y-z balance, residual,
distance and intensity weights; one 6x6 system an iteration in coordinates
centred on the correspondences, the degeneracy remap, and the status codes)
and of the local map's insertion (``map_manager.cpp``: the map moved into
the new frame, the append and dynamic-removal gates, the sphere crop and
the random re-budget that keeps each class's capacity).  Every sum is a
float64 sum over plain tensors of one sequence: no batch axis, no fixed
summation order, no kernel.

Clouds are dicts of ``xyz`` [N, 3], ``normal`` [N, 3], ``intensity`` [N]
and ``mask`` [N] (bool) tensors; a feature frame or a map is a dict of such
clouds by class.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

CLASSES = ("ground", "pillar", "facade", "beam", "roof", "vertex")
PLANAR = ("ground", "facade", "roof")
F64 = torch.float64


def _d(t: torch.Tensor) -> torch.Tensor:
    return t.to(F64)


def rotation(roll, pitch, yaw) -> torch.Tensor:
    """R = Rz(yaw) Ry(pitch) Rx(roll), float64 [3, 3]."""
    ca, sa = math.cos(roll), math.sin(roll)
    cb, sb = math.cos(pitch), math.sin(pitch)
    cg, sg = math.cos(yaw), math.sin(yaw)
    Rx = torch.tensor([[1, 0, 0], [0, ca, -sa], [0, sa, ca]], dtype=F64)
    Ry = torch.tensor([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]], dtype=F64)
    Rz = torch.tensor([[cg, -sg, 0], [sg, cg, 0], [0, 0, 1]], dtype=F64)
    return Rz @ Ry @ Rx


def angle_of(R: torch.Tensor) -> float:
    """The rotation angle of R (radians), from its trace."""
    c = (float(R[0, 0] + R[1, 1] + R[2, 2]) - 1.0) / 2.0
    return math.acos(max(-1.0, min(1.0, c)))


def nearest(q: torch.Tensor, p: torch.Tensor, chunk: int = 1024) -> tuple:
    """(index, squared distance) of each query's nearest support point
    (float64 brute force); inf without support."""
    n = q.shape[0]
    if p.shape[0] == 0 or n == 0:
        return (torch.zeros(n, dtype=torch.int64, device=q.device),
                torch.full((n,), math.inf, dtype=F64, device=q.device))
    idx, d2 = [], []
    for s in range(0, n, chunk):
        v, i = torch.cdist(q[s:s + chunk], p).min(1)
        idx.append(i)
        d2.append(v * v)
    return torch.cat(idx), torch.cat(d2)


def _huber(res: torch.Tensor, window: float) -> torch.Tensor:
    return torch.where(res > window,
                       (2.0 * res * window - window * window)
                       / torch.clamp(res * res, min=1e-12), 1.0)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """[N, 3] -> [N, 3, 3] cross-product matrices."""
    z = torch.zeros_like(v[:, 0])
    return torch.stack([
        torch.stack([z, -v[:, 2], v[:, 1]], -1),
        torch.stack([v[:, 2], z, -v[:, 0]], -1),
        torch.stack([-v[:, 1], v[:, 0], z], -1)], -2)


def _orthonormal(T: torch.Tensor) -> torch.Tensor:
    u, _, vt = torch.linalg.svd(T[:3, :3])
    d = float(torch.linalg.det(u @ vt))
    out = T.clone()
    out[:3, :3] = u @ torch.diag(torch.tensor(
        [1.0, 1.0, d], dtype=F64, device=T.device)) @ vt
    return out


def icp(source: Dict[str, dict], target: Dict[str, dict], reg,
        guess: torch.Tensor, max_iter: int, add: float,
        until: int = 0) -> dict:
    """MULLS-ICP of ``source`` onto ``target`` from ``guess`` [4, 4]:
    ``{"T": [4, 4] float64, "code", "sigma", "confidence", "iterations"}``
    at its own stop (code 1 ok, -1 diverged, -2 too few correspondences,
    -3 sigma too large), and every iteration's record under ``"path"``
    (the ICP run on to ``max_iter`` as if it had not stopped): ``T`` after
    it, its ``step_t`` (m), ``step_r`` (rad) and ``sigma``, and the
    ``code`` it would stop with, or 0.  ``reg``: the configuration's registration
    settings."""
    if reg.normal_shooting_on:
        raise NotImplementedError("normal-shooting correspondences")
    dev = guess.device
    bits = reg.used_feature_type
    used = [c for i, c in enumerate(CLASSES)
            if bits[i] == "1" and c in source]
    src = {c: {k: _d(v) if k != "mask" else v.bool()
               for k, v in source[c].items()} for c in used}
    tgt = {c: {k: _d(v) if k != "mask" else v.bool()
               for k, v in target[c].items()} for c in used}
    tv = {c: tgt[c]["mask"] for c in used}
    cos_gate = math.cos(math.radians(reg.normal_bearing))
    strategy = reg.corr_weight_strategy
    max_tran = 2.0 * (reg.corr_dis_thre_init + add)
    max_rot = math.radians(reg.max_bearable_rotation_d)
    conv_rot = math.radians(reg.converge_rot_d)
    n_feat = max(1, sum(int(src[c]["mask"].sum())
                        for c in ("pillar", "facade", "beam") if c in src))
    box = None
    if reg.apply_intersection_filter:
        pts = torch.cat([tgt[c]["xyz"][tv[c]] for c in used])
        pad = 2.0 * reg.corr_dis_thre_init
        if pts.shape[0]:
            box = (pts.min(0).values - pad, pts.max(0).values + pad)
        else:
            box = (torch.full((3,), math.inf, dtype=F64, device=dev),
                   torch.full((3,), -math.inf, dtype=F64, device=dev))

    T = _d(guess).clone()
    thre = {c: reg.corr_dis_thre_init + add for c in used}
    code, sigma2, conf, it = 0, 1.0, 1.0, 0
    path, own = [], None
    for k in range(max_iter):
        R, t = T[:3, :3], T[:3, 3]
        corr = {}
        for c in used:
            s = src[c]
            x = s["xyz"] @ R.T + t
            m = s["mask"].clone()
            if box is not None:
                m &= ((x >= box[0]) & (x <= box[1])).all(-1)
            n_dir = s["normal"] @ R.T
            tp = tgt[c]["xyz"][tv[c]]
            ti = torch.nonzero(tv[c]).flatten()
            i_loc, d2 = nearest(x, tp)
            idx = ti[i_loc] if ti.numel() else i_loc
            cand = m & (d2 <= (2.5 * thre[c]) ** 2)
            # one source a target: the nearest, then the lowest ordinal
            n_t = tgt[c]["xyz"].shape[0]
            best = torch.full((n_t,), math.inf, dtype=F64, device=dev)
            best.scatter_reduce_(0, idx[cand], d2[cand], "amin")
            tied = cand & (d2 <= best[idx])
            j = torch.arange(x.shape[0], device=dev)
            first = torch.full((n_t,), x.shape[0], dtype=torch.int64,
                               device=dev)
            first.scatter_reduce_(0, idx[tied], j[tied], "amin")
            keep = tied & (first[idx] == j)
            keep &= d2 <= thre[c] ** 2
            if c != "vertex":
                cosang = (n_dir * tgt[c]["normal"][idx]).sum(-1).abs()
                keep &= cosang >= cos_gate
            corr[c] = (x, idx, keep)
        cnt = {c: int(corr[c][2].sum()) for c in used}
        total = sum(cnt.values())
        necessary = sum(cnt.get(c, 0) for c in ("pillar", "facade", "beam"))
        conf_new = necessary / n_feat
        too_few = (total < reg.min_total_corr_num
                   or necessary < reg.min_neccessary_corr_num
                   or conf_new < reg.min_neccessary_corr_ratio)
        if strategy[0] == "1":
            m1 = cnt.get("ground", 0) + cnt.get("roof", 0)
            w_ground = max(0.01, reg.z_xy_balance_ratio
                           * (cnt.get("facade", 0) + 2 * cnt.get("pillar", 0)
                              - cnt.get("beam", 0)) / (1e-4 + 2.0 * m1))
        else:
            w_ground = 1.0
        n_valid = sum(cnt.values())
        center = sum((corr[c][0][corr[c][2]].sum(0) for c in used),
                     torch.zeros(3, dtype=F64, device=dev)) \
            / (n_valid + 1e-6)
        late = it > reg.residual_weight_after_iter
        ATA = torch.zeros(6, 6, dtype=F64, device=dev)
        ATb = torch.zeros(6, dtype=F64, device=dev)
        rows = []
        for c in used:
            x, idx, keep = corr[c]
            x, idx = x[keep], idx[keep]
            q_abs = tgt[c]["xyz"][idx]
            p, q = x - center, q_abs - center
            tn = tgt[c]["normal"][idx]
            w = torch.full((p.shape[0],),
                           w_ground if c in ("ground", "roof") else 1.0,
                           dtype=F64, device=dev)
            if strategy[2] == "1":
                b = min(reg.dist_weight_base_min
                        + reg.dist_weight_base_step * k,
                        reg.dist_weight_base_max)
                w = w * torch.clamp(b + (1.0 - b) * q_abs.norm(dim=-1)
                                    / reg.dist_weight_unit_dist, min=0.01)
            if strategy[3] == "1":
                w = w * torch.exp(-(src[c]["intensity"][keep]
                                    - tgt[c]["intensity"][idx]).abs()
                                  / reg.intensity_scale)
            if c in PLANAR:
                # n . (R p + t - q) = 0, linearised: [n, p x n] x = n.(q-p)
                A = torch.cat([tn, torch.cross(p, tn, dim=-1)], -1)[:, None]
                r0 = (tn * (q - p)).sum(-1)[:, None]
                window = reg.pt2pl_res_window
                size = r0[:, 0].abs()
            elif c == "vertex":
                # R p + t - q = 0: [I, -[p]x] x = q - p
                eye = torch.eye(3, dtype=F64, device=dev).expand(
                    p.shape[0], 3, 3)
                A = torch.cat([eye, -_skew(p)], -1)
                r0 = q - p
                window = reg.pt2pt_res_window
                size = r0.norm(dim=-1)
            else:
                # v x (R p + t - q) = 0: [[v]x, -[v]x [p]x] x = v x (q - p)
                V = _skew(tn)
                A = torch.cat([V, -V @ _skew(p)], -1)
                r0 = torch.cross(tn, q - p, dim=-1)
                window = reg.pt2li_res_window
                size = r0.norm(dim=-1)
            if strategy[1] == "1" and late:
                w = w * _huber(size, window)
            ATA += torch.einsum("n,nki,nkj->ij", w, A, A)
            ATb += torch.einsum("n,nki,nk->i", w, A, r0)
            rows.append((A, r0, w))
        ATA += 1e-6 * torch.eye(6, dtype=F64, device=dev)
        x = torch.linalg.solve(ATA, ATb)
        if reg.degeneracy_thre > 0.0:
            tr_t = float(ATA[0, 0] + ATA[1, 1] + ATA[2, 2])
            tr_r = float(ATA[3, 3] + ATA[4, 4] + ATA[5, 5])
            rho = math.sqrt(max(tr_r, 1e-9) / max(tr_t, 1e-9))
            s = torch.tensor([1, 1, 1, rho, rho, rho], dtype=F64,
                             device=dev)
            Ahat = ATA / s[:, None] / s[None, :] / max(tr_t / 3.0, 1e-9)
            lam, V = torch.linalg.eigh(Ahat)
            z = V.T @ (s * x)
            x = (V @ torch.where(lam >= reg.degeneracy_thre, z, 0.0)) / s
        vtpv = sum(float((w * ((A @ x) - r0).pow(2).sum(-1)).sum())
                   for A, r0, w in rows)
        nobs = sum(float((w > 0).sum()) * A.shape[1] for A, r0, w in rows)
        sigma2_new = vtpv / max(nobs - 6.0, 1.0)
        step = torch.eye(4, dtype=F64, device=dev)
        Rs = rotation(*[float(v) for v in x[3:]]).to(dev)
        step[:3, :3] = Rs
        step[:3, 3] = x[:3] + center - Rs @ center
        step_t = float(step[:3, 3].norm())
        step_r = angle_of(Rs)
        diverged = step_t > max_tran or step_r > max_rot
        converged = it > 2 and step_t < reg.converge_tran \
            and step_r < conv_rot
        last = it >= max_iter - 1
        if too_few:
            code = -2
        elif diverged:
            code = -1
        elif converged or last:
            code = -3 if math.sqrt(sigma2_new) >= reg.sigma_thre else 1
        else:
            code = 0
        if not (too_few or diverged):
            T = step @ T
            sigma2 = sigma2_new
        conf = conf_new
        it += 1
        path.append({"T": T.clone(), "step_t": step_t, "step_r": step_r,
                     "sigma": math.sqrt(sigma2_new), "code": code,
                     "confidence": conf_new, "counts": cnt})
        if own is None and (too_few or diverged or converged or last):
            own = {"T": _orthonormal(T), "code": code,
                   "sigma": math.sqrt(sigma2), "confidence": conf,
                   "iterations": it}
        if own is not None and it >= until:
            break
        thre = {c: max(v / reg.dis_thre_update_rate, reg.corr_dis_thre_min)
                for c, v in thre.items()}
    for p in path:
        p["T"] = _orthonormal(p["T"])
    return dict(own, path=path)


def insert(local_map: Dict[str, dict], frame: Dict[str, dict],
           T_rel: torch.Tensor, caps: Dict[str, int], mcfg,
           uniform: torch.Tensor, removal_enabled: bool) -> Dict[str, dict]:
    """The local map after appending ``frame`` (its down-sampled clouds,
    in its own coordinates) registered by ``T_rel`` (new frame -> map):
    the map moved into the new frame, the frame's points within the append
    radius added after the dynamic-removal gate, every class cropped to the
    map radius, and each class re-budgeted to ``caps[c]`` points by the
    random priority ``uniform`` (one draw a row of the old-then-new rows of
    every class, in class order; a new row's priority is raised by 0.5).
    Returns ``{class: {"xyz", "mask"}}`` in float64."""
    T = _d(T_rel)
    Ri, ti = T[:3, :3].T, -(T[:3, :3].T @ T[:3, 3])
    count = sum(int(local_map[c]["mask"].sum())
                for c in ("ground", "pillar", "facade", "beam", "roof"))
    removal = (removal_enabled and mcfg.map_based_dynamic_removal_on
               and count > mcfg.local_map_max_pt_num // 5)
    dist_max = max(1.5 * float(T[:3, 3].norm()),
                   mcfg.dynamic_dist_thre_min + 0.1)
    out, at = {}, 0
    for c in CLASSES:
        old_xyz = _d(local_map[c]["xyz"]) @ Ri.T + ti
        old_m = local_map[c]["mask"].bool()
        new_xyz = _d(frame[c]["xyz"])
        new_m = frame[c]["mask"].bool() & (
            new_xyz.norm(dim=-1) < mcfg.append_frame_radius)
        if c in ("pillar", "beam", "facade") and removal:
            _, d2 = nearest(new_xyz, old_xyz[old_m])
            d = d2.sqrt()
            moving = (d <= mcfg.near_dist_thre) | (
                (d >= mcfg.dynamic_dist_thre_min) & (d <= dist_max))
            new_m &= ~((new_xyz.norm(dim=-1)
                        < mcfg.dynamic_removal_radius) & moving)
        xyz = torch.cat([old_xyz, new_xyz])
        mask = torch.cat([old_m, new_m]) & (
            xyz.norm(dim=-1) < mcfg.local_map_radius)
        n_old = old_xyz.shape[0]
        u = _d(uniform[at:at + xyz.shape[0]]).clone()
        at += xyz.shape[0]
        u[n_old:] += 0.5
        # valid rows by falling priority (ties: the earlier row), then the
        # invalid rows in order; the first caps[c] rows are kept
        key = torch.where(mask, 1.5 - u, 3.0)
        kept = torch.argsort(key, stable=True)[:caps[c]]
        out[c] = {"xyz": xyz[kept], "mask": mask[kept]}
    return out


def unmatched(a: torch.Tensor, b: torch.Tensor, match_m: float) -> int:
    """How many points of ``a`` [N, 3] lie farther than ``match_m`` from
    every point of ``b`` [M, 3]."""
    if a.shape[0] == 0:
        return 0
    if b.shape[0] == 0:
        return a.shape[0]
    _, d2 = nearest(_d(a), _d(b))
    return int((d2 > match_m ** 2).sum())


def cloud_miss(a: Dict[str, dict], b: Dict[str, dict], match_m: float,
               classes: Optional[tuple] = None) -> tuple:
    """(points of either side with no point of the same class on the other
    within ``match_m``, valid points of both sides), over the classes."""
    miss = total = 0
    for c in classes or sorted(set(a) & set(b)):
        pa = a[c]["xyz"][a[c]["mask"].bool()]
        pb = b[c]["xyz"][b[c]["mask"].bool()]
        miss += unmatched(pa, pb, match_m) + unmatched(pb, pa, match_m)
        total += pa.shape[0] + pb.shape[0]
    return miss, total
