"""Robust global (coarse) registration from putative correspondences —
port of ``mulls_tpu/backend/coarse_reg.py``.

* :func:`coarse_reg_ransac` — all M random 3-point hypotheses at once
  (closed-form Kabsch each), an M x K inlier matrix, argmax, then a
  weighted refinement on the best consensus set (the role of PCL's
  `CorrespondenceRejectorSampleConsensus`, `cregistration.hpp:605-661`).
* :func:`coarse_reg_gnc` — TEASER-style (`cregistration.hpp:664-759`):
  pairwise-consistency pruning by greedy clique growth, then GNC-TLS over
  translation-invariant measurements for the rotation and a median /
  Kabsch translation.
* :func:`coarse_reg_bev` — global (yaw, tx, ty) BEV raster correlation by
  FFT (``torch.fft``).

The random picks are the reference's ``jax.random.choice(..., p=prob)``:
``cumsum(p)``, then ``p_cuml[-1] * (1 - u)`` with ``u`` uniform, then a
left ``searchsorted`` — built on :class:`~mulls_tpu_torch.core.draws.Draws`
so that a test can replay the reference's key.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mulls_tpu_torch.core import se3
from mulls_tpu_torch.core.cloud import top_k_indices
from mulls_tpu_torch.core.draws import Draws

f32 = torch.float32


class CoarseRegResult(NamedTuple):
    transform: torch.Tensor  # [4,4] source -> target
    inlier_count: torch.Tensor
    valid: torch.Tensor  # bool: enough inliers (>= min_inlier_count)
    reliable: torch.Tensor  # bool: >= 2x min_inlier_count (reference gate)


def nanmedian(x: torch.Tensor, dim: int, keepdim: bool = False
              ) -> torch.Tensor:
    """``jnp.nanmedian``: the 0.5 quantile of the non-NaN entries with
    linear interpolation (the mean of the two middle values for an even
    count, weighted as JAX weighs them); NaN where no entry is valid.
    ``torch.nanmedian`` returns the lower middle value instead."""
    nan = torch.isnan(x)
    xs = torch.sort(torch.where(nan, float("inf"), x), dim=dim).values
    counts = torch.sum(~nan, dim=dim, keepdim=True).to(x.dtype)
    q = 0.5 * (counts - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    w_high = q - low
    w_low = 1.0 - w_high
    low = torch.clamp(torch.minimum(low, counts - 1.0), min=0.0).long()
    high = torch.clamp(torch.minimum(high, counts - 1.0), min=0.0).long()
    v = (torch.gather(xs, dim, low) * w_low
         + torch.gather(xs, dim, high) * w_high)
    v = torch.where(counts > 0, v, float("nan"))
    return v if keepdim else v.squeeze(dim)


def choice(draws: Draws, n: int, shape, p: torch.Tensor) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace=True, p=p)``."""
    p_cuml = torch.cumsum(p, 0)
    u = draws.uniform(shape).to(p.device)
    r = p_cuml[-1] * (1.0 - u)
    ind = torch.searchsorted(p_cuml, r.reshape(-1).contiguous())
    return ind.reshape(tuple(shape))


_U32 = 0xFFFFFFFF


def randint(draws: Draws, shape, lo: int, hi: int,
            device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, lo, hi)`` (int32): the key splits
    in two, each half draws 32 bits a value, and the two words combine by
    a multiplier of 2^32 mod span (``jax/_src/random.py::_randint``); the
    uint32 products wrap as there."""
    k1, k2 = draws.split(2)
    higher = k1.bits(shape).to(device)
    lower = k2.bits(shape).to(device)
    span = hi - lo if hi > lo else 1
    multiplier = (((2 ** 16 % span) ** 2) & _U32) % span
    offset = ((higher % span) * multiplier) & _U32
    offset = ((offset + lower % span) & _U32) % span
    return (lo + offset).to(torch.int64)


def _kabsch(src, tgt, w):
    """Weighted rigid alignment: (R, t) minimizing |R s + t - q|^2_w.
    src/tgt: [..., N, 3], w: [..., N]."""
    wsum = torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
    ws = w / wsum
    mu_s = torch.einsum("...n,...ni->...i", ws, src)
    mu_t = torch.einsum("...n,...ni->...i", ws, tgt)
    sc = src - mu_s[..., None, :]
    tc = tgt - mu_t[..., None, :]
    H = torch.einsum("...n,...ni,...nj->...ij", ws, sc, tc)
    u, _, vt = torch.linalg.svd(H)
    v = vt.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    d = torch.linalg.det(v @ ut)
    s = torch.ones(H.shape[:-2] + (3,), dtype=H.dtype, device=H.device)
    s[..., 2] = d
    R = v @ (s[..., :, None] * ut)
    t = mu_t - torch.einsum("...ij,...j->...i", R, mu_s)
    return R, t


def _pack(R, t):
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def clique_consistency_mask(src: torch.Tensor, tgt: torch.Tensor,
                            mask: torch.Tensor, eps: float,
                            grow_steps: int = 40, num_seeds: int = 0):
    """Prune putative correspondences by rigid pairwise consistency
    (TEASER++'s max-clique stage, `cregistration.hpp:699-727`): every
    correspondence seeds a clique, each of ``grow_steps`` steps adds the
    candidate with the most edges into the remaining candidate set (one
    ``[S,K] @ [K,K]`` 0/1 matmul, exact in fp32), the grown cliques are
    verified by a trimmed Kabsch fit, and the one with the most support
    over all matches wins.  Returns (members of the winning clique's
    support, its size)."""
    k = src.shape[0]
    dev = src.device
    ds = torch.linalg.norm(src[:, None, :] - src[None, :, :], dim=-1)
    dt = torch.linalg.norm(tgt[:, None, :] - tgt[None, :, :], dim=-1)
    compat = (torch.abs(ds - dt) < eps) & mask[:, None] & mask[None, :]
    # duplicate matches (same keypoint on either side) trivially satisfy
    # the consistency test — never let them certify each other
    compat = compat & (ds > 0.1) & (dt > 0.1)
    compat = compat & ~torch.eye(k, dtype=torch.bool, device=dev)
    A = compat.to(f32)

    s = num_seeds or k
    deg = torch.sum(A, dim=1)
    seeds = top_k_indices(deg, s)
    members = torch.nn.functional.one_hot(seeds, k).to(f32)  # [S,K]
    cand = compat[seeds] & mask[None, :]
    rows = torch.arange(s, device=dev)
    for _ in range(grow_steps):
        # +0.5 keeps zero-degree candidates pickable
        score = (cand.to(f32) @ A + 0.5) * cand
        best = torch.argmax(score, dim=1)
        picked = cand[rows, best]
        any_cand = torch.any(cand, dim=1) & picked
        add = torch.nn.functional.one_hot(best, k).to(f32) \
            * any_cand[:, None].to(f32)
        members = torch.clamp(members + add, max=1.0)
        cand = cand & (compat[best] | ~any_cand[:, None]) & (members < 0.5)

    # geometric verification of every grown clique: a few median-scaled
    # trims, then support over ALL matches
    src_b = src.expand(members.shape + (3,))
    tgt_b = tgt.expand(members.shape + (3,))

    def fit_d2(w):
        R, t = _kabsch(src_b, tgt_b, w)
        proj = torch.einsum("sij,kj->ski", R, src) + t[:, None, :]
        return torch.sum((proj - tgt[None]) ** 2, -1)

    w = members
    for _ in range(3):
        d2 = fit_d2(w)
        med = nanmedian(torch.where(members > 0.5, d2, float("nan")), 1,
                        keepdim=True)
        med = torch.nan_to_num(med, nan=1.0)
        w = members * (d2 <= 9.0 * med)
    d2 = fit_d2(w)
    support = (d2 <= eps * eps) & mask[None, :]
    counts = torch.sum(support, dim=1)
    best_seed = torch.argmax(counts)
    keep = support[best_seed] & mask
    return keep, torch.sum(keep)


def coarse_reg_ransac(src: torch.Tensor, tgt: torch.Tensor,
                      mask: torch.Tensor, draws: Draws, inlier_thre: float,
                      num_hypotheses: int = 512,
                      min_inlier_count: int = 8) -> CoarseRegResult:
    """src/tgt: [K, 3] putative correspondence pairs, mask: [K]."""
    k = src.shape[0]
    keep, _ = clique_consistency_mask(src, tgt, mask, eps=inlier_thre)
    mask = torch.where(torch.sum(keep) >= min_inlier_count, keep, mask)
    prob = mask.to(f32)
    prob = prob / torch.clamp(prob.sum(), min=1.0)
    picks = choice(draws, k, (num_hypotheses, 3), prob)
    distinct = ((picks[:, 0] != picks[:, 1]) & (picks[:, 0] != picks[:, 2])
                & (picks[:, 1] != picks[:, 2]))
    s3, t3 = src[picks], tgt[picks]  # [M, 3, 3]
    w3 = torch.ones((num_hypotheses, 3), dtype=f32, device=src.device)
    R, t = _kabsch(s3, t3, w3)
    proj = torch.einsum("mij,kj->mki", R, src) + t[:, None, :]
    d2 = torch.sum((proj - tgt[None]) ** 2, -1)
    inl = (d2 <= inlier_thre ** 2) & mask[None, :]
    counts = torch.where(distinct, torch.sum(inl, dim=1), -1)
    best = torch.argmax(counts)
    Rb, tb = _kabsch(src, tgt, inl[best].to(f32))
    proj = src @ Rb.T + tb
    inl_final = (torch.sum((proj - tgt) ** 2, -1) <= inlier_thre ** 2) & mask
    n_inl = torch.sum(inl_final)
    return CoarseRegResult(transform=_pack(Rb, tb), inlier_count=n_inl,
                           valid=n_inl >= min_inlier_count,
                           reliable=n_inl >= 2 * min_inlier_count)


def coarse_reg_gnc(src: torch.Tensor, tgt: torch.Tensor, mask: torch.Tensor,
                   draws: Draws, noise_bound: float, num_tims: int = 2048,
                   gnc_iters: int = 20,
                   min_inlier_count: int = 8) -> CoarseRegResult:
    """GNC-TLS robust registration (TEASER-style decoupling): rotation
    from TIMs a_ij = s_i - s_j vs b_ij = q_i - q_j under the GNC-TLS
    weight schedule, translation by component-wise median over the
    rotation inliers, then a Kabsch polish."""
    k = src.shape[0]
    k1, k2 = draws.split(2)
    keep, _ = clique_consistency_mask(src, tgt, mask, eps=noise_bound)
    sel = torch.sum(keep) >= min_inlier_count
    mask_gnc = torch.where(sel, keep, mask)
    prob = mask_gnc.to(f32)
    prob = prob / torch.clamp(prob.sum(), min=1.0)
    i_idx = choice(k1, k, (num_tims,), prob)
    j_idx = choice(k2, k, (num_tims,), prob)
    ok = mask_gnc[i_idx] & mask_gnc[j_idx] & (i_idx != j_idx)
    a = src[i_idx] - src[j_idx]
    b = tgt[i_idx] - tgt[j_idx]
    # TIM noise bound is 2x the measurement bound
    nb2 = (2.0 * noise_bound) ** 2

    def residual2(R):
        e = torch.einsum("ij,nj->ni", R, a) - b
        return torch.sum(e * e, -1)

    w0 = ok.to(f32)
    R, _ = _kabsch(a, b, w0)
    r2max = torch.amax(torch.where(ok, residual2(R), 0.0))
    mu = torch.clamp(1.0 / (2.0 * r2max / nb2 - 1.0), min=1e-6)
    for _ in range(gnc_iters):
        r2 = residual2(R)
        # GNC-TLS weights (Yang et al. 2020, eq. 14)
        lo = mu / (mu + 1.0) * nb2
        hi = (mu + 1.0) / mu * nb2
        w = torch.where(r2 <= lo, 1.0,
                        torch.where(r2 >= hi, 0.0,
                                    torch.sqrt(nb2 * mu * (mu + 1.0)
                                               / torch.clamp(r2, min=1e-12))
                                    - mu))
        w = torch.clamp(w, 0.0, 1.0) * ok
        R, _ = _kabsch(a, b, w)
        mu = mu * 1.4

    diff = tgt - src @ R.T
    t_est = nanmedian(torch.where(mask_gnc[:, None], diff, float("nan")), 0)
    t_est = torch.nan_to_num(t_est, nan=0.0)
    d2 = torch.sum((src @ R.T + t_est - tgt) ** 2, -1)
    inl = (d2 <= (2.0 * noise_bound) ** 2) & mask
    Rb, tb = _kabsch(src, tgt, inl.to(f32))
    d2b = torch.sum((src @ Rb.T + tb - tgt) ** 2, -1)
    inl_b = (d2b <= (2.0 * noise_bound) ** 2) & mask
    n_inl = torch.sum(inl_b)
    return CoarseRegResult(transform=_pack(Rb, tb), inlier_count=n_inl,
                           valid=n_inl >= min_inlier_count,
                           reliable=n_inl >= 2 * min_inlier_count)


def double_check_tran(T_coarse: torch.Tensor, T_predict: torch.Tensor,
                      tran_thre, rot_thre_deg) -> torch.Tensor:
    """TEASER-vs-odometry consistency gate (`build_pose_graph.cpp:211-235`);
    the thresholds are floats or 0-d float32 tensors."""
    dT = se3.inverse(T_predict) @ T_coarse
    dt = torch.linalg.norm(dT[:3, 3])
    da = se3.rotation_angle(dT[:3, :3])
    rot = torch.as_tensor(rot_thre_deg, dtype=f32, device=dT.device)
    return (dt <= tran_thre) & (da <= torch.deg2rad(rot))


def _raster(xyz, mask, grid: int, res: float):
    """Occupancy counts of a [..., N, 3] cloud's xy on a grid x grid raster
    centred at the origin, capped at 3."""
    half = grid // 2
    ij = torch.floor(xyz[..., :2] / res).to(torch.int64) + half
    ok = mask & torch.all((ij >= 0) & (ij < grid), dim=-1)
    ij = torch.clamp(ij, 0, grid - 1)
    lead = xyz.shape[:-2]
    b = int(math.prod(lead))
    flat = (ij[..., 0] * grid + ij[..., 1]).reshape(b, -1)
    flat = flat + torch.arange(b, device=xyz.device)[:, None] * grid * grid
    img = torch.zeros(b * grid * grid, dtype=f32, device=xyz.device)
    # float atomics add these in any order, but they add ones: counts are
    # exact in fp32 up to 2^24, so every order gives the same bits
    img.index_add_(0, flat.reshape(-1), ok.reshape(-1).to(f32))
    return torch.clamp(img.reshape(lead + (grid, grid)), max=3.0)


def coarse_reg_bev(src: torch.Tensor, src_mask: torch.Tensor,
                   tgt: torch.Tensor, tgt_mask: torch.Tensor,
                   grid: int = 256, res: float = 0.5, yaw_steps: int = 120,
                   chunk: int = 24, min_peak_ratio: float = 0.25
                   ) -> CoarseRegResult:
    """Global 3-DoF (yaw, tx, ty) registration by BEV raster correlation:
    both clouds are rasterized to occupancy grids and every yaw hypothesis
    is scored by a zero-padded (linear) 2D cross-correlation over all
    translations at once by FFT.  ``inlier_count`` is the number of
    overlapping occupied cells at the peak; validity gates the peak
    against the geometric mean of both self-correlations."""
    dev = src.device
    tgt_img = _raster(tgt, tgt_mask, grid, res)
    pad = 2 * grid
    tgt_f = torch.fft.rfft2(tgt_img, s=(pad, pad))

    # pad the yaw sweep to a multiple of the chunk (repeated final
    # hypotheses score the same; argmax picks the first)
    n_pad = -yaw_steps % chunk
    yaws = torch.arange(yaw_steps + n_pad, dtype=f32, device=dev) \
        * (2.0 * math.pi / yaw_steps)
    yaws = torch.clamp(yaws, max=2.0 * math.pi * (yaw_steps - 1) / yaw_steps)
    best_parts, arg_parts = [], []
    x, y = src[:, 0], src[:, 1]
    for yc in yaws.reshape(-1, chunk):
        c, s = torch.cos(yc), torch.sin(yc)
        xr = c[:, None] * x[None] - s[:, None] * y[None]
        yr = s[:, None] * x[None] + c[:, None] * y[None]
        pts = torch.stack([xr, yr, torch.zeros_like(xr)], -1)
        imgs = _raster(pts, src_mask[None].expand(xr.shape), grid, res)
        src_f = torch.fft.rfft2(imgs, s=(pad, pad))
        corr = torch.fft.irfft2(torch.conj(src_f) * tgt_f[None],
                                s=(pad, pad)).reshape(chunk, -1)
        best_parts.append(torch.amax(corr, dim=1))
        arg_parts.append(torch.argmax(corr, dim=1))  # the first maximum
    best = torch.cat(best_parts)
    arg = torch.cat(arg_parts)
    k = torch.argmax(best)
    yaw = yaws[k]
    di = arg[k] // pad
    dj = arg[k] % pad
    # FFT correlation index -> shift (wrap negative shifts)
    di = torch.where(di > pad // 2, di - pad, di)
    dj = torch.where(dj > pad // 2, dj - pad, dj)
    t_xy = torch.stack([di, dj]).to(f32) * res
    c, s = torch.cos(yaw), torch.sin(yaw)
    R = torch.eye(3, dtype=f32, device=dev)
    R[0, 0], R[0, 1], R[1, 0], R[1, 1] = c, -s, s, c
    # z offset: medians of the height distributions
    src_z = nanmedian(torch.where(src_mask, src[:, 2], float("nan")), 0)
    tgt_z = nanmedian(torch.where(tgt_mask, tgt[:, 2], float("nan")), 0)
    t = torch.stack([t_xy[0], t_xy[1],
                     torch.nan_to_num(tgt_z - src_z, nan=0.0)])
    self_t = torch.sum(tgt_img * tgt_img)
    self_s = torch.sum(_raster(src, src_mask, grid, res) ** 2)
    norm = torch.sqrt(torch.clamp(self_t * self_s, min=1e-12))
    peak = best[k]
    n_cells = peak / 9.0  # upper bound estimate of overlapping full cells
    return CoarseRegResult(
        transform=_pack(R, t), inlier_count=n_cells.to(torch.int32),
        valid=peak > min_peak_ratio * norm,
        reliable=peak > 2.0 * min_peak_ratio * norm)


def bev_feature_stack(clouds: dict, names=("facade", "pillar", "beam",
                                           "vertex")):
    """(xyz, mask) of the BEV-relevant feature classes of a cloud dict,
    for :func:`coarse_reg_bev` (the class choice of the reference)."""
    xyz = torch.cat([clouds[n].xyz for n in names])
    mask = torch.cat([clouds[n].mask for n in names])
    return xyz, mask
