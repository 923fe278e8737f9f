"""Dual-threshold grid ground filter — port of ``mulls_tpu/ops/ground.py``
(reference `cfilter.hpp:1658-2036`), as segment reductions over a static
2D grid.

Reference semantics preserved:
  * approximate mean height -> non-ground pre-gate (z > mean + gf_max_h)
  * per-cell min-z, 3x3 neighbor min-z + reliable-neighbor count over
    interior cells only
  * ground grid test: min_z - neighbor_min_z < gf_neigh_grid_h_thre
  * point-level: ground iff z - cell_min_z < gf_in_grid_h_thre, else
    unground with height-above-ground in `height`
  * distance-weighted stochastic downsampling (linear / quadratic inverse)
  * high-intensity keep exception
  * ground normals: (0,0,1) | per-cell RANSAC plane (method 3)

The reference's ``segment_max`` / ``segment_sum`` become
``scatter_reduce("amax")`` (exact in any order) / the order-fixed
:func:`mulls_tpu_torch.ops.segment.segment_sum`, so a frame gives the same
bits on every run; an empty segment keeps JAX's identity (the int32
minimum for a max).  The packed-int32 pick keys of the
reference (RANSAC member picks, min-z and min-range in ONE segment max)
are kept as they are.  The filter takes leading batch dimensions; its
one float sum over the scan (the mean height) is the order-fixed
:func:`mulls_tpu_torch.core.batch.fsum`, so a batch entry gets the bits of
its call alone.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mulls_tpu_torch.config import GroundFilterConfig, ShapeConfig
from mulls_tpu_torch.core.batch import fsum, offsets, take
from mulls_tpu_torch.core.draws import Draws
from mulls_tpu_torch.ops.pca import eigh_sym3x3
from mulls_tpu_torch.ops.segment import segment_sum

_BIG = 1.0e30
_INT32_MIN = -(1 << 31)
_MASK32 = 0xFFFFFFFF


class GroundResult(NamedTuple):
    is_ground: torch.Tensor  # [N] bool (post down-sampling keep mask)
    is_unground: torch.Tensor  # [N] bool (post down-sampling keep mask)
    height: torch.Tensor  # [N] f32 height above ground (`data[3]` parity)
    normal: torch.Tensor  # [N, 3] f32 ground normal per ground point
    cell_id: torch.Tensor  # [N] int64


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """``(h * m) mod 2^32`` for uint32 values held in int64, without ever
    leaving int64's range (uint32 multiply-wrap parity)."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _min_pool3(grid: torch.Tensor) -> torch.Tensor:
    """3x3 min over a [..., G, G] grid, interior cells only.  Border cells
    keep their own value (`cfilter.hpp:1785,1798-1810`)."""
    g = torch.nn.functional.pad(grid, (1, 1, 1, 1), value=_BIG)
    m = grid
    h, w = grid.shape[-2:]
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            m = torch.minimum(m, g[..., 1 + di:h + 1 + di, 1 + dj:w + 1 + dj])
    interior = torch.zeros((h, w), dtype=torch.bool, device=grid.device)
    interior[1:-1, 1:-1] = True
    return torch.where(interior, m, grid)


def _sum_pool3(grid: torch.Tensor) -> torch.Tensor:
    g = torch.nn.functional.pad(grid, (1, 1, 1, 1))
    s = torch.zeros_like(grid)
    h, w = grid.shape[-2:]
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            s = s + g[..., 1 + di:h + 1 + di, 1 + dj:w + 1 + dj]
    return s


def _segment_max(data: torch.Tensor, seg: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """[..., n, C] int32 rows reduced by max into ``num_segments`` rows per
    batch entry; an empty segment holds the int32 minimum
    (``jax.ops.segment_max``)."""
    lead = tuple(seg.shape[:-1])
    if lead:
        seg = seg + offsets(lead, num_segments, seg.device)
    n_c = data.shape[-1]
    out = torch.full((math.prod(lead) * num_segments, n_c), _INT32_MIN,
                     dtype=data.dtype, device=data.device)
    index = seg.reshape(-1, 1).expand(-1, n_c)
    out.scatter_reduce_(0, index, data.reshape(-1, n_c), "amax",
                        include_self=False)
    return out.reshape(*lead, num_segments, n_c)


def fast_ground_filter(xyz: torch.Tensor, intensity: torch.Tensor,
                       mask: torch.Tensor, cfg: GroundFilterConfig,
                       shapes: ShapeConfig, draws: Draws,
                       fixed_num_downsampling: bool = True,
                       nonground_rate=None) -> GroundResult:
    """The ground / unground split of a scan ``xyz`` [..., n, 3] (leading
    dimensions are batch entries, each filtered on its own)."""
    n = xyz.shape[-2]
    lead = tuple(xyz.shape[:-2])
    dev = xyz.device
    g = shapes.grid_dim
    num_cells = g * g
    res = cfg.gf_grid_size

    z = xyz[..., 2]
    mean_z = (fsum(torch.where(mask, z, 0.0), -1)
              / torch.clamp(torch.sum(mask, -1), min=1))[..., None]
    non_ground_z = mean_z + cfg.gf_max_h

    # static grid anchored at the min corner
    bb_min = torch.amin(torch.where(mask[..., None], xyz[..., :2], _BIG),
                        dim=-2)
    col = torch.floor((xyz[..., 0] - bb_min[..., 0:1]) / res).to(torch.int64)
    row = torch.floor((xyz[..., 1] - bb_min[..., 1:2]) / res).to(torch.int64)
    in_grid = mask & (col >= 0) & (col < g) & (row >= 0) & (row < g)
    cell = torch.where(in_grid, row * g + col, num_cells)

    # points participating in the ground grid stats: below the pre-gate
    below = in_grid & (z <= non_ground_z)
    cell_stat = torch.where(below, cell, num_cells)
    rng_all = torch.linalg.norm(xyz, dim=-1)

    # --- stage 1: ONE fused int32 segment max (reference `ground.py:106-170`)
    #   cols 0..23  floor-biased RANSAC member picks: key (pick << 17) | idx
    #   col  24     quantized -z      -> per-cell min_z
    #   col  25     quantized -range  -> per-cell min range
    kg, ku1, ku2 = draws.split(3)
    n_hyp = 8  # vectorized equivalent of the reference's 20 seq. iters
    n_pick = 3 * n_hyp
    if n_pick % 2 != 0:
        raise ValueError("pick hashes come two 16-bit halves per 32-bit "
                         "word: n_pick must be even")
    if n > (1 << 17):
        raise ValueError("packed picks assume point index < 2^17")
    # murmur3-style finalizer over (point, pick) — two 16-bit uniforms per
    # 32-bit hash; uint32 arithmetic kept exact in int64
    salt = ku2.bits((*lead, 1, n_pick // 2))
    h = (_mul32(torch.arange(n, dtype=torch.int64, device=dev)[:, None],
                2654435761) + salt) & _MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    u01 = torch.cat([(h & 0xFFFF).to(torch.float32),
                     (h >> 16).to(torch.float32)],
                    dim=-1) * (1.0 / (1 << 16))  # [..., n, n_pick]
    z_hi = torch.amax(torch.where(below, z, -_BIG), -1, keepdim=True)
    z_lo = torch.amin(torch.where(below, z, _BIG), -1, keepdim=True)
    pick_band = cfg.gf_in_grid_h_thre
    span = pick_band + torch.clamp(z_hi - z_lo, min=1e-3)
    qscale = 16382.0 / span
    pick_v = torch.clamp((pick_band * u01 + (z_hi - z)[..., None])
                         * qscale[..., None], 0.0, 16383.0).to(torch.int32)
    idx_col = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    pick_key = (pick_v << 17) | idx_col  # [..., n, 24]
    qz = torch.clamp((z_hi - z) * 8192.0, 0.0, 2.0e9).to(torch.int32)
    r_hi = torch.amax(torch.where(below, rng_all, 0.0), -1,
                      keepdim=True) + 1.0
    qr = torch.clamp((r_hi - rng_all) * 8192.0, 0.0, 2.0e9).to(torch.int32)
    fused = torch.cat([pick_key, qz[..., None], qr[..., None]], dim=-1)
    fused = torch.where(below[..., None], fused, -1)
    cmax = _segment_max(fused, cell_stat, num_cells + 1)[..., :num_cells, :]
    seg_min_z = torch.where(cmax[..., 24] >= 0,
                            z_hi - cmax[..., 24].to(torch.float32) / 8192.0,
                            _BIG)
    cell_dist = torch.where(cmax[..., 25] >= 0,
                            r_hi - cmax[..., 25].to(torch.float32) / 8192.0,
                            0.0)

    # occupancy count of the below points per cell (exact in f32: < 2^24)
    seg_cnt = segment_sum(below.to(torch.float32), cell_stat,
                          num_cells + 1)[..., :num_cells]

    min_z = seg_min_z.reshape(*lead, g, g)
    neigh_min_z = _min_pool3(min_z)
    occupied = (seg_cnt >= cfg.gf_grid_min_pt_num).reshape(*lead, g, g)
    reliable = _sum_pool3(occupied.to(torch.int32))
    interior = torch.zeros((g, g), dtype=torch.bool, device=dev)
    interior[1:-1, 1:-1] = True
    reliable = torch.where(interior, reliable, 0)

    cell_ok = occupied & (reliable >= cfg.gf_reliable_neighbor_grid_thre)
    cell_is_ground = cell_ok & ((min_z - neigh_min_z)
                                < cfg.gf_neigh_grid_h_thre)

    # one packed per-cell table -> ONE [..., n, 5] gather
    cell_tab = torch.stack([
        cell_ok.reshape(*lead, -1).to(torch.float32),
        cell_is_ground.reshape(*lead, -1).to(torch.float32),
        min_z.reshape(*lead, -1), neigh_min_z.reshape(*lead, -1), cell_dist],
        dim=-1)  # [..., C, 5]
    cell_of = torch.clamp(cell, 0, num_cells - 1)
    pc = take(cell_tab, cell_of)
    p_cell_ok = in_grid & (pc[..., 0] > 0.5)
    p_cell_ground = in_grid & (pc[..., 1] > 0.5)
    p_min_z = pc[..., 2]
    p_neigh_min_z = pc[..., 3]
    p_cell_dist = pc[..., 4]

    # pre-gate unground (`cfilter.hpp:1740-1754`); points outside the
    # static grid window also go unground
    pre_unground = mask & ((z > non_ground_z) | ~in_grid)
    band = (below & p_cell_ok & p_cell_ground
            & ((z - p_min_z) < cfg.gf_in_grid_h_thre))
    in_cell_unground = below & p_cell_ok & p_cell_ground & ~band
    nonground_cell = below & p_cell_ok & ~p_cell_ground

    # heights above ground (`data[3]`): pre-gate points use mean-3 baseline
    height = torch.where(
        pre_unground, z - (mean_z - 3.0),
        torch.where(in_cell_unground, z - p_min_z,
                    torch.where(nonground_cell, z - p_neigh_min_z, 0.0)))

    # distance-weighted stochastic downsampling rates
    def rate_from_dist(dist, base_rate):
        w = cfg.standard_distance / (dist + 1e-4)
        if cfg.dist_inverse_sampling_method == 1:
            return w * base_rate + 1.0
        if cfg.dist_inverse_sampling_method == 2:
            return w * w * base_rate + 1.0
        return torch.zeros_like(dist) + base_rate

    high_intensity = intensity > cfg.intensity_thre_nonground

    # the non-ground rate may be a tensor (self-adaptive update,
    # `cfilter.hpp:2416-2444`; one per batch entry) instead of the static
    # config value
    ug_base = (float(cfg.gf_nonground_down_rate)
               if nonground_rate is None else nonground_rate[..., None])
    ug_rate = rate_from_dist(torch.where(pre_unground, rng_all, p_cell_dist),
                             ug_base)
    u = ku1.uniform((*lead, n))
    ug_keep = (u * torch.clamp(ug_rate, min=1.0) < 1.0) | high_intensity
    is_unground = (pre_unground | in_cell_unground | nonground_cell) & ug_keep

    if fixed_num_downsampling:
        # keep the full in-band ground set; the fixed-num budget picks later
        g_keep = torch.ones((*lead, n), dtype=torch.bool, device=dev)
    else:
        g_rate = rate_from_dist(p_cell_dist, float(cfg.gf_ground_down_rate))
        g_keep = kg.uniform((*lead, n)) * torch.clamp(g_rate, min=1.0) < 1.0
    is_ground = band & g_keep

    up = torch.zeros((*lead, n, 3), dtype=torch.float32, device=dev)
    up[..., 2] = 1.0
    # --- ground normals -----------------------------------------------------
    if cfg.ground_normal_method == 3:
        # per-cell RANSAC plane (`cfilter.hpp:1909,2038-2054`), all cells and
        # all hypotheses at once; hypothesis scoring and the LS refit ride
        # ONE wide segment sum
        gm = band
        gcell = torch.where(gm, cell, num_cells)
        ransac_thre = 0.3 * cfg.gf_in_grid_h_thre

        pick_cols = cmax[..., :n_pick]
        pick_ok = pick_cols >= 0  # [..., C, n_pick] cell had a below point
        pick_idx = torch.where(pick_ok, pick_cols & ((1 << 17) - 1), 0)
        pts = take(xyz, pick_idx.reshape(*lead, -1)).reshape(
            *lead, num_cells, n_pick, 3)
        p1 = pts[..., 0 * n_hyp:1 * n_hyp, :]  # [..., C, n_hyp, 3]
        p2 = pts[..., 1 * n_hyp:2 * n_hyp, :]
        p3 = pts[..., 2 * n_hyp:3 * n_hyp, :]
        cross = torch.linalg.cross(p2 - p1, p3 - p1, dim=-1)
        cn = torch.linalg.norm(cross, dim=-1, keepdim=True)
        nrm_h = cross / torch.clamp(cn, min=1e-9)  # [..., C, n_hyp, 3]
        # degeneracy gate: duplicate/collinear samples
        ok_h = (cn[..., 0] > 1e-6) & pick_ok[..., :n_hyp]  # [..., C, n_hyp]
        coeffs = torch.cat(
            [nrm_h, -torch.sum(nrm_h * p1, -1, keepdim=True)], dim=-1)
        dead = torch.zeros_like(coeffs)
        dead[..., 3] = _BIG
        coeffs = torch.where(ok_h[..., None], coeffs, dead)
        pcoef = take(coeffs.reshape(*lead, num_cells, 4 * n_hyp), cell_of)
        pcoef = pcoef.reshape(*lead, n, n_hyp, 4)
        d = torch.abs(torch.sum(pcoef[..., :3] * xyz[..., None, :], -1)
                      + pcoef[..., 3])
        inl = gm[..., None] & (d <= ransac_thre)
        x, y, zz = xyz[..., 0], xyz[..., 1], xyz[..., 2]
        feats = torch.stack([torch.ones_like(x), x, y, zz, x * x, x * y,
                             x * zz, y * y, y * zz, zz * zz], -1)
        sel = torch.cat([inl, gm[..., None]], dim=-1).to(torch.float32)
        blocks = sel[..., :, None] * feats[..., None, :]  # [.., n, 9, 10]
        msum = segment_sum(blocks.reshape(*lead, n, (n_hyp + 1) * 10), gcell,
                           num_cells + 1)[..., :num_cells, :]
        msum = msum.reshape(*lead, num_cells, n_hyp + 1, 10)
        cnt_h = torch.where(ok_h, msum[..., :n_hyp, 0], -1.0)
        best_h = torch.argmax(cnt_h, dim=-1)  # [..., C], first maximum
        best_cnt = torch.gather(cnt_h, -1, best_h[..., None])[..., 0]
        use_fallback = best_cnt <= 0.0

        # LS refit on the per-cell consensus moments (optimizeCoefficients)
        best_sums = torch.gather(
            msum, -2, best_h[..., None, None].expand(
                *best_h.shape, 1, 10))[..., 0, :]
        sums = torch.where(use_fallback[..., None], msum[..., n_hyp, :],
                           best_sums)
        cnt = torch.clamp(sums[..., 0], min=1.0)
        meanp = sums[..., 1:4] / cnt[..., None]
        exx = sums[..., 4:10] / cnt[..., None]
        mx, my, mz = meanp[..., 0], meanp[..., 1], meanp[..., 2]
        cov = torch.stack([
            exx[..., 0] - mx * mx, exx[..., 1] - mx * my,
            exx[..., 2] - mx * mz, exx[..., 1] - mx * my,
            exx[..., 3] - my * my, exx[..., 4] - my * mz,
            exx[..., 2] - mx * mz, exx[..., 4] - my * mz,
            exx[..., 5] - mz * mz,
        ], -1).reshape(*lead, num_cells, 3, 3)
        _, vecs = eigh_sym3x3(cov)
        nrm = vecs[..., 2]  # smallest eigvec = plane normal
        nrm = nrm * torch.where(nrm[..., 2:3] < 0, -1.0, 1.0)
        cell_nz_ok = ((torch.abs(nrm[..., 2]) > 0.8)
                      & (sums[..., 0] >= cfg.gf_grid_min_pt_num))
        p_nrm = take(nrm, cell_of)
        p_nz_ok = take(cell_nz_ok, cell_of)
        normal = torch.where(p_nz_ok[..., None], p_nrm, up)
        # final symmetric inlier gate against the REFIT plane (reference
        # `ground.py:340-361`)
        refit_c = torch.cat(
            [nrm, -torch.sum(nrm * meanp, -1, keepdim=True)], dim=-1)
        prc = take(refit_c, cell_of)
        d_refit = torch.abs(torch.sum(prc[..., :3] * xyz, -1) + prc[..., 3])
        sym_inl = gm & (d_refit <= ransac_thre)
        sym_inl = torch.where(take(use_fallback, cell_of), gm, sym_inl)
        is_ground = is_ground & p_nz_ok & sym_inl
    else:
        # method 0 here; methods 1/2 are applied by the caller via ops.pca
        normal = up

    return GroundResult(is_ground=is_ground, is_unground=is_unground,
                        height=height, normal=normal, cell_id=cell)
