"""Downsampling masks (fixed shapes, masked) — port of
``mulls_tpu/ops/voxel.py``.

* :func:`voxel_downsample_mask` — hash-grid voxel downsample, parity with
  `cfilter.hpp:83-165` (keep one point per voxel), as a scatter-min race
  on a bounded voxel table.
* :func:`dist_filter_mask` — ring distance filter (`cfilter.hpp:755-930`).
* :func:`xy_normal_balanced_mask` — azimuth-sector-balanced budget used for
  facade/beam (`cfilter.hpp:551-605`).
* :func:`random_downsample` — a random fixed budget (the baselines' frame
  downsample).

Every function takes leading batch dimensions (``[S, N, 3]``): each batch
entry gets the mask of its call alone.
"""

from __future__ import annotations

import math

import torch

from mulls_tpu_torch.core.batch import offsets
from mulls_tpu_torch.core.draws import Draws

_MASK32 = 0xFFFFFFFF


def hash_ijk(ijk: torch.Tensor, table_size: int) -> torch.Tensor:
    """3D integer-cell hash (Teschner et al. primes), masked to a
    power-of-two table.  Products wrap like the reference's int32 (the low
    bits are formed in int64, which keeps them exact)."""
    ijk = ijk.to(torch.int64)
    h = (ijk[..., 0] * 73856093) ^ (ijk[..., 1] * 19349663) \
        ^ (ijk[..., 2] * 83492791)
    return (h & (table_size - 1)).to(torch.int64)


def dist_filter_mask(xyz: torch.Tensor, mask: torch.Tensor, min_dist: float,
                     max_dist: float, use_z: bool = True) -> torch.Tensor:
    """Keep points with min_dist <= range <= max_dist (xy-plane range when
    ``use_z`` is False). Parity: `cfilter.hpp:755-800`."""
    sq = (torch.sum(xyz ** 2, dim=-1) if use_z
          else torch.sum(xyz[..., :2] ** 2, dim=-1))
    return mask & (sq >= min_dist ** 2) & (sq <= max_dist ** 2)


def scanner_filter_mask(xyz: torch.Tensor, mask: torch.Tensor,
                        self_radius: float,
                        underground_z: float) -> torch.Tensor:
    """Drop scanner self-returns and underground ghosts
    (parity: `cfilter.hpp:914-930`)."""
    sq = torch.sum(xyz ** 2, dim=-1)
    return mask & (sq > self_radius ** 2) & (xyz[..., 2] > underground_z)


def intensity_filter_mask(intensity: torch.Tensor, mask: torch.Tensor,
                          min_i: float = 0.0, max_i: float = 1.0,
                          intensity_scale: float = 255.0) -> torch.Tensor:
    """Keep points with intensity inside (min_i, max_i) x scale
    (`cfilter.hpp:755-775`, documented intent of ``intensity_filter``)."""
    return (mask & (intensity > min_i * intensity_scale)
            & (intensity < max_i * intensity_scale))


def incidence_angle_filter_mask(xyz: torch.Tensor, normal: torch.Tensor,
                                mask: torch.Tensor, min_rad: float = 0.0,
                                max_rad: float = 1.5707963) -> torch.Tensor:
    """Keep points whose beam-to-surface incidence angle lies in
    (min_rad, max_rad).  Parity: `cfilter.hpp:778-805`."""
    rng = torch.linalg.norm(xyz, dim=-1)
    dot = torch.abs(torch.sum(xyz * normal, dim=-1))
    ang = torch.arccos(torch.clamp(dot / torch.clamp(rng, min=1e-9),
                                   -1.0, 1.0))
    return mask & (ang > min_rad) & (ang < max_rad)


def voxel_downsample_mask(xyz: torch.Tensor, mask: torch.Tensor,
                          resolution: float,
                          table_size: int = 1 << 20) -> torch.Tensor:
    """Keep (at most) one valid point per voxel: each point scatters its
    own index into its hashed slot with a min reduction and survives if it
    won the slot.  Hash collisions merge distinct voxels (<7% at 131k
    points in a 1M-slot table)."""
    n = xyz.shape[-2]
    lead = tuple(xyz.shape[:-2])
    ijk = torch.floor(xyz / resolution).to(torch.int32)
    h = hash_ijk(ijk, table_size)
    if lead:  # each batch entry its own table
        h = h + offsets(lead, table_size, xyz.device)
    idx = torch.arange(n, dtype=torch.int64, device=xyz.device)
    slot_val = torch.where(mask, idx, n)
    table = torch.full((math.prod(lead) * table_size,), n,
                       dtype=torch.int64, device=xyz.device)
    table.scatter_reduce_(0, h.reshape(-1), slot_val.reshape(-1), "amin",
                          include_self=True)
    return mask & (table[h] == idx)


def random_downsample(mask: torch.Tensor, keep_num: int, draws: Draws
                      ) -> torch.Tensor:
    """Random mask with at most ``keep_num`` surviving valid points
    (parity: `random_downsample_pcl`; the reference draws at
    `ops/voxel.py:109`).  The k-th largest score decides what survives, so
    the tie order of ``topk`` changes nothing."""
    n = mask.shape[-1]
    score = torch.where(mask, draws.uniform(mask.shape).to(mask.device),
                        -1.0)
    kth = torch.topk(score, min(keep_num, n), dim=-1).values[..., -1:]
    return mask & (score >= torch.clamp(kth, min=0.0))


def xy_normal_balanced_mask(normal: torch.Tensor, mask: torch.Tensor,
                            keep_per_sector: int, sector_num: int,
                            u: torch.Tensor) -> torch.Tensor:
    """Keep ~keep_per_sector random points per azimuth sector of the
    direction vector (parity: `xy_normal_balanced_downsample`,
    `cfilter.hpp:551-605`).  ``u`` is the uniform draw of ``mask``'s shape
    (the reference draws it here, `ops/voxel.py:135`).  Directions are
    sign-canonicalized so v and -v share a sector."""
    v = torch.where(normal[..., 1:2] < 0, -normal, normal)  # ny >= 0
    az = torch.atan2(v[..., 1], v[..., 0])  # [0, pi)
    sector = torch.clamp((az / (math.pi / sector_num)).to(torch.int32),
                         0, sector_num - 1)
    k = min(keep_per_sector, mask.shape[-1])
    keep = torch.zeros_like(mask)
    for s in range(sector_num):
        m_s = mask & (sector == s)
        score = torch.where(m_s, u, -1.0)
        kth = torch.topk(score, k, dim=-1).values[..., -1:]
        keep = keep | (m_s & (score >= torch.clamp(kth, min=0.0)))
    return keep
