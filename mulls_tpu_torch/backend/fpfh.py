"""FPFH descriptors + SAC-IA coarse registration — port of
``mulls_tpu/backend/fpfh.py`` (the reference's alternative
coarse-registration path, `cregistration.hpp:351-408`:
``compute_fpfh_feature`` wrapping PCL's ``FPFHEstimationOMP`` and
``coarse_reg_fpfhsac`` wrapping ``SampleConsensusInitialAlignment``).

* :func:`compute_fpfh` — one dense [N, N] pass in plain torch (the
  coarse step runs on downsampled clouds of about two thousand points):
  the Darboux-frame angle features of every pair, 11-bin histograms
  accumulated bin by bin, and the FPFH neighbour weighting as one
  [N, N] @ [N, 33] matmul.
* :func:`match_fpfh` / :func:`coarse_reg_fpfhsac` — descriptor distances
  in the reference's expanded form; the ``randomness`` nearest target
  descriptors by a stable ascending sort, so that ties go to the lower
  index as in ``jax.lax.top_k`` (plane-interior descriptors are often
  equal to the bit).
* :func:`_sac_ia` — every hypothesis at once; its scoring (512 hypotheses
  x 256 points) and its polish are 1-NN searches, each one launch of the
  ``nn`` CUDA kernel on the card.

The draws replay the reference's key tree through
:class:`~mulls_tpu_torch.core.draws.Draws`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from mulls_tpu_torch.backend.coarse_reg import (CoarseRegResult, _kabsch,
                                                _pack, choice, randint)
from mulls_tpu_torch.core.draws import Draws
from mulls_tpu_torch.ops import kernels

N_BINS = 11  # PCL FPFHSignature33: 11 bins x 3 angular features
f32 = torch.float32


def _soft_histogram(bins: torch.Tensor, weights: torch.Tensor
                    ) -> torch.Tensor:
    """bins [N, N] int in [0, N_BINS), weights [N, N] -> [N, N_BINS]
    per-row weighted counts, bin by bin (no [N, N, 11] one-hot)."""
    return torch.stack([torch.sum(torch.where(bins == b, weights, 0.0), 1)
                        for b in range(N_BINS)], -1)


def _bin(f: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> bin index, truncated toward zero as ``astype(int32)``."""
    return torch.clamp(((f + 1.0) * 0.5 * N_BINS).to(torch.int32), 0,
                       N_BINS - 1)


def compute_fpfh(xyz: torch.Tensor, normals: torch.Tensor,
                 mask: torch.Tensor, radius: float) -> torch.Tensor:
    """[N,3] points + unit normals + validity mask -> [N, 33] FPFH.

    PCL's estimator semantics (`cregistration.hpp:360-369`; the caller
    passes 2x its search radius): SPFH Darboux-frame angle histograms
    (f1 = v.n_q, f2 = u.d/|d|, f3 = atan2(w.n_q, u.n_q)), then the
    distance-weighted neighbour average, each 11-bin block normalized to
    percentages.  Masked rows are zero."""
    n = xyz.shape[0]
    d = xyz[None, :, :] - xyz[:, None, :]  # p -> q
    dist = torch.linalg.norm(d, dim=-1)
    nbr = (dist <= radius) & (dist > 1e-9) & mask[None, :] & mask[:, None]

    dn = d / torch.clamp(dist, min=1e-9)[..., None]
    # Darboux frame at the source point of each pair
    u = normals[:, None, :].expand(d.shape)  # n_p
    nq = normals[None, :, :].expand(d.shape)  # n_q
    v = torch.linalg.cross(dn, u)
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-9)
    w = torch.linalg.cross(u, v)
    f1 = torch.sum(v * nq, -1)  # alpha in [-1, 1]
    f2 = torch.sum(u * dn, -1)  # phi   in [-1, 1]
    f3 = torch.atan2(torch.sum(w * nq, -1), torch.sum(u * nq, -1))

    wgt = nbr.to(f32)
    spfh = torch.cat([_soft_histogram(_bin(f1), wgt),
                      _soft_histogram(_bin(f2), wgt),
                      _soft_histogram(_bin(f3 / math.pi), wgt)], -1)
    # normalize each point's SPFH blocks by its neighbour count
    k = torch.clamp(torch.sum(wgt, -1, keepdim=True), min=1.0)
    spfh = spfh / k

    # FPFH(p) = SPFH(p) + 1/k sum_q (1/omega_q) SPFH(q), omega = pair dist
    inv_w = wgt / torch.clamp(dist, min=1e-3)
    fpfh = spfh + (inv_w @ spfh) / k
    # percentage normalization per 11-bin block (PCL convention)
    blocks = fpfh.reshape(n, 3, N_BINS)
    blocks = 100.0 * blocks / torch.clamp(
        torch.sum(blocks, -1, keepdim=True), min=1e-9)
    return torch.where(mask[:, None], blocks.reshape(n, 3 * N_BINS), 0.0)


def _descriptor_topk(f_src: torch.Tensor, f_tgt: torch.Tensor,
                     mask_tgt: torch.Tensor, k: int) -> torch.Tensor:
    """[Ns, k] indices of each source descriptor's k nearest target
    descriptors (L2, the reference's expanded form), nearest first, ties
    to the lower index as ``lax.top_k(-d2, k)``."""
    d2 = (torch.sum(f_src ** 2, -1)[:, None] - 2.0 * f_src @ f_tgt.T
          + torch.sum(f_tgt ** 2, -1)[None, :])
    d2 = torch.where(mask_tgt[None, :], d2, float("inf"))
    return torch.sort(d2, dim=1, stable=True).indices[:, :k]


class FpfhMatches(NamedTuple):
    src_idx: torch.Tensor  # [K] indices into the source cloud
    tgt_idx: torch.Tensor  # [K] matched target indices
    mask: torch.Tensor  # [K] validity


def match_fpfh(fpfh_src: torch.Tensor, mask_src: torch.Tensor,
               fpfh_tgt: torch.Tensor, mask_tgt: torch.Tensor, draws: Draws,
               randomness: int = 15) -> FpfhMatches:
    """Descriptor matching with SAC-IA's correspondence randomization
    (`cregistration.hpp:393` ``setCorrespondenceRandomness(15)``): each
    source descriptor draws uniformly among its ``randomness`` nearest
    target descriptors (L2)."""
    dev = fpfh_src.device
    ns = fpfh_src.shape[0]
    topk = _descriptor_topk(fpfh_src, fpfh_tgt, mask_tgt, randomness)
    pick = randint(draws, (ns,), 0, randomness, dev)
    tgt_idx = torch.gather(topk, 1, pick[:, None])[:, 0]
    return FpfhMatches(src_idx=torch.arange(ns, device=dev), tgt_idx=tgt_idx,
                       mask=mask_src & mask_tgt[tgt_idx])


def _nn(pts: torch.Tensor, pts_mask: torch.Tensor, tgt: torch.Tensor,
        tgt_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN (index, squared distance) of [Q, 3] queries in the target: one
    ``nn`` launch on the card."""
    idx, d2 = kernels.nn(pts.contiguous(), pts_mask.contiguous(),
                         tgt.contiguous(), tgt_mask.contiguous())
    return idx.to(torch.int64), d2


def _sac_ia(src_xyz, src_mask, tgt_xyz, tgt_mask, topk_tgt, draws: Draws,
            inlier_thre: float, num_hypotheses: int, num_score_pts: int,
            randomness: int, min_inlier_count: int):
    dev = src_xyz.device
    k1, k2, k3 = draws.split(3)
    ns = src_xyz.shape[0]
    prob = src_mask.to(f32)
    prob = prob / torch.clamp(prob.sum(), min=1.0)
    s_idx = choice(k1, ns, (num_hypotheses, 3), prob)
    pick = randint(k2, (num_hypotheses, 3), 0, randomness, dev)
    t_idx = topk_tgt[s_idx, pick]  # [M, 3]
    R, t = _kabsch(src_xyz[s_idx], tgt_xyz[t_idx],
                   torch.ones((num_hypotheses, 3), dtype=f32, device=dev))

    # score each hypothesis by truncated 1-NN error over a fixed scoring
    # subset (PCL's align() loop with a truncated error functor): all
    # M x S projected points in one 1-NN search
    score_idx = choice(k3, ns, (num_score_pts,), prob)
    spts = src_xyz[score_idx]
    thre2 = inlier_thre * inlier_thre
    proj = torch.einsum("mij,sj->msi", R, spts) + t[:, None, :]
    q = proj.reshape(-1, 3)
    _, nn_d2 = _nn(q, torch.ones(q.shape[0], dtype=torch.bool, device=dev),
                   tgt_xyz, tgt_mask)
    scores = torch.sum(torch.clamp(nn_d2.reshape(num_hypotheses, -1),
                                   max=thre2), -1)
    best = torch.argmin(scores)
    Rb, tb = R[best], t[best]

    # polish: a few dense 1-NN Kabsch iterations on trimmed correspondences
    for _ in range(3):
        j, d2 = _nn(src_xyz @ Rb.T + tb, src_mask, tgt_xyz, tgt_mask)
        w = (d2 <= thre2) & src_mask
        Rb, tb = _kabsch(src_xyz, tgt_xyz[j], w.to(f32))
    _, nn_d2 = _nn(src_xyz @ Rb.T + tb, src_mask, tgt_xyz, tgt_mask)
    inl = (nn_d2 <= thre2) & src_mask
    n_inl = torch.sum(inl)
    fitness = (torch.sum(torch.where(src_mask, nn_d2, 0.0))
               / torch.clamp(torch.sum(src_mask), min=1))
    res = CoarseRegResult(transform=_pack(Rb, tb), inlier_count=n_inl,
                          valid=n_inl >= min_inlier_count,
                          reliable=n_inl >= 2 * min_inlier_count)
    return res, fitness


def coarse_reg_fpfhsac(src_xyz: torch.Tensor, src_normals: torch.Tensor,
                       src_mask: torch.Tensor, tgt_xyz: torch.Tensor,
                       tgt_normals: torch.Tensor, tgt_mask: torch.Tensor,
                       draws: Draws, search_radius: float,
                       inlier_thre: float = 1.0, num_hypotheses: int = 512,
                       num_score_pts: int = 256, randomness: int = 15,
                       min_inlier_count: int = 8
                       ) -> Tuple[CoarseRegResult, torch.Tensor]:
    """FPFH-SAC initial alignment (`coarse_reg_fpfhsac`,
    `cregistration.hpp:372-407`) with SAC-IA semantics: each hypothesis
    draws 3 source samples and pairs each with a random candidate among its
    ``randomness`` most similar target descriptors; the winner minimizes
    the truncated 1-NN error of the scoring points, then three trimmed
    Kabsch polishes.  Returns (result, fitness) with PCL
    ``getFitnessScore`` semantics (masked mean squared 1-NN distance of the
    aligned source)."""
    _, k2 = draws.split(2)
    f_src = compute_fpfh(src_xyz, src_normals, src_mask, 2.0 * search_radius)
    f_tgt = compute_fpfh(tgt_xyz, tgt_normals, tgt_mask, 2.0 * search_radius)
    topk = _descriptor_topk(f_src, f_tgt, tgt_mask, randomness)
    return _sac_ia(src_xyz, src_mask, tgt_xyz, tgt_mask, topk, k2,
                   inlier_thre, num_hypotheses, num_score_pts, randomness,
                   min_inlier_count)
