"""NCC keypoint descriptor matching — port of ``mulls_tpu/backend/ncc.py``
(reference `find_feature_correspondence_ncc`, `cregistration.hpp:409-601`).

Descriptors are the 11-dim vectors of the feature extractor.  Matching is
a dense L1 distance table [T, S], built one descriptor dimension at a
time (no [T, S, 11] intermediate), with either reciprocal-NN filtering or
the fixed-top-k mode with per-point usage caps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mulls_tpu_torch.core.cloud import VertexDescriptors

_BIG = 3.0e38


class NccMatches(NamedTuple):
    t_idx: torch.Tensor  # [K] target keypoint index (int64)
    s_idx: torch.Tensor  # [K] source keypoint index (int64)
    valid: torch.Tensor  # [K] bool
    dist: torch.Tensor  # [K] L1 descriptor distance


def _norm_intensity(vec, t_vec, t_mask):
    """Index 8 holds the raw mean neighborhood intensity; normalize both
    sides with the *target* min/max like the reference
    (`cregistration.hpp:436-487`)."""
    t_int = t_vec[:, 8]
    imin = torch.amin(torch.where(t_mask, t_int, _BIG))
    imax = torch.amax(torch.where(t_mask, t_int, -_BIG))
    rng = torch.clamp(imax - imin, min=1e-6)
    out = vec.clone()
    out[:, 8] = (vec[:, 8] - imin) / rng * 255.0
    return out


def l1_table(t_vec: torch.Tensor, s_vec: torch.Tensor) -> torch.Tensor:
    """[T, S] sum over the descriptor dimensions of |t - s|, accumulated
    dimension by dimension in order (the reference's reduction order)."""
    d = torch.abs(t_vec[:, None, 0] - s_vec[None, :, 0])
    for k in range(1, t_vec.shape[1]):
        d += torch.abs(t_vec[:, None, k] - s_vec[None, :, k])
    return d


def _usage_caps(ti: np.ndarray, si: np.ndarray, vals: np.ndarray,
                max_corr_num: int) -> np.ndarray:
    """The reference's sequential greedy pass over the sorted candidates
    (`cregistration.hpp:567-586`): keep a candidate while both of its
    points are used fewer than ``max_corr_num`` times."""
    cnt_t: dict = {}
    cnt_s: dict = {}
    keep = np.zeros(len(ti), bool)
    for n, (t, s, v) in enumerate(zip(ti.tolist(), si.tolist(),
                                      vals.tolist())):
        if (v < _BIG and cnt_t.get(t, 0) < max_corr_num
                and cnt_s.get(s, 0) < max_corr_num):
            cnt_t[t] = cnt_t.get(t, 0) + 1
            cnt_s[s] = cnt_s.get(s, 0) + 1
            keep[n] = True
    return keep


def match_ncc(target: VertexDescriptors, source: VertexDescriptors,
              fixed_num_corr: bool = True, corr_num: int = 1000,
              reciprocal: bool = False, max_corr_num: int = 6) -> NccMatches:
    t_vec = _norm_intensity(target.vec, target.vec, target.mask)
    s_vec = _norm_intensity(source.vec, target.vec, target.mask)
    d = l1_table(t_vec, s_vec)
    d = torch.where(target.mask[:, None] & source.mask[None, :], d, _BIG)

    tn, sn = d.shape
    dev = d.device
    if not fixed_num_corr:
        # per-target best source (first minimum) + optional reciprocal check
        best_s = torch.argmin(d, dim=1)
        best_val = torch.gather(d, 1, best_s[:, None])[:, 0]
        valid = target.mask & (best_val < _BIG)
        if reciprocal:
            col_min = torch.amin(d, dim=0)
            valid = valid & (best_val <= col_min[best_s])
        return NccMatches(t_idx=torch.arange(tn, device=dev), s_idx=best_s,
                          valid=valid, dist=best_val)

    # fixed-number mode: the globally smallest corr_num entries, equal
    # values in index order (``lax.top_k``'s order: a stable sort)
    k = min(corr_num, tn * sn)
    vals, flat_idx = torch.sort(d.reshape(-1), stable=True)
    vals, flat_idx = vals[:k], flat_idx[:k]
    ti = flat_idx // sn
    si = flat_idx % sn
    # the usage caps are a sequential greedy pass over <= corr_num
    # candidates: one host loop over the fetched candidates
    keep = _usage_caps(ti.cpu().numpy(), si.cpu().numpy(),
                       vals.cpu().numpy(), max_corr_num)
    return NccMatches(t_idx=ti, s_idx=si,
                      valid=torch.as_tensor(keep, device=dev), dist=vals)
