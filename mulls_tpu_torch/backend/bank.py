"""Device-resident submap bank — port of ``mulls_tpu/backend/bank.py``.

Submap feature clouds stay on the card: a fixed-capacity bank (a leading
[S] axis on every local-map tensor) holds them, storing a submap is an
in-place copy into one slot, and every back-end evaluation (adjacent
map-to-map refinement, the loop-closure candidate ladder: NCC matching ->
GNC/RANSAC coarse -> odometry double-check -> fine MULLS-ICP) reads bank
slots and returns a small packed row, so the host fetches tens of floats
per registration instead of clouds.  Every map-to-map ICP iteration is one
grouped launch of the ``nn`` kernel for its feature classes.

Reference behavior covered: `test/mulls_slam.cpp:451-628` (per-submap
back-end), `src/build_pose_graph.cpp:123-209`, `mulls_slam.cpp:529-576`
(coarse + double-check + fine ladder).

Memory: one submap at the default map capacities is ~0.8 MB (19.4k masked
feature points + 2k descriptors); the default 192-slot bank ~155 MB.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mulls_tpu_torch.backend import coarse_reg as cr
from mulls_tpu_torch.backend.ncc import match_ncc
from mulls_tpu_torch.config import MullsConfig
from mulls_tpu_torch.core.cloud import FeatureCloud, VertexDescriptors
from mulls_tpu_torch.core.draws import Draws
from mulls_tpu_torch.core.tree import Struct, tree_map
from mulls_tpu_torch.frontend.icp import mm_lls_icp

# packed RegResult row: 12 (T[:3,:]) + sigma + code + confidence + iters
# + 36 (info 6x6) = 52 floats
REG_ROW = 52
# loop row adds: coarse_used flag + coarse_valid flag + coarse T (12)
LOOP_ROW = REG_ROW + 2 + 12


@dataclass
class SubmapBank(Struct):
    """Stacked local-map snapshots: every tensor has a leading [S] axis."""

    clouds: Dict[str, FeatureCloud]
    desc: VertexDescriptors

    @property
    def capacity(self) -> int:
        return self.desc.mask.shape[0]


def init_bank(template_clouds, template_desc, capacity: int) -> SubmapBank:
    """An all-zero bank shaped after one local map's clouds and
    descriptors, on their device."""
    z = lambda x: torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype,
                              device=x.device)
    return SubmapBank(clouds=tree_map(z, template_clouds),
                      desc=tree_map(z, template_desc))


def slot(tree, i: int):
    """The tensors of bank slot ``i`` (views)."""
    return tree_map(lambda x: x[i], tree)


def bank_store(bank: SubmapBank, i: int, clouds, desc) -> SubmapBank:
    """Write one local-map snapshot into slot ``i``, in place (one copy
    per tensor, ordered on the stream after the work that made them)."""
    idx = torch.tensor([i], device=bank.desc.mask.device)

    def put(b, x):
        b.index_copy_(0, idx, x[None])
        return b

    tree_map(put, bank.clouds, clouds)
    tree_map(put, bank.desc, desc)
    return bank


def local_bounds(clouds) -> torch.Tensor:
    """[6] = (min_xyz, max_xyz) of the submap's structural points in the
    submap's LOCAL frame; world bounds follow on the host from the 8
    transformed corners, so PGO pose updates re-bound a submap without
    touching its clouds (`graph_optimizer.cpp:778-798`)."""
    big = 1e9
    dev = clouds["ground"].xyz.device
    mn = torch.full((3,), big, dtype=torch.float32, device=dev)
    mx = torch.full((3,), -big, dtype=torch.float32, device=dev)
    any_valid = torch.tensor(False, device=dev)
    for name in ("ground", "facade", "pillar"):
        c = clouds[name]
        m = c.mask[:, None]
        mn = torch.minimum(mn, torch.amin(torch.where(m, c.xyz, big), dim=0))
        mx = torch.maximum(mx, torch.amax(torch.where(m, c.xyz, -big), dim=0))
        any_valid = any_valid | torch.any(c.mask)
    mn = torch.where(any_valid, mn, -1.0)
    mx = torch.where(any_valid, mx, 1.0)
    return torch.cat([mn, mx])


def _pack_reg(res) -> torch.Tensor:
    """RegResult -> [REG_ROW] f32."""
    f = torch.float32
    return torch.cat([
        res.transform[:3, :].reshape(-1),
        torch.stack([res.sigma.to(f), res.process_code.to(f),
                     res.confidence.to(f), res.iterations.to(f)]),
        res.information.reshape(-1).to(f)])


def unpack_reg(row):
    """[>=REG_ROW] numpy row -> dict(T f64 [4,4], sigma, code, confidence,
    iterations, info [6,6] f64)."""
    T = np.eye(4)
    T[:3, :] = np.asarray(row[:12], np.float64).reshape(3, 4)
    return {
        "T": T,
        "sigma": float(row[12]),
        "code": int(row[13]),
        "confidence": float(row[14]),
        "iterations": int(row[15]),
        "info": np.asarray(row[16:52], np.float64).reshape(6, 6),
    }


def unpack_loop(row):
    """[LOOP_ROW] numpy row -> unpack_reg dict + coarse_used/coarse_valid
    flags + the coarse transform."""
    d = unpack_reg(row)
    d["coarse_used"] = bool(row[52] > 0.5)
    d["coarse_valid"] = bool(row[53] > 0.5)
    Tc = np.eye(4)
    Tc[:3, :] = np.asarray(row[54:66], np.float64).reshape(3, 4)
    d["T_coarse"] = Tc
    return d


# m2m fine-ICP source budget: the submap clouds carry ~20k points per
# class; as the ICP SOURCE they would multiply every NN search ~8x over
# the frame ICP for no accuracy gain (correspondence count saturates in
# the low thousands).  The TARGET stays full.  Sources at or under the cap
# are untouched.
M2M_SRC_CAP = 4096


def _stride_src(clouds):
    """Stride-subsample every feature class to <= M2M_SRC_CAP (ceiling
    stride: 8191 points -> stride 2 -> 4096, never an over-cap 8191)."""
    out = {}
    for name, c in clouds.items():
        s = max(1, -(-c.xyz.shape[0] // M2M_SRC_CAP))
        out[name] = (tree_map(lambda x: x[::s].contiguous(), c) if s > 1
                     else c)
    return out


def pair_m2m(bank: SubmapBank, i: int, j: int, T_guess: torch.Tensor,
             cfg: MullsConfig, max_iter: int) -> torch.Tensor:
    """Register submap ``j`` onto submap ``i`` from bank slots — the
    adjacent-edge refinement (`mulls_slam.cpp:477-498`) and the rare
    retries.  Returns [REG_ROW] on the bank's device."""
    tgt = slot(bank.clouds, i)
    src = _stride_src(slot(bank.clouds, j))
    res = mm_lls_icp(src, tgt, cfg.reg, T_guess, max_iter=max_iter)
    return _pack_reg(res)


def loop_eval_batch(bank: SubmapBank, old_idx: Sequence[int], j: int,
                    T_guess: torch.Tensor, use_coarse: Sequence[bool],
                    check_mult: torch.Tensor, draws: Draws, cfg: MullsConfig,
                    n_eval: Optional[int] = None) -> torch.Tensor:
    """Evaluate K loop-closure candidates against submap ``j``
    (`mulls_slam.cpp:517-576` ladder), one candidate after the other:

      1. NCC descriptor matching old_k <- new (`:529`)
      2. GNC/RANSAC robust coarse alignment on the putative set (`:537`)
      3. odometry double-check of the coarse transform with per-candidate
         tolerance multipliers (`:551-555`)
      4. fine map-to-map MULLS-ICP from the checked coarse transform, else
         from the odometry prediction (`:560`)

    Every candidate starts from the PRE-transfer odometry prediction; the
    host applies the accept/transfer ordering on the rows.  Args: old_idx
    [K] slots, j slot, T_guess [K,4,4], use_coarse [K], check_mult [K,2]
    f32, draws (split into K children as the reference splits its key).
    Only the first ``n_eval`` rows (default all) are evaluated; the rest
    (the caller's padding) stay zero.  Returns [K, LOOP_ROW]."""
    s = cfg.submap
    dev = bank.desc.mask.device
    K = len(old_idx)
    n_eval = K if n_eval is None else n_eval
    src_full = slot(bank.clouds, j)
    src = _stride_src(src_full)
    src_desc = slot(bank.desc, j)
    children = draws.split(K)
    rows = torch.zeros((K, LOOP_ROW), dtype=torch.float32, device=dev)
    nb = cfg.feature.cloud_pca_neigh_r
    for k in range(n_eval):
        oi = int(old_idx[k])
        Tg = T_guess[k]
        tgt = slot(bank.clouds, oi)
        m = match_ncc(slot(bank.desc, oi), src_desc,
                      fixed_num_corr=s.best_n_feature_match_on,
                      corr_num=s.feature_corr_num,
                      reciprocal=s.reciprocal_feature_match_on)
        # NCC pairs index the FULL vertex cloud (descriptor rows align
        # with it); only the fine-ICP source is strided
        p_src = src_full["vertex"].xyz[m.s_idx]
        p_tgt = tgt["vertex"].xyz[m.t_idx]
        pm = (m.valid & src_full["vertex"].mask[m.s_idx]
              & tgt["vertex"].mask[m.t_idx])
        if s.teaser_based_global_registration_on:
            cres = cr.coarse_reg_gnc(
                p_src, p_tgt, pm, children[k], noise_bound=nb,
                min_inlier_count=s.teaser_min_inlier_count)
        else:
            cres = cr.coarse_reg_ransac(
                p_src, p_tgt, pm, children[k], inlier_thre=2.0 * nb,
                min_inlier_count=s.teaser_min_inlier_count)
        checked = cr.double_check_tran(
            cres.transform, Tg, s.wrong_edge_tran_thre * check_mult[k, 0],
            s.wrong_edge_rot_thre_deg * check_mult[k, 1])
        coarse_ok = bool(use_coarse[k]) & cres.valid & checked
        T_init = torch.where(coarse_ok, cres.transform, Tg)
        fres = mm_lls_icp(src, tgt, cfg.reg, T_init,
                          max_iter=cfg.reg.reg_max_iter_num_m2m)
        rows[k] = torch.cat([
            _pack_reg(fres),
            torch.stack([coarse_ok.to(torch.float32),
                         cres.valid.to(torch.float32)]),
            cres.transform[:3, :].reshape(-1)])
    return rows


def pair_bev(bank: SubmapBank, i: int, j: int, grid: int = 320,
             res: float = 0.6):
    """BEV FFT-correlation coarse alignment of slot j onto slot i straight
    from the bank (the fallback basin search).  Returns ([4,4], valid)."""
    sx, sm = cr.bev_feature_stack(slot(bank.clouds, j))
    tx, tm = cr.bev_feature_stack(slot(bank.clouds, i))
    out = cr.coarse_reg_bev(sx, sm, tx, tm, grid=grid, res=res)
    return out.transform, out.valid
