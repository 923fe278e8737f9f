"""Baseline odometry: voxel downsample + NDT / VGICP scan-to-map — port of
``mulls_tpu/pipeline/baseline.py``.

The reference program's ``--baseline_reg_method=ndt|gicp`` path
(`mulls_slam.cpp:413-416, 634-639, 671-676`): feature extraction becomes a
plain voxel downsample and registration the vendored baselines
(:mod:`mulls_tpu_torch.ops.baseline_reg`).  As in the odometry pipeline,
the map lives on the device as a fixed-capacity masked buffer in the
current frame's coordinates, frames are uploaded ahead by a host thread,
and the per-frame results come back in one transfer per run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from mulls_tpu_torch.config import MullsConfig
from mulls_tpu_torch.core import se3
from mulls_tpu_torch.core.cloud import unpack_raw
from mulls_tpu_torch.core.device import resolve_device
from mulls_tpu_torch.core.draws import Draws, GeneratorDraws
from mulls_tpu_torch.core.tree import Struct
from mulls_tpu_torch.ops import baseline_reg as br
from mulls_tpu_torch.ops import voxel as vx
from mulls_tpu_torch.pipeline.odometry import (OdometryResult, StepOut,
                                               prefetch_frames)

f32 = torch.float32


@dataclass
class BaselineState(Struct):
    map_xyz: torch.Tensor   # [M, 3] in the last frame's coordinates
    map_mask: torch.Tensor  # [M]
    pose: torch.Tensor      # [4, 4]
    T_prev: torch.Tensor    # [4, 4]
    frame_idx: torch.Tensor  # int32
    draws: Draws  # the reference's ``key`` (`jax.random.key(0)` there)


def init_baseline_state(cfg: MullsConfig, device="cuda",
                        draws: Optional[Draws] = None) -> BaselineState:
    """The run's starting state on ``device``; production ``draws`` come
    from a ``torch.Generator`` seeded from ``cfg.seed``."""
    dev = resolve_device(device)
    m = cfg.baseline.map_budget
    return BaselineState(
        map_xyz=torch.zeros((m, 3), dtype=f32, device=dev),
        map_mask=torch.zeros((m,), dtype=torch.bool, device=dev),
        pose=torch.eye(4, dtype=f32, device=dev),
        T_prev=torch.eye(4, dtype=f32, device=dev),
        frame_idx=torch.zeros((), dtype=torch.int32, device=dev),
        draws=draws if draws is not None else GeneratorDraws(cfg.seed, dev))


def _downsample_frame(raw, cfg: MullsConfig, draws: Draws):
    """The frame's valid points within range, one per voxel, at most
    ``frame_budget`` of them by a random draw, compacted in index order
    (``jnp.argsort`` is stable: the first valid points lead)."""
    b = cfg.baseline
    mask = vx.dist_filter_mask(raw.xyz, raw.mask,
                               cfg.preprocess.min_dist_used,
                               cfg.preprocess.max_dist_used)
    mask = vx.voxel_downsample_mask(raw.xyz, mask, b.voxel_down_size)
    mask = vx.random_downsample(mask, b.frame_budget, draws)
    idx = torch.argsort((~mask).to(torch.uint8), stable=True)[:b.frame_budget]
    return raw.xyz[idx], mask[idx]


def baseline_step(state: BaselineState, raw_packed, cfg: MullsConfig):
    """One frame: (new state, the packed [16] step vector of
    ``StepOut.pack_vec``)."""
    b = cfg.baseline
    dev = state.pose.device
    raw = unpack_raw(raw_packed)
    k_next, k_ds, k_map = state.draws.split(3)
    f_xyz, f_mask = _downsample_frame(raw, cfg, k_ds)

    first = state.frame_idx == 0
    guess = state.T_prev

    # target model from the current map (one pass of segment sums)
    table = br.build_voxel_table(state.map_xyz, state.map_mask,
                                 b.table_resolution,
                                 mode=("gicp" if b.method == "gicp"
                                       else "ndt"))
    if b.method == "gicp":
        s_cov = br.point_covariances(f_xyz, f_mask, b.gicp_cov_radius)
        res = br.vgicp_register(f_xyz, f_mask, s_cov, table, guess,
                                max_iter=b.max_iter)
    else:
        res = br.ndt_register(f_xyz, f_mask, table, guess,
                              max_iter=b.max_iter, direct7=b.direct7)

    ok = (res.matched > 100) & torch.isfinite(res.fitness)
    eye = torch.eye(4, dtype=f32, device=dev)
    T_rel = torch.where(first, eye, torch.where(ok, res.transform, guess))
    pose = state.pose @ T_rel
    pose = torch.cat([torch.cat([se3.orthonormalize(pose[:3, :3]),
                                 pose[:3, 3:]], dim=1), pose[3:]], dim=0)

    # map update: move the map into the new frame, append, crop, re-budget
    old_xyz = se3.transform_points(se3.inverse(T_rel), state.map_xyz)
    merged = torch.cat([old_xyz, f_xyz])
    m_mask = torch.cat([state.map_mask, f_mask])
    m_mask = m_mask & (torch.linalg.norm(merged, dim=-1)
                       < cfg.map.local_map_radius)
    # keep the newest first on overflow (a fresh point wins ties).  Masked
    # entries all score -1 and tie; which of them are kept changes nothing,
    # since a masked point weighs 0 in every later sum
    fresh = torch.cat([torch.zeros_like(state.map_mask, dtype=f32),
                       torch.full((f_xyz.shape[0],), 0.25, dtype=f32,
                                  device=dev)])
    score = torch.where(m_mask,
                        k_map.uniform(m_mask.shape).to(dev) + fresh, -1.0)
    keep_idx = torch.topk(score, b.map_budget).indices
    new_state = BaselineState(
        map_xyz=merged[keep_idx], map_mask=m_mask[keep_idx], pose=pose,
        T_prev=torch.where(first | ~ok, eye, T_rel),
        frame_idx=state.frame_idx + 1, draws=k_next)
    code = torch.where(first | ok, 1, -1).to(torch.int32)
    vec = StepOut.pack_vec(T_rel, res.fitness, code,
                           res.matched / torch.clamp(torch.sum(f_mask),
                                                     min=1.0),
                           res.iterations)
    return new_state, vec


class BaselinePipeline:
    """Streaming NDT / GICP odometry on ``device`` (``"cuda"`` unless the
    caller asks for the CPU): frames are uploaded ahead by a host thread,
    and the step vectors come back in one transfer at the end of the run.
    ``segment`` is the progress report's stride (the reference scans
    segments of that many frames)."""

    def __init__(self, cfg: MullsConfig, segment: int = 16, device="cuda",
                 draws: Optional[Draws] = None):
        if cfg.baseline.method not in ("ndt", "gicp"):
            raise ValueError(f"unknown baseline method "
                             f"{cfg.baseline.method!r}")
        self.cfg = cfg
        self.segment = segment
        self.device = resolve_device(device)
        self.draws = draws

    def run(self, dataset, progress: bool = False) -> OdometryResult:
        cfg = self.cfg
        n = len(dataset)
        state = init_baseline_state(cfg, self.device, self.draws)
        vecs: List[torch.Tensor] = []
        for i, raw in enumerate(prefetch_frames(
                dataset, self.device,
                with_ts=cfg.map.motion_compensation_method == 1)):
            state, vec = baseline_step(state, raw, cfg)
            vecs.append(vec)
            if progress and ((i + 1) % self.segment == 0 or i == n - 1):
                print(f"[{i + 1}/{n}] frames dispatched", flush=True)
        # ONE device-to-host copy for the whole run
        out = (torch.stack(vecs).cpu().numpy() if vecs
               else np.zeros((0, 16), np.float32))
        T_rels, fit, cod, _, _ = StepOut.unpack_vecs(out)
        poses = np.tile(np.eye(4), (n, 1, 1))
        for i in range(1, n):
            p = poses[i - 1] @ T_rels[i]
            u, _, vt = np.linalg.svd(p[:3, :3])
            p[:3, :3] = u @ vt
            poses[i] = p
        return OdometryResult(poses=poses, codes=[int(c) for c in cod],
                              sigmas=[float(s) for s in fit])
