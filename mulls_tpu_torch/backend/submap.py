"""Submap management + loop closure + pose-graph back end — port of
``mulls_tpu/backend/submap.py`` (`test/mulls_slam.cpp:451-628`,
`src/build_pose_graph.cpp`):

* submap segmentation on accumulated translation / rotation / frame count
  (`map_manager.cpp:296-314`); a submap snapshots the local map into the
  device bank (``backend/bank.py``)
* adjacent edges from composed odometry, refined by map-to-map MULLS-ICP
  (`mulls_slam.cpp:477-498`)
* loop candidates by radius search over submap centers + 2D bbx IoU +
  id-gap gates (`build_pose_graph.cpp:123-209`)
* coarse alignment for loop candidates: NCC keypoint matching +
  GNC(TEASER-style)/RANSAC + odometry double-check
  (`mulls_slam.cpp:517-576`), with the BEV basin search as fallback
* PGO over submap nodes with node freezing, wrong-edge veto and cooling
  (`graph_optimizer.cpp`, `mulls_slam.cpp:597-623`)

Decisions run on the host over small fetched rows, as in the reference;
clouds stay in the bank on the back end's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mulls_tpu_torch.backend import bank as bk
from mulls_tpu_torch.backend import coarse_reg as cr
from mulls_tpu_torch.backend.ncc import match_ncc
from mulls_tpu_torch.backend.pgo import (PoseGraph, optimize_and_check,
                                         optimize_and_check_cg)
from mulls_tpu_torch.config import MullsConfig
from mulls_tpu_torch.core import trace
from mulls_tpu_torch.core.device import resolve_device
from mulls_tpu_torch.core.draws import Draws
from mulls_tpu_torch.core.tree import tree_map
from mulls_tpu_torch.frontend.icp import mm_lls_icp
from mulls_tpu_torch.ops import kernels

REG_EDGE, ADJACENT_EDGE, HISTORY_EDGE, NONE_EDGE = 2, 1, 0, -1


def to_host(tree):
    """A copy of a tree of tensors on the CPU (never a view of the bank)."""
    return tree_map(lambda x: x.detach().to("cpu", copy=True), tree)


def to_device(tree, device):
    return tree_map(lambda x: x.to(device), tree)


class Submap:
    """One submap node: world pose + feature clouds + NCC descriptors.

    The clouds may live in the back end's bank (``slot >= 0``); then
    ``clouds`` and ``descriptors`` are lazy properties that copy the slot
    to the host (and cache it) only when a consumer off the back end's
    path asks (checkpoints, snapshots, eviction).  World bounds derive
    from a 6-float local-frame AABB + the pose, so PGO pose updates
    re-bound the submap without cloud traffic.
    """

    def __init__(self, sid: int, pose: np.ndarray, clouds, descriptors,
                 frame_begin: int, frame_end: int, center=None,
                 bbx_min=None, bbx_max=None, stable: bool = False,
                 span_min_conf: float = 1.0, span_mean_conf: float = 1.0,
                 slot: int = -1, fetch=None, local_bbx=None):
        self.sid = sid
        self.pose = pose  # [4,4] world pose of the submap frame (f64)
        self._clouds = clouds  # host (CPU tensor) clouds, or None
        self._descriptors = descriptors  # host VertexDescriptors, or None
        self.frame_begin = frame_begin
        self.frame_end = frame_end
        self.center = (center if center is not None
                       else np.asarray(pose)[:3, 3].copy())
        self._bbx_min = bbx_min
        self._bbx_max = bbx_max
        # pose confirmed by a successful PGO (`pose_stable`,
        # `utility.hpp:260`); stable nodes get tight bounds in later PGOs
        self.stable = stable
        # worst / mean per-frame registration confidence over the span:
        # the min-vs-mean ratio de-weights the adjacent PGO edge INTO
        # this submap
        self.span_min_conf = span_min_conf
        self.span_mean_conf = span_mean_conf
        self.slot = slot  # bank slot, -1 = host-resident
        self._fetch = fetch  # () -> (host clouds, host descriptors)
        self._local_bbx = local_bbx  # [6] local-frame (min3, max3)

    def __repr__(self):
        return (f"Submap(sid={self.sid}, frames={self.frame_begin}.."
                f"{self.frame_end}, slot={self.slot})")

    def _materialize(self):
        # the bank's slots are written in place on the stream that reads
        # them, so a copy taken now is whole: the reference's retry around
        # fetches racing a buffer donation has no counterpart here
        if self._clouds is None and self._fetch is not None:
            self._clouds, self._descriptors = self._fetch()

    @property
    def clouds(self):
        self._materialize()
        return self._clouds

    @property
    def descriptors(self):
        self._materialize()
        return self._descriptors

    @property
    def bbx_min(self):
        if self._bbx_min is None:
            self.compute_bounds()
        return self._bbx_min

    @bbx_min.setter
    def bbx_min(self, v):
        self._bbx_min = v

    @property
    def bbx_max(self):
        if self._bbx_max is None:
            self.compute_bounds()
        return self._bbx_max

    @bbx_max.setter
    def bbx_max(self, v):
        self._bbx_max = v

    @property
    def local_bbx(self) -> Optional[np.ndarray]:
        """Local-frame AABB (min3, max3) of the structural classes."""
        if self._local_bbx is None:
            if self._clouds is None and self._fetch is None:
                return None
            pts = []
            for name in ("ground", "facade", "pillar"):
                c = self.clouds[name]
                m = c.mask.numpy()
                if m.any():
                    pts.append(c.xyz.numpy()[m])
            if not pts:
                return None
            p = np.concatenate(pts)
            self._local_bbx = np.concatenate([p.min(0), p.max(0)])
        elif not isinstance(self._local_bbx, np.ndarray):
            # a device tensor from bank.local_bounds — a 6-float fetch
            self._local_bbx = self._local_bbx.cpu().numpy().astype(
                np.float64)
        return self._local_bbx

    def compute_bounds(self):
        """World center + AABB from the local AABB's 8 transformed corners
        (a conservative superset of the exact per-point world AABB)."""
        self.center = self.pose[:3, 3].copy()
        lb = self.local_bbx
        if lb is None:
            self.bbx_min = self.center - 1.0
            self.bbx_max = self.center + 1.0
            return
        lo, hi = lb[:3], lb[3:]
        corners = np.array([[lo[0], lo[1], lo[2]], [lo[0], lo[1], hi[2]],
                            [lo[0], hi[1], lo[2]], [lo[0], hi[1], hi[2]],
                            [hi[0], lo[1], lo[2]], [hi[0], lo[1], hi[2]],
                            [hi[0], hi[1], lo[2]], [hi[0], hi[1], hi[2]]])
        w = corners @ self.pose[:3, :3].T + self.pose[:3, 3]
        self.bbx_min = w.min(0)
        self.bbx_max = w.max(0)


@dataclass
class Edge:
    i: int  # target submap (block1)
    j: int  # source submap (block2)
    T: np.ndarray  # [4,4] T such that T @ p_j ~ p_i
    info: np.ndarray  # [6,6]
    kind: int  # REG_EDGE / ADJACENT_EDGE / ...
    sigma: float = 0.0
    confidence: float = 1.0


def coarse_align_submaps(a: Submap, b: Submap, cfg: MullsConfig,
                         draws: Draws, device="cuda"
                         ) -> Tuple[np.ndarray, bool]:
    """NCC keypoint matching + robust coarse registration of submap b onto
    submap a on ``device`` (`mulls_slam.cpp:529-556`)."""
    s = cfg.submap
    m = match_ncc(to_device(a.descriptors, device),
                  to_device(b.descriptors, device),
                  fixed_num_corr=s.best_n_feature_match_on,
                  corr_num=s.feature_corr_num,
                  reciprocal=s.reciprocal_feature_match_on)
    va = to_device(a.clouds["vertex"], device)
    vb = to_device(b.clouds["vertex"], device)
    src = vb.xyz[m.s_idx]
    tgt = va.xyz[m.t_idx]
    mask = m.valid & vb.mask[m.s_idx] & va.mask[m.t_idx]
    nb = cfg.feature.cloud_pca_neigh_r
    if s.teaser_based_global_registration_on:
        res = cr.coarse_reg_gnc(src, tgt, mask, draws, noise_bound=nb,
                                min_inlier_count=s.teaser_min_inlier_count)
    else:
        res = cr.coarse_reg_ransac(src, tgt, mask, draws,
                                   inlier_thre=2.0 * nb,
                                   min_inlier_count=s.teaser_min_inlier_count)
    return (res.transform.cpu().numpy().astype(np.float64),
            bool(res.valid))


def bev_stack_of(s: Submap, device="cuda"):
    """The BEV feature stack (xyz, mask) of a submap as tensors on
    ``device``: computed once and reused when many pairs are aligned (the
    merge's fallback is all-pairs, so per-call stacks would be O(A*B)
    instead of O(A+B))."""
    return tuple(x.to(device) for x in cr.bev_feature_stack(s.clouds))


def bev_align_submaps(a: Submap, b: Submap, grid: int = 320,
                      res: float = 0.6, device="cuda", stack_a=None,
                      stack_b=None) -> Tuple[np.ndarray, bool]:
    """Global BEV FFT-correlation coarse alignment of submap b onto a —
    the fallback when NCC putative sets degrade (a dense (yaw, tx, ty)
    basin search cannot miss the true mode for planar motion).
    ``stack_a`` / ``stack_b`` are :func:`bev_stack_of`'s stacks, when the
    caller keeps them."""
    tx, tm = stack_a if stack_a is not None else bev_stack_of(a, device)
    sx, sm_m = stack_b if stack_b is not None else bev_stack_of(b, device)
    out = cr.coarse_reg_bev(sx, sm_m, tx, tm, grid=grid, res=res)
    return out.transform.cpu().numpy().astype(np.float64), bool(out.valid)


def _np_quat_from_rotation(R: np.ndarray) -> np.ndarray:
    """Batched rotation matrix -> unit quaternion [w,x,y,z] on the host."""
    R = np.asarray(R, np.float64)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = np.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = np.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = np.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], -1)
    qz = np.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], -1)
    cands = np.stack([qw, qx, qy, qz], -2)
    scores = np.stack([tr, m00, m11, m22], -1)
    idx = np.argmax(scores, axis=-1)
    q = np.take_along_axis(cands, idx[..., None, None].repeat(4, -1),
                           axis=-2)[..., 0, :]
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return q * np.where(q[..., :1] < 0, -1.0, 1.0)


def _np_rotation_from_quat(q: np.ndarray) -> np.ndarray:
    """Batched quaternion [w,x,y,z] -> rotation matrix on the host."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = (q[..., i] for i in range(4))
    r0 = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)], -1)
    r1 = np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)], -1)
    r2 = np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)], -1)
    return np.stack([r0, r1, r2], -2)


def _np_double_check(T_coarse: np.ndarray, T_predict: np.ndarray,
                     tran_thre: float, rot_thre_deg: float) -> bool:
    """Host twin of `coarse_reg.double_check_tran`
    (`build_pose_graph.cpp:211-235`)."""
    dT = np.linalg.inv(T_predict) @ T_coarse
    dt = float(np.linalg.norm(dT[:3, 3]))
    c = np.clip((np.trace(dT[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
    return dt <= tran_thre and np.degrees(np.arccos(c)) <= rot_thre_deg


def _bbx_iou_2d(a: Submap, b: Submap) -> float:
    lo = np.maximum(a.bbx_min[:2], b.bbx_min[:2])
    hi = np.minimum(a.bbx_max[:2], b.bbx_max[:2])
    inter = np.prod(np.maximum(hi - lo, 0.0))
    area_a = np.prod(np.maximum(a.bbx_max[:2] - a.bbx_min[:2], 1e-6))
    area_b = np.prod(np.maximum(b.bbx_max[:2] - b.bbx_min[:2], 1e-6))
    return float(inter / max(min(area_a, area_b), 1e-6))


class SlamBackend:
    """Owns submaps, the pose graph, and the loop-closure machinery; its
    bank and every registration live on ``device``."""

    def __init__(self, cfg: MullsConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.submaps: List[Submap] = []
        self.edges: List[Edge] = []
        self.events: List[str] = []  # back-end decision log (glog parity)
        self.cooling = 0
        # frames since the last successful PGO — beyond
        # num_frame_thre_large_drift the odometry prior is distrusted
        # (`mulls_slam.cpp:505,558` accu_frame_count_wo_opt)
        self.frames_wo_opt = 0
        self._accu_tran = 0.0
        self._accu_rot_deg = 0.0
        self._accu_frames = 0
        # worst / summed per-frame registration confidence of the open span
        self._span_min_conf = 1.0
        self._span_conf_sum = 0.0
        self._span_conf_n = 0
        # optimized submap poses (None until a successful PGO)
        self.optimized: Optional[np.ndarray] = None
        # the submap bank (allocated at the first add_submap)
        self.bank: Optional[bk.SubmapBank] = None
        self._bank_cap = cfg.submap.submap_bank_capacity
        self._slot_sid: Dict[int, int] = {}  # slot -> sid
        # kernel launches made by on_new_submap (the calling thread's own)
        self.launches = {name: 0 for name in kernels.launch_counts()}
        # host-clock ms of each boundary ladder, of each loop candidate's
        # evaluation and of each PGO solve, results fetched (on a card the
        # ladder queues behind the front end's work on the shared stream)
        self.timings = {"ladder": [], "candidate": [], "pgo": []}
        self.pgo_accepted = 0  # optimize() calls that returned poses

    # --- segmentation --------------------------------------------------

    def accumulate(self, T_rel: np.ndarray, confidence: float = None
                   ) -> None:
        self._accu_tran += float(np.linalg.norm(T_rel[:3, 3]))
        c = np.clip((np.trace(T_rel[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        self._accu_rot_deg += float(np.degrees(np.arccos(c)))
        self._accu_frames += 1
        self.frames_wo_opt += 1
        if confidence is not None:
            self._span_min_conf = min(self._span_min_conf, float(confidence))
            self._span_conf_sum += float(confidence)
            self._span_conf_n += 1

    def should_segment(self) -> bool:
        s = self.cfg.submap
        return (self._accu_tran > s.submap_accu_tran
                or self._accu_rot_deg > s.submap_accu_rot
                or self._accu_frames >= s.submap_accu_frame)

    def _make_fetch(self, slot: int):
        def fetch():
            return (to_host(bk.slot(self.bank.clouds, slot)),
                    to_host(bk.slot(self.bank.desc, slot)))
        return fetch

    def rebuild_bank(self) -> None:
        """Re-upload restored submap clouds into the bank after a
        checkpoint resume: the newest ``submap_bank_capacity`` submaps go
        to slot = sid % capacity (add_submap's assignment); older ones stay
        host-resident like evicted submaps.  Without it the post-resume
        ladder would take the host path and lose loop closures.  Like the
        reference, it drops the bank before it materializes the submaps
        (`mulls_tpu/backend/submap.py:419-420`)."""
        if not self.submaps:
            return
        self.bank = None
        self._slot_sid = {}
        start = max(0, len(self.submaps) - self._bank_cap)
        for sm in self.submaps[:start]:
            sm._materialize()
            sm.slot = -1
            sm._fetch = None
        for sm in self.submaps[start:]:
            sm._materialize()
            clouds = to_device(sm.clouds, self.device)
            desc = to_device(sm.descriptors, self.device)
            if self.bank is None:
                self.bank = bk.init_bank(clouds, desc, self._bank_cap)
            slot = sm.sid % self._bank_cap
            bk.bank_store(self.bank, slot, clouds, desc)
            self._slot_sid[slot] = sm.sid
            sm.slot = slot
            sm._fetch = self._make_fetch(slot)

    def add_submap(self, local_map, pose: np.ndarray, frame_begin: int,
                   frame_end: int) -> Submap:
        """Snapshot the local map (on the back end's device) as a new
        submap: one in-place copy into a bank slot; the host fetches only
        the 6-float local AABB, lazily."""
        sid = len(self.submaps)
        if self.bank is None:
            self.bank = bk.init_bank(local_map.clouds, local_map.vertex_desc,
                                     self._bank_cap)
        slot = sid
        if slot >= self._bank_cap:
            # bank full: evict the oldest banked submap to the host (it
            # stays a loop candidate through the host path)
            slot = min(self._slot_sid, key=lambda s: self._slot_sid[s])
            old = self.submaps[self._slot_sid[slot]]
            old._materialize()
            _ = old.local_bbx
            old.slot = -1
            old._fetch = None
            del self._slot_sid[slot]
            self.events.append(f"bank: evicted submap {old.sid} "
                               f"(slot {slot} -> {sid})")
        bk.bank_store(self.bank, slot, local_map.clouds,
                      local_map.vertex_desc)
        self._slot_sid[slot] = sid
        lb = bk.local_bounds(local_map.clouds)  # device [6], fetched lazily
        sm = Submap(sid=sid, pose=pose.copy(), clouds=None, descriptors=None,
                    frame_begin=frame_begin, frame_end=frame_end,
                    slot=slot, fetch=self._make_fetch(slot), local_bbx=lb)
        sm.span_min_conf = self._span_min_conf
        sm.span_mean_conf = (self._span_conf_sum / self._span_conf_n
                             if self._span_conf_n else 1.0)
        self.submaps.append(sm)
        self._accu_tran = 0.0
        self._accu_rot_deg = 0.0
        self._accu_frames = 0
        self._span_min_conf = 1.0
        self._span_conf_sum = 0.0
        self._span_conf_n = 0
        return sm

    # --- registration helpers -------------------------------------------

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def map_to_map(self, a: Submap, b: Submap, T_guess: np.ndarray,
                   max_iter: Optional[int] = None):
        """Register submap b onto submap a from host clouds (RegResult)."""
        return mm_lls_icp(to_device(b.clouds, self.device),
                          to_device(a.clouds, self.device), self.cfg.reg,
                          self._t(T_guess),
                          max_iter=max_iter or self.cfg.reg.reg_max_iter_num_m2m)

    def coarse_align(self, a: Submap, b: Submap, draws: Draws
                     ) -> Tuple[np.ndarray, bool]:
        return coarse_align_submaps(a, b, self.cfg, draws, self.device)

    def bev_align(self, a: Submap, b: Submap) -> Tuple[np.ndarray, bool]:
        return bev_align_submaps(a, b, device=self.device)

    # --- back-end step at a new submap boundary --------------------------

    def _pair_reg(self, a: Submap, b: Submap, T_guess: np.ndarray,
                  max_iter: Optional[int] = None) -> dict:
        """m2m registration of b onto a as a plain host dict: from bank
        slots when both submaps are banked (one 52-float fetch), else from
        the host clouds."""
        mi = max_iter or self.cfg.reg.reg_max_iter_num_m2m
        if self.bank is not None and a.slot >= 0 and b.slot >= 0:
            row = bk.pair_m2m(self.bank, a.slot, b.slot, self._t(T_guess),
                              self.cfg, mi).cpu().numpy()
            return bk.unpack_reg(row)
        res = self.map_to_map(a, b, T_guess, max_iter=mi)
        return {"T": res.transform.cpu().numpy().astype(np.float64),
                "sigma": float(res.sigma), "code": int(res.process_code),
                "confidence": float(res.confidence),
                "iterations": int(res.iterations),
                "info": res.information.cpu().numpy().astype(np.float64)}

    def on_new_submap(self, draws: Draws,
                      frames_wo_opt: Optional[int] = None
                      ) -> Optional[np.ndarray]:
        """The reference's per-submap back end (SURVEY.md §3.2).  Returns
        updated submap poses [S, 4, 4] if a PGO ran and was accepted, else
        None.  ``frames_wo_opt``: the drift counter as of the boundary frame
        (a threaded caller snapshots it; the reset on acceptance is then
        the caller's).  The kernel launches this call makes on its own
        thread are added to ``self.launches``."""
        with trace.span("backend.ladder", timed=True) as sp, \
                kernels.count_launches() as counts:
            poses = self._on_new_submap(draws, frames_wo_opt)
        for name in self.launches:
            self.launches[name] += counts[name]
        self.timings["ladder"].append(sp.ms)
        return poses

    def _on_new_submap(self, draws, frames_wo_opt):
        s_cfg = self.cfg.submap
        fwo = (self.frames_wo_opt if frames_wo_opt is None
               else int(frames_wo_opt))
        if len(self.submaps) < 2:
            return None
        a = self.submaps[-2]
        b = self.submaps[-1]

        # demote weak registration edges (`build_pose_graph.cpp:100-121`)
        for e in self.edges:
            if e.kind == REG_EDGE and (e.confidence < 0.2 or e.sigma > 0.3):
                e.kind = HISTORY_EDGE

        # adjacent edge + map-to-map refinement
        T_adj = np.linalg.inv(a.pose) @ b.pose
        adj = self._pair_reg(a, b, T_adj)
        code, sigma = adj["code"], adj["sigma"]
        if code == 1 and sigma <= s_cfg.map2map_reliable_sigma_thre:
            # overwrite odometry with the refined estimate
            T_adj = adj["T"]
            b.pose = a.pose @ T_adj
            b.compute_bounds()
        # the adjacent edge carries the full m2m information when the
        # solve converged (`information_matrix_to_next`,
        # `build_pose_graph.cpp:51-83`)
        info = (adj["info"] if code == 1 else np.eye(6) * 100.0)
        # de-weight the adjacent edge by the span's worst-vs-mean per-frame
        # registration confidence, normalized by the span's own mean
        q = float(np.clip(
            b.span_min_conf / max(0.5 * b.span_mean_conf, 1e-6), 0.05, 1.0))
        if q < 1.0:
            self.events.append(
                f"adjacent {a.sid}->{b.sid}: span conf min/mean "
                f"{b.span_min_conf:.3f}/{b.span_mean_conf:.3f}, "
                f"info x{q*q:.4f}")
        self.edges.append(Edge(i=a.sid, j=b.sid, T=T_adj, info=info * q * q,
                               kind=ADJACENT_EDGE, sigma=sigma,
                               confidence=adj["confidence"]))

        if not s_cfg.loop_closure_detection_on:
            return None
        if self.cooling > 0:
            self.cooling -= 1
            return None

        # large-drift mode (`mulls_slam.cpp:505-511`): widen the search
        # and drop the IoU gate
        overall = (s_cfg.overall_loop_closure_searching_on
                   and fwo > s_cfg.num_frame_thre_large_drift)
        search_dist = (1.5 if overall else 1.0) * s_cfg.neighbor_search_dist
        iou_gate = 0.0 if overall else s_cfg.min_iou_thre
        if overall:
            self.events.append(
                f"submap {b.sid}: large-drift loop search "
                f"({fwo} frames w/o opt)")

        # loop candidates (`build_pose_graph.cpp:123-209`)
        cands = []
        for old in self.submaps[:-1]:
            if b.sid - old.sid < s_cfg.min_submap_id_diff:
                continue
            d = np.linalg.norm(old.center[:2] - b.center[:2])
            if d > search_dist + 0.02 * self._dist_since(old):
                continue
            iou = _bbx_iou_2d(old, b)
            if iou < iou_gate:
                self.events.append(f"cand {old.sid}->{b.sid} rejected: "
                                   f"iou {iou:.2f}")
                continue
            cands.append((iou, old))
        cands.sort(key=lambda x: -x[0])
        self.events.append(f"submap {b.sid}: {len(cands)} loop candidates")

        sel = cands[:s_cfg.max_used_reg_edge_per_optimization]
        # drift-aware acceptance window (SubmapConfig.loop_check_*)
        if overall:
            tol_t = s_cfg.wrong_edge_tran_thre * 10.0
            tol_r = s_cfg.wrong_edge_rot_thre_deg * 6.0
        else:
            tol_t = min(s_cfg.loop_check_drift_tol_base
                        + s_cfg.loop_check_drift_tol_per_frame * fwo,
                        s_cfg.wrong_edge_tran_thre * 3.0)
            tol_r = min(s_cfg.loop_check_drift_rot_base_deg
                        + s_cfg.loop_check_drift_rot_per_frame_deg * fwo,
                        s_cfg.wrong_edge_rot_thre_deg * 3.0)
        use_bank = (self.bank is not None and b.slot >= 0 and sel
                    and all(o.slot >= 0 for _, o in sel))
        if use_bank:
            new_reg_edges = self._eval_candidates_banked(sel, b, overall,
                                                         draws, fwo,
                                                         (tol_t, tol_r))
        else:
            new_reg_edges = self._eval_candidates_host(sel, b, overall,
                                                       draws, fwo,
                                                       (tol_t, tol_r))

        if new_reg_edges == 0:
            return None
        poses = self.optimize()
        if poses is not None:
            self.cooling = s_cfg.cooling_submap_num
            if frames_wo_opt is None:
                # synchronous caller: reset here (threaded callers defer
                # the reset to the pipeline's _apply_boundary)
                self.frames_wo_opt = 0
        return poses

    def _bev_of(self, a: Submap, b: Submap) -> Tuple[np.ndarray, bool]:
        """Prior-free BEV basin alignment, from the bank when possible."""
        if self.bank is not None and a.slot >= 0 and b.slot >= 0:
            T_bev, ok = bk.pair_bev(self.bank, a.slot, b.slot)
            return T_bev.cpu().numpy().astype(np.float64), bool(ok)
        return self.bev_align(a, b)

    def _drift_window_accept(self, old: Submap, b: Submap, d: dict,
                             tol: Tuple[float, float],
                             allow_bev: bool = True
                             ) -> Tuple[dict, bool, bool]:
        """Drift-aware acceptance of a code-1 fine m2m result ``d``: a
        result outside the window around the odometry prediction is
        retried from that prediction, then (while ``allow_bev``) arbitrated
        by the prior-free BEV basin search.  Returns (result, accepted,
        via_bev); a via_bev edge must not drive the transfer correction."""
        tol_t, tol_r = tol
        s_cfg = self.cfg.submap
        Tg = np.linalg.inv(old.pose) @ b.pose
        if _np_double_check(d["T"], Tg, tol_t, tol_r):
            return d, True, False
        d2 = self._pair_reg(old, b, Tg)
        if (d2["code"] == 1
                and d2["confidence"] >= s_cfg.map_to_map_min_cor_ratio
                and _np_double_check(d2["T"], Tg, tol_t, tol_r)):
            self.events.append(
                f"loop {old.sid}->{b.sid}: outside drift window "
                f"({tol_t:.2f} m), odometry-guess retry accepted")
            return dict(d2, coarse_used=False), True, False
        if allow_bev:
            T_bev, ok_bev = self._bev_of(old, b)
            if ok_bev and _np_double_check(d["T"], T_bev,
                                           max(1.0, 0.5 * tol_t),
                                           max(5.0, 0.5 * tol_r)):
                self.events.append(
                    f"loop {old.sid}->{b.sid}: outside drift window "
                    f"({tol_t:.2f} m) but BEV-confirmed, accepted")
                return d, True, True
        self.events.append(
            f"loop {old.sid}->{b.sid}: rejected, outside drift window "
            f"({tol_t:.2f} m / {tol_r:.1f} deg)")
        return d, False, False

    def _eval_candidates_banked(self, sel, b: Submap, overall: bool,
                                draws: Draws, fwo: int,
                                tol: Tuple[float, float]) -> int:
        """The candidate ladder over bank slots (``bank.loop_eval_batch``),
        host accept logic on its rows, rare re-runs for the BEV fallback
        and transfer-corrected retries."""
        s_cfg = self.cfg.submap
        f_t, f_r = (10.0, 6.0) if overall else (3.0, 3.0)
        K = s_cfg.max_used_reg_edge_per_optimization
        old_idx = np.zeros((K,), np.int64)
        Tg = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        uc = np.zeros((K,), bool)
        cm = np.broadcast_to(np.asarray([f_t, f_r], np.float32),
                             (K, 2)).copy()
        for r, (iou, old) in enumerate(sel):
            old_idx[r] = old.slot
            Tg[r] = (np.linalg.inv(old.pose) @ b.pose).astype(np.float32)
            uc[r] = bool(iou > s_cfg.min_iou_thre_global_reg or overall)
        with trace.span("backend.candidate", timed=True) as sp:
            rows = bk.loop_eval_batch(
                self.bank, old_idx.tolist(), b.slot, self._t(Tg),
                uc.tolist(), self._t(cm), draws, self.cfg,
                n_eval=len(sel)).cpu().numpy()
        self.timings["candidate"] += [sp.ms / len(sel)] * len(sel)

        def _weak(dd):
            return (dd["code"] != 1
                    or dd["confidence"] < s_cfg.map_to_map_min_cor_ratio)

        new_reg_edges = 0
        transfer_T: Optional[np.ndarray] = None
        for r, (iou, old) in enumerate(sel):
            d = bk.unpack_loop(rows[r])
            T_guess = np.asarray(Tg[r], np.float64)
            if d["coarse_used"]:
                self.events.append(f"loop {old.sid}->{b.sid}: using "
                                   "coarse alignment")
            elif uc[r]:
                # NCC coarse failed its checks; only when the fine solve
                # from the odometry prediction also failed is the global
                # BEV basin search worth a retry
                if _weak(d):
                    T_bev, ok_bev = bk.pair_bev(self.bank, old.slot, b.slot)
                    T_bev = T_bev.cpu().numpy().astype(np.float64)
                    if bool(ok_bev) and _np_double_check(
                            T_bev, T_guess,
                            s_cfg.wrong_edge_tran_thre * f_t,
                            s_cfg.wrong_edge_rot_thre_deg * f_r):
                        d2 = self._pair_reg(old, b, T_bev)
                        if not _weak(d2):
                            d = dict(d2, coarse_used=True)
                            self.events.append(
                                f"loop {old.sid}->{b.sid}: using BEV "
                                "coarse alignment")
                    else:
                        self.events.append(f"loop {old.sid}->{b.sid}: "
                                           "coarse failed, using odometry "
                                           "prediction")
            if (not d["coarse_used"] and transfer_T is None
                    and fwo > s_cfg.num_frame_thre_large_drift):
                # large drift + no global registration: the odometry prior
                # is untrustworthy, skip the candidate (`mulls_slam.cpp:558`)
                self.events.append(f"loop {old.sid}->{b.sid}: skipped, "
                                   "drifted odometry prior only")
                continue
            if transfer_T is not None and _weak(d):
                # the row used the pre-transfer guess; the reference's
                # sequential loop would have seen the corrected b.pose
                d = self._pair_reg(old, b, np.linalg.inv(old.pose) @ b.pose)
            if d["code"] != 1:
                self.events.append(f"loop {old.sid}->{b.sid}: fine reg code "
                                   f"{d['code']}")
                continue
            if d["confidence"] < s_cfg.map_to_map_min_cor_ratio:
                # overlap too thin for a trustworthy m2m edge
                # (`--map_to_map_min_cor_ratio`, `mulls_slam.cpp:566`)
                self.events.append(
                    f"loop {old.sid}->{b.sid}: rejected, corr ratio "
                    f"{d['confidence']:.3f}")
                continue
            d, ok, via_bev = self._drift_window_accept(
                old, b, d, tol, allow_bev=(transfer_T is None))
            if not ok:
                continue
            self.events.append(f"loop {old.sid}->{b.sid}: accepted, sigma "
                               f"{d['sigma']:.4f}")
            self.edges.append(Edge(i=old.sid, j=b.sid, T=d["T"],
                                   info=d["info"], kind=REG_EDGE,
                                   sigma=d["sigma"],
                                   confidence=d["confidence"]))
            new_reg_edges += 1
            if s_cfg.transfer_correct_reg_tran_on and not via_bev:
                transfer_T = d["T"]
                b.pose = old.pose @ transfer_T
                b.compute_bounds()
        return new_reg_edges

    def _eval_candidates_host(self, sel, b: Submap, overall: bool,
                              draws: Draws, fwo: Optional[int] = None,
                              tol: Optional[Tuple[float, float]] = None
                              ) -> int:
        """The sequential candidate ladder on host clouds — used when a
        candidate was evicted from the bank or restored from a checkpoint.
        Every candidate's coarse alignment gets the same ``draws``, as the
        reference passes every one the same key."""
        s_cfg = self.cfg.submap
        if fwo is None:
            fwo = self.frames_wo_opt
        if tol is None:
            tol = (s_cfg.wrong_edge_tran_thre * (10.0 if overall else 3.0),
                   s_cfg.wrong_edge_rot_thre_deg * (6.0 if overall else 3.0))
        new_reg_edges = 0
        transfer_T: Optional[np.ndarray] = None
        for rank, (iou, old) in enumerate(sel):
            with trace.span("backend.candidate", timed=True) as sp:
                T_guess = np.linalg.inv(old.pose) @ b.pose
                T_init = T_guess
                global_reg_ok = False
                if transfer_T is None and (iou > s_cfg.min_iou_thre_global_reg
                                           or overall):
                    # global registration for high-overlap candidates
                    # (`mulls_slam.cpp:529-556`); on failure fall back to the
                    # odometry prediction
                    T_coarse, ok = self.coarse_align(old, b, draws)
                    f_t, f_r = (10.0, 6.0) if overall else (3.0, 3.0)

                    def _checked(T_c):
                        return _np_double_check(
                            np.asarray(T_c, np.float64), T_guess,
                            s_cfg.wrong_edge_tran_thre * f_t,
                            s_cfg.wrong_edge_rot_thre_deg * f_r)

                    if ok and _checked(T_coarse):
                        T_init = T_coarse
                        global_reg_ok = True
                        self.events.append(f"loop {old.sid}->{b.sid}: using "
                                           "coarse alignment")
                    else:
                        # NCC failed or locked onto a wrong coherent mode:
                        # retry with the global BEV basin search
                        T_bev, ok_bev = self.bev_align(old, b)
                        if ok_bev and _checked(T_bev):
                            T_init = T_bev
                            global_reg_ok = True
                            self.events.append(f"loop {old.sid}->{b.sid}: "
                                               "using BEV coarse alignment")
                        else:
                            self.events.append(f"loop {old.sid}->{b.sid}: "
                                               "coarse failed, using odometry "
                                               "prediction")
                if (not global_reg_ok and transfer_T is None
                        and fwo > s_cfg.num_frame_thre_large_drift):
                    self.events.append(f"loop {old.sid}->{b.sid}: skipped, "
                                       "drifted odometry prior only")
                    continue
                d = self._pair_reg(old, b, T_init)
            self.timings["candidate"].append(sp.ms)
            if d["code"] != 1:
                self.events.append(f"loop {old.sid}->{b.sid}: fine reg code "
                                   f"{d['code']}")
                continue
            if d["confidence"] < s_cfg.map_to_map_min_cor_ratio:
                self.events.append(
                    f"loop {old.sid}->{b.sid}: rejected, corr ratio "
                    f"{d['confidence']:.3f}")
                continue
            d, ok, via_bev = self._drift_window_accept(
                old, b, d, tol, allow_bev=(transfer_T is None))
            if not ok:
                continue
            self.events.append(f"loop {old.sid}->{b.sid}: accepted, sigma "
                               f"{d['sigma']:.4f}")
            self.edges.append(Edge(
                i=old.sid, j=b.sid, T=d["T"], info=d["info"], kind=REG_EDGE,
                sigma=d["sigma"], confidence=d["confidence"]))
            new_reg_edges += 1
            if s_cfg.transfer_correct_reg_tran_on and not via_bev:
                transfer_T = d["T"]
                b.pose = old.pose @ transfer_T
                b.compute_bounds()
        return new_reg_edges

    def _dist_since(self, old: Submap) -> float:
        return float(sum(np.linalg.norm(
            self.submaps[k + 1].pose[:3, 3] - self.submaps[k].pose[:3, 3])
            for k in range(old.sid, len(self.submaps) - 1)))

    # --- PGO --------------------------------------------------------------

    def build_graph(self, extra_fixed=None) -> Tuple[PoseGraph, list]:
        """The pose graph of the active (REG and ADJACENT) edges on the
        back end's device, with the reference's freezing, per-node bounds
        and bucket padding (nodes to 16, edges to 32; padding nodes are
        fixed identities, padding edges masked)."""
        m = len(self.submaps)
        active = [e for e in self.edges if e.kind in (REG_EDGE, ADJACENT_EDGE)]
        e = len(active)
        node_t = np.stack([s.pose[:3, 3] for s in self.submaps]).astype(
            np.float32)
        Rs = np.stack([s.pose[:3, :3] for s in self.submaps])
        node_q = _np_quat_from_rotation(Rs).astype(np.float32)
        edge_t = np.stack([ed.T[:3, 3] for ed in active]).astype(np.float32)
        Rq = np.stack([ed.T[:3, :3] for ed in active])
        edge_q = _np_quat_from_rotation(Rq).astype(np.float32)
        w_adj = self.cfg.submap.adjacent_edge_weight_ratio
        info = np.stack([
            ed.info * (w_adj if ed.kind == ADJACENT_EDGE else 1.0)
            for ed in active]).astype(np.float32)
        fixed = np.zeros(m, bool)
        fixed[0] = True
        if extra_fixed is not None:
            fixed |= np.asarray(extra_fixed, bool)
        # pre-loop nodes frozen like the reference's ceres bounds trick
        reg_targets = [ed.i for ed in active if ed.kind == REG_EDGE]
        if reg_targets:
            fixed[:min(reg_targets)] = True
        # per-node parameter bounds (`set_pgo_problem_ceres`,
        # `graph_optimizer.cpp:594-629`): stable nodes move at most
        # +-inter_submap_{t,r}_limit; the others get a limit growing with
        # their distance from the last stable node
        t_limit = r_limit = None
        if not self.cfg.submap.free_node_on:
            t_lim = np.full(m, np.inf, np.float32)
            r_lim = np.full(m, np.inf, np.float32)
            t0 = self.cfg.submap.inter_submap_t_limit
            r0 = self.cfg.submap.inter_submap_r_limit
            stable_index = 0
            for i in range(m):
                if fixed[i]:
                    stable_index = i
                    continue
                if self.submaps[i].stable:
                    t_lim[i], r_lim[i] = t0, r0
                    stable_index = i
                else:
                    k = i - stable_index
                    t_lim[i], r_lim[i] = k * t0, k * r0
            # adaptive cap: no node moves beyond the scale of the graph's
            # actual inconsistency
            max_rt, max_rr = self._graph_inconsistency(active)
            t_lim = np.minimum(t_lim, 2.0 * max_rt + 0.2)
            r_lim = np.minimum(r_lim, max_rr + 0.01)
            t_limit, r_limit = t_lim, r_lim

        mp = max(16, -(-m // 16) * 16)
        ep = max(32, -(-e // 32) * 32)
        node_t = np.concatenate([node_t, np.zeros((mp - m, 3), np.float32)])
        q_pad = np.zeros((mp - m, 4), np.float32)
        q_pad[:, 0] = 1.0
        node_q = np.concatenate([node_q, q_pad])
        fixed = np.concatenate([fixed, np.ones(mp - m, bool)])
        if t_limit is not None:
            t_limit = self._t(np.concatenate(
                [t_limit, np.zeros(mp - m, np.float32)]))
            r_limit = self._t(np.concatenate(
                [r_limit, np.zeros(mp - m, np.float32)]))
        edge_i = [ed.i for ed in active] + [0] * (ep - e)
        edge_j = [ed.j for ed in active] + [0] * (ep - e)
        edge_t = np.concatenate([edge_t, np.zeros((ep - e, 3), np.float32)])
        eq_pad = np.zeros((ep - e, 4), np.float32)
        eq_pad[:, 0] = 1.0
        edge_q = np.concatenate([edge_q, eq_pad])
        info = np.concatenate([info, np.broadcast_to(
            np.eye(6, dtype=np.float32), (ep - e, 6, 6))])
        edge_mask = np.concatenate([np.ones(e, bool), np.zeros(ep - e, bool)])
        dev = self.device
        return PoseGraph(
            node_t=self._t(node_t), node_q=self._t(node_q),
            edge_i=torch.tensor(edge_i, dtype=torch.int64, device=dev),
            edge_j=torch.tensor(edge_j, dtype=torch.int64, device=dev),
            edge_t=self._t(edge_t), edge_q=self._t(edge_q),
            edge_info=self._t(info),
            edge_mask=torch.as_tensor(edge_mask, device=dev),
            fixed=torch.as_tensor(fixed, device=dev),
            t_limit=t_limit, r_limit=r_limit), active

    def _graph_inconsistency(self, active) -> Tuple[float, float]:
        """Max (translation, rotation-rad) residual of the active edges at
        the CURRENT node poses — the scale of what a PGO could correct."""
        max_rt = 0.0
        max_rr = 0.0
        for ed in active:
            Ti = self.submaps[ed.i].pose
            Tj = self.submaps[ed.j].pose
            rel = np.linalg.inv(Ti) @ Tj
            dt_ = np.linalg.norm(rel[:3, 3] - ed.T[:3, 3])
            cR = np.clip((np.trace(ed.T[:3, :3].T @ rel[:3, :3]) - 1)
                         * 0.5, -1.0, 1.0)
            max_rt = max(max_rt, float(dt_))
            max_rr = max(max_rr, float(np.arccos(cR)))
        return max_rt, max_rr

    def optimize(self, extra_fixed=None) -> Optional[np.ndarray]:
        """PGO + wrong-edge veto (`graph_optimizer.cpp:713-754`).  On
        success updates the submap poses and returns them [S, 4, 4]."""
        s_cfg = self.cfg.submap
        graph, active = self.build_graph(extra_fixed)

        # consistency gate: when every edge already closes within the
        # configured floor there is nothing to correct
        max_rt, max_rr = self._graph_inconsistency(active)
        if (max_rt < s_cfg.pgo_min_inconsistency_tran
                and np.degrees(max_rr) < s_cfg.pgo_min_inconsistency_rot_deg):
            self.events.append(
                f"pgo: graph consistent (max residual {max_rt:.3f} m / "
                f"{np.degrees(max_rr):.2f} deg) — node update skipped")
            poses = np.stack([s.pose.copy() for s in self.submaps])
            # only nodes spanned by a loop (REG) edge earn "stable" here
            lo, hi = None, None
            for ed in active:
                if ed.kind == REG_EDGE:
                    a, b = sorted((ed.i, ed.j))
                    lo = a if lo is None else min(lo, a)
                    hi = b if hi is None else max(hi, b)
            if lo is not None:
                for s in self.submaps[lo:hi + 1]:
                    s.stable = True
            self.optimized = poses
            self.pgo_accepted += 1
            return poses
        # --pose_graph_optimization_method selects the solver
        # (`graph_optimizer.h:181-186`, `mulls_slam.cpp:597-613`):
        #   ceres — dense GN/LM + parameter bounds, on the device
        #   g2o   — block-sparse LM on the host (backend/sparse_pgo.py),
        #           anchors eliminated, Huber on every edge
        #   gtsam — matrix-free GN with preconditioned CG, on the device,
        #           warm-started from the current (last optimized) poses
        method = s_cfg.pose_graph_optimization_method.lower()
        mp = int(graph.node_t.shape[0])
        with trace.span("backend.pgo", timed=True) as sp:
            if method == "gtsam":
                graph = graph._replace(t_limit=None, r_limit=None)
                packed = optimize_and_check_cg(
                    graph, iterations=s_cfg.pgo_max_iter, robust_kernel=False,
                    tran_thre=s_cfg.wrong_edge_tran_thre,
                    rot_thre_deg=s_cfg.wrong_edge_rot_thre_deg).cpu().numpy()
                t = packed[:3 * mp].reshape(mp, 3)
                q = packed[3 * mp:7 * mp].reshape(mp, 4)
                bad = packed[7 * mp + 1:] > 0.5
            elif method == "g2o":
                from mulls_tpu_torch.backend.sparse_pgo import (
                    optimize_pose_graph_sparse, wrong_edge_check_np)
                a = {k: getattr(graph, k).cpu().numpy()
                     for k in ("node_t", "node_q", "edge_i", "edge_j",
                               "edge_t", "edge_q", "edge_info", "edge_mask",
                               "fixed")}
                # the reference's g2o path ignores equal_weight_on and
                # diagonal_information_matrix_on (kept for parity)
                t, q, _chi2 = optimize_pose_graph_sparse(
                    a["node_t"], a["node_q"], a["edge_i"], a["edge_j"],
                    a["edge_t"], a["edge_q"], a["edge_info"], a["fixed"],
                    edge_mask=a["edge_mask"],
                    iterations=s_cfg.pgo_max_iter, robust_kernel=True)
                bad = wrong_edge_check_np(
                    t, q, a["edge_i"], a["edge_j"], a["edge_t"], a["edge_q"],
                    a["edge_mask"], s_cfg.wrong_edge_tran_thre,
                    s_cfg.wrong_edge_rot_thre_deg)
            else:
                packed = optimize_and_check(
                    graph, iterations=s_cfg.pgo_max_iter,
                    equal_weight=s_cfg.equal_weight_on,
                    diagonal_information=s_cfg.diagonal_information_matrix_on,
                    robust_kernel=s_cfg.robust_kernel_on,
                    tran_thre=s_cfg.wrong_edge_tran_thre,
                    rot_thre_deg=s_cfg.wrong_edge_rot_thre_deg).cpu().numpy()
                t = packed[:3 * mp].reshape(mp, 3)
                q = packed[3 * mp:7 * mp].reshape(mp, 4)
                bad = packed[7 * mp + 1:] > 0.5
        self.timings["pgo"].append(sp.ms)
        reg_idx = [k for k, ed in enumerate(active) if ed.kind == REG_EDGE]
        n_bad_reg = int(bad[reg_idx].sum()) if reg_idx else 0
        n_reg = len(reg_idx)
        for k, ed in enumerate(active):
            if bad[k] and ed.kind == REG_EDGE:
                ed.kind = NONE_EDGE
        if n_reg == 0 or n_bad_reg == n_reg or \
                (n_bad_reg / max(n_reg, 1)) > s_cfg.wrong_edge_ratio_thre:
            return None  # optimization rejected
        m = len(self.submaps)
        t = np.asarray(t, np.float64)[:m]  # drop the padding
        R = _np_rotation_from_quat(np.asarray(q)[:m])
        poses = np.tile(np.eye(4), (m, 1, 1))
        poses[:, :3, :3] = R
        poses[:, :3, 3] = t
        for s, p in zip(self.submaps, poses):
            s.pose = p.copy()
            s.stable = True  # confirmed by PGO (`mulls_slam.cpp:620-621`)
            s.compute_bounds()
        self.optimized = poses
        self.pgo_accepted += 1
        return poses
