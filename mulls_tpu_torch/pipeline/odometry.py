"""The LiDAR odometry loop — port of ``mulls_tpu/pipeline/odometry.py``
(the reference's `mulls_slam` front-end loop, `test/mulls_slam.cpp:386-803`).

One step per frame:

    decode -> extract_features -> scan-to-map MULLS-ICP (warm-up s2s,
    in-frame retry, mover veto, yaw sweep) -> pose composition ->
    local-map update (dynamic removal, re-budget, periodic re-PCA)

The state (local map, pose, motion model) lives on the device between
frames.  Where the reference branches with ``lax.cond`` (warm-up s2s,
retry, veto, yaw sweep, refresh) the port takes a host ``if`` on a 0-d
tensor, one sync per decision; everything else stays masked selects on the
device.  Failure handling follows the reference (`mulls_slam.cpp:686-693`):
on a negative registration code the frame falls back to the motion-model
guess.

The step is written over leading batch dimensions: a state and a frame
with a leading ``[S]`` (:func:`stack_states`, ``StackedDraws``) step S
sequences in lockstep as one, every operation and kernel once for all S
(``parallel/multiseq.py``), each sequence with the bits of its step
alone.  The batched step takes its frame counter from the host
(``slam_step(..., frame=i)``): in lockstep it is the same for every
sequence, so the warm-up and refresh branches read no tensor.  The host
branches of the recovery ladder, the mover veto and the yaw sweep read
0-d tensors and run without a batch only (the multi-sequence config turns
them off, as the reference's does).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from mulls_tpu_torch.config import MullsConfig
from mulls_tpu_torch.core import se3
from mulls_tpu_torch.core.cloud import (FeatureCloud, FeatureFrame,
                                        PackedRawCloud, VertexDescriptors,
                                        pack_raw_host, unpack_raw)
from mulls_tpu_torch.core.batch import matmul, where
from mulls_tpu_torch.core.device import resolve_device
from mulls_tpu_torch.core.draws import Draws, GeneratorDraws, StackedDraws
from mulls_tpu_torch.core.tree import Struct, tree_map, tree_where
from mulls_tpu_torch.frontend.features import extract_features
from mulls_tpu_torch.frontend.icp import RegResult, mm_lls_icp
from mulls_tpu_torch.mapping.local_map import (LocalMap, init_local_map,
                                               refresh_linear_map_vectors,
                                               update_local_map)
from mulls_tpu_torch.ops.neighbors import nearest_neighbor_grouped


@dataclass
class SlamState(Struct):
    local_map: LocalMap
    pose: torch.Tensor  # [4,4] f32, lidar pose of the last processed frame
    T_prev: torch.Tensor  # [4,4] previous relative transform (motion model)
    frame_idx: torch.Tensor  # int32
    draws: Draws  # the reference's ``key``
    # previous frame's FULL feature clouds — present only when a
    # scan-to-scan registration can happen (see _carries_prev_frame)
    prev_frame: Optional[Dict[str, FeatureCloud]] = None
    # dynamic non-ground stochastic-downsample rate
    # (`update_parameters_self_adaptive`, `cfilter.hpp:2416-2444`)
    nonground_rate: Optional[torch.Tensor] = None
    # correspondence-gate widening for the NEXT frame after a failed
    # registration (`add_length`, `mulls_slam.cpp:650-657, 686-693`)
    add_length: Optional[torch.Tensor] = None
    # EMA of healthy-frame registration confidence; negative = unseeded
    conf_ema: Optional[torch.Tensor] = None
    # frames since the last HEALTHY registration
    model_age: Optional[torch.Tensor] = None


@dataclass
class StepOut(Struct):
    T_rel: torch.Tensor  # [4,4]
    pose: torch.Tensor  # [4,4]
    sigma: torch.Tensor
    code: torch.Tensor
    confidence: torch.Tensor
    iterations: torch.Tensor
    # everything above packed as one [16] f32 vector so a whole run's
    # results come back in a single device->host transfer
    vec: torch.Tensor

    @staticmethod
    def pack_vec(T_rel, sigma, code, confidence, iterations):
        return torch.cat([
            T_rel[..., :3, :].reshape(*T_rel.shape[:-2], 12),
            torch.stack([sigma, code.to(torch.float32), confidence,
                         iterations.to(torch.float32)], -1)], -1)

    @staticmethod
    def unpack_vecs(vecs: np.ndarray):
        """[N,16] -> (T_rels [N,4,4] f64, sigmas [N], codes [N], conf [N],
        iters [N])."""
        n = vecs.shape[0]
        T = np.tile(np.eye(4), (n, 1, 1))
        T[:, :3, :] = vecs[:, :12].reshape(n, 3, 4).astype(np.float64)
        return (T, vecs[:, 12].astype(np.float64),
                vecs[:, 13].astype(np.int32), vecs[:, 14].astype(np.float64),
                vecs[:, 15].astype(np.int32))


def _carries_prev_frame(cfg: MullsConfig) -> bool:
    """The previous frame's FULL feature clouds ride the state when any
    scan-to-scan registration can happen: the s2s module, or the
    reference's always-on warm-up (`mulls_slam.cpp:631`)."""
    return (cfg.map.scan_to_scan_module_on
            or cfg.map.initial_scan2scan_frame_num > 0)


def _scalar(v, dtype, device) -> torch.Tensor:
    return torch.tensor(v, dtype=dtype, device=device)


def init_state(cfg: MullsConfig, device="cuda",
               draws: Optional[Draws] = None) -> SlamState:
    """The run's starting state on ``device``; production ``draws`` come
    from a ``torch.Generator`` seeded from ``cfg.seed``."""
    dev = resolve_device(device)
    prev = None
    if _carries_prev_frame(cfg):
        s = cfg.shapes
        # FULL-capacity classes: s2s registers the new frame's down clouds
        # against the previous frame's full feature sets
        prev = {
            "ground": FeatureCloud.empty(s.n_ground_full, dev),
            "pillar": FeatureCloud.empty(s.n_pillar_full, dev),
            "facade": FeatureCloud.empty(s.n_facade_full, dev),
            "beam": FeatureCloud.empty(s.n_beam_full, dev),
            "roof": FeatureCloud.empty(s.n_roof_full, dev),
            "vertex": FeatureCloud.empty(
                max(1, cfg.feature.vertex_keep_num), dev),
        }
    return SlamState(
        local_map=init_local_map(cfg.map, dev),
        pose=torch.eye(4, dtype=torch.float32, device=dev),
        T_prev=torch.eye(4, dtype=torch.float32, device=dev),
        frame_idx=_scalar(0, torch.int32, dev),
        draws=draws if draws is not None else GeneratorDraws(cfg.seed, dev),
        prev_frame=prev,
        nonground_rate=_scalar(float(cfg.ground.gf_nonground_down_rate),
                               torch.float32, dev),
        add_length=_scalar(0.0, torch.float32, dev),
        conf_ema=_scalar(-1.0, torch.float32, dev),
        model_age=_scalar(99, torch.int32, dev),
    )


def stack_states(states: List[SlamState]) -> SlamState:
    """S states as one batched state: every tensor stacked on a new leading
    axis, the draws as one ``StackedDraws`` (each sequence keeps its own
    stream).  Port of the reference's ``stack_states``
    (``mulls_tpu/parallel/multiseq.py:48-49``)."""
    draws = StackedDraws([st.draws for st in states])
    bare = [st.replace(draws=None) for st in states]
    stacked = tree_map(lambda *xs: torch.stack(xs), *bare)
    return stacked.replace(draws=draws)


def state_from_numpy(tree: dict, cfg: MullsConfig, device="cuda",
                     draws: Optional[Draws] = None) -> SlamState:
    """The port's ``SlamState`` from the reference's ``SlamState``
    converted leaf by leaf to numpy arrays: a dict with the fields of
    ``SlamState`` (``local_map`` -> ``clouds`` -> class -> cloud fields,
    ``vertex_desc``; ``pose``, ``T_prev``, ``frame_idx``, ``prev_frame``
    (or None), ``nonground_rate``, ``add_length``, ``conf_ema``,
    ``model_age``).  The reference's key is not carried: ``draws`` stands
    in for it (default: a generator seeded from ``cfg.seed``).  Floating
    leaves land as float32, masks as bool, counters as int32."""
    dev = resolve_device(device)

    def t(a):
        a = np.array(a)  # a writable copy of the caller's array
        if a.dtype == np.bool_:
            return torch.as_tensor(a, device=dev)
        if np.issubdtype(a.dtype, np.integer):
            return torch.as_tensor(a.astype(np.int32), device=dev)
        return torch.as_tensor(a.astype(np.float32), device=dev)

    def cloud(d):
        return FeatureCloud(**{k: t(d[k]) for k in (
            "xyz", "normal", "intensity", "strength", "height", "ts_ratio",
            "mask")})

    lm = tree["local_map"]
    local_map = LocalMap(
        clouds={n: cloud(c) for n, c in lm["clouds"].items()},
        vertex_desc=VertexDescriptors(vec=t(lm["vertex_desc"]["vec"]),
                                      mask=t(lm["vertex_desc"]["mask"])))
    prev = tree.get("prev_frame")
    return SlamState(
        local_map=local_map, pose=t(tree["pose"]), T_prev=t(tree["T_prev"]),
        frame_idx=t(tree["frame_idx"]),
        draws=draws if draws is not None else GeneratorDraws(cfg.seed, dev),
        prev_frame=({n: cloud(c) for n, c in prev.items()}
                    if prev is not None else None),
        nonground_rate=t(tree["nonground_rate"]),
        add_length=t(tree["add_length"]), conf_ema=t(tree["conf_ema"]),
        model_age=t(tree["model_age"]))


def _feature_stage(state: SlamState, raw, cfg: MullsConfig, k_feat: Draws):
    """Stage 1: decode + motion-comp prep + extract_semantic_pts +
    self-adaptive parameter update."""
    if isinstance(raw, PackedRawCloud):
        raw = unpack_raw(raw)

    # motion compensation (`cfilter.hpp:412-549`, `mulls_slam.cpp:704-715`)
    if cfg.map.motion_compensation_method > 0:
        from mulls_tpu_torch.ops import motion
        s = (motion.timestamp_ratio_from_azimuth(raw.xyz, raw.mask)
             if cfg.map.motion_compensation_method == 2 else raw.ts_ratio)
        if cfg.map.motion_compensation_timing == "pre":
            xyz_u = motion.undistort(raw.xyz, s, raw.mask, state.T_prev)
            raw = raw.replace(xyz=xyz_u, ts_ratio=s)
        else:
            raw = raw.replace(ts_ratio=s)

    frame = extract_features(
        raw, cfg, k_feat,
        nonground_rate=(state.nonground_rate
                        if cfg.feature.adaptive_parameters_on else None))

    # self-adaptive parameter update (`cfilter.hpp:2416-2444`)
    ng_rate = state.nonground_rate
    if cfg.feature.adaptive_parameters_on:
        ng_count = (torch.sum(frame.down["facade"].mask, -1)
                    + torch.sum(frame.down["pillar"].mask, -1)
                    ).to(torch.float32)
        min_exp = float(cfg.feature.adaptive_nonground_min_expected)
        lowered = torch.clamp(ng_rate - min_exp
                              / torch.clamp(ng_count, min=1.0), min=1.0)
        ng_rate = torch.where(ng_count < min_exp, lowered, ng_rate)
    return frame, ng_rate


def _fractional_step(T_base: torch.Tensor, T_full: torch.Tensor,
                     inv_n: torch.Tensor) -> torch.Tensor:
    """``T_base (+) frac(delta)`` where ``delta = T_base^-1 T_full`` with its
    rotation angle and translation scaled by ``inv_n`` (screw-motion
    interpolation of a blackout-spanning re-acquisition step)."""
    delta = se3.inverse(T_base) @ T_full
    R = delta[:3, :3]
    theta = se3.rotation_angle(R)
    w = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]])
    axis = w / torch.clamp(2.0 * torch.sin(theta), min=1e-6)
    R_f = se3.so3_exp(axis * theta * inv_n)
    delta_f = torch.eye(4, dtype=torch.float32, device=T_base.device)
    delta_f[:3, :3] = R_f
    delta_f[:3, 3] = delta[:3, 3] * inv_n
    return T_base @ delta_f


def _register_stage(state: SlamState, frame: FeatureFrame, cfg: MullsConfig,
                    frame_no: Optional[int] = None):
    """Stage 2: scan-to-scan + scan-to-map MULLS-ICP with cadence, in-frame
    retry, mover veto, yaw re-acquisition, recovery bookkeeping, pose
    composition (reference `odometry.py:219-602`).  ``frame_no``: the
    host's frame counter, which the warm-up branch reads in place of
    ``state.frame_idx`` when given."""
    dev = state.pose.device
    f32 = torch.float32
    lead = tuple(state.pose.shape[:-2])
    eye = torch.eye(4, dtype=f32, device=dev).expand(*lead, 4, 4)
    first = state.frame_idx == 0
    if cfg.map.initial_guess_mode == 2:
        guess = state.T_prev
    elif cfg.map.initial_guess_mode == 1:
        guess = eye.clone()
        guess[..., :3, 3] = state.T_prev[..., :3, 3]
    else:
        guess = eye
    guess0 = guess  # raw motion-model prior (pre-s2s) for the sanity veto

    warm = state.frame_idx <= cfg.map.initial_scan2scan_frame_num
    s2s = None
    if cfg.map.scan_to_scan_module_on:
        s2s = mm_lls_icp(frame.down, state.prev_frame, cfg.reg, guess,
                         max_iter=cfg.reg.reg_max_iter_num_s2s,
                         dis_thre_add=state.add_length)
        guess = where(s2s.process_code == 1, s2s.transform, guess)
        s2m_add = torch.where(s2s.process_code == 1, 1.0, 0.8)
    elif _carries_prev_frame(cfg) and cfg.map.warmup_s2s_on:
        # the reference's always-on warm-up s2s for the first frames
        # (`mulls_slam.cpp:631`); its lax.cond is a host branch here, on
        # the host's frame counter when the caller keeps one
        if (frame_no <= cfg.map.initial_scan2scan_frame_num
                if frame_no is not None else bool(warm)):
            s2s = mm_lls_icp(frame.down, state.prev_frame, cfg.reg, guess,
                             max_iter=cfg.reg.reg_max_iter_num_s2s,
                             dis_thre_add=state.add_length + 1.0)
        else:
            s2s = RegResult.not_run(guess)
        s2m_add = state.add_length
    else:
        s2m_add = state.add_length

    res = mm_lls_icp(frame.down, state.local_map.clouds, cfg.reg, guess,
                     max_iter=cfg.reg.reg_max_iter_num_s2m,
                     dis_thre_add=s2m_add)

    # scan-to-map cadence (`mulls_slam.cpp:631,667`)
    have_s2s = (cfg.map.scan_to_scan_module_on
                or (_carries_prev_frame(cfg) and cfg.map.warmup_s2s_on))
    cadence_sel = torch.zeros((), dtype=torch.bool, device=dev)
    if have_s2s and (cfg.map.s2m_frequency > 1
                     or cfg.map.initial_scan2scan_frame_num > 0):
        idx = state.frame_idx
        use_s2s = ((idx <= cfg.map.initial_scan2scan_frame_num)
                   | (idx % cfg.map.s2m_frequency != 0))
        cadence_sel = use_s2s & (s2s.process_code == 1)
        res = res.replace(
            transform=where(cadence_sel, s2s.transform, res.transform),
            sigma=torch.where(cadence_sel, s2s.sigma, res.sigma),
            process_code=torch.where(cadence_sel, s2s.process_code,
                                     res.process_code),
            confidence=torch.where(cadence_sel, s2s.confidence,
                                   res.confidence),
            iterations=torch.where(cadence_sel, s2s.iterations,
                                   res.iterations))

    # confidence baseline: EMA of healthy-frame confidence
    ema = state.conf_ema
    baseline = torch.where(ema < 0.0, res.confidence, ema)

    def _suspect(r):
        return (r.process_code < 0) | (
            r.confidence < cfg.map.add_length_confidence_drop * baseline)

    # in-frame retry through a WIDER gate than the first attempt
    if cfg.map.inframe_recovery_on:
        suspect0 = _suspect(res) & ~cadence_sel
        if bool(suspect0):
            retry = mm_lls_icp(frame.down, state.local_map.clouds, cfg.reg,
                               guess, max_iter=cfg.reg.reg_max_iter_num_s2m,
                               dis_thre_add=s2m_add + 1.0)
            take = ((retry.process_code == 1)
                    & (retry.confidence > res.confidence))
            res = tree_where(take, retry, res)

    # --- moving-object sanity veto + source-cleaned re-registration
    # (reference `odometry.py:336-463`)
    sanity_thre = cfg.map.dynamic_step_sanity_thre
    if (cfg.map.map_based_dynamic_removal_on and sanity_thre > 0
            and cfg.map.initial_guess_mode == 2
            and cfg.map.dynamic_sanity_veto_on):
        model_warm = ((state.frame_idx
                       > cfg.map.initial_scan2scan_frame_num + 1)
                      & (state.model_age <= 3))
        dev0 = torch.linalg.norm(res.transform[:3, 3] - guess0[:3, 3])
        suspect_dyn = (model_warm & (res.process_code == 1)
                       & (dev0 > sanity_thre))
        dyn_gate2 = float(np.float32(cfg.map.dynamic_dist_thre_min)) ** 2
        dyn_gate2 = torch.full((), dyn_gate2, dtype=f32, device=dev)

        if bool(suspect_dyn):
            # hypothesis test (observability-weighted map support of the
            # deviant solve vs the prior) + mover-cleaned re-registration
            du = res.transform[:3, 3] - guess0[:3, 3]
            dev_ = torch.linalg.norm(du)
            u = du / torch.clamp(dev_, min=1e-6)
            sup_gate2 = torch.clamp((0.5 * dev_) ** 2, min=dyn_gate2,
                                    max=9.0 * dyn_gate2)
            sup_res = torch.tensor(0.0, device=dev)
            sup_prior = torch.tensor(0.0, device=dev)
            # map distances of every class under the prior and of the
            # support classes under the deviant solve, in one grouped call
            names = list(frame.down)
            sup_names = [n for n in names
                         if n in ("pillar", "facade", "beam", "vertex")]
            maps = state.local_map.clouds
            found = nearest_neighbor_grouped(
                [(se3.transform_points(pose, frame.down[n].xyz),
                  frame.down[n].mask, maps[n].xyz, maps[n].mask)
                 for pose, group in ((guess0, names),
                                     (res.transform, sup_names))
                 for n in group])
            d2p = {n: d2 for n, (_, d2) in zip(names, found)}
            d2r = {n: d2 for n, (_, d2) in zip(sup_names, found[len(names):])}
            cleaned = {}
            for name, c in frame.down.items():
                cleaned[name] = c.replace(
                    mask=c.mask & (d2p[name] < dyn_gate2))
                if name in d2r:
                    a = torch.abs(se3.rotate_vectors(guess0, c.normal) @ u)
                    if name == "facade":
                        w = a
                    elif name == "vertex":
                        w = torch.ones_like(a)
                    else:  # pillar/beam: axis direction in `normal`
                        w = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0))
                    sup_res = sup_res + torch.sum(
                        w * (c.mask & (d2r[name] < sup_gate2)))
                    sup_prior = sup_prior + torch.sum(
                        w * (c.mask & (d2p[name] < sup_gate2)))
            res2 = mm_lls_icp(cleaned, state.local_map.clouds, cfg.reg,
                              guess0, max_iter=cfg.reg.reg_max_iter_num_s2m,
                              dis_thre_add=s2m_add)
        else:
            sup_res = sup_prior = torch.zeros((), device=dev)
            res2 = res
        # the deviant solve explains clearly more static structure than the
        # prior: the platform genuinely moved — the original result stands
        genuine = suspect_dyn & (sup_res > 1.2 * sup_prior + 5)
        dev2 = torch.linalg.norm(res2.transform[:3, 3] - guess0[:3, 3])
        take2 = (suspect_dyn & ~genuine & (res2.process_code == 1)
                 & (dev2 <= sanity_thre)
                 & (res2.confidence >= 0.5 * res.confidence))
        res = tree_where(take2, res2, res)
        # still deviant after cleaning: hold the motion model (code -4)
        veto = suspect_dyn & ~genuine & ~take2
        res = res.replace(process_code=torch.where(
            veto, -4, res.process_code).to(torch.int32))
        guess = torch.where(veto, guess0, guess)

    # --- rotation-tolerant post-blackout re-acquisition (reference
    # `odometry.py:465-523`; keyed on inframe_recovery_on like the
    # reference)
    reacq_taken = torch.zeros((), dtype=torch.bool, device=dev)
    if (cfg.map.inframe_recovery_on and cfg.map.yaw_reacquire_on
            and cfg.map.initial_guess_mode == 2
            and cfg.map.yaw_reacquire_step_d > 0):
        dark = ((state.model_age >= cfg.map.yaw_reacquire_blackout)
                & ~first & ~warm & ~cadence_sel)
        need = dark & (res.process_code != 1)
        step_d = float(cfg.map.yaw_reacquire_step_d)
        n_side = max(int(round(cfg.map.yaw_reacquire_range_d / step_d)), 1)
        yaws = [np.radians(k * step_d)
                for k in range(-n_side, n_side + 1) if k != 0]
        trials = [(y, s) for s in (1.0, 1.0 / 3.0)
                  for y in ([0.0] if s != 1.0 else []) + yaws]
        if bool(need):
            best_score, rec = None, None
            for yaw, sc in trials:
                yaw_t = torch.tensor(yaw, dtype=f32, device=dev)
                zero = torch.zeros((), dtype=f32, device=dev)
                Rz = se3.make_transform(torch.zeros(3, dtype=f32, device=dev),
                                        torch.stack([zero, zero, yaw_t]))
                init = guess0.clone()
                init[:3, 3] = init[:3, 3] * torch.tensor(sc, dtype=f32)
                r = mm_lls_icp(frame.down, state.local_map.clouds, cfg.reg,
                               init @ Rz,
                               max_iter=cfg.reg.reg_max_iter_num_s2m,
                               dis_thre_add=s2m_add + 1.0)
                score = torch.where(
                    r.process_code == 1,
                    r.confidence / torch.clamp(r.sigma, min=1e-4), -1.0)
                if rec is None:
                    best_score, rec = score, r
                else:  # argmax: the first best trial wins ties
                    better = score > best_score
                    best_score = torch.where(better, score, best_score)
                    rec = tree_where(better, r, rec)
        else:
            rec = res
        reacq_taken = (need & (rec.process_code == 1)
                       & (rec.confidence >= 0.5 * baseline))
        res = tree_where(reacq_taken, rec, res)

    failed = res.process_code < 0
    low_conf = res.confidence < cfg.map.add_length_confidence_drop * baseline
    # frame 0 registers against an EMPTY map; `first` arms the cold-start
    # widening for frame 1 (`mulls_slam.cpp:391`)
    add_next = torch.where(first | failed | low_conf | reacq_taken, 1.0,
                           0.0).to(f32)
    healthy = (res.process_code == 1) & ~first
    # baseline adaptation: fast EMA on normal healthy frames, slow EMA on
    # low-confidence healthy frames
    ema_next = torch.where(
        healthy,
        torch.where(ema < 0.0, res.confidence,
                    torch.where(low_conf,
                                0.98 * ema + 0.02 * res.confidence,
                                0.9 * ema + 0.1 * res.confidence)),
        ema)
    T_rel = where(first, eye, where(failed, guess, res.transform))
    if cfg.map.zupt_on:
        # zero-velocity update (`common_nav.cpp:6-22`)
        stationary = (torch.linalg.norm(T_rel[..., :3, 3], dim=-1)
                      < cfg.map.zupt_tran_thre)
        T_z = T_rel.clone()
        T_z[..., 2, 3] = 0.0
        T_rel = where(stationary, T_z, T_rel)
    # the model PERSISTS through failures (T_rel is then the prior itself)
    T_prev_next = where(first, eye, T_rel)
    model_age_next = torch.where(res.process_code == 1, 0,
                                 state.model_age + 1).to(torch.int32)
    # a re-acquired step hands the next frame `prior (+) correction/n` and
    # marks the model cold (reference `odometry.py:563-585`)
    if (cfg.map.inframe_recovery_on and cfg.map.yaw_reacquire_on
            and cfg.map.initial_guess_mode == 2):
        n = torch.clamp(state.model_age.to(f32), min=1.0)
        T_model = _fractional_step(guess0, T_rel, 1.0 / n)
        T_model[:3, 3] = T_rel[:3, 3]
        T_prev_next = torch.where(reacq_taken, T_model, T_prev_next)
        model_age_next = torch.where(reacq_taken, 4,
                                     model_age_next).to(torch.int32)

    pose = matmul(state.pose, T_rel)
    pose[..., :3, :3] = se3.orthonormalize(pose[..., :3, :3])

    # dynamic-object gate distance scales with per-frame motion
    # (`mulls_slam.cpp:439`); floored in update_local_map
    dyn_max = 1.5 * torch.linalg.norm(T_rel[..., :3, 3], dim=-1)
    removal_ok = (~failed) & (
        res.confidence >= cfg.map.dynamic_removal_confidence_drop * baseline)
    code = torch.where(first, 1, res.process_code).to(torch.int32)
    out = StepOut(T_rel=T_rel, pose=pose, sigma=res.sigma, code=code,
                  confidence=res.confidence, iterations=res.iterations,
                  vec=StepOut.pack_vec(T_rel, res.sigma, code,
                                       res.confidence, res.iterations))
    return (out, T_prev_next, add_next, ema_next, dyn_max, removal_ok,
            model_age_next)


def _gate_append(cfg: MullsConfig, out: StepOut):
    """Append gate for VETOED frames only (code -4, a mover-capture hold);
    ordinary failures still append like the reference (keyed on
    inframe_recovery_on like the reference, `odometry.py:615`)."""
    if (cfg.map.inframe_recovery_on and cfg.map.yaw_reacquire_on
            and cfg.map.initial_guess_mode == 2):
        return out.code != -4
    return True


def _map_stage(state: SlamState, frame: FeatureFrame, T_rel, dyn_max,
               removal_ok, cfg: MullsConfig, k_map: Draws, append_ok=True,
               frame_no: Optional[int] = None):
    """Stage 3: dynamic removal + local-map append/crop/rebudget + periodic
    direction-vector refresh (`mulls_slam.cpp:431-435`), on the host's
    frame counter ``frame_no`` when the caller keeps one."""
    local_map = update_local_map(state.local_map, frame, T_rel, dyn_max,
                                 cfg.map, k_map, removal_enabled=removal_ok,
                                 append_enabled=append_ok)
    freq = cfg.map.local_map_recalculation_frequency
    if frame_no is None:
        frame_no = int(state.frame_idx)
    if 0 < freq < 99999 and (frame_no + 1) % freq == 0:
        local_map = refresh_linear_map_vectors(local_map)
    return local_map


def _undistort_frame(frame: FeatureFrame, T_rel, cfg: MullsConfig
                     ) -> FeatureFrame:
    """Post-registration motion compensation (`mulls_slam.cpp:704-715`):
    undistort the registered frame's feature clouds with the MEASURED
    frame-to-frame transform before they are appended / handed on."""
    if not (cfg.map.motion_compensation_method > 0
            and cfg.map.motion_compensation_timing == "post"):
        return frame
    from mulls_tpu_torch.ops import motion

    def und(c):
        return c.replace(xyz=motion.undistort(c.xyz, c.ts_ratio, c.mask,
                                              T_rel))

    return frame.replace(down={k: und(c) for k, c in frame.down.items()},
                         full={k: und(c) for k, c in frame.full.items()})


def slam_step(state: SlamState, raw, cfg: MullsConfig, timer=None,
              frame: Optional[int] = None):
    """One frame: (new state, StepOut).  ``raw`` is a ``PackedRawCloud`` or
    a ``RawCloud`` on the state's device (both batched, ``[S, ...]``, for a
    batched state).  ``timer(name)``, when given, is a context manager
    wrapped around the feature / reg / map stages.  ``frame``: the host's
    count of the frames the state has stepped (``state.frame_idx``, which
    the warm-up and refresh branches then do not read back)."""
    span = timer if timer is not None else (
        lambda name: contextlib.nullcontext())
    k_next, k_feat, k_map = state.draws.split(3)
    with span("feature"):
        feats, ng_rate = _feature_stage(state, raw, cfg, k_feat)
    with span("reg"):
        (out, T_prev_next, add_next, ema_next, dyn_max,
         removal_ok, model_age_next) = _register_stage(state, feats, cfg,
                                                       frame_no=frame)
    with span("map"):
        feats = _undistort_frame(feats, out.T_rel, cfg)
        local_map = _map_stage(state, feats, out.T_rel, dyn_max, removal_ok,
                               cfg, k_map, append_ok=_gate_append(cfg, out),
                               frame_no=frame)
    new_state = SlamState(
        local_map=local_map, pose=out.pose, T_prev=T_prev_next,
        frame_idx=state.frame_idx + 1, draws=k_next,
        prev_frame=feats.full if _carries_prev_frame(cfg) else None,
        nonground_rate=ng_rate, add_length=add_next, conf_ema=ema_next,
        model_age=model_age_next)
    return new_state, out


@dataclass
class OdometryResult:
    poses: np.ndarray  # [N, 4, 4] f64, LiDAR frame, pose[0] = I
    codes: List[int] = field(default_factory=list)
    sigmas: List[float] = field(default_factory=list)
    timings: Optional[np.ndarray] = None  # [N, 4] ms (feat/map/reg/loop)


def _frames_of_segment(k: int, batch: dict, with_ts: bool, pin: bool,
                       device: torch.device):
    """The first ``k`` frames of a native packed segment
    (``io/native.py::PackedSegmentPrefetcher``): one upload of the whole
    batch, then a ``PackedRawCloud`` view per frame."""
    packed = PackedRawCloud(
        xyz_q=torch.from_numpy(batch["xyz_q"]),
        intensity_q=torch.from_numpy(batch["intensity_q"]),
        ts_q=(torch.from_numpy(batch["ts_q"].astype(np.int32))
              if with_ts else None),
        n=torch.from_numpy(batch["n"]))
    if pin:
        packed = packed.pin_memory()
    packed = packed.to(device, non_blocking=pin)
    return [tree_map(lambda a, j=j: a[j], packed) for j in range(k)]


def prefetch_frames(dataset, device: torch.device, depth: int = 4,
                    with_ts: bool = True, segment: int = 16):
    """Threaded host pipeline: read -> pack -> upload, ``depth`` frames
    ahead of the consumer so disk decode and the host-to-device copy
    overlap device compute.  Yields packed frames on ``device``.  A dataset
    with ``packed_segments`` (the native reader of ``io/dataset.py``)
    hands over ``segment`` frames at a time already packed by its C++
    workers."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    pin = device.type == "cuda"
    native = (dataset.packed_segments(segment)
              if hasattr(dataset, "packed_segments") else None)

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            if native is not None:
                with native:
                    for k, batch in native:
                        for frame in _frames_of_segment(k, batch, with_ts,
                                                        pin, device):
                            if not put(frame):
                                return
                put(None)
                return
            it = iter(dataset) if hasattr(dataset, "__iter__") \
                else (dataset[i] for i in range(len(dataset)))
            for frame in it:
                packed = pack_raw_host(frame, with_ts=with_ts)
                if pin:
                    packed = packed.pin_memory()
                if not put(packed.to(device, non_blocking=pin)):
                    return
            put(None)
        except BaseException as e:  # surfaced in the consumer
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=5.0)


def results_from_vecs(vecs: np.ndarray, timings=None) -> OdometryResult:
    """The run's poses (each frame's T_rel chained onto the last pose,
    re-orthonormalized in float64), codes and sigmas from its packed
    [N, 16] step vectors."""
    n = vecs.shape[0]
    T_rels, sig, cod, _, _ = StepOut.unpack_vecs(vecs)
    poses = np.tile(np.eye(4), (n, 1, 1))
    for i in range(1, n):
        # re-orthonormalize in f64 to keep long compositions clean
        p = poses[i - 1] @ T_rels[i]
        u, _, vt = np.linalg.svd(p[:3, :3])
        p[:3, :3] = u @ vt
        poses[i] = p
    return OdometryResult(poses=poses, codes=[int(c) for c in cod],
                          sigmas=[float(s) for s in sig], timings=timings)


class OdometryPipeline:
    """Streaming runner: frames run through :func:`slam_step` in segments
    of ``segment`` frames while a host thread packs and uploads ahead;
    per-frame results stay on the device and come back in one transfer
    per segment."""

    def __init__(self, cfg: MullsConfig, segment: int = 16, device="cuda",
                 draws: Optional[Draws] = None):
        self.cfg = cfg
        self.segment = segment
        self.device = resolve_device(device)
        self.draws = draws

    def run(self, dataset, progress: bool = False,
            profile: bool = False) -> OdometryResult:
        """``profile=True`` records per-frame feature / map / reg stage
        times in ms (the reference's timing report columns,
        `mulls_slam.cpp:805-827`), with a device sync around each stage."""
        cfg = self.cfg
        dev = self.device
        n = len(dataset)
        state = init_state(cfg, dev, draws=self.draws)
        timings = np.zeros((n, 4), np.float64) if profile else None
        ship_ts = cfg.map.motion_compensation_method == 1
        vec_parts: List[np.ndarray] = []
        pending: List[torch.Tensor] = []

        spans: Dict[str, float] = {}

        @contextlib.contextmanager
        def timer(name):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            yield
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            spans[name] = (time.perf_counter() - t0) * 1e3

        col = {"feature": 0, "map": 1, "reg": 2}
        for i, raw in enumerate(prefetch_frames(dataset, dev,
                                                with_ts=ship_ts,
                                                segment=self.segment)):
            state, out = slam_step(state, raw, cfg,
                                   timer=timer if profile else None, frame=i)
            pending.append(out.vec)
            if profile:
                for name, ms in spans.items():
                    timings[i, col[name]] = ms
            if len(pending) == self.segment or i == n - 1:
                vec_parts.append(torch.stack(pending).cpu().numpy())
                pending = []
                if progress:
                    print(f"[{i + 1}/{n}] frames done", flush=True)

        vecs = (np.concatenate(vec_parts) if vec_parts
                else np.zeros((0, 16), np.float32))
        return results_from_vecs(vecs, timings)
