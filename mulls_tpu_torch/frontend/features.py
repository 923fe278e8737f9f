"""Per-frame feature extraction — port of
``mulls_tpu/frontend/features.py`` (the reference's `extract_semantic_pts`,
`cfilter.hpp:2295-2413`, orchestrating `fast_ground_filter`,
`get_pc_pca_feature`, `classify_nground_pts`, `encode_stable_points`,
`non_max_suppress` and the fixed-num budgets).

  raw [N_raw] -> unground [20k] --PCA--> class masks -> full clouds
  (budgeted compaction) -> NMS + sector-balanced budgets -> down clouds

Shapes are static and every cloud is a fixed-capacity masked tensor; the
draws follow the reference's key tree (``draws.split(16)``, one child per
site) so a replayed key tree reproduces its numbers.  A raw cloud with a
leading batch dimension (``[S, N, 3]``, with :class:`StackedDraws`) is S
frames extracted as one: every operation and kernel runs once for all S,
and each frame gets the features of its call alone.
"""

from __future__ import annotations

import math

import torch

from mulls_tpu_torch.config import MullsConfig
from mulls_tpu_torch.core.batch import put, take
from mulls_tpu_torch.core.cloud import (FeatureCloud, FeatureFrame, RawCloud,
                                        VertexDescriptors,
                                        compact_topk_random,
                                        compact_topk_score, masked_max,
                                        masked_min)
from mulls_tpu_torch.core.draws import Draws
from mulls_tpu_torch.ops import ground as ground_ops
from mulls_tpu_torch.ops import neighbors as nbr
from mulls_tpu_torch.ops import nms as nms_ops
from mulls_tpu_torch.ops import pca as pca_ops
from mulls_tpu_torch.ops import voxel as voxel_ops


def _gather_cloud(xyz, normal, intensity, strength, height, ts, mask,
                  capacity, draws: Draws) -> FeatureCloud:
    idx, valid = compact_topk_random(mask, capacity,
                                     draws.uniform(mask.shape))
    return FeatureCloud(
        xyz=take(xyz, idx), normal=take(normal, idx),
        intensity=take(intensity, idx), strength=take(strength, idx),
        height=take(height, idx), ts_ratio=take(ts, idx), mask=valid)


def extract_features(raw: RawCloud, cfg: MullsConfig, draws: Draws,
                     nonground_rate=None) -> FeatureFrame:
    pre = cfg.preprocess
    gcfg = cfg.ground
    fcfg = cfg.feature
    shapes = cfg.shapes
    dev = raw.xyz.device
    lead = tuple(raw.xyz.shape[:-2])
    keys = draws.split(16)

    # --- pre-filtering (`mulls_slam.cpp:404-407`, `cfilter.hpp:2331-2343`)
    mask = raw.mask
    if pre.vertical_ang_calib_on and pre.vertical_ang_correction_deg != 0.0:
        from mulls_tpu_torch.ops.motion import vertical_intrinsic_calibration
        raw = raw.replace(xyz=vertical_intrinsic_calibration(
            raw.xyz, pre.vertical_ang_correction_deg))
    if pre.apply_dist_filter:
        mask = voxel_ops.dist_filter_mask(raw.xyz, mask, pre.min_dist_used,
                                          pre.max_dist_used)
    if pre.apply_scanner_filter:
        mask = voxel_ops.scanner_filter_mask(raw.xyz, mask,
                                             pre.scanner_self_radius,
                                             pre.underground_height_thre)
    if pre.cloud_down_res > 0:
        mask = mask & voxel_ops.voxel_downsample_mask(raw.xyz, mask,
                                                      pre.cloud_down_res)

    # --- Semantic-KITTI moving-object / outlier pre-filter
    # (`cfilter.hpp:2487-2504`: labels >= 250 move, 1 is 'outlier')
    semantic = fcfg.semantic_assist_on and raw.label is not None
    if semantic:
        mask = mask & (raw.label < 250) & (raw.label != 1)

    # --- ground / unground split (`cfilter.hpp:1658-2036`)
    g = ground_ops.fast_ground_filter(
        raw.xyz, raw.intensity, mask, gcfg, shapes, keys[0],
        fixed_num_downsampling=fcfg.fixed_num_downsampling_on,
        nonground_rate=nonground_rate)

    # --- ROI filter: delete the y band from the unground cloud
    # (`cfilter.hpp:2367-2374`)
    is_unground = g.is_unground
    if pre.apply_roi_filter:
        in_band = ((raw.xyz[..., 1] > pre.roi_min_y)
                   & (raw.xyz[..., 1] < pre.roi_max_y))
        is_unground = is_unground & ~in_band

    # --- compact the unground set to the PCA budget
    ug_idx, ug_valid = compact_topk_random(
        is_unground, shapes.n_unground, keys[1].uniform(is_unground.shape))
    ug_xyz = take(raw.xyz, ug_idx)
    ug_int = take(raw.intensity, ug_idx)
    ug_ts = take(raw.ts_ratio, ug_idx)
    ug_h = take(g.height, ug_idx)

    # --- neighborhood PCA (`pca.hpp:294-354`) on the first n_q rows of the
    # random compaction (the reference's pca_down_rate query stride), in
    # Morton order
    n_q = shapes.n_unground // max(fcfg.pca_down_rate, 1)
    qo = pca_ops.morton_order(ug_xyz[..., :n_q, :])
    q_xyz = take(ug_xyz[..., :n_q, :], qo)
    q_valid = take(ug_valid[..., :n_q], qo)
    q_int = take(ug_int[..., :n_q], qo)
    q_ts = take(ug_ts[..., :n_q], qo)
    q_h = take(ug_h[..., :n_q], qo)
    feats = pca_ops.pca_features(
        q_xyz, q_valid, ug_xyz, ug_valid,
        radius=fcfg.cloud_pca_neigh_r, min_k=fcfg.cloud_pca_neigh_k_min,
        distance_adaptive=fcfg.use_distance_adaptive_pca,
        unit_dist=fcfg.unit_dist)

    # --- classification (`cfilter.hpp:2102-2168`)
    sin_pillar = math.sin(math.radians(fcfg.pillar_direction_ang))
    sin_beam = math.sin(math.radians(fcfg.beam_direction_ang))
    sin_facade = math.sin(math.radians(fcfg.facade_normal_ang))
    sin_roof = math.sin(math.radians(fcfg.roof_normal_ang))

    pz = torch.abs(feats.principal[..., 2])
    nz = torch.abs(feats.normal[..., 2])
    z = q_xyz[..., 2]
    linear = feats.valid & (feats.linearity > fcfg.linearity_thre)
    planar = feats.valid & ~linear & (feats.planarity > fcfg.planarity_thre)
    is_pillar = linear & (pz > sin_pillar)
    is_beam = linear & (pz < sin_beam) & (z < fcfg.beam_max_height)
    is_roof = planar & (nz > sin_roof) & (z > fcfg.roof_height_min)
    is_facade = planar & (nz < sin_facade)

    # --- semantic mask refinement (`cfilter.hpp:2508-2608`)
    if semantic:
        ug_label = take(take(raw.label, ug_idx)[..., :n_q], qo)
        beyond = (torch.sum(q_xyz[..., :2] ** 2, -1)
                  > fcfg.semantic_labeled_radius ** 2)

        def lab_in(*ids):
            ok = torch.zeros_like(beyond)
            for i in ids:
                ok = ok | (ug_label == i)
            return ok | beyond

        is_pillar = is_pillar & lab_in(71, 80, 81)
        is_facade = is_facade & lab_in(50, 13, 51, 10)
    class_id = (1 * is_pillar.long() + 2 * is_beam.long()
                + 3 * is_facade.long() + 4 * is_roof.long())

    # --- vertex candidates + NCC descriptor pass
    # (`cfilter.hpp:2176-2226`, `encode_stable_points` :1071-1181)
    curv_gate = feats.valid & (feats.curvature > 0.3 * fcfg.curvature_thre)
    kv = min(shapes.n_vertex_full, curv_gate.shape[-1])
    cand_idx, cand_valid = compact_topk_score(curv_gate, feats.curvature, kv)
    if kv < shapes.n_vertex_full:
        pad = shapes.n_vertex_full - kv
        cand_idx = torch.cat([cand_idx, torch.zeros(
            (*lead, pad), dtype=cand_idx.dtype, device=dev)], -1)
        cand_valid = torch.cat([cand_valid, torch.zeros(
            (*lead, pad), dtype=cand_valid.dtype, device=dev)], -1)
    # support classes over the FULL unground cloud: unqueried rows keep
    # class 0 (a zero one-hot row)
    onehot = torch.nn.functional.one_hot(class_id.clamp(min=1) - 1, 4).to(
        torch.float32) * (class_id > 0)[..., None]
    onehot = onehot * q_valid[..., None]
    # the query rows in the unground cloud's order; rows past n_q stay 0
    onehot_full = torch.zeros((*lead, shapes.n_unground, 4),
                              dtype=torch.float32, device=dev)
    onehot_full = put(onehot_full, qo, onehot)
    r_desc = torch.full((*lead, shapes.n_vertex_full),
                        fcfg.cloud_pca_neigh_r, dtype=torch.float32,
                        device=dev)
    cand_xyz = take(q_xyz, cand_idx)
    if fcfg.use_distance_adaptive_pca:
        dq = torch.linalg.norm(cand_xyz, dim=-1)
        r_desc = r_desc * torch.sqrt(torch.clamp(dq / fcfg.unit_dist,
                                                 min=1.0))
    m2 = nbr.knn_class_counts(
        cand_xyz, cand_valid, ug_xyz, ug_valid, r_desc,
        k=fcfg.cloud_pca_neigh_k, class_onehot=onehot_full,
        p_intensity=ug_int, close_r2=0.64 * fcfg.cloud_pca_neigh_r ** 2)
    cand_count = torch.clamp(m2["count"], min=1.0)
    close_counts = m2["close_counts"]  # pillar/beam/facade/roof
    far_counts = m2["far_counts"]
    class_counts = close_counts + far_counts
    geo_count = torch.sum(class_counts, dim=-1)
    mean_int = m2["int_sum"] / cand_count

    # vertex-method-2: unclassified high-curvature points whose neighborhood
    # is rich in feature points get promoted to pillar/beam
    vertex_ratio_thre = fcfg.feature_pts_ratio_guess / fcfg.pca_down_rate
    cand_curv = take(feats.curvature, cand_idx)
    cand_class = take(class_id, cand_idx)
    cand_pz = torch.abs(take(feats.principal, cand_idx)[..., 2])
    cand_z = cand_xyz[..., 2]
    promoted = (cand_valid & (cand_class == 0)
                & (cand_curv > fcfg.curvature_thre)
                & (geo_count / cand_count > vertex_ratio_thre))
    promote_pillar = promoted & (cand_pz > sin_pillar)
    promote_beam = (promoted & (cand_pz < sin_beam)
                    & (cand_z < fcfg.beam_max_height))
    if fcfg.extract_vertex_points_method == 2:
        is_pillar = put(is_pillar, cand_idx,
                        take(is_pillar, cand_idx) | promote_pillar)
        is_beam = put(is_beam, cand_idx, take(is_beam, cand_idx)
                      | promote_beam)

    # stable keypoints (the vertex cloud): enough featured neighbors
    min_neighbor_feature_pts = int(
        fcfg.feature_pts_ratio_guess / fcfg.pca_down_rate
        * fcfg.cloud_pca_neigh_k) - 1
    stable = (cand_valid
              & (m2["count"] > fcfg.cloud_pca_neigh_k_min)
              & (geo_count >= min_neighbor_feature_pts))

    # strengths (normal[3] parity): linearity for linear classes, planarity
    # for planar, 5*curvature for promoted vertices
    strength = torch.where(is_pillar | is_beam, feats.linearity,
                           torch.where(is_facade | is_roof, feats.planarity,
                                       0.0))
    strength = put(strength, cand_idx, torch.where(
        promoted, 5.0 * cand_curv, take(strength, cand_idx)))
    # direction vector: principal for linear, plane normal for planar
    direction = torch.where((is_pillar | is_beam)[..., None], feats.principal,
                            feats.normal)

    # --- the full per-class clouds (budgeted compaction) from the
    # PCA-queried subset (the only points that can carry a class)
    def unground_cloud(m, capacity, k):
        return _gather_cloud(q_xyz, direction, q_int, strength, q_h, q_ts,
                             m, capacity, k)

    full = {}
    full["pillar"] = unground_cloud(is_pillar, shapes.n_pillar_full, keys[2])
    full["beam"] = unground_cloud(is_beam, shapes.n_beam_full, keys[3])
    full["facade"] = unground_cloud(is_facade, shapes.n_facade_full, keys[4])
    full["roof"] = unground_cloud(is_roof, shapes.n_roof_full, keys[5])

    # ground full cloud: the full band, budget-compacted
    is_ground = g.is_ground
    if semantic:
        gl = raw.label
        g_ok = (torch.sum(raw.xyz[..., :2] ** 2, -1)
                > fcfg.semantic_labeled_radius ** 2)
        for i in (40, 44, 48, 49, 60, 72):
            g_ok = g_ok | (gl == i)
        is_ground = is_ground & g_ok
    gr_idx, gr_valid = compact_topk_random(
        is_ground, shapes.n_ground_full, keys[6].uniform(is_ground.shape))
    gr_xyz = take(raw.xyz, gr_idx)
    gr_normal = take(g.normal, gr_idx)
    # ground normal methods 1/2 (`cfilter.hpp:1860-1925`): radius PCA on the
    # compacted ground cloud (method 0 = (0,0,1), method 3 = per-grid plane,
    # both handled inside the ground filter)
    if cfg.ground.ground_normal_method in (1, 2):
        gfeats = pca_ops.pca_features(
            gr_xyz, gr_valid, gr_xyz, gr_valid,
            radius=cfg.ground.normal_estimation_radius,
            min_k=fcfg.cloud_pca_neigh_k_min, distance_adaptive=False,
            unit_dist=fcfg.unit_dist)
        nrm = gfeats.normal * torch.where(gfeats.normal[..., 2:3] < 0, -1.0,
                                          1.0)
        up = torch.zeros_like(nrm)
        up[..., 2] = 1.0
        gr_normal = torch.where(gfeats.valid[..., None], nrm, up)
    g_int = take(raw.intensity, gr_idx)
    full["ground"] = FeatureCloud(
        xyz=gr_xyz, normal=gr_normal, intensity=g_int,
        strength=torch.zeros_like(g_int), height=torch.zeros_like(g_int),
        ts_ratio=take(raw.ts_ratio, gr_idx), mask=gr_valid)

    # vertex cloud: stable keypoints, curvature saliency; a zero keep budget
    # keeps a capacity-1 fully-masked cloud
    vx_idx, vx_valid = compact_topk_score(stable, cand_curv,
                                          max(fcfg.vertex_keep_num, 1))
    if fcfg.vertex_keep_num <= 0:
        vx_valid = torch.zeros_like(vx_valid)
    gi = take(cand_idx, vx_idx)  # rows of the (morton-ordered) queries
    v_curv = take(feats.curvature, gi)
    v_h = take(q_h, gi)
    v_int = take(mean_int, vx_idx)
    full["vertex"] = FeatureCloud(
        xyz=take(q_xyz, gi), normal=take(feats.principal, gi),
        intensity=v_int, strength=5.0 * v_curv,
        height=v_h, ts_ratio=take(q_ts, gi), mask=vx_valid)
    pct = lambda c: torch.floor(100.0 * c / cand_count[..., None])
    desc_vec = torch.cat([
        take(pct(close_counts), vx_idx), take(pct(far_counts), vx_idx),
        v_int[..., None], (v_curv * 100.0)[..., None],
        (v_h * 30.0)[..., None]], dim=-1)
    descriptors = VertexDescriptors(vec=desc_vec, mask=vx_valid)

    # --- NMS sharpening + fixed budgets -> down clouds
    # (`cfilter.hpp:2233-2270`)
    nms_radius = 0.25 * fcfg.cloud_pca_neigh_r
    down = {}

    def sharpened(cloud: FeatureCloud, budget: int, k: Draws,
                  sector: bool) -> FeatureCloud:
        # the reference hands ONE key to the sector balancer and to the
        # compaction (`features.py:324-327`): one draw serves both here
        u = k.uniform(cloud.mask.shape)
        if budget <= 0:
            idx, valid = compact_topk_random(cloud.mask, 1, u)
            return cloud.gather(idx, torch.zeros_like(valid))
        keep = cloud.mask
        if fcfg.sharpen_with_nms_on:
            keep = nms_ops.non_max_suppress(cloud.xyz, cloud.strength,
                                            cloud.mask, nms_radius,
                                            iterations=fcfg.nms_iterations)
        if sector:
            keep = voxel_ops.xy_normal_balanced_mask(
                cloud.normal, keep, budget // fcfg.xy_balanced_sector_num,
                fcfg.xy_balanced_sector_num, u)
        idx, valid = compact_topk_random(keep, budget, u)
        return cloud.gather(idx, valid)

    down["pillar"] = sharpened(full["pillar"], fcfg.pillar_down_fixed_num,
                               keys[7], sector=False)
    down["facade"] = sharpened(full["facade"], fcfg.facade_down_fixed_num,
                               keys[8], sector=True)
    down["beam"] = sharpened(full["beam"], fcfg.beam_down_fixed_num,
                             keys[9], sector=True)
    down["roof"] = sharpened(full["roof"], fcfg.roof_down_fixed_num,
                             keys[10], sector=False)
    gmask = full["ground"].mask
    gd_idx, gd_valid = compact_topk_random(
        gmask, max(fcfg.ground_down_fixed_num, 1),
        keys[11].uniform(gmask.shape))
    if fcfg.ground_down_fixed_num <= 0:
        gd_valid = torch.zeros_like(gd_valid)
    down["ground"] = full["ground"].gather(gd_idx, gd_valid)
    down["vertex"] = full["vertex"]

    bbx_min = masked_min(raw.xyz, mask[..., None], dim=-2)
    bbx_max = masked_max(raw.xyz, mask[..., None], dim=-2)
    return FeatureFrame(full=full, down=down, descriptors=descriptors,
                        bbx_min=bbx_min, bbx_max=bbx_max)
