"""Sliding local feature map as fixed-capacity buffers — port of
``mulls_tpu/mapping/local_map.py`` (reference MapManager,
`src/map_manager.cpp:18-314`).

Per-class fixed-capacity masked tensors updated by functions (transform ->
dynamic removal -> append -> radius crop -> random re-budget).  The map is
kept in the coordinate frame of the last appended scan, like the
reference.  Per-class caps (``MapShapeConfig``) stand in for the
reference's one global cap (`map_manager.cpp:73-86`).  A map with a
leading batch dimension (``[S, N, 3]`` clouds) is S maps updated as one;
each gets the map of its update alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from mulls_ref.config import MapConfig
from mulls_ref.core import se3
from mulls_ref.core.batch import expand_like, take
from mulls_ref.core.cloud import (FEATURE_NAMES, FeatureCloud,
                                        FeatureFrame, VertexDescriptors)
from mulls_ref.core.draws import Draws
from mulls_ref.core.tree import Struct, tree_map
from mulls_ref.ops.neighbors import nearest_neighbor_grouped

_DYNAMIC_CLASSES = ("pillar", "beam", "facade")  # `map_manager.cpp:191-215`


@dataclass
class LocalMap(Struct):
    clouds: Dict[str, FeatureCloud]
    vertex_desc: VertexDescriptors


def init_local_map(map_cfg: MapConfig, device) -> LocalMap:
    caps = map_cfg.shapes
    clouds = {n: FeatureCloud.empty(caps.capacity(n), device)
              for n in FEATURE_NAMES}
    return LocalMap(clouds=clouds, vertex_desc=VertexDescriptors.empty(
        caps.capacity("vertex"), device))


def _dynamic_removal_mask(cloud: FeatureCloud, d2: torch.Tensor,
                          center_radius: float, dist_min: float,
                          dist_max: torch.Tensor, near_thre: float,
                          enabled: torch.Tensor) -> torch.Tensor:
    """Frame-side mask: drop feature points near the scanner whose 1-NN map
    distance (squared: ``d2``) falls in (0, near] U [dist_min, dist_max]
    (`map_manager.cpp:145-256`)."""
    d = torch.sqrt(torch.clamp(d2, min=0.0))
    rng = torch.linalg.norm(cloud.xyz, dim=-1)
    in_scope = rng < center_radius
    dynamic = (d <= near_thre) | ((d >= dist_min)
                                  & (d <= expand_like(dist_max, d)))
    drop = in_scope & dynamic & expand_like(enabled, d)
    return cloud.mask & ~drop


def update_local_map(local_map: LocalMap, frame: FeatureFrame,
                     T_rel: torch.Tensor, dynamic_dist_max: torch.Tensor,
                     map_cfg: MapConfig, draws: Draws,
                     removal_enabled=True, append_enabled=True) -> LocalMap:
    """Append ``frame`` (down clouds + vertex) to the map.

    ``T_rel`` maps the new frame's coords into the current map frame (the
    registration result); the returned map lives in the new frame's coords.
    ``removal_enabled`` gates dynamic-object removal (off for failed or
    low-confidence frames); ``append_enabled`` gates the append itself (a
    vetoed frame's pose is the motion-model guess).  The map still
    transforms/crops so its coordinates follow the pose.
    """
    caps = map_cfg.shapes
    dev = T_rel.device
    T_inv = se3.inverse(T_rel)

    # global cap gate for dynamic removal (`map_manager.cpp:38`)
    map_count = sum(local_map.clouds[n].count
                    for n in ("ground", "pillar", "facade", "beam", "roof"))
    # the gates that are host values stay on the host: a scalar made into
    # a tensor on the card is a host-to-device copy, which syncs
    removal_on = map_count > map_cfg.local_map_max_pt_num // 5
    if torch.is_tensor(removal_enabled):
        removal_on = removal_on & removal_enabled
    elif not removal_enabled:
        removal_on = torch.zeros_like(removal_on)
    if not map_cfg.map_based_dynamic_removal_on:
        removal_on = torch.zeros_like(removal_on)
    # (callers pass an already speed-scaled gate; the floor lives HERE only)
    dist_max = torch.clamp(dynamic_dist_max,
                           min=map_cfg.dynamic_dist_thre_min + 0.1)

    append_ok = (expand_like(append_enabled, frame.down["ground"].mask)
                 if torch.is_tensor(append_enabled) else bool(append_enabled))
    # Stage 1 — per-class elementwise prep (transform, crops, removal)
    olds, adds = {}, {}
    for name in FEATURE_NAMES:
        olds[name] = local_map.clouds[name].transform(T_inv)  # into new frame
        add = frame.down[name]
        # append-radius crop (`--append_frame_radius`,
        # `mulls_slam.cpp:143,259,438`)
        adds[name] = add.replace(mask=add.mask & append_ok & (
            torch.linalg.norm(add.xyz, dim=-1) < map_cfg.append_frame_radius))
    # dynamic removal: one grouped 1-NN launch for its classes
    found = nearest_neighbor_grouped([
        (adds[n].xyz, adds[n].mask, olds[n].xyz, olds[n].mask)
        for n in _DYNAMIC_CLASSES])
    map_d2 = {n: d2 for n, (_, d2) in zip(_DYNAMIC_CLASSES, found)}
    merged_by_name = {}
    fresh_by_name = {}
    for name in FEATURE_NAMES:
        old, add = olds[name], adds[name]
        if name in _DYNAMIC_CLASSES:
            keep = _dynamic_removal_mask(
                add, map_d2[name], map_cfg.dynamic_removal_radius,
                map_cfg.dynamic_dist_thre_min, dist_max,
                map_cfg.near_dist_thre, removal_on)
            add = add.replace(mask=keep)
        merged = old.concat(add)
        # sphere crop (`map_manager.cpp:62-67`)
        rng = torch.linalg.norm(merged.xyz, dim=-1)
        merged_by_name[name] = merged.replace(
            mask=merged.mask & (rng < map_cfg.local_map_radius))
        fresh_by_name[name] = torch.cat([
            torch.zeros((old.capacity,), dtype=torch.float32, device=dev),
            torch.full((add.capacity,), 0.5, dtype=torch.float32,
                       device=dev)])  # the same for every batch entry

    # Stage 2 — ONE class-keyed stable sort re-budgets every class at once
    # (reference `local_map.py:127-167`): key = class_id*4 + (1.5 - score)
    # for valid rows, class_id*4 + 3 for invalid; each class's winners are a
    # static slice of the sorted order.  ``jnp.argsort`` is stable, hence
    # ``stable=True`` here.  The slices' starts are the classes' static
    # capacities (host numbers), the same in every batch entry.
    lengths = [merged_by_name[n].capacity for n in FEATURE_NAMES]
    starts = np.concatenate([[0], np.cumsum(lengths)]).astype(int)
    all_mask = torch.cat([merged_by_name[n].mask for n in FEATURE_NAMES], -1)
    score = draws.uniform(all_mask.shape) + torch.cat(
        [fresh_by_name[n] for n in FEATURE_NAMES])
    class_id = torch.cat([
        torch.full((lengths[i],), 4.0 * i, dtype=torch.float32, device=dev)
        for i in range(len(FEATURE_NAMES))])
    sort_key = class_id + torch.where(all_mask, 1.5 - score, 3.0)
    perm = torch.argsort(sort_key, dim=-1, stable=True)
    axis = all_mask.dim() - 1  # the point axis

    def _cat(field):
        return take(torch.cat([getattr(merged_by_name[n], field)
                               for n in FEATURE_NAMES], axis), perm)

    sorted_cloud = FeatureCloud(xyz=_cat("xyz"), normal=_cat("normal"),
                                intensity=_cat("intensity"),
                                strength=_cat("strength"),
                                height=_cat("height"),
                                ts_ratio=_cat("ts_ratio"), mask=_cat("mask"))
    new_clouds = {}
    for i, name in enumerate(FEATURE_NAMES):
        s0 = int(starts[i])
        cap = caps.capacity(name)
        new_clouds[name] = tree_map(lambda a: a.narrow(axis, s0, cap),
                                    sorted_cloud)

    # vertex descriptors ride the same permutation (vertex segment only)
    i_v = FEATURE_NAMES.index("vertex")
    cap_v = caps.capacity("vertex")
    s_v = int(starts[i_v])
    vert_perm = perm[..., s_v:s_v + cap_v] - s_v
    desc_vec = torch.cat([local_map.vertex_desc.vec, frame.descriptors.vec],
                         dim=axis)
    desc_mask = torch.cat([local_map.vertex_desc.mask,
                           frame.descriptors.mask], dim=axis)
    new_desc = VertexDescriptors(
        vec=take(desc_vec, vert_perm),
        mask=new_clouds["vertex"].mask & take(desc_mask, vert_perm))
    return LocalMap(clouds=new_clouds, vertex_desc=new_desc)


# `MapManager::update_cloud_vectors` hardcoded operating point
# (`src/map_manager.cpp:100-106`)
_REFRESH_RADIUS = 1.8
_REFRESH_MIN_K = 6
_REFRESH_MIN_LINEARITY = 0.65
_REFRESH_PILLAR_SIN = 0.80  # keep pillar if |dir_z| > sin(55 deg)
_REFRESH_BEAM_SIN = 0.25    # keep beam  if |dir_z| < sin(15 deg)


def refresh_linear_map_vectors(local_map: LocalMap) -> LocalMap:
    """Re-estimate the map's linear-feature direction vectors and cull
    points whose merged neighborhood is no longer strongly linear or
    correctly oriented (`MapManager::update_cloud_vectors`,
    `src/map_manager.cpp:95-292`): one query-centred PCA pass per class
    (pillar, beam) + masked selects."""
    from mulls_ref.ops.pca import pca_features

    new_clouds = dict(local_map.clouds)
    for name, keep_gate in (("pillar", lambda dz: dz > _REFRESH_PILLAR_SIN),
                            ("beam", lambda dz: dz < _REFRESH_BEAM_SIN)):
        c = local_map.clouds[name]
        f = pca_features(c.xyz, c.mask, c.xyz, c.mask, _REFRESH_RADIUS,
                         _REFRESH_MIN_K)
        keep = (f.valid & (f.linearity > _REFRESH_MIN_LINEARITY)
                & keep_gate(torch.abs(f.principal[..., 2])))
        new_clouds[name] = c.replace(
            normal=torch.where(keep[..., None], f.principal, c.normal),
            strength=torch.where(keep, f.linearity, c.strength),
            mask=c.mask & keep)
    return LocalMap(clouds=new_clouds, vertex_desc=local_map.vertex_desc)
