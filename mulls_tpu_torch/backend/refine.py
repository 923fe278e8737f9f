"""End-of-run trajectory refinement — port of
``mulls_tpu/backend/refine.py`` (`mulls_slam.cpp:832-931`).

* :func:`inner_submap_refine` — the default "option B": for every submap,
  optimize the member frames' poses with both endpoint frames FIXED to
  their loop-corrected values and adjacent-frame odometry edges in between
  (`mulls_slam.cpp:876-927`).  Tiny one-shot chain graphs: the host numpy
  solver (``backend/np_pgo.py``), as in the reference.
* :func:`framewise_pgo` — "option A": one graph over ALL frames with
  adjacent odometry edges plus the submap registration edges between
  member frames (`mulls_slam.cpp:835-875`), solved on the device the
  caller passes (the reference pins it to the host CPU only to avoid
  remote TPU compiles).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from mulls_tpu_torch.backend import np_pgo
from mulls_tpu_torch.backend.pgo import (PoseGraph, optimize_pose_graph,
                                         optimize_pose_graph_cg)
from mulls_tpu_torch.core import se3
from mulls_tpu_torch.core.device import resolve_device


def _quat_f32(R: np.ndarray, device) -> np.ndarray:
    """Unit quaternions of [N,3,3] rotations, in float32 as the reference
    converts them."""
    R = torch.as_tensor(np.asarray(R, np.float32), device=device)
    return se3.quat_from_rotation(R).cpu().numpy()


def inner_submap_refine(poses: np.ndarray, poses_odom: np.ndarray,
                        boundaries: Sequence[Tuple[int, int]],
                        iterations: int = 15, t_limit: float = 0.0,
                        r_limit: float = 0.0) -> np.ndarray:
    """Refine interior frame poses submap by submap.

    Args:
      poses: [N,4,4] current frame poses (endpoints already corrected by
        the submap-level PGO).
      poses_odom: [N,4,4] raw odometry poses (source of the adjacent-edge
        measurements).
      boundaries: (frame_begin, frame_end) inclusive ranges per submap.
    Returns refined [N,4,4] poses."""
    out = poses.copy()
    for lo, hi in boundaries:
        if hi - lo < 2:
            continue
        sub = poses[lo:hi + 1]
        t = sub[:, :3, 3]
        q = np_pgo.quat_from_rotation(sub[:, :3, :3])
        m = hi - lo + 1
        T_rel = np.einsum("nij,njk->nik",
                          np.linalg.inv(poses_odom[lo:hi]),
                          poses_odom[lo + 1:hi + 1])
        et = T_rel[:, :3, 3]
        eq = np_pgo.quat_from_rotation(T_rel[:, :3, :3])
        fixed = np.zeros(m, bool)
        fixed[0] = fixed[-1] = True
        # ceres-style growing bounds from the fixed start frame
        # (`--inner_submap_t_limit/-r_limit`, `mulls_slam.cpp:911-915`);
        # a non-positive limit leaves that component unbounded
        tl = rl = None
        if t_limit > 0 or r_limit > 0:
            k = np.arange(m, dtype=np.float64)
            tl = (k * t_limit if t_limit > 0 else np.full(m, np.inf))
            rl = (k * r_limit if r_limit > 0 else np.full(m, np.inf))
        nt, nq, _ = np_pgo.optimize_pose_graph_np(
            t, q, np.arange(m - 1), np.arange(1, m), et, eq,
            np.broadcast_to(np.eye(6), (m - 1, 6, 6)), fixed,
            t_limit=tl, r_limit=rl, iterations=iterations)
        seg = np.tile(np.eye(4), (m, 1, 1))
        seg[:, :3, :3] = np_pgo.rotation_from_quat(nq)
        seg[:, :3, 3] = nt
        out[lo:hi + 1] = seg
    return out


def framewise_pgo(poses_odom: np.ndarray,
                  reg_edges: List[Tuple[int, int, np.ndarray, np.ndarray]],
                  fixed_first: bool = True, iterations: int = 25,
                  device="cuda") -> np.ndarray:
    """Whole-trajectory PGO on ``device``: adjacent odometry edges +
    frame-level loop registration edges (i, j, T_ij [4,4], info [6,6])."""
    dev = resolve_device(device)
    n = len(poses_odom)
    t = poses_odom[:, :3, 3].astype(np.float32)
    q = _quat_f32(poses_odom[:, :3, :3], dev)
    T_rel = np.einsum("nij,njk->nik", np.linalg.inv(poses_odom[:n - 1]),
                      poses_odom[1:])
    ei = np.arange(n - 1)
    e_i, e_j = [ei], [ei + 1]
    e_t = [T_rel[:, :3, 3].astype(np.float32)]
    e_q = [_quat_f32(T_rel[:, :3, :3], dev)]
    infos = [np.broadcast_to(np.eye(6, dtype=np.float32), (n - 1, 6, 6))]
    for (i, j, T_ij, info) in reg_edges:
        e_i.append(np.asarray([i]))
        e_j.append(np.asarray([j]))
        e_t.append(T_ij[None, :3, 3].astype(np.float32))
        e_q.append(_quat_f32(T_ij[None, :3, :3], dev))
        infos.append(info[None].astype(np.float32))
    fixed = np.zeros(n, bool)
    if fixed_first:
        fixed[0] = True

    def t_(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    e = sum(len(x) for x in e_i)
    graph = PoseGraph(
        node_t=t_(t), node_q=t_(q),
        edge_i=t_(np.concatenate(e_i), torch.int64),
        edge_j=t_(np.concatenate(e_j), torch.int64),
        edge_t=t_(np.concatenate(e_t)), edge_q=t_(np.concatenate(e_q)),
        edge_info=t_(np.concatenate(infos)),
        edge_mask=torch.ones(e, dtype=torch.bool, device=dev),
        fixed=t_(fixed, torch.bool))
    # frame-scale graphs (KITTI-00 is 4541 nodes): the dense solver would
    # materialize the (6n)^2 Hessian, so the matrix-free CG path serves them
    solve = optimize_pose_graph_cg if n > 256 else optimize_pose_graph
    nt, nq, _ = solve(graph, iterations=iterations, robust_kernel=True)
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :3] = se3.rotation_from_quat(nq).cpu().numpy()
    out[:, :3, 3] = nt.cpu().numpy().astype(np.float64)
    return out
