"""KITTI odometry drift metrics — exact parity with the reference
`include/nav/odom_error_compute.h` (the scoreboard of SURVEY.md §3.4/§6).

Odometry mode: segment lengths {100..800} m; SLAM mode ("longer segments"):
{400..3200} m; segments start every 10 frames; errors are the relative-pose
error over each segment normalized by segment length
(`odom_error_compute.h:32-35, 85-140`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)
LENGTHS_LONGER = (400.0, 800.0, 1200.0, 1600.0, 2000.0, 2400.0, 2800.0, 3200.0)
STEP_SIZE = 10


@dataclass
class SegmentError:
    first_frame: int
    r_err: float  # rad/m
    t_err: float  # fraction/m (t_err*100 = %)
    length: float
    len_id: int
    speed: float  # km/h


def _trajectory_distances(poses: np.ndarray) -> np.ndarray:
    d = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(d)])


def _last_frame(dist: np.ndarray, first: int, length: float) -> int:
    # side='right' already yields the first index strictly greater than
    # the target (`odom_error_compute.h:57` semantics)
    idx = np.searchsorted(dist, dist[first] + length, side="right")
    return idx if idx < len(dist) else -1


def compute_error(poses_gt: np.ndarray, poses_result: np.ndarray,
                  longer_segments_on: bool = False) -> List[SegmentError]:
    poses_gt = np.asarray(poses_gt, np.float64)
    poses_result = np.asarray(poses_result, np.float64)
    lengths = LENGTHS_LONGER if longer_segments_on else LENGTHS
    dist = _trajectory_distances(poses_gt)
    errors: List[SegmentError] = []
    inv_gt = np.linalg.inv(poses_gt)
    inv_res = np.linalg.inv(poses_result)
    for first in range(0, len(poses_gt), STEP_SIZE):
        for len_id, length in enumerate(lengths):
            last = _last_frame(dist, first, length)
            if last == -1:
                continue
            delta_gt = inv_gt[first] @ poses_gt[last]
            delta_res = inv_res[first] @ poses_result[last]
            pose_error = np.linalg.inv(delta_res) @ delta_gt
            d = 0.5 * (np.trace(pose_error[:3, :3]) - 1.0)
            r_err = float(np.arccos(np.clip(d, -1.0, 1.0)))
            t_err = float(np.linalg.norm(pose_error[:3, 3]))
            num_frames = last - first + 1
            speed = length / (0.1 * num_frames) * 3.6
            errors.append(SegmentError(first, r_err / length, t_err / length,
                                       length, len_id, speed))
    return errors


def summarize(errors: List[SegmentError]) -> dict:
    """Overall ATE (%) and ARE (deg/m) + per-length tables
    (parity with `odom_error_compute.h:158-244`)."""
    if not errors:
        return {"ate_percent": float("nan"), "are_deg_per_m": float("nan"),
                "per_length": {}}
    t = np.array([e.t_err for e in errors])
    r = np.array([e.r_err for e in errors])
    lid = np.array([e.len_id for e in errors])
    lengths = {e.len_id: e.length for e in errors}
    per_length = {}
    for i in sorted(set(lid.tolist())):
        m = lid == i
        per_length[lengths[i]] = {
            "ate_percent": float(t[m].mean() * 100.0),
            "are_deg_per_m": float(np.degrees(r[m].mean())),
            "count": int(m.sum()),
        }
    # accuracy w.r.t. vehicle speed: 10..100 km/h buckets, +-10 window
    # (`odom_error_compute.h:220-240`)
    sp = np.array([e.speed for e in errors])
    per_speed = {}
    for v in range(10, 101, 10):
        m = np.abs(sp - v) < 10.0
        if m.any():
            per_speed[v] = {
                "ate_percent": float(t[m].mean() * 100.0),
                "are_deg_per_m": float(np.degrees(r[m].mean())),
                "count": int(m.sum()),
            }
    return {
        "ate_percent": float(t.mean() * 100.0),
        "are_deg_per_m": float(np.degrees(r.mean())),
        "per_length": per_length,
        "per_speed": per_speed,
        "num_segments": len(errors),
    }


def ate_rmse(poses_gt: np.ndarray, poses_result: np.ndarray) -> float:
    """Absolute trajectory RMSE (m) — auxiliary metric (evo-style)."""
    d = np.asarray(poses_gt)[:, :3, 3] - np.asarray(poses_result)[:, :3, 3]
    return float(np.sqrt((d ** 2).sum(axis=1).mean()))


def format_report(summary: dict, longer_segments_on: bool = False) -> str:
    mode = "SLAM" if longer_segments_on else "odometry"
    lines = [f"Accuracy evaluation ({mode})",
             f"Overall ATE (%) : {summary['ate_percent']:.4f}",
             f"Overall ARE (deg/m) : {summary['are_deg_per_m']:.6f}",
             "  dist(m)   ATE (%)   ARE (deg/m)   n"]
    for length, row in sorted(summary["per_length"].items()):
        lines.append(f"  {length:7.0f}  {row['ate_percent']:8.4f}  "
                     f"{row['are_deg_per_m']:11.6f}  {row['count']}")
    if summary.get("per_speed"):
        lines.append("  speed(km/h)   ATE (%)   ARE (deg/m)   n")
        for v, row in sorted(summary["per_speed"].items()):
            lines.append(f"  {v:11.0f}  {row['ate_percent']:8.4f}  "
                         f"{row['are_deg_per_m']:11.6f}  {row['count']}")
    return "\n".join(lines)
