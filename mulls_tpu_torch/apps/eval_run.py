"""Offline evaluation & replay inspection — the roles of the reference's
`python/kitti_eval.py` (drift metrics, trajectory/timing plots, per-frame
adjacent-error diagnosis) and `test/vis_slam.cpp` (flagging problematic
frames from a finished run), headless.

Usage:
  python -m mulls_tpu_torch.apps.eval_run \
      --est_pose_file out/pose_b_lo.txt --gt_pose_file 00.txt \
      [--calib_file calib.txt] [--timing_file timing.txt] \
      [--plot_dir out/plots] [--json_out out/eval.json] \
      [--point_cloud_folder scans/ --map_pcd_out out/map.pcd \
       --map_bev_out out/map.png [--device cuda]]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from mulls_tpu_torch.eval import kitti_metrics
from mulls_tpu_torch.io import kitti as kitti_io
from mulls_tpu_torch.io.dataset import FolderDataset
from mulls_tpu_torch.mapping.assembly import (accumulate_map,
                                              radius_outlier_filter,
                                              write_map_outputs)


def adjacent_error_diagnosis(gt: np.ndarray, est: np.ndarray,
                             horiz_thre: float = 0.1,
                             vert_thre: float = 0.1,
                             yaw_thre_deg: float = 0.5):
    """Per-frame adjacent-pose error vs ground truth with the reference's
    thresholds (`kitti_eval.py:37-41`).  Returns (errors [N-1, 3],
    flagged frame indices)."""
    rel_gt = np.einsum("nij,njk->nik", np.linalg.inv(gt[:-1]), gt[1:])
    rel_est = np.einsum("nij,njk->nik", np.linalg.inv(est[:-1]), est[1:])
    d = np.einsum("nij,njk->nik", np.linalg.inv(rel_gt), rel_est)
    horiz = np.linalg.norm(d[:, :2, 3], axis=1)
    vert = np.abs(d[:, 2, 3])
    yaw = np.degrees(np.abs(np.arctan2(d[:, 1, 0], d[:, 0, 0])))
    errs = np.stack([horiz, vert, yaw], axis=1)
    flagged = np.where((horiz > horiz_thre) | (vert > vert_thre)
                       | (yaw > yaw_thre_deg))[0] + 1
    return errs, flagged


def plot_outputs(gt, est, errs, timing, plot_dir):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    os.makedirs(plot_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(8, 8))
    if gt is not None:
        ax.plot(gt[:, 0, 3], gt[:, 2, 3] if _is_kitti_cam(gt)
                else gt[:, 1, 3], "k-", label="ground truth")
    ax.plot(est[:, 0, 3], est[:, 2, 3] if gt is not None and
            _is_kitti_cam(gt) else est[:, 1, 3], "r-", label="estimate")
    ax.axis("equal")
    ax.legend()
    ax.set_title("trajectory")
    fig.savefig(os.path.join(plot_dir, "trajectory.png"), dpi=150)
    plt.close(fig)
    if errs is not None:
        fig, axes = plt.subplots(3, 1, figsize=(10, 7), sharex=True)
        for a, col, name in zip(axes, errs.T,
                                ("horizontal [m]", "vertical [m]",
                                 "yaw [deg]")):
            a.plot(col)
            a.set_ylabel(name)
        axes[-1].set_xlabel("frame")
        fig.savefig(os.path.join(plot_dir, "adjacent_errors.png"), dpi=150)
        plt.close(fig)
    if timing is not None:
        fig, ax = plt.subplots(figsize=(10, 4))
        labels = ("feature", "map", "registration", "loop")
        for k in range(min(4, timing.shape[1])):
            ax.plot(timing[:, k], label=labels[k])
        ax.set_xlabel("frame")
        ax.set_ylabel("ms")
        ax.legend()
        fig.savefig(os.path.join(plot_dir, "timing.png"), dpi=150)
        plt.close(fig)


def _is_kitti_cam(gt) -> bool:
    """KITTI gt is in the camera frame (y down): trajectories live in the
    x-z plane."""
    span = gt[:, :3, 3].max(0) - gt[:, :3, 3].min(0)
    return span[2] > 3 * span[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--est_pose_file", required=True)
    p.add_argument("--gt_pose_file", default=None)
    p.add_argument("--calib_file", default=None)
    p.add_argument("--timing_file", default=None)
    p.add_argument("--plot_dir", default=None)
    p.add_argument("--json_out", default=None)
    p.add_argument("--point_cloud_folder", default=None,
                   help="replay: re-assemble the map from the estimated "
                        "poses + scan folder (`test/vis_slam.cpp` role)")
    p.add_argument("--map_pcd_out", default=None)
    p.add_argument("--map_bev_out", default=None)
    p.add_argument("--map_voxel_size", type=float, default=0.25)
    p.add_argument("--device", default="cuda",
                   help="where the replayed map's outlier filter counts: "
                        "cuda (default) | cpu")
    args = p.parse_args(argv)

    est = kitti_io.read_kitti_poses(args.est_pose_file)
    gt = errs = timing = None
    report = {"frames": len(est)}
    if args.gt_pose_file:
        gt = kitti_io.read_kitti_poses(args.gt_pose_file)
        m = min(len(gt), len(est))
        gt, est_c = gt[:m], est[:m]
        metrics = kitti_metrics.summarize(
            kitti_metrics.compute_error(gt, est_c))
        print(kitti_metrics.format_report(metrics))
        report["kitti"] = metrics
        errs, flagged = adjacent_error_diagnosis(gt, est_c)
        report["flagged_frames"] = flagged.tolist()
        print(f"[eval] {len(flagged)} problematic frames: "
              f"{flagged[:20].tolist()}{'...' if len(flagged) > 20 else ''}")
    if args.timing_file and os.path.exists(args.timing_file):
        timing = np.loadtxt(args.timing_file)
        report["mean_ms_per_frame"] = float(timing.sum(1).mean())
    if args.plot_dir:
        plot_outputs(gt, est, errs, timing, args.plot_dir)
    if args.point_cloud_folder and (args.map_pcd_out or args.map_bev_out):
        # post-hoc replay: rebuild the registered map from the pose file,
        # the headless stand-in for vis_slam's re-rendering, with the SLAM
        # CLI's radius-outlier filter (the reference's replay writes the
        # map unfiltered)
        ds = FolderDataset(args.point_cloud_folder, n_raw=1 << 17)
        pts = accumulate_map(ds, est[:len(ds)],
                             voxel_res=args.map_voxel_size)
        pts = radius_outlier_filter(pts, device=args.device)
        write_map_outputs(pts, args.map_pcd_out, args.map_bev_out)
        print(f"[eval] replayed map: {len(pts)} points")
        report["map_points"] = int(len(pts))
    if args.json_out:
        os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
