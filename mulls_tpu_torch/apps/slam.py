"""mulls_slam-equivalent CLI — port of ``mulls_tpu/apps/slam.py``.

Runs LiDAR odometry, or with ``--loop_closure_detection_on`` the full SLAM
pipeline (submaps, loop closure, PGO and the end-of-run refinement), over a
scan folder on the card, and writes the reference program's outputs
(`test/mulls_slam.cpp`): pose files in KITTI 3x4 format, a timing report,
the pose-graph constraint file, checkpoints, during-run map snapshots and
the KITTI drift evaluation when ground truth is given.  The NDT/VGICP
baselines, map assembly and the feature / map viewers are not ported yet:
their flags raise.

Usage:
  python -m mulls_tpu_torch.apps.slam \
      --point_cloud_folder /data/kitti/00/velodyne \
      --gt_body_pose_file_path /data/kitti/00/00.txt \
      --calib_file_path /data/kitti/00/calib.txt \
      --output_lo_body_pose_file_path out/pose_b_lo.txt \
      --flagfile script/config/lo_gflag_list_kitti_urban.txt
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from mulls_tpu_torch.config import (MullsConfig, apply_flag_overrides,
                                    gflag_bool, load_flagfile)
from mulls_tpu_torch.eval import kitti_metrics
from mulls_tpu_torch.io import kitti as kitti_io
from mulls_tpu_torch.io.dataset import FolderDataset
from mulls_tpu_torch.pipeline.odometry import OdometryPipeline
from mulls_tpu_torch.pipeline.slam import SlamPipeline

# flags whose path lives in modules this package does not carry yet
_NOT_PORTED = {
    "baseline_reg_method": "the NDT / VGICP baselines",
    "semantic_kitti_label_folder": "the Semantic-KITTI dataset reader",
    "output_map_pcd": "map assembly",
    "write_out_map_on": "map assembly",
    "write_map_each_frame": "map assembly",
    "output_map_bev": "map assembly",
    "output_map_html": "the HTML viewer",
    "export_feature_frame": "the feature-cloud viewer export",
    "profile_dir": "the profiler capture",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--point_cloud_folder", required=True)
    p.add_argument("--pc_format", default=None, help=".pcd | .bin | ...")
    p.add_argument("--flagfile", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) | cpu (plain PyTorch paths)")
    p.add_argument("--frame_num_begin", type=int, default=0)
    p.add_argument("--frame_num_end", type=int, default=None)
    p.add_argument("--frame_step", type=int, default=1)
    p.add_argument("--gt_body_pose_file_path", default=None)
    p.add_argument("--gt_oxts_format", type=gflag_bool, nargs="?", const=1,
                   default=0,
                   help="gt poses are tx ty tz qx qy qz qw lines "
                        "(`dataio.hpp:2003-2040`) instead of KITTI 3x4")
    p.add_argument("--gt_in_lidar_frame", type=gflag_bool, nargs="?",
                   const=1, default=0,
                   help="gt poses are already in the LiDAR frame "
                        "(no calib applied, `mulls_slam.cpp:301-314`)")
    p.add_argument("--output_gt_lidar_pose_file_path", default=None)
    p.add_argument("--lo_lidar_pose_point_cloud", default=None,
                   help="write the estimated trajectory as a .pcd")
    p.add_argument("--gt_lidar_pose_point_cloud", default=None)
    p.add_argument("--calib_file_path", default=None)
    p.add_argument("--output_adjacent_lo_pose_file_path", default=None)
    p.add_argument("--output_lo_body_pose_file_path", default=None)
    p.add_argument("--output_lo_lidar_pose_file_path", default=None)
    p.add_argument("--timing_report_file", default=None)
    p.add_argument("--evaluation_file", default=None)
    p.add_argument("--progress", action="store_true")
    p.add_argument("--loop_closure_detection_on", type=gflag_bool,
                   default=None,
                   help="override the flagfile's loop-closure switch (0|1)")
    p.add_argument("--constraint_output_file", default=None,
                   help="dump the pose-graph edges in the reference's "
                        "constraint-file format (`dataio.hpp:1247-1337`)")
    p.add_argument("--checkpoint_path", default=None,
                   help="checkpoint file for save/resume (SLAM mode)")
    p.add_argument("--map_snapshot_dir", default=None,
                   help="write a WebGL snapshot of the live map / "
                        "trajectory / pose graph here every N submaps")
    p.add_argument("--map_snapshot_every_submaps", type=int, default=4)
    for name in _NOT_PORTED:
        p.add_argument(f"--{name}", default=None,
                       help=f"not ported yet ({_NOT_PORTED[name]})")
    return p


def _write_poses(path, poses) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    kitti_io.write_kitti_poses(path, poses)


def main(argv=None) -> int:
    args, extra = build_parser().parse_known_args(argv)
    for name, what in _NOT_PORTED.items():
        val = getattr(args, name)
        if val not in (None, "", "0", "false", "False"):
            raise SystemExit(f"--{name}: {what} is not ported to "
                             f"mulls_tpu_torch yet")
    cfg = load_flagfile(args.flagfile) if args.flagfile else MullsConfig()
    if extra:  # gflags parity: any --name=value accepted on the CLI
        cfg = apply_flag_overrides(cfg, extra)
    if args.loop_closure_detection_on is not None:
        cfg = cfg.replace(submap=dataclasses.replace(
            cfg.submap,
            loop_closure_detection_on=bool(args.loop_closure_detection_on)))
    if cfg.baseline.method:
        raise SystemExit("the NDT / VGICP baselines are not ported to "
                         "mulls_tpu_torch yet")

    ds = FolderDataset(args.point_cloud_folder, cfg.shapes.n_raw,
                       ext=args.pc_format, begin=args.frame_num_begin,
                       end=args.frame_num_end, step=args.frame_step)
    print(f"[mulls_tpu_torch] {len(ds)} frames from "
          f"{args.point_cloud_folder}")

    backend = None
    if cfg.submap.loop_closure_detection_on:
        # the full SLAM pipeline (submaps + loop closure + PGO,
        # `mulls_slam.cpp:451-628`)
        pipe = SlamPipeline(cfg, checkpoint_path=args.checkpoint_path,
                            snapshot_dir=args.map_snapshot_dir,
                            snapshot_every=args.map_snapshot_every_submaps,
                            device=args.device)
        res = pipe.run(ds, progress=args.progress,
                       stage_timing=args.timing_report_file is not None)
        backend = res.backend
        print(f"[mulls_tpu_torch] back-end: {len(backend.submaps)} submaps, "
              f"{len(backend.edges)} edges, "
              f"{sum(1 for e in backend.edges if e.kind == 2)} reg edges")
        # end-of-run inner-submap refinement (`mulls_slam.cpp:876-927`)
        pipe.refine(res)
    else:
        res = OdometryPipeline(cfg, device=args.device).run(
            ds, progress=args.progress,
            profile=args.timing_report_file is not None)

    poses_lidar = res.poses
    if args.output_lo_lidar_pose_file_path:
        _write_poses(args.output_lo_lidar_pose_file_path, poses_lidar)
    if args.output_adjacent_lo_pose_file_path:
        adj = np.einsum("nij,njk->nik",
                        np.linalg.inv(poses_lidar[:-1]), poses_lidar[1:])
        _write_poses(args.output_adjacent_lo_pose_file_path, adj)

    calib = (kitti_io.read_kitti_calib(args.calib_file_path)
             if args.calib_file_path else np.eye(4))
    poses_body = kitti_io.uncalibrate(poses_lidar, calib)
    if args.output_lo_body_pose_file_path:
        _write_poses(args.output_lo_body_pose_file_path, poses_body)

    if args.timing_report_file and res.timings is not None:
        np.savetxt(args.timing_report_file, res.timings, fmt="%.3f",
                   header="feature_ms map_ms reg_ms loop_ms")
    if res.timings is not None:
        t = res.timings[1:]
        print(f"[mulls_tpu_torch] mean per-frame: total "
              f"{t.sum(1).mean():.1f} ms (feature {t[:, 0].mean():.1f} | "
              f"map {t[:, 1].mean():.1f} | reg {t[:, 2].mean():.1f} | "
              f"loop {t[:, 3].mean():.1f})")

    gt_body = gt_lidar = None
    if args.gt_body_pose_file_path:
        gt_body = (kitti_io.read_pose_quat(args.gt_body_pose_file_path)
                   if args.gt_oxts_format
                   else kitti_io.read_kitti_poses(args.gt_body_pose_file_path))
        gt_body = np.einsum("ij,njk->nik", np.linalg.inv(gt_body[0]), gt_body)
        gt_lidar = (gt_body if args.gt_in_lidar_frame
                    else kitti_io.apply_calibration(gt_body, calib))
        if args.output_gt_lidar_pose_file_path:
            _write_poses(args.output_gt_lidar_pose_file_path, gt_lidar)

    # trajectory-as-pointcloud export (`dataio.hpp:2105-2123`)
    from mulls_tpu_torch.io.pcd import write_pcd
    if args.lo_lidar_pose_point_cloud:
        write_pcd(args.lo_lidar_pose_point_cloud,
                  poses_lidar[:, :3, 3].astype(np.float32))
    if args.gt_lidar_pose_point_cloud and gt_lidar is not None:
        write_pcd(args.gt_lidar_pose_point_cloud,
                  gt_lidar[:, :3, 3].astype(np.float32))

    # constraint-file dump (`dataio.hpp:1247-1337` format)
    if args.constraint_output_file:
        if backend is not None:
            from mulls_tpu_torch.io.constraints import write_constraint_file
            n_con = write_constraint_file(args.constraint_output_file,
                                          backend.edges)
            print(f"[mulls_tpu_torch] {n_con} constraints -> "
                  f"{args.constraint_output_file}")
        else:
            print("[mulls_tpu_torch] constraint output requested but no "
                  "pose graph was built (enable "
                  "--loop_closure_detection_on)")

    if gt_body is not None:
        m = min(len(gt_body), len(poses_body))
        errs = kitti_metrics.compute_error(gt_body[:m], poses_body[:m])
        summary = kitti_metrics.summarize(errs)
        print(kitti_metrics.format_report(summary))
        if args.evaluation_file:
            with open(args.evaluation_file, "w") as f:
                json.dump(summary, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
