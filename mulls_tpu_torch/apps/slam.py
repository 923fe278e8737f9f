"""mulls_slam-equivalent CLI — port of ``mulls_tpu/apps/slam.py``.

Runs LiDAR odometry, or with ``--loop_closure_detection_on`` the full SLAM
pipeline (submaps, loop closure, PGO and the end-of-run refinement), over a
scan folder on the card, and writes the reference program's outputs
(`test/mulls_slam.cpp`): pose files in KITTI 3x4 format, a timing report,
the pose-graph constraint file, checkpoints, during-run map snapshots,
the assembled map (pcd, BEV image, HTML viewer; its outlier filter counts
neighbours on the card), one frame's feature clouds, a profiler trace and
the KITTI drift evaluation when ground truth is given.
``--baseline_reg_method ndt|gicp`` runs the NDT / VGICP baselines in place
of MULLS-ICP.  Every flag of ``mulls_tpu/apps/slam.py`` is accepted.

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
from mulls_tpu_torch.io.dataset import FolderDataset, SemanticKittiDataset
from mulls_tpu_torch.io.pcd import write_pcd
from mulls_tpu_torch.mapping.assembly import (accumulate_map,
                                              radius_outlier_filter,
                                              write_map_outputs)
from mulls_tpu_torch.pipeline.baseline import BaselinePipeline
from mulls_tpu_torch.pipeline.odometry import OdometryPipeline
from mulls_tpu_torch.pipeline.slam import SlamPipeline
from mulls_tpu_torch.viz import export_html_viewer


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
    p.add_argument("--baseline_reg_method", default="",
                   help="replace MULLS-ICP with a baseline: ndt | gicp")
    p.add_argument("--semantic_kitti_label_folder", default=None,
                   help="Semantic-KITTI .label folder (enables the "
                        "semantic-assisted extraction path)")
    p.add_argument("--output_map_pcd", default=None,
                   help="write the merged, outlier-filtered map cloud")
    p.add_argument("--write_out_map_on", type=gflag_bool, nargs="?",
                   const=1, default=0,
                   help="write the merged map into "
                        "--output_map_point_cloud_folder_path/merged_map.pcd "
                        "(`mulls_slam.cpp:46,959-1028`)")
    p.add_argument("--map_downrate_output", type=int, default=1,
                   help="per-frame point stride for the output map "
                        "(`mulls_slam.cpp:49,970`; the assembled map is "
                        "also voxel-thinned by --map_voxel_size)")
    p.add_argument("--write_out_gt_map_on", type=gflag_bool, nargs="?",
                   const=1, default=0,
                   help="assemble the map with gt poses instead of the "
                        "estimated ones")
    p.add_argument("--write_map_each_frame", type=gflag_bool, nargs="?",
                   const=1, default=0,
                   help="write each registered frame as its own pcd into "
                        "--output_map_point_cloud_folder_path")
    p.add_argument("--output_map_point_cloud_folder_path",
                   default="map_out")
    p.add_argument("--map_filter_on", type=gflag_bool, default=1,
                   help="radius-outlier filter the assembled map (0|1), "
                        "on --device")
    p.add_argument("--output_map_bev", default=None,
                   help="write a birds-eye height image of the map")
    p.add_argument("--output_map_html", default=None,
                   help="write a standalone interactive WebGL viewer (map, "
                        "trajectory and pose-graph edges)")
    p.add_argument("--map_voxel_size", type=float, default=0.25)
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler Chrome trace of the run "
                        "(host and, on the card, CUDA activity) here")
    p.add_argument("--export_feature_frame", type=int, default=None,
                   help="write this frame's per-class feature clouds as pcd "
                        "and a class-coloured HTML view")
    p.add_argument("--export_feature_dir", default="feature_out")
    return p


def _write_poses(path, poses) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    kitti_io.write_kitti_poses(path, poses)


def _export_features(ds, cfg, frame_idx: int, out_dir: str,
                     device) -> None:
    """One frame's per-class feature clouds as pcd files and a
    class-coloured HTML view — the headless stand-in for the reference
    program's feature viewer window (`map_viewer.h:101-224`)."""
    from mulls_tpu_torch.core.cloud import RawCloud
    from mulls_tpu_torch.core.device import resolve_device
    from mulls_tpu_torch.core.draws import GeneratorDraws
    from mulls_tpu_torch.frontend.features import extract_features
    from mulls_tpu_torch.viz.html_viewer import CLASS_NAMES

    dev = resolve_device(device)
    frame = extract_features(RawCloud.from_numpy(ds[frame_idx], dev), cfg,
                             GeneratorDraws(cfg.seed, dev))
    os.makedirs(out_dir, exist_ok=True)
    all_xyz, all_cls, all_i = [], [], []
    for name, cloud in frame.full.items():
        m = cloud.mask.cpu().numpy()
        xyz = cloud.xyz.cpu().numpy()[m]
        inten = cloud.intensity.cpu().numpy()[m]
        write_pcd(os.path.join(out_dir, f"{frame_idx:06d}_{name}.pcd"), xyz,
                  intensity=inten, normals=cloud.normal.cpu().numpy()[m])
        print(f"[mulls_tpu_torch] {name}: {int(m.sum())} pts")
        all_xyz.append(xyz)
        all_cls.append(np.full(int(m.sum()), CLASS_NAMES.index(name)
                               if name in CLASS_NAMES else 0, np.uint8))
        all_i.append(inten)
    export_html_viewer(
        os.path.join(out_dir, f"{frame_idx:06d}_features.html"),
        np.concatenate(all_xyz), np.concatenate(all_cls),
        np.concatenate(all_i), title=f"frame {frame_idx} features")


def main(argv=None) -> int:
    args, extra = build_parser().parse_known_args(argv)
    cfg = load_flagfile(args.flagfile) if args.flagfile else MullsConfig()
    if extra:  # gflags parity: any --name=value accepted on the CLI
        cfg = apply_flag_overrides(cfg, extra)

    if args.semantic_kitti_label_folder:
        ds = SemanticKittiDataset(
            args.point_cloud_folder, args.semantic_kitti_label_folder,
            cfg.shapes.n_raw, begin=args.frame_num_begin,
            end=args.frame_num_end, step=args.frame_step)
        cfg = cfg.replace(feature=dataclasses.replace(
            cfg.feature, semantic_assist_on=True))
    else:
        ds = FolderDataset(args.point_cloud_folder, cfg.shapes.n_raw,
                           ext=args.pc_format, begin=args.frame_num_begin,
                           end=args.frame_num_end, step=args.frame_step)
    print(f"[mulls_tpu_torch] {len(ds)} frames from "
          f"{args.point_cloud_folder}")
    if args.loop_closure_detection_on is not None:
        cfg = cfg.replace(submap=dataclasses.replace(
            cfg.submap,
            loop_closure_detection_on=bool(args.loop_closure_detection_on)))
    if args.baseline_reg_method:
        cfg = cfg.replace(baseline=dataclasses.replace(
            cfg.baseline, method=args.baseline_reg_method))

    if args.export_feature_frame is not None:
        _export_features(ds, cfg, args.export_feature_frame,
                         args.export_feature_dir, args.device)

    prof = None
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if args.device != "cpu":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()

    backend = None
    if cfg.baseline.method:
        # the NDT / VGICP baselines in place of MULLS-ICP
        # (`mulls_slam.cpp:195-198,634-639`)
        res = BaselinePipeline(cfg, device=args.device).run(
            ds, progress=args.progress)
    elif cfg.submap.loop_closure_detection_on:
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

    if prof is not None:
        prof.__exit__(None, None, None)
        os.makedirs(args.profile_dir, exist_ok=True)
        trace = os.path.join(args.profile_dir, "trace.json")
        prof.export_chrome_trace(trace)
        print(f"[mulls_tpu_torch] profiler trace written to {trace}")

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

    if args.write_out_map_on and not args.output_map_pcd:
        os.makedirs(args.output_map_point_cloud_folder_path, exist_ok=True)
        args.output_map_pcd = os.path.join(
            args.output_map_point_cloud_folder_path, "merged_map.pcd")
    map_poses = (gt_lidar if (args.write_out_gt_map_on
                              and gt_lidar is not None) else poses_lidar)
    if args.write_map_each_frame:
        # per-frame registered clouds (`--write_map_each_frame`)
        os.makedirs(args.output_map_point_cloud_folder_path, exist_ok=True)
        for i in range(min(len(ds), len(map_poses))):
            d = ds[i]
            xyz = d["xyz"][d["mask"]]
            if args.map_downrate_output > 1:
                xyz = xyz[::args.map_downrate_output]
            T = map_poses[i]
            moved = xyz @ T[:3, :3].T.astype(np.float32) \
                + T[:3, 3].astype(np.float32)
            write_pcd(os.path.join(args.output_map_point_cloud_folder_path,
                                   f"{i:06d}.pcd"), moved)
    if args.output_map_pcd or args.output_map_bev or args.output_map_html:
        pts = accumulate_map(ds, map_poses, voxel_res=args.map_voxel_size,
                             downrate=args.map_downrate_output)
        if args.map_filter_on:
            pts = radius_outlier_filter(pts, device=args.device)
        write_map_outputs(pts, args.output_map_pcd, args.output_map_bev)
        print(f"[mulls_tpu_torch] map assembled: {len(pts)} points")
        if args.output_map_html:
            # pose-graph edges anchored at each submap's first frame
            traj = map_poses[:, :3, 3]
            edges = None
            if backend is not None and backend.edges:
                anchor = [min(s.frame_begin, len(traj) - 1)
                          for s in backend.submaps]
                edges = [(anchor[e.i], anchor[e.j], e.kind)
                         for e in backend.edges if e.kind >= 1]
            n_emb = export_html_viewer(
                args.output_map_html, pts, trajectory=traj, edges=edges,
                title=os.path.basename(args.point_cloud_folder or "run"))
            print(f"[mulls_tpu_torch] viewer ({n_emb} pts) -> "
                  f"{args.output_map_html}")

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
