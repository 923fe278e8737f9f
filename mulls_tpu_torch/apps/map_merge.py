"""Multi-session map merging CLI — port of ``mulls_tpu/apps/map_merge.py``.

Aligns and fuses the submap graphs of two or more finished SLAM runs
(saved with ``mulls_tpu_torch.apps.slam --checkpoint_path``) into one
globally consistent map; see ``backend/merge.py`` for the algorithm.
Runs on the card by default.

    python -m mulls_tpu_torch.apps.map_merge \\
        --checkpoints runA.ckpt,runB.ckpt --output_dir merged/ \\
        [--flagfile lo_gflag_list_kitti_urban.txt] [--device cpu] \\
        [--output_map_pcd merged/map.pcd] [--output_map_html merged/map.html]

Exit codes: 0 merged, 1 an unusable checkpoint or a session that could
not be localized, 2 fewer than two checkpoints.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

import numpy as np

from mulls_tpu_torch.backend.merge import (merge_sessions, merged_feature_map,
                                           session_from_checkpoint)
from mulls_tpu_torch.config import (MullsConfig, apply_flag_overrides,
                                    load_flagfile)
from mulls_tpu_torch.io.kitti import write_kitti_poses
from mulls_tpu_torch.io.pcd import write_pcd
from mulls_tpu_torch.viz.html_viewer import export_html_viewer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoints", required=True,
                   help="comma-separated SLAM checkpoint files; the first "
                        "is the anchor session (its frame stays fixed)")
    p.add_argument("--flagfile", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) | cpu (plain PyTorch paths)")
    p.add_argument("--output_dir", default="merged_out")
    p.add_argument("--output_map_pcd", default=None,
                   help="write the merged feature map as one pcd")
    p.add_argument("--output_map_html", default=None,
                   help="standalone WebGL viewer of the merged map + "
                        "trajectories + inter-session edges")
    p.add_argument("--json_out", default=None)
    p.add_argument("--min_votes", type=int, default=2,
                   help="minimum agreeing coarse-alignment pairs for a "
                        "session transform")
    p.add_argument("--max_inter_edges", type=int, default=8,
                   help="inter-session fine edges per added session")
    p.add_argument("--progress", action="store_true")
    return p


def main(argv=None) -> int:
    args, extra = build_parser().parse_known_args(argv)
    cfg = load_flagfile(args.flagfile) if args.flagfile else MullsConfig()
    if extra:  # gflags parity: any --name=value accepted on the CLI
        cfg = apply_flag_overrides(cfg, extra)

    paths = [p for p in args.checkpoints.split(",") if p]
    if len(paths) < 2:
        print("need >= 2 checkpoints to merge", file=sys.stderr)
        return 2
    try:
        sessions = [session_from_checkpoint(p) for p in paths]
    except (ValueError, OSError, pickle.UnpicklingError, EOFError) as e:
        # unusable checkpoint: missing file, truncated or corrupt pickle,
        # or an odometry-only run without a back end
        print(f"[merge] FAILED: {e}", file=sys.stderr)
        return 1
    for p, s in zip(paths, sessions):
        print(f"[merge] {p}: {len(s.submaps)} submaps, "
              f"{len(s.edges)} edges, "
              f"{0 if s.poses is None else len(s.poses)} frames")

    try:
        res = merge_sessions(sessions, cfg, min_votes=args.min_votes,
                             max_inter_edges_per_session=args.max_inter_edges,
                             device=args.device)
    except ValueError as e:
        print(f"[merge] FAILED: {e}", file=sys.stderr)
        return 1
    if args.progress:
        for ev in res.events:
            print("  [merge]", ev)
    print(f"[merge] {len(res.submaps)} submaps, {res.inter_edges} "
          f"inter-session edges, joint PGO "
          f"{'accepted' if res.pgo_accepted else 'skipped/vetoed'}")
    for si, T in enumerate(res.session_transforms):
        print(f"[merge] session {si} transform |t|="
              f"{np.linalg.norm(T[:3, 3]):.2f} m")

    os.makedirs(args.output_dir, exist_ok=True)
    for si, poses in enumerate(res.poses):
        if poses is None:
            continue
        out = os.path.join(args.output_dir, f"session_{si}_pose.txt")
        write_kitti_poses(out, poses)
        print(f"[merge] wrote {out}")
    # merged submap node poses (constraint-file companion)
    node_out = os.path.join(args.output_dir, "merged_submap_poses.txt")
    write_kitti_poses(node_out, np.stack([s.pose for s in res.submaps]))
    print(f"[merge] wrote {node_out}")

    if args.output_map_pcd or args.output_map_html:
        xyz, cid, inten = merged_feature_map(res)
        if args.output_map_pcd:
            write_pcd(args.output_map_pcd, xyz, intensity=inten)
            print(f"[merge] wrote {args.output_map_pcd} ({len(xyz):,} pts)")
        if args.output_map_html:
            node_pos = {s.sid: k for k, s in enumerate(res.submaps)}
            sub_traj = np.stack([s.pose[:3, 3] for s in res.submaps])
            edges = [(node_pos[e.i], node_pos[e.j], e.kind)
                     for e in res.edges if e.kind >= 1]
            export_html_viewer(args.output_map_html, xyz, class_id=cid,
                               intensity=inten, trajectory=sub_traj,
                               edges=edges, title="mulls_tpu merged map")
            print(f"[merge] wrote {args.output_map_html}")

    if args.json_out:
        payload = {
            "sessions": len(sessions),
            "submaps": len(res.submaps),
            "inter_edges": res.inter_edges,
            "pgo_accepted": res.pgo_accepted,
            "session_transforms": [T.tolist()
                                   for T in res.session_transforms],
            "timings_ms": res.timings,
            "events": res.events,
        }
        with open(args.json_out, "w") as f:
            json.dump(payload, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
