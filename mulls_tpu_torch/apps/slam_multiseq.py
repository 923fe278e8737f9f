"""Fleet-mode CLI: many sequences, one device mesh — port of
``mulls_tpu/apps/slam_multiseq.py``.

Runs LiDAR odometry over MANY scan folders at once, the sequences on the
mesh's entries in contiguous blocks (``parallel/multiseq.py``): on one
card a process steps its sequences as one batch.  With several
processes, set ``MULLS_TPU_COORDINATOR`` / ``MULLS_TPU_NUM_PROCESSES`` /
``MULLS_TPU_PROCESS_ID`` or run under torchrun
(``parallel/distributed.py``); each rank then batches its block of
sequences on its card.  Ranks may share a card (gloo); ``PERF.md`` §6
has the aggregate rates measured on one card.

    python -m mulls_tpu_torch.apps.slam_multiseq \\
        --sequence_parent /data/kitti/sequences --pc_subdir velodyne \\
        --flagfile lo_gflag_list_kitti_urban.txt --output_dir out/

Runs on ``cuda`` by default; ``--device cpu`` runs the plain paths on the
CPU (``--n_devices N`` lists the CPU N times).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--sequence_folders", default=None,
                   help="comma-separated scan folders (one per sequence)")
    p.add_argument("--sequence_parent", default=None,
                   help="parent dir: every subfolder is a sequence")
    p.add_argument("--pc_subdir", default="",
                   help="scan subfolder within each sequence dir "
                        "(e.g. 'velodyne' for KITTI)")
    p.add_argument("--pc_format", default=None)
    p.add_argument("--flagfile", default=None)
    p.add_argument("--frame_num_begin", type=int, default=0)
    p.add_argument("--frame_num_end", type=int, default=None)
    p.add_argument("--output_dir", default="multiseq_out")
    p.add_argument("--segment", type=int, default=16)
    p.add_argument("--n_devices", type=int, default=None)
    p.add_argument("--progress", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args, extra = build_parser().parse_known_args(argv)
    from mulls_tpu_torch.config import (MullsConfig, apply_flag_overrides,
                                        load_flagfile)
    from mulls_tpu_torch.parallel import distributed as dist

    multi = dist.initialize_from_env()

    cfg = (load_flagfile(args.flagfile) if args.flagfile else MullsConfig())
    if extra:
        cfg = apply_flag_overrides(cfg, extra)

    if args.sequence_folders:
        folders = [f for f in args.sequence_folders.split(",") if f]
    elif args.sequence_parent:
        folders = sorted(
            os.path.join(args.sequence_parent, d, args.pc_subdir)
            for d in os.listdir(args.sequence_parent)
            if os.path.isdir(os.path.join(args.sequence_parent, d)))
    else:
        print("need --sequence_folders or --sequence_parent",
              file=sys.stderr)
        return 2

    from mulls_tpu_torch.io import native
    from mulls_tpu_torch.io.dataset import FolderDataset
    from mulls_tpu_torch.io.kitti import write_kitti_poses
    from mulls_tpu_torch.parallel.mesh import make_mesh
    from mulls_tpu_torch.parallel.multiseq import MultiSeqPipeline

    datasets = [FolderDataset(f, cfg.shapes.n_raw, ext=args.pc_format,
                              begin=args.frame_num_begin,
                              end=args.frame_num_end) for f in folders]
    n_true = len(datasets)
    mesh = (dist.global_mesh(device=args.device) if multi
            else make_mesh(args.n_devices, device=args.device))
    padded = dist.shard_sequences(datasets, mesh)
    print(f"[mulls_tpu_torch multiseq] {n_true} sequences "
          f"({len(padded)} shards) on {mesh.size} mesh entries "
          f"({', '.join(str(d) for d in mesh.devices)}; {dist.describe()}); "
          f"reader: {'native' if native.native_available() else 'numpy'}",
          flush=True)

    pipe = MultiSeqPipeline(cfg, mesh, segment=args.segment)
    t0 = time.perf_counter()
    results = pipe.run(padded, progress=args.progress)[:n_true]
    dt = time.perf_counter() - t0
    total = sum(len(r.poses) for r in results)
    print(f"[mulls_tpu_torch multiseq] {total} frames in {dt:.1f} s "
          f"({total / dt:.1f} fps aggregate)")
    if mesh.rank != 0:  # every rank holds every result; one writes them
        return 0

    os.makedirs(args.output_dir, exist_ok=True)
    summary = {}
    seen = {}
    for folder, res in zip(folders, results):
        name = os.path.basename(os.path.dirname(folder.rstrip("/"))
                                if args.pc_subdir else folder.rstrip("/"))
        if name in seen:  # duplicate basenames: disambiguate by index
            seen[name] += 1
            name = f"{name}_{seen[name]}"
        else:
            seen[name] = 0
        out = os.path.join(args.output_dir, f"{name}_pose.txt")
        write_kitti_poses(out, res.poses)
        ok = int(np.sum(np.asarray(res.codes) == 1))
        summary[name] = {"frames": len(res.poses), "ok_frames": ok,
                         "mean_sigma": float(np.mean(res.sigmas))}
        print(f"  {name}: {len(res.poses)} poses -> {out} "
              f"(ok {ok}, mean sigma {np.mean(res.sigmas):.4f})")
    with open(os.path.join(args.output_dir, "summary.json"), "w") as f:
        json.dump({"fps_aggregate": total / dt, "sequences": summary},
                  f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
