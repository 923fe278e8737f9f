"""A long SLAM run with a mid-run checkpoint and a resume, run by the port:
the counterpart of ``tools/endurance_run.py``.

Drives ``SlamPipeline`` (loop closure and checkpoints on) over a multi-lap
drive of the bench's urban world (0.8 m/frame, ``MullsConfig()``'s 131k-
point scans; 4,200 frames are ~3.4 km), simulating each scan on demand
from a per-index seed (``worlds.LazyDrive``), then:

- evaluates both KITTI modes, odometry's 100-800 m segments and the
  400-3200 m segments of ``longer_segments_on``;
- records the peak host RSS, ``torch.cuda.max_memory_allocated``, the
  submaps, loop edges, failed and vetoed frames, and the refinement's time;
- keeps the first checkpoint written at or after mid-run, resumes a second
  pipeline from a copy of it, finishes the drive and the refinement, and
  gives the largest and the last pose difference between the two runs.

    python -m mulls_tpu_torch.tools.endurance_run [--frames 4200]
        [--seed 7] [--out docs/ENDURANCE_h100.json] [--device cuda]

``--workdir`` (default ``build/endurance`` under the checkout) holds the
checkpoints.  At ~1-1.6 frames/s with loop closure on the card, 4,200
frames and the resume take well over an hour.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import time

import numpy as np

from mulls_tpu_torch.tools import worlds
from mulls_tpu_torch.tools.accuracy_bench import (CONFIG_DIR, evaluate,
                                                  load_config, peak_rss_mb)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


CHECKPOINT_EVERY = 8  # segments of 8 frames, as the reference's run


def run_endurance(frames: int, seed: int, workdir: str,
                  device="cuda") -> dict:
    """The run, its evaluation and the resume (see the module's doc), on
    the urban flagfile's config, or ``MullsConfig()`` when it is absent,
    with loop closure on."""
    import torch

    from mulls_tpu_torch.core.device import resolve_device
    from mulls_tpu_torch.pipeline import checkpoint as ck_mod
    from mulls_tpu_torch.pipeline.slam import SlamPipeline
    from mulls_tpu_torch.tools.roofline import card_line

    dev = resolve_device(device)
    cfg, cfg_name = load_config(os.path.join(CONFIG_DIR,
                                             "lo_gflag_list_kitti_urban.txt"))
    cfg = cfg.replace(submap=dataclasses.replace(
        cfg.submap, loop_closure_detection_on=True))
    card = card_line(dev)
    print(f"[endurance] {card}", flush=True)

    rng = np.random.default_rng(seed)
    world = worlds.build_world(rng)
    world_g = worlds.loop_trajectory(frames)
    gt = np.einsum("ij,njk->nik", np.linalg.inv(world_g[0]), world_g)
    ds = worlds.LazyDrive(world, world_g, cfg.shapes.n_raw, seed)
    path_len = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0),
                                           axis=1)))
    print(f"[endurance] {frames} frames, {path_len:.0f} m path, "
          f"{len(world):,} world points; config {cfg_name}", flush=True)

    os.makedirs(workdir, exist_ok=True)
    ck_a = os.path.join(workdir, "run_a.ckpt")
    ck_mid = os.path.join(workdir, "mid.ckpt")
    ck_b = os.path.join(workdir, "run_b.ckpt")
    for p in (ck_a, ck_mid, ck_b):
        if os.path.exists(p):
            os.remove(p)

    # keep a copy of the first checkpoint at or after mid-run: the pipeline
    # imports save_checkpoint from the module when it writes one
    half = frames // 2
    real_save = ck_mod.save_checkpoint
    kept = {}

    def hooked_save(path, state, frame_idx, *a, **kw):
        real_save(path, state, frame_idx, *a, **kw)
        if frame_idx >= half and "f" not in kept and path == ck_a:
            shutil.copyfile(ck_a, ck_mid)
            kept["f"] = int(frame_idx)
            print(f"[endurance] mid-run checkpoint kept at frame "
                  f"{frame_idx}", flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ck_mod.save_checkpoint = hooked_save
    try:
        t0 = time.perf_counter()
        pipe = SlamPipeline(cfg, checkpoint_path=ck_a,
                            checkpoint_every=CHECKPOINT_EVERY, device=dev)
        res = pipe.run(ds, progress=True)
        sync()
        t_run = time.perf_counter() - t0
    finally:
        ck_mod.save_checkpoint = real_save
    t1 = time.perf_counter()
    pipe.refine(res)
    sync()
    t_refine = time.perf_counter() - t1
    be = res.backend
    codes = [int(c) for c in res.codes]
    out = {"frames": frames, "seed": seed, "config": cfg_name,
           "device": str(dev), "card": card,
           "path_length_m": path_len, "run_s": t_run, "refine_s": t_refine,
           "fps": frames / t_run, "submaps": len(be.submaps),
           "loop_edges": sum(1 for e in be.edges if e.kind == 2),
           "edges_total": len(be.edges),
           "failed_frames": sum(1 for c in codes if c not in (1, -4)),
           "vetoed_frames": codes.count(-4),
           "mid_checkpoint_frame": kept.get("f"),
           "checkpoint_bytes": os.path.getsize(ck_a)}
    out["odometry_100_800"] = evaluate(gt, res.poses_odom)
    out["slam_100_800"] = evaluate(gt, res.poses)
    out["slam_400_3200"] = evaluate(gt, res.poses, longer=True)
    for k in ("odometry_100_800", "slam_100_800", "slam_400_3200"):
        print(f"[endurance] {k}: {out[k]}", flush=True)
    if "f" not in kept:
        raise RuntimeError("no checkpoint was written at or after mid-run: "
                           "the drive ends within CHECKPOINT_EVERY segments "
                           "of its half")

    print(f"[endurance] resuming from frame {kept['f']} ...", flush=True)
    t2 = time.perf_counter()
    # run B continues from a copy, so its own checkpoints leave the kept
    # mid-run one as it was
    shutil.copyfile(ck_mid, ck_b)
    pipe_b = SlamPipeline(cfg, checkpoint_path=ck_b,
                          checkpoint_every=CHECKPOINT_EVERY, device=dev)
    res_b = pipe_b.run(ds)
    pipe_b.refine(res_b)
    sync()
    out["resume_s"] = time.perf_counter() - t2
    d = np.linalg.norm(res_b.poses[:, :3, 3] - res.poses[:, :3, 3], axis=1)
    out["resume_max_pose_delta_m"] = float(d.max())
    out["resume_end_delta_m"] = float(d[-1])
    out["peak_rss_mb"] = peak_rss_mb()
    out["device_max_memory_allocated"] = (
        int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
        else None)
    print(f"[endurance] resume max pose delta {d.max():.6f} m (end "
          f"{d[-1]:.6f} m); peak RSS {out['peak_rss_mb']:.0f} MiB, device "
          f"max allocated {out['device_max_memory_allocated']}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--frames", type=int, default=4200)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=os.path.join(_REPO, "docs",
                                                  "ENDURANCE_h100.json"))
    ap.add_argument("--workdir", default=os.path.join(_REPO, "build",
                                                      "endurance"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run_endurance(args.frames, args.seed, args.workdir,
                        device=args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
