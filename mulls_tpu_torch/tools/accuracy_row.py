"""One row of the reference's accuracy matrix, run by the port.

Builds the urban world and the loop trajectory of
``tools/synthetic_accuracy_bench.py`` (loaded by path: its top level
imports only numpy, and this module imports nothing of ``mulls_tpu``) from
``--seed``, simulates ``--frames`` scans at ``MullsConfig()`` defaults as
the bench does, and runs the port's ``OdometryPipeline``, then its
``SlamPipeline`` with loop closure and the end-of-run refinement.  Prints
the matrix's columns (odometry drift %, deg/m, SLAM drift %, SLAM end
gap, loop edges, failed frames) through ``eval/kitti_metrics.py``, for
seed 7 and 420 frames beside the reference's row of
``docs/accuracy/MATRIX.md`` (made with the reference's urban flagfile,
which this repository does not hold).

    python -m mulls_tpu_torch.tools.accuracy_row [--seed 7] [--frames 420]
        [--device cuda] [--out FILE.json] [--skip_slam]

Full width on the card takes ~10 minutes (420 frames twice); without a
card it raises unless ``--device cpu`` is passed, which at this width
takes hours.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time

import numpy as np

# the reference's urban_s7 row (docs/accuracy/MATRIX.md:3): odometry
# drift %, deg/m, SLAM drift %, SLAM end gap m, loop edges, failed frames
REFERENCE_S7 = (0.011, 0.0001, 0.010, 0.015, 15, 0)


def load_bench():
    """``tools/synthetic_accuracy_bench.py`` as a module, by path."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tools", "synthetic_accuracy_bench.py")
    spec = importlib.util.spec_from_file_location("synthetic_accuracy_bench",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def urban_frames(seed: int, n_frames: int, n_raw: int):
    """(scans, ground-truth poses relative to frame 0) of the bench's
    urban world: its draws in its order (the world, then each scan)."""
    bench = load_bench()
    rng = np.random.default_rng(seed)
    world = bench.build_world(rng)
    world_g = bench.loop_trajectory(n_frames)
    gt = np.einsum("ij,njk->nik", np.linalg.inv(world_g[0]), world_g)
    scans = [bench.simulate(world, world_g[k], n_raw, rng)
             for k in range(n_frames)]
    return scans, gt


def evaluate(gt: np.ndarray, poses: np.ndarray) -> dict:
    from mulls_tpu_torch.eval import kitti_metrics as km
    summ = km.summarize(km.compute_error(gt, poses))
    return {"t_drift_pct": summ["ate_percent"],
            "r_drift_deg_per_m": summ["are_deg_per_m"],
            "ate_rmse_m": km.ate_rmse(gt, poses),
            "end_gap_m": float(np.linalg.norm(poses[-1, :3, 3]
                                              - gt[-1, :3, 3]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--frames", type=int, default=420)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="the record (JSON), with "
                    "the odometry's per-frame poses and codes")
    ap.add_argument("--skip_slam", action="store_true",
                    help="odometry only, as the reference bench's flag")
    args = ap.parse_args(argv)

    import torch

    from mulls_tpu_torch.config import MullsConfig
    from mulls_tpu_torch.core.device import resolve_device
    from mulls_tpu_torch.pipeline.odometry import OdometryPipeline
    from mulls_tpu_torch.pipeline.slam import SlamPipeline
    from mulls_tpu_torch.tools.roofline import card_line

    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    cfg = MullsConfig()
    t0 = time.perf_counter()
    scans, gt = urban_frames(args.seed, args.frames, cfg.shapes.n_raw)
    out = {"seed": args.seed, "frames": args.frames, "device": str(dev),
           "loop_length_m": float(np.sum(np.linalg.norm(
               np.diff(gt[:, :3, 3], axis=0), axis=1))),
           "simulate_s": time.perf_counter() - t0}
    print(f"[accuracy] urban seed {args.seed}: {args.frames} scans over "
          f"{out['loop_length_m']:.1f} m simulated in "
          f"{out['simulate_s']:.1f} s", flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    sync()
    t0 = time.perf_counter()
    odo = OdometryPipeline(cfg, device=dev).run(scans)
    sync()
    out["odometry_fps"] = args.frames / (time.perf_counter() - t0)
    # the bench's count: codes other than 1 and the mover veto's -4
    bad = [i for i, c in enumerate(odo.codes) if c not in (1, -4)]
    out["odometry_failed_frames"] = len(bad)
    out["odometry_failed_frame_indices"] = bad[:32]
    out["odometry"] = evaluate(gt, odo.poses)
    o = out["odometry"]
    print(f"[accuracy] odometry: drift {o['t_drift_pct']:.4f} % / "
          f"{o['r_drift_deg_per_m']:.5f} deg/m, end gap {o['end_gap_m']:.4f}"
          f" m, failed frames {bad}, {out['odometry_fps']:.2f} frames/s",
          flush=True)
    if args.skip_slam:
        _write(args.out, out, odo)
        return 0

    cfg_slam = cfg.replace(submap=dataclasses.replace(
        cfg.submap, loop_closure_detection_on=True))
    sync()
    t0 = time.perf_counter()
    pipe = SlamPipeline(cfg_slam, device=dev)
    res = pipe.run(scans)
    pipe.refine(res)
    sync()
    out["slam_fps"] = args.frames / (time.perf_counter() - t0)
    be = res.backend
    out["submaps"] = len(be.submaps)
    out["loop_edges"] = sum(1 for e in be.edges if e.kind == 2)
    out["slam"] = evaluate(gt, res.poses)
    # a loop edge against the truth: a submap's pose is its last frame's
    fe = {s.sid: s.frame_end for s in be.submaps}
    out["loop_edge_t_err_m"] = [
        float(np.linalg.norm(e.T[:3, 3] - (np.linalg.inv(gt[fe[e.i]])
                                           @ gt[fe[e.j]])[:3, 3]))
        for e in be.edges if e.kind == 2]

    o, s = out["odometry"], out["slam"]
    row = (o["t_drift_pct"], o["r_drift_deg_per_m"], s["t_drift_pct"],
           s["end_gap_m"], out["loop_edges"], len(bad))
    print("| run | odom drift % | odom deg/m | slam drift % | slam end-gap m "
          "| loop edges | failed frames |", flush=True)
    print(f"| port urban_s{args.seed} | {row[0]:.3f} | {row[1]:.4f} | "
          f"{row[2]:.3f} | {row[3]:.3f} | {row[4]} | {row[5]} |", flush=True)
    if args.seed == 7 and args.frames == 420:
        ref = REFERENCE_S7
        print(f"| reference urban_s7 | {ref[0]:.3f} | {ref[1]:.4f} | "
              f"{ref[2]:.3f} | {ref[3]:.3f} | {ref[4]} | {ref[5]} |",
              flush=True)
    print(f"[accuracy] odometry {out['odometry_fps']:.2f} frames/s, SLAM "
          f"{out['slam_fps']:.2f} frames/s; {out['submaps']} submaps; loop "
          f"edges' errors {[round(e, 3) for e in out['loop_edge_t_err_m']]}"
          f" m; failed frames {bad}", flush=True)
    print(json.dumps(out), flush=True)
    _write(args.out, out, odo)
    return 0


def _write(path, out: dict, odo) -> None:
    if not path:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({**out, "odometry_codes": odo.codes,
                   "odometry_poses": odo.poses.tolist()}, f, indent=2)


if __name__ == "__main__":
    sys.exit(main())
