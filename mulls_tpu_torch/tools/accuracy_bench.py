"""The synthetic accuracy bench, run by the port: the counterpart of
``tools/synthetic_accuracy_bench.py``'s ``main``.

Builds one run of the bench's worlds (``tools/worlds.py``: urban, highway,
dynamic, highway_loop, urban_hard; fog, beam-structured sensors, a
handheld gait), runs the port's ``OdometryPipeline`` (or, with
``--baseline``, its NDT / GICP ``BaselinePipeline``), holds the codes to
the bench's health policy, then runs ``SlamPipeline`` with loop closure
and the end-of-run refinement and checks each loop edge against the
truth.  The row's keys are the bench's; the port adds its per-frame codes
and poses, the edges, peak memory and the card's name and power limit.

    python -m mulls_tpu_torch.tools.accuracy_bench --world dynamic \\
        --seed 1009 [--frames 420] [--fog] [--beams 16] [--hardness 2]
        [--traj_step 0.35] [--handheld] [--baseline ndt|gicp]
        [--ablate_features] [--lax_health] [--skip_odometry] [--skip_slam]
        [--events] [--config FLAGFILE] [--json_out FILE] [--device cuda]

``--config`` defaults to the urban flagfile at the MULLS layout's
``script/config/`` under the checkout; when it is absent the run is at
``MullsConfig()`` defaults, as the bench's is, and the row's ``config``
says so.  On the card a row of 420 frames takes ~2 min of odometry and
~5 min of SLAM; without a card it raises unless ``--device cpu`` is
given, which at full width takes hours.  Exit code 1 when the health
policy fails (the row is still written, with ``health_error``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

from mulls_tpu_torch.tools import worlds

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "script", "config")
VETO_STRETCH_MAX = 8  # frames held by the mover veto in a row
LOOP_EDGE_WRONG_M = 1.0  # the bench calls a loop edge wrong beyond this


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--frames", type=int, default=420)
    ap.add_argument("--config", default=os.path.join(
        CONFIG_DIR, "lo_gflag_list_kitti_urban.txt"),
        help="flagfile; MullsConfig() defaults when the file is absent")
    ap.add_argument("--json_out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--events", action="store_true",
                    help="print the back end's decision log")
    ap.add_argument("--skip_odometry", action="store_true")
    ap.add_argument("--skip_slam", action="store_true")
    ap.add_argument("--world", default="urban", choices=list(worlds.WORLDS))
    ap.add_argument("--baseline", default="", choices=["", "ndt", "gicp"],
                    help="run the NDT / VGICP baseline odometry instead")
    ap.add_argument("--ablate_features", action="store_true",
                    help="ground features only (used_feature_type 100000)")
    ap.add_argument("--hardness", type=int, default=1,
                    help="urban_hard level 1-3")
    ap.add_argument("--traj_step", type=float, default=0.0,
                    help="trajectory step in m/frame (0: the world's)")
    ap.add_argument("--handheld", action="store_true",
                    help="handheld carry motion on the trajectory")
    ap.add_argument("--lax_health", action="store_true",
                    help="record the health policy's verdict, do not fail")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--beams", type=int, default=0,
                    help="scanner elevation beams (0: dense sampling)")
    ap.add_argument("--fog", action="store_true",
                    help="20 m sensor range on frames 25-40 %% of the run")
    return ap


def load_config(path: str):
    """(config, its name): the flagfile, or ``MullsConfig()`` when absent."""
    from mulls_tpu_torch.config import MullsConfig, load_flagfile
    if path and os.path.exists(path):
        return load_flagfile(path), os.path.basename(path)
    return MullsConfig(), "MullsConfig()"


def row_config(args, cfg):
    """The bench's config edits: a baseline or the feature ablation skip
    SLAM (``args`` is changed in place, as the bench does)."""
    if args.baseline:
        cfg = cfg.replace(baseline=dataclasses.replace(
            cfg.baseline, method=args.baseline))
        args.skip_slam = True
    if args.ablate_features:
        cfg = cfg.replace(reg=dataclasses.replace(
            cfg.reg, used_feature_type="100000"))
        args.skip_slam = True
    return cfg


def sensor_v_err(cfg) -> float:
    """The vertical-angle intrinsic the config's calibration undoes."""
    p = cfg.preprocess
    return (p.vertical_ang_correction_deg
            if p.vertical_ang_calib_on
            and 0.0 < p.vertical_ang_correction_deg < 180.0 else 0.0)


def health(codes, fog_span: tuple, fog: bool) -> tuple:
    """(the row's code counts, the policy's failures) as the bench has
    them: failed = codes other than 1 and the veto's -4; at most
    ``VETO_STRETCH_MAX`` vetoed frames in a row; outside the fog bank (and
    3 frames after it) no two failed frames in a row and at most 3 (5 with
    fog) failed frames."""
    bad = [i for i, c in enumerate(codes) if c not in (1, -4)]
    held = [i for i, c in enumerate(codes) if c == -4]
    run_len = cur = 0
    prev = None
    for i in held:
        cur = cur + 1 if prev == i - 1 else 1
        run_len = max(run_len, cur)
        prev = i
    lo, hi = fog_span
    outside = [i for i in bad if not (lo <= i < hi + 3)] if fog else bad
    errors = []
    if run_len > VETO_STRETCH_MAX:
        errors.append(f"mover veto stretch too long: {held}")
    if any(j == i + 1 for i, j in zip(outside, outside[1:])):
        errors.append(f"failure cascade: {outside}")
    if len(outside) > (5 if fog else 3):
        errors.append(f"too many failures: {outside}")
    counts = {"odometry_failed_frames": len(bad),
              "odometry_failed_frame_indices": bad[:32],
              "odometry_vetoed_frames": len(held),
              "odometry_vetoed_frame_indices": held[:32],
              "odometry_veto_stretch": run_len}
    return counts, errors


def evaluate(gt: np.ndarray, poses: np.ndarray, longer: bool = False
             ) -> dict:
    """The bench's columns; ``longer``: KITTI's 400-3200 m segments."""
    from mulls_tpu_torch.eval import kitti_metrics as km
    summ = km.summarize(km.compute_error(gt, poses,
                                         longer_segments_on=longer))
    return {"t_drift_pct": summ["ate_percent"],
            "r_drift_deg_per_m": summ["are_deg_per_m"],
            "ate_rmse_m": km.ate_rmse(gt, poses),
            "end_gap_m": float(np.linalg.norm(poses[-1, :3, 3]
                                              - gt[-1, :3, 3])),
            "segments": summ.get("num_segments", 0)}


def peak_rss_mb() -> float:
    """The process's peak resident set in MiB (``ru_maxrss``, KiB)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def run_row(args, cfg=None, device="cuda", draws=None) -> dict:
    """One row of the matrix.  ``cfg``: the config before the row's edits
    (default: ``args.config``, or ``MullsConfig()``); ``draws``: the front
    end's random stream (default: a generator seeded from ``cfg.seed``).
    Raises when ``device`` is ``cuda`` and no card is present."""
    import torch

    from mulls_tpu_torch.core.device import resolve_device
    from mulls_tpu_torch.pipeline.odometry import OdometryPipeline
    from mulls_tpu_torch.pipeline.slam import SlamPipeline
    from mulls_tpu_torch.tools.roofline import card_line

    dev = resolve_device(device)
    if cfg is None:
        cfg, cfg_name = load_config(args.config)
    else:
        from mulls_tpu_torch.config import MullsConfig
        cfg_name = "MullsConfig()" if cfg == MullsConfig() else "given"
    cfg = row_config(args, cfg)
    card = card_line(dev)
    print(f"[accuracy] {card}", flush=True)

    t0 = time.perf_counter()
    scans, gt, meta = worlds.make_run(
        args.world, args.seed, args.frames, cfg.shapes.n_raw, fog=args.fog,
        beams=args.beams, hardness=args.hardness, traj_step=args.traj_step,
        handheld=args.handheld, v_err=sensor_v_err(cfg))
    fog_span = tuple(meta["fog"] or (0, 0))
    out = {"frames": args.frames, "world": args.world, "seed": args.seed,
           "beams": args.beams, "config": cfg_name, "fog": meta["fog"],
           "loop_length_m": meta["loop_length_m"], "device": str(dev),
           "card": card, "simulate_s": time.perf_counter() - t0}
    print(f"[accuracy] {args.world} seed {args.seed}: {args.frames} scans "
          f"({meta['world_points']:,} world points, {out['loop_length_m']:.1f}"
          f" m) in {out['simulate_s']:.1f} s; config {cfg_name}", flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if not args.skip_odometry:
        sync()
        t0 = time.perf_counter()
        if args.baseline:
            from mulls_tpu_torch.pipeline.baseline import BaselinePipeline
            out["baseline"] = args.baseline
            odo = BaselinePipeline(cfg, device=dev, draws=draws).run(scans)
        else:
            odo = OdometryPipeline(cfg, device=dev, draws=draws).run(scans)
        sync()
        out["odometry_fps"] = args.frames / (time.perf_counter() - t0)
        counts, errors = health(odo.codes, fog_span, args.fog)
        out.update(counts)
        out["odometry"] = evaluate(gt, odo.poses)
        out["odometry_codes"] = [int(c) for c in odo.codes]
        out["odometry_poses"] = np.asarray(odo.poses).tolist()
        if errors:
            out["health_error"] = "; ".join(errors)
        o = out["odometry"]
        print(f"[accuracy] odometry: drift {o['t_drift_pct']:.4f} % / "
              f"{o['r_drift_deg_per_m']:.5f} deg/m, ATE {o['ate_rmse_m']:.3f}"
              f" m, end gap {o['end_gap_m']:.3f} m; failed "
              f"{counts['odometry_failed_frame_indices']}, vetoed "
              f"{counts['odometry_vetoed_frame_indices']}; "
              f"{out['odometry_fps']:.2f} frames/s"
              + (f"; health: {out['health_error']}" if errors else ""),
              flush=True)

    if not args.skip_slam:
        cfg_slam = cfg.replace(submap=dataclasses.replace(
            cfg.submap, loop_closure_detection_on=True))
        sync()
        t0 = time.perf_counter()
        pipe = SlamPipeline(cfg_slam, device=dev, frontend_draws=draws)
        res = pipe.run(scans)
        pipe.refine(res)
        sync()
        out["slam_fps"] = args.frames / (time.perf_counter() - t0)
        be = res.backend
        out["submaps"] = len(be.submaps)
        out["loop_edges"] = sum(1 for e in be.edges if e.kind == 2)
        out["slam"] = evaluate(gt, res.poses)
        # a submap's pose is its last frame's: the true edge is
        # gt[fe_i]^-1 gt[fe_j]
        fe = {s.sid: s.frame_end for s in be.submaps}
        diag, edges = [], []
        for e in be.edges:
            T = np.asarray(e.T, np.float64)
            d = {"i": e.i, "j": e.j, "kind": e.kind,
                 "confidence": float(e.confidence)}
            if e.kind != 1:
                T_gt = np.linalg.inv(gt[fe[e.i]]) @ gt[fe[e.j]]
                d["t_err_m"] = float(np.linalg.norm(T[:3, 3] - T_gt[:3, 3]))
                diag.append({k: (round(v, 3) if isinstance(v, float) else v)
                             for k, v in d.items()})
            edges.append({**d, "T": T.tolist()})
        out["reg_edge_diag"] = diag
        out["edges"] = edges
        out["slam_codes"] = [int(c) for c in res.codes]
        out["slam_poses"] = np.asarray(res.poses).tolist()
        n_wrong = sum(1 for d in diag if d["t_err_m"] > LOOP_EDGE_WRONG_M)
        s = out["slam"]
        print(f"[accuracy] SLAM: drift {s['t_drift_pct']:.4f} % / "
              f"{s['r_drift_deg_per_m']:.5f} deg/m, end gap "
              f"{s['end_gap_m']:.3f} m; {out['submaps']} submaps, "
              f"{out['loop_edges']} loop edges ({len(diag)} registration "
              f"edges, {n_wrong} wrong > {LOOP_EDGE_WRONG_M} m); "
              f"{out['slam_fps']:.2f} frames/s", flush=True)
        if args.events:
            for ev in be.events:
                print("  [backend]", ev, flush=True)

    out["device_max_memory_allocated"] = (
        int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
        else None)
    out["peak_rss_mb"] = peak_rss_mb()
    return out


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    out = run_row(args, device=args.device)
    per_frame = ("odometry_poses", "odometry_codes", "slam_poses",
                 "slam_codes", "edges")
    print(json.dumps({k: v for k, v in out.items() if k not in per_frame}),
          flush=True)
    if args.json_out:
        os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(out, f)
    return 1 if "health_error" in out and not args.lax_health else 0


if __name__ == "__main__":
    sys.exit(main())
