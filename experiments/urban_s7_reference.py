"""The JAX reference's odometry on the ``urban_s7`` row's frames at
``MullsConfig()`` defaults, and where the port's run of the same frames
parts from it.

Builds the urban world and the loop trajectory of
``tools/synthetic_accuracy_bench.py`` from ``--seed`` exactly as
``mulls_tpu_torch/tools/accuracy_row.py`` does (``tools/worlds.py``: the
same draws in the same order), runs ``mulls_tpu``'s ``OdometryPipeline`` over ``--frames`` scans
on the CPU, prints the drift columns of the accuracy matrix and writes the
per-frame poses and codes to ``--out`` (npz).  With ``--port FILE.json``
(the port's ``accuracy_row --out`` record, which carries its odometry
poses and codes) it prints both rows, each with its per-frame relative
motion's error against the truth, and the first frame whose code or
relative motion (beyond 2 cm / 0.2 deg, the parity tests' bound) differs.

    JAX_PLATFORMS=cpu python -m experiments.urban_s7_reference \\
        --frames 420 --out ref.npz [--port port.json]
    python -m experiments.urban_s7_reference --ref ref.npz --port port.json

Kept outside both packages: it imports the JAX package, and the port's
numbers come from its own tool on the card.  At full width on a CPU the
reference takes several seconds a frame.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

BOUND = (0.02, 0.2)  # m, deg: per-frame relative motion, as the parity tests


def _rot_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    M = Ra.T @ Rb
    s = np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                        M[1, 0] - M[0, 1]]) / 2.0
    return float(np.degrees(np.arctan2(s, (np.trace(M) - 1.0) / 2.0)))


def _row(gt: np.ndarray, poses: np.ndarray, codes) -> dict:
    from mulls_tpu.eval import kitti_metrics as km
    summ = km.summarize(km.compute_error(gt, poses))
    bad = [i for i, c in enumerate(codes) if c not in (1, -4)]
    rel = lambda p: np.linalg.inv(p[:-1]) @ p[1:]
    err = np.linalg.norm(rel(poses)[:, :3, 3] - rel(gt)[:, :3, 3], axis=1)
    return {"t_drift_pct": summ["ate_percent"],
            "median_rel_err_m": float(np.median(err)),
            "max_rel_err_m": float(err.max()),
            "r_drift_deg_per_m": summ["are_deg_per_m"],
            "end_gap_m": float(np.linalg.norm(poses[-1, :3, 3]
                                              - gt[-1, :3, 3])),
            "failed_frames": len(bad), "failed_frame_indices": bad[:32]}


def run_reference(seed: int, n_frames: int) -> dict:
    from mulls_tpu.config import MullsConfig
    from mulls_tpu.pipeline.odometry import OdometryPipeline
    from mulls_tpu_torch.tools.worlds import make_run

    cfg = MullsConfig()
    t0 = time.perf_counter()
    scans, gt, _ = make_run("urban", seed, n_frames, cfg.shapes.n_raw)
    print(f"[reference] {n_frames} scans simulated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    res = OdometryPipeline(cfg).run(scans)
    secs = time.perf_counter() - t0
    print(f"[reference] odometry {n_frames} frames in {secs:.1f} s",
          flush=True)
    return {"poses": np.asarray(res.poses), "codes": np.asarray(res.codes),
            "gt": gt, "seconds": secs}


def first_parting(ref: dict, port_poses: np.ndarray, port_codes) -> dict:
    """The first frame whose code differs and the first whose relative
    motion differs beyond ``BOUND``, with the largest differences."""
    rp, pp = ref["poses"], port_poses
    rel_r = np.linalg.inv(rp[:-1]) @ rp[1:]
    rel_p = np.linalg.inv(pp[:-1]) @ pp[1:]
    dt = np.linalg.norm(rel_r[:, :3, 3] - rel_p[:, :3, 3], axis=1)
    dr = np.array([_rot_deg(a[:3, :3], b[:3, :3])
                   for a, b in zip(rel_r, rel_p)])
    over = np.nonzero((dt >= BOUND[0]) | (dr >= BOUND[1]))[0]
    codes_r = [int(c) for c in ref["codes"]]
    codes_p = [int(c) for c in port_codes]
    code_diff = [i for i, (a, b) in enumerate(zip(codes_r, codes_p))
                 if a != b]
    return {"first_motion_parting_frame": (int(over[0]) + 1 if len(over)
                                           else None),
            "frames_over_bound": int(len(over)),
            "first_code_parting_frame": code_diff[0] if code_diff else None,
            "max_rel_dt_m": float(dt.max()), "max_rel_dr_deg": float(dr.max()),
            "median_rel_dt_m": float(np.median(dt))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--frames", type=int, default=420)
    ap.add_argument("--out", default=None, help="write the reference's "
                    "poses and codes (npz)")
    ap.add_argument("--ref", default=None, help="read them instead of "
                    "running the reference")
    ap.add_argument("--port", default=None, help="the port's accuracy_row "
                    "record (JSON)")
    args = ap.parse_args(argv)

    if args.ref:
        z = np.load(args.ref)
        ref = {k: z[k] for k in z.files}
    else:
        ref = run_reference(args.seed, args.frames)
        if args.out:
            np.savez(args.out, **ref)
    out = {"reference": _row(ref["gt"], ref["poses"], ref["codes"])}
    if args.port:
        with open(args.port) as f:
            rec = json.load(f)
        port_poses = np.asarray(rec["odometry_poses"], np.float64)
        n = min(len(port_poses), len(ref["poses"]))
        out["frames"] = n
        out["port"] = _row(ref["gt"][:n], port_poses[:n],
                           rec["odometry_codes"][:n])
        out["parting"] = first_parting(
            {"poses": ref["poses"][:n], "codes": ref["codes"][:n]},
            port_poses[:n], rec["odometry_codes"][:n])
    print(json.dumps(out, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main())
