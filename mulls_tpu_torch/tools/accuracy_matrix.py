"""The accuracy matrix, run by the port: the counterpart of
``tools/run_accuracy_matrix.py``.

Drives ``mulls_tpu_torch.tools.accuracy_bench`` one subprocess at a time
over the reference's job lists, with the same tags and flags:

- ``matrix``: worlds {urban, highway, dynamic} x seeds {7, 23, 1009} x
  {clean, fog} (highway odometry only, on the highway flagfile), the
  highway loop (560 frames), and urban_hard at three levels and a second
  seed;
- ``disc``: the NDT / GICP baselines and the ground-only feature ablation
  on the urban and dynamic worlds;
- ``profiles``: the sensor-profile flagfiles on beam-structured scans, and
  the handheld regime.

Each row writes ``<out>/<tag>.json``; a row whose JSON exists is reused.
A flagfile missing from ``--config_dir`` (the MULLS layout's
``script/config/`` under the checkout by default) runs at
``MullsConfig()`` defaults and its row's ``config`` says so.  The run ends
with the reference's markdown table (plus the vetoed frames), written to
``<out>/MATRIX.md``.

    python -m mulls_tpu_torch.tools.accuracy_matrix [--only all|matrix|
        disc|profiles|TAG,TAG,...] [--frames 420] [--timeout 2100]
        [--out docs/accuracy_h100] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from mulls_tpu_torch.tools.accuracy_bench import CONFIG_DIR

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SEEDS = [7, 23, 1009]  # 7 is the reference's tuning seed
LISTS = ("matrix", "disc", "profiles", "all")

PROFILES = [  # (tag, flagfile, beams)
    ("prof_16", "lo_gflag_list_16.txt", 16),
    ("prof_32", "lo_gflag_list_32.txt", 32),
    ("prof_64", "lo_gflag_list_64.txt", 64),
    ("prof_128", "lo_gflag_list_128.txt", 128),
    ("prof_mulran", "lo_gflag_list_mulran.txt", 64),
    ("prof_newer_college", "lo_gflag_list_newer_college.txt", 64),
    ("prof_ultrafast", "lo_gflag_list_kitti_ultrafast.txt", 0),
]


def build_jobs(frames: int, only: str, config_dir: str = CONFIG_DIR):
    """[(tag, accuracy_bench flags)] of a job list, or of the tags of a
    comma list (each from ``all``)."""
    if only not in LISTS:
        tags = only.split(",")
        jobs = dict(build_jobs(frames, "all", config_dir))
        missing = [t for t in tags if t not in jobs]
        if missing:
            raise ValueError(f"unknown matrix tags {missing}")
        return [(t, jobs[t]) for t in tags]
    highway = os.path.join(config_dir, "lo_gflag_list_kitti_highway.txt")
    jobs = []
    if only in ("matrix", "all"):
        for world in ("urban", "highway", "dynamic"):
            for seed in SEEDS:
                for fog in (False, True):
                    tag = f"{world}_s{seed}{'_fog' if fog else ''}"
                    cmd = ["--world", world, "--seed", str(seed),
                           "--frames", str(frames)]
                    if fog:
                        cmd.append("--fog")
                    if world == "highway":
                        # the highway world on the reference's highway
                        # operating point, odometry only (no loop)
                        cmd += ["--skip_slam", "--config", highway]
                    jobs.append((tag, cmd))
        # the highway loop: sparse geometry with loop closure, 560 frames
        # re-traverse the first ~110 m of mapped road
        for seed, fog in ((7, False), (23, False), (7, True)):
            tag = f"highway_loop_s{seed}{'_fog' if fog else ''}"
            cmd = ["--world", "highway_loop", "--seed", str(seed),
                   "--frames", str(max(frames, 560)), "--config", highway]
            if fog:
                cmd.append("--fog")
            jobs.append((tag, cmd))
        # the difficulty curve: levels 2-3 run lax (cascades at extreme
        # difficulty are the measurement)
        jobs.append(("urban_hard_s7",
                     ["--world", "urban_hard", "--seed", "7",
                      "--frames", str(frames)]))
        for lvl in (2, 3):
            jobs.append((f"urban_hard{lvl}_s7",
                         ["--world", "urban_hard", "--seed", "7",
                          "--hardness", str(lvl), "--frames", str(frames),
                          "--lax_health"]))
        jobs.append(("urban_hard_s23",
                     ["--world", "urban_hard", "--seed", "23",
                      "--frames", str(frames), "--lax_health"]))
    if only in ("disc", "all"):
        # the baselines and the feature ablation on the same worlds: a
        # sharp degradation shows that the worlds discriminate
        for world in ("urban", "dynamic"):
            for seed in SEEDS:
                base = ["--world", world, "--seed", str(seed),
                        "--frames", str(frames), "--lax_health"]
                for mode in ("ndt", "gicp"):
                    jobs.append((f"disc_{mode}_{world}_s{seed}",
                                 base + ["--baseline", mode]))
                jobs.append((f"disc_ablate_{world}_s{seed}",
                             base + ["--ablate_features"]))
        jobs.append(("disc_ndt_urban_hard_s7",
                     ["--world", "urban_hard", "--seed", "7",
                      "--frames", str(frames), "--lax_health",
                      "--baseline", "ndt"]))
    if only in ("profiles", "all"):
        for tag, flagfile, beams in PROFILES:
            cmd = ["--world", "urban", "--seed", "7",
                   "--frames", str(frames),
                   "--config", os.path.join(config_dir, flagfile)]
            if beams:
                cmd += ["--beams", str(beams)]
            jobs.append((tag, cmd))
        # the newer_college flagfile in its own regime: walking pace with
        # handheld carry motion
        jobs.append(("prof_newer_college_handheld",
                     ["--world", "urban", "--seed", "7",
                      "--frames", str(frames), "--beams", "64",
                      "--traj_step", "0.35", "--handheld", "--lax_health",
                      "--config", os.path.join(
                          config_dir, "lo_gflag_list_newer_college.txt")]))
    return jobs


def table_row(tag: str, r: dict) -> str:
    """A row of the reference's table, with the vetoed frames."""
    if "error" in r:
        return f"| {tag} | — | — | — | — | — | {r['error']} | — |"
    o = r.get("odometry", {})
    s = r.get("slam", {})
    return ("| {} | {:.3f} | {:.4f} | {} | {} | {} | {} | {} |".format(
        tag, o.get("t_drift_pct", float("nan")),
        o.get("r_drift_deg_per_m", float("nan")),
        ("{:.3f}".format(s["t_drift_pct"]) if s else "—"),
        ("{:.3f}".format(s["end_gap_m"]) if s else "—"),
        r.get("loop_edges", "—"),
        r.get("odometry_failed_frames", 0),
        r.get("odometry_vetoed_frames", 0)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--only", default="all",
                    help="a job list (matrix, disc, profiles, all) or a "
                         "comma list of tags")
    ap.add_argument("--frames", type=int, default=420)
    ap.add_argument("--timeout", type=float, default=2100.0)
    ap.add_argument("--config_dir", default=CONFIG_DIR)
    ap.add_argument("--out", default=os.path.join(_REPO, "docs",
                                                  "accuracy_h100"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    jobs = build_jobs(args.frames, args.only, args.config_dir)
    print(f"[matrix] {len(jobs)} runs", flush=True)
    results = {}
    for n, (tag, cmd) in enumerate(jobs):
        jpath = os.path.join(args.out, f"{tag}.json")
        if os.path.exists(jpath):
            with open(jpath) as f:
                results[tag] = json.load(f)
            print(f"[matrix] {tag}: cached", flush=True)
            continue
        t0 = time.time()
        full = [sys.executable, "-m", "mulls_tpu_torch.tools.accuracy_bench",
                "--json_out", jpath, "--device", args.device] + cmd
        print(f"[matrix] ({n + 1}/{len(jobs)}) {tag} ...", flush=True)
        try:
            p = subprocess.run(full, timeout=args.timeout,
                               capture_output=True, text=True, cwd=_REPO)
            if p.returncode == 0 and os.path.exists(jpath):
                with open(jpath) as f:
                    results[tag] = json.load(f)
            else:
                print(f"[matrix] {tag} FAILED rc={p.returncode}\n"
                      + (p.stdout or "")[-1500:]
                      + (p.stderr or "")[-1500:], flush=True)
                results[tag] = {"error": f"rc={p.returncode}"}
                # a row that failed its health policy is not reused
                if os.path.exists(jpath):
                    os.replace(jpath, jpath[:-5] + ".failed.json")
        except subprocess.TimeoutExpired:
            print(f"[matrix] {tag} TIMEOUT", flush=True)
            results[tag] = {"error": "timeout"}
        print(f"[matrix] {tag} done in {time.time() - t0:.0f}s", flush=True)

    lines = ["| run | odom drift % | odom deg/m | slam drift % | "
             "slam end-gap m | loop edges | failed frames | vetoed frames |",
             "|---|---|---|---|---|---|---|---|"]
    lines += [table_row(tag, results[tag]) for tag, _ in jobs
              if tag in results]
    table = "\n".join(lines)
    with open(os.path.join(args.out, "MATRIX.md"), "w") as f:
        f.write(table + "\n")
    print(table, flush=True)
    bad = [t for t, r in results.items() if "error" in r]
    print(f"[matrix] complete, {len(bad)} failures: {bad}", flush=True)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
