"""The ``urban_s7`` row of the reference's accuracy matrix, run by the port.

A thin wrapper over ``accuracy_bench.run_row`` for the urban world at
``MullsConfig()`` defaults: odometry, then ``SlamPipeline`` with loop
closure and the refinement.  Prints the matrix's columns (odometry drift
%, deg/m, SLAM drift %, SLAM end gap, loop edges, failed frames), for seed
7 and 420 frames beside the reference's row of ``docs/accuracy/MATRIX.md``
(made with the reference's urban flagfile, which this repository does not
hold).

    python -m mulls_tpu_torch.tools.accuracy_row [--seed 7] [--frames 420]
        [--device cuda] [--out FILE.json] [--skip_slam]

Full width on the card takes ~10 minutes (420 frames twice); without a
card it raises unless ``--device cpu`` is passed, which at this width
takes hours.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from mulls_tpu_torch.tools import accuracy_bench

# the reference's urban_s7 row (docs/accuracy/MATRIX.md:3): odometry
# drift %, deg/m, SLAM drift %, SLAM end gap m, loop edges, failed frames
REFERENCE_S7 = (0.011, 0.0001, 0.010, 0.015, 15, 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--frames", type=int, default=420)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="the record (JSON), with "
                    "the per-frame poses and codes")
    ap.add_argument("--skip_slam", action="store_true",
                    help="odometry only, as the reference bench's flag")
    args = ap.parse_args(argv)

    row_args = accuracy_bench.parser().parse_args(
        ["--world", "urban", "--seed", str(args.seed), "--frames",
         str(args.frames), "--lax_health"]
        + (["--skip_slam"] if args.skip_slam else []))
    from mulls_tpu_torch.config import MullsConfig
    out = accuracy_bench.run_row(row_args, cfg=MullsConfig(),
                                 device=args.device)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f)
    if args.skip_slam:
        return 0
    o, s = out["odometry"], out["slam"]
    row = (o["t_drift_pct"], o["r_drift_deg_per_m"], s["t_drift_pct"],
           s["end_gap_m"], out["loop_edges"], out["odometry_failed_frames"])
    print("| run | odom drift % | odom deg/m | slam drift % | slam end-gap m "
          "| loop edges | failed frames |", flush=True)
    print(f"| port urban_s{args.seed} | {row[0]:.3f} | {row[1]:.4f} | "
          f"{row[2]:.3f} | {row[3]:.3f} | {row[4]} | {row[5]} |", flush=True)
    if args.seed == 7 and args.frames == 420:
        ref = REFERENCE_S7
        print(f"| reference urban_s7 | {ref[0]:.3f} | {ref[1]:.4f} | "
              f"{ref[2]:.3f} | {ref[3]:.3f} | {ref[4]} | {ref[5]} |",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
