"""Card against CPU at small width, repeated: how far one checkout's card
run parts from its own CPU run, and whether the card run repeats itself.

The runs are ``chip_smoke.py``'s agree phase's two whole runs (this
checkout's ``chip_smoke.py``, loaded by path, gives the world, the scans,
the draws and the small configuration): the CPU once, then the card
``--repeats`` times, each printed with its largest per-frame motion
difference from the CPU run (m, deg), the per-frame translation
differences and the end position.  ``--deterministic`` turns on
``torch.use_deterministic_algorithms`` (warnings only), which tells apart
a fixed outcome from the noise of float atomics.

Usage:  python3 mulls_tpu_torch/tools/agree_runs.py [--root DIR]
            [--repeats N] [--deterministic]

``--root`` names the checkout whose ``mulls_tpu_torch`` runs (default:
the one that holds this script).  It needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose mulls_tpu_torch runs")
    ap.add_argument("--repeats", type=int, default=6)
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    import mulls_tpu_torch
    from mulls_tpu_torch.pipeline.odometry import OdometryPipeline
    if not torch.cuda.is_available():
        raise RuntimeError("agree_runs compares the card with the CPU: no "
                           "card")
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device("cuda", 0)
    print(f"[agree_runs] {Path(mulls_tpu_torch.__file__).parent}"
          + (" (deterministic algorithms)" if args.deterministic else ""),
          flush=True)

    # the agree phase's world, scans and draws
    cfg = cs.small_cfg()
    n_frames = 6
    rng = np.random.default_rng(cs.SEED + 2)
    world = cs.make_world(rng, n=60_000, half_x=35.0, half_y=35.0)
    frames = [cs.render_scan(world, T, cfg.shapes.n_raw, rng,
                             sensor_range=30.0)
              for T in cs.trajectory(n_frames, step=0.6)]

    def run(where):
        return OdometryPipeline(cfg, segment=n_frames, device=where,
                                draws=cs.HostDraws(cs.SEED, where)
                                ).run(frames)

    cpu = run("cpu")
    cpu_rel = np.linalg.inv(cpu.poses[:-1]) @ cpu.poses[1:]
    for k in range(args.repeats):
        card = run(dev)
        diffs = [cs.motion_diff(a, b) for a, b in zip(
            np.linalg.inv(card.poses[:-1]) @ card.poses[1:], cpu_rel)]
        print(f"[agree_runs] run {k}: max {max(d[0] for d in diffs):.4g} m "
              f"{max(d[1] for d in diffs):.4g} deg; per frame (m) "
              + " ".join(f"{d[0]:.3e}" for d in diffs)
              + f"; end {np.array2string(card.poses[-1][:3, 3])}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
