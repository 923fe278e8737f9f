"""Frames per second of the main path for one checkout of the repository, so
that two checkouts can be compared on one card: run each in its own
process, in turns (old, new, new, old).

The frames are those of this checkout's ``chip_smoke.py`` main phase
(loaded by path): the 32 full-width scans of its street world from its
seed, the same numbers for every checkout.  ``OdometryPipeline`` at the
default ``MullsConfig`` runs them three times in one process, each run
timed on the host clock with a sync at each end; the first run includes
the warm-up.  Each run's frames/s and end position are printed.

Usage:  python3 mulls_tpu_torch/tools/main_rate.py [--root DIR]

``--root`` names the checkout whose ``mulls_tpu_torch`` runs (default:
the one that holds this script).  It needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[2]
RUNS = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose mulls_tpu_torch runs")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    import mulls_tpu_torch
    from mulls_tpu_torch.config import MullsConfig
    from mulls_tpu_torch.ops import kernels
    from mulls_tpu_torch.pipeline.odometry import OdometryPipeline
    from mulls_tpu_torch.tools.roofline import card_line
    if not torch.cuda.is_available():
        raise RuntimeError("main_rate times the card: no card")
    dev = torch.device("cuda", 0)
    print(card_line(dev), flush=True)
    root = Path(mulls_tpu_torch.__file__).parent
    kernels.library()

    cfg = MullsConfig()
    rng = np.random.default_rng(cs.SEED)
    world = cs.make_world(rng)
    frames = [cs.render_scan(world, T, cfg.shapes.n_raw, rng)
              for T in cs.trajectory(cs.FRAMES)]
    for k in range(RUNS):
        pipe = OdometryPipeline(cfg, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipe.run(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"[main_rate] {root} run {k}: {len(frames)} frames in "
              f"{wall:.3f} s, {len(frames) / wall:.4f} frames/s; end "
              f"{np.array2string(res.poses[-1][:3, 3], precision=6)}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
