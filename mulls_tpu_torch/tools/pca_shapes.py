"""Device time of ``kernels.pca_moments`` at the port's call shapes, for one
checkout of the repository, so that two checkouts can be compared on one
card: run each in its own process, in turns (old, new, new, old).

The inputs are those of this checkout's ``chip_smoke.py`` (loaded by
path), from its street world and seed: the frame PCA's own call (one
feature stage on the first scan: 10240 queries in Morton order x 20480),
the same support with random queries, the map refresh's 1536 x 1536 and
1024 x 1024 at r = 1.8, and the probe phase's dense case (10240 x 20480)
at r = 0.7, 1.0 and 1.8.  Every checkout gets the same numbers.

Usage:  python3 mulls_tpu_torch/tools/pca_shapes.py [--root DIR] [--out FILE]

``--root`` names the checkout whose ``mulls_tpu_torch`` is timed (default:
the one that holds this script).  It needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose mulls_tpu_torch is timed")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    import mulls_tpu_torch
    from mulls_tpu_torch.config import MullsConfig
    from mulls_tpu_torch.ops import kernels
    from mulls_tpu_torch.tools.roofline import card_line, device_ms
    if not torch.cuda.is_available():
        raise RuntimeError("pca_shapes times the CUDA kernel: no card")
    dev = torch.device("cuda", 0)
    card = card_line(dev)
    print(card, flush=True)
    print(f"[pca_shapes] timing {Path(mulls_tpu_torch.__file__).parent}",
          flush=True)
    kernels.library()

    rng = np.random.default_rng(cs.SEED)
    world = cs.make_world(rng)
    pose = cs.trajectory(1)[0]
    scan = cs.render_scan(world, pose, MullsConfig().shapes.n_raw, rng)
    cases = cs.pca_cases(scan, world, pose, dev, cs.SEED)
    q, p, pm = cs.dense_case(scan, np.random.default_rng(cs.SEED + 3), dev)
    for r in (0.7, 1.0, 1.8):
        cases[f"10240x20480 dense r={r}"] = (q, p, pm, torch.full(
            (10240,), r ** 2, dtype=torch.float32, device=dev))
    rows = []
    for shape, (q, p, pm, r2) in cases.items():
        hits = float(kernels.pca_moments(q, p, pm, r2)[0].sum())
        ms = device_ms(lambda: kernels.pca_moments(q, p, pm, r2), 20)[0]
        rows.append({"shape": shape, "hits_per_query": hits / q.shape[0],
                     "device_ms": ms})
        print(f"[pca_shapes] {shape:28s} {hits / q.shape[0]:7.2f} hits a "
              f"query  {ms:.4f} ms device", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "root": str(root), "rows": rows}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
