"""The readings that the comparison's limits are set from, for one cell, in
one process (its set-up is long):

    python3 benchmark/readings.py --workload <cell> \
        --program-seeds 11,12,... [--seconds 1] --control-seeds 21,22,23

* the program's: a run of the cell (``run.py``'s body) for each seed, with
  a short window; each prints its result line with the numbers compared;
* the control's: ``mulls_ref``'s step computed in TF32 put in the
  program's place (``mulls_ref.precision.set_precision("tf32")``: the
  operands of its products, in nn, moments, pca_moments and
  ``core/batch.py``, rounded to TF32 as tensor cores would), on three
  sequences drawn from the seed over two segments from the empty start,
  judged as a run judges the program: every frame after the warm-up
  scan-to-scan by :func:`benchlib.check.stage_gaps`, and the first call of
  each kernel at each segment's start against the float32 plain versions.
  It needs no program.

The last line is one JSON object: each number's largest reading over the
program's seeds and smallest over the control's.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

from benchlib import check, traffic  # noqa: E402
from benchlib.catalog import Catalog, apply_overrides  # noqa: E402
from benchlib.main import main  # noqa: E402


def control_numbers(cat: Catalog, cell: str, seed: int, device) -> tuple:
    """(the control's numbers, its per-registration records) on one seed
    (see the module note)."""
    import torch
    from mulls_ref.config import MullsConfig
    from mulls_ref import precision as prec
    from mulls_ref.core.cloud import pack_raw_host, unpack_raw
    from mulls_ref.core.draws import GeneratorDraws
    from mulls_ref.ops import kernels
    from mulls_ref.pipeline import odometry
    from benchlib.probe import KernelProbe, StageProbe
    w = cat.workload(cell)
    config = cat.config(w["config"])
    limits = cat.limits(w["config"])
    seqs, seg = list(config["sequences"]), int(config["segment"])
    n = 2 * seg
    cfg_run = apply_overrides(MullsConfig(), config.get("mulls_config", {}))
    cfg_run = apply_overrides(cfg_run, {"map": {
        "inframe_recovery_on": False, "dynamic_sanity_veto_on": False}})
    steady = apply_overrides(cfg_run, {"map": {"warmup_s2s_on": False}})
    cfg_ref = check.reference_config(config)
    mix = dict(cat.traffic(w["traffic"]), frames=n)
    drives = traffic.make_drives(mix, seqs, cfg_run.shapes.n_raw, seed,
                                 device)
    follow = sorted({int(x) for x in np.random.default_rng(
        [int(seed) % (1 << 63), 11]).choice(len(seqs), min(3, len(seqs)),
                                            replace=False)})
    records, parts = [], []
    kprobe = KernelProbe(kernels)
    try:
        for s in follow:
            freq = cfg_run.map.local_map_recalculation_frequency
            stages = StageProbe(odometry, odometry, [
                f for f in range(3, n)
                if not (0 < freq < 99999 and (f + 1) % freq == 0)])
            try:
                state = odometry.init_state(cfg_run, device, draws=(
                    GeneratorDraws(traffic.sequence_seed(seed, s, salt=1),
                                   device)))
                vecs = []
                for f in range(n):
                    if f % seg == 0:
                        kprobe.arm(f)
                    raw = unpack_raw(pack_raw_host(
                        drives[s][f], with_ts=False).to(device))
                    cfg = cfg_run if f < seg else steady
                    prec.set_precision("tf32")
                    try:
                        state, out = odometry.slam_step(state, raw, cfg,
                                                        frame=f)[:2]
                    finally:
                        prec.set_precision("fp32")
                    vecs.append(out.vec.detach().cpu().numpy())
            finally:
                stages.restore()
            for f in sorted(stages.kept):
                r = check.stage_gaps(stages.kept[f], None, f, drives[s][f],
                                     vecs[f], vecs[f - 1], cfg_ref, limits,
                                     device)
                records.append(dict(r, seq=s))
            parts += [check.kernel_gaps(c) for _, c in
                      sorted(kprobe.calls.items()) if c]
            kprobe.calls.clear()
            del stages, state
    finally:
        kprobe.restore()
    parts.append(check.stage_numbers(records, limits))
    del drives
    torch.cuda.empty_cache() if torch.cuda.is_available() else None
    return check.merge(parts), records


def run(argv, root=ROOT, here=None, device="cuda", require_card=True):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    import torch
    cat = Catalog(root, here) if here else Catalog(root)
    dev = torch.device(device)
    lower, upper = {}, {}
    for seed in [int(x) for x in args.program_seeds.split(",") if x]:
        import io
        from contextlib import redirect_stderr, redirect_stdout
        buf, err = io.StringIO(), io.StringIO()
        with redirect_stdout(buf), redirect_stderr(err):
            rc = main(["--workload", args.workload, "--seed", str(seed),
                       "--seconds", str(args.seconds), "--trace", "0"],
                      root, time.perf_counter(), require_card=require_card,
                      device=device, here=here)
        nums = {}
        for ln in err.getvalue().splitlines():
            if ln.startswith("[bench] numbers "):
                nums = json.loads(ln[len("[bench] numbers "):])
            elif ln.startswith("[bench] registrations "):
                print(f"[program] seed {seed} registrations {ln[22:]}",
                      flush=True)
            elif not ln.startswith("[check]"):
                print(ln, flush=True)
        line = buf.getvalue().strip().splitlines()[-1] if rc == 0 else "{}"
        print(f"[program] seed {seed} rc {rc}: {line}", flush=True)
        print(f"[program] seed {seed} numbers {json.dumps(nums)}", flush=True)
        for k, v in nums.items():
            lower[k] = max(lower.get(k, v), v)
    for seed in [int(x) for x in args.control_seeds.split(",") if x]:
        t = time.perf_counter()
        nums, log = control_numbers(cat, args.workload, seed, dev)
        print(f"[control] seed {seed} registrations {json.dumps(log)}",
              flush=True)
        print(f"[control] seed {seed} (tf32, "
              f"{time.perf_counter() - t:.1f} s): {json.dumps(nums)}",
              flush=True)
        for k, v in nums.items():
            upper[k] = min(upper.get(k, v), v)
    print(json.dumps({"workload": args.workload, "program_max": lower,
                      "control_min": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
