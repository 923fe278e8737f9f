"""The JAX reference's side of an accuracy-bench comparison, and its
recovery-ladder record.

Builds the run of ``tools/synthetic_accuracy_bench.py`` from the same flags
through the bench's own world functions (loaded by path), runs ``mulls_tpu``'s
``OdometryPipeline`` on the CPU at ``MullsConfig()`` defaults and, with
``--slam``, its ``SlamPipeline`` with loop closure and the refinement.  It
writes the bench's row with the per-frame codes and poses and the edges to
``--out`` (JSON).  Given the port's ``accuracy_bench --json_out`` record
(``--port``), it prints both rows and the first frame whose code or
relative motion parts (2 cm / 0.2 deg, the parity tests' bound); with
``--ref`` it reads a written record instead of running the reference.

    JAX_PLATFORMS=cpu python -m experiments.bench_reference \\
        --world dynamic --seed 1009 --frames 420 --out ref.json
    python -m experiments.bench_reference --ref ref.json --port port.json

``--replay_port N`` runs the port instead, on the CPU over the run's
first N frames with the reference's key tree replayed as its draws
(~15-22 s a frame at full width), and compares it with ``--ref``;
``--from_state K --steps M`` steps both packages from the reference's
own state after K frames (one ``slam_scan``) and prints each frame's
codes and how far the two ``T_rel`` part: they separate the port's code
from its draws and from the state a run has reached.

``--ladder`` writes the recovery ladder's record instead
(``experiments/ladder_reference.json``): the warm state after 16
stationary scans of the urban world (seed 0) at the defaults, then one
step for each case of
``tests/test_torch_pipeline.py::test_recovery_paths_match_reference``
(a 40 deg wrong prior with model age 4, and a prior 1.2 m off with age
0), each step's code and ``T_rel``.  ``chip_smoke.py``'s ladder phase
holds the port on the card to it.

Kept outside both packages: it imports the JAX package.  At full width the
reference takes ~4 s a frame on a CPU and ~2.7 GB.
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

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LADDER_SCANS = 16  # the warm state's stationary scans (then one more)
LADDER_SEED = 0
# (case, prior yaw deg, prior shift m, model age): the ladder's two cases
LADDER_CASES = (("yaw_sweep", 40.0, 0.0, 4), ("mover_veto", 0.0, 1.2, 0))


def load_bench():
    """``tools/synthetic_accuracy_bench.py`` as a module, by path."""
    spec = importlib.util.spec_from_file_location(
        "synthetic_accuracy_bench",
        os.path.join(_REPO, "tools", "synthetic_accuracy_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_run(bench, world: str, seed: int, frames: int, n_raw: int,
              fog: bool = False, beams: int = 0, hardness: int = 1,
              traj_step: float = 0.0, handheld: bool = False,
              v_err: float = 0.0) -> tuple:
    """(scans, ground truth relative to frame 0) as the bench's ``main``
    assembles them (``tools/synthetic_accuracy_bench.py:575-626``)."""
    rng = np.random.default_rng(seed)
    sim_kw = {}
    if world == "highway":
        pts = bench.build_world_highway(rng)
        world_g = bench.highway_trajectory(frames)
    elif world == "highway_loop":
        pts = bench.build_world_highway_loop(rng)
        world_g = bench.highway_loop_trajectory(frames)
    elif world == "urban_hard":
        pts = np.concatenate([bench.build_world(rng),
                              bench.build_world_hard_extras(rng)])
        world_g = bench.loop_trajectory(frames)
        sim_kw = {
            1: dict(noise_base=0.02, noise_range_coef=0.0006,
                    occl_sectors=2),
            2: dict(noise_base=0.025, noise_range_coef=0.0007,
                    occl_sectors=3),
            3: dict(noise_base=0.03, noise_range_coef=0.0008,
                    occl_sectors=3),
        }[max(1, min(hardness, 3))]
    else:
        pts = bench.build_world(rng)
        world_g = (bench.loop_trajectory(frames, step=traj_step)
                   if traj_step > 0 else bench.loop_trajectory(frames))
    if handheld:
        world_g = bench.handheld_sway(world_g, rng)
    gt = np.einsum("ij,njk->nik", np.linalg.inv(world_g[0]), world_g)
    fog_lo, fog_hi = ((int(0.25 * frames), int(0.40 * frames)) if fog
                      else (0, 0))
    dyn = bench.dynamic_traffic(rng, frames) if world == "dynamic" else None
    scans = [bench.simulate(np.concatenate([pts, dyn[k]]) if dyn is not None
                            else pts,
                            world_g[k], n_raw, rng,
                            sensor_range=(20.0 if fog_lo <= k < fog_hi
                                          else 65.0),
                            beams=beams, vertical_ang_err_deg=v_err, **sim_kw)
             for k in range(frames)]
    return scans, gt


def _metrics(gt: np.ndarray, poses: np.ndarray) -> dict:
    from mulls_tpu.eval import kitti_metrics as km
    summ = km.summarize(km.compute_error(gt, poses))
    return {"t_drift_pct": summ["ate_percent"],
            "r_drift_deg_per_m": summ["are_deg_per_m"],
            "ate_rmse_m": km.ate_rmse(gt, poses),
            "end_gap_m": float(np.linalg.norm(poses[-1, :3, 3]
                                              - gt[-1, :3, 3])),
            "segments": summ.get("num_segments", 0)}


def run_reference(args) -> dict:
    from mulls_tpu.config import MullsConfig
    from mulls_tpu.pipeline.odometry import OdometryPipeline
    from mulls_tpu.pipeline.slam import SlamPipeline

    cfg = MullsConfig()
    t0 = time.perf_counter()
    scans, gt = bench_run(load_bench(), args.world, args.seed, args.frames,
                          cfg.shapes.n_raw, fog=args.fog, beams=args.beams,
                          hardness=args.hardness, traj_step=args.traj_step,
                          handheld=args.handheld)
    out = {"world": args.world, "seed": args.seed, "frames": args.frames,
           "fog": args.fog, "beams": args.beams, "config": "MullsConfig()",
           "platform": "cpu", "simulate_s": time.perf_counter() - t0}
    print(f"[reference] {args.world} seed {args.seed}: {args.frames} scans "
          f"in {out['simulate_s']:.1f} s", flush=True)
    t0 = time.perf_counter()
    odo = OdometryPipeline(cfg).run(scans)
    out["odometry_s"] = time.perf_counter() - t0
    codes = [int(c) for c in odo.codes]
    out["odometry_failed_frames"] = sum(c not in (1, -4) for c in codes)
    out["odometry_vetoed_frames"] = codes.count(-4)
    out["odometry"] = _metrics(gt, np.asarray(odo.poses))
    out["odometry_codes"] = codes
    out["odometry_poses"] = np.asarray(odo.poses).tolist()
    out["gt"] = gt.tolist()
    print(f"[reference] odometry in {out['odometry_s']:.1f} s: "
          f"{out['odometry']}", flush=True)
    if args.slam:
        cfg_slam = cfg.replace(submap=dataclasses.replace(
            cfg.submap, loop_closure_detection_on=True))
        t0 = time.perf_counter()
        pipe = SlamPipeline(cfg_slam)
        res = pipe.run(scans)
        pipe.refine(res)
        out["slam_s"] = time.perf_counter() - t0
        be = res.backend
        out["submaps"] = len(be.submaps)
        out["loop_edges"] = sum(1 for e in be.edges if e.kind == 2)
        out["slam"] = _metrics(gt, np.asarray(res.poses))
        out["slam_codes"] = [int(c) for c in res.codes]
        out["slam_poses"] = np.asarray(res.poses).tolist()
        fe = {s.sid: s.frame_end for s in be.submaps}
        out["edges"] = [
            {"i": e.i, "j": e.j, "kind": e.kind,
             "T": np.asarray(e.T).tolist(),
             "confidence": float(e.confidence),
             "t_err_m": (None if e.kind == 1 else float(np.linalg.norm(
                 np.asarray(e.T)[:3, 3]
                 - (np.linalg.inv(gt[fe[e.i]]) @ gt[fe[e.j]])[:3, 3])))}
            for e in be.edges]
        print(f"[reference] SLAM in {out['slam_s']:.1f} s: {out['slam']}, "
              f"{out['loop_edges']} loop edges", flush=True)
    return out


def _pose(yaw_deg: float, shift_m: float) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(np.radians(yaw_deg)), np.sin(np.radians(yaw_deg))
    T[:2, :2] = [[c, -s], [s, c]]
    T[0, 3] = shift_m
    return T


def ladder_scans(bench, n_raw: int) -> list:
    """The ladder's scans: the urban world from ``LADDER_SEED``, all taken
    from the loop's start pose (``worlds.stationary_scans`` in the port)."""
    rng = np.random.default_rng(LADDER_SEED)
    pts = bench.build_world(rng)
    pose = bench.loop_trajectory(1)[0]
    return [bench.simulate(pts, pose, n_raw, rng)
            for _ in range(LADDER_SCANS + 1)]


def run_ladder() -> dict:
    # mulls_tpu first: its import selects JAX's platform
    from mulls_tpu.config import MullsConfig

    import jax
    import jax.numpy as jnp

    from mulls_tpu.core.cloud import pack_raw_host
    from mulls_tpu.pipeline.odometry import (StepOut, _stack_packed,
                                             init_state, slam_scan)

    cfg = MullsConfig()
    scans = ladder_scans(load_bench(), cfg.shapes.n_raw)
    pack = lambda fs: jax.device_put(_stack_packed(
        [pack_raw_host(f, with_ts=False) for f in fs]))
    t0 = time.perf_counter()
    warm, vecs = slam_scan(init_state(cfg), pack(scans[:LADDER_SCANS]), cfg)
    warm_codes = [int(c) for c in StepOut.unpack_vecs(np.asarray(vecs))[2]]
    print(f"[ladder] warm state in {time.perf_counter() - t0:.1f} s, codes "
          f"{warm_codes}", flush=True)
    out = {"command": "JAX_PLATFORMS=cpu python -m experiments."
                      "bench_reference --ladder",
           "jax": jax.__version__, "seed": LADDER_SEED,
           "config": "MullsConfig()", "warm_scans": LADDER_SCANS,
           "warm_codes": warm_codes, "cases": {}}
    for case, yaw, shift, age in LADDER_CASES:
        state = jax.tree.map(jnp.copy, warm).replace(
            T_prev=jnp.asarray(_pose(yaw, shift)), model_age=jnp.int32(age),
            add_length=jnp.float32(0.0))
        t0 = time.perf_counter()
        _, vecs = slam_scan(state, pack(scans[LADDER_SCANS:]), cfg)
        T, _, code, conf, _ = StepOut.unpack_vecs(np.asarray(vecs))
        out["cases"][case] = {"prior_yaw_deg": yaw, "prior_shift_m": shift,
                              "model_age": age, "code": int(code[0]),
                              "confidence": float(conf[0]),
                              "T_rel": T[0].tolist()}
        print(f"[ladder] {case}: code {int(code[0])}, T_rel translation "
              f"{np.round(T[0][:3, 3], 4).tolist()} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def _parity():
    """tests/torch_parity.py (the JAX key replayed as the port's draws,
    the reference's state as numpy): test-side, where JAX is allowed."""
    sys.path.insert(0, os.path.join(_REPO, "tests"))
    import torch_parity
    return torch_parity


def replay_port(args) -> dict:
    """The port on the CPU at ``MullsConfig()`` defaults over the run's
    first ``--replay_port`` frames, its draws the reference's key tree
    replayed: the odometry record, for ``--ref`` to compare."""
    import jax
    import torch

    from mulls_tpu_torch.config import MullsConfig
    from mulls_tpu_torch.pipeline.odometry import OdometryPipeline
    cfg = MullsConfig()
    scans, _ = bench_run(load_bench(), args.world, args.seed, args.frames,
                         cfg.shapes.n_raw, fog=args.fog, beams=args.beams,
                         hardness=args.hardness, traj_step=args.traj_step,
                         handheld=args.handheld)
    torch.set_num_threads(args.threads)
    t0 = time.perf_counter()
    res = OdometryPipeline(cfg, device="cpu", draws=_parity().JaxKeyDraws(
        jax.random.key(cfg.seed))).run(scans[:args.replay_port],
                                       progress=True)
    print(f"[replay] {args.replay_port} frames in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"odometry_codes": [int(c) for c in res.codes],
            "odometry_poses": np.asarray(res.poses).tolist()}


def from_state(args) -> list:
    """The reference's state after ``--from_state`` frames (one
    ``slam_scan``), then ``--steps`` more frames through the reference's
    ``slam_scan`` and the port's ``slam_step`` (CPU, the reference's key
    replayed): each frame's codes and the two ``T_rel``'s difference."""
    import jax
    import jax.numpy as jnp
    import torch

    from mulls_tpu.config import MullsConfig as JConfig
    from mulls_tpu.core.cloud import pack_raw_host
    from mulls_tpu.pipeline.odometry import (StepOut, _stack_packed,
                                             init_state, slam_scan)
    from mulls_tpu_torch.config import MullsConfig
    from mulls_tpu_torch.core.cloud import pack_raw_host as t_pack
    from mulls_tpu_torch.pipeline.odometry import slam_step, state_from_numpy
    tp = _parity()
    k, m = args.from_state, args.steps
    cfg, tcfg = JConfig(), MullsConfig()
    scans, _ = bench_run(load_bench(), args.world, args.seed, k + m,
                         cfg.shapes.n_raw, fog=args.fog, beams=args.beams,
                         hardness=args.hardness, traj_step=args.traj_step,
                         handheld=args.handheld)
    pack = lambda fs: jax.device_put(_stack_packed(
        [pack_raw_host(f, with_ts=False) for f in fs]))
    state, vecs = slam_scan(init_state(cfg), pack(scans[:k]), cfg)
    first = [int(c) for c in StepOut.unpack_vecs(np.asarray(vecs))[2]]
    print(f"[from_state] the reference's first {k} frames in one scan: codes "
          f"other than 1 {[(i, c) for i, c in enumerate(first) if c != 1]}",
          flush=True)
    tree = tp.state_to_numpy(state)
    key = jax.random.wrap_key_data(np.array(jax.random.key_data(state.key)))
    _, vecs = slam_scan(jax.tree.map(jnp.copy, state), pack(scans[k:]), cfg)
    T_ref, _, c_ref, conf_ref, _ = StepOut.unpack_vecs(np.asarray(vecs))
    torch.set_num_threads(args.threads)
    ts = state_from_numpy(tree, tcfg, device="cpu",
                          draws=tp.JaxKeyDraws(key))
    rows = []
    for j, i in enumerate(range(k, k + m)):
        ts, o = slam_step(ts, t_pack(scans[i], with_ts=False), tcfg,
                          frame=i)
        T = o.T_rel.numpy().astype(np.float64)
        rows.append({"frame": i, "port_code": int(o.code),
                     "reference_code": int(c_ref[j]),
                     "dt_m": float(np.linalg.norm(T[:3, 3] - T_ref[j][:3, 3])),
                     "port_confidence": float(o.confidence),
                     "reference_confidence": float(conf_ref[j])})
        print("[from_state] frame {frame}: codes port {port_code} reference "
              "{reference_code}, T_rel {dt_m:.4f} m apart, confidence "
              "{port_confidence:.3f} / {reference_confidence:.3f}"
              .format(**rows[-1]), flush=True)
    return rows


def compare(ref: dict, port: dict) -> dict:
    """Both rows, and where the port's odometry parts from the
    reference's (``experiments/urban_s7_reference.py::first_parting``)."""
    from experiments.urban_s7_reference import first_parting

    keys = ("odometry", "odometry_failed_frames", "odometry_vetoed_frames",
            "slam", "submaps", "loop_edges")
    n = min(len(ref["odometry_poses"]), len(port["odometry_poses"]))
    gt = np.asarray(ref["gt"])[:n]
    rel = lambda p: np.linalg.inv(p[:-1]) @ p[1:]

    def against_truth(rec):
        """The odometry's median per-frame motion error and its end error
        (x, y, z in frame 0's axes) against the truth, in m."""
        poses = np.asarray(rec["odometry_poses"], np.float64)[:n]
        err = np.linalg.norm(rel(poses)[:, :3, 3] - rel(gt)[:, :3, 3], axis=1)
        return {"median_rel_err_m": float(np.median(err)),
                "end_err_xyz_m": (poses[-1, :3, 3] - gt[-1, :3, 3]).tolist()}

    return {"reference": {**{k: ref.get(k) for k in keys},
                          **against_truth(ref)},
            "port": {**{k: port.get(k) for k in keys}, **against_truth(port)},
            "frames": n,
            "parting": first_parting(
                {"poses": np.asarray(ref["odometry_poses"])[:n],
                 "codes": ref["odometry_codes"][:n]},
                np.asarray(port["odometry_poses"], np.float64)[:n],
                port["odometry_codes"][:n])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--world", default="urban",
                    choices=["urban", "highway", "dynamic", "highway_loop",
                             "urban_hard"])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--frames", type=int, default=420)
    ap.add_argument("--fog", action="store_true")
    ap.add_argument("--beams", type=int, default=0)
    ap.add_argument("--hardness", type=int, default=1)
    ap.add_argument("--traj_step", type=float, default=0.0)
    ap.add_argument("--handheld", action="store_true")
    ap.add_argument("--slam", action="store_true",
                    help="also SlamPipeline with loop closure and refine")
    ap.add_argument("--out", default=None, help="the record (JSON)")
    ap.add_argument("--ref", default=None, help="read a record instead of "
                    "running the reference")
    ap.add_argument("--port", default=None, help="the port's accuracy_bench "
                    "--json_out record")
    ap.add_argument("--ladder", action="store_true",
                    help="write the recovery ladder's record instead")
    ap.add_argument("--replay_port", type=int, default=0, metavar="N",
                    help="run the port on the CPU over the first N frames "
                    "with the reference's draws replayed instead (its "
                    "record to --out; compared with --ref when given)")
    ap.add_argument("--from_state", type=int, default=0, metavar="K",
                    help="step both packages from the reference's state "
                    "after K frames instead, for --steps frames")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--threads", type=int, default=4,
                    help="torch threads of the port's CPU runs")
    args = ap.parse_args(argv)

    if args.ladder:
        rec = run_ladder()
        path = args.out or os.path.join(_REPO, "experiments",
                                        "ladder_reference.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(json.dumps(rec["cases"]), flush=True)
        return 0
    if args.from_state:
        rows = from_state(args)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rows, f, indent=1)
        return 0
    if args.replay_port:
        port = replay_port(args)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(port, f)
        if args.ref:
            with open(args.ref) as f:
                print(json.dumps(compare(json.load(f), port), indent=1),
                      flush=True)
        return 0
    if args.ref:
        with open(args.ref) as f:
            ref = json.load(f)
    else:
        ref = run_reference(args)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(ref, f)
    if args.port:
        with open(args.port) as f:
            print(json.dumps(compare(ref, json.load(f)), indent=1),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, _REPO)
    sys.exit(main())
