#!/usr/bin/env python3
"""Smoke test of mulls_tpu_torch on one NVIDIA card.

Phases (each prints its own line; any failure exits non-zero):

1. device   — a CUDA card must be present; prints
              ``nvidia-smi --query-gpu=name,power.limit``.
2. build    — compiles the CUDA kernels from ``mulls_tpu_torch/csrc``
              (one nvcc per source, in parallel) and prints the build time.
3. kernels  — each kernel against its plain PyTorch version on the card, on
              inputs shaped like the main path's calls (taken from the
              synthetic world below), with the tolerances stated beside
              each check, and two launches against each other (same
              bits); nn also as one grouped launch for the five ICP
              classes against five single launches; pca_moments on the
              frame PCA's own call (one feature stage: 10240 queries in
              Morton order x 20480), on random queries of the same
              support, and at the map refresh's 1536 x 1536 and
              1024 x 1024 (r = 1.8, a pillar map).  Times the kernel on
              the device (torch.profiler) and per call with CUDA events,
              the plain version and, where one exists, a library
              yardstick (timed here only).  Then the batched step's three
              kernels at S = 8 sequences of the full-width shapes (the
              five ICP classes, 40 problems, one nn launch; moments' two
              passes; the frame PCA): one launch for all 8 against 8
              single launches bit for bit and the plain version on the
              last sequence, same bits twice, device and CUDA-event ms
              beside the 8 single launches', the plain version's and one
              batched library call's over the same [8, ...] inputs
              (cdist + min, or cdist + compare + fp32 matmul; timed
              only), bound 8 x the single one.
4. probe    — the roofline probe's two kernels against their plain
              versions on the card: ``count_within`` (a cell-grid count:
              the support sorted into cells of side sqrt(max r2), one
              thread a query walking the 27 cells around it) and
              ``adj_stack`` (wgmma fed by TMA, merged across a cluster),
              on the probe's own inputs and on a dense case from the scan
              (10240 x 20480 at r = 0.7) with ones, integer and random bf16
              stacks: counts and integer stacks exact, random stacks
              within the stated bound, each twice for the same bits.  The
              library yardsticks at the probe shape (timed only): cdist +
              compare + sum, and cdist + compare + a bf16 matmul.  Then
              the dense case timed at r = 0.7, 1.0, 1.8 and 3.0 for
              pca_moments, count_within (the kernel alone), moments C=10
              (the hit-sparse form) and adj_stack C=16 and 128 (the dense
              form); then the probe itself
              (``mulls_tpu_torch.tools.roofline.run_probe``) with its
              launch counts, which must be > 0; its rows give each
              kernel's device ms alone and its call's whole device ms,
              ``count_within`` bounded by the bytes and 10 operations a
              hit, its walk's candidate pairs beside it.
5. main     — ``OdometryPipeline`` at full width (``MullsConfig()``
              defaults: n_raw 131072, n_unground 20480) over ~32 frames of
              a synthetic world (>= 100k valid points per scan, made with
              numpy from a fixed seed).  Checks that each of the four
              main-path counters (nn, nn_grouped, moments, pca_moments)
              counted launches,
              that nn launched at most 30 times a frame, that >= 90 % of
              the frames after the first registered with code 1, and the
              end translation error against ground truth.  The same run
              again from the same seed must give the same poses bit for
              bit (the order-fixed sums of ops/segment.py); both end
              errors are printed.
6. agree    — the port on the card against the port's plain PyTorch paths
              on the CPU, same scans and same draws, at a small width:
              equal codes and per-frame motion within 2 cm / 0.2 deg.
              Then stage by stage: at each frame the card gets the CPU's
              own state, scan and draws, and the script prints the first
              call of each stage whose outputs differ, and the first that
              flips a mask, an index or a count.
7. profile  — where a frame's time goes at full width: stage times
              (feature / reg / map, a sync around each) and, from
              ``torch.profiler``, the device's busy share and the kernels
              that take the most device time.
8. slam     — ``SlamPipeline`` at full width with loop closure on (the
              default submap settings: 30 m submaps, min_submap_id_diff 8,
              the ceres PGO) over 208 frames, 1.2 laps, of the urban loop
              world of ``tools/synthetic_accuracy_bench.py`` (the port's
              copy, ``mulls_tpu_torch/tools/worlds.py``), then the
              end-of-run refinement.  Checks >= 90 %
              code 1, adjacent edges = submaps - 1, >= 1 loop edge and each
              within 0.5 m of the ground truth's relative pose, >= 1
              accepted PGO, end error <= 2 %, every kernel launched on the
              run and the back end's own nn launches > 0.  Prints frames/s
              beside the main phase's odometry-only rate and ms per
              boundary ladder, per loop candidate and per PGO.  Then
              The first 64 of the same frames also run through odometry
              alone first, for the rate without the back end (the first
              corner included), and the back end's m2m, loop
              candidate and PGO are timed again alone on the card after
              the run.  Then ``nn_grouped`` at the map-to-map shapes of one ``pair_m2m``
              iteration between two of the run's submaps: bit-equal to the
              plain version, same bits twice, timed against its bound and
              ``cdist`` + ``min``.  Then the run's first boundary that
              added a loop edge, run twice on the card from the back end's
              state kept just before it (``backend_to_numpy``, the
              boundary's draws): the edges (i, j, kind, T, confidence),
              the PGO's poses and every submap's pose equal bit for bit.
9. agree-slam — ``SlamPipeline`` on the card and on the CPU at the parity
              tests' width with tests/test_pipeline.py's loop world and
              config and the same draws: the same submap spans and edges,
              per-frame motion within 5 cm / 0.5 deg and poses within
              10 cm / 1 deg (the bounds of tests/test_torch_slam.py).
10. assembly — ``accumulate_map`` of the slam phase's 208 frames at its
              final poses (0.25 m voxels), then ``radius_outlier_filter``
              on the card: one ``count_within`` call, the whole map
              against itself (one cell index, one launch).  That call and
              one on the first 200,000 queries each give the same bits
              twice and, on those queries, the plain version's counts on
              the card exactly; the filter keeps what the plain counts
              keep; the pcd, BEV image and HTML viewer are written and
              not empty.  Prints the map size, the filter's ms and
              launches, and at both shapes the kernel's device ms
              (torch.profiler, where the trace keeps its events), the
              whole call's device ms and CUDA-event ms, the index build's
              ms and the bound (the bytes, or 10 operations a hit); on the
              chunk also the walk's candidate pairs, the brute-force
              bound, and the plain version's and the library yardstick's
              ms (cdist + compare + sum).
11. baseline — ``BaselinePipeline`` with ``ndt`` and ``gicp`` at the default
              ``BaselineConfig`` over the main phase's 32 frames: codes 1
              or -1, finite fitness, frames/s and end error (recorded, not
              bounded); ``pca_moments`` at the GICP covariances' own first
              call (16384 x 16384, r = 1.0) against its plain version, as
              in the kernel phase; both methods on the card against the
              CPU at a small width with the same draws, 2 cm / 0.2 deg.
12. cli     — ``mulls_tpu_torch.apps.slam.main`` over 8 street frames
              written as KITTI .bin: SLAM with ``--output_map_pcd``,
              ``--output_map_bev``, ``--output_map_html`` and
              ``--profile_dir`` (the trace must hold CUDA kernel events),
              then ``--baseline_reg_method gicp``; exit 0 and the files.

13. reg     — ``mulls_tpu_torch.apps.reg.main`` at full width for every
              coarse mode (the default GNC with its BEV fallback, ransac,
              fpfh, bev, yaw4dof, none): the main phase's frame 0 as the
              target (.bin), its frame 6 turned by 37 deg about its origin
              as the source (.pcd).  Exit 0 and a finite transform in
              every mode; the default within 0.3 m / 1 deg of the truth,
              the others' errors recorded (the street looks alike after a
              half turn, and the heading sweep's score prefers that
              mode).  Then yaw4dof on two frames 6.5 m apart of the slam
              phase's urban world (built so that no two facades look
              alike), the source turned the same way: within 0.3 m /
              1 deg.  Both sweeps run with ``--corr_dis_thre=6``: the
              sweep starts each heading from zero translation, 6 m from
              the truth.  nn_grouped, moments and pca_moments launched
              in every mode and nn in fpfh; ms per mode.  Then ``nn`` at
              the SAC-IA scoring call's own
              inputs (512 x 256 queries) and ``nn_grouped`` at one
              iteration of a heading seed: bit-equal to the plain
              versions, the same bits twice, timed with the bound and
              ``cdist`` + ``min``.
14. merge   — two ``SlamPipeline`` sessions at full width (the default
              config with loop closure on, 48 frames, 60 m, two submaps
              each) on the main phase's street: A east from x = -30, B
              back west 3 m to the side, each in its own frame 0, each
              writing its checkpoint; then ``apps.map_merge.main``: exit
              0, the session transform within 0.5 m / 1 deg of the truth,
              >= 1 inter-session edge, the PGO accepted, B's merged frames
              within 0.5 m of its truth, the pose files, pcd and HTML
              written; ms of the vote pass, the fine edges and the PGO.
15. multiseq — ``MultiSeqPipeline`` at full width on a one-device mesh:
              four drives of the street (16 frames, one cut to 12),
              stepped as one [4, ...] batch.  Each sequence must
              equal an ``OdometryPipeline`` run of it alone (the
              multi-sequence config, seed ``cfg.seed + s``) bit for bit,
              register >= 90 % of its frames after the first with code 1,
              and launch ``nn_grouped``, ``moments`` and ``pca_moments``.
              Then the aggregate frames/s at S = 1, 4 and 8 in one batch
              (the drives repeated, read back as KITTI .bin through the
              native reader), timed after a 4-frame warm-up segment with
              a sync at the end of each segment, with the kernel launches
              per sequence-frame (at S = 8 at most 1.25/8 of S = 1's); at
              S = 1 and 8 the device's busy share over one more steady
              segment (torch.profiler: the union of the kernels'
              intervals over the unprofiled segment time), its device
              operations per sequence-frame (at S = 8 below half of
              S = 1's) and the host syncs per batched frame (the
              runtime's synchronize calls; at S = 8 at most 8 x S = 1's),
              with the device-to-host copies beside them; then S = 8
              over 4 processes sharing the card (a gloo group) on the
              same reader, each batching its block of 2.
16. fleet   — the native IO library built from the port's source (the
              phase fails if it does not build);
              ``apps.slam_multiseq.main`` over two folders of 8 street
              frames as KITTI .bin: exit 0, the pose files and
              ``summary.json``; ``format_transform bin2pcd`` on one frame,
              read back exactly; the native and numpy readers equal on the
              .bin and the .pcd; a 2-rank process group on the one card
              (gloo: NCCL refuses two ranks on one device) running
              ``optimize_pose_graph_sharded`` on tests/test_multiseq.py's
              9-node ring: equal on both ranks, within 1e-3 m of the
              one-process ``optimize_pose_graph``; ``distributed_slam_step``
              over 4 full-width pairs of the main phase's frames on a one-
              and a four-entry mesh of the card: transforms bit-equal to
              four single ``mm_lls_icp`` calls, node updates within 1e-4.
17. ladder  — the recovery ladder at full width against the reference's
              record (``experiments/ladder_reference.json``, written by
              ``experiments/bench_reference.py --ladder``): the warm state
              after 16 stationary scans of the urban world (seed 0,
              ``MullsConfig()``), stepped on the card with the port's
              production draws, then one step for each of the record's
              cases: a 40 deg wrong prior with model age 4 (the in-frame
              retry, then the yaw sweep) and a prior 1.2 m off with age 0
              (the mover veto's hypothesis test).  Equal codes and T_rel
              within 2 cm / 0.2 deg of the record; ms per case, the ICP
              runs of the step and the sweep's seeds that ran.

The order of the run: 1-5, 11, 6, 7, 12, 13, 8, 9, 10, 14, 15, 16, 17: the phases
that read torch.profiler (3, 4, 7, 11, 13) come first.  Its traces have
lost device events, in the kernel and probe phases of some runs and
after the threaded SLAM runs of others, for a reason not known.  A timing
takes up to three traces; if all lose events, it takes the mean of the
launches the last one kept, and the kernels line lists each such time on
its kernel's row under ``device_ms_from_partial_traces``.

The line before the last is one JSON object describing every kernel; the
last line is ``{"ok": true, "device": {...}}``.

Usage:  python3 chip_smoke.py [--out FILE.json]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import sys
import tempfile
import time

import numpy as np

FRAMES = 32  # full-width frames of the main path
# the kernels the odometry and SLAM paths launch
MAIN_KERNELS = ("nn", "nn_grouped", "moments", "pca_moments")
SEED = 0  # of the synthetic worlds, the scans and the draws


def fail(msg: str, code: int = 1) -> int:
    print(f"[FAIL] {msg}", flush=True)
    return code


def n_ops(ops) -> str:
    """Device operations per call from ``roofline.device_ms``: None when
    its traces lost events of several kernels (not measured)."""
    return "not measured" if ops is None else f"{ops:.0f}"


# --------------------------------------------------------------------------
# synthetic world (numpy, seeded) — denser kin of tests/test_pipeline.py's
# _loop_world: ground + building facades + a street corridor + posts
# --------------------------------------------------------------------------

def make_world(rng: np.random.Generator, n: int = 900_000,
               half_x: float = 110.0, half_y: float = 70.0) -> np.ndarray:
    n_g = n // 2
    g = np.stack([rng.uniform(-half_x, half_x, n_g),
                  rng.uniform(-half_y, half_y, n_g),
                  0.03 * rng.normal(size=n_g) - 1.7], -1)
    # facades: both sides of a street along x, and cross-street blocks
    n_w = n // 4
    side = rng.integers(0, 4, n_w)
    u_x = rng.uniform(-half_x, half_x, n_w)
    u_y = rng.uniform(-half_y, half_y, n_w)
    street = 11.0 + 0.05 * rng.normal(size=n_w)
    block = np.round(u_x / 35.0) * 35.0 + 0.05 * rng.normal(size=n_w)
    wx = np.where(side < 2, u_x, block)
    wy = np.where(side == 0, street, np.where(side == 1, -street, u_y))
    # cross-street facades stay off the street itself
    wy = np.where((side >= 2) & (np.abs(wy) < 14.0),
                  np.sign(wy + 1e-6) * (14.0 + np.abs(wy)), wy)
    w = np.stack([wx, wy, rng.uniform(-1.5, 6.0, n_w)], -1)
    # posts (poles, trunks) at random spots
    n_p = n - n_g - n_w
    per = 60
    cx = rng.uniform(-half_x, half_x, n_p // per + 1)
    cy = rng.uniform(-half_y, half_y, n_p // per + 1)
    reps = np.repeat(np.arange(len(cx)), per)[:n_p]
    p = np.stack([cx[reps] + 0.02 * rng.normal(size=n_p),
                  cy[reps] + 0.02 * rng.normal(size=n_p),
                  rng.uniform(-1.5, 3.0, n_p)], -1)
    return np.concatenate([g, w, p]).astype(np.float32)


def trajectory(n_frames: int, step: float = 1.0) -> np.ndarray:
    """``step`` m/frame along the street with a gentle yaw drift
    (0.4 deg/frame)."""
    poses = []
    x, y, yaw = -20.0, 0.0, 0.0
    for _ in range(n_frames):
        T = np.eye(4)
        c, s = math.cos(yaw), math.sin(yaw)
        T[:2, :2] = [[c, -s], [s, c]]
        T[:3, 3] = [x, y, 0.0]
        poses.append(T)
        x += step * math.cos(yaw)
        y += step * math.sin(yaw)
        yaw += math.radians(0.4)
    return np.stack(poses)


def render_scan(world: np.ndarray, pose: np.ndarray, n_raw: int,
                rng: np.random.Generator, sensor_range: float = 60.0) -> dict:
    inv = np.linalg.inv(pose)
    local = world @ inv[:3, :3].T.astype(np.float32) \
        + inv[:3, 3].astype(np.float32)
    r = np.linalg.norm(local[:, :2], axis=1)
    sel = np.where((r < sensor_range) & (r > 1.5))[0]
    if len(sel) > n_raw:
        sel = rng.choice(sel, n_raw, replace=False)
    pts = local[sel] + 0.008 * rng.normal(size=(len(sel), 3))
    xyz = np.zeros((n_raw, 3), np.float32)
    xyz[:len(sel)] = pts
    mask = np.zeros(n_raw, bool)
    mask[:len(sel)] = True
    inten = np.zeros(n_raw, np.float32)
    wsel = world[sel]
    # world-stable pseudo-intensity so NCC descriptors are informative
    inten[:len(sel)] = (np.abs(np.sin(0.7 * wsel[:, 0])
                               + np.cos(1.3 * wsel[:, 1])) * 120.0)
    return {"xyz": xyz, "intensity": inten,
            "ts_ratio": np.linspace(0, 1, n_raw, dtype=np.float32),
            "mask": mask}


def post_map(world: np.ndarray, pose: np.ndarray, n: int,
             rng: np.random.Generator) -> tuple:
    """A pillar map as the local map holds it: ``n`` points of 16 a post on
    posts within 50 m of ``pose`` (the last quarter of ``make_world``'s
    rows, 60 a post), in the pose's frame, 3 % of them masked."""
    posts = world[len(world) // 2 + len(world) // 4:]
    inv = np.linalg.inv(pose)
    local = posts @ inv[:3, :3].T.astype(np.float32) \
        + inv[:3, 3].astype(np.float32)
    post_id = np.arange(len(posts)) // 60
    near = np.unique(post_id[np.linalg.norm(local[:, :2], axis=1) < 50.0])
    ids = rng.choice(near, -(-n // 16), replace=False)
    rows = np.concatenate([rng.choice(np.where(post_id == i)[0], 16,
                                      replace=False) for i in ids])[:n]
    return local[rows], rng.uniform(size=n) >= 0.03


class KernelTap:
    """Records the arguments of ``kernels.<name>`` (default
    ``pca_moments``) as ``module`` (default ``ops.pca``) calls it, while
    entered (every other name passes through)."""

    def __init__(self, module=None, name: str = "pca_moments"):
        self.target, self.name = module, name

    def __enter__(self):
        from mulls_tpu_torch.ops import kernels
        from mulls_tpu_torch.ops import pca
        self.module = self.target or pca
        self.kernels, self.calls = kernels, []
        self.module.kernels = self
        return self

    def __exit__(self, *exc):
        self.module.kernels = self.kernels

    def __getattr__(self, name):
        fn = getattr(self.kernels, name)
        if name != self.name:
            return fn

        def tapped(*args):
            self.calls.append(args)
            return fn(*args)
        return tapped


def pca_cases(scan: dict, world: np.ndarray, pose: np.ndarray, dev,
              seed: int) -> dict:
    """``pca_moments``' inputs ``(q, p, p_mask, r2)`` on ``dev``:
    the frame PCA's call as the main path makes it (one feature stage at
    full width on ``scan``: 10240 queries in Morton order against the 20480
    unground points, r = 0.7), the same support with a random subset of it
    as queries, and the map refresh's shapes (r = 1.8) on ``post_map``
    clouds at the pillar (1536) and beam (1024) capacities.  Every checkout
    that has the feature stage gets the same numbers from the same seed."""
    import torch

    from mulls_tpu_torch.config import MullsConfig
    from mulls_tpu_torch.core.cloud import pack_raw_host
    from mulls_tpu_torch.pipeline import odometry as odo
    cfg = MullsConfig()
    state = odo.init_state(cfg, dev)
    with KernelTap() as tap:
        odo._feature_stage(state, pack_raw_host(scan, with_ts=False).to(dev),
                           cfg, state.draws)
    q, p, pm, r2 = tap.calls[0]
    shape = f"{q.shape[0]}x{p.shape[0]}"
    rng = np.random.default_rng(seed + 4)
    sel = torch.as_tensor(rng.choice(p.shape[0], q.shape[0], replace=False),
                          device=dev)
    cases = {f"{shape} Morton": (q, p, pm, r2),
             f"{shape} random": (p[sel].contiguous(), p, pm, r2)}
    for n in (1536, 1024):
        xyz, m = post_map(world, pose, n, rng)
        pt = torch.as_tensor(xyz, device=dev)
        cases[f"{n}x{n} refresh"] = (pt, pt, torch.as_tensor(m, device=dev),
                                     torch.full((n,), 1.8 ** 2,
                                                dtype=torch.float32,
                                                device=dev))
    return cases


# --------------------------------------------------------------------------
# repeat check (the timing and bound helpers are the probe's, in
# mulls_tpu_torch/tools/roofline.py)
# --------------------------------------------------------------------------

def same_bits(fn) -> bool:
    """Two calls of ``fn`` give identical tensors."""
    import torch
    a, b = leaves(fn()), leaves(fn())
    return len(a) == len(b) and all(torch.equal(u, v)
                                    for (_, u), (_, v) in zip(a, b))


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def kernel_phase(scan: dict, world: np.ndarray, pose: np.ndarray, dev,
                 seed: int) -> list:
    import torch
    from mulls_tpu_torch.ops import kernels
    from mulls_tpu_torch.tools.roofline import bound_ms, device_ms, time_ms

    rng = np.random.default_rng(seed + 1)
    valid = np.where(scan["mask"])[0]
    pts = scan["xyz"][valid]
    inten = scan["intensity"][valid]

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    def cloud(n, valid_frac, jitter=0.0):
        sel = rng.choice(len(pts), n, replace=False)
        xyz = pts[sel] + jitter * rng.normal(size=(n, 3)).astype(np.float32)
        m = rng.uniform(size=n) < valid_frac
        return t(xyz), t(m, torch.bool), sel

    rows = []

    # --- nn at the ICP shapes: sources jittered by 5 cm against a different
    # subset of the scan.  The kernel forms d2 exactly as the plain version
    # does and merges exactly, so indices and distances are equal bit for
    # bit (tolerance 0), and two launches give the same bits.
    def nn_check(name, got, want):
        for k, ((ik, dk), (ip, dp)) in enumerate(zip(got, want)):
            if not (torch.equal(ik, ip) and torch.equal(dk, dp)):
                bad = int((ik != ip).sum()) + int((dk != dp).sum())
                raise AssertionError(f"{name} problem {k}: {bad} indices or "
                                     f"distances differ from the plain "
                                     f"version")

    icp_shapes = ((800, 6144), (400, 1536), (1200, 8192), (200, 1024),
                  (200, 512))  # ground, pillar, facade, beam, roof
    probs = {}
    for qn, pn in icp_shapes:
        q, qm, _ = cloud(qn, 0.9, jitter=0.05)
        p, pm, _ = cloud(pn, 0.9)
        probs[(qn, pn)] = (q, qm, p, pm)
    for qn, pn in ((1200, 8192), (800, 6144)):
        pr = probs[(qn, pn)]
        nn_check(f"nn {qn}x{pn}", [kernels.nn(*pr)], [kernels.nn_plain(*pr)])
        if not same_bits(lambda: kernels.nn(*pr)):
            raise AssertionError(f"nn {qn}x{pn}: two launches differ")
        ms, ops = device_ms(lambda: kernels.nn(*pr), 50)
        ev = time_ms(lambda: kernels.nn(*pr), 50)
        plain = time_ms(lambda: kernels.nn_plain(*pr), 10)
        lib = time_ms(lambda: cdist_min([pr]), 10)
        flops, nbytes = 9.0 * qn * pn, qn * 13 + pn * 13 + qn * 8
        b, by = bound_ms(flops, nbytes)
        print(f"[kernels] nn {qn}x{pn}: equal to the plain version bit for "
              f"bit, same bits twice; kernel {ms:.4f} ms on the device "
              f"({n_ops(ops)} launch per call; {ev:.4f} ms per call with "
              f"CUDA events), plain {plain:.4f} ms, cdist+min {lib:.4f} ms, "
              f"bound {b:.5f} ms ({by})", flush=True)
        rows.append({"name": "nn", "shape": f"{qn}x{pn}", "max_abs_err": 0.0,
                     "ms": ms, "event_ms": ev, "plain_ms": plain,
                     "library_ms": lib, "bound_ms": b, "bound_by": by})

    # --- nn_grouped: one launch for one ICP iteration's five classes,
    # against the same five problems as five kernels.nn launches
    group = [probs[s] for s in icp_shapes]
    nn_check("nn_grouped", kernels.nn_grouped(group),
             kernels.nn_grouped_plain(group))
    if not same_bits(lambda: kernels.nn_grouped(group)):
        raise AssertionError("nn_grouped: two launches differ")
    ms, ops = device_ms(lambda: kernels.nn_grouped(group), 200)
    ev = time_ms(lambda: kernels.nn_grouped(group), 200)
    five, five_ops = device_ms(lambda: [kernels.nn(*pr) for pr in group], 50)
    five_ev = time_ms(lambda: [kernels.nn(*pr) for pr in group], 50)
    plain = time_ms(lambda: kernels.nn_grouped_plain(group), 10)
    lib = time_ms(lambda: cdist_min(group), 10)
    pairs = sum(qn * pn for qn, pn in icp_shapes)
    nbytes = sum(qn * 13 + pn * 13 + qn * 8 for qn, pn in icp_shapes)
    b, by = bound_ms(9.0 * pairs, nbytes)
    shape = " + ".join(f"{qn}x{pn}" for qn, pn in icp_shapes)
    print(f"[kernels] nn_grouped {shape} ({pairs:.3g} pairs): equal to the "
          f"plain version bit for bit, same bits twice; one grouped launch "
          f"{ms:.4f} ms on the device ({n_ops(ops)} launch per call; "
          f"{ev:.4f} ms per call with CUDA events); five nn launches "
          f"{five:.4f} ms on the device ({n_ops(five_ops)} launches; "
          f"{five_ev:.4f} ms with CUDA events); plain {plain:.4f} ms, "
          f"cdist+min per class {lib:.4f} ms, bound {b:.5f} ms ({by})",
          flush=True)
    rows.append({"name": "nn_grouped", "shape": shape, "max_abs_err": 0.0,
                 "ms": ms, "event_ms": ev, "five_nn_ms": five,
                 "five_nn_event_ms": five_ev, "plain_ms": plain,
                 "library_ms": lib, "bound_ms": b, "bound_by": by})

    # --- moments: the NCC descriptor's two passes, 4096 x 20480
    p, pm, psel = cloud(20480, 0.95)
    q, qm, qsel = cloud(4096, 1.0)
    r2 = torch.full((4096,), 0.7 ** 2, dtype=torch.float32, device=dev)
    ones = torch.ones((20480, 1), dtype=torch.float32, device=dev)
    s1k, _ = kernels.moments(q, p, pm, r2, ones)
    s1p, _ = kernels.moments_plain(q, p, pm, r2, ones)
    count1 = torch.clamp(s1k[:, 0], min=1.0)
    r2s = (r2 * torch.clamp(25.0 / count1, max=1.0)).contiguous()
    cr2 = torch.clamp(r2s, max=0.64 * 0.49).contiguous()
    cls = rng.integers(0, 5, 20480)
    onehot = np.eye(5, dtype=np.float32)[cls][:, 1:]
    f6 = t(np.concatenate([np.ones((20480, 1), np.float32), onehot,
                           inten[psel][:, None] / 255.0], 1))
    s2k, c2k = kernels.moments(q, p, pm, r2s, f6, cr2)
    s2p, c2p = kernels.moments_plain(q, p, pm, r2s, f6, cr2)
    torch.cuda.synchronize()
    # tolerance: counts and one-hot sums are integers, exact in fp32 and
    # identical adjacency -> exact; the intensity column differs only by
    # summation order (1e-5 relative)
    exact_ok = (torch.equal(s1k, s1p) and torch.equal(s2k[:, :5], s2p[:, :5])
                and torch.equal(c2k[:, :5], c2p[:, :5]))
    err = max(float((s1k - s1p).abs().max()), float((s2k - s2p).abs().max()),
              float((c2k - c2p).abs().max()))
    if not (exact_ok and torch.allclose(s2k, s2p, rtol=1e-5, atol=1e-4)
            and torch.allclose(c2k, c2p, rtol=1e-5, atol=1e-4)):
        raise AssertionError(f"moments: counts differ or max err {err}")
    if not (same_bits(lambda: kernels.moments(q, p, pm, r2, ones))
            and same_bits(lambda: kernels.moments(q, p, pm, r2s, f6, cr2))):
        raise AssertionError("moments: two launches differ")
    ms = (device_ms(lambda: kernels.moments(q, p, pm, r2, ones), 20)[0]
          + device_ms(lambda: kernels.moments(q, p, pm, r2s, f6, cr2), 20)[0])
    ev = (time_ms(lambda: kernels.moments(q, p, pm, r2, ones), 20)
          + time_ms(lambda: kernels.moments(q, p, pm, r2s, f6, cr2), 20))
    plain = (time_ms(lambda: kernels.moments_plain(q, p, pm, r2, ones), 5)
             + time_ms(lambda: kernels.moments_plain(q, p, pm, r2s, f6, cr2),
                       5))
    lib = (time_ms(lambda: cdist_sums(q, p, pm, r2, ones, 4096), 5)
           + time_ms(lambda: (cdist_sums(q, p, pm, r2s, f6, 4096),
                              cdist_sums(q, p, pm, cr2, f6, 4096)), 5))
    pairs = 2.0 * 4096 * 20480
    hits1, hits2 = float(s1k[:, 0].sum()), float(s2k[:, 0].sum())
    close2 = float(c2k[:, 0].sum())
    flops = 10.0 * pairs + 1.0 * hits1 + 6.0 * hits2 + 6.0 * close2
    nbytes = 2 * (4096 * 16 + 20480 * 13) + 20480 * 28 + 4096 * (4 + 48)
    b, by = bound_ms(flops, nbytes)
    print(f"[kernels] moments 4096x20480 (C=1, then C=6 + close): counts "
          f"exact, max|err| {err:.3g}, same bits twice; kernel {ms:.4f} ms "
          f"on the device ({ev:.4f} ms with CUDA events), plain "
          f"{plain:.4f} ms, cdist+compare+matmul {lib:.4f} ms, bound "
          f"{b:.5f} ms ({by}); hits per query {hits1 / 4096:.1f} (pass 1), "
          f"{hits2 / 4096:.1f} (pass 2)", flush=True)
    rows.append({"name": "moments", "shape": "2 x 4096x20480",
                 "max_abs_err": err, "ms": ms, "event_ms": ev,
                 "plain_ms": plain, "library_ms": lib, "bound_ms": b,
                 "bound_by": by})

    # --- pca_moments: the frame's PCA as the main path calls it (Morton
    # order), the same support with random queries, and the map refresh's
    # two shapes at r = 1.8.
    for shape, (q, p, pm, r2) in pca_cases(scan, world, pose, dev,
                                           seed).items():
        rows.append(pca_check(shape, q, p, pm, r2))
    return rows


BATCH_S = 8  # the sequences of the batched kernel checks


def batched_kernel_phase(scan: dict, dev, seed: int) -> dict:
    """The three kernels of the batched step at S = BATCH_S sequences,
    each sequence its own random subsets of the scan at the main path's
    full-width shapes: one batched launch against BATCH_S single launches
    bit for bit (tolerance 0: an entry keeps its own tiles, chunks and
    merge order), against the plain version on the last entry (nn: bit for
    bit; moments and pca_moments: counts exact, sums as in the kernel
    phase, on its first 1024 queries), and the same bits twice; then the
    batched launch's device and CUDA-event ms beside the BATCH_S single
    launches', and its bound (the single launch's, x BATCH_S, from this
    run's hits)."""
    import torch
    from mulls_tpu_torch.ops import kernels
    from mulls_tpu_torch.tools.roofline import bound_ms, device_ms, time_ms

    rng = np.random.default_rng(seed + 3)
    valid = np.where(scan["mask"])[0]
    pts = scan["xyz"][valid]
    S = BATCH_S

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    def clouds(n, valid_frac, jitter=0.0):
        xyz = np.stack([pts[rng.choice(len(pts), n, replace=False)]
                        for _ in range(S)])
        xyz = xyz + jitter * rng.normal(size=xyz.shape).astype(np.float32)
        return t(xyz), t(rng.uniform(size=(S, n)) < valid_frac, torch.bool)

    def entries_equal(name, batched, single):
        """batched: a tuple of [S, ...] outputs; single(s): entry s's."""
        for s in range(S):
            for k, (b, a) in enumerate(zip(batched, single(s))):
                if not torch.equal(b[s], a):
                    raise AssertionError(f"{name}: sequence {s}, output {k} "
                                         f"differs from its single launch")

    def report(name, shape, fn, singles, plain, library, flops, nbytes,
               extra=""):
        """``plain``: the plain version over the [S, ...] inputs;
        ``library``: one batched PyTorch computation of the same function
        over them (timed only)."""
        if not same_bits(fn):
            raise AssertionError(f"{name} S = {S}: two launches differ")
        ms, ops = device_ms(fn, 20)
        ev = time_ms(fn, 20)
        s_ms, s_ops = device_ms(singles, 10)
        s_ev = time_ms(singles, 10)
        plain_ms = time_ms(plain, 2)
        lib = time_ms(library, 3)
        b, by = bound_ms(flops, nbytes)
        print(f"[kernels] {name} batched, S = {S} x {shape}: every sequence "
              f"equal to its single launch bit for bit{extra}, same bits "
              f"twice; one launch {ms:.4f} ms on the device ({n_ops(ops)} "
              f"device operations a call; {ev:.4f} ms with CUDA events), "
              f"{S} single launches {s_ms:.4f} ms on the device "
              f"({n_ops(s_ops)} operations; {s_ev:.4f} ms with CUDA events), "
              f"the plain version {plain_ms:.4f} ms and the batched "
              f"library call {lib:.4f} ms (CUDA events), "
              f"bound {b:.5f} ms ({by}; {S} x the single bound)",
              flush=True)
        return {"shape": f"{S} x {shape}", "sequences": S, "ms": ms,
                "event_ms": ev, "device_ops_per_call": ops,
                "single_launches_ms": s_ms, "single_launches_event_ms": s_ev,
                "plain_ms": plain_ms, "library_ms": lib, "bound_ms": b,
                "bound_by": by, "max_abs_err": 0.0}

    out = {}
    # --- nn: one ICP iteration's five classes for S sequences, one launch
    icp_shapes = ((800, 6144), (400, 1536), (1200, 8192), (200, 1024),
                  (200, 512))
    group = []
    for qn, pn in icp_shapes:
        q, qm = clouds(qn, 0.9, jitter=0.05)
        p, pm = clouds(pn, 0.9)
        group.append((q, qm, p, pm))
    kernels.reset_launch_counts()
    got = kernels.nn_grouped(group)
    torch.cuda.synchronize()
    if kernels.launch_counts()["nn"] != 1:
        raise AssertionError(f"nn_grouped S = {S}: "
                             f"{kernels.launch_counts()['nn']} launches")
    flat = [x for pair in got for x in pair]
    entries_equal("nn_grouped", flat, lambda s: [
        x for pair in kernels.nn_grouped([tuple(a[s] for a in pr)
                                          for pr in group]) for x in pair])
    plain = kernels.nn_grouped_plain([tuple(a[S - 1] for a in pr)
                                      for pr in group])
    for (ik, dk), (ip, dp) in zip(got, plain):
        if not (torch.equal(ik[S - 1], ip) and torch.equal(dk[S - 1], dp)):
            raise AssertionError(f"nn_grouped S = {S}: the last sequence "
                                 f"differs from the plain version")
    pairs = S * sum(qn * pn for qn, pn in icp_shapes)
    nbytes = S * sum(qn * 13 + pn * 13 + qn * 8 for qn, pn in icp_shapes)
    out["nn_grouped"] = report(
        "nn_grouped", " + ".join(f"{qn}x{pn}" for qn, pn in icp_shapes),
        lambda: kernels.nn_grouped(group),
        lambda: [kernels.nn_grouped([tuple(a[s] for a in pr)
                                     for pr in group]) for s in range(S)],
        lambda: kernels.nn_grouped_plain(group),
        lambda: cdist_min(group),  # cdist + min per class over [S, ...]
        9.0 * pairs, nbytes, extra=" and the plain version")

    # --- moments: the descriptor's two passes, 4096 x 20480 a sequence
    p, pm = clouds(20480, 0.95)
    q, _ = clouds(4096, 1.0)
    r2 = torch.full((S, 4096), 0.7 ** 2, dtype=torch.float32, device=dev)
    ones = torch.ones((S, 20480, 1), dtype=torch.float32, device=dev)
    s1, _ = kernels.moments(q, p, pm, r2, ones)
    r2s = (r2 * torch.clamp(25.0 / torch.clamp(s1[..., 0], min=1.0),
                            max=1.0)).contiguous()
    cr2 = torch.clamp(r2s, max=0.64 * 0.49).contiguous()
    cls = rng.integers(0, 5, (S, 20480))
    f6 = t(np.concatenate([np.ones((S, 20480, 1), np.float32),
                           np.eye(5, dtype=np.float32)[cls][..., 1:],
                           rng.uniform(size=(S, 20480, 1))], -1)
           .astype(np.float32))
    s2, c2 = kernels.moments(q, p, pm, r2s, f6, cr2)
    entries_equal("moments", (s1,), lambda s: kernels.moments(
        q[s], p[s], pm[s], r2[s], ones[s])[:1])
    entries_equal("moments", (s2, c2), lambda s: kernels.moments(
        q[s], p[s], pm[s], r2s[s], f6[s], cr2[s]))
    e = S - 1
    ps2, pc2 = kernels.moments_plain(q[e, :1024], p[e], pm[e], r2s[e, :1024],
                                     f6[e], cr2[e, :1024])
    err = max(float((s2[e, :1024] - ps2).abs().max()),
              float((c2[e, :1024] - pc2).abs().max()))
    if not (torch.equal(s2[e, :1024, :5], ps2[:, :5])
            and torch.equal(c2[e, :1024, :5], pc2[:, :5]) and err <= 1e-4):
        raise AssertionError(f"moments S = {S}: the last sequence differs "
                             f"from the plain version (max err {err})")
    hits = float(s1[..., 0].sum() + 6.0 * s2[..., 0].sum()
                 + 6.0 * c2[..., 0].sum())
    flops = 10.0 * 2 * S * 4096 * 20480 + hits
    nbytes = S * (2 * (4096 * 16 + 20480 * 13) + 20480 * 28
                  + 4096 * (4 + 48))
    out["moments"] = report(
        "moments", "2 x 4096x20480",
        lambda: (kernels.moments(q, p, pm, r2, ones),
                 kernels.moments(q, p, pm, r2s, f6, cr2)),
        lambda: [(kernels.moments(q[s], p[s], pm[s], r2[s], ones[s]),
                  kernels.moments(q[s], p[s], pm[s], r2s[s], f6[s], cr2[s]))
                 for s in range(S)],
        lambda: (kernels.moments_plain(q, p, pm, r2, ones),
                 kernels.moments_plain(q, p, pm, r2s, f6, cr2)),
        # cdist + compare + fp32 matmul over [S, ...], both passes
        lambda: (cdist_sums(q, p, pm, r2, ones, 512),
                 cdist_sums(q, p, pm, r2s, f6, 512),
                 cdist_sums(q, p, pm, cr2, f6, 512)),
        flops, nbytes, extra=f" (two launches a pair of passes); the "
                             f"plain version on the last's first 1024 "
                             f"queries: counts exact, max|err| {err:.3g}")
    out["moments"]["max_abs_err"] = err

    # --- pca_moments: the frame PCA, 10240 Morton-ordered queries of a
    # sequence's 20480 unground points, r = 0.7
    from mulls_tpu_torch.ops.pca import morton_order
    p, pm = clouds(20480, 0.95)
    q = p[:, :10240]
    q = torch.stack([q[s][morton_order(q[s])] for s in range(S)])
    r2 = torch.full((S, 10240), 0.49, dtype=torch.float32, device=dev)
    cnt, s1p, s2p = kernels.pca_moments(q, p, pm, r2)
    entries_equal("pca_moments", (cnt, s1p, s2p), lambda s: kernels.pca_moments(
        q[s], p[s], pm[s], r2[s]))
    pc, p1, p2 = kernels.pca_moments_plain(q[e, :1024], p[e], pm[e],
                                           r2[e, :1024])
    err = max(float((s1p[e, :1024] - p1).abs().max()),
              float((s2p[e, :1024] - p2).abs().max()))
    if not (torch.equal(cnt[e, :1024], pc) and err <= 1e-4):
        raise AssertionError(f"pca_moments S = {S}: the last sequence "
                             f"differs from the plain version (max err "
                             f"{err})")
    hits = float(cnt.sum())
    flops = 10.0 * S * 10240 * 20480 + 15.0 * hits
    nbytes = S * (10240 * 16 + 20480 * 13 + 10240 * 40)
    # the yardstick: cdist + compare + fp32 matmul with a [S, P, 10] stack
    # of 1, p and the upper terms of p p^T
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    stack = torch.stack([torch.ones_like(x), x, y, z, x * x, x * y, x * z,
                         y * y, y * z, z * z], -1)
    out["pca_moments"] = report(
        "pca_moments", "10240x20480", lambda: kernels.pca_moments(
            q, p, pm, r2),
        lambda: [kernels.pca_moments(q[s], p[s], pm[s], r2[s])
                 for s in range(S)],
        lambda: kernels.pca_moments_plain(q, p, pm, r2),
        lambda: cdist_sums(q, p, pm, r2, stack, 512),
        flops, nbytes, extra=f" (chunk {kernels.pca_chunk(10240, 20480)}, "
                             f"{hits / (S * 10240):.2f} hits a query); the "
                             f"plain version on the last's first 1024 "
                             f"queries: counts exact, max|err| {err:.3g}")
    out["pca_moments"]["max_abs_err"] = err
    return out


def pca_check(shape: str, q, p, pm, r2) -> dict:
    """``pca_moments`` against its plain version on one input (counts exact,
    covariances to 1e-6 m^2, lambda_3 to 1 %, same bits twice), timed."""
    import torch
    from mulls_tpu_torch.ops import kernels
    from mulls_tpu_torch.ops.neighbors import cov_from_moments
    from mulls_tpu_torch.tools.roofline import bound_ms, device_ms, time_ms

    qn, pn = q.shape[0], p.shape[0]
    ck, sk, ok_ = kernels.pca_moments(q, p, pm, r2)
    cp, sp, op = kernels.pca_moments_plain(q, p, pm, r2)
    torch.cuda.synchronize()
    cov_k = cov_from_moments(ck, sk, ok_)
    cov_p = cov_from_moments(cp, sp, op)
    err = float((cov_k - cov_p).abs().max())
    # tolerance: counts exact (same adjacency); covariances to 1e-6 m^2, a
    # few ulp of a 0.7 m neighborhood's spread (~1e-1 m^2); and the
    # smallest eigenvalue, which normals and classes read (~6e-5 m^2 on an
    # 8 mm-noise plane), to 1 % per query.  Sums centred far from the
    # query lose it: at 60 m, fp32 rounding alone is ~2e-4 m^2.
    lam_k = torch.linalg.eigvalsh(cov_k.double())[:, 0]
    lam_p = torch.linalg.eigvalsh(cov_p.double())[:, 0]
    full = cp >= 5
    lam_err = float(((lam_k - lam_p).abs() / (lam_p.abs() + 1e-6))[full]
                    .max())
    lam_ok = bool(torch.all(((lam_k - lam_p).abs()
                             <= 1e-2 * lam_p.abs() + 1e-8)[full]))
    if not (torch.equal(ck, cp) and err <= 1e-6 and lam_ok):
        raise AssertionError(f"pca_moments {shape}: counts differ, cov err "
                             f"{err} or lambda_3 relative err {lam_err}")
    if not same_bits(lambda: kernels.pca_moments(q, p, pm, r2)):
        raise AssertionError(f"pca_moments {shape}: two launches differ")
    ms = device_ms(lambda: kernels.pca_moments(q, p, pm, r2), 20)[0]
    ev = time_ms(lambda: kernels.pca_moments(q, p, pm, r2), 20)
    plain = time_ms(lambda: kernels.pca_moments_plain(q, p, pm, r2), 3)
    # the yardstick: the count, sums and uncentred second moments as one
    # matmul of the 0/1 adjacency with a [P, 10] stack
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    stack = torch.stack([torch.ones_like(x), x, y, z, x * x, x * y, x * z,
                         y * y, y * z, z * z], 1)
    lib = time_ms(lambda: cdist_sums(q, p, pm, r2, stack, 2048), 3)
    hits = float(ck.sum())
    # 10 operations a pair for the distance and the compare, 15 a hit (the
    # probe's count)
    flops = 10.0 * qn * pn + 15.0 * hits
    nbytes = qn * 16 + pn * 13 + qn * 40
    b, by = bound_ms(flops, nbytes)
    print(f"[kernels] pca_moments {shape} (r = "
          f"{float(r2.sqrt().max()):.2f}, {hits / qn:.2f} hits a query, chunk "
          f"{kernels.pca_chunk(qn, pn)}): counts exact, max|cov err| "
          f"{err:.3g} m^2, max lambda_3 relative err {lam_err:.3g} "
          f"({int(full.sum())} queries, median lambda_3 "
          f"{float(lam_p[full].median()):.3g} m^2), same bits twice; "
          f"kernel {ms:.4f} ms on the device ({ev:.4f} ms with CUDA "
          f"events), plain {plain:.4f} ms, cdist+compare+matmul {lib:.4f} "
          f"ms, bound {b:.5f} ms ({by})", flush=True)
    return {"name": "pca_moments", "shape": shape, "max_abs_err": err,
            "ms": ms, "event_ms": ev, "plain_ms": plain, "library_ms": lib,
            "bound_ms": b, "bound_by": by, "hits_per_query": hits / qn}


# --------------------------------------------------------------------------
# phase 4: the roofline probe and its two kernels
# --------------------------------------------------------------------------

def dense_case(scan: dict, rng: np.random.Generator, dev) -> tuple:
    """(q, p, p_mask) on ``dev``: 20480 of the scan's points, 3 % masked,
    and 10240 of them as queries."""
    import torch
    pts = scan["xyz"][np.where(scan["mask"])[0]]
    p = torch.as_tensor(pts[rng.choice(len(pts), 20480, replace=False)],
                        device=dev)
    pm = torch.as_tensor(rng.uniform(size=20480) < 0.97, device=dev)
    sel = torch.as_tensor(rng.choice(20480, 10240, replace=False),
                          device=dev)
    return p[sel].contiguous(), p, pm


def cdist_count(q, p, pm, r2, rows: int):
    """The library yardstick of count_within (timed only, never called by
    the port): torch.cdist, compare, sum, in query slices of ``rows``."""
    import torch
    r = r2.clamp(min=0).sqrt()
    return torch.cat([((torch.cdist(q[s:s + rows], p) <= r[s:s + rows, None])
                       & pm).sum(1) for s in range(0, q.shape[0], rows)])


def cdist_sums(q, p, pm, r2, feats, rows: int):
    """The library yardstick of moments and pca_moments (timed only):
    torch.cdist, compare, an fp32 matmul of the 0/1 adjacency with the
    [P, C] features, in query slices of ``rows``; over leading batch
    dimensions too (``q`` [..., Q, 3], ``feats`` [..., P, C])."""
    import torch
    r = r2.clamp(min=0).sqrt()
    return torch.cat([torch.matmul(
        ((torch.cdist(q[..., s:s + rows, :], p)
          <= r[..., s:s + rows, None]) & pm[..., None, :]).to(
            torch.float32), feats) for s in range(0, q.shape[-2], rows)],
        dim=-2)


def cdist_min(group):
    """The library yardstick of nn and nn_grouped (timed only): torch.cdist
    and min for each problem, masked support moved out of reach; over
    leading batch dimensions too."""
    import torch
    return [torch.cdist(q, torch.where(pm[..., None], p,
                                       torch.full_like(p, 1e18))).min(dim=-1)
            for q, _, p, pm in group]


def cdist_stack(q, p, pm, r2, stack, rows: int):
    """The library yardstick of adj_stack (timed only): torch.cdist,
    compare, a bf16 matmul with the stack, in query slices of ``rows``."""
    import torch
    r = r2.clamp(min=0).sqrt()
    return torch.cat([torch.matmul(
        ((torch.cdist(q[s:s + rows], p) <= r[s:s + rows, None]) & pm).to(
            torch.bfloat16), stack) for s in range(0, q.shape[0], rows)])


def probe_phase(scan: dict, dev, seed: int) -> dict:
    import torch
    from mulls_tpu_torch.ops import kernels
    from mulls_tpu_torch.tools import roofline as rf

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    def check(tag, q, p, pm, r2, stacks) -> float:
        """count_within exact; adj_stack exact for integer-valued stacks
        (0/1 times integers below 2^24 sums exactly in fp32), and for the
        others within rtol 1e-5 and atol 1e-5 x the sum of |terms| (fp32
        summation order); every kernel twice for the same bits."""
        ck = rf.count_within(q, p, pm, r2)
        cp = rf.count_within_plain(q, p, pm, r2)
        torch.cuda.synchronize()
        if not torch.equal(ck, cp):
            raise AssertionError(f"count_within {tag}: "
                                 f"{int((ck != cp).sum())} counts differ")
        if not same_bits(lambda: rf.count_within(q, p, pm, r2)):
            raise AssertionError(f"count_within {tag}: two launches differ")
        errs = []
        for name, f, exact in stacks:
            sk = rf.adj_stack(q, p, pm, r2, f)
            sp = rf.adj_stack_plain(q, p, pm, r2, f)
            err = float((sk - sp).abs().max())
            if exact:
                ok = torch.equal(sk, sp)
            else:
                terms = rf.adj_stack_plain(q, p, pm, r2, f.abs())
                ok = bool(torch.all((sk - sp).abs()
                                    <= 1e-5 * sp.abs() + 1e-5 * terms))
            if not ok:
                raise AssertionError(f"adj_stack {tag}, {name}: max err "
                                     f"{err} outside the tolerance")
            if not same_bits(lambda: rf.adj_stack(q, p, pm, r2, f)):
                raise AssertionError(f"adj_stack {tag}, {name}: two "
                                     f"launches differ")
            errs.append(err)
            print(f"[probe] adj_stack {tag}, {name}: "
                  f"{'exact' if exact else f'max|err| {err:.3g}'}, same "
                  f"bits twice", flush=True)
        print(f"[probe] count_within {tag}: exact, same bits twice; "
              f"{float(ck.mean()):.3f} hits a query", flush=True)
        return max(errs)

    # (a) the probe's own inputs: 20480 x 20480, r^2 = 1, the ones stack
    x = rf.probe_inputs()
    q, p = t(x["q_map"]), t(x["p"])
    qn, pn = q.shape[0], p.shape[0]
    pm = torch.ones(pn, dtype=torch.bool, device=dev)
    r2 = torch.ones(qn, dtype=torch.float32, device=dev)
    ones = torch.ones((pn, 128), dtype=torch.bfloat16, device=dev)
    err_a = check(f"probe {qn}x{pn}", q, p, pm, r2,
                  [("ones C=128", ones, True)])
    plain = {"count_within": rf.time_ms(
        lambda: rf.count_within_plain(q, p, pm, r2), 3),
        "adj_stack": rf.time_ms(
            lambda: rf.adj_stack_plain(q, p, pm, r2, ones), 3)}
    library = {"count_within": rf.time_ms(
        lambda: cdist_count(q, p, pm, r2, 4096), 3),
        "adj_stack": rf.time_ms(
            lambda: cdist_stack(q, p, pm, r2, ones, 4096), 3)}
    print(f"[probe] library yardsticks at {qn}x{pn} (timed only; cdist "
          f"expands the square, so its adjacency may differ on the radius): "
          f"cdist + compare + sum {library['count_within']:.4f} ms, cdist + "
          f"compare + bf16 matmul C=128 {library['adj_stack']:.4f} ms",
          flush=True)
    del q, p, pm, r2, ones

    # (b) dense: the frame PCA's shape, 10240 queries (a subset of the
    # support) x 20480 scan points at r = 0.7, as the pca_moments check
    rng = np.random.default_rng(seed + 3)
    q, p, pm = dense_case(scan, rng, dev)
    r2 = torch.full((10240,), 0.7 ** 2, dtype=torch.float32, device=dev)
    cols = np.arange(1, 65, dtype=np.float32)[None, :]
    stacks = [
        ("ones C=128", torch.ones((20480, 128), dtype=torch.bfloat16,
                                  device=dev), True),
        # column-distinct integers (|value| <= 256, exact in bf16): a
        # transposed fragment would show
        ("integers C=64", t(cols * rng.integers(-4, 5, (20480, 1)),
                            torch.bfloat16), True),
        ("random C=16", t(rng.normal(size=(20480, 16)), torch.bfloat16),
         False),
        ("random C=128", t(rng.normal(size=(20480, 128)), torch.bfloat16),
         False)]
    err_b = check("dense 10240x20480", q, p, pm, r2, stacks)

    # the dense case timed for each form of the neighbourhood sum, as the
    # radius (and so the hits a query) grows: pca_moments and moments with
    # ten columns are hit-sparse, adj_stack dense, count_within the
    # cell-grid count (its kernel alone: the index is tensor ops)
    f10 = t(rng.uniform(size=(20480, 10)))
    dense = {}
    for r in (0.7, 1.0, 1.8, 3.0):
        r2 = torch.full((10240,), r ** 2, dtype=torch.float32, device=dev)
        hits = float(rf.count_within_plain(q, p, pm, r2).sum())
        row = {"hits_per_query": hits / 10240}
        for name, fn, kern in (
                ("pca_moments", lambda: kernels.pca_moments(q, p, pm, r2),
                 None),
                ("count_within (cell grid)",
                 lambda: rf.count_within(q, p, pm, r2),
                 "count_within_kernel"),
                ("moments C=10", lambda: kernels.moments(q, p, pm, r2, f10),
                 None),
                ("adj_stack C=16", lambda: rf.adj_stack(q, p, pm, r2,
                                                        stacks[2][1]),
                 "adj_stack_kernel"),
                ("adj_stack C=128", lambda: rf.adj_stack(q, p, pm, r2,
                                                         stacks[3][1]),
                 "adj_stack_kernel")):
            row[name] = rf.device_ms(fn, 20, kern)[0]
        dense[f"r={r}"] = row
        print(f"[probe] dense 10240x20480 (r = {r}, {hits / 10240:.1f} hits "
              f"a query), device ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items()
                          if k != "hits_per_query"), flush=True)

    # the probe itself, through its entry point's function; its launches
    rf.reset_launch_counts()
    rec = rf.run_probe(dev, x)
    launches = rf.launch_counts()
    print(f"[probe] launches {launches}", flush=True)
    for name, k in launches.items():
        if k <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"probe")
    rows = {r["kernel"]: r for r in rec["rows"]}
    entries = []
    for name, line, err in (("count_within", 69, 0.0),
                            ("adj_stack", 84, max(err_a, err_b))):
        r = rows[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"mulls_tpu_torch/csrc/{name}.cu",
            "replaces": f"tools/perf_mfu_roofline.py:{line}",
            "launches": launches[name], "max_abs_err": err,
            "ms": r["device_ms"], "plain_ms": plain[name],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": library[name], "shape": r["shape"],
            "event_ms": r["event_ms"],
            "call_device_ms": r["call_device_ms"]})
        if name == "count_within":
            entries[-1]["candidate_pairs"] = r["candidate_pairs"]
    return {"entries": entries, "record": rec, "dense": dense,
            "library_ms": library}


# --------------------------------------------------------------------------
# phase 5: the main path
# --------------------------------------------------------------------------

def main_phase(frames: list, gt: np.ndarray, dev) -> dict:
    import torch
    from mulls_tpu_torch.config import MullsConfig
    from mulls_tpu_torch.ops import kernels
    from mulls_tpu_torch.pipeline.odometry import OdometryPipeline

    cfg = MullsConfig()
    pipe = OdometryPipeline(cfg, device=dev)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipe.run(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()

    n = len(frames)
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    end_err = float(np.linalg.norm(res.poses[-1, :3, 3]
                                   - gt_rel[-1, :3, 3]))
    dist = float(np.sum(np.linalg.norm(np.diff(gt_rel[:, :3, 3], axis=0),
                                       axis=1)))
    codes = res.codes
    bad = [(i, c) for i, c in enumerate(codes) if i > 0 and c != 1]
    print(f"[main] {n} frames at full width in {wall:.2f} s: "
          f"{n / wall:.2f} frames/s (the first frames include warm-up)",
          flush=True)
    print(f"[main] codes {codes}", flush=True)
    for i, c in bad:
        print(f"[main] frame {i}: code {c}", flush=True)
    print(f"[main] end translation error {end_err:.4f} m over {dist:.1f} m "
          f"({100.0 * end_err / max(dist, 1e-9):.3f} %)", flush=True)
    print(f"[main] launches {launches}: nn {launches['nn'] / n:.2f} per "
          f"frame ({launches['nn_grouped'] / n:.2f} of them grouped)",
          flush=True)
    return {"frames": n, "seconds": wall, "fps": n / wall, "codes": codes,
            "bad": bad, "end_err_m": end_err, "dist_m": dist,
            "launches": launches, "sigmas": res.sigmas, "poses": res.poses}


# --------------------------------------------------------------------------
# phase 6: the card against the CPU at a small width
# --------------------------------------------------------------------------

class HostDraws:
    """The port's ``Draws`` made by one CPU generator and moved to
    ``device``: a card run and a CPU run see the same numbers."""

    def __init__(self, seed: int, device):
        import torch
        self.device = device
        self.gen = torch.Generator().manual_seed(seed)

    def split(self, n: int):
        return [self] * n

    def uniform(self, shape):
        import torch
        return torch.rand(tuple(shape), generator=self.gen).to(self.device)

    def bits(self, shape):
        import torch
        return torch.randint(0, 1 << 32, tuple(shape), generator=self.gen,
                             dtype=torch.int64).to(self.device)


def small_cfg():
    from mulls_tpu_torch.config import (FeatureConfig, MapConfig,
                                        MapShapeConfig, MullsConfig,
                                        ShapeConfig)
    return MullsConfig(
        shapes=ShapeConfig(n_raw=16384, n_unground=8192, n_ground_full=1024,
                           n_pillar_full=512, n_beam_full=512,
                           n_facade_full=1024, n_roof_full=256,
                           n_vertex_full=512, grid_dim=64),
        feature=FeatureConfig(ground_down_fixed_num=256,
                              pillar_down_fixed_num=128,
                              facade_down_fixed_num=256,
                              beam_down_fixed_num=64, roof_down_fixed_num=64,
                              unground_down_fixed_num=2048,
                              vertex_keep_num=128),
        map=MapConfig(shapes=MapShapeConfig(ground=1024, pillar=256,
                                            beam=256, facade=1024, roof=128,
                                            vertex=256)))


def motion_diff(a: np.ndarray, b: np.ndarray):
    """(translation m, rotation deg) between two [4,4] motions.  The angle
    comes from both its sine and its cosine: arccos of the trace alone has
    a floor of ~0.03 deg for f32 rotations that are equal."""
    M = a[:3, :3].T @ b[:3, :3]
    s = np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                        M[1, 0] - M[0, 1]]) / 2.0
    return (float(np.linalg.norm(a[:3, 3] - b[:3, 3])),
            float(np.degrees(np.arctan2(s, (np.trace(M) - 1.0) / 2.0))))


def leaves(x, path: str = "") -> list:
    """(path, tensor) for the tensors of a nest of dataclasses, dicts and
    tuples, in order."""
    import dataclasses

    import torch
    if torch.is_tensor(x):
        return [(path, x)]
    if dataclasses.is_dataclass(x):
        items = [(f.name, getattr(x, f.name)) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        items = list(x.items())
    elif hasattr(x, "_fields"):  # a NamedTuple
        items = list(zip(x._fields, x))
    elif isinstance(x, (list, tuple)):
        items = list(enumerate(x))
    else:
        return []
    return [leaf for k, v in items
            for leaf in leaves(v, f"{path}.{k}" if path else str(k))]


def out_diff(a, b, worst: bool = False):
    """(integer or bool elements that differ, largest float difference)
    between two outputs of the same call on the CPU and on the card; with
    ``worst``, also the path of the output that differs most."""
    flips, dmax, where, top = 0, 0.0, None, 0.0
    for (path, x), (_, y) in zip(leaves(a), leaves(b)):
        x, y = x.cpu(), y.cpu()
        if x.numel() == 0:
            continue
        if x.dtype.is_floating_point:
            d = float((x.double() - y.double()).abs().max())
            dmax = max(dmax, d)
        else:
            d = int((x != y).sum())
            flips += d
        if d > top:
            where, top = path, d
    return (flips, dmax, where) if worst else (flips, dmax)


class Recorder:
    """Records the inputs and outputs of the feature stage's operations and
    of every ICP run, in call order, while it is entered."""

    def __init__(self):
        from mulls_tpu_torch.frontend import features as F
        from mulls_tpu_torch.pipeline import odometry as odo
        self.targets = [
            (F.ground_ops, "fast_ground_filter"), (F, "compact_topk_random"),
            (F.pca_ops, "morton_order"), (F.pca_ops, "pca_features"),
            (F, "compact_topk_score"), (F.nbr, "knn_class_counts"),
            (F.nms_ops, "non_max_suppress"),
            (F.voxel_ops, "xy_normal_balanced_mask"), (odo, "mm_lls_icp")]
        self.log = []

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n in self.targets]
        for m, n, fn in self.saved:
            def call(*a, _fn=fn, _n=n, **k):
                out = _fn(*a, **k)
                self.log.append((_n, (a, k), out))
                return out
            setattr(m, n, call)
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def call_diffs(log_a: list, log_b: list) -> dict:
    """Between the calls of the CPU and of the card, in call order: the
    first whose outputs differ at all, the first whose integer or bool
    outputs differ (a flipped mask, index or count), every call with such
    flips, and the sources, the calls that got equal inputs and gave
    different outputs (with each output that differs)."""
    res = {"first_diff": None, "first_flip": None, "sources": [],
           "flipped": []}
    for i, ((name, args_a, a), (_, args_b, b)) in enumerate(
            zip(log_a, log_b)):
        flips, dmax, where = out_diff(a, b, worst=True)
        if not (flips or dmax > 0.0):
            continue
        tag = (f"{name} (call {i}): {flips} flips, max float diff "
               f"{dmax:.3g}, most in {where}")
        res["first_diff"] = res["first_diff"] or tag
        if flips:
            res["first_flip"] = res["first_flip"] or tag
            res["flipped"].append(f"{name} (call {i}) {flips}")
        if out_diff(args_a, args_b) == (0, 0.0):
            fields = [(p, out_diff(x, y)) for (p, x), (_, y) in
                      zip(leaves(a), leaves(b))]
            res["sources"].append(tag + " (" + ", ".join(
                f"{p or 'out'} {f or d:.3g}" for p, (f, d) in fields
                if f or d) + ")")
    return res


def isolate_stages(cfg, frames: list, dev, seed: int) -> list:
    """Where card and CPU part.  The CPU run is driven step by step; at each
    frame the card is handed the CPU's own state, inputs and draws, one
    stage at a time, so that a difference shows in the stage that makes it
    and does not carry over from earlier frames."""
    import torch

    from mulls_tpu_torch.core.cloud import pack_raw_host
    from mulls_tpu_torch.core.tree import tree_map
    from mulls_tpu_torch.pipeline import odometry as odo

    def to(tree, where):
        return tree_map(lambda x: x.to(where) if torch.is_tensor(x) else x,
                        tree)

    def on_card(state, gen_state):
        d = HostDraws(seed, dev)
        d.gen.set_state(gen_state)
        return to(state, dev).replace(draws=d)

    state = odo.init_state(cfg, "cpu", draws=HostDraws(seed, "cpu"))
    gen = state.draws.gen
    rows = []
    for i, f in enumerate(frames):
        raw = pack_raw_host(f, with_ts=False)
        g0 = gen.get_state()
        with Recorder() as rc:
            frame_c, _ = odo._feature_stage(state, raw, cfg, state.draws)
        g1 = gen.get_state()
        card = on_card(state, g0)
        with Recorder() as rd:
            frame_d, _ = odo._feature_stage(card, to(raw, dev), cfg,
                                            card.draws)
        feat = call_diffs(rc.log, rd.log)
        down_flips = {k: out_diff(frame_c.down[k], frame_d.down[k])[0]
                      for k in frame_c.down}

        # registration, on the CPU's features and on the card's own
        with Recorder() as rc:
            reg_c = odo._register_stage(state, frame_c, cfg)
        with Recorder() as rd:
            reg_d = odo._register_stage(card, to(frame_c, dev), cfg)
        reg = call_diffs(rc.log, rd.log)
        T_c = reg_c[0].T_rel.double().numpy()
        own = odo._register_stage(card, frame_d, cfg)[0]
        dt, dr = motion_diff(T_c, reg_d[0].T_rel.double().cpu().numpy())
        dt_own, dr_own = motion_diff(T_c, own.T_rel.double().cpu().numpy())

        # the map update, on the CPU's frame and motion
        out_c, dyn_max, removal_ok = reg_c[0], reg_c[4], reg_c[5]
        lm_c = odo._map_stage(state, frame_c, out_c.T_rel, dyn_max,
                              removal_ok, cfg, state.draws,
                              odo._gate_append(cfg, out_c))
        card.draws.gen.set_state(g1)
        lm_d = odo._map_stage(card, to(frame_c, dev), *to(
            (out_c.T_rel, dyn_max, removal_ok), dev), cfg, card.draws,
            to(odo._gate_append(cfg, out_c), dev))
        map_flips, map_dmax = out_diff(lm_c, lm_d)

        row = {"frame": i, "feature": feat, "down_flips": down_flips,
               "reg": reg, "reg_dt_m": dt, "reg_dr_deg": dr,
               "reg_own_dt_m": dt_own, "reg_own_dr_deg": dr_own,
               "map_flips": map_flips, "map_max_diff": map_dmax}
        rows.append(row)
        print(f"[agree] frame {i}: feature stage: first difference "
              f"{feat['first_diff']}; first flip {feat['first_flip']}; "
              f"sources {feat['sources']}; calls with flips "
              f"{feat['flipped']}; down-cloud flips {down_flips}",
              flush=True)
        print(f"[agree] frame {i}: reg on the CPU's features differs by "
              f"{dt:.2e} m, {dr:.2e} deg (first difference "
              f"{reg['first_diff']}; first flip {reg['first_flip']}; "
              f"sources {reg['sources']}); on the card's own features by "
              f"{dt_own:.2e} m, {dr_own:.2e} deg; map on the CPU's inputs: "
              f"{map_flips} flips, max float diff {map_dmax:.3g}",
              flush=True)

        # the CPU's next state, by the step itself from the same draws
        gen.set_state(g0)
        state, _ = odo.slam_step(state, raw, cfg)
    return rows


def agree_phase(dev, seed: int, n_frames: int = 6) -> dict:
    """A 70 m x 70 m world seen to 30 m at 0.6 m/frame, the scale of the
    parity tests' worlds, so the small budgets register every frame."""
    from mulls_tpu_torch.pipeline.odometry import OdometryPipeline
    cfg = small_cfg()
    rng = np.random.default_rng(seed + 2)
    world = make_world(rng, n=60_000, half_x=35.0, half_y=35.0)
    frames = [render_scan(world, T, cfg.shapes.n_raw, rng, sensor_range=30.0)
              for T in trajectory(n_frames, step=0.6)]
    runs = {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        runs[str(where)] = (OdometryPipeline(
            cfg, segment=n_frames, device=where,
            draws=HostDraws(seed, where)).run(frames),
            time.perf_counter() - t0)
    (card, card_s), (cpu, cpu_s) = runs[str(dev)], runs["cpu"]
    per_frame = [motion_diff(a, b) for a, b in zip(
        np.linalg.inv(card.poses[:-1]) @ card.poses[1:],
        np.linalg.inv(cpu.poses[:-1]) @ cpu.poses[1:])]
    dt = max(d[0] for d in per_frame)
    dr = max(d[1] for d in per_frame)
    print(f"[agree] small width ({cfg.shapes.n_raw} points), {n_frames} "
          f"frames: codes card {card.codes} cpu {cpu.codes}; per-frame "
          f"motion difference (m, deg) "
          + ", ".join(f"{a:.2e}/{b:.2e}" for a, b in per_frame)
          + f"; max {dt:.2e} m, {dr:.2e} deg (card {card_s:.1f} s with "
          f"warm-up, cpu {cpu_s:.1f} s)", flush=True)
    stages = isolate_stages(cfg, frames, dev, seed)
    return {"codes_card": card.codes, "codes_cpu": cpu.codes,
            "per_frame_m_deg": per_frame, "max_dt_m": dt, "max_dr_deg": dr,
            "stages": stages}


# --------------------------------------------------------------------------
# phase 7: where a frame's time goes
# --------------------------------------------------------------------------

def profile_phase(frames: list, cfg, dev, warm: int = 4, window: int = 4
                  ) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mulls_tpu_torch.core.cloud import pack_raw_host
    from mulls_tpu_torch.pipeline.odometry import (OdometryPipeline,
                                                   init_state, slam_step)
    n = warm + window
    # stage times: the pipeline syncs the card around each stage
    res = OdometryPipeline(cfg, device=dev).run(frames[:n], profile=True)
    stage = {name: float(np.mean(res.timings[warm:, col]))
             for name, col in (("feature", 0), ("reg", 2), ("map", 1))}
    print("[profile] stage ms per frame (mean of frames "
          f"{warm}..{n - 1}, a sync around each stage): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stage.items()), flush=True)

    # the same window of steady frames from the same state, first on the
    # host clock alone, then under the profiler for the device's busy time
    # (slam_step leaves its input state as it was)
    packed = [pack_raw_host(f, with_ts=False).to(dev) for f in frames[:n]]
    warm_state = init_state(cfg, dev)
    for raw in packed[:warm]:
        warm_state, _ = slam_step(warm_state, raw, cfg)
    torch.cuda.synchronize()

    def window_ms():
        state = warm_state
        t0 = time.perf_counter()
        for raw in packed[warm:]:
            state, _ = slam_step(state, raw, cfg)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    plain_ms = window_ms()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = window_ms()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name: dict = {}
    for e in kern:
        ms, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, k + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    # the PyTorch operators that launched device work most often
    ops = sorted(((e.key, e.count) for e in prof.key_averages()
                  if e.key.startswith("aten::")
                  and e.self_device_time_total > 0),
                 key=lambda kv: -kv[1])[:8]
    out = {"stage_ms": stage, "window_frames": window,
           "frame_ms": plain_ms / window,
           "profiled_frame_ms": wall_ms / window,
           "device_ms_per_frame": busy_ms / window if kern else None,
           "device_launches_per_frame": len(kern) / window,
           "top": [{"name": name[:100], "ms_per_frame": ms / window,
                    "calls_per_frame": k / window}
                   for name, (ms, k) in top],
           "top_ops": [{"name": name, "calls_per_frame": k / window}
                       for name, k in ops]}
    if not kern:
        print("[profile] device busy share not measured: the profiler "
              "recorded no device activity", flush=True)
        return out
    busy = busy_ms / plain_ms
    out["device_busy_share"] = busy
    print(f"[profile] frames {warm}..{n - 1}: {plain_ms / window:.2f} ms "
          f"per frame ({window * 1e3 / plain_ms:.2f} frames/s) on the host "
          f"clock; under torch.profiler {wall_ms / window:.2f} ms per frame, "
          f"device busy {busy_ms / window:.2f} ms per frame in "
          f"{len(kern) / window:.0f} device operations: busy "
          f"{100.0 * busy:.1f} %, idle {100.0 - 100.0 * busy:.1f} % of the "
          f"unprofiled frame time", flush=True)
    for t in out["top"]:
        print(f"[profile]   {t['ms_per_frame']:8.3f} ms/frame "
              f"{t['calls_per_frame']:7.1f} calls/frame  {t['name']}",
              flush=True)
    print("[profile] operators that launched device work most often, "
          "calls per frame: "
          + ", ".join(f"{t['name']} {t['calls_per_frame']:.0f}"
                      for t in out["top_ops"]), flush=True)
    return out


# --------------------------------------------------------------------------
# phase 8: SLAM with loop closure at full width (the back end's main path)
# --------------------------------------------------------------------------

# the SLAM drive: 1.3 m/frame around the loop in segments of 4 frames
# closes submaps of ~31 m, and the 9th submap (id 8, min_submap_id_diff
# away from the first) ends ~3 m from submap 0's end frame, well inside
# the 15 m candidate radius; 208 frames = 270 m, 1.2 laps
SLAM_FRAMES, SLAM_STEP, SLAM_SEGMENT = 208, 1.3, 4
# the odometry-only rate on the drive's first frames (the whole drive took
# ~185 s of a 1094 s run on a slow host)
SLAM_ODO_FRAMES = 64
LOOP_EDGE_BOUND_M = 0.5  # a loop edge against the truth (the bench: 1 m)


def slam_phase(dev, seed: int, main_fps: float) -> dict:
    """``SlamPipeline`` at full width with loop closure on: the default
    config (30 m submaps, min_submap_id_diff 8, the ceres PGO), 208 frames
    of the bench's urban loop, then the end-of-run refinement."""
    import dataclasses

    import torch
    from mulls_tpu_torch.config import MullsConfig
    from mulls_tpu_torch.ops import kernels
    from mulls_tpu_torch.pipeline.odometry import OdometryPipeline
    from mulls_tpu_torch.pipeline.slam import SlamPipeline
    from mulls_tpu_torch.tools import worlds

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 5)
    world = worlds.build_world(rng)
    gt = worlds.loop_trajectory(SLAM_FRAMES, step=SLAM_STEP)
    base = MullsConfig()
    n_raw = base.shapes.n_raw
    frames = [worlds.simulate(world, T, n_raw, rng) for T in gt]
    counts = [int(f["mask"].sum()) for f in frames]
    print(f"[slam] {SLAM_FRAMES} scans of the urban loop at {SLAM_STEP} "
          f"m/frame, valid points min {min(counts)} max {max(counts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    cfg = base.replace(submap=dataclasses.replace(
        base.submap, loop_closure_detection_on=True))
    # the first SLAM_ODO_FRAMES of the same frames through odometry alone,
    # for the rate without the back end
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    OdometryPipeline(base, device=dev).run(frames[:SLAM_ODO_FRAMES])
    torch.cuda.synchronize()
    odo_fps = SLAM_ODO_FRAMES / (time.perf_counter() - t0)
    pipe = SlamPipeline(cfg, segment=SLAM_SEGMENT, device=dev)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with LoopBoundarySnapshot(cfg) as snap:
        res = pipe.run(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    t0 = time.perf_counter()
    pipe.refine(res)
    refine_ms = (time.perf_counter() - t0) * 1e3

    be = res.backend
    alone = backend_alone_ms(be, cfg, dev)
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    dist = float(np.sum(np.linalg.norm(np.diff(gt_rel[:, :3, 3], axis=0),
                                       axis=1)))
    end_err = float(np.linalg.norm(res.poses[-1, :3, 3]
                                   - gt_rel[-1, :3, 3]))
    odo_err = float(np.linalg.norm(res.poses_odom[-1, :3, 3]
                                   - gt_rel[-1, :3, 3]))
    fe = {s.sid: s.frame_end for s in be.submaps}
    loops = []
    for e in be.edges:
        if e.kind != 2:
            continue
        T_gt = np.linalg.inv(gt_rel[fe[e.i]]) @ gt_rel[fe[e.j]]
        dt, dr = motion_diff(np.asarray(e.T), T_gt)
        loops.append({"i": e.i, "j": e.j, "t_err_m": dt, "r_err_deg": dr,
                      "sigma": e.sigma, "confidence": e.confidence})
    kinds = [e.kind for e in be.edges]
    tm = be.timings
    stat = {k: (float(np.mean(v)) if v else None, len(v))
            for k, v in tm.items()}
    bad = [(i, c) for i, c in enumerate(res.codes) if i > 0 and c != 1]
    print(f"[slam] {SLAM_FRAMES} frames with loop closure in {wall:.2f} s: "
          f"{SLAM_FRAMES / wall:.2f} frames/s (odometry only on the first "
          f"{SLAM_ODO_FRAMES} of the same frames: {odo_fps:.2f} frames/s; the "
          f"main phase: {main_fps:.2f}); "
          f"refine {refine_ms:.1f} ms", flush=True)
    print(f"[slam] {len(bad)} frames after the first without code 1: "
          f"{bad[:12]}", flush=True)
    print(f"[slam] {len(be.submaps)} submaps "
          f"{[(s.frame_begin, s.frame_end) for s in be.submaps]}; edges "
          f"{[(e.i, e.j, e.kind) for e in be.edges]}; PGO accepted "
          f"{be.pgo_accepted} times", flush=True)
    for lp in loops:
        print(f"[slam] loop edge {lp['i']}->{lp['j']}: {lp['t_err_m']:.4f} m, "
              f"{lp['r_err_deg']:.3f} deg from the ground truth (sigma "
              f"{lp['sigma']:.4f}, confidence {lp['confidence']:.3f})",
              flush=True)
    print(f"[slam] end error {end_err:.4f} m over {dist:.1f} m "
          f"({100.0 * end_err / dist:.3f} %; odometry alone "
          f"{odo_err:.4f} m)", flush=True)
    print("[slam] host-clock ms, fetches included, on the boundary thread "
          "(queued behind the front end on the shared stream): "
          + ", ".join(f"{k} {m:.1f} x {n}" if m is not None
                      else f"{k} none" for k, (m, n) in stat.items()),
          flush=True)
    print("[slam] the same work alone on the card after the run, host-clock "
          "ms (median of 3, results fetched): "
          + ", ".join(f"{k} {v:.1f}" for k, v in alone.items()), flush=True)
    print(f"[slam] launches on the whole run {launches}; the back end's own "
          f"{be.launches}", flush=True)
    for ev in be.events:
        print(f"[slam]   {ev}", flush=True)
    return {"frames": SLAM_FRAMES, "seconds": wall, "scans": frames,
            "poses": res.poses, "fps": SLAM_FRAMES / wall,
            "odometry_fps": odo_fps,
            "main_fps": main_fps,
            "codes": res.codes, "bad": bad, "submaps": len(be.submaps),
            "spans": [(s.frame_begin, s.frame_end) for s in be.submaps],
            "edges": [(e.i, e.j, e.kind) for e in be.edges],
            "adjacent": kinds.count(1), "loops": loops,
            "pgo_accepted": be.pgo_accepted, "end_err_m": end_err,
            "odometry_end_err_m": odo_err, "dist_m": dist,
            "refine_ms": refine_ms, "timings_ms": tm, "alone_ms": alone,
            "launches": launches,
            "backend_launches": dict(be.launches), "events": be.events,
            "backend": be, "cfg": cfg, "loop_boundary": snap.kept}


class LoopBoundarySnapshot:
    """While entered, keeps the back end's host state and the boundary's
    draws (``backend_to_numpy``, the generator's state) from just before
    the first ``SlamBackend.on_new_submap`` call that adds a loop edge.
    Only calls that can have a loop candidate (the new submap's id at
    least ``min_submap_id_diff``) are copied."""

    def __init__(self, cfg):
        self.cfg, self.kept = cfg, None

    def __enter__(self):
        from mulls_tpu_torch.backend.convert import backend_to_numpy
        from mulls_tpu_torch.backend.submap import SlamBackend
        self.cls = SlamBackend
        real = self.fn = SlamBackend.on_new_submap
        diff = self.cfg.submap.min_submap_id_diff

        def wrapped(be, draws, frames_wo_opt=None):
            if self.kept is not None or be.submaps[-1].sid < diff:
                return real(be, draws, frames_wo_opt)
            tree = backend_to_numpy(be)
            state = draws.get_state()
            loops = sum(e.kind == 2 for e in be.edges)
            out = real(be, draws, frames_wo_opt)
            if sum(e.kind == 2 for e in be.edges) > loops:
                self.kept = {"tree": tree, "draws": state,
                             "frames_wo_opt": frames_wo_opt,
                             "sid": be.submaps[-1].sid}
            return out

        self.cls.on_new_submap = wrapped
        return self

    def __exit__(self, *exc):
        self.cls.on_new_submap = self.fn


def slam_bits_check(slam: dict, dev) -> dict:
    """The slam phase's loop boundary run twice on the card from the same
    state: ``SlamBackend.on_new_submap`` on two back ends rebuilt from the
    kept host state (``backend_from_numpy``: the bank re-uploaded, as a
    resumed run has it) with the same draws.  The edges (i, j, kind, T,
    confidence), the PGO's returned poses and every submap's pose must be
    equal bit for bit; ms per run."""
    import torch
    from mulls_tpu_torch.backend.convert import backend_from_numpy
    from mulls_tpu_torch.core.draws import GeneratorDraws

    kept, cfg = slam["loop_boundary"], slam["cfg"]
    if kept is None:
        raise AssertionError("no boundary of the SLAM run added a loop edge")
    runs = []
    for _ in range(2):
        be = backend_from_numpy(kept["tree"], cfg, dev)
        draws = GeneratorDraws(0, dev)
        draws.set_state(kept["draws"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses = be.on_new_submap(draws, kept["frames_wo_opt"])
        torch.cuda.synchronize()
        runs.append({"ms": (time.perf_counter() - t0) * 1e3, "poses": poses,
                     "edges": [(e.i, e.j, e.kind, np.asarray(e.T),
                                e.confidence) for e in be.edges],
                     "submap_poses": [np.asarray(s.pose) for s in be.submaps]})
    a, b = runs
    same_edges = len(a["edges"]) == len(b["edges"]) and all(
        x[:3] == y[:3] and np.array_equal(x[3], y[3]) and x[4] == y[4]
        for x, y in zip(a["edges"], b["edges"]))
    same_pgo = ((a["poses"] is None) == (b["poses"] is None)
                and (a["poses"] is None
                     or np.array_equal(a["poses"], b["poses"])))
    same_nodes = all(np.array_equal(x, y) for x, y in
                     zip(a["submap_poses"], b["submap_poses"]))
    loops = [x[:2] for x in a["edges"] if x[2] == 2]
    print(f"[slam] the loop boundary of submap {kept['sid']} run twice from "
          f"the same state ({len(kept['tree']['submaps'])} submaps, "
          f"{len(kept['tree']['edges'])} edges before it): edges "
          f"{'equal' if same_edges else 'DIFFER'}, PGO "
          f"{'accepted' if a['poses'] is not None else 'not accepted'} and "
          f"its nodes {'equal' if same_pgo and same_nodes else 'DIFFER'} "
          f"bit for bit; loop edges {loops}; {a['ms']:.1f} and "
          f"{b['ms']:.1f} ms", flush=True)
    if not (same_edges and same_pgo and same_nodes):
        raise AssertionError("the loop boundary run twice from the same "
                             "state gave different edges or PGO nodes")
    return {"sid": kept["sid"], "ms": [a["ms"], b["ms"]],
            "edges": len(a["edges"]), "loop_edges": loops,
            "pgo_accepted": a["poses"] is not None}


def backend_alone_ms(be, cfg, dev) -> dict:
    """Host-clock ms (median of 3, the result fetched) of the back end's
    three steps on the SLAM run's own bank and graph, with the card to
    themselves: the adjacent m2m registration of the last two banked
    submaps, one loop candidate's ladder (NCC, GNC, the fine m2m) for the
    first loop edge's pair, and the dense PGO solve of the final graph."""
    import torch
    from mulls_tpu_torch.backend import bank as bk
    from mulls_tpu_torch.backend.pgo import optimize_and_check
    from mulls_tpu_torch.core.draws import GeneratorDraws

    def ms(fn):
        out = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    s = cfg.submap
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    banked = [sm for sm in be.submaps if sm.slot >= 0]
    a, b = banked[-2], banked[-1]
    res = {"m2m": ms(lambda: bk.pair_m2m(
        be.bank, a.slot, b.slot, f32(np.linalg.inv(a.pose) @ b.pose), cfg,
        cfg.reg.reg_max_iter_num_m2m).cpu())}
    loop = next((e for e in be.edges if e.kind == 2), None)
    if loop is not None:
        old, new = be.submaps[loop.i], be.submaps[loop.j]
        res["candidate"] = ms(lambda: bk.loop_eval_batch(
            be.bank, [old.slot], new.slot,
            f32(np.linalg.inv(old.pose) @ new.pose)[None], [True],
            f32([[3.0, 3.0]]), GeneratorDraws(0, dev), cfg).cpu())
    graph, _ = be.build_graph()
    res["pgo"] = ms(lambda: optimize_and_check(
        graph, iterations=s.pgo_max_iter, robust_kernel=s.robust_kernel_on,
        tran_thre=s.wrong_edge_tran_thre,
        rot_thre_deg=s.wrong_edge_rot_thre_deg).cpu())
    return res


class NnTap:
    """Records the problems of ``nearest_neighbor_grouped`` as the ICP
    calls it, while entered."""

    def __enter__(self):
        from mulls_tpu_torch.frontend import icp
        self.icp, self.fn, self.calls = icp, icp.nearest_neighbor_grouped, []
        icp.nearest_neighbor_grouped = self
        return self

    def __exit__(self, *exc):
        self.icp.nearest_neighbor_grouped = self.fn

    def __call__(self, problems):
        self.calls.append([tuple(t.contiguous() for t in pr)
                           for pr in problems])
        return self.fn(problems)


def m2m_nn_check(slam: dict, dev) -> dict:
    """``nn_grouped`` at the map-to-map shapes: the first ICP iteration of
    ``bank.pair_m2m`` between two real adjacent submaps of the SLAM run
    (strided sources against full targets, the five ICP classes in one
    launch), bit-equal to the plain version and twice the same bits,
    timed, against ``cdist`` + ``min`` per class and the bound."""
    import torch
    from mulls_tpu_torch.backend import bank as bk
    from mulls_tpu_torch.ops import kernels
    from mulls_tpu_torch.tools.roofline import bound_ms, device_ms, time_ms

    be, cfg = slam["backend"], slam["cfg"]
    banked = [s for s in be.submaps if s.slot >= 0]
    a, b = banked[-3], banked[-2]
    T = torch.as_tensor((np.linalg.inv(a.pose) @ b.pose).astype(np.float32),
                        device=dev)
    with NnTap() as tap:
        bk.pair_m2m(be.bank, a.slot, b.slot, T, cfg, 1)
    group = tap.calls[0]
    got, want = kernels.nn_grouped(group), kernels.nn_grouped_plain(group)
    for k, ((ik, dk), (ip, dp)) in enumerate(zip(got, want)):
        if not (torch.equal(ik, ip) and torch.equal(dk, dp)):
            raise AssertionError(f"nn_grouped at the m2m shapes, problem {k}:"
                                 f" differs from the plain version")
    if not same_bits(lambda: kernels.nn_grouped(group)):
        raise AssertionError("nn_grouped at the m2m shapes: two launches "
                             "differ")
    shapes = [(pr[0].shape[0], pr[2].shape[0]) for pr in group]
    pairs = sum(q * p for q, p in shapes)
    ms, ops = device_ms(lambda: kernels.nn_grouped(group), 50)
    ev = time_ms(lambda: kernels.nn_grouped(group), 50)
    plain = time_ms(lambda: kernels.nn_grouped_plain(group), 5)
    lib_ms = time_ms(lambda: cdist_min(group), 5)
    nbytes = sum(q * 13 + p * 13 + q * 8 for q, p in shapes)
    bnd, by = bound_ms(9.0 * pairs, nbytes)
    shape = " + ".join(f"{q}x{p}" for q, p in shapes)
    print(f"[kernels] nn_grouped at the m2m shapes of submaps {a.sid}->"
          f"{b.sid} ({shape}, {pairs:.3g} pairs): equal to the plain version"
          f" bit for bit, same bits twice; one grouped launch {ms:.4f} ms on "
          f"the device ({n_ops(ops)} launch per call; {ev:.4f} ms per call "
          f"with CUDA events), plain {plain:.4f} ms, cdist+min "
          f"{lib_ms:.4f} ms, bound {bnd:.5f} ms ({by}); "
          f"{cfg.reg.reg_max_iter_num_m2m} such "
          f"launches per registration", flush=True)
    return {"shape": shape, "pairs": pairs, "ms": ms, "event_ms": ev,
            "plain_ms": plain, "library_ms": lib_ms, "bound_ms": bnd,
            "bound_by": by, "max_abs_err": 0.0}


# --------------------------------------------------------------------------
# phase 9: SLAM on the card against SLAM on the CPU at a small width
# --------------------------------------------------------------------------

def _loop_world(rng: np.random.Generator, n: int = 120000,
                extent: float = 45.0) -> np.ndarray:
    """tests/test_pipeline.py's loop world: ground + walls on a square
    corridor + posts."""
    n_g = n // 2
    g = np.stack([rng.uniform(-extent, extent, n_g),
                  rng.uniform(-extent, extent, n_g),
                  0.03 * rng.normal(size=n_g) - 1.7], -1)
    n_w = n // 4
    side = rng.integers(0, 4, n_w)
    u = rng.uniform(-extent, extent, n_w)
    d = np.full(n_w, extent * 0.7) + 0.05 * rng.normal(size=n_w)
    wx = np.where(side == 0, d, np.where(side == 1, -d, u))
    wy = np.where(side < 2, u, np.where(side == 2, d, -d))
    w = np.stack([wx, wy, rng.uniform(-1.5, 3.0, n_w)], -1)
    n_p = n - n_g - n_w
    per = 60
    cx = rng.uniform(-extent, extent, n_p // per + 1)
    cy = rng.uniform(-extent, extent, n_p // per + 1)
    reps = np.repeat(np.arange(len(cx)), per)[:n_p]
    p = np.stack([cx[reps] + 0.02 * rng.normal(size=n_p),
                  cy[reps] + 0.02 * rng.normal(size=n_p),
                  rng.uniform(-1.5, 2.0, n_p)], -1)
    return np.concatenate([g, w, p]).astype(np.float32)


def agree_slam_phase(dev, seed: int, n_frames: int = 26) -> dict:
    """tests/test_pipeline.py's loop-closure world and config (26 frames on
    a circle of 8 m with a speed ramp, 4-frame submaps, loop search 3 ids
    back) through ``SlamPipeline`` on the card and on the CPU with the same
    scans and the same front-end and back-end draws."""
    import dataclasses

    from mulls_tpu_torch.pipeline.slam import SlamPipeline
    base = small_cfg()
    cfg = base.replace(
        submap=dataclasses.replace(
            base.submap, loop_closure_detection_on=True,
            submap_accu_tran=8.0, submap_accu_rot=1e9, submap_accu_frame=4,
            min_submap_id_diff=3, neighbor_search_dist=30.0,
            min_iou_thre=0.2, teaser_min_inlier_count=6,
            map2map_reliable_sigma_thre=0.04,
            max_used_reg_edge_per_optimization=2),
        reg=dataclasses.replace(base.reg, corr_dis_thre_init=3.5,
                                corr_dis_thre_min=0.6))
    rng = np.random.default_rng(seed + 6)
    world = _loop_world(rng)
    gt = []
    for k in range(n_frames):
        ang = 2 * np.pi * (k / (n_frames - 1)) ** 1.5
        T = np.eye(4)
        c, s = math.cos(ang + math.pi / 2), math.sin(ang + math.pi / 2)
        T[:2, :2] = [[c, -s], [s, c]]
        T[:3, 3] = [8.0 * math.cos(ang) - 8.0, 8.0 * math.sin(ang), 0.0]
        gt.append(T)
    frames = [render_scan(world, T, cfg.shapes.n_raw, rng, sensor_range=35.0)
              for T in gt]
    runs = {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        runs[str(where)] = (SlamPipeline(
            cfg, segment=2, device=where, draws=HostDraws(seed + 1, where),
            frontend_draws=HostDraws(seed, where)).run(frames),
            time.perf_counter() - t0)
    (card, card_s), (cpu, cpu_s) = runs[str(dev)], runs["cpu"]
    spans = [[(s.frame_begin, s.frame_end) for s in r.backend.submaps]
             for r in (card, cpu)]
    edges = [[(e.i, e.j, e.kind) for e in r.backend.edges]
             for r in (card, cpu)]
    rel = [motion_diff(a, b) for a, b in zip(
        np.linalg.inv(card.poses[:-1]) @ card.poses[1:],
        np.linalg.inv(cpu.poses[:-1]) @ cpu.poses[1:])]
    pose = [motion_diff(a, b) for a, b in zip(card.poses, cpu.poses)]
    out = {"spans_card": spans[0], "spans_cpu": spans[1],
           "edges_card": edges[0], "edges_cpu": edges[1],
           "codes_card": card.codes, "codes_cpu": cpu.codes,
           "rel_dt_m": max(d[0] for d in rel),
           "rel_dr_deg": max(d[1] for d in rel),
           "pose_dt_m": max(d[0] for d in pose),
           "pose_dr_deg": max(d[1] for d in pose),
           "per_frame_rel_m": [d[0] for d in rel],
           "per_frame_pose_m": [d[0] for d in pose]}
    print(f"[agree-slam] small width, {n_frames} frames: card spans "
          f"{spans[0]}, edges {edges[0]}; cpu spans {spans[1]}, edges "
          f"{edges[1]}; per-frame motion difference max {out['rel_dt_m']:.2e}"
          f" m, {out['rel_dr_deg']:.2e} deg; pose difference max "
          f"{out['pose_dt_m']:.2e} m, {out['pose_dr_deg']:.2e} deg (card "
          f"{card_s:.1f} s with warm-up, cpu {cpu_s:.1f} s)", flush=True)
    return out


# --------------------------------------------------------------------------
# phase 10: the map assembled from the SLAM run, filtered on the card
# --------------------------------------------------------------------------

ASSEMBLY_CHUNK = 200_000  # the first chunk's queries: checked, timed


def assembly_phase(frames: list, poses: np.ndarray, dev, out_dir: str
                   ) -> dict:
    """``accumulate_map`` of the SLAM run's frames at its final poses (0.25 m
    voxels), then ``radius_outlier_filter`` on the card: one count_within
    call, the whole map against itself.  That call gives the same bits
    twice, and on its first 200,000 queries the plain version's counts on
    the card (in 128-query slices) exactly; the filter keeps what the plain
    counts keep there.  The kernel is timed at the filter's shape and on
    that first chunk alone, the shape of the filter's launches when it
    counted in chunks.
    Writes the pcd, the BEV image and the HTML viewer."""
    import torch
    from mulls_tpu_torch.mapping import assembly as asm
    from mulls_tpu_torch.ops import kernels
    from mulls_tpu_torch.tools.roofline import (bound_ms, call_device_ms,
                                                device_ms, time_ms)
    from mulls_tpu_torch.viz import export_html_viewer

    t0 = time.perf_counter()
    pts = asm.accumulate_map(frames, poses, voxel_res=0.25)
    acc_s = time.perf_counter() - t0
    pn = len(pts)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    kept = asm.radius_outlier_filter(pts, device=dev)
    stop.record()
    torch.cuda.synchronize()
    filter_ms = start.elapsed_time(stop)
    launches = kernels.launch_counts()["count_within"]

    p = torch.as_tensor(pts, device=dev)
    pm = torch.ones(pn, dtype=torch.bool, device=dev)
    r2_map = torch.ones(pn, dtype=torch.float32, device=dev)
    whole = kernels.count_within(p, p, pm, r2_map)  # the filter's call
    if not same_bits(lambda: kernels.count_within(p, p, pm, r2_map)):
        raise AssertionError("count_within at the filter's shape: two "
                             "launches differ")
    q = p[:ASSEMBLY_CHUNK]
    qn = q.shape[0]
    r2 = r2_map[:qn]
    ck = kernels.count_within(q, p, pm, r2)
    if not same_bits(lambda: kernels.count_within(q, p, pm, r2)):
        raise AssertionError("count_within at the assembly chunk: two "
                             "launches differ")
    start.record()
    cp = torch.cat([kernels.count_within_plain(q[s:s + 128], p, pm,
                                               r2[s:s + 128])
                    for s in range(0, qn, 128)])
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    for tag, got in (("the filter's call", whole[:qn]),
                     ("the chunk's call", ck)):
        if not torch.equal(got, cp):
            raise AssertionError(f"count_within, {tag}: "
                                 f"{int((got != cp).sum())} counts of the "
                                 f"first chunk differ from the plain ones")
    keep_plain = pts[:qn][(cp >= 4).cpu().numpy()]
    if not np.array_equal(kept[:len(keep_plain)], keep_plain):
        raise AssertionError("the filter keeps other points than the plain "
                             "counts keep on the first chunk")

    def timed(qq, rr) -> dict:
        """The kernel's device ms (None where every trace lost its events;
        this phase runs after the SLAM runs, after which traces have lost
        events), the whole call's device ms (the index too), its CUDA-event
        ms, and the index's alone with CUDA events."""
        def fn():
            return kernels.count_within(qq, p, pm, rr)

        try:
            kern = device_ms(fn, 10, "count_within_kernel")[0]
        except AssertionError as e:  # every event lost: not measured
            print(f"[assembly] count_within device time not measured: {e}",
                  flush=True)
            kern = None
        return {"ms": kern,
                "call_device_ms": call_device_ms(fn, 10,
                                                 "count_within_kernel"),
                "event_ms": time_ms(fn, 5),
                "index_ms": time_ms(lambda: kernels.query_cells(
                    qq, kernels.cell_index(p, pm, rr)), 5)}

    def ms_txt(x):
        return "not measured" if x is None else f"{x:.4f} ms"

    # the function's bound: the bytes, and 10 operations a hit; the walk's
    # candidate pairs beside it, and the brute-force form's 10 a pair
    chunk, full = timed(q, r2), timed(p, r2_map)
    hits, hits_map = float(cp.sum()), float(whole.sum())
    cand = kernels.candidate_pairs(q, p, pm, r2)
    nbytes = 16 * qn + 13 * pn + 4 * qn
    b, by = bound_ms(10.0 * hits, nbytes)
    b_map, by_map = bound_ms(10.0 * hits_map, 16 * pn + 13 * pn + 4 * pn)
    brute_b, _ = bound_ms(10.0 * qn * pn, nbytes)
    library_ms = time_ms(lambda: cdist_count(q, p, pm, r2, 2048), 1,
                         warmup=1)
    files = {"pcd": os.path.join(out_dir, "map.pcd"),
             "bev": os.path.join(out_dir, "map_bev.png"),
             "html": os.path.join(out_dir, "map.html")}
    asm.write_map_outputs(kept, files["pcd"], files["bev"])
    if not os.path.exists(files["bev"]):  # no matplotlib: the raster
        files["bev"] = os.path.splitext(files["bev"])[0] + ".npy"
    export_html_viewer(files["html"], kept, trajectory=poses[:, :3, 3])
    sizes = {k: os.path.getsize(v) if os.path.exists(v) else 0
             for k, v in files.items()}
    if not all(sizes.values()):
        raise AssertionError(f"map outputs missing or empty: {sizes}")
    print(f"[assembly] map of {len(frames)} frames at 0.25 m: {pn} points "
          f"({acc_s:.1f} s on the host), {len(kept)} kept by the filter in "
          f"{filter_ms:.1f} ms with CUDA events (upload, {launches} "
          f"count_within call: the index and the launch, copy back)",
          flush=True)
    print(f"[assembly] count_within {pn}x{pn} (the filter's call, "
          f"{hits_map / pn:.1f} hits a query): same bits twice, its first "
          f"{qn} counts equal the plain ones; kernel "
          f"{ms_txt(full['ms'])} on the device, the call "
          f"{ms_txt(full['call_device_ms'])} on the device and "
          f"{full['event_ms']:.4f} ms with CUDA events (the index "
          f"{full['index_ms']:.4f} ms of it), bound {b_map:.5f} ms "
          f"({by_map})", flush=True)
    print(f"[assembly] count_within {qn}x{pn} (the first chunk, r = 1.0, "
          f"{hits / qn:.1f} hits and {cand / qn:.1f} candidates a query): "
          f"exact against the plain version on the card, same bits twice, "
          f"the filter keeps what the plain counts keep; kernel "
          f"{ms_txt(chunk['ms'])} on the device, the call "
          f"{ms_txt(chunk['call_device_ms'])} on the device and "
          f"{chunk['event_ms']:.4f} ms with CUDA events (the index "
          f"{chunk['index_ms']:.4f} ms of it), plain {plain_ms:.1f} ms "
          f"(128-query slices), library {library_ms:.1f} ms (cdist + "
          f"compare + sum, 2048-query slices), bound {b:.5f} ms ({by}: "
          f"10 operations a hit; {cand} candidate pairs in the walk; the "
          f"brute-force bound {brute_b:.3f} ms); files {sizes}", flush=True)
    return {"points": pn, "kept": len(kept), "accumulate_s": acc_s,
            "filter_ms": filter_ms, "launches": launches,
            "shape": f"{qn}x{pn}", **chunk,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b, "bound_by": by, "candidate_pairs": cand,
            "brute_force_bound_ms": brute_b,
            "hits_per_query": hits / qn, "files": sizes,
            "filter_call": {"shape": f"{pn}x{pn}", **full,
                            "bound_ms": b_map, "bound_by": by_map,
                            "hits_per_query": hits_map / pn}}


# --------------------------------------------------------------------------
# phase 11: the NDT / VGICP baselines
# --------------------------------------------------------------------------

def baseline_small_cfg():
    """The agree phase's width with the baselines at the budgets of the
    CPU parity test (tests/test_torch_baseline.py)."""
    import dataclasses
    cfg = small_cfg()
    return cfg.replace(baseline=dataclasses.replace(
        cfg.baseline, frame_budget=4096, map_budget=8192,
        table_resolution=1.8, voxel_down_size=0.5, max_iter=20))


def baseline_phase(frames: list, gt: np.ndarray, dev, seed: int) -> dict:
    """``BaselinePipeline`` with ``ndt`` and ``gicp`` at the default
    ``BaselineConfig`` over the main phase's street frames: codes 1 or -1,
    finite fitness, frames/s and end error (recorded, not bounded: the
    baselines drift on synthetic worlds by design); ``pca_moments`` at the
    GICP covariances' own first call (16384 x 16384, r = 1.0) against its
    plain version; then both methods on the card against the CPU at a small
    width with the same draws (2 cm / 0.2 deg)."""
    import dataclasses

    import torch
    from mulls_tpu_torch.config import MullsConfig
    from mulls_tpu_torch.ops import baseline_reg, kernels
    from mulls_tpu_torch.pipeline.baseline import BaselinePipeline

    base = MullsConfig()
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    out = {}
    for method in ("ndt", "gicp"):
        cfg = base.replace(baseline=dataclasses.replace(base.baseline,
                                                        method=method))
        pipe = BaselinePipeline(cfg, device=dev)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with KernelTap(baseline_reg) as tap:
            res = pipe.run(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        end_err = float(np.linalg.norm(res.poses[-1, :3, 3]
                                       - gt_rel[-1, :3, 3]))
        out[method] = {"fps": len(frames) / wall, "codes": res.codes,
                       "end_err_m": end_err, "launches": launches,
                       "fitness": res.sigmas}
        print(f"[baseline] {method}: {len(frames)} full-width frames in "
              f"{wall:.2f} s, {len(frames) / wall:.2f} frames/s (warm-up "
              f"included); codes {res.codes}; end error {end_err:.3f} m; "
              f"launches {launches}", flush=True)
        if not set(res.codes) <= {1, -1}:
            raise AssertionError(f"{method}: codes {set(res.codes)}")
        if not np.all(np.isfinite(res.sigmas)):
            raise AssertionError(f"{method}: non-finite fitness")
        if method == "gicp":
            if launches["pca_moments"] <= 0:
                raise AssertionError("gicp launched no pca_moments")
            q, p, pm, r2 = tap.calls[0]
            out["gicp_pca"] = pca_check(
                f"{q.shape[0]}x{p.shape[0]} GICP", q, p, pm, r2)
            out["gicp_pca"]["launches"] = launches["pca_moments"]

    # the card against the CPU at a small width, the same draws
    cfg0 = baseline_small_cfg()
    rng = np.random.default_rng(seed + 7)
    world = make_world(rng, n=60_000, half_x=35.0, half_y=35.0)
    small = [render_scan(world, T, cfg0.shapes.n_raw, rng, sensor_range=30.0)
             for T in trajectory(6, step=0.6)]
    for method in ("ndt", "gicp"):
        cfg = cfg0.replace(baseline=dataclasses.replace(cfg0.baseline,
                                                        method=method))
        card, cpu = (BaselinePipeline(cfg, device=where,
                                      draws=HostDraws(seed, where)).run(small)
                     for where in (dev, "cpu"))
        diff = [motion_diff(a, b) for a, b in zip(
            np.linalg.inv(card.poses[:-1]) @ card.poses[1:],
            np.linalg.inv(cpu.poses[:-1]) @ cpu.poses[1:])]
        dt, dr = max(d[0] for d in diff), max(d[1] for d in diff)
        out[f"agree_{method}"] = {"codes_card": card.codes,
                                  "codes_cpu": cpu.codes, "max_dt_m": dt,
                                  "max_dr_deg": dr}
        print(f"[baseline] {method} at small width, 6 frames: codes card "
              f"{card.codes} cpu {cpu.codes}; per-frame motion difference "
              f"max {dt:.2e} m, {dr:.2e} deg", flush=True)
        if card.codes != cpu.codes or not (dt < 0.02 and dr < 0.2):
            raise AssertionError(f"{method}: card and CPU differ at small "
                                 f"width ({dt} m, {dr} deg)")
    return out


# --------------------------------------------------------------------------
# phase 12: the SLAM CLI itself on the card
# --------------------------------------------------------------------------

def cli_phase(frames: list, out_dir: str) -> dict:
    """``python -m mulls_tpu_torch.apps.slam`` (its ``main``) over 8 street
    frames written as KITTI .bin: SLAM with the map outputs and a profiler
    trace, then the GICP baseline.  Checks exit 0, the files, and CUDA
    kernel events in the trace."""
    from mulls_tpu_torch.apps import slam as cli
    scans = os.path.join(out_dir, "velodyne")
    os.makedirs(scans, exist_ok=True)
    for k, f in enumerate(frames[:8]):
        m = f["mask"]
        np.concatenate([f["xyz"][m], f["intensity"][m, None] / 255.0],
                       1).astype(np.float32).tofile(
                           os.path.join(scans, f"{k:06d}.bin"))
    o = lambda name: os.path.join(out_dir, name)
    res = {}
    t0 = time.perf_counter()
    rc = cli.main(["--point_cloud_folder", scans,
                   "--loop_closure_detection_on", "1",
                   "--output_lo_lidar_pose_file_path", o("slam_poses.txt"),
                   "--output_map_pcd", o("cli_map.pcd"),
                   "--output_map_bev", o("cli_map.png"),
                   "--output_map_html", o("cli_map.html"),
                   "--profile_dir", o("profile")])
    res["slam_s"] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"the SLAM CLI exited {rc}")
    bev = o("cli_map.png") if os.path.exists(o("cli_map.png")) \
        else o("cli_map.npy")
    files = [o("slam_poses.txt"), o("cli_map.pcd"), bev, o("cli_map.html"),
             o("profile/trace.json")]
    sizes = {os.path.basename(f): (os.path.getsize(f)
                                   if os.path.exists(f) else 0)
             for f in files}
    if not all(sizes.values()):
        raise AssertionError(f"CLI outputs missing or empty: {sizes}")
    kernel_events = 0
    with open(o("profile/trace.json")) as f:
        for line in f:
            kernel_events += '"cat": "kernel"' in line
    if kernel_events <= 0:
        raise AssertionError("the profiler trace holds no CUDA kernel event")
    t0 = time.perf_counter()
    rc = cli.main(["--point_cloud_folder", scans,
                   "--baseline_reg_method", "gicp",
                   "--output_lo_lidar_pose_file_path", o("gicp_poses.txt")])
    res["gicp_s"] = time.perf_counter() - t0
    if rc != 0 or not os.path.getsize(o("gicp_poses.txt")):
        raise AssertionError(f"the GICP CLI run exited {rc} or wrote no "
                             f"poses")
    res.update({"files": sizes, "kernel_events": kernel_events})
    print(f"[cli] slam --loop_closure_detection_on 1 with the map outputs "
          f"and --profile_dir: exit 0 in {res['slam_s']:.1f} s, files "
          f"{sizes}, {kernel_events} CUDA kernel events in the trace; "
          f"--baseline_reg_method gicp: exit 0 in {res['gicp_s']:.1f} s",
          flush=True)
    return res


# --------------------------------------------------------------------------
# phase 13: the pairwise-registration CLI, every coarse mode
# --------------------------------------------------------------------------

REG_YAW_DEG = 37.0  # the source's extra heading, off the sweep's 15-deg grid
REG_BOUND = (0.3, 1.0)  # m, deg: the default mode and yaw4dof to the truth
REG_SWEEP_GATE_M = 6.0  # yaw4dof's --corr_dis_thre (the default is 1.5)


def rot_z(deg: float) -> np.ndarray:
    T = np.eye(4)
    a = math.radians(deg)
    T[:2, :2] = [[math.cos(a), -math.sin(a)], [math.sin(a), math.cos(a)]]
    return T


def reg_phase(frames: list, gt: np.ndarray, dev, out_dir: str) -> dict:
    """``mulls_tpu_torch.apps.reg.main`` at full width for every coarse
    mode: the target is the main phase's frame 0 (written as KITTI .bin),
    the source its frame 6 turned about its origin by 37 deg of yaw
    (written as .pcd).  Every mode exits 0 with a finite transform; the
    default (GNC with the BEV fallback) lands within 0.3 m / 1 deg of the
    truth, the others' errors are recorded.  Then yaw4dof on frames 20
    and 25 of the urban loop world, the source turned the same way,
    within 0.3 m / 1 deg (both sweeps with the first gate widened to
    6 m: the sweep starts every heading from zero translation).  Then ``nn`` at
    the SAC-IA scoring call's own inputs and ``nn_grouped`` at one
    iteration of a heading seed of the sweep, each against its plain
    version (bit for bit, the same bits twice), timed."""
    import torch
    from mulls_tpu_torch.apps import reg as cli
    from mulls_tpu_torch.backend import fpfh
    from mulls_tpu_torch.io.dataset import write_point_cloud
    from mulls_tpu_torch.ops import kernels
    from mulls_tpu_torch.tools import worlds
    from mulls_tpu_torch.tools.roofline import bound_ms, device_ms, time_ms

    tgt, src = frames[0], frames[6]
    m_t, m_s = tgt["mask"], src["mask"]
    o = lambda name: os.path.join(out_dir, name)
    # KITTI .bin keeps intensity / 255, the pcd as it is
    write_point_cloud(o("reg_target.bin"), tgt["xyz"][m_t],
                      tgt["intensity"][m_t])
    turned = src["xyz"][m_s] @ rot_z(REG_YAW_DEG)[:3, :3].T
    write_point_cloud(o("reg_source.pcd"), turned, src["intensity"][m_s])
    T_true = np.linalg.inv(gt[0]) @ gt[6] @ rot_z(-REG_YAW_DEG)
    # the sweep again on the urban loop world of the slam phase (the
    # bench's world, whose facades differ side to side): its frames 20 and
    # 25, 6.5 m apart on a straight, the source turned the same way
    rng = np.random.default_rng(SEED + 5)
    urban = worlds.build_world(rng)
    poses = worlds.loop_trajectory(26, step=SLAM_STEP)
    u_t, u_s = (worlds.simulate(urban, poses[k], len(tgt["mask"]), rng)
                for k in (20, 25))
    write_point_cloud(o("reg_urban_target.bin"), u_t["xyz"][u_t["mask"]],
                      u_t["intensity"][u_t["mask"]])
    write_point_cloud(o("reg_urban_source.pcd"),
                      u_s["xyz"][u_s["mask"]] @ rot_z(REG_YAW_DEG)[:3, :3].T,
                      u_s["intensity"][u_s["mask"]])
    T_urban = np.linalg.inv(poses[20]) @ poses[25] @ rot_z(-REG_YAW_DEG)
    modes = {}
    sac_tap, sweep_tap = None, None
    for mode in ("default", "ransac", "fpfh", "bev", "yaw4dof", "none",
                 "yaw4dof_urban"):
        pair = "reg_urban_" if mode == "yaw4dof_urban" else "reg_"
        argv = ["--point_cloud_1_path", o(f"{pair}target.bin"),
                "--point_cloud_2_path", o(f"{pair}source.pcd"),
                "--output_point_cloud_path", o(f"reg_{mode}.pcd"),
                "--json_out", o(f"reg_{mode}.json")]
        if mode != "default":
            argv += ["--coarse_reg", mode.split("_")[0]]
        if mode.startswith("yaw4dof"):
            # the sweep seeds the heading only, from zero translation; the
            # source's origin is 6 m from the target's, beyond the default
            # gate (1.5 m, candidates within 3.75 m), which finds too few
            # correspondences at every seed
            argv += [f"--corr_dis_thre={REG_SWEEP_GATE_M}"]
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "fpfh":
            with KernelTap(fpfh, "nn") as sac_tap:
                rc = cli.main(argv)
        elif mode == "yaw4dof":
            with NnTap() as sweep_tap:
                rc = cli.main(argv)
        else:
            rc = cli.main(argv)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = kernels.launch_counts()
        if rc != 0:
            raise AssertionError(f"reg --coarse_reg {mode} exited {rc}")
        with open(o(f"reg_{mode}.json")) as f:
            rec = json.load(f)
        T = np.asarray(rec["transform"])
        if not (np.all(np.isfinite(T))
                and os.path.getsize(o(f"reg_{mode}.pcd")) > 0):
            raise AssertionError(f"reg {mode}: a non-finite transform or no "
                                 f"output cloud")
        dt, dr = motion_diff(T, T_urban if mode == "yaw4dof_urban"
                             else T_true)
        modes[mode] = {"ms": ms, "t_err_m": dt, "r_err_deg": dr,
                       "launches": launches,
                       **{k: v for k, v in rec.items() if k != "transform"}}
        print(f"[reg] {mode}: exit 0 in {ms:.1f} ms (reading, both clouds' "
              f"features, the coarse step, ICP, writing), {dt:.4f} m / "
              f"{dr:.3f} deg from the truth; {rec}; launches {launches}",
              flush=True)
        if mode in ("default", "yaw4dof_urban") and not (
                dt <= REG_BOUND[0] and dr <= REG_BOUND[1]):
            raise AssertionError(f"reg {mode}: {dt} m / {dr} deg from the "
                                 f"truth, above {REG_BOUND}")
        for name in ("nn_grouped", "moments", "pca_moments"):
            if launches[name] <= 0:
                raise AssertionError(f"reg {mode}: {name} not launched")
        if mode == "fpfh" and launches["nn"] <= launches["nn_grouped"]:
            raise AssertionError("reg fpfh: no nn launch of its own")

    # nn at the SAC-IA scoring call's own inputs (its first nn call)
    q, qm, p, pm = sac_tap.calls[0]
    got, want = kernels.nn(q, qm, p, pm), kernels.nn_plain(q, qm, p, pm)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("nn at the SAC-IA scoring shape differs from "
                             "the plain version")
    if not same_bits(lambda: kernels.nn(q, qm, p, pm)):
        raise AssertionError("nn at the SAC-IA scoring shape: two launches "
                             "differ")
    qn, pn = q.shape[0], p.shape[0]
    sac = {"shape": f"{qn}x{pn}", "launches": modes["fpfh"]["launches"]["nn"]
           - modes["fpfh"]["launches"]["nn_grouped"]}
    sac["ms"], _ = device_ms(lambda: kernels.nn(q, qm, p, pm), 20)
    sac["event_ms"] = time_ms(lambda: kernels.nn(q, qm, p, pm), 20)
    sac["plain_ms"] = time_ms(lambda: kernels.nn_plain(q, qm, p, pm), 3)
    sac["library_ms"] = time_ms(lambda: cdist_min([(q, qm, p, pm)]), 3)
    sac["bound_ms"], sac["bound_by"] = bound_ms(
        9.0 * qn * pn, qn * 13 + pn * 13 + qn * 8)
    sac["max_abs_err"] = 0.0
    print(f"[kernels] nn at the SAC-IA scoring shape {sac['shape']} (512 "
          f"hypotheses x 256 points against the facade + ground target): "
          f"equal to the plain version bit for bit, same bits twice; kernel "
          f"{sac['ms']:.4f} ms on the device ({sac['event_ms']:.4f} ms with "
          f"CUDA events), plain {sac['plain_ms']:.4f} ms, cdist+min "
          f"{sac['library_ms']:.4f} ms, bound {sac['bound_ms']:.5f} ms "
          f"({sac['bound_by']}); {sac['launches']} nn launches of its own "
          f"in the fpfh run", flush=True)

    # nn_grouped at one ICP iteration of the sweep's first heading seed
    group = sweep_tap.calls[0]
    for k, ((ik, dk), (ip, dp)) in enumerate(zip(
            kernels.nn_grouped(group), kernels.nn_grouped_plain(group))):
        if not (torch.equal(ik, ip) and torch.equal(dk, dp)):
            raise AssertionError(f"nn_grouped at the sweep's shapes, problem "
                                 f"{k}: differs from the plain version")
    if not same_bits(lambda: kernels.nn_grouped(group)):
        raise AssertionError("nn_grouped at the sweep's shapes: two "
                             "launches differ")
    shapes = [(pr[0].shape[0], pr[2].shape[0]) for pr in group]
    pairs = sum(a * b for a, b in shapes)
    sweep = {"shape": " + ".join(f"{a}x{b}" for a, b in shapes),
             "pairs": pairs, "launches_per_seed": len(sweep_tap.calls)
             // max(1, round(360.0 / 15.0)),
             "launches": modes["yaw4dof"]["launches"]["nn_grouped"]}
    sweep["ms"], _ = device_ms(lambda: kernels.nn_grouped(group), 50)
    sweep["event_ms"] = time_ms(lambda: kernels.nn_grouped(group), 50)
    sweep["plain_ms"] = time_ms(lambda: kernels.nn_grouped_plain(group), 5)
    sweep["library_ms"] = time_ms(lambda: cdist_min(group), 5)
    sweep["bound_ms"], sweep["bound_by"] = bound_ms(
        9.0 * pairs, sum(a * 13 + b * 13 + a * 8 for a, b in shapes))
    sweep["max_abs_err"] = 0.0
    print(f"[kernels] nn_grouped at one iteration of a heading seed "
          f"({sweep['shape']}, {pairs:.3g} pairs): equal to the plain "
          f"version bit for bit, same bits twice; {sweep['ms']:.4f} ms on "
          f"the device ({sweep['event_ms']:.4f} ms with CUDA events), plain "
          f"{sweep['plain_ms']:.4f} ms, cdist+min per class "
          f"{sweep['library_ms']:.4f} ms, bound {sweep['bound_ms']:.5f} ms "
          f"({sweep['bound_by']}); {sweep['launches_per_seed']} launches a "
          f"seed, {sweep['launches']} in the sweep", flush=True)
    launches = {k: sum(m["launches"][k] for m in modes.values())
                for k in modes["default"]["launches"]}
    return {"modes": modes, "sac_ia_nn": sac, "sweep_nn_grouped": sweep,
            "launches": launches}


# --------------------------------------------------------------------------
# phase 14: two SLAM sessions of the street merged by the map-merge CLI
# --------------------------------------------------------------------------

MERGE_FRAMES = 48  # a session: 60 m of the street, two 30 m submaps
MERGE_STEP = 1.25  # m/frame
MERGE_BOUND = (0.5, 1.0)  # m, deg: the session transform to the truth


def street_drive(x0: float, y0: float, yaw: float) -> np.ndarray:
    """MERGE_FRAMES poses straight along the street from (x0, y0)."""
    poses = []
    for k in range(MERGE_FRAMES):
        T = rot_z(math.degrees(yaw))
        T[:2, 3] = [x0 + k * MERGE_STEP * math.cos(yaw),
                    y0 + k * MERGE_STEP * math.sin(yaw)]
        poses.append(T)
    return np.stack(poses)


def merge_phase(world: np.ndarray, dev, out_dir: str) -> dict:
    """Two ``SlamPipeline`` sessions at full width with the default config
    (loop closure on, 30 m submaps): A drives the street east from x = -30,
    B drives it back west 3 m to the side, each in its own frame 0, each
    writing its checkpoint; then ``mulls_tpu_torch.apps.map_merge.main``
    on the two.  Checks exit 0, the session transform within 0.5 m / 1 deg
    of the truth, >= 1 inter-session edge, the PGO accepted, B's merged
    frame positions within 0.5 m of its truth in A's frame and the files
    written."""
    import dataclasses

    import torch
    from mulls_tpu_torch.apps import map_merge as cli
    from mulls_tpu_torch.config import MullsConfig
    from mulls_tpu_torch.ops import kernels
    from mulls_tpu_torch.pipeline.slam import SlamPipeline

    base = MullsConfig()
    cfg = base.replace(submap=dataclasses.replace(
        base.submap, loop_closure_detection_on=True))
    rng = np.random.default_rng(SEED + 13)
    gA = street_drive(-30.0, 0.0, 0.0)
    gB = street_drive(30.0, 3.0, math.pi)
    o = lambda name: os.path.join(out_dir, name)
    sessions = []
    for name, g in (("A", gA), ("B", gB)):
        scans = [render_scan(world, T, base.shapes.n_raw, rng) for T in g]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = SlamPipeline(cfg, segment=SLAM_SEGMENT, device=dev,
                           checkpoint_path=o(f"session_{name}.ckpt")
                           ).run(scans)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spans = [(s.frame_begin, s.frame_end) for s in res.backend.submaps]
        sessions.append({"fps": MERGE_FRAMES / wall, "spans": spans,
                         "codes_not_1": [c for c in res.codes[1:] if c != 1]})
        print(f"[merge] session {name}: {MERGE_FRAMES} frames at "
              f"{MERGE_FRAMES / wall:.2f} frames/s, submaps {spans}, codes "
              f"other than 1 after the first: {sessions[-1]['codes_not_1']}",
              flush=True)
        if len(spans) < 2:
            raise AssertionError(f"session {name}: {len(spans)} submap(s), "
                                 f"two needed")
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(["--checkpoints",
                   f"{o('session_A.ckpt')},{o('session_B.ckpt')}",
                   "--output_dir", o("merged"),
                   "--output_map_pcd", o("merged/map.pcd"),
                   "--output_map_html", o("merged/map.html"),
                   "--json_out", o("merged/merge.json"), "--progress"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = kernels.launch_counts()
    if rc != 0:
        raise AssertionError(f"map_merge exited {rc}")
    with open(o("merged/merge.json")) as f:
        rec = json.load(f)
    T_true = np.linalg.inv(gA[0]) @ gB[0]
    T_s = np.asarray(rec["session_transforms"][1])
    dt, dr = motion_diff(T_s, T_true)
    poses_b = np.loadtxt(o("merged/session_1_pose.txt")).reshape(-1, 3, 4)
    gt_b = np.einsum("ij,njk->nik", np.linalg.inv(gA[0]), gB)
    pos_err = float(np.max(np.linalg.norm(poses_b[:, :3, 3]
                                          - gt_b[:, :3, 3], axis=1)))
    files = ["session_0_pose.txt", "session_1_pose.txt",
             "merged_submap_poses.txt", "map.pcd", "map.html"]
    sizes = {f: (os.path.getsize(o(f"merged/{f}"))
                 if os.path.exists(o(f"merged/{f}")) else 0) for f in files}
    tm = rec["timings_ms"]
    print(f"[merge] map_merge: exit 0 in {ms:.1f} ms (reading both "
          f"checkpoints, the vote pass {tm['vote']:.1f} ms, the fine edges "
          f"{tm['edges']:.1f} ms, the PGO {tm['pgo']:.1f} ms, writing); "
          f"{rec['inter_edges']} inter-session edges, PGO "
          f"{'accepted' if rec['pgo_accepted'] else 'not accepted'}; session "
          f"transform {dt:.4f} m / {dr:.3f} deg from the truth; session B's "
          f"merged frames at most {pos_err:.4f} m from the truth; files "
          f"{sizes}; launches {launches}", flush=True)
    for ev in rec["events"]:
        print(f"[merge]   {ev}", flush=True)
    if not (dt <= MERGE_BOUND[0] and dr <= MERGE_BOUND[1]):
        raise AssertionError(f"merge: the session transform is {dt} m / {dr}"
                             f" deg from the truth, above {MERGE_BOUND}")
    if rec["inter_edges"] < 1 or not rec["pgo_accepted"]:
        raise AssertionError("merge: no inter-session edge or the PGO was "
                             "not accepted")
    if not pos_err <= MERGE_BOUND[0]:
        raise AssertionError(f"merge: session B's frames up to {pos_err} m "
                             f"from the truth")
    if not all(sizes.values()):
        raise AssertionError(f"merge: outputs missing or empty: {sizes}")
    if launches["nn_grouped"] <= 0:
        raise AssertionError("merge: no nn_grouped launch")
    return {"sessions": sessions, "ms": ms, "timings_ms": tm,
            "inter_edges": rec["inter_edges"],
            "pgo_accepted": rec["pgo_accepted"], "t_err_m": dt,
            "r_err_deg": dr, "pos_err_m": pos_err, "files": sizes,
            "launches": launches, "events": rec["events"]}


# --------------------------------------------------------------------------
# phase 15: multi-sequence odometry on one card
# --------------------------------------------------------------------------

MULTISEQ_FRAMES = 16  # a drive
MULTISEQ_SHORT = 12  # the last drive of the check, cut to exercise the end
# the rate runs: segments of 2 frames, 4 frames of warm-up, 8 timed
MULTISEQ_SEGMENT, MULTISEQ_WARM, MULTISEQ_TIMED = 2, 4, 8
# (x0, y0, heading deg, deg/frame): four drives along the street, 1 m/frame
MULTISEQ_DRIVES = ((-60.0, 0.0, 0.0, 0.3), (50.0, 2.0, 180.0, -0.3),
                   (-20.0, -3.0, 2.0, 0.0), (20.0, 3.0, 182.0, 0.2))


def multiseq_drive(x0: float, y0: float, yaw_deg: float, turn_deg: float,
                   n: int) -> np.ndarray:
    poses = []
    x, y, yaw = x0, y0, math.radians(yaw_deg)
    for _ in range(n):
        T = rot_z(math.degrees(yaw))
        T[:2, 3] = [x, y]
        poses.append(T)
        x += math.cos(yaw)
        y += math.sin(yaw)
        yaw += math.radians(turn_deg)
    return np.stack(poses)


MULTISEQ_RANKS = 4  # processes sharing the card for the process-parallel rate
MULTISEQ_RATE_S = 8  # the sequences of the process-parallel rate


def multiseq_rank(rank: int, world: int, init: str, folders: list, cfg,
                  device: str, out: str) -> None:
    """One rank (a spawned process) of the process-parallel rate: its
    block of MULTISEQ_RATE_S sequences, read from .bin folders through the
    native reader (the warm-up and timed frames), through
    ``MultiSeqPipeline`` on the shared card; every segment ends at a
    barrier of all ranks, so rank 0's clock brackets the timed window of
    all."""
    import torch.distributed as tdist

    from mulls_tpu_torch.io import native
    from mulls_tpu_torch.io.dataset import FolderDataset
    from mulls_tpu_torch.parallel import distributed as dist
    from mulls_tpu_torch.parallel.multiseq import MultiSeqPipeline

    if not native.native_available():
        raise AssertionError("the native reader does not load in the rank")
    dist.initialize_from_env(init, world, rank, backend="gloo")
    rec = {"describe": dist.describe()}
    try:
        mesh = dist.global_mesh(device=device)
        marks = {}

        def hook(k):
            tdist.barrier()
            marks[k] = time.perf_counter()

        end = MULTISEQ_WARM + MULTISEQ_TIMED
        ds = [FolderDataset(folders[s % len(folders)], cfg.shapes.n_raw,
                            end=end) for s in range(MULTISEQ_RATE_S)]
        MultiSeqPipeline(cfg, mesh, segment=MULTISEQ_SEGMENT).run(
            ds, on_segment=hook)
        rec["seconds"] = marks[end] - marks[MULTISEQ_WARM]
    finally:
        tdist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def spawn(target, args_of_rank, world: int, timeout: float) -> None:
    """``world`` processes started with ``spawn``, each ``target(*args)``;
    fails unless every one exits 0 within ``timeout`` seconds."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of_rank(r))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + timeout
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.perf_counter()))
    stuck = [p for p in procs if p.is_alive()]
    for p in stuck:
        p.kill()
        p.join()
    if stuck or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"the {world}-rank group failed: exit codes "
                             f"{[p.exitcode for p in procs]}")


_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize", "cudaMemcpy")


def busy_share(prof, S: int, batched_frames: int, profiled_ms: float,
               fps_aggregate: float):
    """Over a profiled segment of ``batched_frames`` batched frames of S
    sequences: the device's busy time (the union of its kernels'
    intervals) over the time the segment takes at the unprofiled rate, the
    device operations per sequence-frame, and the host syncs per batched
    frame (the runtime's synchronize calls, and the device-to-host copies
    beside them)."""
    from torch.autograd import DeviceType
    events = prof.events()
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    seq_frames = S * batched_frames
    if not kern:
        print(f"[multiseq] device busy share at S = {S} not measured: the "
              f"profiler recorded no device activity", flush=True)
        return None
    syncs = sum(1 for e in events if e.name in _SYNC_CALLS)
    dtoh = sum(1 for e in kern if "DtoH" in e.name)
    spans = [(e.time_range.start, e.time_range.end) for e in kern]
    busy = union_ms(spans)
    summed = sum(b - a for a, b in spans) / 1e3
    unprofiled_ms = 1e3 * seq_frames / fps_aggregate
    print(f"[multiseq] S = {S}, one steady segment under torch.profiler "
          f"({batched_frames} batched frames, {seq_frames} sequence-frames):"
          f" device busy {busy:.2f} ms (the union of its kernels; "
          f"{summed:.2f} ms summed) in {unprofiled_ms:.2f} ms at the "
          f"unprofiled rate ({profiled_ms:.2f} ms profiled): busy "
          f"{100.0 * busy / unprofiled_ms:.1f} %; "
          f"{len(kern) / seq_frames:.0f} device operations per "
          f"sequence-frame; host syncs per batched frame "
          f"{syncs / batched_frames:.1f} ({dtoh / batched_frames:.1f} "
          f"device-to-host copies)", flush=True)
    return {"busy_ms": busy, "kernel_ms_summed": summed,
            "profiled_window_ms": profiled_ms,
            "unprofiled_window_ms": unprofiled_ms,
            "busy_share": busy / unprofiled_ms,
            "device_ops_per_sequence_frame": len(kern) / seq_frames,
            "host_syncs_per_batched_frame": syncs / batched_frames,
            "dtoh_copies_per_batched_frame": dtoh / batched_frames}


class SyncWatch:
    """The host's syncs by call site: torch.cuda's sync debug mode warns at
    each operation that synchronizes with the device, and the warnings'
    locations (the Python line that called the operation, relative to the
    checkout) are counted between :meth:`start` and :meth:`stop`."""

    def __init__(self):
        self.sites: dict = {}
        self._cm = None

    def start(self) -> None:
        import warnings

        import torch
        self._cm = warnings.catch_warnings(record=True)
        self._caught = self._cm.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")

    def stop(self) -> None:
        import torch
        torch.cuda.set_sync_debug_mode(0)
        self._cm.__exit__(None, None, None)
        here = os.path.dirname(os.path.abspath(__file__))
        for w in self._caught:
            if "synchroniz" not in str(w.message):
                continue
            site = f"{os.path.relpath(w.filename, here)}:{w.lineno}"
            self.sites[site] = self.sites.get(site, 0) + 1


def union_ms(intervals: list) -> float:
    """Length of the union of (start, end) intervals (us), in ms."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def multiseq_phase(world: np.ndarray, dev) -> dict:
    """``MultiSeqPipeline`` at full width on a one-device mesh: four drives
    of the street (one cut to 12 frames) stepped as one batch, each
    sequence against an ``OdometryPipeline`` run of it alone with the
    multi-sequence config and seed ``cfg.seed + s``: the same codes and
    poses bit for bit.  Then the aggregate frames/s at S = 1, 4 and 8 in
    one batch (the four drives, repeated, written as KITTI .bin and read
    through the native reader), timed over 8 frames after 4 of warm-up
    with a sync at the end of each 2-frame segment, with the kernel
    launches per sequence-frame; at S = 1 and 8 the device's busy share,
    its operations per sequence-frame and the host's syncs per batched
    frame over one more segment under torch.profiler; then S = 8 over
    MULTISEQ_RANKS processes sharing the card on the same reader, each
    rank batching its block of 2."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mulls_tpu_torch.config import MullsConfig
    from mulls_tpu_torch.io import native
    from mulls_tpu_torch.io.dataset import FolderDataset
    from mulls_tpu_torch.parallel.mesh import make_mesh
    from mulls_tpu_torch.parallel.multiseq import MultiSeqPipeline
    from mulls_tpu_torch.pipeline.odometry import OdometryPipeline

    cfg = MullsConfig()
    rng = np.random.default_rng(SEED + 15)
    drives = [multiseq_drive(*d, MULTISEQ_FRAMES) for d in MULTISEQ_DRIVES]
    pool = [[render_scan(world, T, cfg.shapes.n_raw, rng) for T in g]
            for g in drives]
    check = pool[:3] + [pool[3][:MULTISEQ_SHORT]]
    mesh = make_mesh(1, device=dev)
    pipe = MultiSeqPipeline(cfg, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipe.run(check)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"frames": [len(c) for c in check], "seconds": wall,
           "launches": pipe.block_launches, "sequences": []}
    print(f"[multiseq] {len(check)} sequences ({out['frames']} frames) on "
          f"{[str(d) for d in mesh.devices]}, one batch, in {wall:.2f} s: "
          f"{sum(out['frames']) / wall:.2f} frames/s aggregate, the first "
          f"frames included; the batch's launches {pipe.block_launches[0]}",
          flush=True)
    for s, r in enumerate(res):
        alone = OdometryPipeline(pipe.cfg.replace(seed=cfg.seed + s),
                                 device=dev).run(check[s])
        same = (alone.codes == r.codes
                and np.array_equal(alone.poses, r.poses))
        rel = lambda p: np.linalg.inv(p[:-1]) @ p[1:]
        d = rel(alone.poses) - rel(r.poses)
        gt = np.linalg.inv(drives[s][0]) @ drives[s][:len(check[s])]
        end = float(np.linalg.norm(r.poses[-1, :3, 3] - gt[-1, :3, 3]))
        ok = sum(1 for c in r.codes[1:] if c == 1)
        rec = {"frames": len(r.poses), "codes": r.codes, "ok_after_first":
               ok, "equal_alone": same,
               "max_rel_dt_m": float(np.abs(d[:, :3, 3]).max()),
               "max_rel_dR": float(np.abs(d[:, :3, :3]).max()),
               "end_err_m": end, "launches": pipe.launches[s]}
        out["sequences"].append(rec)
        print(f"[multiseq] sequence {s}: {rec['frames']} frames, codes "
              f"{r.codes}; end error {end:.4f} m; alone: "
              f"{'the same codes and poses bit for bit' if same else 'differs'}"
              f" (T_rel max |d| {rec['max_rel_dt_m']:.3g} m, "
              f"{rec['max_rel_dR']:.3g})", flush=True)

    # the rates: the drives written as KITTI .bin and read back through
    # the native reader, as a fleet run reads its logs; S = 1, 4 and 8 in
    # this process, then S = 8 over MULTISEQ_RANKS processes sharing the
    # card (gloo): the same reader on both sides of the processes' change
    native.build_library()  # raises: the phase fails
    if not native.native_available():
        raise AssertionError("the native IO library built but did not load")
    rates = {}
    steady_end = MULTISEQ_WARM + MULTISEQ_TIMED
    tmp = tempfile.mkdtemp(prefix="multiseq_")
    try:
        folders = []
        for s, seq in enumerate(pool):
            folders.append(os.path.join(tmp, f"drive{s}"))
            os.makedirs(folders[-1])
            for k, f in enumerate(seq[:steady_end + 2 * MULTISEQ_SEGMENT]):
                _write_bin(os.path.join(folders[-1], f"{k:06d}.bin"), f)
        busy = {}
        for S in (1, 4, 8):
            # at S = 1 and 8 one more segment, under the profiler: the
            # device, and the host's syncs
            prof = (profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
                    if S in (1, 8) else None)
            # and one more after it, under torch.cuda's sync debug mode:
            # the host syncs by call site
            n_prof = steady_end + (MULTISEQ_SEGMENT if prof is not None
                                   else 0)
            n = n_prof + (MULTISEQ_SEGMENT if prof is not None else 0)
            marks = {}
            watch = SyncWatch()

            def hook(k):
                marks[k] = time.perf_counter()
                if prof is not None and k == steady_end:
                    prof.start()
                elif prof is not None and k == n_prof:
                    prof.stop()
                    marks["profiled"] = time.perf_counter()
                    watch.start()
                elif prof is not None and k == n:
                    watch.stop()

            p = MultiSeqPipeline(cfg, mesh, segment=MULTISEQ_SEGMENT)
            p.run([FolderDataset(folders[s % len(folders)], cfg.shapes.n_raw,
                                 end=n) for s in range(S)], on_segment=hook)
            steady = S * MULTISEQ_TIMED
            secs = marks[steady_end] - marks[MULTISEQ_WARM]
            per_seq_frame = {k: sum(x[k] for x in p.block_launches) / (S * n)
                             for k in p.block_launches[0]}
            rates[str(S)] = {"fps_aggregate": steady / secs,
                             "steady_frames": steady, "seconds": secs,
                             "launches_per_sequence_frame": per_seq_frame}
            print(f"[multiseq] S = {S}, one process: {steady} steady frames "
                  f"in {secs:.3f} s after {MULTISEQ_WARM} warm-up frames: "
                  f"{steady / secs:.3f} frames/s aggregate "
                  f"({steady / secs / S:.3f} per sequence); kernel launches "
                  f"per sequence-frame "
                  + ", ".join(f"{k} {v:.3f}"
                              for k, v in per_seq_frame.items() if v),
                  flush=True)
            if prof is not None:
                busy[str(S)] = busy_share(
                    prof, S, MULTISEQ_SEGMENT,
                    1e3 * (marks["profiled"] - marks[steady_end]),
                    rates[str(S)]["fps_aggregate"])
                sites = watch.sites
                total = sum(sites.values())
                busy[str(S)]["sync_sites_per_batched_frame"] = {
                    k: v / MULTISEQ_SEGMENT for k, v in sites.items()}
                print(f"[multiseq] S = {S}, one steady segment under the "
                      f"sync debug mode: {total / MULTISEQ_SEGMENT:.1f} "
                      f"synchronizing operations per batched frame: "
                      + "; ".join(f"{k} x{v / MULTISEQ_SEGMENT:g}"
                                  for k, v in sorted(sites.items())),
                      flush=True)
        out["busy"] = busy
        init = "file://" + os.path.join(tmp, "rendezvous")
        outs = [os.path.join(tmp, f"rank{r}.json")
                for r in range(MULTISEQ_RANKS)]
        spawn(multiseq_rank,
              lambda r: (r, MULTISEQ_RANKS, init, folders, cfg, dev.type,
                         outs[r]), MULTISEQ_RANKS, 600.0)
        with open(outs[0]) as f:
            rec = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    S = MULTISEQ_RATE_S
    steady = S * MULTISEQ_TIMED
    key = f"{S}_over_{MULTISEQ_RANKS}_processes"
    fps = steady / rec["seconds"]
    rates[key] = {"fps_aggregate": fps, "steady_frames": steady,
                  "seconds": rec["seconds"],
                  "vs_one_process": fps / rates[str(S)]["fps_aggregate"]}
    for k in rates:
        rates[k]["speedup_vs_1"] = (rates[k]["fps_aggregate"]
                                    / rates["1"]["fps_aggregate"])
    print(f"[multiseq] S = {S} over {MULTISEQ_RANKS} processes on the card "
          f"({rec['describe']}, ...): {steady} steady frames in "
          f"{rec['seconds']:.3f} s: {fps:.3f} frames/s aggregate, "
          f"x{rates[key]['vs_one_process']:.3f} the one-process rate at "
          f"S = {S} on the same reader", flush=True)
    out["rates"] = rates
    return out


# --------------------------------------------------------------------------
# phase 16: the fleet CLI, the native reader, format_transform, two ranks
# --------------------------------------------------------------------------

FLEET_FRAMES = 8


def _write_bin(path: str, f: dict) -> None:
    m = f["mask"]
    np.concatenate([f["xyz"][m], f["intensity"][m, None] / 255.0],
                   1).astype(np.float32).tofile(path)


def _spawn_ranks(out_dir: str, device: str, world: int = 2,
                 timeout: float = 240.0) -> list:
    """``world`` processes (spawn) in a gloo group on ``device`` (the
    card), each running ``parallel/ring_check.py``'s sharded PGO on the
    ring."""
    from mulls_tpu_torch.parallel.ring_check import sharded_rank
    init = "file://" + os.path.join(out_dir, "rendezvous")
    outs = [os.path.join(out_dir, f"rank{r}.json") for r in range(world)]
    spawn(sharded_rank, lambda r: (r, world, init, outs[r], device), world,
          timeout)
    recs = []
    for o in outs:
        with open(o) as f:
            recs.append(json.load(f))
    return recs


def fleet_phase(frames: list, gt: np.ndarray, dev, out_dir: str) -> dict:
    """The fleet CLI (``apps.slam_multiseq.main``) over two folders of 8
    street frames as KITTI .bin through the native reader (built here;
    the phase fails if it does not build); ``format_transform bin2pcd``
    on one frame, read back; native and numpy readers on the .bin and
    the .pcd; a 2-rank gloo group on the card running
    ``optimize_pose_graph_sharded`` on tests/test_multiseq.py's 9-node
    ring; ``distributed_slam_step`` over 4 full-width pairs of the main
    phase's frames on a one-entry and a four-entry mesh of the card."""
    import dataclasses

    import torch
    from mulls_tpu_torch.apps import format_transform, slam_multiseq
    from mulls_tpu_torch.backend.pgo import optimize_pose_graph
    from mulls_tpu_torch.config import MullsConfig
    from mulls_tpu_torch.core.cloud import FeatureCloud, RawCloud
    from mulls_tpu_torch.core.draws import GeneratorDraws
    from mulls_tpu_torch.frontend.features import extract_features
    from mulls_tpu_torch.frontend.icp import mm_lls_icp
    from mulls_tpu_torch.io import native
    from mulls_tpu_torch.io.dataset import pad_cloud, read_point_cloud
    from mulls_tpu_torch.io.pcd import read_pcd
    from mulls_tpu_torch.parallel.mesh import (Mesh, distributed_slam_step,
                                               make_mesh)
    from mulls_tpu_torch.parallel.ring_check import ring_graph, torch_graph

    out = {}
    t0 = time.perf_counter()
    info = native.build_library()  # raises: the phase fails
    if not native.native_available():
        raise AssertionError("the native IO library built but did not load")
    out["native_build_s"] = time.perf_counter() - t0
    print(f"[fleet] native IO library {'built' if info['built'] else 'found'}"
          f" in {out['native_build_s']:.2f} s: {info['path']}", flush=True)

    folders = []
    for name, part in (("seq_a", frames[:FLEET_FRAMES]),
                       ("seq_b", frames[FLEET_FRAMES:2 * FLEET_FRAMES])):
        d = os.path.join(out_dir, "fleet", name)
        os.makedirs(d, exist_ok=True)
        for k, f in enumerate(part):
            _write_bin(os.path.join(d, f"{k:06d}.bin"), f)
        folders.append(d)
    res_dir = os.path.join(out_dir, "fleet_out")
    t0 = time.perf_counter()
    rc = slam_multiseq.main(["--sequence_folders", ",".join(folders),
                             "--output_dir", res_dir, "--segment", "4",
                             "--device", dev.type])
    out["cli_s"] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"the fleet CLI exited {rc}")
    with open(os.path.join(res_dir, "summary.json")) as f:
        summary = json.load(f)
    for name in ("seq_a", "seq_b"):
        poses = np.loadtxt(os.path.join(res_dir, f"{name}_pose.txt"))
        if poses.shape != (FLEET_FRAMES, 12):
            raise AssertionError(f"{name}_pose.txt holds {poses.shape}")
        if summary["sequences"][name]["ok_frames"] < FLEET_FRAMES - 1:
            raise AssertionError(f"{name}: {summary['sequences'][name]}")
    out["summary"] = summary
    print(f"[fleet] slam_multiseq over 2 folders of {FLEET_FRAMES} .bin "
          f"frames: exit 0 in {out['cli_s']:.1f} s, fps_aggregate "
          f"{summary['fps_aggregate']:.3f} (the first frames included), "
          f"{summary['sequences']}", flush=True)

    # format_transform, and the two readers on the .bin and the .pcd
    src = os.path.join(folders[0], "000000.bin")
    pcd = os.path.join(out_dir, "fleet", "000000.pcd")
    if format_transform.main(["bin2pcd", src, pcd]) != 0:
        raise AssertionError("format_transform bin2pcd failed")
    raw = np.fromfile(src, np.float32).reshape(-1, 4)
    back = read_pcd(pcd)
    # the .pcd stores float32: the points and the KITTI reader's x255
    # intensities come back exactly
    if not (np.array_equal(back["xyz"], raw[:, :3]) and np.array_equal(
            back["intensity"], raw[:, 3] * np.float32(255))):
        raise AssertionError("bin2pcd's file does not read back as the .bin")
    n_raw = MullsConfig().shapes.n_raw
    for path in (src, pcd):
        a = native.read_cloud_native(path, n_raw)
        b = pad_cloud(read_point_cloud(path), n_raw)
        if not all(np.array_equal(a[k], b[k]) for k in b):
            raise AssertionError(f"native and numpy readers differ on {path}")
    print(f"[fleet] bin2pcd: {len(raw)} points read back exactly; native "
          f"and numpy readers give equal padded clouds on the .bin and the "
          f".pcd", flush=True)

    # two ranks on one card: gloo (NCCL refuses two ranks on one device)
    g = ring_graph()
    t0 = time.perf_counter()
    recs = _spawn_ranks(os.path.join(out_dir, "fleet"), dev.type)
    out["ranks_s"] = time.perf_counter() - t0
    t1, _, _ = optimize_pose_graph(torch_graph(g, dev), iterations=15)
    t1 = t1.cpu().numpy()
    ring = []
    for r, rec in enumerate(recs):
        err = float(np.abs(np.float32(rec["t"]) - t1).max())
        ring.append({"describe": rec["describe"], "max_dt_m": err,
                     "slice": rec["slice"], "whole": rec["whole"]})
        if not err <= 1e-3:
            raise AssertionError(f"rank {r}'s sharded PGO is {err} m from "
                                 f"optimize_pose_graph")
    if recs[0]["t"] != recs[1]["t"]:
        raise AssertionError("the two ranks' sharded PGO results differ")
    out["ranks"] = ring
    print(f"[fleet] 2 ranks on one {dev.type} device "
          f"({recs[0]['describe']}; {recs[1]['describe']}), "
          f"{out['ranks_s']:.1f} s with the processes' start: "
          f"optimize_pose_graph_sharded on the 9-node ring equal on both "
          f"ranks, {ring[0]['max_dt_m']:.3g} m from the one-process "
          f"optimize_pose_graph; process_slice(10) "
          f"{[x['slice'] for x in ring]}", flush=True)

    # distributed_slam_step over 4 full-width pairs (k + 1 onto k)
    cfg = MullsConfig()
    feats = [extract_features(RawCloud.from_numpy(frames[k], dev), cfg,
                              GeneratorDraws(SEED + k, dev)).down
             for k in range(5)]
    fields = [f.name for f in dataclasses.fields(FeatureCloud)]

    def stack(cl):
        return {c: FeatureCloud(**{f: torch.stack([getattr(x[c], f)
                                                   for x in cl])
                                   for f in fields}) for c in cl[0]}

    guess = torch.eye(4, device=dev)
    guess[0, 3] = 1.0  # the street's 1 m/frame
    guesses = guess.expand(4, 4, 4).contiguous()
    e_i = torch.arange(4, device=dev)
    m = 5
    node_t = torch.zeros((m, 3), device=dev)
    node_q = torch.zeros((m, 4), device=dev)
    node_q[:, 0] = 1.0
    it = cfg.reg.reg_max_iter_num_s2m
    single = [mm_lls_icp(feats[k + 1], feats[k], cfg.reg, guesses[k], it)
              for k in range(4)]
    T1 = torch.stack([r.transform for r in single])
    steps = {}
    for name, mesh in (("one entry", make_mesh(1, device=dev)),
                       ("four entries", Mesh((dev,) * 4))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nt, nq, T, sig = distributed_slam_step(mesh, cfg.reg, it, m)(
            stack(feats[1:]), stack(feats[:4]), guesses, e_i, e_i + 1,
            node_t, node_q)
        torch.cuda.synchronize()
        steps[name] = {"ms": 1e3 * (time.perf_counter() - t0),
                       "T_equal": bool(torch.equal(T, T1)),
                       "t": nt.cpu().numpy(), "q": nq.cpu().numpy()}
    d_node = max(float(np.abs(steps["one entry"][k]
                              - steps["four entries"][k]).max())
                 for k in ("t", "q"))
    rel_gt = [np.linalg.inv(gt[k]) @ gt[k + 1] for k in range(4)]
    err = [float(np.linalg.norm(T1[k].cpu().numpy()[:3, 3]
                                - rel_gt[k][:3, 3])) for k in range(4)]
    out["step"] = {"codes": [int(r.process_code) for r in single],
                   "T_err_m": err, "node_diff": d_node,
                   **{f"{k}_ms": v["ms"] for k, v in steps.items()},
                   **{f"{k}_T_equal": v["T_equal"]
                      for k, v in steps.items()}}
    equal = all(v["T_equal"] for v in steps.values())
    times = ", ".join(f"{k} {v['ms']:.1f} ms" for k, v in steps.items())
    print(f"[fleet] distributed_slam_step over 4 full-width pairs: codes "
          f"{out['step']['codes']}, transforms "
          f"{'bit-equal' if equal else 'NOT equal'} to four single "
          f"mm_lls_icp calls on one and on four mesh entries ({times}); "
          f"the node update differs by {d_node:.3g} between the two; "
          f"pair errors against the truth {[round(e, 4) for e in err]} m",
          flush=True)
    if not equal:
        raise AssertionError("the step's transforms differ from single "
                             "mm_lls_icp calls")
    if not d_node <= 1e-4:
        raise AssertionError(f"node updates of the one- and four-entry "
                             f"meshes differ by {d_node}")
    return out


# --------------------------------------------------------------------------
# phase 17: the recovery ladder at full width, against the reference
# --------------------------------------------------------------------------

LADDER_RECORD = os.path.join("experiments", "ladder_reference.json")
LADDER_BOUND = (0.02, 0.2)  # m, deg: T_rel against the record


class IcpCount:
    """Counts ``mm_lls_icp`` calls of the odometry step while entered."""

    def __enter__(self):
        from mulls_tpu_torch.pipeline import odometry
        self.mod, self.fn, self.calls = odometry, odometry.mm_lls_icp, 0
        odometry.mm_lls_icp = self
        return self

    def __exit__(self, *exc):
        self.mod.mm_lls_icp = self.fn

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


def ladder_phase(dev) -> dict:
    """The warm state of ``experiments/ladder_reference.json`` on the card:
    ``MullsConfig()``, its stationary scans of the urban world
    (``worlds.stationary_scans``), each stepped by ``slam_step`` with the
    port's production draws (a generator seeded from ``cfg.seed``; the
    reference's ``jax.random`` is not replayed, so equal bits are not
    expected).  From that state one more step for each of the record's
    cases (a wrong prior of given yaw and shift, a model age): the code
    must equal the record's and ``T_rel`` be within 2 cm / 0.2 deg of
    it.  Prints ms per case and the ICP runs of the step (the yaw sweep
    adds one a seed)."""
    import torch
    from mulls_tpu_torch.config import MullsConfig
    from mulls_tpu_torch.core.cloud import pack_raw_host
    from mulls_tpu_torch.core.draws import GeneratorDraws
    from mulls_tpu_torch.core.tree import tree_map
    from mulls_tpu_torch.pipeline.odometry import init_state, slam_step
    from mulls_tpu_torch.tools.worlds import stationary_scans

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, LADDER_RECORD)) as f:
        rec = json.load(f)
    cfg = MullsConfig()
    n = rec["warm_scans"]
    t0 = time.perf_counter()
    scans = stationary_scans(rec["seed"], n + 1, cfg.shapes.n_raw)
    packed = [pack_raw_host(f, with_ts=False).to(dev) for f in scans]
    warm = init_state(cfg, dev)
    warm_codes = []
    for i in range(n):
        warm, out = slam_step(warm, packed[i], cfg, frame=i)
        warm_codes.append(int(out.code))
    torch.cuda.synchronize()
    print(f"[ladder] warm state: {n} stationary scans of the urban world "
          f"(seed {rec['seed']}), codes {warm_codes} (the reference's "
          f"{rec['warm_codes']}), {time.perf_counter() - t0:.1f} s",
          flush=True)
    # the sweep's trials (odometry._register_stage): every yaw step on
    # each side at the prior's translation, then zero yaw and every step
    # at a third of it
    m = cfg.map
    seeds = 4 * max(int(round(m.yaw_reacquire_range_d
                              / m.yaw_reacquire_step_d)), 1) + 1
    draws_state = warm.draws.get_state()
    out_cases = {}
    for case, c in rec["cases"].items():
        T = np.eye(4, dtype=np.float32)
        yaw = np.radians(c["prior_yaw_deg"])
        T[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        T[0, 3] = c["prior_shift_m"]
        draws = GeneratorDraws(cfg.seed, dev)
        draws.set_state(draws_state)
        state = tree_map(lambda x: x.clone() if torch.is_tensor(x) else x,
                         warm).replace(
            draws=draws, T_prev=torch.as_tensor(T, device=dev),
            model_age=torch.tensor(c["model_age"], dtype=torch.int32,
                                   device=dev),
            add_length=torch.tensor(0.0, dtype=torch.float32, device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with IcpCount() as icp:
            _, step = slam_step(state, packed[n], cfg, frame=n)
            code = int(step.code)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        T_rel = step.T_rel.cpu().numpy().astype(np.float64)
        dt, dr = motion_diff(T_rel, np.asarray(c["T_rel"], np.float64))
        sweep = seeds if icp.calls > seeds else 0
        ok = code == c["code"] and dt < LADDER_BOUND[0] and dr < LADDER_BOUND[1]
        print(f"[ladder] {case} (prior {c['prior_yaw_deg']:g} deg, "
              f"{c['prior_shift_m']:g} m, model age {c['model_age']}): code "
              f"{code} (reference {c['code']}), T_rel {dt * 100:.3f} cm / "
              f"{dr:.4f} deg from the reference's; {icp.calls} ICP runs, the "
              f"yaw sweep ran {sweep} of its {seeds} seeds; {ms:.1f} ms",
              flush=True)
        out_cases[case] = {"code": code, "reference_code": c["code"],
                           "dt_m": dt, "dr_deg": dr, "ms": ms,
                           "icp_runs": icp.calls, "sweep_seeds": sweep,
                           "ok": ok}
    return {"warm_codes": warm_codes, "cases": out_cases}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=None, help="also write a JSON record")
    args = ap.parse_args()

    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "mulls_tpu_torch", "csrc")):
        return fail("mulls_tpu_torch/ is not beside this script: run it from "
                    "a checkout of the repository", 2)
    sys.path.insert(0, here)

    # --- phase 1: device
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: no card")
    dev = torch.device("cuda", 0)

    import mulls_tpu_torch  # noqa: F401  (sets the fp32 matmul flags)
    from mulls_tpu_torch.config import MullsConfig
    from mulls_tpu_torch.ops import kernels
    from mulls_tpu_torch.tools.roofline import card_line
    card = card_line(dev)
    print(card, flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}: {torch.cuda.get_device_name(0)}"
          f" x {torch.cuda.device_count()}", flush=True)

    # --- phase 2: build
    t0 = time.perf_counter()
    info = kernels.build_kernels()
    kernels.library()
    print(f"[build] kernels {'built' if info['built'] else 'found'} in "
          f"{time.perf_counter() - t0:.2f} s: {info['path']}", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"[build] {line.strip()}", flush=True)

    # synthetic world and scans (set-up, numpy from the seed)
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    world = make_world(rng)
    gt = trajectory(FRAMES)
    n_raw = MullsConfig().shapes.n_raw
    frames = [render_scan(world, T, n_raw, rng) for T in gt]
    counts = [int(f["mask"].sum()) for f in frames]
    print(f"[data] {FRAMES} scans, valid points min {min(counts)} max "
          f"{max(counts)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    if min(counts) < 100_000:
        return fail("a scan has fewer than 100k valid points")

    # --- phase 3: kernels vs plain, single and batched
    try:
        rows = kernel_phase(frames[0], world, gt[0], dev, SEED)
        batched = batched_kernel_phase(frames[0], dev, SEED)
    except AssertionError as e:
        return fail(f"kernel check: {e}")

    # --- phase 4: the roofline probe
    try:
        probe = probe_phase(frames[0], dev, SEED)
    except AssertionError as e:
        return fail(f"probe check: {e}")

    # --- phase 5: main path, twice from the same seed: the same bits
    main_res = main_phase(frames, gt, dev)
    launches = main_res["launches"]
    again = main_phase(frames, gt, dev)
    repeat_equal = bool(np.array_equal(main_res["poses"], again["poses"]))
    print(f"[main] two runs from seed {SEED}: end errors "
          f"{main_res['end_err_m']!r} m and {again['end_err_m']!r} m; poses "
          f"{'equal bit for bit' if repeat_equal else 'differ'}", flush=True)
    # --- phase 11: the baselines (profiled: before the threaded SLAM runs)
    try:
        baseline = baseline_phase(frames, gt, dev, SEED)
    except AssertionError as e:
        return fail(f"slice check: {e}")
    # --- phase 6: card against CPU; phase 7: time breakdown
    agree = agree_phase(dev, SEED)
    prof = profile_phase(frames, MullsConfig(), dev)
    # --- phase 12: the CLI, SLAM under its own trace
    tmp_dir = tempfile.TemporaryDirectory()
    try:
        cli = cli_phase(frames, tmp_dir.name)
        # --- phase 13: the pairwise-registration CLI, every coarse mode
        t0 = time.perf_counter()
        reg = reg_phase(frames, gt, dev, tmp_dir.name)
        print(f"[reg] phase {time.perf_counter() - t0:.1f} s", flush=True)
    except AssertionError as e:
        tmp_dir.cleanup()
        return fail(f"slice check: {e}")
    # --- phase 8: SLAM with loop closure; the m2m nn shapes from its bank;
    # phase 9: SLAM on the card against the CPU
    slam = slam_phase(dev, SEED, main_res["fps"])
    try:
        m2m = m2m_nn_check(slam, dev)
    except AssertionError as e:
        return fail(f"kernel check: {e}")
    try:
        slam_bits = slam_bits_check(slam, dev)
    except AssertionError as e:
        return fail(f"slice check: {e}")
    agree_slam = agree_slam_phase(dev, SEED)
    # --- phase 10: the SLAM run's map
    try:
        assembly = assembly_phase(slam.pop("scans"), slam["poses"], dev,
                                  tmp_dir.name)
        # --- phase 14: two SLAM sessions merged by the map-merge CLI
        t0 = time.perf_counter()
        merge = merge_phase(world, dev, tmp_dir.name)
        print(f"[merge] phase {time.perf_counter() - t0:.1f} s", flush=True)
        # --- phase 15: multi-sequence odometry; phase 16: the fleet CLI,
        # the native reader, format_transform and two ranks on the card
        t0 = time.perf_counter()
        multiseq = multiseq_phase(world, dev)
        print(f"[multiseq] phase {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        fleet = fleet_phase(frames, gt, dev, tmp_dir.name)
        print(f"[fleet] phase {time.perf_counter() - t0:.1f} s", flush=True)
        # --- phase 17: the recovery ladder against the reference's record
        t0 = time.perf_counter()
        ladder = ladder_phase(dev)
        print(f"[ladder] phase {time.perf_counter() - t0:.1f} s", flush=True)
    except AssertionError as e:
        return fail(f"slice check: {e}")
    finally:
        tmp_dir.cleanup()
    kernels_line = []
    by_name = {}
    for r in rows:
        by_name.setdefault(r["name"], []).append(r)
    replaces = {"nn": "mulls_tpu/ops/kernels.py:111",
                "nn_grouped": "mulls_tpu/ops/kernels.py:111",
                "moments": "mulls_tpu/ops/kernels.py:197",
                "pca_moments": "mulls_tpu/ops/kernels.py:317"}
    for name, rs in by_name.items():
        r = rs[0]  # the first (largest) main-path shape
        kernels_line.append({
            "name": name, "route": "cuda",
            "source": "mulls_tpu_torch/csrc/"
                      f"{'nn' if name == 'nn_grouped' else name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(x["max_abs_err"] for x in rs),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "slam_launches": slam["launches"][name]})
        if name == "pca_moments":
            # the GICP source covariances' shape and the gicp run's launches
            kernels_line[-1]["gicp"] = {
                k: baseline["gicp_pca"][k] for k in (
                    "shape", "ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "max_abs_err", "launches")}
        if name == "nn_grouped":
            # the back end's shapes: one m2m ICP iteration, its launches
            # those of the SLAM run's back end
            kernels_line[-1]["m2m"] = {
                k: m2m[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by")}
            kernels_line[-1]["m2m"]["launches"] = \
                slam["backend_launches"]["nn_grouped"]
            # one iteration of a heading seed of the reg CLI's yaw4dof
            kernels_line[-1]["yaw4dof"] = reg["sweep_nn_grouped"]
        if name == "nn":
            # FPFH-SAC's scoring call in the reg CLI's fpfh mode
            kernels_line[-1]["sac_ia"] = reg["sac_ia_nn"]
        if name in batched:
            # one launch for BATCH_S sequences (the kernel phase), with the
            # launches a sequence-frame of phase 15's batches of 8 and 1
            rate = multiseq["rates"]
            kernels_line[-1][f"batched_s{BATCH_S}"] = dict(
                batched[name], launches_per_sequence_frame=rate[
                    str(BATCH_S)]["launches_per_sequence_frame"][name],
                launches_per_sequence_frame_s1=rate["1"][
                    "launches_per_sequence_frame"][name])
    # the probe's kernels: count_within at the map assembly's shape with the
    # filter's launches (the probe's run kept as a record), adj_stack with
    # the probe's own
    for e in probe["entries"]:
        if e["name"] == "count_within":
            e["probe"] = {k: e[k] for k in ("shape", "ms", "call_device_ms",
                                            "event_ms", "plain_ms",
                                            "library_ms", "bound_ms",
                                            "bound_by", "candidate_pairs",
                                            "launches")}
            e.update({k: assembly[k] for k in (
                "shape", "ms", "call_device_ms", "event_ms", "index_ms",
                "plain_ms", "library_ms", "bound_ms", "bound_by",
                "candidate_pairs", "brute_force_bound_ms", "launches",
                "filter_call")})
        kernels_line.append(e)
    # the launches of the reg CLI (all six modes), of the merge CLI and of
    # the multi-sequence check's sequences (phase 15, summed)
    for e in kernels_line:
        e["reg_launches"] = reg["launches"].get(e["name"], 0)
        e["merge_launches"] = merge["launches"].get(e["name"], 0)
        e["multiseq_launches"] = sum(x.get(e["name"], 0)
                                     for x in multiseq["launches"])
    # device times that came from traces which lost events (device_ms took
    # the mean of the launches they kept), listed on each kernel's row
    from mulls_tpu_torch.tools.roofline import PARTIAL_TRACES
    for e in kernels_line:
        base = "nn_grouped" if e["name"] == "nn" else e["name"]
        partial = [t for t in PARTIAL_TRACES
                   if re.search(rf"\b{base}_kernel\b", t["kernel"])]
        if partial:
            e["device_ms_from_partial_traces"] = [
                {k: t[k] for k in ("kept", "calls", "ms", "clock")}
                for t in partial]
    if PARTIAL_TRACES:
        print(f"[timing] {len(PARTIAL_TRACES)} device times from traces "
              f"that lost events, marked on their kernels' rows", flush=True)

    problems = []
    if not repeat_equal:
        problems.append(f"two main runs from seed {SEED} differ: end errors "
                        f"{main_res['end_err_m']} and {again['end_err_m']}")
    if assembly["launches"] <= 0:
        problems.append("the map filter launched no count_within")
    for name in MAIN_KERNELS:  # the four counters of the main path
        k = launches[name]
        if k <= 0:
            problems.append(f"kernel {name} was not launched on the main "
                            f"path")
    # one grouped launch per ICP iteration and one for dynamic removal:
    # ~23 a frame on this run, 115.5 when each class launched on its own
    if launches["nn"] > 30 * main_res["frames"]:
        problems.append(f"nn launched {launches['nn']} times in "
                        f"{main_res['frames']} frames, above 30 a frame")
    after_first = main_res["codes"][1:]
    healthy = sum(1 for c in after_first if c == 1)
    if healthy < 0.9 * len(after_first):
        problems.append(f"only {healthy}/{len(after_first)} frames after "
                        f"the first registered with code 1")
    if not np.all(np.isfinite(main_res["sigmas"])):
        problems.append("non-finite sigma")
    # a tracking check, not an accuracy claim: the synthetic street is
    # well constrained, and drift above 2 % means registration went wrong
    if not main_res["end_err_m"] <= 0.02 * main_res["dist_m"]:
        problems.append(f"end translation error {main_res['end_err_m']} m "
                        f"over {main_res['dist_m']} m is above 2 %")
    # card vs CPU, the bound of the JAX-vs-port parity tests.  The stage
    # isolation above shows where the two part: registration on the same
    # features agrees to ~1e-6 m, and the map update exactly.  In the
    # feature stage, the closed-form eigh's arccos near repeated
    # eigenvalues turns last-ulp differences of the card's math functions
    # into curvature and linearity differences of ~1e-4.  Those reorder
    # the curvature top-k and flip NMS picks, so a few of the 128 pillar
    # points differ per frame.  At this width that moves a frame by up to
    # ~1 cm, half the bound, and does so the same way on every run.
    if agree["codes_card"] != agree["codes_cpu"]:
        problems.append("card and CPU codes differ at the small width")
    if not (agree["max_dt_m"] < 0.02 and agree["max_dr_deg"] < 0.2):
        problems.append(f"card and CPU motion differ by {agree['max_dt_m']} "
                        f"m / {agree['max_dr_deg']} deg")

    # the SLAM path: every kernel of the front end launched during it, and
    # the back end's own map-to-map searches
    for name in MAIN_KERNELS:
        k = slam["launches"][name]
        if k <= 0:
            problems.append(f"kernel {name} was not launched on the SLAM "
                            f"path")
    if slam["backend_launches"]["nn"] <= 0:
        problems.append("the back end launched no nn kernel")
    s_after = slam["codes"][1:]
    if sum(1 for c in s_after if c == 1) < 0.9 * len(s_after):
        problems.append(f"SLAM: {len(slam['bad'])} of {len(s_after)} frames "
                        f"after the first without code 1")
    if slam["adjacent"] != slam["submaps"] - 1:
        problems.append(f"SLAM: {slam['adjacent']} adjacent edges for "
                        f"{slam['submaps']} submaps")
    if not slam["loops"]:
        problems.append("SLAM: no loop edge")
    for lp in slam["loops"]:
        if not lp["t_err_m"] <= LOOP_EDGE_BOUND_M:
            problems.append(f"SLAM: loop edge {lp['i']}->{lp['j']} is "
                            f"{lp['t_err_m']} m from the ground truth, above "
                            f"{LOOP_EDGE_BOUND_M} m")
    if slam["pgo_accepted"] < 1:
        problems.append("SLAM: no PGO accepted")
    if not slam["end_err_m"] <= 0.02 * slam["dist_m"]:
        problems.append(f"SLAM: end error {slam['end_err_m']} m over "
                        f"{slam['dist_m']} m is above 2 %")
    # card against CPU at small width: the bounds of the CPU parity test
    # between the port and the reference (tests/test_torch_slam.py).  On
    # this world's fast turning loop a few features per frame flip between
    # the two (the feature stage's closed-form eigh, see the agree phase
    # above), which moves a frame by centimetres and accumulates along the
    # trajectory
    if (agree_slam["spans_card"] != agree_slam["spans_cpu"]
            or agree_slam["edges_card"] != agree_slam["edges_cpu"]):
        problems.append("SLAM on the card and on the CPU: different submap "
                        "spans or edges")
    if not (agree_slam["rel_dt_m"] < 0.05 and agree_slam["rel_dr_deg"] < 0.5
            and agree_slam["pose_dt_m"] < 0.1
            and agree_slam["pose_dr_deg"] < 1.0):
        problems.append(f"SLAM on the card and on the CPU: per-frame motion "
                        f"differs by {agree_slam['rel_dt_m']} m / "
                        f"{agree_slam['rel_dr_deg']} deg, poses by "
                        f"{agree_slam['pose_dt_m']} m / "
                        f"{agree_slam['pose_dr_deg']} deg")

    # the recovery ladder at full width: the reference's codes, and its
    # motion within the parity tests' bound
    for case, c in ladder["cases"].items():
        if not c["ok"]:
            problems.append(f"ladder {case}: code {c['code']} (reference "
                            f"{c['reference_code']}), T_rel {c['dt_m']} m / "
                            f"{c['dr_deg']} deg from the reference's")

    # multi-sequence odometry: each sequence as its run alone, healthy,
    # and its own launches of the front end's kernels
    for s, rec in enumerate(multiseq["sequences"]):
        if not rec["equal_alone"]:
            problems.append(f"multiseq sequence {s} differs from its run "
                            f"alone (T_rel max |d| {rec['max_rel_dt_m']} m)")
        if rec["ok_after_first"] < 0.9 * (rec["frames"] - 1):
            problems.append(f"multiseq sequence {s}: codes {rec['codes']}")
        for name in ("nn_grouped", "moments", "pca_moments"):
            if rec["launches"][name] <= 0:
                problems.append(f"multiseq sequence {s} launched no {name}")
    if [r["frames"] for r in multiseq["sequences"]] != multiseq["frames"]:
        problems.append("multiseq results are not truncated to each "
                        "sequence's length")
    # the batch: each kernel launched once for the 8 sequences of a step,
    # so ~1/8 of one sequence's launches a sequence-frame; fewer device
    # operations; no more host syncs than 8 single frames
    r1 = multiseq["rates"]["1"]["launches_per_sequence_frame"]
    r8 = multiseq["rates"]["8"]["launches_per_sequence_frame"]
    for name in ("nn_grouped", "moments", "pca_moments"):
        if not 0 < r8[name] <= 1.25 * r1[name] / 8:
            problems.append(f"multiseq: {name} launched {r8[name]} times a "
                            f"sequence-frame at S = 8, {r1[name]} at S = 1")
    b1, b8 = multiseq["busy"].get("1"), multiseq["busy"].get("8")
    if b1 and b8:
        if not (b8["device_ops_per_sequence_frame"]
                < 0.5 * b1["device_ops_per_sequence_frame"]):
            problems.append(f"multiseq: {b8['device_ops_per_sequence_frame']}"
                            f" device operations a sequence-frame at S = 8, "
                            f"{b1['device_ops_per_sequence_frame']} at S = 1")
        if not (b8["host_syncs_per_batched_frame"]
                <= 8 * b1["host_syncs_per_batched_frame"]):
            problems.append(f"multiseq: {b8['host_syncs_per_batched_frame']}"
                            f" host syncs a batched frame at S = 8, above 8 x"
                            f" {b1['host_syncs_per_batched_frame']}")

    if args.out:
        slam_rec = {k: v for k, v in slam.items()
                    if k not in ("backend", "cfg", "poses", "loop_boundary")}
        main_res.pop("poses")
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": kernels_line,
                       "kernel_rows": rows, "probe": probe, "main": main_res,
                       "agree": agree, "profile": prof, "slam": slam_rec,
                       "m2m_nn": m2m, "agree_slam": agree_slam,
                       "assembly": assembly, "baseline": baseline,
                       "cli": cli, "reg": reg, "merge": merge,
                       "multiseq": multiseq, "fleet": fleet,
                       "slam_bits": slam_bits, "ladder": ladder,
                       "main_repeat_end_err_m":
                       again["end_err_m"]}, f, indent=1, default=float)
    if problems:
        for p in problems:
            print(f"[FAIL] {p}", flush=True)
        return 1
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
