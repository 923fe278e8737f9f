"""Full SLAM pipeline: front-end odometry + submap back end (loop closure,
PGO) — port of ``mulls_tpu/pipeline/slam.py`` (SURVEY.md §3.1-3.2).

The front end is the port's ``slam_step``, one frame at a time on the
main thread.  Every ``segment`` frames the host hands the segment (its
packed per-frame results, still on the card, and the local map at its
end) to a segment worker thread, which fetches the results, chains the
poses and runs the back end's bookkeeping; a submap boundary's expensive
ladder (adjacent m2m, loop candidates, PGO) runs on a boundary thread.
A boundary's corrections are folded in only at the next boundary, a
checkpoint or the end of the run — the reference's strict one-boundary
lag, which keeps the trajectory independent of thread timing.  Nothing
flows back from the back end into the front end.

All threads issue their device work to the same CUDA stream (the
default one), so the bank and the front end's tensors need no
cross-stream synchronization.  The local map the front end produces is
new tensors every frame, so a segment keeps a reference to it instead of
a copy.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from mulls_tpu_torch.backend.submap import REG_EDGE, SlamBackend
from mulls_tpu_torch.config import MullsConfig
from mulls_tpu_torch.core import trace
from mulls_tpu_torch.core.device import resolve_device
from mulls_tpu_torch.core.draws import Draws, GeneratorDraws
from mulls_tpu_torch.pipeline.odometry import (STAGE_COLUMNS,
                                               OdometryResult, StepOut,
                                               init_state, prefetch_frames,
                                               slam_step)


class _View:
    """Dataset slice view for resume offsets."""

    def __init__(self, ds, start):
        self.ds, self.start = ds, start

    def __len__(self):
        return len(self.ds) - self.start

    def __getitem__(self, k):
        return self.ds[self.start + k]


class SlamPipeline:
    """``draws``: the back end's random stream, split once per boundary as
    the reference splits ``jax.random.key(cfg.seed + 1)`` (default: a
    generator seeded from ``cfg.seed + 1``); ``frontend_draws``: the front
    end's (default: ``init_state``'s, seeded from ``cfg.seed``)."""

    def __init__(self, cfg: MullsConfig, segment: int = 8,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 8,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every: int = 4, device="cuda",
                 draws: Optional[Draws] = None,
                 frontend_draws: Optional[Draws] = None):
        self.cfg = cfg
        self.segment = segment
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every  # in segments
        # every `snapshot_every` submaps a WebGL artifact of the current
        # map / trajectory / edges is written on a background thread
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = snapshot_every
        self.device = resolve_device(device)
        self.draws = (draws if draws is not None
                      else GeneratorDraws(cfg.seed + 1, self.device))
        self.frontend_draws = frontend_draws

    def _next_draws(self) -> Draws:
        self.draws, d = self.draws.split(2)
        return d

    def run(self, dataset, progress: bool = False,
            stage_timing: bool = False) -> OdometryResult:
        """``stage_timing``: per-frame feature / map / reg stage times in
        ms (a sync around each stage) and synchronous boundaries."""
        cfg = self.cfg
        dev = self.device
        n = len(dataset)
        state = init_state(cfg, dev, draws=self.frontend_draws)
        backend = SlamBackend(cfg, dev)
        poses = np.tile(np.eye(4), (n, 1, 1))
        poses_odom = np.tile(np.eye(4), (n, 1, 1))  # pure odometry chain
        codes: List[int] = []
        sigmas: List[float] = []
        frame_submap = np.full(n, -1, np.int32)  # submap id per frame
        submap_open_begin = 0
        cur_pose = np.eye(4)
        cur_pose_odom = np.eye(4)
        timings = np.zeros((n, 4), np.float64)

        # resume from a checkpoint if one exists (SURVEY.md §5.4)
        i = 0
        seg_count = 0
        if self.checkpoint_path:
            from mulls_tpu_torch.pipeline.checkpoint import load_checkpoint
            ck = load_checkpoint(self.checkpoint_path, cfg, dev,
                                 draws=state.draws,
                                 backend_draws=self.draws)
            if ck is not None and 0 < ck["frame_idx"] <= n:
                state = ck["state"]
                if ck.get("backend") is not None:
                    backend = ck["backend"]
                i = ck["frame_idx"]
                m = min(i, len(ck["poses"]))
                poses[:m] = ck["poses"][:m]
                poses_odom[:m] = ck["poses_odom"][:m]
                codes = list(ck["codes"])[:m]
                sigmas = list(ck["sigmas"])[:m]
                cur_pose = poses[i - 1].copy()
                cur_pose_odom = poses_odom[i - 1].copy()
                submap_open_begin = (backend.submaps[-1].frame_end + 1
                                     if backend.submaps else 0)
                for s in backend.submaps:
                    frame_submap[s.frame_begin:s.frame_end + 1] = s.sid
                print(f"[mulls_tpu_torch] resumed at frame {i} "
                      f"({len(backend.submaps)} submaps)")

        def _boundary_start(lmap, seg_end):
            """Synchronous part of a boundary: snapshot the local map into
            the bank + span bookkeeping; also snapshots the drift counter
            so the ladder's large-drift gates read its value at this
            frame, whenever the boundary thread gets to run."""
            nonlocal submap_open_begin
            last = seg_end - 1
            sm = backend.add_submap(lmap, poses[last], submap_open_begin,
                                    last)
            frame_submap[submap_open_begin:seg_end] = sm.sid
            submap_open_begin = seg_end
            old_poses = np.stack([s.pose for s in backend.submaps])
            return sm, old_poses, backend.frames_wo_opt

        def _boundary_finish(old_poses, b_end, frames_wo_opt):
            """The boundary ladder (`mulls_slam.cpp:451-628`): adjacent
            m2m + loop candidates + PGO; returns a correction record for
            _apply_boundary."""
            new_poses = backend.on_new_submap(self._next_draws(),
                                              frames_wo_opt=frames_wo_opt)
            if new_poses is not None:
                # per-submap rigid corrections against the poses the stored
                # frames were chained from (captured before the ladder)
                corr = np.stack([newp @ np.linalg.inv(old_poses[s.sid])
                                 for s, newp in zip(backend.submaps,
                                                    new_poses)])
                return ("pgo", b_end, corr)
            # no PGO: the adjacent m2m may still have nudged the newest
            # submap pose (`mulls_slam.cpp:489-498`)
            return ("nudge", b_end, backend.submaps[-1].pose.copy())

        def _apply_boundary(res, now_end):
            """Fold a finished boundary's corrections into the trajectory;
            frames chained after the boundary composed from the
            uncorrected tail pose, so the newest submap's correction
            applies to them too (`mulls_slam.cpp:614-623`)."""
            nonlocal cur_pose
            kind, b_end, data = res
            if kind == "pgo":
                # the drift counter resets at the accepted boundary
                backend.frames_wo_opt = max(now_end - b_end, 0)
                for sid in range(len(data)):
                    mask = frame_submap[:b_end] == sid
                    if not mask.any():
                        continue
                    poses[:b_end][mask] = np.einsum(
                        "ij,njk->nik", data[sid], poses[:b_end][mask])
                tail_corr = data[-1]
                if now_end > b_end:
                    poses[b_end:now_end] = np.einsum(
                        "ij,njk->nik", tail_corr, poses[b_end:now_end])
                cur_pose = tail_corr @ cur_pose
            else:
                last = b_end - 1
                ref_pose = data
                if not np.allclose(ref_pose, poses[last]):
                    corr = ref_pose @ np.linalg.inv(poses[last])
                    poses[last:now_end] = np.einsum(
                        "ij,njk->nik", corr, poses[last:now_end])
                    cur_pose = corr @ cur_pose

        def _boundary(lmap, seg_end):
            """A synchronous boundary (staged path + end-of-run flush)."""
            sm, old_poses, fwo = _boundary_start(lmap, seg_end)
            _apply_boundary(_boundary_finish(old_poses, seg_end, fwo),
                            seg_end)
            return sm

        pending = None  # in-flight boundary ladder (a Future)
        boundary_pool = None  # its executor; None: synchronous boundaries

        def _process(entry):
            """Host bookkeeping + back end for ONE completed segment."""
            nonlocal cur_pose, cur_pose_odom, pending
            i0, k_real, vecs_dev, lmap = entry
            seg_end = i0 + k_real
            t0 = time.perf_counter()
            with trace.sync("fetch"):  # waits for the segment
                vecs_np = vecs_dev.cpu().numpy()
            if not stage_timing:
                timings[i0:seg_end, 2] = (time.perf_counter() - t0) * 1e3 \
                    / k_real
            T_rels, seg_sigma, seg_codes, seg_conf, _ = StepOut.unpack_vecs(
                vecs_np)
            for k in range(i0, seg_end):
                T = T_rels[k - i0]
                u, _, vt = np.linalg.svd(T[:3, :3])
                T[:3, :3] = u @ vt
                if k > 0:
                    cur_pose = cur_pose @ T
                    cur_pose_odom = cur_pose_odom @ T
                poses[k] = cur_pose
                poses_odom[k] = cur_pose_odom
                codes.append(int(seg_codes[k - i0]))
                sigmas.append(float(seg_sigma[k - i0]))
                if k > 0:
                    backend.accumulate(T, confidence=seg_conf[k - i0])

            # back end at the segment boundary (`mulls_slam.cpp:451-628`);
            # the NEXT boundary waits for this one's ladder
            tb0 = time.perf_counter()
            if backend.should_segment():
                if pending is not None:
                    # deterministic one-boundary lag: block for the
                    # previous ladder here, whether or not it finished
                    _apply_boundary(pending.result(), seg_end)
                    pending = None
                sm, old_poses, fwo = _boundary_start(lmap, seg_end)
                if boundary_pool is not None:
                    pending = boundary_pool.submit(_boundary_finish,
                                                   old_poses, seg_end, fwo)
                else:
                    _apply_boundary(
                        _boundary_finish(old_poses, seg_end, fwo), seg_end)
                if (self.snapshot_dir
                        and sm.sid % max(self.snapshot_every, 1) == 0):
                    self._snapshot(backend, sm, poses[:seg_end, :3, 3].copy())
            timings[i0:seg_end, 3] = (time.perf_counter() - tb0) * 1e3 \
                / k_real
            if progress:
                print(f"[{seg_end}/{n}] submaps={len(backend.submaps)} "
                      f"edges={len(backend.edges)} "
                      f"sigma={sigmas[-1]:.4f}", flush=True)

        def _drain_pending(now_end):
            nonlocal pending
            if pending is not None:
                _apply_boundary(pending.result(), now_end)
                pending = None

        def _checkpoint(frame_idx):
            from mulls_tpu_torch.pipeline.checkpoint import save_checkpoint
            save_checkpoint(self.checkpoint_path, state, frame_idx, poses,
                            poses_odom, codes, sigmas, backend, self.draws)

        ship_ts = cfg.map.motion_compensation_method == 1
        frames = prefetch_frames(_View(dataset, i), dev, with_ts=ship_ts)
        if stage_timing:
            seg_vecs, i0 = [], i
            with trace.StageClock(dev, STAGE_COLUMNS) as clock:
                for raw in frames:
                    state, out = slam_step(state, raw, cfg)
                    timings[i, :3] = clock.lap()
                    seg_vecs.append(out.vec)
                    i += 1
                    if len(seg_vecs) == self.segment or i == n:
                        _process((i0, len(seg_vecs), torch.stack(seg_vecs),
                                  state.local_map))
                        seg_vecs, i0 = [], i
                        seg_count += 1
        else:
            # ALL segment post-processing (the fetch of the segment's
            # results, pose chaining, the back end) runs on ONE worker
            # thread consuming segments in order, so the main thread keeps
            # issuing frames; the bounded queue gives backpressure
            jobs: "queue.Queue" = queue.Queue(maxsize=4)
            w_err: List[BaseException] = []
            boundary_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="mulls-boundary")

            def _worker():
                while True:
                    item = jobs.get()
                    try:
                        if item is not None and not w_err:
                            _process(item)
                    except BaseException as e:  # surfaced in the main thread
                        w_err.append(e)
                    finally:
                        jobs.task_done()
                    if item is None:
                        return

            th = threading.Thread(target=_worker, daemon=True)
            th.start()
            try:
                seg_vecs, i0 = [], i
                for raw in frames:
                    state, out = slam_step(state, raw, cfg)
                    seg_vecs.append(out.vec)
                    if len(seg_vecs) < self.segment and i0 + len(
                            seg_vecs) < n:
                        continue
                    jobs.put((i0, len(seg_vecs), torch.stack(seg_vecs),
                              state.local_map))
                    i = i0 + len(seg_vecs)
                    seg_vecs, i0 = [], i
                    seg_count += 1
                    if w_err:
                        break
                    if self.checkpoint_path and \
                            seg_count % self.checkpoint_every == 0:
                        jobs.join()  # drain: the checkpoint must match i
                        if w_err:
                            break
                        _drain_pending(i)  # corrections folded in
                        _checkpoint(i)
            finally:
                frames.close()
                jobs.put(None)
                th.join()
                try:
                    _drain_pending(i)
                finally:
                    boundary_pool.shutdown(wait=True)
            if w_err:
                raise w_err[0]

        # end-of-run flush of the open span as a final (partial) submap
        # through the regular boundary ladder, so a revisit inside the last
        # open span still earns its loop edge (`mulls_slam.cpp:823-876`)
        if backend.submaps and backend._accu_frames > 0 and i > 0:
            _boundary(state.local_map, i)

        if self.checkpoint_path:
            # final checkpoint: the completed session
            _checkpoint(n)

        res = OdometryResult(poses=poses, codes=codes, sigmas=sigmas,
                             timings=timings)
        res.backend = backend
        res.poses_odom = poses_odom
        res.frame_submap = frame_submap
        return res

    def _snapshot(self, backend, sm, traj) -> None:
        """A WebGL snapshot of the map, trajectory and pose graph, written
        on a daemon thread."""
        from mulls_tpu_torch.viz.html_viewer import write_run_snapshot
        os.makedirs(self.snapshot_dir, exist_ok=True)
        base = os.path.join(self.snapshot_dir, f"snapshot_{sm.sid:04d}")
        subs = list(backend.submaps)
        # viewer edges index into the trajectory: submap ids -> last frame
        fe = {s.sid: s.frame_end for s in subs}
        eds = [(fe[e.i], fe[e.j], e.kind) for e in backend.edges
               if e.i in fe and e.j in fe]
        threading.Thread(target=write_run_snapshot,
                         args=(base, subs, traj, eds), daemon=True).start()

    def refine(self, res: OdometryResult) -> np.ndarray:
        """End-of-run refinement: with ``framewise_pgo_on`` one graph over
        ALL frames (adjacent odometry edges + the loop edges remapped to
        their submaps' last frames, `mulls_slam.cpp:835-875`) on the
        pipeline's device; otherwise the inner-submap pass
        (`mulls_slam.cpp:876-927`).  Returns (and stores) the poses."""
        from mulls_tpu_torch.backend.refine import (framewise_pgo,
                                                    inner_submap_refine)
        backend = getattr(res, "backend", None)
        if backend is None or len(backend.submaps) < 1:
            return res.poses
        if self.cfg.submap.framewise_pgo_on:
            fe = {s.sid: s.frame_end for s in backend.submaps}
            reg = [(fe[e.i], fe[e.j], e.T, e.info)
                   for e in backend.edges if e.kind == REG_EDGE
                   and e.i in fe and e.j in fe]
            if reg:
                res.poses = framewise_pgo(
                    getattr(res, "poses_odom", res.poses), reg,
                    iterations=self.cfg.submap.pgo_max_iter,
                    device=self.device)
                return res.poses
            # no loop edges: fall through to the inner-submap pass
        bounds = [(s.frame_begin, s.frame_end) for s in backend.submaps]
        res.poses = inner_submap_refine(
            res.poses, res.poses_odom, bounds,
            iterations=self.cfg.submap.inner_refine_max_iter,
            t_limit=self.cfg.submap.inner_submap_t_limit,
            r_limit=self.cfg.submap.inner_submap_r_limit)
        return res.poses
