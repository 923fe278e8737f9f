"""Multi-sequence odometry — port of ``mulls_tpu/parallel/multiseq.py``.

The frame-to-frame dependency caps one trajectory's parallelism, so
throughput beyond one sequence comes from running MANY trajectories at
once: one odometry state per sequence, the sequences on the mesh's
entries in contiguous blocks (the reference's ``P("data")``), stepping in
lockstep segments.  This is the offline / fleet mode, e.g. all 11 KITTI
odometry sequences in one run.

The reference ``vmap``s its step over the sequence axis.  The port's step
cannot go under a ``vmap`` (host ``if``s on 0-d tensors, ctypes kernels),
so a process steps its sequences in turn, frame by frame, on the current
stream, with the port's own :func:`slam_step`; each sequence's results
equal a run of that sequence alone (``OdometryPipeline`` with the same
config and draws).  Every step syncs the host at its own ``if``s, so
per-sequence streams would have nothing to overlap: several sequences on
one card share it only through their host gaps (``PERF.md`` §6).

One host thread a sequence was tried first and measured on the H100: the
step is Python-bound, and the threads' hand-offs of the GIL at every
operator made 4 and 8 sequences 5x slower in aggregate than one
(``PERF.md`` §6).  Host work runs in parallel across processes: a
process group (``parallel/distributed.py``, gloo when ranks share a card)
gives each rank its block of the sequences.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from mulls_tpu_torch.config import MullsConfig
from mulls_tpu_torch.core.draws import Draws
from mulls_tpu_torch.ops import kernels
from mulls_tpu_torch.parallel.mesh import Mesh
from mulls_tpu_torch.pipeline.odometry import (OdometryResult, init_state,
                                               prefetch_frames,
                                               results_from_vecs, slam_step)


class _Sequence:
    """One sequence's state, frame feed, results and launches."""

    def __init__(self, pipe: "MultiSeqPipeline", s: int, dataset,
                 dev: torch.device, draws: Optional[Draws]):
        cfg = pipe.cfg
        self.n = len(dataset)
        self.state = init_state(cfg.replace(seed=cfg.seed + s), dev,
                                draws=draws)
        self.frames = prefetch_frames(
            dataset, dev, with_ts=cfg.map.motion_compensation_method == 1,
            segment=pipe.segment)
        self.pending: List[torch.Tensor] = []
        self.parts: List[np.ndarray] = []
        self.launches = dict.fromkeys(kernels.launch_counts(), 0)

    def step(self, cfg: MullsConfig) -> None:
        with kernels.count_launches() as rec:
            self.state, out = slam_step(self.state, next(self.frames), cfg)
            self.pending.append(out.vec)
        for name, k in rec.items():
            self.launches[name] += k

    def fetch(self) -> None:
        """The segment's one device-to-host copy."""
        if self.pending:
            self.parts.append(torch.stack(self.pending).cpu().numpy())
            self.pending = []

    def vecs(self) -> np.ndarray:
        return (np.concatenate(self.parts) if self.parts
                else np.zeros((0, 16), np.float32))


class MultiSeqPipeline:
    """Runs S sequences in lockstep segments, the sequences on the mesh's
    entries in contiguous blocks.  S must be a multiple of the mesh size;
    a sequence shorter than the longest stops at its end (the reference
    replays its last frame and truncates: the same results).

    Like the reference it turns off the in-frame recovery ladder and the
    mover veto (their extra ICPs ran for every sequence under the
    reference's ``vmap``), and keeps two configs: the warm one for
    segments that start inside the scan-to-scan warm-up
    (``i <= initial_scan2scan_frame_num``), the steady one, with
    ``warmup_s2s_on=False``, for the rest.

    After :meth:`run`, ``launches`` holds each of this process's
    sequences' kernel launch counts."""

    def __init__(self, cfg: MullsConfig, mesh: Mesh, segment: int = 16):
        cfg = cfg.replace(map=dataclasses.replace(
            cfg.map, inframe_recovery_on=False,
            dynamic_sanity_veto_on=False))
        self.cfg = cfg
        self.cfg_steady = cfg.replace(map=dataclasses.replace(
            cfg.map, warmup_s2s_on=False))
        self.mesh = mesh
        self.segment = segment
        self.launches: List[dict] = []

    def run(self, datasets: List, progress: bool = False,
            draws: Optional[Sequence[Draws]] = None,
            on_segment: Optional[Callable[[int], None]] = None
            ) -> List[OdometryResult]:
        """One result per dataset, in order (every rank gets all of them).
        ``draws``: one ``Draws`` per sequence (default: sequence s draws
        from a generator seeded with ``cfg.seed + s``, as the reference
        seeds its key).  ``on_segment(frames)``, when given, runs at the
        end of each lockstep segment, after every sequence of this process
        has fetched its results (a sync), with the frame
        count done: the hook a measurement brackets a steady window with."""
        S = len(datasets)
        n_mesh = self.mesh.size
        if S % n_mesh != 0:
            raise ValueError(f"{S} sequences on {n_mesh} devices: the "
                             f"sequence count must be a multiple of the "
                             f"mesh size")
        n_max = max(len(d) for d in datasets)
        mine = [(s, dev) for dev, (lo, hi) in zip(self.mesh.devices,
                                                  self.mesh.blocks(S))
                for s in range(lo, hi)]
        seqs: List[_Sequence] = []
        try:
            for s, dev in mine:
                seqs.append(_Sequence(self, s, datasets[s], dev,
                                      None if draws is None else draws[s]))
            warm_lim = self.cfg.map.initial_scan2scan_frame_num
            for i0 in range(0, n_max, self.segment):
                cfg = self.cfg if i0 <= warm_lim else self.cfg_steady
                done = min(i0 + self.segment, n_max)
                for i in range(i0, done):
                    for seq in seqs:
                        if i < seq.n:
                            seq.step(cfg)
                for seq in seqs:
                    seq.fetch()
                if on_segment is not None:
                    on_segment(done)
                if progress:
                    print(f"[multiseq {done}/{n_max}] x{len(seqs)} "
                          f"sequences", flush=True)
        finally:
            for seq in seqs:
                seq.frames.close()
        self.launches = [seq.launches for seq in seqs]
        out = [results_from_vecs(seq.vecs()) for seq in seqs]
        if self.mesh.world_size > 1:
            import torch.distributed as dist
            parts: list = [None] * self.mesh.world_size
            dist.all_gather_object(parts, out, group=self.mesh.group)
            out = [r for part in parts for r in part]
        return out
