"""Multi-sequence odometry — port of ``mulls_tpu/parallel/multiseq.py``.

The frame-to-frame dependency caps one trajectory's parallelism, so
throughput beyond one sequence comes from running MANY trajectories at
once: one odometry state per sequence, the sequences on the mesh's
entries in contiguous blocks (the reference's ``P("data")``), stepping in
lockstep segments.  This is the offline / fleet mode, e.g. all 11 KITTI
odometry sequences in one run.

The reference ``vmap``s its step over the sequence axis.  The port's step
is written over a leading sequence axis instead (``pipeline/odometry.py``):
:func:`stack_states` stacks the S states of a mesh entry into one
``[S, ...]`` state, each frame's S packed scans are stacked into one
``[S, ...]`` batch, and :func:`slam_step` steps them as one, so every
operation and every kernel (``nn``, ``moments``, ``pca_moments``) is issued
once for the S sequences of an entry.  Each sequence's results equal a run
of that sequence alone (``OdometryPipeline`` with the same config and
draws) bit for bit: its draws come from its own stream
(``StackedDraws``), and the step's arithmetic adds in an order that does
not depend on the batch (``core/batch.py``).  ``torch.func.vmap`` is not
used: it would loop silently over any operator without a batching rule
(``segment_reduce``, for one), and it could not replay each sequence's own
generator.

One host thread a sequence was tried first and measured on the
H100: the step is Python-bound, and the threads' hand-offs of the GIL at
every operator made 4 and 8 sequences 5x slower in aggregate than one
(``PERF.md`` §6).  Host work runs in parallel across processes: a process
group (``parallel/distributed.py``, gloo when ranks share a card) gives
each rank its block of the sequences, which it steps as one batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from mulls_tpu_torch.config import MullsConfig
from mulls_tpu_torch.core import trace
from mulls_tpu_torch.core.draws import Draws, GeneratorDraws, StackedDraws
from mulls_tpu_torch.core.tree import tree_map
from mulls_tpu_torch.ops import kernels
from mulls_tpu_torch.parallel.mesh import Mesh
from mulls_tpu_torch.pipeline.odometry import (OdometryResult, SlamState,
                                               init_state, prefetch_frames,
                                               results_from_vecs, slam_step,
                                               stack_states)

__all__ = ["MultiSeqPipeline", "put_sharded", "stack_states"]


def put_sharded(tree, mesh: Mesh, n_items: int) -> list:
    """This process's blocks of a tree stacked over ``n_items`` (a leading
    axis on every tensor): for each of its mesh entries, the entry's
    contiguous block on the entry's device (the reference's
    ``put_sharded`` with ``P("data")``, ``multiseq.py:52-70``; every
    process holds the same whole and keeps its own blocks)."""
    return [tree_map(lambda a, lo=lo, hi=hi, d=dev: a[lo:hi].to(d), tree)
            for dev, (lo, hi) in zip(mesh.devices, mesh.blocks(n_items))]


class _Block:
    """One mesh entry's sequences: their stacked state, frame feeds,
    results and launches."""

    def __init__(self, pipe: "MultiSeqPipeline", state: SlamState,
                 datasets: list, dev: torch.device):
        self.state = state
        self.lens = [len(d) for d in datasets]
        with_ts = pipe.cfg.map.motion_compensation_method == 1
        self.feeds = [prefetch_frames(d, dev, with_ts=with_ts,
                                      segment=pipe.segment)
                      for d in datasets]
        self.last: list = [None] * len(datasets)
        self.pending: List[torch.Tensor] = []
        self.parts: List[np.ndarray] = []
        self.launches = dict.fromkeys(kernels.launch_counts(), 0)

    def step(self, cfg: MullsConfig, i: int) -> None:
        """Frame ``i`` of every sequence, as one batch: a sequence past its
        end replays its last frame (its results are cut to its length)."""
        for k, feed in enumerate(self.feeds):
            if i < self.lens[k]:
                self.last[k] = next(feed)
        with trace.span("step.stack"):
            raw = tree_map(lambda *xs: torch.stack(xs), *self.last)
        with kernels.count_launches() as rec, trace.span("step"):
            self.state, out = slam_step(self.state, raw, cfg, frame=i)
            self.pending.append(out.vec)
        for name in self.launches:
            self.launches[name] += rec[name]

    def fetch(self) -> None:
        """The segment's one device-to-host copy."""
        if self.pending:
            with trace.span("segment.fetch"), trace.sync("fetch"):
                self.parts.append(
                    torch.stack(self.pending, 1).cpu().numpy())
            self.pending = []

    def results(self) -> List[OdometryResult]:
        vecs = (np.concatenate(self.parts, 1) if self.parts
                else np.zeros((len(self.lens), 0, 16), np.float32))
        return [results_from_vecs(vecs[k, :n])
                for k, n in enumerate(self.lens)]

    def close(self) -> None:
        for feed in self.feeds:
            feed.close()


class MultiSeqPipeline:
    """Runs S sequences in lockstep segments, the sequences on the mesh's
    entries in contiguous blocks, each entry's block stepped as one batch.
    S must be a multiple of the mesh size; a sequence shorter than the
    longest replays its last frame and its results are cut to its length,
    as in the reference.

    Like the reference it turns off the in-frame recovery ladder and the
    mover veto (their extra ICPs would run for every sequence of the
    batch), and keeps two configs: the warm one for segments that start
    inside the scan-to-scan warm-up (``i <= initial_scan2scan_frame_num``),
    the steady one, with ``warmup_s2s_on=False``, for the rest.

    After :meth:`run`, ``block_launches`` holds each of this process's
    blocks' kernel launch counts, and ``launches`` one record per sequence
    of this process: its block's (the sequences of a block share their
    launches)."""

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
        self.block_launches: List[dict] = []

    def run(self, datasets: List, progress: bool = False,
            draws: Optional[Sequence[Draws]] = None,
            on_segment: Optional[Callable[[int], None]] = None
            ) -> List[OdometryResult]:
        """One result per dataset, in order (every rank gets all of them).
        ``draws``: one ``Draws`` per sequence (default: sequence s draws
        from a generator seeded with ``cfg.seed + s`` on its entry's
        device, as the reference seeds its key).  ``on_segment(frames)``,
        when given, runs at the end of each lockstep segment, after every
        block of this process has fetched its results (a sync), with the
        frame count done: the hook a measurement brackets a steady window
        with.  Each segment is the span ``segment``, closed before the
        hook runs; inside it each frame's wait for its feeds
        (``feed.wait``), its stack of the S frames (``step.stack``), its
        step (``step``) and the segment's copy (``segment.fetch``)."""
        cfg = self.cfg
        S = len(datasets)
        n_mesh = self.mesh.size
        if S % n_mesh != 0:
            raise ValueError(f"{S} sequences on {n_mesh} devices: the "
                             f"sequence count must be a multiple of the "
                             f"mesh size")
        n_max = max(len(d) for d in datasets)
        # every sequence's starting state on the host, stacked; then each
        # entry's block on its device with its sequences' own draws
        host = stack_states([init_state(cfg.replace(seed=cfg.seed + s),
                                        "cpu") for s in range(S)])
        placed = put_sharded(host.replace(draws=None), self.mesh, S)
        blocks: List[_Block] = []
        try:
            for (dev, (lo, hi)), state in zip(
                    zip(self.mesh.devices, self.mesh.blocks(S)), placed):
                own = StackedDraws([
                    draws[s] if draws is not None
                    else GeneratorDraws(cfg.seed + s, dev)
                    for s in range(lo, hi)])
                blocks.append(_Block(self, state.replace(draws=own),
                                     datasets[lo:hi], dev))
            warm_lim = self.cfg.map.initial_scan2scan_frame_num
            for i0 in range(0, n_max, self.segment):
                cfg = self.cfg if i0 <= warm_lim else self.cfg_steady
                done = min(i0 + self.segment, n_max)
                with trace.span("segment"):
                    for i in range(i0, done):
                        for blk in blocks:
                            blk.step(cfg, i)
                    for blk in blocks:
                        blk.fetch()
                if on_segment is not None:
                    on_segment(done)
                if progress:
                    print(f"[multiseq {done}/{n_max}] x{S // n_mesh} "
                          f"sequences a batch, {len(blocks)} batches",
                          flush=True)
        finally:
            for blk in blocks:
                blk.close()
        self.block_launches = [blk.launches for blk in blocks]
        self.launches = [blk.launches for blk in blocks
                         for _ in blk.lens]
        out = [r for blk in blocks for r in blk.results()]
        if self.mesh.world_size > 1:
            import torch.distributed as dist
            parts: list = [None] * self.mesh.world_size
            dist.all_gather_object(parts, out, group=self.mesh.group)
            out = [r for part in parts for r in part]
        return out
