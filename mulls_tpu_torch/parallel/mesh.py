"""The device mesh and the multi-device step — port of
``mulls_tpu/parallel/mesh.py``.

The reference shards its ``data`` axis over a ``jax.sharding.Mesh`` with
``shard_map`` and reduces with ``psum``.  Here a :class:`Mesh` is an
ordered list of this process's ``torch.device`` entries, an axis name and
an optional process group whose ranks each hold such a list.  Work on the
``data`` axis (registration pairs, pose-graph edges, sequences) goes to
the mesh's entries in contiguous blocks, like ``P("data")``: rank r's
entries come after rank r-1's.  A reduction over the mesh
(:meth:`Mesh.reduce_sum`) adds the entries' partial sums in entry order
within the process, then ``all_reduce(SUM)`` across the ranks, so every
rank holds the same sum and the replicated solve that follows gives every
rank the same update.

:func:`distributed_slam_step` is the multi-device step: each entry
registers its pairs (``mm_lls_icp``), forms the pose-graph normal
equations of its edges with ``backend/pgo.py``'s own assembly
(``segment_sum`` in a fixed order), the blocks are reduced over the mesh,
and one replicated Gauss-Newton update follows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from mulls_tpu_torch.backend.pgo import PoseGraph, _normal_equations
from mulls_tpu_torch.config import RegConfig
from mulls_tpu_torch.core import se3
from mulls_tpu_torch.core.cloud import FeatureCloud
from mulls_tpu_torch.core.device import resolve_device
from mulls_tpu_torch.core.tree import tree_map
from mulls_tpu_torch.frontend.icp import RegResult, mm_lls_icp

f32 = torch.float32


@dataclass(frozen=True)
class Mesh:
    """``devices``: this process's entries, in order (a device may appear
    more than once: the CPU mesh of the tests lists ``cpu`` n times, and
    two ranks may share one card).  ``group``: the process group whose
    ranks hold the other entries, or None for a mesh of one process."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "data"
    group: Optional[object] = None

    @property
    def rank(self) -> int:
        if self.group is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group)

    @property
    def world_size(self) -> int:
        if self.group is None:
            return 1
        import torch.distributed as dist
        return dist.get_world_size(self.group)

    @property
    def size(self) -> int:
        """Entries over all ranks (every rank holds as many)."""
        return len(self.devices) * self.world_size

    def local_entries(self) -> range:
        """The global indices of this process's entries."""
        n = len(self.devices)
        return range(self.rank * n, (self.rank + 1) * n)

    def blocks(self, n_items: int) -> List[Tuple[int, int]]:
        """[begin, end) of the contiguous block of ``n_items`` that each of
        this process's entries owns; ``n_items`` must divide evenly."""
        if n_items % self.size:
            raise ValueError(f"{n_items} items on a mesh of {self.size}: "
                             f"the count must be a multiple of the mesh "
                             f"size")
        per = n_items // self.size
        return [(e * per, (e + 1) * per) for e in self.local_entries()]

    def reduce_sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum over the mesh of one partial tensor per local entry: the
        local parts added in entry order on ``devices[0]``, then
        ``all_reduce(SUM)`` across the ranks."""
        dev = self.devices[0]
        acc = parts[0].to(dev).clone(memory_format=torch.contiguous_format)
        for p in parts[1:]:
            acc = acc + p.to(dev)
        if self.world_size > 1:
            import torch.distributed as dist
            dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=self.group)
        return acc

    def gather_blocks(self, local: torch.Tensor, n_items: int
                      ) -> torch.Tensor:
        """The [n_items, ...] whole from this process's contiguous block
        ``local`` of it (on ``devices[0]``): each rank's block broadcast
        from that rank, so every rank holds every block bit for bit."""
        if self.world_size == 1:
            return local
        import torch.distributed as dist
        per = n_items // self.world_size
        out = torch.empty((n_items,) + tuple(local.shape[1:]),
                          dtype=local.dtype, device=local.device)
        for r in range(self.world_size):
            blk = out[r * per:(r + 1) * per]
            if r == self.rank:
                blk.copy_(local)
            src = dist.get_global_rank(self.group, r) \
                if self.group is not dist.group.WORLD else r
            dist.broadcast(blk, src=src, group=self.group)
        return out


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              device="cuda") -> Mesh:
    """A one-process mesh of ``n_devices`` entries (default: every card).
    ``device="cuda"`` takes cards 0..n-1 and raises when there are fewer:
    unlike the reference it never falls back to the CPU.  ``device="cpu"``
    lists the CPU ``n_devices`` times (default once)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh(tuple([dev] * (n_devices or 1)), axis_name)
    have = torch.cuda.device_count()
    n = n_devices or have
    if have < n:
        raise ValueError(f"need {n} cards, have {have}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis_name)


def _index(tree, b: int):
    return tree_map(lambda a: a[b], tree)


def batched_icp(sources: Dict[str, FeatureCloud],
                targets: Dict[str, FeatureCloud], guesses: torch.Tensor,
                cfg: RegConfig, max_iter: int) -> List[RegResult]:
    """``mm_lls_icp`` over a leading batch axis of cloud dicts
    ([B, N, ...] leaves) and ``guesses`` [B, 4, 4], one registration after
    another (the reference's ``vmap``)."""
    return [mm_lls_icp(_index(sources, b), _index(targets, b), cfg,
                       guesses[b], max_iter)
            for b in range(guesses.shape[0])]


def _pair_graph(node_t, node_q, edge_i, edge_j, T: torch.Tensor,
                ok: torch.Tensor):
    """The pose graph of one block of pairs: an edge a registration, kept
    where its code is 1 (``ok``), with identity information."""
    e = edge_i.shape[0]
    dev = node_t.device
    return PoseGraph(
        node_t=node_t, node_q=node_q, edge_i=edge_i, edge_j=edge_j,
        edge_t=T[:, :3, 3], edge_q=se3.quat_from_rotation(T[:, :3, :3]),
        edge_info=torch.eye(6, dtype=f32, device=dev).expand(e, 6, 6),
        edge_mask=ok,
        fixed=torch.zeros((node_t.shape[0],), dtype=torch.bool, device=dev))


def distributed_slam_step(mesh: Mesh, cfg: RegConfig, max_iter: int,
                          num_nodes: int, axis_name: str = "data"
                          ) -> Callable:
    """The multi-device step, as a function of

      sources / targets: dicts of ``FeatureCloud`` batches ([B, N, ...]),
      guesses [B, 4, 4], edge_i / edge_j [B] node ids of each pair,
      node_t [M, 3], node_q [M, 4] (replicated).

    Every rank passes the whole batch; the pairs go to the mesh's entries
    in contiguous blocks (B a multiple of the mesh size).  Each entry
    registers its pairs on its device and forms the pose-graph blocks of
    its edges (an edge kept where the registration's code is 1); ``H`` and
    ``g`` are reduced over the mesh, node 0 is pinned (1e9) with 1e-4
    damping, and one replicated Gauss-Newton update follows.  Returns
    (node_t', node_q', transforms [B, 4, 4], sigmas [B]) on
    ``mesh.devices[0]``, the same on every rank."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"axis {axis_name!r} is not the mesh's "
                         f"{mesh.axis_name!r}")
    m = num_nodes

    def step(sources, targets, guesses, edge_i, edge_j, node_t, node_q):
        n_pairs = guesses.shape[0]
        dev0 = mesh.devices[0]
        parts_H, parts_g, Ts, sigmas = [], [], [], []
        for d, (lo, hi) in zip(mesh.devices, mesh.blocks(n_pairs)):
            def on(x):
                return tree_map(lambda a: a[lo:hi].to(d), x)
            res = batched_icp(on(sources), on(targets), on(guesses), cfg,
                              max_iter)
            T = torch.stack([r.transform for r in res])
            ok = torch.stack([r.process_code == 1 for r in res])
            graph = _pair_graph(node_t.to(d), node_q.to(d), on(edge_i),
                                on(edge_j), T, ok)
            H, g = _normal_equations(graph.node_t, graph.node_q, graph,
                                     graph.edge_info, False, 1.0)
            parts_H.append(H)
            parts_g.append(g)
            Ts.append(T.to(dev0))
            sigmas.append(torch.stack([r.sigma for r in res]).to(dev0))
        # the collective: the normal equations reduced over the mesh
        H = mesh.reduce_sum(parts_H)
        g = mesh.reduce_sum(parts_g)
        Hd = H.reshape(m * 6, m * 6)
        pin = torch.zeros((m,), dtype=f32, device=dev0)
        pin[0] = 1e9
        Hd = Hd + torch.diag(torch.repeat_interleave(pin, 6)) \
            + 1e-4 * torch.eye(m * 6, dtype=f32, device=dev0)
        delta = torch.linalg.solve_ex(Hd, -g.reshape(-1))[0].reshape(m, 6)
        node_q = node_q.to(dev0)
        dq = torch.cat([torch.ones((m, 1), dtype=f32, device=dev0),
                        0.5 * delta[:, 3:6]], dim=1)
        q_new = se3.quat_mul(dq, node_q)
        q_new = q_new / torch.linalg.norm(q_new, dim=-1, keepdim=True)
        t_new = node_t.to(dev0) + delta[:, :3]
        return (t_new, q_new, mesh.gather_blocks(torch.cat(Ts), n_pairs),
                mesh.gather_blocks(torch.cat(sigmas), n_pairs))

    return step
