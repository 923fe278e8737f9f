"""A small pose graph and the body of one rank that runs the sharded PGO
on it in a process group: the check of the multi-device layer shared by
``tests/test_torch_parallel.py``, ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.  Ranks are started with the ``spawn`` method and import
only numpy, torch and the port."""

from __future__ import annotations

import json

import numpy as np
import torch


def ring_graph(seed: int = 0) -> dict:
    """tests/test_multiseq.py's pose graph: a ring of 9 nodes with noisy
    starts, 8 odometry edges and one exact loop edge, padded to 16 edges,
    as numpy arrays."""
    rng = np.random.default_rng(seed)
    m = 9
    t_true = np.stack([np.arange(m, dtype=np.float32),
                       np.zeros(m, np.float32), np.zeros(m, np.float32)], -1)
    q_id = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (m, 1))
    e_i = np.concatenate([np.arange(m - 1), [0]])
    e_j = np.concatenate([np.arange(1, m), [m - 1]])
    e_t = np.concatenate([np.tile(np.asarray([1.0, 0, 0], np.float32),
                                  (m - 1, 1)), [[8.0, 0, 0]]])
    e = len(e_i)
    pad = 16 - e
    node_t0 = t_true + 0.1 * rng.normal(size=t_true.shape).astype(np.float32)
    node_t0[0] = 0.0
    return {
        "node_t": node_t0.astype(np.float32), "node_q": q_id,
        "edge_i": np.concatenate([e_i, np.zeros(pad)]).astype(np.int64),
        "edge_j": np.concatenate([e_j, np.zeros(pad)]).astype(np.int64),
        "edge_t": np.concatenate([e_t, np.zeros((pad, 3))])
        .astype(np.float32),
        "edge_q": np.tile(q_id[0], (16, 1)),
        "edge_info": np.broadcast_to(np.eye(6, dtype=np.float32),
                                     (16, 6, 6)).copy(),
        "edge_mask": np.arange(16) < e,
        "fixed": np.arange(m) == 0, "t_true": t_true}


def torch_graph(g: dict, device="cpu"):
    from mulls_tpu_torch.backend.pgo import PoseGraph
    return PoseGraph(**{k: torch.as_tensor(v, device=device)
                        for k, v in g.items() if k != "t_true"})


def sharded_rank(rank: int, world: int, init: str, out: str,
                 device: str = "cpu") -> None:
    """One rank of a process group (gloo): the sharded PGO on the ring
    over the global mesh, this rank's ``process_slice`` of 10 items, and
    ``gather_blocks`` of a block per rank; written to ``out`` (JSON)."""
    torch.set_num_threads(1)
    from mulls_tpu_torch.backend.pgo import optimize_pose_graph_sharded
    from mulls_tpu_torch.parallel import distributed as dist

    assert dist.initialize_from_env(init, world, rank, backend="gloo")
    try:
        mesh = dist.global_mesh(device=device)
        t, q, chi2 = optimize_pose_graph_sharded(
            torch_graph(ring_graph(), device), mesh, iterations=15)
        whole = mesh.gather_blocks(
            torch.arange(3, dtype=torch.float32, device=t.device)
            + 10 * rank, 3 * world)
        rec = {"t": t.cpu().tolist(), "q": q.cpu().tolist(),
               "chi2": float(chi2), "slice": dist.process_slice(10),
               "mesh_size": mesh.size, "whole": whole.cpu().tolist(),
               "describe": dist.describe()}
    finally:
        torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)
