"""Multi-process runtime helpers on ``torch.distributed`` — port of
``mulls_tpu/parallel/distributed.py``.

Each process holds a slice of the cards; a process group stitches them
into one mesh (``parallel/mesh.py::Mesh`` with its ``group``) whose
reductions are ``all_reduce`` calls.  The multi-process surfaces are:

* multi-sequence odometry: sequences go to the mesh's entries in
  contiguous blocks (``parallel/multiseq.py``), each process running its
  own;
* sharded pose-graph optimization: the edge blocks' normal equations
  reduced across processes (``backend/pgo.py::optimize_pose_graph_sharded``).

The backend: NCCL when every rank of a host owns a card of its own; gloo
for CPU tensors and when ranks share a card (NCCL refuses two ranks on
one device).  :func:`describe` says which one runs.  Single-process runs
work unchanged: with nothing configured every helper is local.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from mulls_tpu_torch.core.device import resolve_device
from mulls_tpu_torch.parallel.mesh import Mesh, make_mesh


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def choose_backend(world_size: int) -> str:
    """``nccl`` when this host has a card for each of its ranks
    (``LOCAL_WORLD_SIZE``, or the world size on one host), else ``gloo``."""
    local = _env_int("LOCAL_WORLD_SIZE") or world_size
    if torch.cuda.is_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def local_device(device="cuda") -> torch.device:
    """This rank's device: for ``cuda`` the card ``LOCAL_RANK`` (or the
    rank) modulo the card count, so ranks share cards when there are
    fewer cards than ranks."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    rank = _env_int("LOCAL_RANK")
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_from_env(coordinator: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None,
                        backend: Optional[str] = None) -> bool:
    """Initialize the default process group when multi-process coordinates
    are available; returns True if a multi-process runtime is set up.

    Resolution order: explicit args > ``MULLS_TPU_COORDINATOR`` (a
    ``host:port``, read as ``tcp://host:port``, or any ``init_method``
    URL such as ``file:///path``) / ``MULLS_TPU_NUM_PROCESSES`` /
    ``MULLS_TPU_PROCESS_ID`` > torchrun's ``RANK`` / ``WORLD_SIZE`` /
    ``MASTER_ADDR`` (``env://``).  Nothing configured -> no-op, False.
    ``backend`` defaults to :func:`choose_backend`."""
    coordinator = coordinator or os.environ.get("MULLS_TPU_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("MULLS_TPU_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("MULLS_TPU_PROCESS_ID")
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs the number of processes "
                             "and this process's id")
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    elif all(os.environ.get(k) for k in ("RANK", "WORLD_SIZE",
                                          "MASTER_ADDR")):
        init = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    else:
        return False
    if dist.is_initialized():
        return True
    backend = backend or choose_backend(num_processes)
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)
    if backend == "nccl":  # before the first collective creates the comm
        torch.cuda.set_device(local_device("cuda"))
    return True


def describe() -> str:
    """One line: this process's rank, the world size and the backend."""
    if not dist.is_initialized():
        return "one process (no process group)"
    return (f"rank {dist.get_rank()} of {dist.get_world_size()}, backend "
            f"{dist.get_backend()}")


def global_mesh(axis_name: str = "data", device="cuda") -> Mesh:
    """The mesh over every process: this rank's device
    (:func:`local_device`) in the default group, or, without a process
    group, every local card (the CPU once for ``device="cpu"``)."""
    if not dist.is_initialized():
        return make_mesh(None, axis_name, device)
    return Mesh((local_device(resolve_device(device)),), axis_name,
                dist.group.WORLD)


def process_slice(n_items: int) -> Tuple[int, int]:
    """[begin, end) range of a globally-indexed work list owned by this
    process — contiguous block partitioning, used to decide which sequence
    folders this process reads from disk."""
    p = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    per = (n_items + p - 1) // p
    return min(i * per, n_items), min((i + 1) * per, n_items)


def shard_sequences(datasets: List, mesh: Mesh) -> List:
    """Pad a sequence list to a multiple of the mesh size by repeating the
    last dataset (idle shards; the caller discards their results by the
    true count)."""
    out = list(datasets)
    while len(out) % mesh.size:
        out.append(datasets[-1])
    return out
