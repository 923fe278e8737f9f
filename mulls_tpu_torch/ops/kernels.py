"""The three neighborhood kernels: hand-written CUDA for Hopper, each with
its plain PyTorch version beside it; and the one kernel library that holds
them and the roofline probe's two kernels.

Port of ``mulls_tpu/ops/kernels.py`` (Pallas TPU kernels).  The CUDA
sources live in ``mulls_tpu_torch/csrc``; they are compiled with ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface at first
use (keyed on a hash of the sources, under ``build/mulls_tpu_torch_kernels``
at the root of the checkout) and bound with ``ctypes``.

* :func:`nn_grouped` — fused 1-NN for a group of problems in one launch
  (replaces ``nn_pallas``); :func:`nn` is the group of one.
* :func:`moments` — masked neighborhood feature sums, optionally with a
  close sub-neighborhood (replaces ``moments_pallas``).
* :func:`pca_moments` — query-centred PCA moments (replaces
  ``pca_moments_pallas``).
* :func:`count_within` — per-query count of valid support within the
  radius (replaces the roofline probe's ``_kernel_dist_only``), walking the
  27 cells around each query in the grid of :func:`cell_index`; the map
  assembly's outlier filter counts with it.

The probe's other kernel (``csrc/adj_stack.cu``) is built into the same
library and bound here, but its wrapper and launch count live with the
probe, in :mod:`mulls_tpu_torch.tools.roofline`, as the TPU kernel it
replaces lives in ``tools/perf_mfu_roofline.py``.

Dispatch: a wrapper takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.  Each wrapper counts its
launches under its own name with ``core/trace.py``'s counters, where the
kernel is launched and nowhere else: ``nn`` counts every launch of the nn
kernel, ``nn_grouped`` those made for :func:`nn_grouped`.
:func:`launch_counts` reads the process's totals (the SLAM pipeline
launches from two host threads), and :func:`count_launches` gives one
thread's own launches (the back end's apart from the front end's): a trace
record that starts with the kernels' keys and also holds what else the
thread counts while it is open (spans, syncs).

Batches: the wrappers of nn, moments and pca_moments take inputs with
leading batch dimensions (``[S, Q, 3]`` queries against ``[S, P, 3]``
support: the S sequences of ``parallel/multiseq.py`` stepped as one) and
launch once for all of them: the problems of a group for ``nn``, a grid
axis for the batch entry in ``moments.cu`` and ``pca_moments.cu``.  Each
entry keeps the tiles, chunks and merge order of its launch alone, so its
outputs equal that launch's bit for bit.  The plain versions loop over the
entries.

The nn, moments and pca_moments kernels merge across support chunks
through scratch kept per device and stream (:func:`_scratch`): merge words
and arrival counters that every launch leaves as it found them, so no
launch needs a memset.

The squared distance is ``((q-p)_x^2 + (q-p)_y^2) + (q-p)_z^2`` with every
operation rounded on its own, in the kernels and in the plain versions
alike, so both produce the same adjacency and argmin bit for bit (the
reference's plain path expands ``|q|^2 + |p|^2 - 2 q.p``, whose rounding at
metre-scale coordinates moves boundary points).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from mulls_tpu_torch.core import trace

_BIG = 3.0e38

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("nn.cu", "moments.cu", "pca_moments.cu", "count_within.cu",
            "adj_stack.cu")
_HEADERS = ("common.cuh",)
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LIB_NAME = "libmulls_tpu_torch_kernels.so"
# the kernels' geometry (checked against csrc/ when the library loads)
NN_MAX_GROUP = 48  # problems in one nn launch
NN_TILE_Q, NN_CHUNK = 128, 1024  # queries x support points per nn block
MOMENTS_MAX_C = 16  # templated accumulator widths in csrc/moments.cu
MOMENTS_TILE_Q, MOMENTS_CHUNK = 128, 1024
# csrc/pca_moments.cu: queries per tile, the largest support chunk, points
# per shared-memory stage
PCA_TILE_Q, PCA_CHUNK, PCA_STAGE = 128, 1024, 256
COUNT_THREADS = 128  # csrc/count_within.cu: one query a thread
# csrc/adj_stack.cu: the largest stack width, queries per tile, blocks per
# tile (a cluster) and support points per TMA stage
ADJ_MAX_C, ADJ_TILE_Q, ADJ_CLUSTER, ADJ_STAGE = 128, 128, 8, 128


# --------------------------------------------------------------------------
# build + load
# --------------------------------------------------------------------------

def build_root() -> Path:
    """``build/mulls_tpu_torch_kernels`` at the root of the checkout."""
    return Path(__file__).resolve().parents[2] / "build" / \
        "mulls_tpu_torch_kernels"


def _digest() -> str:
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or CUDA_HOME)")


def library_path() -> Path:
    return build_root() / _digest() / _LIB_NAME


def build_kernels() -> dict:
    """Compile ``csrc/*.cu`` (one ``nvcc`` per source, all started
    together) and link them into one shared library, unless the library
    for these sources exists.  Returns ``{"path", "seconds", "built",
    "log"}``; the log holds ``ptxas -v`` (registers, shared memory,
    spills per kernel)."""
    so = library_path()
    log_path = so.parent / "build.log"
    if so.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(so), "seconds": 0.0, "built": False, "log": log}
    t0 = time.perf_counter()
    nvcc = _nvcc()
    tmp = so.parent / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    objs = [tmp / (Path(s).stem + ".o") for s in _SOURCES]
    procs = [subprocess.Popen(
        [nvcc, *_NVCC_FLAGS, "-c", str(_CSRC / src), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(_SOURCES, objs)]
    logs = []
    failed = []
    for src, proc in zip(_SOURCES, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp_so = tmp / _LIB_NAME
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp_so), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    log = "\n".join(logs)
    log_path.write_text(log)
    os.replace(tmp_so, so)  # atomic: a concurrent build sees all or none
    shutil.rmtree(tmp, ignore_errors=True)
    return {"path": str(so), "seconds": time.perf_counter() - t0,
            "built": True, "log": log}


_library_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The kernel library, built on first use: once, when several threads
    ask for it at once (they would share one build directory)."""
    with _library_lock:
        return _load_library()


@functools.lru_cache(maxsize=None)
def _load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_kernels()["path"])
    vp, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.mulls_nn_grouped.argtypes = [i, vp, vp, vp, vp, vp]
    lib.mulls_nn_grouped.restype = i
    lib.mulls_nn_empty_key.argtypes = []
    lib.mulls_nn_empty_key.restype = ctypes.c_ulonglong
    lib.mulls_moments.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, vp,
                                  vp, vp, vp, vp, vp]
    lib.mulls_moments.restype = i
    lib.mulls_pca_moments.argtypes = [vp, vp, vp, vp, i, i, i, i, vp, vp,
                                      vp, vp, vp, vp]
    lib.mulls_pca_moments.restype = i
    lib.mulls_count_within.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i,
                                       i, vp, vp]
    lib.mulls_count_within.restype = i
    lib.mulls_adj_stack.argtypes = [vp, vp, vp, vp, i, i, i, vp, vp]
    lib.mulls_adj_stack.restype = i
    for fn, want in ((lib.mulls_nn_geometry,
                      (NN_MAX_GROUP, NN_TILE_Q, NN_CHUNK)),
                     (lib.mulls_moments_geometry,
                      (MOMENTS_MAX_C, MOMENTS_TILE_Q, MOMENTS_CHUNK)),
                     (lib.mulls_pca_moments_geometry,
                      (PCA_TILE_Q, PCA_CHUNK, PCA_STAGE)),
                     (lib.mulls_count_within_geometry, (COUNT_THREADS,)),
                     (lib.mulls_adj_stack_geometry,
                      (ADJ_MAX_C, ADJ_TILE_Q, ADJ_CLUSTER, ADJ_STAGE))):
        fn.argtypes, fn.restype = [ip] * len(want), None
        got = [ctypes.c_int() for _ in want]
        fn(*[ctypes.byref(g) for g in got])
        if tuple(g.value for g in got) != want:
            raise RuntimeError(f"csrc/ and kernels.py disagree on the "
                               f"geometry of {fn.__name__}: {want} here")
    return lib


_scratch_by_stream: dict = {}
# the SLAM pipeline launches kernels from two host threads (the front end
# and the back end's boundary thread) on one stream
_scratch_lock = threading.Lock()


def _scratch(t: torch.Tensor, n_keys: int, n_counters: int):
    """(merge words int64 [>= n_keys], int32 arrival counters
    [>= n_counters]) for the current
    stream of ``t``'s device.  Every launch leaves them as made (words at
    ``mulls_nn_empty_key()``, counters 0), so they are filled only when
    made or grown; kernels on one stream run in order, so they never share
    them, whichever host thread launched them."""
    key = (t.device.index, _stream(t).value)
    with _scratch_lock:
        keys, counters = _scratch_by_stream.get(key, (None, None))
        if keys is None or keys.numel() < n_keys:
            empty = library().mulls_nn_empty_key()
            keys = torch.full((max(n_keys, 1 << 14),), empty,
                              dtype=torch.int64, device=t.device)
        if counters is None or counters.numel() < n_counters:
            counters = torch.zeros((max(n_counters, 1 << 10),),
                                   dtype=torch.int32, device=t.device)
        _scratch_by_stream[key] = (keys, counters)
    return keys, counters


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {err})")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _dispatch(device: torch.device) -> bool:
    """True: run the CUDA kernel; False: the plain version (CPU only)."""
    if device.type == "cpu":
        return False
    if device.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain path for device {device}")


LAUNCH_KEYS = ("nn", "nn_grouped", "moments", "pca_moments", "count_within")


def reset_launch_counts() -> None:
    trace.reset(LAUNCH_KEYS)


def launch_counts() -> dict:
    """Every thread's launches of each kernel since the last reset."""
    return trace.totals(LAUNCH_KEYS)


def _count(fn) -> None:
    """One launch of ``fn``'s kernel, counted under ``fn``'s name."""
    trace.count(fn.__name__)


def count_launches():
    """The calling thread's view of the launch counters: yields a dict
    {name: launches} of the kernels this thread launches while entered
    (launches from other threads are not in it), with whatever else the
    thread counts meanwhile (``core/trace.py``).  Nested records also add
    to the enclosing one."""
    return trace.record(LAUNCH_KEYS)


# --------------------------------------------------------------------------
# squared distances, exactly as the kernels form them
# --------------------------------------------------------------------------

def sqdist_direct(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """[Q,3] x [P,3] -> [Q,P]: ((dx*dx + dy*dy) + dz*dz), d = q - p."""
    dx = q[:, 0:1] - p[None, :, 0]
    dy = q[:, 1:2] - p[None, :, 1]
    dz = q[:, 2:3] - p[None, :, 2]
    return dx * dx + dy * dy + dz * dz


# --------------------------------------------------------------------------
# 1-NN
# --------------------------------------------------------------------------

def nn_plain(q_xyz: torch.Tensor, q_mask: torch.Tensor, p_xyz: torch.Tensor,
             p_mask: torch.Tensor, chunk: int = 2048
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch 1-NN over [chunk, P] distance blocks, each batch
    entry on its own."""
    if q_xyz.dim() > 2:
        return _per_entry(nn_plain, (q_xyz, q_mask, p_xyz, p_mask), 2)
    idx_parts, d2_parts = [], []
    for s in range(0, max(q_xyz.shape[0], 1), chunk):  # Q = 0: one block
        d2 = sqdist_direct(q_xyz[s:s + chunk], p_xyz)
        d2 = torch.where(p_mask[None, :], d2, _BIG)
        idx = torch.argmin(d2, dim=1)  # first minimum: lowest index wins
        idx_parts.append(idx.to(torch.int32))
        d2_parts.append(torch.gather(d2, 1, idx[:, None])[:, 0])
    idx = torch.cat(idx_parts)
    d2 = torch.where(q_mask, torch.cat(d2_parts), _BIG)
    return idx, d2


def _per_entry(fn, args, point_dims: int):
    """``fn`` on each batch entry of ``args`` (the batch dimensions are all
    but the last ``point_dims`` of the first argument), outputs stacked."""
    lead = args[0].shape[:args[0].dim() - point_dims]
    n = math.prod(lead)
    flat = [None if a is None else a.reshape(n, *a.shape[len(lead):])
            for a in args]
    outs = [fn(*[None if a is None else a[b] for a in flat])
            for b in range(n)]
    return tuple(None if o[0] is None else
                 torch.stack(o).reshape(*lead, *o[0].shape)
                 for o in zip(*outs))


NnProblem = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def nn_grouped_plain(problems: Sequence[NnProblem]
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """:func:`nn_plain` over each problem of the group."""
    return [nn_plain(*pr) for pr in problems]


def _check_nn(problem: NnProblem, dev: torch.device, tag: str) -> None:
    q_xyz, q_mask, p_xyz, p_mask = problem
    lead = tuple(q_xyz.shape[:-2])
    qn, pn = q_xyz.shape[-2], p_xyz.shape[-2]
    _check(f"{tag}q_xyz", q_xyz, torch.float32, (*lead, qn, 3), dev)
    _check(f"{tag}q_mask", q_mask, torch.bool, (*lead, qn), dev)
    _check(f"{tag}p_xyz", p_xyz, torch.float32, (*lead, pn, 3), dev)
    _check(f"{tag}p_mask", p_mask, torch.bool, (*lead, pn), dev)
    if pn < 1:
        raise ValueError(f"{tag}nn: empty support")


def _nn_entries(problem: NnProblem, out: Tuple[torch.Tensor, torch.Tensor]
                ) -> list:
    """The launch entries of a checked CUDA problem: for each batch entry
    with queries, its six pointers (q, q_mask, p, p_mask, idx, d2) and its
    sizes (Q, P)."""
    q_xyz, q_mask, p_xyz, p_mask = problem
    qn, pn = q_xyz.shape[-2], p_xyz.shape[-2]
    if qn == 0:
        return []
    base = [t.data_ptr() for t in (*problem, *out)]
    step = (12 * qn, qn, 12 * pn, pn, 4 * qn, 4 * qn)  # bytes an entry
    return [([b + k * st for b, st in zip(base, step)], qn, pn)
            for k in range(math.prod(q_xyz.shape[:-2]))]


def _launch_nn(entries: list, like: torch.Tensor) -> None:
    """One launch of ``csrc/nn.cu`` for up to NN_MAX_GROUP entries of
    :func:`_nn_entries` on ``like``'s device."""
    ptrs = (ctypes.c_void_p * (6 * len(entries)))(*[
        p for ptr6, _, _ in entries for p in ptr6])
    sizes = (ctypes.c_int * (2 * len(entries)))(*[
        n for _, qn, pn in entries for n in (qn, pn)])
    n_tiles = sum(-(-qn // NN_TILE_Q) for _, qn, _ in entries)
    keys, counters = _scratch(like, sum(qn for _, qn, _ in entries), n_tiles)
    _check_launch(library().mulls_nn_grouped(
        len(entries), ptrs, sizes, _ptr(keys), _ptr(counters),
        _stream(like)), "nn")
    _count(nn)


def _nn_cuda(problems: Sequence[NnProblem], grouped: bool
             ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    outs, entries = [], []
    for pr in problems:
        shape = tuple(pr[0].shape[:-1])
        out = (torch.empty(shape, dtype=torch.int32, device=pr[0].device),
               torch.empty(shape, dtype=torch.float32, device=pr[0].device))
        outs.append(out)
        entries += _nn_entries(pr, out)
    for s in range(0, len(entries), NN_MAX_GROUP):
        _launch_nn(entries[s:s + NN_MAX_GROUP], problems[0][0])
        if grouped:
            _count(nn_grouped)
    return outs


def nn_grouped(problems: Sequence[NnProblem]
               ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """:func:`nn` for each ``(q_xyz, q_mask, p_xyz, p_mask)`` problem of a
    group, in one launch per NN_MAX_GROUP problems (problems without
    queries take none).  Returns ``[(idx, sqdist), ...]`` in order; every
    result equals :func:`nn` on its problem bit for bit.  A problem with
    batch dimensions (``[S, Q, 3]`` against ``[S, P, 3]``) counts as one
    problem an entry.

    CUDA kernel: ``csrc/nn.cu`` (replaces ``nn_pallas``,
    ``mulls_tpu/ops/kernels.py:90-150``): query tiles x support chunks over
    the whole group, merged exactly — see the source note."""
    problems = [tuple(pr) for pr in problems]
    if not problems:
        return []
    dev = problems[0][0].device
    for k, pr in enumerate(problems):
        _check_nn(pr, dev, f"problem {k}: ")
    if not _dispatch(dev):
        return nn_grouped_plain(problems)
    return _nn_cuda(problems, grouped=True)


def nn(q_xyz: torch.Tensor, q_mask: torch.Tensor, p_xyz: torch.Tensor,
       p_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused 1-NN: (idx [..., Q] int32, sqdist [..., Q] f32).  Invalid
    support is excluded, invalid queries get the 3.0e38 sentinel, ties go
    to the lowest support index (API parity with
    ``mulls_tpu.ops.kernels.nn_pallas``).

    CUDA kernel: ``csrc/nn.cu`` as a group of the batch's entries
    (replaces ``nn_pallas``, ``mulls_tpu/ops/kernels.py:90-150``) — bound
    by fp32 operations, see the source note."""
    problem = (q_xyz, q_mask, p_xyz, p_mask)
    dev = q_xyz.device
    _check_nn(problem, dev, "")
    if not _dispatch(dev):
        return nn_plain(*problem)
    return _nn_cuda([problem], grouped=False)[0]


# --------------------------------------------------------------------------
# radius moments (adjacency @ features), optional close sub-neighborhood
# --------------------------------------------------------------------------

def moments_plain(q_xyz: torch.Tensor, p_xyz: torch.Tensor,
                  p_mask: torch.Tensor, r2: torch.Tensor,
                  feat_stack: torch.Tensor,
                  close_r2: Optional[torch.Tensor] = None, chunk: int = 1024
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch ``adj @ feat_stack`` over [chunk, P] blocks, each
    batch entry on its own."""
    if q_xyz.dim() > 2:
        return _per_entry(
            lambda q, p, m, r, f, c: moments_plain(q, p, m, r, f, c, chunk),
            (q_xyz, p_xyz, p_mask, r2, feat_stack, close_r2), 2)
    sums, csums = [], []
    for s in range(0, q_xyz.shape[0], chunk):
        d2 = sqdist_direct(q_xyz[s:s + chunk], p_xyz)
        adj = p_mask[None, :] & (d2 <= r2[s:s + chunk, None])
        sums.append(adj.to(torch.float32) @ feat_stack)
        if close_r2 is not None:
            close = adj & (d2 <= close_r2[s:s + chunk, None])
            csums.append(close.to(torch.float32) @ feat_stack)
    if not sums:  # no queries
        sums = [feat_stack.new_zeros((0, feat_stack.shape[1]))]
        csums = sums
    return (torch.cat(sums),
            torch.cat(csums) if close_r2 is not None else None)


def moments(q_xyz: torch.Tensor, p_xyz: torch.Tensor, p_mask: torch.Tensor,
            r2: torch.Tensor, feat_stack: torch.Tensor,
            close_r2: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused neighborhood sums (API of ``moments_pallas``).

    Args:
      q_xyz: [..., Q,3] queries; r2: [..., Q] per-query squared radius.
      p_xyz/p_mask: [..., P,3]/[..., P] support; invalid rows contribute
        nothing.
      feat_stack: [..., P,C] per-support features, C <= 16.
      close_r2: [..., Q] absolute squared close radius, or None; the second
        output sums over d2 <= min(r2, close_r2).
    The leading dimensions, if any, are batch entries, each its own
    problem.

    Returns (sums [..., Q,C], close_sums [..., Q,C] or None).

    CUDA kernel: ``csrc/moments.cu`` (replaces ``moments_pallas``,
    ``mulls_tpu/ops/kernels.py:157-262``): query tiles x support chunks
    (x batch entries), merged in chunk order, so two launches give the
    same bits and an entry of a batch those of its launch alone."""
    dev = q_xyz.device
    lead = tuple(q_xyz.shape[:-2])
    qn, pn = q_xyz.shape[-2], p_xyz.shape[-2]
    cn = feat_stack.shape[-1] if feat_stack.dim() == len(lead) + 2 else -1
    _check("q_xyz", q_xyz, torch.float32, (*lead, qn, 3), dev)
    _check("p_xyz", p_xyz, torch.float32, (*lead, pn, 3), dev)
    _check("p_mask", p_mask, torch.bool, (*lead, pn), dev)
    _check("r2", r2, torch.float32, (*lead, qn), dev)
    _check("feat_stack", feat_stack, torch.float32, (*lead, pn, cn), dev)
    if close_r2 is not None:
        _check("close_r2", close_r2, torch.float32, (*lead, qn), dev)
    if not 1 <= cn <= MOMENTS_MAX_C:
        raise ValueError(f"moments: feature width {cn} outside "
                         f"[1, {MOMENTS_MAX_C}]")
    if not _dispatch(dev):
        return moments_plain(q_xyz, p_xyz, p_mask, r2, feat_stack, close_r2)
    lib = library()
    n_seq = math.prod(lead)
    sums = torch.empty((*lead, qn, cn), dtype=torch.float32, device=dev)
    # per-chunk partial sums, added in chunk order by the kernel
    part_shape = (n_seq, max(1, -(-pn // MOMENTS_CHUNK)), qn, cn)
    partial = torch.empty(part_shape, dtype=torch.float32, device=dev)
    csums = cpartial = None
    if close_r2 is not None:
        csums = torch.empty((*lead, qn, cn), dtype=torch.float32, device=dev)
        cpartial = torch.empty(part_shape, dtype=torch.float32, device=dev)
    if qn == 0 or n_seq == 0:  # nothing to launch
        return sums, csums
    _, counters = _scratch(q_xyz, 0, n_seq * -(-qn // MOMENTS_TILE_Q))
    _check_launch(lib.mulls_moments(
        _ptr(q_xyz), _ptr(r2), _ptr(close_r2), _ptr(p_xyz), _ptr(p_mask),
        _ptr(feat_stack), qn, pn, cn, n_seq, _ptr(partial), _ptr(cpartial),
        _ptr(counters), _ptr(sums), _ptr(csums), _stream(q_xyz)), "moments")
    _count(moments)
    return sums, csums


# --------------------------------------------------------------------------
# PCA moments about each query point
# --------------------------------------------------------------------------

def pca_moments_plain(q_xyz: torch.Tensor, p_xyz: torch.Tensor,
                      p_mask: torch.Tensor, r2: torch.Tensor,
                      chunk: int = 512
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch query-centred moments over [chunk, P] blocks, each
    batch entry on its own."""
    if q_xyz.dim() > 2:
        return _per_entry(
            lambda q, p, m, r: pca_moments_plain(q, p, m, r, chunk),
            (q_xyz, p_xyz, p_mask, r2), 2)
    cnt, s1, s2 = [], [], []
    for s in range(0, q_xyz.shape[0], chunk):
        qc = q_xyz[s:s + chunk]
        d2 = sqdist_direct(qc, p_xyz)
        a = (p_mask[None, :] & (d2 <= r2[s:s + chunk, None])).to(
            torch.float32)
        ex = p_xyz[None, :, 0] - qc[:, 0:1]
        ey = p_xyz[None, :, 1] - qc[:, 1:2]
        ez = p_xyz[None, :, 2] - qc[:, 2:3]
        ax, ay, az = a * ex, a * ey, a * ez
        cnt.append(a.sum(1))
        s1.append(torch.stack([ax.sum(1), ay.sum(1), az.sum(1)], -1))
        s2.append(torch.stack([(ax * ex).sum(1), (ax * ey).sum(1),
                               (ax * ez).sum(1), (ay * ey).sum(1),
                               (ay * ez).sum(1), (az * ez).sum(1)], -1))
    if not cnt:  # no queries
        z = q_xyz.new_zeros
        return z((0,)), z((0, 3)), z((0, 6))
    return torch.cat(cnt), torch.cat(s1), torch.cat(s2)


_SMS = 132  # streaming multiprocessors of an H100 SXM
PCA_MIN_CHUNK = 128  # half a stage: 8 votes a lane


def pca_chunk(qn: int, pn: int) -> int:
    """Support points per block of ``csrc/pca_moments.cu``: PCA_CHUNK,
    halved while the grid has fewer blocks than the card has SMs, down to
    PCA_MIN_CHUNK.  The frame's 10240 x 20480 keeps 1024 (1600 blocks);
    the map refresh's 1536 x 1536 takes 128 (144 blocks), its 1024 x 1024
    also 128 (64 blocks).  Below 128 points a block's fixed work (its
    queries, the lane reduction, its partial row, the tile's merge) would
    outweigh its pairs."""
    tiles = -(-qn // PCA_TILE_Q)
    chunk = PCA_CHUNK
    while chunk > PCA_MIN_CHUNK and tiles * -(-pn // chunk) < _SMS:
        chunk //= 2
    return chunk


def pca_moments(q_xyz: torch.Tensor, p_xyz: torch.Tensor,
                p_mask: torch.Tensor, r2: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(count [..., Q], sum(p - q) [..., Q,3], sum((p - q)(p - q)^T) upper
    [..., Q,6]) over valid support within each query's radius — moments
    about the query point; feed straight into ``cov_from_moments``
    (covariance is shift-invariant).  Leading dimensions are batch entries,
    each its own problem.

    CUDA kernel: ``csrc/pca_moments.cu`` (replaces ``pca_moments_pallas``,
    ``mulls_tpu/ops/kernels.py:269-347``): query tiles x support chunks
    (:func:`pca_chunk`, chosen from one entry's sizes) x batch entries, a
    warp vote per four points so that a miss costs only the distance and
    the compare, sums centred at each query in fp32 and merged in chunk
    order, so two launches give the same bits and an entry of a batch
    those of its launch alone."""
    dev = q_xyz.device
    lead = tuple(q_xyz.shape[:-2])
    qn, pn = q_xyz.shape[-2], p_xyz.shape[-2]
    _check("q_xyz", q_xyz, torch.float32, (*lead, qn, 3), dev)
    _check("p_xyz", p_xyz, torch.float32, (*lead, pn, 3), dev)
    _check("p_mask", p_mask, torch.bool, (*lead, pn), dev)
    _check("r2", r2, torch.float32, (*lead, qn), dev)
    if not _dispatch(dev):
        return pca_moments_plain(q_xyz, p_xyz, p_mask, r2)
    lib = library()
    n_seq = math.prod(lead)
    cnt = torch.empty((*lead, qn), dtype=torch.float32, device=dev)
    s1 = torch.empty((*lead, qn, 3), dtype=torch.float32, device=dev)
    s2 = torch.empty((*lead, qn, 6), dtype=torch.float32, device=dev)
    if qn == 0 or n_seq == 0:  # nothing to launch
        return cnt, s1, s2
    chunk = pca_chunk(qn, pn)
    # per-chunk partial sums, added in chunk order by the kernel
    partial = torch.empty((n_seq, max(1, -(-pn // chunk)), qn, 10),
                          dtype=torch.float32, device=dev)
    _, counters = _scratch(q_xyz, 0, n_seq * -(-qn // PCA_TILE_Q))
    _check_launch(lib.mulls_pca_moments(
        _ptr(q_xyz), _ptr(r2), _ptr(p_xyz), _ptr(p_mask), qn, pn, chunk,
        n_seq, _ptr(partial), _ptr(counters), _ptr(cnt), _ptr(s1), _ptr(s2),
        _stream(q_xyz)), "pca_moments")
    _count(pca_moments)
    return cnt, s1, s2


# --------------------------------------------------------------------------
# count of valid support within the radius
# --------------------------------------------------------------------------

_COUNT_PLAIN_CHUNK = 1024  # queries per block of the plain version


def count_within_plain(q_xyz: torch.Tensor, p_xyz: torch.Tensor,
                       p_mask: torch.Tensor, r2: torch.Tensor
                       ) -> torch.Tensor:
    """Plain PyTorch count over [chunk, P] adjacency blocks."""
    parts = []
    for s in range(0, max(q_xyz.shape[0], 1), _COUNT_PLAIN_CHUNK):
        d2 = sqdist_direct(q_xyz[s:s + _COUNT_PLAIN_CHUNK], p_xyz)
        adj = p_mask[None, :] & (d2 <= r2[s:s + _COUNT_PLAIN_CHUNK, None])
        parts.append(adj.sum(1).to(torch.float32))
    return torch.cat(parts)


class CellIndex(NamedTuple):
    """The valid support sorted by the key of its cell (:func:`cell_index`).

    ``points`` float32 [N, 4]: (x, y, z, 1) in key order, N the valid
    points; ``keys`` int64 [N], sorted; ``lo`` and ``top`` float64 [3] (on
    the device), the box's low corner and the last cell along each axis;
    ``h`` the cell side; ``dims`` the cells along x, y and z.  A point's
    cell is ``floor((p - lo) / h)`` in float64, clamped to the grid, and its
    key ``cx + dims[0] * (cy + dims[1] * cz)``."""
    points: torch.Tensor
    keys: torch.Tensor
    lo: torch.Tensor
    top: torch.Tensor
    h: float
    dims: Tuple[int, int, int]


# The cell side is sqrt(max r2) times (1 + _CELL_MARGIN): a pair that the
# float32 distance puts within r is then less than one cell apart along each
# axis in the float64 cell coordinates, whose own rounding is ~1e-16.  The
# side never goes below the box's extent / _MAX_CELLS, so keys stay below
# 2^61, nor below _MIN_CELL metres.
_CELL_MARGIN = 1e-5
_MAX_CELLS = 1 << 20
_MIN_CELL = 1e-6


def _cells(xyz: torch.Tensor, lo: torch.Tensor, top: torch.Tensor,
           h: float) -> torch.Tensor:
    """int64 [N, 3]: the cell of each point, clamped to the grid; a NaN
    coordinate (of a point that no compare counts) takes cell 0."""
    u = torch.floor((xyz.to(torch.float64) - lo) / h)
    u = torch.nan_to_num(u, nan=0.0, posinf=math.inf, neginf=-math.inf)
    return torch.minimum(torch.clamp(u, min=0.0), top).to(torch.int64)


def _keys(cells: torch.Tensor, dims: Tuple[int, int, int]) -> torch.Tensor:
    return cells[:, 0] + dims[0] * (cells[:, 1] + dims[1] * cells[:, 2])


def cell_index(p_xyz: torch.Tensor, p_mask: torch.Tensor,
               r2: torch.Tensor) -> CellIndex:
    """The grid index of ``csrc/count_within.cu``: the valid support sorted
    (stably) by cell key, in a grid of side ``sqrt(max r2)`` plus a margin
    over the valid support's bounding box.  Plain tensor ops on any device,
    O(P) memory whatever the box, and one host sync (the box, the largest
    radius and the number of valid points).

    Non-finite values count nowhere unless a radius is infinite, so the
    box holds the finite valid points, the side the largest non-NaN
    radius: a NaN radius counts nothing, and an infinite one makes the
    side infinite, a grid of one cell that every query walks whole."""
    dev = p_xyz.device
    m = (p_mask & torch.isfinite(p_xyz).all(1))[:, None]
    f64 = torch.float64
    none = torch.zeros(3, dtype=f64, device=dev)
    host = torch.cat([
        torch.where(m, p_xyz, math.inf).amin(0).to(f64) if len(p_xyz)
        else none,
        torch.where(m, p_xyz, -math.inf).amax(0).to(f64) if len(p_xyz)
        else none,
        (torch.where(torch.isnan(r2), -math.inf, r2).amax().to(f64)
         if r2.numel() else none[0]).reshape(1),
        p_mask.sum().to(f64).reshape(1),
        m.sum().to(f64).reshape(1)]).cpu().tolist()
    n = int(host[7])
    lo, hi = (host[:3], host[3:6]) if host[8] else ([0.0] * 3, [0.0] * 3)
    extent = max(b - a for a, b in zip(lo, hi))
    h = max(math.sqrt(max(host[6], 0.0)) * (1.0 + _CELL_MARGIN),
            extent / _MAX_CELLS, _MIN_CELL)
    dims = tuple(int(math.floor((b - a) / h)) + 1 for a, b in zip(lo, hi))
    # one copy to the device, made while its queue is empty after the sync
    lo_top = torch.tensor([*lo, *(d - 1 for d in dims)], dtype=torch.float64,
                          device=dev)
    lo_t, top = lo_top[:3], lo_top[3:]
    # invalid points take the largest key and sort past the valid ones
    keys = torch.where(p_mask, _keys(_cells(p_xyz, lo_t, top, h), dims),
                       torch.iinfo(torch.int64).max)
    keys, order = torch.sort(keys, stable=True)
    valid = p_xyz[order[:n]]
    points = torch.cat([valid, torch.ones_like(valid[:, :1])], 1)
    return CellIndex(points, keys[:n].contiguous(), lo_t, top, h, dims)


def query_cells(q_xyz: torch.Tensor, index: CellIndex
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order int64 [Q], cells int64 [Q, 3]): the queries sorted stably by
    the key of their cell (clamped to the grid), and the cell of query
    ``order[i]`` at row i."""
    cells = _cells(q_xyz, index.lo, index.top, index.h)
    _, order = torch.sort(_keys(cells, index.dims), stable=True)
    return order, cells[order]


def neighbour_ranges(cells: torch.Tensor, index: CellIndex
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start, end) int64 [Q, 9]: for each query cell, the ranges of
    ``index.points`` in its 3 x 3 (y, z) neighbour rows, each the x-run of
    up to three cells around it; an empty range outside the grid.  The
    kernel finds the same ranges by binary search."""
    dx, dy, dz = index.dims
    x0 = torch.clamp(cells[:, 0] - 1, min=0)
    x1 = torch.clamp(cells[:, 0] + 1, max=dx - 1)
    starts, ends = [], []
    for oz in (-1, 0, 1):
        for oy in (-1, 0, 1):
            y, z = cells[:, 1] + oy, cells[:, 2] + oz
            inside = (y >= 0) & (y < dy) & (z >= 0) & (z < dz)
            row = dx * (y + dy * z)
            s = torch.searchsorted(index.keys, row + x0)
            e = torch.searchsorted(index.keys, row + x1 + 1)
            starts.append(torch.where(inside, s, 0))
            ends.append(torch.where(inside, e, 0))
    return torch.stack(starts, 1), torch.stack(ends, 1)


def candidate_pairs(q_xyz: torch.Tensor, p_xyz: torch.Tensor,
                    p_mask: torch.Tensor, r2: torch.Tensor) -> int:
    """The (query, support) pairs :func:`count_within`'s kernel forms on
    these inputs: the valid support in the 27 cells around each query with
    r2 >= 0.  A measure of the walk's own work, which its design sets; the
    function's bound counts only the hits."""
    index = cell_index(p_xyz, p_mask, r2)
    order, cells = query_cells(q_xyz, index)
    start, end = neighbour_ranges(cells, index)
    walks = (r2[order] >= 0)[:, None]
    return int(torch.where(walks, end - start, 0).sum())


def count_within(q_xyz: torch.Tensor, p_xyz: torch.Tensor,
                 p_mask: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """float32 [Q]: for each query, the number of valid support points with
    ((q-p)_x^2 + (q-p)_y^2) + (q-p)_z^2 <= r2[q].

    CUDA kernel: ``csrc/count_within.cu`` (replaces ``_kernel_dist_only``,
    ``tools/perf_mfu_roofline.py:69-81``): the support sorted into a cell
    grid by :func:`cell_index`, the queries sorted by the same key, and one
    thread a query walking the 27 cells around it, so each count is one
    integer sum and equals the plain version exactly in every launch."""
    dev = q_xyz.device
    qn, pn = q_xyz.shape[0], p_xyz.shape[0]
    _check("q_xyz", q_xyz, torch.float32, (qn, 3), dev)
    _check("p_xyz", p_xyz, torch.float32, (pn, 3), dev)
    _check("p_mask", p_mask, torch.bool, (pn,), dev)
    _check("r2", r2, torch.float32, (qn,), dev)
    if not _dispatch(dev):
        return count_within_plain(q_xyz, p_xyz, p_mask, r2)
    out = torch.empty((qn,), dtype=torch.float32, device=dev)
    if qn == 0:  # nothing to launch
        return out
    index = cell_index(p_xyz, p_mask, r2)
    order, cells = query_cells(q_xyz, index)
    cells = cells.to(torch.int32).contiguous()
    _check_launch(library().mulls_count_within(
        _ptr(q_xyz), _ptr(r2), _ptr(order), _ptr(cells), _ptr(index.points),
        _ptr(index.keys), qn, index.keys.shape[0], *index.dims, _ptr(out),
        _stream(q_xyz)), "count_within")
    _count(count_within)
    return out


