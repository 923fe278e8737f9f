"""ctypes bindings for the native C++ IO runtime — port of
``mulls_tpu/io/native.py``.

The native layer (``mulls_tpu_torch/native/src/mulls_io.cpp``, the port's
own copy of the reference's source) plays the role of the reference's C++
DataIo (`dataio.hpp`): format decoding (KITTI .bin, PCD, PLY, txt/csv,
LAS) into the fixed-shape padded buffers, plus a worker-thread prefetch
ring so scan decode overlaps device compute, and a packed-segment ring
that also quantizes to the wire format of ``core/cloud.py``.

The library is built at first use with ``g++`` into
``build/mulls_tpu_torch_native/<source hash>/`` at the root of the
checkout (:func:`build_library`).  When no compiler or build is available,
:func:`load_library` returns None and ``io/dataset.py`` reads with its
numpy readers, as the reference does; :func:`native_available` says which
reader runs.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "native" / "src" / "mulls_io.cpp"
_CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
_LIB_NAME = "libmulls_io.so"


def build_root() -> Path:
    """``build/mulls_tpu_torch_native`` at the root of the checkout."""
    return Path(__file__).resolve().parents[2] / "build" / \
        "mulls_tpu_torch_native"


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_CXX_FLAGS).encode())
    return build_root() / h.hexdigest()[:16] / _LIB_NAME


def build_library() -> dict:
    """Compile ``mulls_io.cpp`` unless the library for this source exists.
    Returns ``{"path", "seconds", "built"}``; raises RuntimeError when
    there is no ``g++`` or the compile fails."""
    so = library_path()
    if so.exists():
        return {"path": str(so), "seconds": 0.0, "built": False}
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native IO library is built "
                           "with g++")
    t0 = time.perf_counter()
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.parent / f"tmp-{os.getpid()}-{_LIB_NAME}"
    r = subprocess.run([cxx, *_CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {_SRC.name}:\n{r.stdout}")
    os.replace(tmp, so)  # atomic: a concurrent build sees all or none
    return {"path": str(so), "seconds": time.perf_counter() - t0,
            "built": True}


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(build_library()["path"])
    except (RuntimeError, OSError, subprocess.TimeoutExpired):
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    vp, i = ctypes.c_void_p, ctypes.c_int
    paths = ctypes.POINTER(ctypes.c_char_p)
    lib.mio_read_cloud.argtypes = [ctypes.c_char_p, i, ctypes.c_uint64,
                                   f32p, f32p, f32p, u8p]
    lib.mio_read_cloud.restype = i
    lib.mio_prefetch_create.argtypes = [paths, i, i, i, i]
    lib.mio_prefetch_create.restype = vp
    lib.mio_prefetch_next.argtypes = [vp, f32p, f32p, f32p, u8p]
    lib.mio_prefetch_next.restype = i
    lib.mio_prefetch_destroy.argtypes = [vp]
    lib.mio_prefetch_destroy.restype = None
    lib.mio_packed_prefetch_create.argtypes = [paths, i, i, i, i, i]
    lib.mio_packed_prefetch_create.restype = vp
    lib.mio_packed_prefetch_next.argtypes = [
        vp, ctypes.POINTER(ctypes.c_int16), u8p,
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_int32)]
    lib.mio_packed_prefetch_next.restype = i
    lib.mio_packed_prefetch_destroy.argtypes = [vp]
    lib.mio_packed_prefetch_destroy.restype = None
    return lib


_load_lock = threading.Lock()


def load_library() -> Optional[ctypes.CDLL]:
    """The loaded library, or None (after one build attempt, made once when
    several threads ask at once)."""
    with _load_lock:
        return _load()


def native_available() -> bool:
    return load_library() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _paths(files: List[str]):
    return (ctypes.c_char_p * len(files))(*[f.encode() for f in files])


def _frame_buffers(n_raw: int):
    return (np.empty((n_raw, 3), np.float32), np.empty((n_raw,), np.float32),
            np.empty((n_raw,), np.float32), np.empty((n_raw,), np.uint8))


def _frame(xyz, intensity, ts, mask) -> dict:
    return {"xyz": xyz, "intensity": intensity, "ts_ratio": ts,
            "mask": mask.astype(bool)}


def read_cloud_native(path: str, n_raw: int, seed: int = 0) -> Optional[dict]:
    """Single-file native read into a padded frame dict, or None."""
    lib = load_library()
    if lib is None:
        return None
    xyz, intensity, ts, mask = _frame_buffers(n_raw)
    n = lib.mio_read_cloud(path.encode(), n_raw, seed,
                           _ptr(xyz, ctypes.c_float),
                           _ptr(intensity, ctypes.c_float),
                           _ptr(ts, ctypes.c_float),
                           _ptr(mask, ctypes.c_uint8))
    if n < 0:
        return None
    return _frame(xyz, intensity, ts, mask)


class NativePrefetcher:
    """Iterates padded frames decoded by the native worker pool, in order.

    Usage::
        with NativePrefetcher(files, n_raw) as pf:
            for frame in pf: ...
    """

    def __init__(self, files: List[str], n_raw: int, workers: int = 4,
                 depth: int = 8):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native IO library unavailable")
        self._lib = lib
        self._files = list(files)
        self._n_raw = n_raw
        self._handle = lib.mio_prefetch_create(
            _paths(self._files), len(self._files), n_raw, workers, depth)
        self._consumed = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._handle:
            self._lib.mio_prefetch_destroy(self._handle)
            self._handle = None

    def __len__(self) -> int:
        return len(self._files)

    def __iter__(self) -> Iterator[dict]:
        for _ in range(len(self._files)):
            xyz, intensity, ts, mask = _frame_buffers(self._n_raw)
            n = self._lib.mio_prefetch_next(
                self._handle, _ptr(xyz, ctypes.c_float),
                _ptr(intensity, ctypes.c_float), _ptr(ts, ctypes.c_float),
                _ptr(mask, ctypes.c_uint8))
            if n < 0:
                raise IOError(
                    f"native read failed (code {n}) at frame {self._consumed}"
                    f": {self._files[self._consumed]}")
            self._consumed += 1
            yield _frame(xyz, intensity, ts, mask)


class PackedSegmentPrefetcher:
    """Iterates whole SEGMENTS of frames already quantized to the wire
    format by the C++ workers ([segment, n_raw] batches, tail repeated).
    Yields (frames_in_batch, dict of packed numpy arrays: ``xyz_q`` int16
    [segment, n_raw, 3], ``intensity_q`` uint8, ``ts_q`` uint16, ``n``
    int32 [segment])."""

    def __init__(self, files: List[str], n_raw: int, segment: int,
                 workers: int = 4, depth: int = 3):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native IO library unavailable")
        self._lib = lib
        self._files = list(files)
        self._n_raw = n_raw
        self._segment = segment
        self._handle = lib.mio_packed_prefetch_create(
            _paths(self._files), len(self._files), n_raw, segment, workers,
            depth)
        self._batches = -(-len(files) // segment) if files else 0

    def close(self):
        if self._handle:
            self._lib.mio_packed_prefetch_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        n_raw, seg = self._n_raw, self._segment
        for _ in range(self._batches):
            xyz = np.empty((seg, n_raw, 3), np.int16)
            inten = np.empty((seg, n_raw), np.uint8)
            ts = np.empty((seg, n_raw), np.uint16)
            counts = np.empty((seg,), np.int32)
            k = self._lib.mio_packed_prefetch_next(
                self._handle, _ptr(xyz, ctypes.c_int16),
                _ptr(inten, ctypes.c_uint8), _ptr(ts, ctypes.c_uint16),
                _ptr(counts, ctypes.c_int32))
            if k < 0:
                return
            yield k, {"xyz_q": xyz, "intensity_q": inten, "ts_q": ts,
                      "n": counts}
