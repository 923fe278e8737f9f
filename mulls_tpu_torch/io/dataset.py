"""Folder datasets + padding to the static shape contract (host side).

The reference scans a folder (optionally via ``_filelist.txt``) and
dispatches on extension (`dataio.hpp:875-1086, 1732`).  Here a
:class:`FolderDataset` yields numpy dicts padded to ``ShapeConfig.n_raw``
with validity masks, ready to be shipped to device.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional

import numpy as np

from mulls_tpu_torch.io import native as nio
from mulls_tpu_torch.io.kitti import read_kitti_bin, read_kitti_labels
from mulls_tpu_torch.io.pcd import read_pcd, write_pcd

_EXTS = (".pcd", ".bin", ".txt", ".csv", ".ply", ".las", ".h5")


def read_point_cloud(path: str) -> dict:
    """Extension-dispatching reader (parity: `dataio.hpp:147-446`).
    Returns {'xyz': [N,3] f32, 'intensity': [N] f32, ...}."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pcd":
        return read_pcd(path)
    if ext == ".bin":
        return read_kitti_bin(path)
    if ext in (".txt", ".csv"):
        delim = "," if ext == ".csv" else None
        raw = np.loadtxt(path, delimiter=delim, dtype=np.float64)
        raw = np.atleast_2d(raw)
        out = {"xyz": raw[:, :3].astype(np.float32)}
        out["intensity"] = (raw[:, 3].astype(np.float32) if raw.shape[1] > 3
                            else np.zeros(len(raw), np.float32))
        return out
    if ext == ".ply":
        return _read_ply(path)
    if ext == ".las":
        return _read_las(path)
    if ext == ".h5":
        return _read_h5(path)
    raise ValueError(f"unsupported point cloud format: {ext}")


def _read_ply(path: str) -> dict:
    """Minimal PLY reader (ascii + binary_little_endian, float32 props)."""
    with open(path, "rb") as f:
        fmt = None
        n = 0
        props: List[str] = []
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n = int(line.split()[2])
            elif line.startswith("property") and n and "list" not in line:
                props.append(line.split()[-1])
            elif line == "end_header":
                break
        dtype = np.dtype([(p, "f4") for p in props])
        if fmt == "ascii":
            raw = np.loadtxt(f, dtype=np.float32, max_rows=n)
            arr = np.core.records.fromarrays(np.atleast_2d(raw).T, dtype=dtype)
        else:
            arr = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
    out = {"xyz": np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float32)}
    out["intensity"] = (np.asarray(arr["intensity"], np.float32)
                        if "intensity" in props else np.zeros(n, np.float32))
    return out


def pad_cloud(data: dict, n_raw: int, rng: Optional[np.random.Generator] = None
              ) -> dict:
    """Pad (or subsample) to the static capacity; adds 'mask' and 'ts_ratio'.

    If the scan exceeds capacity, a uniform random subset is kept (the
    reference would keep all points; capacity is sized to avoid this on the
    target datasets).
    """
    xyz = data["xyz"]
    n = len(xyz)
    intensity = data.get("intensity", np.zeros(n, np.float32))
    label = data.get("label")
    ts = data.get("ts_ratio")
    if ts is None:
        # azimuth fallback prep is done on device; store ordinal ratio here
        ts = (np.arange(n, dtype=np.float32) / max(n - 1, 1))
    if n > n_raw:
        rng = rng or np.random.default_rng(0)
        keep = rng.choice(n, n_raw, replace=False)
        keep.sort()
        xyz, intensity, ts = xyz[keep], intensity[keep], ts[keep]
        if label is not None:
            label = label[keep]
        n = n_raw
    out_xyz = np.zeros((n_raw, 3), np.float32)
    out_int = np.zeros((n_raw,), np.float32)
    out_ts = np.zeros((n_raw,), np.float32)
    mask = np.zeros((n_raw,), bool)
    out_xyz[:n] = xyz
    out_int[:n] = np.asarray(intensity, np.float32).reshape(-1)[:n]
    out_ts[:n] = ts
    mask[:n] = True
    out = {"xyz": out_xyz, "intensity": out_int, "ts_ratio": out_ts,
           "mask": mask}
    if label is not None:
        out_lab = np.zeros((n_raw,), np.int32)
        out_lab[:n] = np.asarray(label).reshape(-1)[:n]
        out["label"] = out_lab
    return out


class FolderDataset:
    """Iterates a folder of point-cloud files in sorted order, padded to the
    shape contract.  Mirrors `batch_read_filenames_in_folder` +
    `read_pc_cloud_block` (`dataio.hpp:875-1086`).

    Decoding uses the native C++ runtime (``io/native.py``) when its
    library builds and loads, including a worker-pool prefetch ring when
    iterating and packed segments for the odometry prefetch, and the numpy
    readers of this package otherwise.  ``native=False`` forces the numpy
    readers.
    """

    def __init__(self, root: str, n_raw: int, ext: Optional[str] = None,
                 begin: int = 0, end: Optional[int] = None, step: int = 1,
                 native: bool = True):
        names = sorted(os.listdir(root))
        files = [os.path.join(root, f) for f in names
                 if f.lower().endswith(ext or _EXTS)]
        self.files = files[begin:end:step]
        self.n_raw = n_raw
        self._native = native and nio.native_available()

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> dict:
        if self._native:
            out = nio.read_cloud_native(self.files[i], self.n_raw)
            if out is not None:
                return out
        return pad_cloud(read_point_cloud(self.files[i]), self.n_raw)

    def __iter__(self) -> Iterator[dict]:
        if self._native:
            # a file the library cannot read raises IOError here, as the
            # numpy reader raises on it
            with nio.NativePrefetcher(self.files, self.n_raw) as pf:
                yield from pf
            return
        for i in range(len(self)):
            yield self[i]

    def packed_segments(self, segment: int):
        """Native fast path: segments of frames decoded AND quantized to
        the wire format by the C++ worker pool
        (:class:`io.native.PackedSegmentPrefetcher`), or None."""
        if not self._native:
            return None
        return nio.PackedSegmentPrefetcher(self.files, self.n_raw, segment)


class SemanticKittiDataset(FolderDataset):
    """KITTI velodyne folder + Semantic-KITTI labels folder
    (`cfilter.hpp:2448-2608`, `tools/semantic_kitti_api.h`)."""

    def __init__(self, velodyne_root: str, label_root: str, n_raw: int,
                 begin: int = 0, end: Optional[int] = None, step: int = 1):
        super().__init__(velodyne_root, n_raw, ext=".bin", begin=begin,
                         end=end, step=step)
        self.label_files = [
            os.path.join(label_root,
                         os.path.splitext(os.path.basename(f))[0] + ".label")
            for f in self.files]

    def __getitem__(self, i: int) -> dict:
        data = read_point_cloud(self.files[i])
        data["label"] = read_kitti_labels(self.label_files[i])
        return pad_cloud(data, self.n_raw)

    def __iter__(self) -> Iterator[dict]:
        # labels must ride along: bypass the native (label-less) prefetcher
        for i in range(len(self)):
            yield self[i]

    def packed_segments(self, segment: int):
        return None  # labels must ride along; use the numpy pack path


def write_point_cloud(path: str, xyz: np.ndarray,
                      intensity: Optional[np.ndarray] = None,
                      subsample_ratio: int = 1,
                      geo_shift: Optional[np.ndarray] = None) -> int:
    """Extension-dispatching writer (`DataIo::write_cloud_file`,
    `dataio.hpp:223-287` → pcd/las/ply/txt writers :289-874).

    ``subsample_ratio`` keeps every k-th point (`write_txt_file` overload,
    `dataio.hpp:846-874`, applied to every format here).  ``geo_shift`` is
    the reference's LAS global-shift translation (`dataio.hpp:635-768`):
    added to the coordinates on write (LAS f64 offsets absorb it losslessly).
    Returns the number of points written.
    """
    xyz = np.asarray(xyz, np.float64)[::max(1, subsample_ratio)]
    inten = (np.asarray(intensity, np.float32)[::max(1, subsample_ratio)]
             if intensity is not None else np.zeros(len(xyz), np.float32))
    if geo_shift is not None:
        xyz = xyz + np.asarray(geo_shift, np.float64)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pcd":
        write_pcd(path, xyz.astype(np.float32), inten)
    elif ext == ".las":
        _write_las(path, xyz, inten)
    elif ext == ".ply":
        _write_ply(path, xyz, inten)
    elif ext in (".txt", ".csv"):
        sep = "," if ext == ".csv" else "  "
        np.savetxt(path, xyz, fmt="%.6f", delimiter=sep)
    elif ext == ".bin":  # KITTI layout: x y z i float32, i in [0,1]
        np.concatenate([xyz.astype(np.float32),
                        inten[:, None] / 255.0], axis=1).tofile(path)
    else:
        raise ValueError(f"unsupported output format: {ext}")
    return len(xyz)


def _write_las(path: str, xyz: np.ndarray, inten: np.ndarray) -> None:
    """Minimal LAS 1.2 point-format-0 writer (scaled int32 xyz + u16
    intensity; header layout mirrors `_read_las`)."""
    import struct as _s
    n = len(xyz)
    offset = xyz.min(axis=0) if n else np.zeros(3)
    scale = np.full(3, 1e-3)
    hdr = bytearray(227)
    hdr[0:4] = b"LASF"
    hdr[24] = 1  # version major
    hdr[25] = 2  # version minor
    _s.pack_into("<H", hdr, 94, 227)   # header size
    _s.pack_into("<I", hdr, 96, 227)   # offset to point data
    hdr[104] = 0                       # point data format 0
    _s.pack_into("<H", hdr, 105, 20)   # record length
    _s.pack_into("<I", hdr, 107, n)
    _s.pack_into("<3d", hdr, 131, *scale)
    _s.pack_into("<3d", hdr, 155, *offset)
    mx, mn = (xyz.max(axis=0), xyz.min(axis=0)) if n else (offset, offset)
    _s.pack_into("<6d", hdr, 179, mx[0], mn[0], mx[1], mn[1], mx[2], mn[2])
    q = np.round((xyz - offset) / scale).astype("<i4")
    rec = np.zeros((n, 20), np.uint8)
    rec[:, 0:12] = q.astype("<i4").view(np.uint8).reshape(n, 12)
    rec[:, 12:14] = np.clip(inten, 0, 65535).astype("<u2") \
        .view(np.uint8).reshape(n, 2)
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(rec.tobytes())


def _write_ply(path: str, xyz: np.ndarray, inten: np.ndarray) -> None:
    """Binary little-endian PLY with x/y/z/intensity float properties
    (`DataIo::write_ply_file`, `dataio.hpp:779-820`)."""
    n = len(xyz)
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property float intensity\nend_header\n")
    body = np.concatenate([xyz.astype("<f4"),
                           inten.astype("<f4")[:, None]], axis=1)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(body.tobytes())


def _read_las(path: str) -> dict:
    """Minimal LAS 1.2-1.4 reader (scaled int32 xyz + u16 intensity)."""
    with open(path, "rb") as f:
        hdr = f.read(375)
        if hdr[:4] != b"LASF":
            raise ValueError(f"not a LAS file: {path}")
        import struct as _s
        data_off = _s.unpack_from("<I", hdr, 96)[0]
        rec_len = _s.unpack_from("<H", hdr, 105)[0]
        n = _s.unpack_from("<I", hdr, 107)[0]
        if n == 0 and hdr[25] >= 4 and len(hdr) >= 255:
            n = _s.unpack_from("<Q", hdr, 247)[0]
        sx, sy, sz = _s.unpack_from("<3d", hdr, 131)
        ox, oy, oz = _s.unpack_from("<3d", hdr, 155)
        f.seek(data_off)
        buf = f.read(n * rec_len)
    rec = np.frombuffer(buf, dtype=np.uint8).reshape(-1, rec_len)
    xi = rec[:, 0:4].copy().view("<i4")[:, 0]
    yi = rec[:, 4:8].copy().view("<i4")[:, 0]
    zi = rec[:, 8:12].copy().view("<i4")[:, 0]
    xyz = np.stack([xi * sx + ox, yi * sy + oy, zi * sz + oz],
                   -1).astype(np.float32)
    inten = (rec[:, 12:14].copy().view("<u2")[:, 0].astype(np.float32)
             if rec_len >= 14 else np.zeros(len(rec), np.float32))
    return {"xyz": xyz, "intensity": inten}


def _read_h5(path: str) -> dict:
    """HESAI *.h5 scans (`h5_io.hpp`): datasets x/y/z/intensity (+ts),
    either flat or [rows, cols] range-image layout."""
    import h5py
    with h5py.File(path, "r") as f:
        x = np.asarray(f["x"], np.float32).ravel()
        y = np.asarray(f["y"], np.float32).ravel()
        z = np.asarray(f["z"], np.float32).ravel()
        inten = (np.asarray(f["intensity"], np.float32).ravel()
                 if "intensity" in f else np.zeros_like(x))
        out = {"xyz": np.stack([x, y, z], -1), "intensity": inten}
        if "ts" in f:
            ts = np.asarray(f["ts"], np.float64).ravel()
            lo, hi = ts.min(), ts.max()
            out["ts_ratio"] = ((ts - lo) / max(hi - lo, 1e-9)
                               ).astype(np.float32)
    return out
