"""Minimal, fast PCD v0.7 reader/writer (numpy, host side).

Covers the subset the reference pipeline produces/consumes
(`dataio.hpp:279-313`): ascii and binary encodings, float32 fields,
arbitrary field sets (x y z [intensity] [normal_*] [curvature]).
"""

from __future__ import annotations

import numpy as np

_TYPEMAP = {("F", 4): "f4", ("F", 8): "f8", ("I", 4): "i4",
            ("I", 1): "i1", ("I", 2): "i2", ("U", 1): "u1",
            ("U", 2): "u2", ("U", 4): "u4"}


def read_pcd(path: str) -> dict:
    """Returns dict with at least 'xyz' [N,3] f32; 'intensity' [N] f32 if
    present; plus any other fields by name."""
    with open(path, "rb") as f:
        header = {}
        fields, sizes, types, counts = [], [], [], []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, rest = line.partition(" ")
            key = key.upper()
            header[key] = rest
            if key == "FIELDS":
                fields = rest.split()
            elif key == "SIZE":
                sizes = [int(s) for s in rest.split()]
            elif key == "TYPE":
                types = rest.split()
            elif key == "COUNT":
                counts = [int(c) for c in rest.split()]
            elif key == "DATA":
                data_mode = rest.strip()
                break
        n = int(header.get("POINTS", header.get("WIDTH", "0")))
        if not counts:
            counts = [1] * len(fields)
        dtype = np.dtype([
            (name if c == 1 else f"{name}", _TYPEMAP[(t, s)] if c == 1
             else (_TYPEMAP[(t, s)], (c,)))
            for name, s, t, c in zip(fields, sizes, types, counts)])
        if data_mode == "binary":
            arr = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        elif data_mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n)
            raw = np.atleast_2d(raw)
            arr = np.zeros(n, dtype=dtype)
            col = 0
            for name, c in zip(fields, counts):
                if c == 1:
                    arr[name] = raw[:, col].astype(dtype[name])
                else:
                    arr[name] = raw[:, col:col + c].astype(dtype[name].base)
                col += c
        else:
            raise ValueError(f"unsupported PCD DATA mode: {data_mode}")
    out = {}
    xyz = np.stack([arr["x"], arr["y"], arr["z"]], axis=-1).astype(np.float32)
    out["xyz"] = xyz
    for name in fields:
        if name in ("x", "y", "z"):
            continue
        out[name] = np.asarray(arr[name])
    if "intensity" not in out:
        out["intensity"] = np.zeros(len(xyz), np.float32)
    return out


def write_pcd(path: str, xyz: np.ndarray, intensity: np.ndarray | None = None,
              normals: np.ndarray | None = None, binary: bool = True,
              extra_fields: dict | None = None) -> None:
    n = len(xyz)
    fields = ["x", "y", "z"]
    cols = [xyz[:, 0], xyz[:, 1], xyz[:, 2]]
    if intensity is not None:
        fields.append("intensity")
        cols.append(intensity)
    if normals is not None:
        fields += ["normal_x", "normal_y", "normal_z"]
        cols += [normals[:, 0], normals[:, 1], normals[:, 2]]
    for name, col in (extra_fields or {}).items():
        fields.append(name)
        cols.append(np.asarray(col, np.float32))
    data = np.stack(cols, axis=-1).astype(np.float32)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(['4'] * len(fields))}\n"
        f"TYPE {' '.join(['F'] * len(fields))}\n"
        f"COUNT {' '.join(['1'] * len(fields))}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(data.tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")
