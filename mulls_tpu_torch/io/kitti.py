"""KITTI odometry dataset IO (host side, numpy).

Formats per the reference DataIo (`dataio.hpp:357-379` .bin reader,
`:1928-2002` calib/pose loaders, `:1896-1927` pose writers):

* velodyne ``.bin``: float32 records (x, y, z, intensity)
* ``calib.txt``: line ``Tr: r11 .. t3`` — LiDAR -> left-camera transform
* pose files: one 3x4 row-major matrix (12 floats) per line, camera frame
"""

from __future__ import annotations

import numpy as np


def read_kitti_bin(path: str) -> dict:
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return {"xyz": raw[:, :3].copy(), "intensity": raw[:, 3].copy() * 255.0}


def read_kitti_labels(path: str) -> np.ndarray:
    """Semantic-KITTI .label file: lower 16 bits = semantic class id."""
    raw = np.fromfile(path, dtype=np.uint32)
    return (raw & 0xFFFF).astype(np.int32)


def read_kitti_calib(path: str) -> np.ndarray:
    """Returns the 4x4 ``Tr`` (velodyne -> camera) matrix."""
    with open(path) as f:
        for line in f:
            if line.startswith("Tr"):
                vals = [float(v) for v in line.split(":", 1)[1].split()]
                T = np.eye(4, dtype=np.float64)
                T[:3, :4] = np.asarray(vals).reshape(3, 4)
                return T
    raise ValueError(f"no 'Tr' line in {path}")


def read_kitti_poses(path: str) -> np.ndarray:
    """[N, 4, 4] float64 poses from a KITTI 12-floats-per-line file."""
    rows = np.loadtxt(path, dtype=np.float64)
    rows = np.atleast_2d(rows)
    n = rows.shape[0]
    poses = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    poses[:, :3, :4] = rows[:, :12].reshape(n, 3, 4)
    return poses


def write_kitti_poses(path: str, poses: np.ndarray) -> None:
    rows = np.asarray(poses)[:, :3, :4].reshape(len(poses), 12)
    np.savetxt(path, rows, fmt="%.9e")


def apply_calibration(poses_cam: np.ndarray, calib: np.ndarray) -> np.ndarray:
    """Camera-frame GT poses -> LiDAR frame: ``Tr^-1 @ P @ Tr``
    (reference semantics at `mulls_slam.cpp:301-314`)."""
    inv = np.linalg.inv(calib)
    return np.einsum("ij,njk,kl->nil", inv, poses_cam, calib)


def uncalibrate(poses_lidar: np.ndarray, calib: np.ndarray) -> np.ndarray:
    """LiDAR-frame poses -> camera frame (for leaderboard-format output)."""
    inv = np.linalg.inv(calib)
    return np.einsum("ij,njk,kl->nil", calib, poses_lidar, inv)


def read_pose_quat(path: str, begin: int = 0, end: int = 10 ** 9,
                   step: int = 1) -> np.ndarray:
    """OXTS-style pose file (`load_poses_from_pose_quat`,
    `dataio.hpp:2003-2040`): each line ``index time tx ty tz qx qy qz qw``.
    Returns [N, 4, 4] float64."""
    rows = np.atleast_2d(np.loadtxt(path, dtype=np.float64))
    rows = rows[begin:end + 1:step]
    n = len(rows)
    poses = np.tile(np.eye(4), (n, 1, 1))
    t = rows[:, 2:5]
    qx, qy, qz, qw = rows[:, 5], rows[:, 6], rows[:, 7], rows[:, 8]
    norm = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / norm, qy / norm, qz / norm, qw / norm
    poses[:, 0, 0] = 1 - 2 * (qy * qy + qz * qz)
    poses[:, 0, 1] = 2 * (qx * qy - qz * qw)
    poses[:, 0, 2] = 2 * (qx * qz + qy * qw)
    poses[:, 1, 0] = 2 * (qx * qy + qz * qw)
    poses[:, 1, 1] = 1 - 2 * (qx * qx + qz * qz)
    poses[:, 1, 2] = 2 * (qy * qz - qx * qw)
    poses[:, 2, 0] = 2 * (qx * qz - qy * qw)
    poses[:, 2, 1] = 2 * (qy * qz + qx * qw)
    poses[:, 2, 2] = 1 - 2 * (qx * qx + qy * qy)
    poses[:, :3, 3] = t
    return poses


def write_pose_quat(path: str, poses: np.ndarray,
                    times: np.ndarray | None = None) -> None:
    """Writes the reference's quat pose format (index time t q)."""
    n = len(poses)
    times = np.zeros(n) if times is None else times
    with open(path, "w") as f:
        for i, (T, tm) in enumerate(zip(poses, times)):
            R = T[:3, :3]
            qw = 0.5 * np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12))
            qx = (R[2, 1] - R[1, 2]) / (4 * qw)
            qy = (R[0, 2] - R[2, 0]) / (4 * qw)
            qz = (R[1, 0] - R[0, 1]) / (4 * qw)
            f.write(f"{i}\t{tm:.6f}\t{T[0, 3]:.6f}\t{T[1, 3]:.6f}\t"
                    f"{T[2, 3]:.6f}\t{qx:.9f}\t{qy:.9f}\t{qz:.9f}\t"
                    f"{qw:.9f}\n")
