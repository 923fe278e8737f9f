"""Host-side readers and writers, copied from the JAX package so that the
port installs and runs without it: numpy readers, and the native C++
reader of ``io/native.py`` (built with g++ at first use)."""

from mulls_tpu_torch.io.pcd import read_pcd, write_pcd
from mulls_tpu_torch.io.kitti import (
    read_kitti_bin,
    read_kitti_calib,
    read_kitti_poses,
    write_kitti_poses,
    apply_calibration,
)
from mulls_tpu_torch.io.dataset import FolderDataset, read_point_cloud

__all__ = [
    "read_pcd", "write_pcd", "read_kitti_bin", "read_kitti_calib",
    "read_kitti_poses", "write_kitti_poses", "apply_calibration",
    "FolderDataset", "read_point_cloud",
]
