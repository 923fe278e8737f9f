"""End-of-run map assembly — port of ``mulls_tpu/mapping/assembly.py``
(`mulls_slam.cpp:959-1028`).

The reference program re-reads every scan, moves it by its (optimized)
pose, voxel-downsamples, SOR-filters, merges everything into one cloud and
writes a pcd and a 2D map image.  Here, as in the JAX package: frames
stream through a host voxel accumulation (one point per voxel of the
merged grid, like `cfilter.hpp:99-153`), outliers go by a radius-count
filter on the card (the per-point neighbour count of
``csrc/count_within.cu``; the reference's statistical outlier removal
serves the same purpose), and the BEV image is a height raster.  The host
functions are the reference's numpy, number for number.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from mulls_tpu_torch.core.device import resolve_device
from mulls_tpu_torch.io.pcd import write_pcd
from mulls_tpu_torch.ops import kernels


def accumulate_map(dataset, poses: np.ndarray, voxel_res: float = 0.25,
                   every_n: int = 1, max_points: int = 6_000_000,
                   dist_max: float = 90.0, downrate: int = 1) -> np.ndarray:
    """Merge transformed scans keeping one point per global voxel.

    ``downrate`` strides each frame's points before merging — the role of
    the reference's output-map random downsample
    (`--map_downrate_output`, `mulls_slam.cpp:970`)."""
    inv_res = 1.0 / voxel_res
    keys_acc: list = []   # pending voxel keys, first-seen order
    pts_acc: list = []

    def compact():
        """Dedupe pending chunks, keeping the FIRST point per voxel
        (np.unique's return_index is the first occurrence)."""
        if len(keys_acc) <= 1:
            return
        k = np.concatenate(keys_acc)
        p = np.concatenate(pts_acc)
        _, first = np.unique(k, return_index=True)
        first.sort()  # preserve first-seen order across frames
        keys_acc[:] = [k[first]]
        pts_acc[:] = [p[first]]

    for i in range(0, min(len(dataset), len(poses)), every_n):
        frame = dataset[i]
        m = frame["mask"]
        xyz = frame["xyz"][m]
        if downrate > 1:
            xyz = xyz[::downrate]
        r = np.linalg.norm(xyz, axis=1)
        xyz = xyz[(r > 1.5) & (r < dist_max)]
        world = xyz @ poses[i][:3, :3].T + poses[i][:3, 3]
        keys = np.floor(world * inv_res).astype(np.int64)
        lin = (keys[:, 0] * 73856093) ^ (keys[:, 1] * 19349663) \
            ^ (keys[:, 2] * 83492791)
        _, first = np.unique(lin, return_index=True)
        keys_acc.append(lin[first])
        pts_acc.append(world[first].astype(np.float32))
        if len(keys_acc) >= 24:
            compact()
            if len(keys_acc[0]) > max_points:
                break
    compact()
    if not keys_acc:
        return np.zeros((0, 3), np.float32)
    return pts_acc[0][:max_points]


def radius_outlier_filter(points: np.ndarray, radius: float = 1.0,
                          min_neighbors: int = 3,
                          device="cuda") -> np.ndarray:
    """Drop points with too few neighbours (plays the role of the
    reference's pcl SOR, `mulls_slam.cpp:992-999`).  The whole map goes to
    ``device`` once and is counted against itself by one
    ``kernels.count_within`` call (one cell index, one launch on the card)."""
    if len(points) == 0:
        return points
    dev = resolve_device(device)
    pts = torch.as_tensor(np.ascontiguousarray(points, np.float32),
                          device=dev)
    mask = torch.ones(len(points), dtype=torch.bool, device=dev)
    r2 = torch.full((len(points),), radius * radius, dtype=torch.float32,
                    device=dev)
    counts = kernels.count_within(pts, pts, mask, r2)
    keep = (counts >= min_neighbors + 1).cpu().numpy()  # self counts
    return points[keep]


def bev_image(points: np.ndarray, resolution: float = 0.5):
    """[N,3] -> (height_img [H,W] f32, extent) birds-eye height raster."""
    if len(points) == 0:
        return np.zeros((1, 1), np.float32), (0, 1, 0, 1)
    lo = points[:, :2].min(0)
    hi = points[:, :2].max(0)
    dims = np.maximum(((hi - lo) / resolution).astype(int) + 1, 1)
    img = np.full(dims[::-1], np.nan, np.float32)
    ij = ((points[:, :2] - lo) / resolution).astype(int)
    # max-height per cell
    order = np.argsort(points[:, 2])
    img[ij[order, 1], ij[order, 0]] = points[order, 2]
    return img, (lo[0], hi[0], lo[1], hi[1])


def write_map_outputs(points: np.ndarray, out_pcd: Optional[str] = None,
                      out_bev: Optional[str] = None,
                      bev_resolution: float = 0.5) -> None:
    if out_pcd:
        os.makedirs(os.path.dirname(out_pcd) or ".", exist_ok=True)
        write_pcd(out_pcd, points)
    if out_bev:
        os.makedirs(os.path.dirname(out_bev) or ".", exist_ok=True)
        img, extent = bev_image(points, bev_resolution)
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots(figsize=(10, 10))
            ax.imshow(img, origin="lower", extent=extent, cmap="viridis")
            ax.set_xlabel("x [m]")
            ax.set_ylabel("y [m]")
            fig.savefig(out_bev, dpi=150, bbox_inches="tight")
            plt.close(fig)
        except ImportError:
            np.save(os.path.splitext(out_bev)[0] + ".npy", img)


def range_image(points: np.ndarray, width: int = 900, height: int = 64,
                f_up_deg: float = 3.0, f_down_deg: float = 25.0,
                max_distance: float = 70.0) -> np.ndarray:
    """[N,3] -> [H,W] uint8 spherical range image — the reference's
    HDL-64 range-image display (`cfilter.hpp:2714-2746`
    ``pointcloud_to_rangeimage``): columns span azimuth, rows span the
    [-f_down, +f_up] elevation fan, pixel value = range / max_distance.
    """
    img = np.zeros((height, width), np.uint8)
    if len(points) == 0:
        return img
    pts = np.asarray(points, np.float64)
    dist = np.linalg.norm(pts, axis=-1)
    ok = dist > 1e-6
    pts, dist = pts[ok], dist[ok]
    hor = np.arctan2(pts[:, 1], pts[:, 0])
    ver = np.degrees(np.arcsin(np.clip(pts[:, 2] / dist, -1.0, 1.0)))
    col = np.clip((0.5 * (1.0 - hor / np.pi) * width).astype(int),
                  0, width - 1)
    row = np.clip(((1.0 - (f_up_deg - ver) / (f_up_deg + f_down_deg))
                   * height).astype(int), 0, height - 1)
    val = (255.0 * np.minimum(1.0, dist / max_distance)).astype(np.uint8)
    img[height - 1 - row, col] = val
    return img


def occupancy_2d_map(points: np.ndarray, m2pix: float = 10.0,
                     map_width: int = 1024, map_height: int = 1024,
                     min_points_in_pix: int = 2, max_points_in_pix: int = 10,
                     min_height: float = -1.0, max_height: float = 3.0,
                     center: bool = False) -> np.ndarray:
    """[N,3] -> [H,W] uint8 occupancy raster — the reference's
    pointcloud-to-2dmap export (`cfilter.hpp:2750-2795` ``generate_2d_map``):
    per-pixel point counts inside a height slab, linearly mapped so that
    ``min_points_in_pix`` -> 255 (free/white) and ``max_points_in_pix``
    -> 0 (occupied/black)."""
    counts = np.zeros((map_height, map_width), np.int64)
    if len(points):
        pts = np.asarray(points, np.float64)
        shift = pts[:, :2].mean(0) if center else np.zeros(2)
        sel = (pts[:, 2] >= min_height) & (pts[:, 2] <= max_height)
        pts = pts[sel]
        x = ((pts[:, 0] - shift[0]) * m2pix + map_width // 2).astype(int)
        y = (-(pts[:, 1] - shift[1]) * m2pix + map_height // 2).astype(int)
        inb = (x >= 0) & (x < map_width) & (y >= 0) & (y < map_height)
        np.add.at(counts, (y[inb], x[inb]), 1)
    scaled = 255.0 + (counts - min_points_in_pix) * (
        -255.0 / max(max_points_in_pix - min_points_in_pix, 1))
    return np.clip(scaled, 0, 255).astype(np.uint8)
