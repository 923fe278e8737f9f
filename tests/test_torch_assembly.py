"""The port's map assembly (``mapping/assembly.py``) and the map replay of
``apps/eval_run.py`` against the JAX package on the CPU, on the same numpy
inputs from a seed.

Tolerances: the host functions (``accumulate_map``, ``bev_image``,
``range_image``, ``occupancy_2d_map``) are the reference's numpy: equal
exactly.  ``radius_outlier_filter``: equal keep masks on points with no
pair distance within 1e-3 m of the radius (the packages form d^2
differently, ROADMAP section 3, so a pair on the radius may flip).  The
port's ``eval_run`` replay: its pcd equals the reference's replayed pcd
after the reference's filter.
"""

import numpy as np
import pytest

import __graft_entry__ as ge
from mulls_tpu.apps import eval_run as jeval
from mulls_tpu.io import kitti as jkitti
from mulls_tpu.mapping import assembly as ja
from mulls_tpu_torch.apps import eval_run as teval
from mulls_tpu_torch.io.pcd import read_pcd
from mulls_tpu_torch.mapping import assembly as ta

N_SCANS = 3


def _poses():
    rng = np.random.default_rng(31)
    gt = np.tile(np.eye(4), (N_SCANS, 1, 1))
    gt[:, 0, 3] = 0.6 * np.arange(N_SCANS)
    yaw = np.radians(2.0) * np.arange(N_SCANS)
    gt[:, 0, 0], gt[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    gt[:, 1, 0], gt[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    gt[:, :3, 3] += 0.01 * rng.normal(size=(N_SCANS, 3))
    return gt


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """KITTI-style .bin scans of a synthetic world, the frames as the
    dataset pads them, and a pose file."""
    root = tmp_path_factory.mktemp("assembly")
    (root / "velodyne").mkdir()
    cfg = ge._small_cfg()
    rng = np.random.default_rng(5)
    world = ge._make_world(5)
    for k, T in enumerate(_poses()):
        d = ge._render_scan(world, T, cfg, rng)
        m = d["mask"]
        rec = np.concatenate([d["xyz"][m], d["intensity"][m, None] / 255.0],
                             1).astype(np.float32)
        rec.tofile(root / "velodyne" / f"{k:06d}.bin")
    jkitti.write_kitti_poses(str(root / "poses.txt"), _poses())
    from mulls_tpu_torch.io.dataset import FolderDataset
    return root, list(FolderDataset(str(root / "velodyne"), 1 << 17))


@pytest.mark.parametrize("kw", [{}, {"voxel_res": 0.5, "downrate": 3},
                                {"every_n": 2, "dist_max": 20.0}])
def test_accumulate_map_equals_reference(scans, kw):
    _, frames = scans
    want = ja.accumulate_map(frames, _poses(), **kw)
    got = ta.accumulate_map(frames, _poses(), **kw)
    assert len(got) > 1000
    np.testing.assert_array_equal(got, want)


def test_host_images_equal_reference(scans):
    _, frames = scans
    pts = ta.accumulate_map(frames, _poses())
    img_t, ext_t = ta.bev_image(pts, 0.5)
    img_j, ext_j = ja.bev_image(pts, 0.5)
    np.testing.assert_array_equal(img_t, img_j)
    assert ext_t == ext_j
    np.testing.assert_array_equal(ta.range_image(frames[0]["xyz"]),
                                  ja.range_image(frames[0]["xyz"]))
    for center in (False, True):
        np.testing.assert_array_equal(
            ta.occupancy_2d_map(pts, center=center),
            ja.occupancy_2d_map(pts, center=center))
    for empty in (ta.bev_image(pts[:0])[0], ta.range_image(pts[:0]),
                  ta.occupancy_2d_map(pts[:0])):
        assert empty.size >= 1


def test_radius_outlier_filter_keeps_what_the_reference_keeps():
    rng = np.random.default_rng(17)
    dense = rng.uniform([-3, -3, -1], [3, 3, 1], (1500, 3))
    sparse = rng.uniform([-10, -10, -2], [10, 10, 2], (400, 3))
    pts = np.concatenate([dense, sparse])
    d = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))
    near_radius = np.any(np.abs(d - 1.0) < 1e-3, axis=1)
    pts = pts[~near_radius].astype(np.float32)
    assert len(pts) > 1500
    want = ja.radius_outlier_filter(pts)
    got = ta.radius_outlier_filter(pts, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert 100 < len(pts) - len(got) < 400  # the sparse points go
    assert len(ta.radius_outlier_filter(pts[:0], device="cpu")) == 0


def test_eval_run_replays_the_reference_map(scans, tmp_path):
    """The port's replay is the reference's, then the outlier filter (on the
    CPU here): its pcd equals the reference's replayed pcd after the
    reference's ``radius_outlier_filter``."""
    root, frames = scans
    pcds = []
    for mod, extra in ((jeval, []), (teval, ["--device", "cpu"])):
        out = tmp_path / mod.__name__
        argv = ["--est_pose_file", str(root / "poses.txt"),
                "--point_cloud_folder", str(root / "velodyne"),
                "--map_pcd_out", str(out / "map.pcd"),
                "--map_bev_out", str(out / "map.png")] + extra
        assert mod.main(argv) == 0
        assert (out / "map.png").stat().st_size > 0
        pcds.append(read_pcd(str(out / "map.pcd"))["xyz"])
    want = ja.radius_outlier_filter(pcds[0])
    assert 0 < len(want) < len(pcds[0])
    np.testing.assert_array_equal(pcds[1], want)
