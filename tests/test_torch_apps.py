"""The port's host side against the JAX package: the numpy readers and
writers (copies), the KITTI drift metrics (a copy), the constraint-file
writer (a copy), and the CLI ``python -m mulls_tpu_torch.apps.slam`` on a
small scan folder, on the CPU: odometry, SLAM, the GICP baseline, the map
outputs with a profiler trace, and one frame's feature export."""

import time

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from mulls_tpu.eval import kitti_metrics as jmetrics
from mulls_tpu.io import kitti as jkitti
from mulls_tpu.io.dataset import FolderDataset as JFolderDataset
from mulls_tpu.io.pcd import read_pcd as j_read_pcd
from mulls_tpu_torch.apps import slam as tslam
from mulls_tpu_torch.eval import kitti_metrics as tmetrics
from mulls_tpu_torch.io import kitti as tkitti
from mulls_tpu_torch.io.dataset import FolderDataset as TFolderDataset
from mulls_tpu_torch.io.pcd import read_pcd as t_read_pcd
from mulls_tpu_torch.io.pcd import write_pcd as t_write_pcd

N_SCANS = 3
STEP_M = 0.6


def _gt():
    gt = np.tile(np.eye(4), (N_SCANS, 1, 1))
    gt[:, 0, 3] = STEP_M * np.arange(N_SCANS)
    return gt


@pytest.fixture(scope="module")
def scan_folder(tmp_path_factory):
    """KITTI-style .bin scans of a synthetic world, a ground-truth pose file
    and an identity calibration."""
    root = tmp_path_factory.mktemp("kitti")
    (root / "velodyne").mkdir()
    cfg = ge._small_cfg()
    rng = np.random.default_rng(3)
    world = ge._make_world(3)
    for k, T in enumerate(_gt()):
        d = ge._render_scan(world, T, cfg, rng)
        m = d["mask"]
        rec = np.concatenate([d["xyz"][m], d["intensity"][m, None] / 255.0],
                             1).astype(np.float32)
        rec.tofile(root / "velodyne" / f"{k:06d}.bin")
    jkitti.write_kitti_poses(str(root / "gt.txt"), _gt())
    (root / "calib.txt").write_text(
        "Tr: " + " ".join(str(v) for v in np.eye(4)[:3].ravel()) + "\n")
    return root


def test_folder_dataset_reads_what_the_reference_reads(scan_folder):
    n_raw = ge._small_cfg().shapes.n_raw
    j = JFolderDataset(str(scan_folder / "velodyne"), n_raw, native=False)
    t = TFolderDataset(str(scan_folder / "velodyne"), n_raw)
    assert len(t) == len(j) == N_SCANS
    for a, b in zip(t, j):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_pcd_and_pose_files_round_trip_across_packages(tmp_path):
    rng = np.random.default_rng(4)
    xyz = rng.uniform(-50, 50, (500, 3)).astype(np.float32)
    inten = rng.uniform(0, 255, 500).astype(np.float32)
    t_write_pcd(str(tmp_path / "a.pcd"), xyz, inten)
    a, b = t_read_pcd(str(tmp_path / "a.pcd")), j_read_pcd(
        str(tmp_path / "a.pcd"))
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a["xyz"], xyz)
    poses = np.tile(np.eye(4), (4, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(4, 3))
    tkitti.write_kitti_poses(str(tmp_path / "p.txt"), poses)
    np.testing.assert_array_equal(
        tkitti.read_kitti_poses(str(tmp_path / "p.txt")),
        jkitti.read_kitti_poses(str(tmp_path / "p.txt")))


def test_kitti_drift_metrics_match_reference():
    rng = np.random.default_rng(5)
    n = 400
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, 0, 3] = 1.2 * np.arange(n)
    gt[:, 1, 3] = 5.0 * np.sin(np.arange(n) / 40.0)
    est = gt.copy()
    est[:, :3, 3] += np.cumsum(0.003 * rng.normal(size=(n, 3)), 0)
    j = jmetrics.summarize(jmetrics.compute_error(gt, est))
    t = tmetrics.summarize(tmetrics.compute_error(gt, est))
    assert t == j  # the same numpy code on the same inputs
    assert tmetrics.ate_rmse(gt, est) == jmetrics.ate_rmse(gt, est)


@pytest.fixture
def one_thread():
    """The CLI runs thousands of small operations: on a CPU shared by the
    suite's workers, one torch thread runs them faster than a pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_slam_cli_runs_the_gicp_baseline(scan_folder, tmp_path, monkeypatch,
                                         one_thread):
    """--baseline_reg_method=gicp runs BaselinePipeline in place of the
    MULLS pipelines and tracks the 0.6 m/frame ground truth (at the
    budgets of tests/test_pipeline.py's baseline test)."""
    import dataclasses

    def small():
        cfg = ge._small_cfg()
        return dataclasses.replace(cfg, baseline=dataclasses.replace(
            cfg.baseline, frame_budget=4096, map_budget=8192,
            table_resolution=1.8, voxel_down_size=0.5, max_iter=20))

    monkeypatch.setattr(tslam, "MullsConfig", small)
    out = tmp_path / "lo_lidar.txt"
    assert tslam.main([
        "--point_cloud_folder", str(scan_folder / "velodyne"),
        "--device", "cpu", "--baseline_reg_method=gicp",
        "--output_lo_lidar_pose_file_path", str(out)]) == 0
    poses = tkitti.read_kitti_poses(str(out))
    np.testing.assert_allclose(poses[:, :3, 3], _gt()[:, :3, 3], atol=0.1)


def test_slam_cli_writes_the_map_outputs(scan_folder, tmp_path, monkeypatch,
                                        one_thread):
    """--output_map_pcd / _bev / _html with the outlier filter, and a
    profiler trace, over the first two scans: the pcd is
    ``accumulate_map`` and the filter applied to the poses the same run
    wrote."""
    import json

    from mulls_tpu_torch.io.dataset import FolderDataset
    from mulls_tpu_torch.mapping import assembly
    monkeypatch.setattr(tslam, "MullsConfig", ge._small_cfg)
    out = tmp_path / "lo_lidar.txt"
    argv = ["--point_cloud_folder", str(scan_folder / "velodyne"),
            "--device", "cpu", "--frame_num_end", "2",
            "--output_lo_lidar_pose_file_path", str(out),
            "--output_map_pcd", str(tmp_path / "map.pcd"),
            "--output_map_bev", str(tmp_path / "map.png"),
            "--output_map_html", str(tmp_path / "map.html"),
            "--map_filter_on", "1", "--profile_dir", str(tmp_path / "prof")]
    assert tslam.main(argv) == 0
    for name in ("map.pcd", "map.png", "map.html"):
        assert (tmp_path / name).stat().st_size > 0, name
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    ds = FolderDataset(str(scan_folder / "velodyne"),
                       ge._small_cfg().shapes.n_raw, end=2)
    want = assembly.radius_outlier_filter(
        assembly.accumulate_map(ds, tkitti.read_kitti_poses(str(out))),
        device="cpu")
    got = t_read_pcd(str(tmp_path / "map.pcd"))["xyz"]
    assert len(got) > 1000
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_slam_cli_exports_one_frames_features(scan_folder, tmp_path,
                                              monkeypatch, one_thread):
    """--export_feature_frame: the frame's per-class pcd files and the
    class-coloured HTML view, before the run (of the second scan alone)."""
    monkeypatch.setattr(tslam, "MullsConfig", ge._small_cfg)
    feat = tmp_path / "feat"
    assert tslam.main(["--point_cloud_folder", str(scan_folder / "velodyne"),
                       "--device", "cpu", "--frame_num_begin", "1",
                       "--frame_num_end", "2", "--export_feature_frame", "0",
                       "--export_feature_dir", str(feat)]) == 0
    counts = {}
    for name in ("ground", "pillar", "facade", "beam", "roof", "vertex"):
        counts[name] = len(t_read_pcd(str(feat / f"000000_{name}.pcd"))
                           ["xyz"])
    assert counts["ground"] > 100 and counts["facade"] > 50, counts
    assert (feat / "000000_features.html").stat().st_size > 10_000


def test_slam_cli_runs_odometry_on_a_scan_folder(scan_folder, tmp_path,
                                                 monkeypatch):
    # the small shapes of the parity tests; the CLI's config is otherwise
    # the default one
    monkeypatch.setattr(tslam, "MullsConfig", ge._small_cfg)
    out = tmp_path / "lo_lidar.txt"
    rc = tslam.main([
        "--point_cloud_folder", str(scan_folder / "velodyne"),
        "--device", "cpu",
        "--gt_body_pose_file_path", str(scan_folder / "gt.txt"),
        "--calib_file_path", str(scan_folder / "calib.txt"),
        "--output_lo_lidar_pose_file_path", str(out),
        "--timing_report_file", str(tmp_path / "timing.txt")])
    assert rc == 0
    poses = tkitti.read_kitti_poses(str(out))
    assert poses.shape == (N_SCANS, 4, 4)
    # the odometry tracks the 0.6 m/frame ground truth to a few cm
    np.testing.assert_allclose(poses[:, :3, 3], _gt()[:, :3, 3], atol=0.05)
    timing = np.loadtxt(tmp_path / "timing.txt")
    assert timing.shape == (N_SCANS, 4) and np.all(timing[:, :3] > 0)


def test_slam_cli_runs_the_back_end_on_a_scan_folder(scan_folder, tmp_path,
                                                     monkeypatch):
    """--loop_closure_detection_on: submaps every frame (segments of one
    frame), the adjacent edges in the constraint file, which the
    reference's reader parses, a checkpoint and a snapshot written, and
    the end-of-run refinement."""
    import functools

    from mulls_tpu.io.constraints import read_constraint_file
    monkeypatch.setattr(tslam, "MullsConfig", ge._small_cfg)
    monkeypatch.setattr(tslam, "SlamPipeline",
                        functools.partial(tslam.SlamPipeline, segment=1))
    out, con = tmp_path / "lo_lidar.txt", tmp_path / "graph.txt"
    rc = tslam.main([
        "--point_cloud_folder", str(scan_folder / "velodyne"),
        "--device", "cpu", "--loop_closure_detection_on=true",
        "--submap_accu_frame=1", "--constraint_output_file", str(con),
        "--checkpoint_path", str(tmp_path / "run.ckpt"),
        "--map_snapshot_dir", str(tmp_path / "snaps"),
        "--map_snapshot_every_submaps=1",
        "--output_lo_lidar_pose_file_path", str(out)])
    assert rc == 0
    poses = tkitti.read_kitti_poses(str(out))
    np.testing.assert_allclose(poses[:, :3, 3], _gt()[:, :3, 3], atol=0.05)
    _, cons = read_constraint_file(str(con))
    assert [(c["block1"], c["block2"], c["kind"]) for c in cons] == [
        (0, 1, 1)]
    assert (tmp_path / "run.ckpt").exists()
    snap = tmp_path / "snaps" / "snapshot_0000.html"
    for _ in range(50):  # written on a daemon thread
        if snap.exists():
            break
        time.sleep(0.2)
    assert snap.exists()


def test_eval_run_matches_reference(scan_folder, tmp_path):
    """``apps/eval_run.py`` is a copy: the same adjacent-error diagnosis and
    the same report on the same pose files."""
    import json

    from mulls_tpu.apps import eval_run as jeval
    from mulls_tpu_torch.apps import eval_run as teval
    rng = np.random.default_rng(6)
    gt = _gt()
    est = gt.copy()
    est[:, :3, 3] += 0.05 * rng.normal(size=(N_SCANS, 3))
    je, jf = jeval.adjacent_error_diagnosis(gt, est)
    te, tf = teval.adjacent_error_diagnosis(gt, est)
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(tf, jf)
    tkitti.write_kitti_poses(str(tmp_path / "est.txt"), est)
    reports = []
    for mod in (jeval, teval):
        out = tmp_path / f"{mod.__name__}.json"
        assert mod.main(["--est_pose_file", str(tmp_path / "est.txt"),
                         "--gt_pose_file", str(scan_folder / "gt.txt"),
                         "--json_out", str(out)]) == 0
        reports.append(json.loads(out.read_text()))
    assert reports[0] == reports[1]


def test_slam_cli_accepts_every_flag_of_the_reference():
    """The port's parser has every flag of ``mulls_tpu/apps/slam.py`` with
    the reference's default (and ``--device``)."""
    from mulls_tpu.apps import slam as jslam
    ref = {a.dest: a.default for a in jslam.build_parser()._actions}
    port = {a.dest: a.default for a in tslam.build_parser()._actions}
    assert set(port) - set(ref) == {"device"}
    assert {k: port[k] for k in ref} == ref
