"""The port's accuracy tools against the reference's: the bench's worlds
(``mulls_tpu_torch/tools/worlds.py`` against the world functions of
``tools/synthetic_accuracy_bench.py``, loaded by path here only), one
row at a small width (``accuracy_bench.run_row`` against ``mulls_tpu``'s
``OdometryPipeline`` on the same scans, the JAX key replayed), the health
policy and the row's keys against the bench's ``main`` on crafted code
lists, the matrix's job lists, and the endurance run's lazy drive.

Tolerance: worlds and scans equal array for array; the row's codes equal
and per-frame T_rel within 2 cm / 0.2 deg (as tests/test_torch_pipeline.py).
"""

import dataclasses
import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch

from experiments import bench_reference as br
from mulls_tpu.pipeline.odometry import OdometryPipeline as JPipeline
from mulls_tpu_torch.tools import (accuracy_bench, accuracy_matrix,
                                   accuracy_row, endurance_run, worlds)
from torch_parity import JaxKeyDraws

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench():
    return br.load_bench()


def _assert_same_scans(a, b):
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("world,kw", [
    ("urban", {}),
    ("urban", {"fog": True}),
    ("urban", {"beams": 16}),
    ("urban", {"beams": 64, "traj_step": 0.35, "handheld": True}),
    ("highway", {}),
    ("highway", {"fog": True, "beams": 32}),
    ("dynamic", {}),
    ("dynamic", {"fog": True}),
    ("highway_loop", {}),
    ("urban_hard", {"hardness": 1}),
    ("urban_hard", {"hardness": 2}),
    ("urban_hard", {"hardness": 3}),
    ("urban", {"v_err": 0.195}),
])
def test_worlds_give_the_bench_scans(bench, world, kw):
    """make_run draws in the bench's order: the same scans and truth for
    seed 7 (6 frames at n_raw 2048; the fog bank is frame 1)."""
    scans, gt, meta = worlds.make_run(world, 7, 6, 2048, **kw)
    ref_scans, ref_gt = br.bench_run(bench, world, 7, 6, 2048, **kw)
    np.testing.assert_array_equal(gt, ref_gt)
    _assert_same_scans(scans, ref_scans)
    assert meta["fog"] == ([1, 2] if kw.get("fog") else None)


def test_world_functions_are_the_benchs(bench):
    """Each world and trajectory function alone, on its own seed."""
    for name in ("build_world", "build_world_highway",
                 "build_world_highway_loop", "build_world_hard_extras"):
        np.testing.assert_array_equal(
            getattr(worlds, name)(np.random.default_rng(3)),
            getattr(bench, name)(np.random.default_rng(3)), err_msg=name)
    for name in ("loop_trajectory", "highway_trajectory",
                 "highway_loop_trajectory"):
        np.testing.assert_array_equal(getattr(worlds, name)(40),
                                      getattr(bench, name)(40))
    poses = bench.loop_trajectory(12)
    np.testing.assert_array_equal(
        worlds.handheld_sway(poses, np.random.default_rng(4)),
        bench.handheld_sway(poses, np.random.default_rng(4)))
    for a, b in zip(worlds.dynamic_traffic(np.random.default_rng(5), 3),
                    bench.dynamic_traffic(np.random.default_rng(5), 3)):
        np.testing.assert_array_equal(a, b)


def test_ladder_scans_are_the_reference_records(bench):
    """The ladder's stationary scans: the port's (chip_smoke.py phase 17)
    and the reference record's (experiments/bench_reference.py)."""
    _assert_same_scans(worlds.stationary_scans(br.LADDER_SEED,
                                               br.LADDER_SCANS + 1, 2048),
                       br.ladder_scans(bench, 2048))


def test_lazy_drive_is_the_endurance_tools(bench):
    """Scan k of the port's lazy drive is the reference tool's, whatever
    the order the scans are read in (a resumed run reads from its
    checkpoint on)."""
    ref = _load("endurance_run_ref", os.path.join(_REPO, "tools",
                                                  "endurance_run.py"))
    world = bench.build_world(np.random.default_rng(7))
    poses = bench.loop_trajectory(6)
    port = worlds.LazyDrive(world, poses, 2048, 7)
    theirs = ref.LazyDrive(world, poses, 2048, 7)
    assert len(port) == len(theirs) == 6
    _assert_same_scans([port[k] for k in (4, 0, 4, 5)],
                       [theirs[k] for k in (4, 0, 4, 5)])


# --- one row at a small width against the reference's odometry

def _row_cfg():
    """The parity tests' width, with a 1 m PCA radius.  This width keeps
    16,384 of a scan's points: drawn uniformly from the bench's 65 m disc
    they are too sparse to register to the parity bound (both packages
    land 4-8 cm from the truth a frame, and as far apart), so the row's
    scans are the 64-beam profile's, which keeps the nearest return of
    each beam and azimuth, dense near the sensor as a real scanner's."""
    from __graft_entry__ import _small_cfg
    cfg = _small_cfg()
    return cfg.replace(feature=dataclasses.replace(cfg.feature,
                                                   cloud_pca_neigh_r=1.0))


ROW_FRAMES, ROW_BEAMS = 6, 64


@pytest.fixture(scope="module")
def row():
    cfg = _row_cfg()
    args = accuracy_bench.parser().parse_args(
        ["--world", "dynamic", "--seed", "7", "--frames", str(ROW_FRAMES),
         "--beams", str(ROW_BEAMS), "--skip_slam", "--device", "cpu"])
    port = accuracy_bench.run_row(
        args, cfg=cfg, device="cpu",
        draws=JaxKeyDraws(jax.random.key(cfg.seed)))
    scans, _ = br.bench_run(br.load_bench(), "dynamic", 7, ROW_FRAMES,
                            cfg.shapes.n_raw, beams=ROW_BEAMS)
    ref = JPipeline(cfg).run(scans)
    return port, ref


def _rot_deg(Ra, Rb):
    M = Ra.T @ Rb
    s = np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                        M[1, 0] - M[0, 1]]) / 2.0
    return float(np.degrees(np.arctan2(s, (np.trace(M) - 1.0) / 2.0)))


def test_row_codes_and_motion_match_the_reference(row):
    port, ref = row
    assert port["odometry_codes"] == [int(c) for c in ref.codes]
    assert all(c == 1 for c in port["odometry_codes"])
    rel = lambda p: np.linalg.inv(p[:-1]) @ p[1:]
    for i, (a, b) in enumerate(zip(
            rel(np.asarray(port["odometry_poses"])),
            rel(np.asarray(ref.poses)))):
        dt = float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
        assert dt < 0.02 and _rot_deg(a[:3, :3], b[:3, :3]) < 0.2, (i, dt)


def test_row_records_the_card_and_the_counts(row):
    port, _ = row
    assert port["device"] == "cpu" and port["config"] == "given"
    assert port["device_max_memory_allocated"] is None
    assert port["odometry_failed_frames"] == 0
    assert port["odometry_vetoed_frames"] == 0
    assert len(port["odometry_poses"]) == ROW_FRAMES
    assert "health_error" not in port


# --- the health policy and the row's keys against the bench's main

class _FakeOdometry:
    """Stands in for the reference's OdometryPipeline in the bench's main:
    the crafted codes, identity poses."""
    codes = []

    def __init__(self, cfg):
        pass

    def run(self, frames):
        class Res:
            pass
        res = Res()
        res.codes = list(self.codes)
        res.poses = np.tile(np.eye(4), (len(frames), 1, 1))
        return res


def _bench_main(bench, monkeypatch, tmp_path, codes, fog):
    """The bench's verdict on ``codes``: its JSON, or the assertion."""
    import mulls_tpu.pipeline.odometry as jodo
    monkeypatch.setattr(_FakeOdometry, "codes", codes)
    monkeypatch.setattr(jodo, "OdometryPipeline", _FakeOdometry)
    monkeypatch.setattr(bench, "build_world",
                        lambda rng: np.zeros((1, 3), np.float32))
    monkeypatch.setattr(bench, "simulate", lambda *a, **kw: {})
    out = tmp_path / "row.json"
    monkeypatch.setattr(sys, "argv", [
        "bench", "--frames", str(len(codes)), "--skip_slam", "--json_out",
        str(out), "--config", str(tmp_path / "absent.txt")]
        + (["--fog"] if fog else []))
    try:
        bench.main()
    except AssertionError as e:
        return None, str(e)
    import json
    return json.loads(out.read_text()), None


_VETO9 = [1] * 3 + [-4] * 9 + [1] * 8
_VETO8 = [1] * 3 + [-4] * 8 + [1] * 9


@pytest.mark.parametrize("name,codes,fog", [
    ("veto stretch of 9 fails", _VETO9, False),
    ("veto stretch of 8 passes", _VETO8, False),
    ("a cascade fails", [1] * 5 + [-2, -2] + [1] * 13, False),
    ("three isolated failures pass", [1, -1, 1, -2, 1, 1, -3] + [1] * 13,
     False),
    ("four isolated failures fail", [1, -1, 1, -2, 1, 1, -3, 1, -1]
     + [1] * 11, False),
    ("failures in the fog bank pass", [1] * 5 + [-2] * 6 + [1] * 9, True),
    ("a cascade after the fog bank fails",
     [1] * 12 + [-2, -2] + [1] * 6, True),
])
def test_health_policy_is_the_benchs(bench, monkeypatch, tmp_path, name,
                                     codes, fog):
    ref_json, ref_err = _bench_main(bench, monkeypatch, tmp_path, codes, fog)
    counts, errors = accuracy_bench.health(
        codes, worlds.fog_span(len(codes), fog), fog)
    assert bool(errors) == (ref_err is not None), (name, errors, ref_err)
    if ref_json is not None:
        for k in ("odometry_failed_frames", "odometry_failed_frame_indices",
                  "odometry_vetoed_frames", "odometry_vetoed_frame_indices"):
            assert counts[k] == ref_json[k], k


def test_row_has_the_benchs_keys(bench, monkeypatch, tmp_path, row):
    ref_json, _ = _bench_main(bench, monkeypatch, tmp_path, [1] * 12, False)
    port, _ = row
    assert set(ref_json) <= set(port), set(ref_json) - set(port)
    assert set(ref_json["odometry"]) <= set(port["odometry"])


# --- the matrix's job lists

@pytest.mark.parametrize("only", ["matrix", "disc", "profiles", "all"])
def test_matrix_jobs_are_the_references(only):
    ref = _load("run_accuracy_matrix_ref",
                os.path.join(_REPO, "tools", "run_accuracy_matrix.py"))
    assert (accuracy_matrix.build_jobs(420, only, config_dir=ref._CFG_DIR)
            == ref.build_jobs(420, only))


def test_matrix_takes_a_list_of_tags():
    jobs = accuracy_matrix.build_jobs(420, "dynamic_s1009,urban_s7,prof_16")
    assert [t for t, _ in jobs] == ["dynamic_s1009", "urban_s7", "prof_16"]
    assert jobs[2][1][-2:] == ["--beams", "16"]
    assert os.path.dirname(jobs[2][1][jobs[2][1].index("--config") + 1]) \
        == accuracy_bench.CONFIG_DIR
    with pytest.raises(ValueError, match="unknown matrix tags"):
        accuracy_matrix.build_jobs(420, "urban_s7,nowhere")


def test_missing_flagfile_runs_at_the_defaults(tmp_path):
    from mulls_tpu_torch.config import MullsConfig
    cfg, name = accuracy_bench.load_config(str(tmp_path / "absent.txt"))
    assert cfg == MullsConfig() and name == "MullsConfig()"
    args = accuracy_bench.parser().parse_args(["--ablate_features"])
    edited = accuracy_bench.row_config(args, cfg)
    assert edited.reg.used_feature_type == "100000" and args.skip_slam
    args = accuracy_bench.parser().parse_args(["--baseline", "gicp"])
    assert accuracy_bench.row_config(args, cfg).baseline.method == "gicp"
    assert args.skip_slam
    assert accuracy_bench.sensor_v_err(cfg) == 0.0


def test_entry_points_run_on_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        accuracy_bench.main(["--frames", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        accuracy_row.main(["--frames", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        endurance_run.main(["--frames", "2", "--workdir", str(tmp_path),
                            "--out", str(tmp_path / "e.json")])
