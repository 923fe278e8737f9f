"""The port's ``MultiSeqPipeline`` against the JAX package's: four
sequences of tests/test_multiseq.py's loop world (one a frame shorter),
the reference on ``make_mesh(4)`` of the 8 virtual CPU devices
(tests/conftest.py), the port on a 4-entry CPU mesh with each sequence's
key tree replayed (``JaxKeyDraws(key(seed + s))``).

Tolerance: per-sequence codes equal, per-frame T_rel within 2 cm / 0.2
deg (the parity tests' bound: under its ``vmap`` the reference's
``lax.cond``s become selects and its reductions may reassociate).  The
port's sequences equal the port's ``OdometryPipeline`` alone on them
with the multi-sequence config, bit for bit."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from mulls_tpu.parallel.mesh import make_mesh as j_make_mesh
from mulls_tpu.parallel.multiseq import MultiSeqPipeline as JMultiSeq
from mulls_tpu_torch.parallel.mesh import make_mesh
from mulls_tpu_torch.parallel.multiseq import MultiSeqPipeline
from mulls_tpu_torch.pipeline.odometry import OdometryPipeline
from test_pipeline import _ListDataset, _loop_world, _simulate_scan
from test_torch_pipeline import _assert_same_motion, _rel
from torch_parity import JaxKeyDraws

S = 4
N_FRAMES = 4
SEGMENT = 3  # a warm segment (i0 = 0), then a steady one (i0 = 3 > 2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sequences(cfg):
    rng = np.random.default_rng(1234)
    world = _loop_world(rng, n=60000, extent=40.0)
    out = []
    for s in range(S):
        ang = 2 * np.pi * s / S
        d = np.array([np.cos(ang), np.sin(ang), 0.0])
        n = N_FRAMES - 1 if s == S - 1 else N_FRAMES  # truncation
        gt = []
        for k in range(n):
            T = np.eye(4)
            T[:3, 3] = 0.5 * k * d
            gt.append(T)
        out.append(_ListDataset(
            _simulate_scan(world, g, cfg.shapes.n_raw, 30.0, rng)
            for g in gt))
    return out


def _draws(cfg):
    return [JaxKeyDraws(jax.random.key(cfg.seed + s)) for s in range(S)]


@pytest.fixture(scope="module")
def runs():
    cfg = ge._small_cfg()
    seqs = _sequences(cfg)
    ref = JMultiSeq(cfg, j_make_mesh(S), segment=SEGMENT).run(seqs)
    pipe = MultiSeqPipeline(cfg, make_mesh(S, device="cpu"),
                            segment=SEGMENT)
    port = pipe.run(seqs, draws=_draws(cfg))
    return cfg, seqs, ref, pipe, port


def test_multiseq_codes_and_motion_match_reference(runs):
    _, seqs, ref, _, port = runs
    assert [len(r.poses) for r in port] == [len(s) for s in seqs] \
        == [N_FRAMES] * (S - 1) + [N_FRAMES - 1]
    for s in range(S):
        assert port[s].codes == ref[s].codes, s
        assert all(c == 1 for c in port[s].codes), s
        _assert_same_motion(_rel(port[s].poses), _rel(ref[s].poses))


def test_each_sequence_equals_its_run_alone(runs):
    """The first sequence and the short one (the others differ only in
    their heading)."""
    cfg, seqs, _, pipe, port = runs
    draws = _draws(cfg)
    for s in (0, S - 1):
        alone = OdometryPipeline(pipe.cfg.replace(seed=cfg.seed + s),
                                 segment=SEGMENT, device="cpu",
                                 draws=draws[s]).run(seqs[s])
        assert alone.codes == port[s].codes
        np.testing.assert_array_equal(alone.poses, port[s].poses)
        assert alone.sigmas == port[s].sigmas
    assert len(pipe.launches) == S  # one launch record per sequence


def test_sequence_count_must_fill_the_mesh():
    cfg = ge._small_cfg()
    pipe = MultiSeqPipeline(cfg, make_mesh(S, device="cpu"))
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        pipe.run([[{}]] * (S + 1))


def test_forced_flags_and_the_two_configs():
    cfg = ge._small_cfg()
    pipe = MultiSeqPipeline(cfg, make_mesh(2, device="cpu"))
    ref = JMultiSeq(cfg, j_make_mesh(2))
    assert not pipe.cfg.map.inframe_recovery_on
    assert not pipe.cfg.map.dynamic_sanity_veto_on
    assert pipe.cfg.map.warmup_s2s_on
    assert not pipe.cfg_steady.map.warmup_s2s_on
    assert dataclasses.replace(pipe.cfg_steady.map, warmup_s2s_on=True) \
        == pipe.cfg.map
    assert dataclasses.asdict(pipe.cfg.map) == dataclasses.asdict(
        ref.cfg.map)


def test_fleet_cli_writes_what_the_reference_cli_writes(tmp_path,
                                                       monkeypatch):
    """``apps/slam_multiseq.py`` against the reference CLI on two folders
    of KITTI .bin scans (3 and 2 frames): the same pose files and summary
    keys, equal frame and healthy-frame counts, and poses within 5 cm /
    0.5 deg (each CLI draws from its own seed: the reference's key, the
    port's generator)."""
    import json

    import mulls_tpu.config as jconfig
    import mulls_tpu_torch.config as tconfig
    from mulls_tpu.apps import slam_multiseq as jcli
    from mulls_tpu_torch.apps import slam_multiseq as tcli
    from mulls_tpu_torch.io.kitti import read_kitti_poses

    cfg = ge._small_cfg()
    seqs = _sequences(cfg)
    folders = []
    for s, n in ((0, 3), (1, 2)):
        d = tmp_path / f"seq{s}"
        d.mkdir()
        for k, f in enumerate(seqs[s][:n]):
            m = f["mask"]
            np.concatenate([f["xyz"][m], f["intensity"][m, None] / 255.0],
                           1).astype(np.float32).tofile(d / f"{k:06d}.bin")
        folders.append(str(d))
    monkeypatch.setattr(jconfig, "MullsConfig", lambda: cfg)
    monkeypatch.setattr(tconfig, "MullsConfig", lambda: cfg)
    common = ["--sequence_folders", ",".join(folders), "--n_devices", "2",
              "--segment", "2"]
    assert jcli.main(common + ["--output_dir", str(tmp_path / "ref")]) == 0
    assert tcli.main(common + ["--output_dir", str(tmp_path / "port"),
                               "--device", "cpu"]) == 0
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) \
        == ["seq0_pose.txt", "seq1_pose.txt", "summary.json"]
    sums = [json.loads((tmp_path / w / "summary.json").read_text())
            for w in ("ref", "port")]
    assert sums[0].keys() == sums[1].keys()
    for name in ("seq0", "seq1"):
        a, b = (sm["sequences"][name] for sm in sums)
        assert (a["frames"], a["ok_frames"]) == (b["frames"], b["ok_frames"])
        assert a["ok_frames"] == a["frames"]
        _assert_same_motion(
            read_kitti_poses(str(tmp_path / "port" / f"{name}_pose.txt")),
            read_kitti_poses(str(tmp_path / "ref" / f"{name}_pose.txt")),
            tol_m=0.05, tol_deg=0.5)
