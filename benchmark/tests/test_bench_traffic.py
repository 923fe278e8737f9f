"""The drives: the PyTorch copy of the accuracy bench's worlds is
deterministic from the seed and keeps the numpy generator's geometry (the
range crop, the point count, the noise), and each sequence gets the world
its KITTI counterpart drives.  CPU, the tiny mix."""

import json
import os

import numpy as np
import torch

import benchutil
from benchlib import traffic
from mulls_tpu_torch.tools import worlds

CPU = torch.device("cpu")


def _mix():
    with open(os.path.join(benchutil.DATA, "tiny_mix.json")) as f:
        return json.load(f)


def test_the_same_seed_gives_the_same_drives():
    mix = dict(_mix(), frames=3)
    a = traffic.make_drives(mix, ["00", "01"], 4096, 2**31 + 5, CPU)
    b = traffic.make_drives(mix, ["00", "01"], 4096, 2**31 + 5, CPU)
    c = traffic.make_drives(mix, ["00", "01"], 4096, 2**31 + 6, CPU)
    for s in range(2):
        for k in range(3):
            for key in ("xyz", "intensity", "mask"):
                np.testing.assert_array_equal(a[s][k][key], b[s][k][key])
    assert not np.array_equal(a[0][0]["xyz"], c[0][0]["xyz"])


def test_sequences_get_their_kitti_counterparts_world():
    mix = json.load(open(os.path.join(benchutil.HERE, "traffic",
                                      "kitti_mix.json")))
    highway = [f"{i:02d}" for i in (1, 3, 4, 10, 12, 20, 21)]
    for i in range(22):
        name = f"{i:02d}"
        assert traffic.world_of(mix, name) == (
            "highway" if name in highway else "urban")


def _scan_stats(xyz, mask):
    p = xyz[mask]
    r = np.linalg.norm(p[:, :2], axis=1)
    return int(mask.sum()), float(r.max()), float(r.min())


def test_the_geometry_is_the_numpy_generators():
    d = traffic._Draw(11, CPU)
    rng = np.random.default_rng(11)
    n_raw = 131072
    for kind in ("urban", "highway"):
        if kind == "urban":
            w_t, w_n = traffic.build_urban(d), worlds.build_world(rng)
            pose = worlds.loop_trajectory(3)[2]
            np.testing.assert_allclose(traffic.loop_poses(3, 0.8, 0.0),
                                       worlds.loop_trajectory(3))
        else:
            w_t, w_n = traffic.build_highway(d), worlds.build_world_highway(
                rng)
            pose = worlds.highway_trajectory(3)[2]
            np.testing.assert_allclose(traffic.highway_poses(3, 2.2, 0.0),
                                       worlds.highway_trajectory(3))
        # the same point count within 1 %, the same extent (the heights
        # are drawn: buildings 4-14 m, embankments down to -4.2 m; the
        # highway's last post lands up to 45 m past its end)
        atol = 1.0 if kind == "urban" else 50.0
        assert abs(w_t.shape[0] - w_n.shape[0]) < 0.01 * w_n.shape[0]
        np.testing.assert_allclose(w_t.min(0).values.numpy()[:2],
                                   w_n.min(0)[:2], atol=atol)
        np.testing.assert_allclose(w_t.max(0).values.numpy()[:2],
                                   w_n.max(0)[:2], atol=atol)
        assert -4.5 < float(w_t[:, 2].min()) and float(w_t[:, 2].max()) < 14.2
        xyz, inten, valid = traffic.simulate(w_t, pose, n_raw, d, 65.0, 1.8,
                                             0.01)
        ref = worlds.simulate(w_n, pose, n_raw, rng)
        n_t, rmax_t, rmin_t = _scan_stats(xyz.numpy(), valid.numpy())
        n_n, rmax_n, rmin_n = _scan_stats(ref["xyz"], ref["mask"])
        # the range crop (noise of 1 cm on top), the point count
        assert rmax_t < 65.05 and rmin_t > 1.75
        assert abs(n_t - n_n) <= 0.05 * n_n
        # the valid points first
        assert bool(valid[:n_t].all()) and not bool(valid[n_t:].any())
        assert float(inten.max()) < 1.0


def test_the_noise_is_the_generators():
    # a flat world at z = 0: the scan's z is the sensor noise alone
    d = traffic._Draw(3, CPU)
    world = torch.stack([d.u(-50, 50, 200_000), d.u(-50, 50, 200_000),
                         torch.zeros(200_000)], -1)
    xyz, _, valid = traffic.simulate(world, np.eye(4), 50_000, d, 65.0, 1.8,
                                     0.01)
    z = xyz[valid][:, 2]
    assert abs(float(z.std()) - 0.01) < 0.001 and abs(float(z.mean())) < 1e-3


def test_the_feed_gets_the_readers_packed_frames():
    # the program's feed takes the packed segments (the native reader's
    # path) and hands over what packing each host frame gives
    from mulls_tpu_torch.core.cloud import pack_raw_host
    from mulls_tpu_torch.pipeline.odometry import prefetch_frames
    drives = traffic.make_drives(dict(_mix(), frames=5), ["00", "01"], 4096,
                                 2**31 + 9, CPU)
    for drive in drives:
        assert drive.packed_segments(2) is not None
        fed = list(prefetch_frames(drive, CPU, with_ts=True, segment=2))
        assert len(fed) == len(drive) == 5
        for k, got in enumerate(fed):
            want = pack_raw_host(drive[k], with_ts=True)
            for key in ("xyz_q", "intensity_q", "ts_q", "n"):
                a, b = getattr(got, key), getattr(want, key)
                assert a.shape == b.shape, key
                assert torch.equal(a.to(torch.int64), b.to(torch.int64)), key


def test_the_loop_slows_on_its_corners():
    poses = traffic.loop_poses(120, 0.8, 0.0, 0.3)  # the first corner
    step = np.linalg.norm(np.diff(poses[:, :2, 3], axis=0), axis=1)
    yaw = np.unwrap(np.arctan2(poses[:, 1, 0], poses[:, 0, 0]))
    turn = np.diff(yaw)
    on_arc = turn > 1e-9
    # 44 m of straight at 0.8 m, then the 8 m-radius arc at 0.3 m a frame
    np.testing.assert_allclose(step[:54], 0.8, atol=1e-9)
    assert 40 <= on_arc.sum() <= 2 * 44
    np.testing.assert_allclose(turn[on_arc][1:-1], 0.3 / 8.0, rtol=1e-9)
    assert float(turn.max()) <= 0.3 / 8.0 + 1e-9
    # no corner pace: the bench's trajectory
    np.testing.assert_allclose(traffic.loop_poses(60, 0.8, 0.0),
                               worlds.loop_trajectory(60))
