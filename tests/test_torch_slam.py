"""The slice as a whole against the JAX package: the world and config of
``tests/test_pipeline.py::test_slam_loop_closure_synthetic`` through both
``SlamPipeline``s with the same draws (both key trees replayed), the back
end's ``on_new_submap`` fed the same submaps through the conversion
function (with the default bank, and with a bank of two slots so that
eviction and the host path run), and a checkpointed run resumed after a
crash against the same run uninterrupted.

Tolerances: the same submap spans and the same edge list (i, j, kind),
exactly; per-frame motion (each frame's pose relative to the previous)
within 5 cm and 0.5 deg of the reference's, and poses within 10 cm and
1 deg.  The packages round squared distances and PCA moments differently,
which moves a few features per frame; on this world's fast, turning loop
at small width that moves a frame's registration by up to 3.9 cm
(measured), twice the odometry parity tests' 2 cm on their gentler drive,
and the differences add up along the trajectory (2.8 cm measured), while
both runs stay within ~5 cm of the ground truth; edge transforms and submap poses from
``on_new_submap`` within 1 cm / 0.1 deg (the m2m ICPs start from equal
inputs); the resumed run equal to the uninterrupted one to 1e-6 m."""

import dataclasses
import glob
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from mulls_tpu.backend.submap import SlamBackend as JBackend
from mulls_tpu.core import se3 as jse3
from mulls_tpu.mapping.local_map import LocalMap as JLocalMap
from mulls_tpu.pipeline.slam import SlamPipeline as JSlam
from mulls_tpu_torch.backend.convert import backend_from_numpy
from mulls_tpu_torch.core.cloud import VertexDescriptors as TDesc
from mulls_tpu_torch.mapping.local_map import LocalMap as TLocalMap
from mulls_tpu_torch.pipeline.slam import SlamPipeline as TSlam
from torch_parity import JaxKeyDraws, backend_tree, cloud_to_torch

from test_pipeline import _loop_world, _simulate_scan


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The suite runs several workers on the CPU's cores: one intra-op
    thread a worker keeps these small-width runs from oversubscribing them
    (measured: the port's loop-world SLAM took 58 s with one thread and
    130 s with eight on a loaded 8-core host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

N_FRAMES = 26


def _cfg():
    cfg = ge._small_cfg()
    return cfg.replace(
        submap=cfg.submap.__class__(
            loop_closure_detection_on=True,
            submap_accu_tran=8.0, submap_accu_rot=1e9, submap_accu_frame=4,
            min_submap_id_diff=3, neighbor_search_dist=30.0,
            min_iou_thre=0.2, teaser_min_inlier_count=6,
            map2map_reliable_sigma_thre=0.04,
            max_used_reg_edge_per_optimization=2),
        reg=cfg.reg.__class__(corr_dis_thre_init=3.5, corr_dis_thre_min=0.6))


def _loop_frames(n_frames=N_FRAMES):
    """test_slam_loop_closure_synthetic's circle with a speed ramp, from the
    suite's session seed."""
    rng = np.random.default_rng(1234)
    cfg = _cfg()
    world = _loop_world(rng)
    radius = 8.0
    gt = []
    for k in range(N_FRAMES):
        ang = 2 * np.pi * (k / (N_FRAMES - 1)) ** 1.5
        t = jnp.asarray([radius * np.cos(ang) - radius,
                         radius * np.sin(ang), 0.0], jnp.float32)
        e = jnp.asarray([0.0, 0.0, ang + np.pi / 2], jnp.float32)
        gt.append(np.asarray(jse3.make_transform(t, e), np.float64))
    frames = [_simulate_scan(world, g, cfg.shapes.n_raw, 35.0, rng)
              for g in gt]
    gt = np.stack(gt)
    return frames[:n_frames], np.linalg.inv(gt[0]) @ gt[:n_frames]


def _rot_deg(Ra, Rb):
    M = Ra.T @ Rb
    s = np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                        M[1, 0] - M[0, 1]]) / 2.0
    return float(np.degrees(np.arctan2(s, (np.trace(M) - 1.0) / 2.0)))


def _rel(poses):
    return np.linalg.inv(poses[:-1]) @ poses[1:]


def _assert_close_poses(a, b, tol_m, tol_deg):
    for k, (p, q) in enumerate(zip(a, b)):
        dt = float(np.linalg.norm(p[:3, 3] - q[:3, 3]))
        dr = _rot_deg(p[:3, :3], q[:3, :3])
        assert dt < tol_m and dr < tol_deg, (k, dt, dr)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One reference run and one port run (on the CPU) of the loop world,
    with the reference's front-end and back-end key trees replayed."""
    cfg = _cfg()
    frames, gt = _loop_frames()
    ref = JSlam(cfg, segment=2).run(frames)
    snaps = str(tmp_path_factory.mktemp("snaps"))
    port = TSlam(cfg, segment=2, device="cpu", snapshot_dir=snaps,
                 snapshot_every=2,
                 draws=JaxKeyDraws(jax.random.key(cfg.seed + 1)),
                 frontend_draws=JaxKeyDraws(jax.random.key(cfg.seed))
                 ).run(frames)
    return cfg, frames, gt, ref, port, snaps


def test_slam_closes_the_same_loops_as_the_reference(runs):
    _, _, gt, ref, port, _ = runs
    assert port.codes == ref.codes
    assert all(c == 1 for c in port.codes)
    jb, tb = ref.backend, port.backend
    assert ([(s.frame_begin, s.frame_end) for s in tb.submaps]
            == [(s.frame_begin, s.frame_end) for s in jb.submaps])
    assert ([(e.i, e.j, e.kind) for e in tb.edges]
            == [(e.i, e.j, e.kind) for e in jb.edges])
    kinds = [e.kind for e in tb.edges]
    assert kinds.count(1) == len(tb.submaps) - 1 and kinds.count(2) >= 1
    _assert_close_poses(_rel(port.poses), _rel(ref.poses), 0.05, 0.5)
    _assert_close_poses(port.poses, ref.poses, 0.1, 1.0)
    # and the port's trajectory tracks the truth like the reference's
    err = np.linalg.norm(port.poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert err.max() < 1.0, err


def test_slam_writes_snapshots_and_counts_no_launches_on_the_cpu(runs):
    *_, port, snaps = runs
    for _ in range(50):  # the writer thread may still be flushing
        found = glob.glob(os.path.join(snaps, "snapshot_*.html"))
        if found:
            break
        time.sleep(0.2)
    assert found and os.path.getsize(found[0]) > 10_000
    # the CPU runs every kernel's plain version: nothing is launched
    assert all(k == 0 for k in port.backend.launches.values())


def test_refine_matches_reference(runs):
    cfg, frames, _, ref, port, _ = runs
    jp = JSlam(cfg, segment=2).refine(ref)
    tp = TSlam(cfg, segment=2, device="cpu").refine(port)
    _assert_close_poses(_rel(tp), _rel(jp), 0.05, 0.5)
    _assert_close_poses(tp, jp, 0.1, 1.0)


def _local_maps(sd):
    """One stored submap's clouds as both packages' local maps."""
    from mulls_tpu.core.cloud import FeatureCloud as JCloud
    from mulls_tpu.core.cloud import VertexDescriptors as JDesc
    jl = JLocalMap(
        clouds={n: JCloud(**{f: jnp.asarray(v) for f, v in c.items()})
                for n, c in sd["clouds"].items()},
        vertex_desc=JDesc(vec=jnp.asarray(sd["descriptors"]["vec"]),
                          mask=jnp.asarray(sd["descriptors"]["mask"])))
    tl = TLocalMap(
        clouds={n: cloud_to_torch(c) for n, c in jl.clouds.items()},
        vertex_desc=TDesc(vec=torch.from_numpy(sd["descriptors"]["vec"]),
                          mask=torch.from_numpy(sd["descriptors"]["mask"])))
    return jl, tl


def _set_span(be, sd):
    be._span_min_conf = sd["span_min_conf"]
    be._span_conf_sum = sd["span_mean_conf"]
    be._span_conf_n = 1


@pytest.mark.parametrize("capacity", [192, 2], ids=["banked", "evicting"])
def test_on_new_submap_matches_reference(runs, capacity):
    """The reference run's submaps fed one at a time to a reference back
    end and a port back end; the port's starts from the reference's state
    after two submaps, handed over by ``backend_from_numpy``.  After each
    boundary both must hold the same edges and submap poses."""
    cfg, *_ = runs
    cfg = cfg.replace(submap=dataclasses.replace(
        cfg.submap, submap_bank_capacity=capacity))
    # the first four submaps: three boundaries, the third with the loop
    # candidate 0 -> 3
    subs = backend_tree(runs[3].backend)["submaps"][:4]
    jb, tb = JBackend(cfg), None
    key = jax.random.key(7)
    for k, sd in enumerate(subs):
        jl, tl = _local_maps(sd)
        _set_span(jb, sd)
        jb.add_submap(jl, sd["pose"], sd["frame_begin"], sd["frame_end"])
        if k == 0:
            continue
        if tb is None:  # hand the reference's state over
            tb = backend_from_numpy(backend_tree(jb), cfg, device="cpu")
            assert [s.slot for s in tb.submaps] == [0, 1]
        else:
            _set_span(tb, sd)
            tb.add_submap(tl, sd["pose"], sd["frame_begin"],
                          sd["frame_end"])
        key, sub = jax.random.split(key)
        pj = jb.on_new_submap(sub)
        pt = tb.on_new_submap(JaxKeyDraws(sub))
        assert (pj is None) == (pt is None), (k, jb.events, tb.events)
        assert ([(e.i, e.j, e.kind) for e in tb.edges]
                == [(e.i, e.j, e.kind) for e in jb.edges]), (k, tb.events)
        _assert_close_poses([e.T for e in tb.edges],
                            [e.T for e in jb.edges], 0.01, 0.1)
        _assert_close_poses([s.pose for s in tb.submaps],
                            [s.pose for s in jb.submaps], 0.01, 0.1)
        assert [s.slot for s in tb.submaps] == [s.slot for s in jb.submaps]
    if capacity == 2:
        assert any("evicted" in ev for ev in tb.events)
    assert any(e.kind == 2 for e in tb.edges), tb.events


class _Crash:
    """The frames, failing at ``crash_at`` (a run that dies mid-way)."""

    def __init__(self, frames, crash_at):
        self.frames, self.crash_at = frames, crash_at

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, k):
        if k >= self.crash_at:
            raise RuntimeError("scan reader died")
        return self.frames[k]


def test_checkpoint_resume_equals_the_uninterrupted_run(tmp_path):
    cfg = _cfg()
    frames, _ = _loop_frames(10)

    def pipe(path):
        return TSlam(cfg, segment=2, checkpoint_path=str(path),
                     checkpoint_every=2, device="cpu")

    whole = pipe(tmp_path / "a.ckpt").run(frames)
    with pytest.raises(RuntimeError, match="scan reader died"):
        pipe(tmp_path / "b.ckpt").run(_Crash(frames, 9))
    # the last checkpoint holds frame 8: one submap in the bank and two
    # frames of the open span
    resumed = pipe(tmp_path / "b.ckpt").run(frames)
    assert len(resumed.backend.submaps) == len(whole.backend.submaps) == 2
    assert resumed.codes == whole.codes
    assert ([(e.i, e.j, e.kind) for e in resumed.backend.edges]
            == [(e.i, e.j, e.kind) for e in whole.backend.edges])
    np.testing.assert_allclose(resumed.poses, whole.poses, atol=1e-6)
