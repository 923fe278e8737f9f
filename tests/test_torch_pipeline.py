"""The port's slice as a whole against the JAX package: a synthetic world
driven through both ``OdometryPipeline``s with the same draws (the
reference's key tree replayed), a run resumed from the reference's
mid-run state through ``state_from_numpy``, and the motion-compensation
stages (a flagfile option).

Tolerance: per-frame codes equal; per-frame T_rel within 2 cm and 0.2 deg.
The two packages differ only in how squared distances and PCA moments are
rounded (see tests/test_torch_frontend.py), which moves a few features per
frame and the registration by millimetres."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from mulls_tpu.core import se3 as jse3
from mulls_tpu.core.cloud import pack_raw_host as j_pack
from mulls_tpu.pipeline.odometry import OdometryPipeline as JPipeline
from mulls_tpu.pipeline.odometry import _feature_stage as j_feature_stage
from mulls_tpu.pipeline.odometry import _stack_packed, slam_scan
from mulls_tpu.pipeline.odometry import _undistort_frame as j_undistort_frame
from mulls_tpu.pipeline.odometry import init_state as j_init_state
from mulls_tpu_torch.core.cloud import pack_raw_host as t_pack
from mulls_tpu_torch.pipeline.odometry import OdometryPipeline as TPipeline
from mulls_tpu_torch.pipeline.odometry import (init_state, slam_step,
                                               state_from_numpy)
from mulls_tpu_torch.pipeline.odometry import StepOut as TStepOut
from mulls_tpu_torch.pipeline.odometry import _feature_stage as t_feature_stage
from mulls_tpu_torch.pipeline.odometry import \
    _undistort_frame as t_undistort_frame
from torch_parity import (JaxKeyDraws, frame_to_torch, match_fraction,
                          state_to_numpy)

N_FRAMES = 8
SEGMENT = 4


def _rot_deg(Ra, Rb):
    # the angle from both the sine and the cosine: arccos of the trace
    # alone has a floor of ~0.03 deg for f32 rotations that are equal
    M = Ra.T @ Rb
    s = np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                        M[1, 0] - M[0, 1]]) / 2.0
    return float(np.degrees(np.arctan2(s, (np.trace(M) - 1.0) / 2.0)))


def _rel(poses):
    return np.linalg.inv(poses[:-1]) @ poses[1:]


def _assert_same_motion(T_port, T_ref, tol_m=0.02, tol_deg=0.2):
    for i, (a, b) in enumerate(zip(T_port, T_ref)):
        dt = float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
        dr = _rot_deg(a[:3, :3], b[:3, :3])
        assert dt < tol_m and dr < tol_deg, (i, dt, dr)


def _world_run(cfg, n_frames, seed=5):
    rng = np.random.default_rng(seed)
    world = ge._make_world(seed)
    gt = []
    for k in range(n_frames):
        yaw = np.radians(1.5 * k)
        T = np.eye(4)
        T[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        T[:3, 3] = [0.6 * k, 0.05 * k, 0.0]
        gt.append(T)
    frames = [ge._render_scan(world, T, cfg, rng) for T in gt]
    ref = JPipeline(cfg, segment=SEGMENT).run(frames)
    port = TPipeline(cfg, segment=SEGMENT, device="cpu",
                     draws=JaxKeyDraws(jax.random.key(cfg.seed))).run(frames)
    return frames, np.stack(gt), ref, port


@pytest.fixture(scope="module")
def run():
    cfg = ge._small_cfg()
    return (cfg, *_world_run(cfg, N_FRAMES))


def test_odometry_codes_and_motion_match_reference(run):
    _, _, _, ref, port = run
    assert port.codes == ref.codes
    assert all(c == 1 for c in ref.codes)
    _assert_same_motion(_rel(port.poses), _rel(ref.poses))


def test_odometry_tracks_ground_truth(run):
    _, _, gt, _, port = run
    gt_rel = np.linalg.inv(gt[0]) @ gt
    err = np.linalg.norm(port.poses[:, :3, 3] - gt_rel[:, :3, 3], axis=1)
    assert err.max() < 0.1, err


def _pack(frames):
    return jax.device_put(_stack_packed(
        [j_pack(f, with_ts=False) for f in frames]))


@pytest.mark.parametrize("timing", ["pre", "post"])
def test_motion_compensation_stages_match_reference(timing):
    """The azimuth-ratio undistortion (a flagfile option, off by default):
    before extraction it goes through the feature stage, after
    registration through ``_undistort_frame``; each stage from the same
    state and inputs in both packages.  Tolerances as in
    tests/test_torch_frontend.py for the features; the undistortion of a
    given frame is a few f32 ulp of 30 m."""
    base = ge._small_cfg()
    cfg = dataclasses.replace(base, map=dataclasses.replace(
        base.map, motion_compensation_method=2,
        motion_compensation_timing=timing))
    d = ge._synthetic_raw(cfg, seed=6)
    T_motion = np.array(jse3.make_transform(
        jnp.asarray([0.6, 0.02, 0.0], jnp.float32),
        jnp.asarray([0.0, 0.0, 0.015], jnp.float32)))
    jstate = j_init_state(cfg).replace(T_prev=jnp.asarray(T_motion))
    tstate = init_state(cfg, device="cpu").replace(
        T_prev=torch.from_numpy(T_motion))
    key = jax.random.key(12)
    jframe, _ = jax.jit(j_feature_stage, static_argnames=("cfg",))(
        jstate, jax.tree.map(jnp.asarray, j_pack(d, with_ts=False)), cfg,
        key)
    tframe, _ = t_feature_stage(tstate, t_pack(d, with_ts=False), cfg,
                                JaxKeyDraws(key))
    for name, jc in jframe.full.items():
        jm, tm = np.asarray(jc.mask), tframe.full[name].mask.numpy()
        assert abs(int(jm.sum()) - int(tm.sum())) <= 0.03 * jm.sum() + 2
        assert match_fraction(tframe.full[name].xyz.numpy()[tm],
                              np.asarray(jc.xyz)[jm], 1e-3) >= 0.99
        # azimuth ratios stamped on the points both packages kept
        np.testing.assert_allclose(
            np.sort(tframe.full[name].ts_ratio.numpy()[tm])[:5],
            np.sort(np.asarray(jc.ts_ratio)[jm])[:5], atol=1e-6)
    if timing == "post":
        ju = j_undistort_frame(jframe, jnp.asarray(T_motion), cfg)
        tu = t_undistort_frame(frame_to_torch(jframe),
                               torch.from_numpy(T_motion), cfg)
        for part in ("full", "down"):
            for name, jc in getattr(ju, part).items():
                np.testing.assert_allclose(
                    getattr(tu, part)[name].xyz.numpy(), np.asarray(jc.xyz),
                    atol=3e-5)


def test_resume_from_reference_state_matches(run):
    """state_from_numpy on the reference's state after 4 frames; the next
    frames through the port's step reproduce the reference's."""
    cfg, frames, _, _, _ = run
    state = j_init_state(cfg)
    state, _ = slam_scan(state, _pack(frames[:SEGMENT]), cfg)
    tree = state_to_numpy(state)
    key = jax.random.wrap_key_data(np.array(jax.random.key_data(state.key)))
    state, vecs = slam_scan(state, _pack(frames[SEGMENT:]), cfg)
    T_ref, _, codes_ref, _, _ = TStepOut.unpack_vecs(np.asarray(vecs))

    tstate = state_from_numpy(tree, cfg, device="cpu",
                              draws=JaxKeyDraws(key))
    assert int(tstate.frame_idx) == SEGMENT
    assert tstate.prev_frame["facade"].xyz.dtype == torch.float32
    T_port, codes_port = [], []
    for f in frames[SEGMENT:]:
        tstate, out = slam_step(tstate, t_pack(f, with_ts=False), cfg)
        T_port.append(out.T_rel.numpy().astype(np.float64))
        codes_port.append(int(out.code))
    assert codes_port == [int(c) for c in codes_ref]
    _assert_same_motion(T_port, T_ref)


@pytest.fixture(scope="module")
def warm():
    """The reference after SEGMENT stationary frames (a populated local map
    and a warm motion model), and one more scan from the same spot."""
    cfg = ge._small_cfg()
    rng = np.random.default_rng(5)
    world = ge._make_world(5)
    scans = [ge._render_scan(world, np.eye(4), cfg, rng)
             for _ in range(SEGMENT + 1)]
    state, _ = slam_scan(j_init_state(cfg), _pack(scans[:SEGMENT]), cfg)
    return cfg, state, scans[SEGMENT]


def _yaw(deg):
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    T[:2, :2] = [[c, -s], [s, c]]
    return T


def _shift(x):
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = x
    return T


@pytest.mark.parametrize("case,T_prior,age", [
    # a 40-deg-wrong prior after a blackout: the widened retry fails and
    # the yaw sweep re-acquires (tests/test_pipeline.py's scenario)
    ("yaw_sweep", _yaw(40.0), 4),
    # a warm prior 1.2 m off the truth: the solve deviates beyond the
    # sanity threshold and the mover veto's hypothesis test runs
    ("mover_veto", _shift(1.2), 0),
])
def test_recovery_paths_match_reference(warm, case, T_prior, age):
    """One step from the same perturbed state in both packages: the
    branches that ordinary frames never take (in-frame retry, mover veto,
    yaw sweep) give the same code and motion."""
    cfg, jstate, scan = warm
    jstate = jax.tree.map(jnp.copy, jstate).replace(
        T_prev=jnp.asarray(T_prior), model_age=jnp.int32(age),
        add_length=jnp.float32(0.0))
    key = jax.random.wrap_key_data(np.array(jax.random.key_data(
        jstate.key)))
    tstate = state_from_numpy(state_to_numpy(jstate), cfg, device="cpu",
                              draws=JaxKeyDraws(key))
    _, out = slam_step(tstate, t_pack(scan, with_ts=False), cfg)
    _, vecs = slam_scan(jstate, _pack([scan]), cfg)
    T_ref, _, code_ref, _, _ = TStepOut.unpack_vecs(np.asarray(vecs))
    assert int(out.code) == int(code_ref[0])
    _assert_same_motion([out.T_rel.numpy().astype(np.float64)], T_ref)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = ge._small_cfg()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TPipeline(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_state(cfg)
