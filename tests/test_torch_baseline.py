"""The NDT / VGICP baselines of the port against the JAX package on the CPU
(``ops/baseline_reg.py``, ``ops/voxel.py::random_downsample``,
``pipeline/baseline.py``), on the same numpy inputs from a seed.

Tolerances, each stated where it is checked:

* the voxel table: counts exact; means and the NDT covariances within
  ``8 |mean|^2 2^-23 n`` of a slot (fp32 sums of n terms of size
  ``|mean|^2`` at tens of metres, in both packages); the GICP covariance
  ``I - (1 - 1e-3) v3 v3^T`` within that bound over the slot's eigengap;
* a registration from one table and one guess: transforms within 1e-3 m /
  0.01 deg, equal iteration counts;
* the GICP source covariances on points with >= 5 neighbours and the same
  neighbour count in both: within 5e-3 (entries lie in [0, 1]);
* ``random_downsample`` with the reference's key replayed: equal masks;
* ``BaselinePipeline`` on 5 frames of the loop world at the budgets of
  ``tests/test_pipeline.py::test_baseline_odometry_synthetic``: equal
  codes and per-frame ``T_rel`` within 2 cm / 0.2 deg.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from mulls_tpu.ops import baseline_reg as jbr
from mulls_tpu.ops import voxel as jvx
from mulls_tpu.pipeline.baseline import BaselinePipeline as JBaseline
from mulls_tpu_torch.ops import baseline_reg as tbr
from mulls_tpu_torch.ops import voxel as tvx
from mulls_tpu_torch.pipeline.baseline import BaselinePipeline as TBaseline
from test_pipeline import _loop_world, _simulate_scan
from torch_parity import JaxKeyDraws, np_, t_

EPS32 = 2.0 ** -23


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's registrations are thousands of small operations: on a
    CPU shared by several test workers, one thread each runs them ~50x
    faster than a pool that waits on its peers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rot_deg(Ra, Rb):
    M = Ra.T @ Rb
    s = np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                        M[1, 0] - M[0, 1]]) / 2.0
    return float(np.degrees(np.arctan2(s, (np.trace(M) - 1.0) / 2.0)))


def _scene(seed, n=6000, shift=(30.0, -20.0, 0.0)):
    """Ground, two walls and posts (a full 6-DoF constraint), moved
    ``shift`` from the origin so that the table's sums are at tens of
    metres, as the map's are."""
    rng = np.random.default_rng(seed)
    n_g = n // 2
    g = np.stack([rng.uniform(-30, 30, n_g), rng.uniform(-30, 30, n_g),
                  0.03 * rng.normal(size=n_g)], -1)
    n_w = n // 3
    w1 = np.stack([np.full(n_w // 2, 12.0) + 0.03 * rng.normal(size=n_w // 2),
                   rng.uniform(-20, 20, n_w // 2),
                   rng.uniform(0, 4, n_w // 2)], -1)
    w2 = np.stack([rng.uniform(-20, 20, n_w - n_w // 2),
                   np.full(n_w - n_w // 2, -8.0)
                   + 0.03 * rng.normal(size=n_w - n_w // 2),
                   rng.uniform(0, 4, n_w - n_w // 2)], -1)
    n_p = n - n_g - n_w
    cx, cy = rng.uniform(-25, 25, 20), rng.uniform(-25, 25, 20)
    k = rng.integers(0, 20, n_p)
    p = np.stack([cx[k] + 0.02 * rng.normal(size=n_p),
                  cy[k] + 0.02 * rng.normal(size=n_p),
                  rng.uniform(0, 5, n_p)], -1)
    pts = np.concatenate([g, w1, w2, p]) + np.asarray(shift)
    return pts.astype(np.float32), rng.uniform(size=len(pts)) > 0.05


def _true_T():
    ang = np.radians(2.0)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(ang), -np.sin(ang), 0],
                 [np.sin(ang), np.cos(ang), 0], [0, 0, 1]]
    T[:3, 3] = [0.6, -0.3, 0.05]
    return T


def _tables(mode, res=1.5):
    pts, m = _scene(9)
    j = jbr.build_voxel_table(jnp.asarray(pts), jnp.asarray(m), res,
                              mode=mode)
    t = tbr.build_voxel_table(t_(pts), t_(m), res, mode=mode)
    return pts, m, j, t


@pytest.mark.parametrize("mode", ["ndt", "gicp"])
def test_build_voxel_table_matches_reference(mode):
    pts, m, j, t = _tables(mode)
    cnt_j, cnt_t = np.asarray(j.count), np_(t.count)
    np.testing.assert_array_equal(cnt_t, cnt_j)
    used = cnt_j > 0
    assert used.sum() > 150
    # raw per-slot count (before the min_points gate) and |mean| give the
    # fp32 bound of the slot's sums
    slot = np.asarray(jvx.hash_ijk(jnp.floor(jnp.asarray(pts) / 1.5)
                                   .astype(jnp.int32), 1 << 17))
    n = np.bincount(slot[m], minlength=1 << 17).astype(np.float64)
    mean_j = np.asarray(j.mean, np.float64)
    mag = np.linalg.norm(mean_j, axis=1)
    tol_mean = 8.0 * mag * EPS32 * np.maximum(n, 1.0)
    dm = np.abs(np_(t.mean) - mean_j).max(1)
    assert np.all(dm[used] <= tol_mean[used] + 1e-6), dm[used].max()
    tol_cov = 8.0 * mag ** 2 * EPS32 * np.maximum(n, 1.0)
    dc = np.abs(np_(t.cov).astype(np.float64)
                - np.asarray(j.cov, np.float64)).max((1, 2))
    if mode == "ndt":
        ok = dc <= tol_cov + 1e-6
    else:
        # I - (1 - 1e-3) v3 v3^T: v3 moves by the covariance error over the
        # slot's eigengap
        lam = np.linalg.eigvalsh(_raw_cov(pts, m, slot, n))
        gap = np.maximum(lam[:, 1] - lam[:, 0], 1e-12)
        ok = (dc <= 4.0 * tol_cov / gap + 1e-5) | (gap < 100.0 * tol_cov)
    assert np.all(ok[used]), dc[used][~ok[used]]
    np.testing.assert_array_equal(np_(t.inv_cov)[~used], 0.0)


def _raw_cov(pts, m, slot, n):
    """float64 unregularized covariance per slot (the eigengap's input)."""
    p = pts[m].astype(np.float64)
    s = slot[m]
    size = 1 << 17
    s1 = np.zeros((size, 3))
    s2 = np.zeros((size, 3, 3))
    np.add.at(s1, s, p)
    np.add.at(s2, s, p[:, :, None] * p[:, None, :])
    nn = np.maximum(n, 1.0)
    mean = s1 / nn[:, None]
    return s2 / nn[:, None, None] - mean[:, :, None] * mean[:, None, :]


def _source(pts, m):
    T = _true_T()
    return ((pts - T[:3, 3]) @ T[:3, :3]).astype(np.float32), m


@pytest.mark.parametrize("method", ["ndt", "gicp"])
def test_registration_from_one_table_matches_reference(method):
    """The reference's table and the same guess in both packages."""
    pts, m, j, _ = _tables(method, res=1.5 if method == "ndt" else 1.0)
    t = tbr.VoxelTable(count=t_(j.count), mean=t_(j.mean),
                       inv_cov=t_(j.inv_cov), cov=t_(j.cov),
                       resolution=float(j.resolution))
    src, sm = _source(pts, m)
    guess = np.eye(4, dtype=np.float32)
    if method == "ndt":
        rj = jbr.ndt_register(jnp.asarray(src), jnp.asarray(sm), j,
                              jnp.asarray(guess))
        rt = tbr.ndt_register(t_(src), t_(sm), t, t_(guess))
    else:
        cov = jbr.point_covariances(jnp.asarray(src), jnp.asarray(sm), 1.0)
        rj = jbr.vgicp_register(jnp.asarray(src), jnp.asarray(sm), cov, j,
                                jnp.asarray(guess))
        rt = tbr.vgicp_register(t_(src), t_(sm), t_(cov), t, t_(guess))
    Tj, Tt = np.asarray(rj.transform, np.float64), np_(rt.transform)
    assert int(rt.iterations) == int(rj.iterations)
    assert np.linalg.norm(Tt[:3, 3] - Tj[:3, 3]) < 1e-3
    assert _rot_deg(Tt[:3, :3], Tj[:3, :3]) < 0.01
    # and both recover the motion
    assert np.linalg.norm(Tt[:3, 3] - _true_T()[:3, 3]) < 0.08
    np.testing.assert_allclose(float(rt.matched), float(rj.matched),
                               rtol=1e-3)


def test_point_covariances_match_reference():
    # planes and posts near the origin, 2-15 neighbours within 1 m
    pts, m = _scene(12, n=3000, shift=(0.0, 0.0, 0.0))
    pts = pts[:1500] * np.float32(0.25)
    m = m[:1500]
    cj = np.asarray(jbr.point_covariances(jnp.asarray(pts), jnp.asarray(m),
                                          1.0))
    ct = np_(tbr.point_covariances(t_(pts), t_(m), 1.0))
    d2 = ((pts[:, None, :].astype(np.float64) - pts[None, :, :]) ** 2).sum(-1)
    near = (d2 <= 1.0) & m[None, :]
    # the two packages form d^2 differently: compare points whose
    # neighbourhoods have no point within 1e-4 of the radius
    clean = ~np.any(np.abs(d2 - 1.0) < 1e-4, axis=1)
    sel = m & clean & (near.sum(1) >= 5)
    assert sel.sum() > 500, sel.sum()
    assert np.abs(ct[sel] - cj[sel]).max() <= 5e-3


def test_random_downsample_matches_reference():
    rng = np.random.default_rng(13)
    mask = rng.uniform(size=5000) > 0.3
    key = jax.random.key(21)
    for keep in (10, 1000, 3400, 6000):
        want = np.asarray(jvx.random_downsample(jnp.asarray(mask), keep, key))
        got = np_(tvx.random_downsample(t_(mask), keep, JaxKeyDraws(key)))
        np.testing.assert_array_equal(got, want)
        assert got.sum() == min(keep, mask.sum())


N_FRAMES = 5


@pytest.fixture(scope="module", params=["ndt", "gicp"])
def runs(request):
    cfg = ge._small_cfg()
    cfg = dataclasses.replace(cfg, baseline=dataclasses.replace(
        cfg.baseline, method=request.param, frame_budget=4096,
        map_budget=8192, table_resolution=1.8, voxel_down_size=0.5,
        max_iter=20))
    rng = np.random.default_rng(1234)
    world = _loop_world(rng, n=60000, extent=40.0)
    gt = []
    for k in range(N_FRAMES):
        T = np.eye(4)
        T[0, 3] = 0.6 * k
        gt.append(T)
    frames = [_simulate_scan(world, g, cfg.shapes.n_raw, 30.0, rng)
              for g in gt]
    ref = JBaseline(cfg, segment=N_FRAMES).run(frames)
    port = TBaseline(cfg, segment=N_FRAMES, device="cpu",
                     draws=JaxKeyDraws(jax.random.key(0))).run(frames)
    return ref, port


def test_baseline_pipeline_matches_reference(runs):
    ref, port = runs
    assert port.codes == ref.codes
    assert all(c == 1 for c in port.codes), port.codes
    rel = lambda P: np.linalg.inv(P[:-1]) @ P[1:]
    for a, b in zip(rel(port.poses), rel(ref.poses)):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 0.02
        assert _rot_deg(a[:3, :3], b[:3, :3]) < 0.2
    np.testing.assert_allclose(np.diff(port.poses[:, 0, 3])[1:], 0.6,
                               atol=0.1)


def test_baseline_pipeline_defaults_to_cuda():
    cfg = ge._small_cfg()
    cfg = dataclasses.replace(cfg, baseline=dataclasses.replace(
        cfg.baseline, method="gicp"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TBaseline(cfg)
    with pytest.raises(ValueError, match="unknown baseline method"):
        TBaseline(dataclasses.replace(cfg, baseline=dataclasses.replace(
            cfg.baseline, method="icp")), device="cpu")
