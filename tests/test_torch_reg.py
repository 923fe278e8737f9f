"""The pairwise-registration slice of the port against the JAX package on
the CPU, on the same seeded numpy inputs: ``core/coord_trans.py``,
``frontend/icp.py::ground_3dof_estimate`` and ``::mm_lls_icp_4dof_global``,
``backend/coarse_reg.py::randint``, ``backend/fpfh.py`` and
``apps/reg.py``.

Tolerances, each stated where it is checked:

* the three coordinate transforms: transform and scale within 1e-5;
* ``ground_3dof_estimate``: transform within 1 mm / 0.01 deg, equal
  iteration counts;
* ``randint``: equal to ``jax.random.randint`` bit for bit;
* ``compute_fpfh``: at least 99 % of the entries within 1e-3 (percentages
  of a block, 0-100; the packages round the pair features differently);
* ``match_fpfh`` / the top-15 with exact descriptor ties: the same target
  indices; ``coarse_reg_fpfhsac`` within 2 cm / 0.2 deg, the same
  ``valid``;
* the 4-DoF heading sweep: the same winning seed yaw, transform within
  2 cm / 0.2 deg;
* ``register_pair`` on the same feature frames: equal process codes and
  ``coarse_valid``, transforms within 2 cm / 0.2 deg;
* the CLI end to end on the CPU, and the sweep through the CLI's
  ``register_frames``: within 0.1 m / 0.5 deg of the truth.

Frames are extracted once per package (one ``jit`` of the reference's
``extract_features`` for the one shape)."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import mulls_tpu.apps.reg as jreg
import mulls_tpu.frontend.features as jfeatures
from mulls_tpu.backend import fpfh as jfpfh
from mulls_tpu.core import coord_trans as jct
from mulls_tpu.core import se3 as jse3
from mulls_tpu.core.cloud import FeatureCloud as JCloud
from mulls_tpu.core.cloud import RawCloud as JRaw
from mulls_tpu.frontend import icp as jicp
from mulls_tpu.io.dataset import pad_cloud
from mulls_tpu_torch.apps import reg as treg
from mulls_tpu_torch.backend import coarse_reg as tcr
from mulls_tpu_torch.backend import fpfh as tfpfh
from mulls_tpu_torch.core import coord_trans as tct
from mulls_tpu_torch.frontend import icp as ticp
from mulls_tpu_torch.io.pcd import write_pcd
from test_fpfh import _rot, _synthetic_scene
from test_pipeline import _loop_world, _simulate_scan
from torch_parity import JaxKeyDraws, cloud_to_torch, frame_to_torch, np_, t_

YAW_DEG = 37.0  # the rotated source's extra heading: off the 15-deg grid


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's registrations are thousands of small operations: on a
    CPU shared by several test workers, one thread each runs them far
    faster than a pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rot_deg(Ra, Rb):
    M = Ra.T @ Rb
    s = np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                        M[1, 0] - M[0, 1]]) / 2.0
    return float(np.degrees(np.arctan2(s, (np.trace(M) - 1.0) / 2.0)))


def _assert_close_T(a, b, tol_m, tol_deg):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dt = float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
    dr = _rot_deg(a[:3, :3], b[:3, :3])
    assert dt < tol_m and dr < tol_deg, (dt, dr)


def _rz(deg):
    T = np.eye(4)
    T[:3, :3] = _rot(math.radians(deg))
    return T


# --------------------------------------------------------------------------
# coord_trans
# --------------------------------------------------------------------------

def _control_points(kind, rng):
    src = rng.uniform(-50, 50, (25, 3)).astype(np.float32)
    if kind == "4dof":
        dst = src.copy()
        dst[:, :2] = 1.02 * (src[:, :2] @ _rot(math.radians(23.0))[:2, :2].T
                             ) + np.array([100.0, -40.0])
        dst[:, 2] += 3.0
    elif kind == "6dof_svd":
        R = _rot(math.radians(31.0)) @ np.array(
            [[1, 0, 0], [0, 0.9962, -0.0872], [0, 0.0872, 0.9962]])
        dst = src @ R.T + np.array([5.0, -2.0, 1.0])
    else:
        r = np.array([0.002, -0.001, 0.003])
        R = np.eye(3) + np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]],
                                  [-r[1], r[0], 0]])
        dst = 1.0005 * (src @ R.T) + np.array([12.0, 7.0, -3.0])
    return src, dst.astype(np.float32)


@pytest.mark.parametrize("kind,kw", [("4dof", {}), ("6dof_svd", {}),
                                     ("6dof_svd", {"with_scale": True}),
                                     ("7dof", {})])
def test_coord_trans_matches_reference(kind, kw):
    src, dst = _control_points(kind, np.random.default_rng(7))
    fn = f"coord_tran_{kind}"
    Tj, sj = getattr(jct, fn)(jnp.asarray(src), jnp.asarray(dst), **kw)
    Tt, st = getattr(tct, fn)(t_(src), t_(dst), **kw)
    np.testing.assert_allclose(np_(Tt), np.asarray(Tj), atol=1e-5)
    assert abs(float(st) - float(sj)) < 1e-5
    # and it recovers the control points' transform
    out = src @ np_(Tt)[:3, :3].T + np_(Tt)[:3, 3]
    np.testing.assert_allclose(out, dst, atol=2e-2)


# --------------------------------------------------------------------------
# ground_3dof_estimate: tests/test_coord_variants.py's case
# --------------------------------------------------------------------------

def test_ground_3dof_estimate_matches_reference():
    from mulls_tpu.config import MullsConfig
    rng = np.random.default_rng(3)
    n = 512
    xyz = np.stack([rng.uniform(-20, 20, n), rng.uniform(-20, 20, n),
                    0.01 * rng.normal(size=n)], -1).astype(np.float32)
    a = np.radians(1.0)
    R = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                  [0, np.sin(a), np.cos(a)]], np.float32)
    src_xyz = xyz @ R.T
    src_xyz[:, 2] -= 0.3

    def cloud(p, nrm):
        return JCloud(xyz=jnp.asarray(p), normal=jnp.asarray(nrm),
                      strength=jnp.ones(n, jnp.float32),
                      intensity=jnp.zeros(n, jnp.float32),
                      height=jnp.zeros(n, jnp.float32),
                      ts_ratio=jnp.zeros(n, jnp.float32),
                      mask=jnp.ones(n, bool))

    tgt = cloud(xyz, np.tile(np.array([0, 0, 1], np.float32), (n, 1)))
    src = cloud(src_xyz, np.tile(R[:, 2], (n, 1)))
    cfg = MullsConfig().reg
    rj = jicp.ground_3dof_estimate(src, tgt, cfg, jnp.eye(4))
    rt = ticp.ground_3dof_estimate(cloud_to_torch(src), cloud_to_torch(tgt),
                                   cfg, torch.eye(4))
    _assert_close_T(np_(rt.transform), rj.transform, 1e-3, 0.01)
    assert int(rt.iterations) == int(rj.iterations)
    assert abs(float(rt.sigma) - float(rj.sigma)) < 1e-4
    T = np_(rt.transform)
    assert abs(T[2, 3] - 0.3) < 0.05  # z and roll recovered
    assert abs(_rot_deg(np.eye(3), T[:3, :3]) - 1.0) < 0.3


# --------------------------------------------------------------------------
# randint
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(0, 2), (0, 15), (3, 10), (0, 1000),
                                   (-7, 993), (5, 5)])
def test_randint_replays_the_reference_draw(lo, hi):
    for seed in range(40):
        for shape in ((1,), (512, 3), (37,)):
            key = jax.random.key(seed)
            want = np.asarray(jax.random.randint(key, shape, lo, hi))
            got = tcr.randint(JaxKeyDraws(key), shape, lo, hi)
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(np_(got), want)


# --------------------------------------------------------------------------
# FPFH
# --------------------------------------------------------------------------

def _scene_t(seed):
    xyz, nrm = _synthetic_scene(np.random.default_rng(seed))
    return np.asarray(xyz), np.asarray(nrm)


def test_compute_fpfh_matches_reference():
    xyz, nrm = _scene_t(0)
    mask = np.ones(len(xyz), bool)
    mask[::17] = False
    fj = np.asarray(jfpfh.compute_fpfh(jnp.asarray(xyz), jnp.asarray(nrm),
                                       jnp.asarray(mask), 2.0))
    ft = np_(tfpfh.compute_fpfh(t_(xyz), t_(nrm), t_(mask), 2.0))
    assert np.mean(np.abs(ft - fj) <= 1e-3) >= 0.99


def test_compute_fpfh_is_rotation_invariant_and_masks_rows():
    """tests/test_fpfh.py::test_fpfh_rotation_invariance on the port."""
    xyz, nrm = _scene_t(0)
    mask = torch.ones(len(xyz), dtype=torch.bool)
    f0 = np_(tfpfh.compute_fpfh(t_(xyz), t_(nrm), mask, 2.0))
    R = _rot(0.7)
    f1 = np_(tfpfh.compute_fpfh(t_(xyz @ R.T), t_(nrm @ R.T), mask, 2.0))
    assert np.abs(f0 - f1).max() < 1e-2
    assert np.allclose(f0.reshape(-1, 3, 11).sum(-1), 100.0, atol=1e-3)
    mask[:10] = False
    f2 = np_(tfpfh.compute_fpfh(t_(xyz), t_(nrm), mask, 2.0))
    assert np.all(f2[:10] == 0.0)


def _tied_descriptors(rng, n_src=300, n_tgt=400):
    """Integer-valued descriptors drawn from 12 distinct rows, so that
    many target descriptors are equal and every distance is exact in fp32
    in both packages (the ties plane interiors give in real scans)."""
    base = rng.integers(0, 100, (12, 33)).astype(np.float32)
    f_src = base[rng.integers(0, 12, n_src)]
    f_tgt = base[rng.integers(0, 12, n_tgt)]
    m_src = rng.uniform(size=n_src) < 0.9
    m_tgt = rng.uniform(size=n_tgt) < 0.9
    return f_src, m_src, f_tgt, m_tgt


def test_match_fpfh_breaks_exact_ties_as_lax_top_k():
    f_src, m_src, f_tgt, m_tgt = _tied_descriptors(np.random.default_rng(5))
    # the top 15: ties to the lower index, as lax.top_k(-d2, 15)
    d2 = (np.sum(f_src ** 2, -1)[:, None] - 2.0 * f_src @ f_tgt.T
          + np.sum(f_tgt ** 2, -1)[None, :])
    _, want = jax.lax.top_k(-jnp.where(m_tgt[None, :], d2, jnp.inf), 15)
    got = tfpfh._descriptor_topk(t_(f_src), t_(f_tgt), t_(m_tgt), 15)
    np.testing.assert_array_equal(np_(got), np.asarray(want))
    for seed in range(4):
        key = jax.random.key(seed)
        mj = jfpfh.match_fpfh(jnp.asarray(f_src), jnp.asarray(m_src),
                              jnp.asarray(f_tgt), jnp.asarray(m_tgt), key)
        mt = tfpfh.match_fpfh(t_(f_src), t_(m_src), t_(f_tgt), t_(m_tgt),
                              JaxKeyDraws(key))
        np.testing.assert_array_equal(np_(mt.tgt_idx), np.asarray(mj.tgt_idx))
        np.testing.assert_array_equal(np_(mt.mask), np.asarray(mj.mask))


def test_coarse_reg_fpfhsac_matches_reference():
    """tests/test_fpfh.py::test_coarse_reg_fpfhsac_recovers_transform's
    case through both packages with the same key."""
    xyz, nrm = _scene_t(2)
    mask = np.ones(len(xyz), bool)
    R = _rot(0.35)
    t = np.array([2.0, -1.5, 0.3], np.float32)
    src = (xyz @ R.T + t).astype(np.float32)
    src_n = (nrm @ R.T).astype(np.float32)
    key = jax.random.PRNGKey(0)
    rj, fit_j = jfpfh.coarse_reg_fpfhsac(
        jnp.asarray(src), jnp.asarray(src_n), jnp.asarray(mask),
        jnp.asarray(xyz), jnp.asarray(nrm), jnp.asarray(mask), key,
        search_radius=1.0, inlier_thre=0.5)
    rt, fit_t = tfpfh.coarse_reg_fpfhsac(
        t_(src), t_(src_n), t_(mask), t_(xyz), t_(nrm), t_(mask),
        JaxKeyDraws(key), search_radius=1.0, inlier_thre=0.5)
    _assert_close_T(np_(rt.transform), rj.transform, 0.02, 0.2)
    assert bool(rt.valid) == bool(rj.valid) and bool(rt.valid)
    assert abs(int(rt.inlier_count) - int(rj.inlier_count)) <= 2
    T_gt = np.eye(4)
    T_gt[:3, :3] = R.T
    T_gt[:3, 3] = -R.T @ t
    _assert_close_T(np_(rt.transform), T_gt, 0.3, 3.0)
    assert float(fit_t) < 0.1


# --------------------------------------------------------------------------
# the scan pair: the loop world at the parity tests' small width
# --------------------------------------------------------------------------

def _pose(x, y, yaw_deg):
    return np.asarray(jse3.make_transform(
        jnp.asarray([x, y, 0.0], jnp.float32),
        jnp.asarray([0.0, 0.0, math.radians(yaw_deg)], jnp.float32)),
        np.float64)


def _rotated(scan, deg):
    """A scan turned about its origin: the truth becomes T @ Rz(-deg)."""
    out = dict(scan)
    out["xyz"] = (scan["xyz"] @ _rz(deg)[:3, :3].T).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def pair():
    """Target and source scans 1.55 m / 6 deg apart, the source also
    turned by YAW_DEG, and the reference's feature frames of the three
    (key 1 for the target, key 2 for the sources, as its CLI draws)."""
    cfg = ge._small_cfg()
    rng = np.random.default_rng(5)
    world = _loop_world(rng)
    P_t, P_s = _pose(0.0, 0.0, 0.0), _pose(1.5, 0.4, 6.0)
    scan_t = _simulate_scan(world, P_t, cfg.shapes.n_raw, 35.0, rng)
    scan_s = _simulate_scan(world, P_s, cfg.shapes.n_raw, 35.0, rng)
    scan_r = _rotated(scan_s, YAW_DEG)
    T_true = np.linalg.inv(P_t) @ P_s
    extract = jax.jit(jfeatures.extract_features, static_argnames=("cfg",))

    def features(scan, k):
        p = pad_cloud(scan, cfg.shapes.n_raw)
        raw = JRaw(**{f: jnp.asarray(p[f]) for f in
                      ("xyz", "intensity", "ts_ratio", "mask")})
        return extract(raw, cfg, jax.random.key(k))

    return {"cfg": cfg, "scans": (scan_t, scan_s, scan_r),
            "T_true": T_true, "T_rot": T_true @ _rz(-YAW_DEG),
            "ft": features(scan_t, 1), "fs": features(scan_s, 2),
            "fr": features(scan_r, 2)}


def _reference_register(monkeypatch, cfg, scans, ft, fs, coarse):
    """The reference's ``register_pair`` on the given feature frames: its
    extraction (jitted inside the function) hands back ``ft`` then ``fs``
    for the two scans."""
    frames = [ft, fs]

    def given(raw, cfg_, key):
        return frames.pop(0)

    jit = jax.jit
    monkeypatch.setattr(jfeatures, "extract_features", given)
    monkeypatch.setattr(jax, "jit", lambda f, **kw: f if f is given
                        else jit(f, **kw))
    try:
        return jreg.register_pair(cfg, *scans, coarse=coarse)
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("coarse", ["gnc", "ransac", "bev", "none"])
def test_register_pair_matches_reference(pair, monkeypatch, coarse):
    cfg = pair["cfg"]
    Tj, sj = _reference_register(monkeypatch, cfg, pair["scans"][:2],
                                 pair["ft"], pair["fs"], coarse)
    Tt, st = treg.register_frames(cfg, frame_to_torch(pair["ft"]),
                                  frame_to_torch(pair["fs"]), coarse, None,
                                  JaxKeyDraws(jax.random.key(3)))
    assert st["process_code"] == sj["process_code"] == 1
    assert st.get("coarse_valid") == sj.get("coarse_valid")
    assert st.get("bev_fallback") == sj.get("bev_fallback")
    _assert_close_T(Tt, Tj, 0.02, 0.2)
    _assert_close_T(Tt, pair["T_true"], 0.1, 0.5)


@pytest.fixture(scope="module")
def sweep(pair):
    """The 4-DoF heading sweep of the turned source in both packages."""
    cfg = pair["cfg"]
    kw = dict(heading_step_d=cfg.reg.heading_change_step_degree,
              max_iter=cfg.reg.reg_max_iter_num_s2s)
    ref = jicp.mm_lls_icp_4dof_global(pair["fr"].down, pair["ft"].full,
                                      cfg.reg, **kw)
    port = ticp.mm_lls_icp_4dof_global(frame_to_torch(pair["fr"]).down,
                                       frame_to_torch(pair["ft"]).full,
                                       cfg.reg, **kw)
    return ref, port


def test_heading_sweep_matches_reference(pair, sweep):
    (rj, yaw_j, score_j), (rt, yaw_t, score_t) = sweep
    assert float(yaw_t) == float(yaw_j)
    assert abs(float(score_t) - float(score_j)) <= 1e-3 * abs(float(score_j))
    assert int(rt.process_code) == int(rj.process_code) == 1
    _assert_close_T(np_(rt.transform), rj.transform, 0.02, 0.2)
    _assert_close_T(np_(rt.transform), pair["T_rot"], 0.1, 0.5)


def test_yaw4dof_cli_path_unpacks_what_the_reference_reads_wrong(
        pair, monkeypatch):
    """A deliberate difference from the reference: its
    ``register_pair(..., coarse="yaw4dof")`` reads the sweep's 3-tuple
    (result, yaw, score) as a result (``mulls_tpu/apps/reg.py:85-99``) and
    raises AttributeError; the port's CLI unpacks the tuple and returns
    the sweep's result."""
    cfg = pair["cfg"]
    with pytest.raises(AttributeError):
        _reference_register(monkeypatch, cfg, pair["scans"][::2],
                            pair["ft"], pair["fr"], "yaw4dof")
    T, stats = treg.register_frames(cfg, frame_to_torch(pair["ft"]),
                                    frame_to_torch(pair["fr"]), "yaw4dof",
                                    None, JaxKeyDraws(jax.random.key(3)))
    assert stats["process_code"] == 1
    _assert_close_T(T, pair["T_rot"], 0.1, 0.5)


def test_reg_cli_registers_two_pcd_files_on_the_cpu(pair, tmp_path,
                                                    monkeypatch):
    """``apps/reg.py::main`` end to end with ``--device cpu``: two pcd
    files in, the default coarse step (GNC with the BEV fallback), its own
    features and draws; exit 0, the moved cloud and the JSON record."""
    scan_t, scan_s, _ = pair["scans"]
    paths = []
    for name, scan in (("target", scan_t), ("source", scan_s)):
        m = scan["mask"]
        p = str(tmp_path / f"{name}.pcd")
        write_pcd(p, scan["xyz"][m], intensity=scan["intensity"][m])
        paths.append(p)
    monkeypatch.setattr(treg, "MullsConfig", ge._small_cfg)
    out = tmp_path / "moved.pcd"
    js = tmp_path / "reg.json"
    rc = treg.main(["--point_cloud_1_path", paths[0],
                    "--point_cloud_2_path", paths[1],
                    "--output_point_cloud_path", str(out),
                    "--json_out", str(js), "--device", "cpu"])
    assert rc == 0
    from mulls_tpu_torch.io.pcd import read_pcd
    assert len(read_pcd(str(out))["xyz"]) == int(scan_s["mask"].sum())
    rec = json.loads(js.read_text())
    assert rec["process_code"] == 1
    _assert_close_T(np.asarray(rec["transform"]), pair["T_true"], 0.1, 0.5)


def test_reg_cli_runs_on_the_card_unless_asked():
    """Without a card the default ``--device cuda`` raises; the CPU runs
    only when asked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        treg.register_pair(ge._small_cfg(), {}, {})
