"""Parity of the port's core and ops modules with the JAX package: se3,
the packed scan decode, compaction, Morton order, the closed-form 3x3
eigensolver, neighborhood PCA, the voxel masks, the ground filter (with the
reference's draws replayed), NMS, motion compensation, and the copied
config.

Same inputs (numpy, seeded) through both packages on the CPU; each
tolerance is stated with its reason."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import mulls_tpu.config as jcfg
import mulls_tpu_torch.config as tcfg
from mulls_tpu.core import cloud as jcloud
from mulls_tpu.core import se3 as jse3
from mulls_tpu.ops import ground as jground
from mulls_tpu.ops import nms as jnms
from mulls_tpu.ops import pca as jpca
from mulls_tpu.ops import voxel as jvoxel
from mulls_tpu_torch.core import cloud as tcloud
from mulls_tpu_torch.core import se3 as tse3
from mulls_tpu_torch.ops import ground as tground
from mulls_tpu_torch.ops import nms as tnms
from mulls_tpu_torch.ops import pca as tpca
from mulls_tpu_torch.ops import voxel as tvoxel
from torch_parity import JaxKeyDraws, np_, t_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- se3 --------------------------------------------------------------------

def _se3_inputs():
    rng = np.random.default_rng(10)
    e = rng.uniform(-0.6, 0.6, (8, 3)).astype(np.float32)
    t = rng.uniform(-5, 5, (8, 3)).astype(np.float32)
    T = np.array(jse3.make_transform(t, e))
    R_noisy = (T[:, :3, :3]
               + 0.01 * rng.normal(size=(8, 3, 3))).astype(np.float32)
    pts = rng.uniform(-30, 30, (8, 50, 3)).astype(np.float32)
    w = rng.uniform(-1, 1, (8, 3)).astype(np.float32)
    q = np.array(jse3.quat_from_rotation(T[:, :3, :3]))
    delta = rng.uniform(-0.3, 0.3, (8, 6)).astype(np.float32)
    return {"e": e, "t": t, "T": T, "Rn": R_noisy, "pts": pts, "w": w,
            "q": q, "q2": q[::-1].copy(), "delta": delta}


_SE3_CASES = {
    "make_transform": lambda m, a: m.make_transform(a["t"], a["e"]),
    "inverse": lambda m, a: m.inverse(a["T"]),
    "transform_points": lambda m, a: m.transform_points(a["T"], a["pts"]),
    "rotate_vectors": lambda m, a: m.rotate_vectors(a["T"], a["pts"]),
    "rotation_angle": lambda m, a: m.rotation_angle(a["T"][:, :3, :3]),
    "orthonormalize": lambda m, a: m.orthonormalize(a["Rn"]),
    "quat_euler_jacobi": lambda m, a: m.quat_euler_jacobi(a["e"]),
    "quat_from_rotation": lambda m, a: m.quat_from_rotation(
        a["T"][:, :3, :3]),
    "rotation_from_quat": lambda m, a: m.rotation_from_quat(a["q"]),
    "so3_exp": lambda m, a: m.so3_exp(a["w"]),
    "skew": lambda m, a: m.skew(a["w"]),
    "translation_norm": lambda m, a: m.translation_norm(a["T"]),
    "quat_mul": lambda m, a: m.quat_mul(a["q"], a["q2"]),
    "quat_conj": lambda m, a: m.quat_conj(a["q"]),
    "se3_boxplus": lambda m, a: m.se3_boxplus(a["T"], a["delta"]),
}


@pytest.mark.parametrize("name", sorted(_SE3_CASES))
def test_se3_matches_reference(name):
    a = _se3_inputs()
    fn = _SE3_CASES[name]
    ref = np.asarray(fn(jse3, {k: jnp.asarray(v) for k, v in a.items()}))
    out = np_(fn(tse3, {k: torch.from_numpy(v) for k, v in a.items()}))
    # fp32 on both sides; 30 m points -> a few ulp of 30 m
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-5)


# --- packed decode, compaction ---------------------------------------------

def test_packed_decode_matches_reference():
    cfg = ge._small_cfg()
    d = ge._synthetic_raw(cfg)
    jp = jcloud.pack_raw_host(d)
    tp = tcloud.pack_raw_host(d)
    np.testing.assert_array_equal(np_(tp.xyz_q), jp.xyz_q)
    np.testing.assert_array_equal(np_(tp.intensity_q), jp.intensity_q)
    np.testing.assert_array_equal(np_(tp.ts_q), jp.ts_q.astype(np.int32))
    jr = jcloud.unpack_raw(jax.tree.map(jnp.asarray, jp))
    tr = tcloud.unpack_raw(tp)
    # exact: the same int -> f32 scaling on both sides
    for f in ("xyz", "intensity", "ts_ratio", "mask"):
        np.testing.assert_array_equal(np_(getattr(tr, f)),
                                      np.asarray(getattr(jr, f)))
    assert int(tp.n) == int(d["mask"].sum())


@pytest.mark.parametrize("prefer", [False, True])
def test_compact_topk_random_matches_reference(prefer):
    rng = np.random.default_rng(11)
    mask = rng.uniform(size=3000) < 0.3
    pref = (rng.integers(0, 2, 3000) * 0.5).astype(np.float32)
    key = jax.random.key(3)
    ji, jv = jcloud.compact_topk_random(jnp.asarray(mask), 512, key,
                                        prefer=jnp.asarray(pref) if prefer
                                        else None)
    u = JaxKeyDraws(key).uniform(mask.shape)
    ti, tv = tcloud.compact_topk_random(torch.from_numpy(mask), 512, u,
                                        prefer=torch.from_numpy(pref)
                                        if prefer else None)
    # same draws and a stable sort with lax.top_k's tie order: identical
    np.testing.assert_array_equal(np_(ti), np.asarray(ji))
    np.testing.assert_array_equal(np_(tv), np.asarray(jv))


def test_compact_topk_score_ties_follow_lax_top_k():
    rng = np.random.default_rng(12)
    mask = rng.uniform(size=1000) < 0.5
    score = rng.integers(0, 5, 1000).astype(np.float32)  # many ties
    ji, jv = jcloud.compact_topk_score(jnp.asarray(mask), jnp.asarray(score),
                                       300)
    ti, tv = tcloud.compact_topk_score(torch.from_numpy(mask),
                                       torch.from_numpy(score), 300)
    np.testing.assert_array_equal(np_(ti), np.asarray(ji))
    np.testing.assert_array_equal(np_(tv), np.asarray(jv))


# --- pca ----------------------------------------------------------------------

def test_morton_order_matches_reference():
    rng = np.random.default_rng(13)
    xyz = rng.uniform(-60, 60, (5000, 3)).astype(np.float32)
    xyz[:100] = xyz[100:200]  # duplicate codes: stable order decides
    np.testing.assert_array_equal(
        np_(tpca.morton_order(torch.from_numpy(xyz))),
        np.asarray(jpca.morton_order(jnp.asarray(xyz))))


def test_eigh_sym3x3_matches_reference():
    rng = np.random.default_rng(14)
    a = rng.normal(size=(500, 3, 3)).astype(np.float32)
    A = a @ a.transpose(0, 2, 1)
    # degenerate cases: isotropic, rank-1, a plane
    A[0] = np.eye(3)
    A[1] = np.outer([1, 2, 3], [1, 2, 3])
    A[2] = np.diag([1.0, 1.0, 0.0])
    A = A.astype(np.float32)
    jv, jV = jpca.eigh_sym3x3(jnp.asarray(A))
    tv, tV = tpca.eigh_sym3x3(torch.from_numpy(A))
    # the same closed form op by op: equal to a few fp32 ulp of the scale
    np.testing.assert_allclose(np_(tv), np.asarray(jv), rtol=1e-5, atol=1e-4)
    # eigenvectors of the well-separated cases agree (up to fp32 rounding)
    np.testing.assert_allclose(np_(tV)[3:], np.asarray(jV)[3:], atol=2e-3)


def test_pca_features_matches_reference():
    cfg = ge._small_cfg()
    d = ge._synthetic_raw(cfg)
    valid = np.where(d["mask"])[0]
    sel = np.random.default_rng(19).choice(valid, 8000, replace=False)
    p = d["xyz"][sel]
    q = p[:2000]
    qm = np.ones(2000, bool)
    pm = np.ones(len(p), bool)
    j = jpca.pca_features(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(p),
                          jnp.asarray(pm), radius=1.5, min_k=7)
    t = tpca.pca_features(*[torch.from_numpy(x) for x in (q, qm, p, pm)],
                          radius=1.5, min_k=7)
    # counts: the reference's expanded d2 may move a boundary point by one
    cnt_diff = np.abs(np_(t.count) - np.asarray(j.count))
    assert np.mean(cnt_diff == 0) > 0.99 and cnt_diff.max() <= 2
    both = np_(t.valid) & np.asarray(j.valid) & (cnt_diff == 0)
    # the reference's CPU path sums uncentred f32 moments (~1e-4 m^2 noise
    # at 30 m); the port centres at the query: eigenvalues within 2e-3 m^2
    np.testing.assert_allclose(np_(t.eigvals)[both],
                               np.asarray(j.eigvals)[both], atol=2e-3)
    # planar points: normals agree up to sign
    planar = both & (np.asarray(j.planarity) > 0.62)
    dots = np.abs(np.sum(np_(t.normal)[planar]
                         * np.asarray(j.normal)[planar], -1))
    assert planar.sum() > 100 and np.mean(dots > 0.99) > 0.98


def test_pca_features_do_not_depend_on_the_summation_order():
    """The same support in reversed order sums each query's moments in
    another order (last-ulp differences, as between the CUDA kernel and
    the plain version).  The closed form runs in float64, so curvature,
    linearity and planarity move by ~1e-7; in float32 its arccos near a
    plane's repeated eigenvalue turned such ulps into ~1e-4, enough to
    reorder the curvature top-k."""
    cfg = ge._small_cfg()
    d = ge._synthetic_raw(cfg, seed=4)
    valid = np.where(d["mask"])[0]
    sel = np.random.default_rng(20).choice(valid, 8000, replace=False)
    p = torch.from_numpy(d["xyz"][sel])
    q = p[:3000].clone()
    qm = torch.ones(3000, dtype=torch.bool)
    pm = torch.ones(8000, dtype=torch.bool)
    a = tpca.pca_features(q, qm, p, pm, radius=1.0, min_k=7)
    b = tpca.pca_features(q, qm, p.flip(0), pm, radius=1.0, min_k=7)
    assert torch.equal(a.count, b.count)
    v = a.valid
    assert int(v.sum()) > 1000
    for f in ("curvature", "linearity", "planarity"):
        diff = (getattr(a, f) - getattr(b, f))[v].abs().max()
        assert float(diff) < 1e-5, (f, float(diff))


# --- voxel masks --------------------------------------------------------------

def test_filter_masks_match_reference():
    rng = np.random.default_rng(15)
    xyz = rng.uniform(-130, 130, (20000, 3)).astype(np.float32)
    xyz[:, 2] *= 0.1
    mask = rng.uniform(size=20000) < 0.95
    jx, jm = jnp.asarray(xyz), jnp.asarray(mask)
    tx, tm = torch.from_numpy(xyz), torch.from_numpy(mask)
    np.testing.assert_array_equal(
        np_(tvoxel.dist_filter_mask(tx, tm, 1.5, 120.0)),
        np.asarray(jvoxel.dist_filter_mask(jx, jm, 1.5, 120.0)))
    np.testing.assert_array_equal(
        np_(tvoxel.scanner_filter_mask(tx, tm, 1.8, -6.0)),
        np.asarray(jvoxel.scanner_filter_mask(jx, jm, 1.8, -6.0)))
    np.testing.assert_array_equal(
        np_(tvoxel.voxel_downsample_mask(tx, tm, 2.0)),
        np.asarray(jvoxel.voxel_downsample_mask(jx, jm, 2.0)))
    inten = rng.uniform(0, 255, 20000).astype(np.float32)
    np.testing.assert_array_equal(
        np_(tvoxel.intensity_filter_mask(torch.from_numpy(inten), tm, 0.1,
                                         0.8)),
        np.asarray(jvoxel.intensity_filter_mask(jnp.asarray(inten), jm,
                                                0.1, 0.8)))
    nrm = rng.normal(size=(20000, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    np.testing.assert_array_equal(
        np_(tvoxel.incidence_angle_filter_mask(tx, torch.from_numpy(nrm), tm,
                                               0.1, 1.2)),
        np.asarray(jvoxel.incidence_angle_filter_mask(jx, jnp.asarray(nrm),
                                                      jm, 0.1, 1.2)))


def test_xy_normal_balanced_mask_matches_reference():
    rng = np.random.default_rng(16)
    nrm = rng.normal(size=(4000, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    mask = rng.uniform(size=4000) < 0.7
    key = jax.random.key(5)
    j = jvoxel.xy_normal_balanced_mask(jnp.asarray(nrm), jnp.asarray(mask),
                                       100, 4, key)
    t = tvoxel.xy_normal_balanced_mask(torch.from_numpy(nrm),
                                       torch.from_numpy(mask), 100, 4,
                                       JaxKeyDraws(key).uniform(mask.shape))
    np.testing.assert_array_equal(np_(t), np.asarray(j))


# --- ground filter --------------------------------------------------------------

@pytest.mark.parametrize("method", [0, 3])
def test_ground_filter_matches_reference_with_its_draws(method):
    cfg = ge._small_cfg()
    gcfg = dataclasses.replace(cfg.ground, ground_normal_method=method)
    d = ge._synthetic_raw(cfg, seed=3)
    key = jax.random.key(7)
    j = jground.fast_ground_filter(
        jnp.asarray(d["xyz"]), jnp.asarray(d["intensity"]),
        jnp.asarray(d["mask"]), gcfg, cfg.shapes, key)
    t = tground.fast_ground_filter(
        torch.from_numpy(d["xyz"]), torch.from_numpy(d["intensity"]),
        torch.from_numpy(d["mask"]), tcfg.GroundFilterConfig(
            **dataclasses.asdict(gcfg)), cfg.shapes, JaxKeyDraws(key))
    # same draws, same integer pick keys: the masks agree but for points
    # sitting on a threshold after fp32 sums taken in another order
    for f in ("is_ground", "is_unground"):
        agree = np.mean(np_(getattr(t, f)) == np.asarray(getattr(j, f)))
        assert agree > 0.999, (f, agree)
    np.testing.assert_allclose(np_(t.height), np.asarray(j.height),
                               atol=1e-3)
    g = np.asarray(j.is_ground)
    dots = np.sum(np_(t.normal)[g] * np.asarray(j.normal)[g], -1)
    assert np.mean(dots > 0.9999) > 0.999
    np.testing.assert_array_equal(np_(t.cell_id), np.asarray(j.cell_id))


def test_ground_filter_pick_hash_is_uint32_exact():
    """The murmur-style pick hash of ground.py:138-148 in int64 equals the
    reference's uint32 arithmetic."""
    salt = np.random.default_rng(17).integers(0, 1 << 32, (1, 12),
                                              dtype=np.uint64)
    n = 5000
    h = (np.arange(n, dtype=np.uint64)[:, None] * np.uint64(2654435761)
         + salt) & np.uint64(0xFFFFFFFF)
    h = h ^ (h >> np.uint64(16))
    h = (h * np.uint64(0x7FEB352D)) & np.uint64(0xFFFFFFFF)
    h = h ^ (h >> np.uint64(15))
    h = (h * np.uint64(0x846CA68B)) & np.uint64(0xFFFFFFFF)
    h = h ^ (h >> np.uint64(16))
    ht = (tground._mul32(torch.arange(n, dtype=torch.int64)[:, None],
                         2654435761)
          + torch.from_numpy(salt.astype(np.int64))) & 0xFFFFFFFF
    ht = ht ^ (ht >> 16)
    ht = tground._mul32(ht, 0x7FEB352D)
    ht = ht ^ (ht >> 15)
    ht = tground._mul32(ht, 0x846CA68B)
    ht = ht ^ (ht >> 16)
    np.testing.assert_array_equal(np_(ht), h.astype(np.int64))


# --- nms ----------------------------------------------------------------------------

def test_nms_matches_reference():
    rng = np.random.default_rng(18)
    xyz = rng.uniform(-10, 10, (3000, 3)).astype(np.float32)
    sal = rng.uniform(size=3000).astype(np.float32)
    sal[:50] = sal[50:100]  # ties: the earlier index wins on both sides
    mask = rng.uniform(size=3000) < 0.9
    j = jnms.non_max_suppress(jnp.asarray(xyz), jnp.asarray(sal),
                              jnp.asarray(mask), 0.6)
    t = tnms.non_max_suppress(torch.from_numpy(xyz), torch.from_numpy(sal),
                              torch.from_numpy(mask), 0.6)
    # the same expanded-distance formula as the reference: identical
    np.testing.assert_array_equal(np_(t), np.asarray(j))


# --- motion compensation ------------------------------------------------------------

def _scan_and_motion():
    rng = np.random.default_rng(19)
    xyz = rng.uniform(-40, 40, (2000, 3)).astype(np.float32)
    mask = rng.uniform(size=2000) < 0.9
    mask[0] = False  # the azimuth origin is the first VALID return
    T = np.asarray(jse3.make_transform(
        jnp.asarray([0.9, -0.1, 0.02], jnp.float32),
        jnp.asarray([0.002, -0.001, 0.03], jnp.float32)))
    return xyz, mask, T


def test_timestamp_ratio_and_undistort_match_reference():
    from mulls_tpu.ops import motion as jmotion
    from mulls_tpu_torch.ops import motion as tmotion
    xyz, mask, T = _scan_and_motion()
    js = np.array(jmotion.timestamp_ratio_from_azimuth(jnp.asarray(xyz),
                                                         jnp.asarray(mask)))
    ts = np_(tmotion.timestamp_ratio_from_azimuth(torch.from_numpy(xyz),
                                                  torch.from_numpy(mask)))
    # atan2 and the remainder in f32 on both sides: a few ulp of 2 pi
    np.testing.assert_allclose(ts, js, atol=1e-6)
    for T_rel in (T, np.eye(4, dtype=np.float32)):  # slerp and lerp arms
        ju = np.asarray(jmotion.undistort(jnp.asarray(xyz), jnp.asarray(js),
                                          jnp.asarray(mask),
                                          jnp.asarray(T_rel), min_range=2.0))
        tu = np_(tmotion.undistort(torch.from_numpy(xyz),
                                   torch.from_numpy(js),
                                   torch.from_numpy(mask),
                                   torch.from_numpy(T_rel), min_range=2.0))
        # f32 rotations of 40 m points: a few ulp of 40 m
        np.testing.assert_allclose(tu, ju, atol=2e-5)


@pytest.mark.parametrize("deg", [0.0, 0.35, 180.0])
def test_vertical_intrinsic_calibration_matches_reference(deg):
    from mulls_tpu.ops import motion as jmotion
    from mulls_tpu_torch.ops import motion as tmotion
    xyz, _, _ = _scan_and_motion()
    j = np.asarray(jmotion.vertical_intrinsic_calibration(jnp.asarray(xyz),
                                                          deg))
    t = np_(tmotion.vertical_intrinsic_calibration(torch.from_numpy(xyz),
                                                   deg))
    np.testing.assert_allclose(t, j, atol=2e-5)


# --- config copy --------------------------------------------------------------------

def test_config_copy_is_verbatim():
    """mulls_tpu_torch/config.py is a verbatim copy of mulls_tpu/config.py:
    a change to one must be made to the other."""
    with open(os.path.join(REPO, "mulls_tpu", "config.py")) as f:
        ref = f.read()
    with open(os.path.join(REPO, "mulls_tpu_torch", "config.py")) as f:
        port = f.read()
    assert port == ref


def test_config_defaults_and_flagfile_match_field_by_field(tmp_path):
    assert dataclasses.asdict(tcfg.MullsConfig()) == \
        dataclasses.asdict(jcfg.MullsConfig())
    flags = tmp_path / "flags.txt"
    flags.write_text("\n".join([
        "--max_dist_used=80", "--gf_grid_size=2.0", "--cloud_pca_neigh_r=0.8",
        "--corr_dis_thre_init=2.0", "--used_feature_type=111111",
        "--apply_map_based_dynamic_removal=false", "--s2m_frequency=2",
        "--motion_compensation_method=2", "--real_time_viewer_on=1",
        "--unknown_flag=3"]) + "\n")
    j = dataclasses.asdict(jcfg.load_flagfile(str(flags)))
    t = dataclasses.asdict(tcfg.load_flagfile(str(flags)))
    assert t == j
    assert t["shapes"]["grid_dim"] == j["shapes"]["grid_dim"] < 160
