"""The port's back-end modules against the JAX package on the CPU: NCC
matching (indices and kept masks exactly equal, distances to 2 ulp), the coarse registrations (with the reference's key tree
replayed as the port's draws), the pose-graph solvers, the end-of-run
refinement, the copied host solvers and the bank's packed rows.

Tolerances, stated per test: coarse transforms agree to 1e-3 (the SVDs differ in rounding);
the BEV search within one grid cell and one yaw step (FFT rounding picks
among equal-height peaks); PGO poses to 1e-3 m / 1e-3 in quaternion (2 cm
for CG on a contradictory graph) and wrong-edge flags exactly; the copied numpy solvers exactly; bank rows as
the ICP parity tests hold registrations (codes equal, T within 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulls_tpu.backend import bank as jbank
from mulls_tpu.backend import coarse_reg as jcr
from mulls_tpu.backend import ncc as jncc
from mulls_tpu.backend import pgo as jpgo
from mulls_tpu.backend import refine as jrefine
from mulls_tpu.backend import sparse_pgo as jsparse
from mulls_tpu.config import MullsConfig as JConfig
from mulls_tpu.core import se3 as jse3
from mulls_tpu.core.cloud import VertexDescriptors as JDesc
from mulls_tpu_torch.backend import bank as tbank
from mulls_tpu_torch.backend import coarse_reg as tcr
from mulls_tpu_torch.backend import ncc as tncc
from mulls_tpu_torch.backend import pgo as tpgo
from mulls_tpu_torch.backend import refine as trefine
from mulls_tpu_torch.backend import sparse_pgo as tsparse
from mulls_tpu_torch.config import MullsConfig as TConfig
from mulls_tpu_torch.core.cloud import VertexDescriptors as TDesc
from torch_parity import JaxKeyDraws, cloud_to_torch, np_

from test_backend import _chain_graph, _corr_set, _structured_scene
from test_bank import _synth_submap



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

# --- NCC matching -----------------------------------------------------------


def _desc_pair(seed, n_t=50, n_s=45, cap=64, integer=False):
    """Target and source descriptors; ``integer`` makes every dimension a
    small integer, so the L1 table is full of exact ties (descriptor counts
    tie often), and the intensity column (index 8) constant: the
    reference's fused program rounds its normalization differently from
    the unfused arithmetic (measured: 8.000002 for an exact 8), so ties
    that hinge on that column are broken by rounding there."""
    rng = np.random.default_rng(seed)

    def one(n):
        v = np.zeros((cap, 11), np.float32)
        v[:n] = (rng.integers(0, 4, (n, 11)) if integer
                 else rng.uniform(0, 100, (n, 11)))
        if integer:
            v[:n, 8] = 1.0
        return v, np.arange(cap) < n

    (tv, tm), (sv, sm) = one(n_t), one(n_s)
    return ((JDesc(vec=jnp.asarray(tv), mask=jnp.asarray(tm)),
             JDesc(vec=jnp.asarray(sv), mask=jnp.asarray(sm))),
            (TDesc(vec=torch.from_numpy(tv), mask=torch.from_numpy(tm)),
             TDesc(vec=torch.from_numpy(sv), mask=torch.from_numpy(sm))))


@pytest.mark.parametrize("integer", [False, True], ids=["float", "ties"])
@pytest.mark.parametrize("mode", [
    dict(fixed_num_corr=True, corr_num=200, max_corr_num=3),
    dict(fixed_num_corr=True, corr_num=1000),
    dict(fixed_num_corr=False, reciprocal=False),
    dict(fixed_num_corr=False, reciprocal=True),
], ids=["fixed200cap3", "fixed1000", "nn", "reciprocal"])
def test_match_ncc_matches_reference_exactly(mode, integer):
    (jt, js), (tt, ts) = _desc_pair(7, integer=integer)
    j = jncc.match_ncc(jt, js, **mode)
    t = tncc.match_ncc(tt, ts, **mode)
    np.testing.assert_array_equal(np_(t.t_idx), np.asarray(j.t_idx))
    np.testing.assert_array_equal(np_(t.s_idx), np.asarray(j.s_idx))
    np.testing.assert_array_equal(np_(t.valid), np.asarray(j.valid))
    # XLA fuses the table into a wider program and rounds a few entries
    # differently: distances agree to 2 ulp
    np.testing.assert_allclose(np_(t.dist), np.asarray(j.dist), rtol=5e-7)


# --- coarse registration ------------------------------------------------------


def _corr_case(case):
    rng = np.random.default_rng(11)
    if case == "outliers":
        src, tgt, T, _ = _corr_set(rng, outlier_frac=0.6)
        mask = np.ones(len(src), bool)
    elif case == "partial_mask":
        src, tgt, T, _ = _corr_set(rng, n=300, outlier_frac=0.4)
        tgt = np.asarray(tgt) + np.asarray([15.0, -8.0, 2.0], np.float32)
        mask = np.ones(len(src), bool)
        mask[rng.choice(len(src), 120, replace=False)] = False
    else:  # extreme
        src, tgt, T, _ = _corr_set(rng, n=400, outlier_frac=0.92,
                                   noise=0.02)
        mask = np.ones(len(src), bool)
    return np.asarray(src), np.asarray(tgt), mask


def _assert_same_coarse(t, j, n_tol=0):
    assert bool(t.valid) == bool(j.valid)
    assert abs(int(t.inlier_count) - int(j.inlier_count)) <= n_tol
    np.testing.assert_allclose(np_(t.transform), np.asarray(j.transform),
                               atol=1e-3)


@pytest.mark.parametrize("case", ["outliers", "partial_mask", "extreme"])
def test_clique_consistency_mask_matches_reference(case):
    src, tgt, mask = _corr_case(case)
    kj, nj = jcr.clique_consistency_mask(jnp.asarray(src), jnp.asarray(tgt),
                                         jnp.asarray(mask), eps=0.3)
    kt, nt = tcr.clique_consistency_mask(torch.from_numpy(src),
                                         torch.from_numpy(tgt),
                                         torch.from_numpy(mask), eps=0.3)
    np.testing.assert_array_equal(np_(kt), np.asarray(kj))
    assert int(nt) == int(nj)


@pytest.mark.parametrize("case", ["outliers", "partial_mask", "extreme"])
def test_coarse_reg_gnc_matches_reference(case):
    src, tgt, mask = _corr_case(case)
    nb = 0.15 if case == "extreme" else 0.05
    key = jax.random.key(1)
    j = jcr.coarse_reg_gnc(jnp.asarray(src), jnp.asarray(tgt),
                           jnp.asarray(mask), key, noise_bound=nb)
    t = tcr.coarse_reg_gnc(torch.from_numpy(src), torch.from_numpy(tgt),
                           torch.from_numpy(mask), JaxKeyDraws(key),
                           noise_bound=nb)
    assert bool(j.valid)
    _assert_same_coarse(t, j)


@pytest.mark.parametrize("case", ["outliers", "partial_mask"])
def test_coarse_reg_ransac_matches_reference(case):
    src, tgt, mask = _corr_case(case)
    key = jax.random.key(2)
    j = jcr.coarse_reg_ransac(jnp.asarray(src), jnp.asarray(tgt),
                              jnp.asarray(mask), key, inlier_thre=0.1)
    t = tcr.coarse_reg_ransac(torch.from_numpy(src), torch.from_numpy(tgt),
                              torch.from_numpy(mask), JaxKeyDraws(key),
                              inlier_thre=0.1)
    assert bool(j.valid)
    _assert_same_coarse(t, j)


def test_choice_replays_the_reference_draw():
    """``jax.random.choice(..., replace=True, p=p)`` from the same key gives
    the same indices (no draw lands on a cumulative-sum boundary here)."""
    rng = np.random.default_rng(3)
    p = (rng.uniform(size=300) < 0.4).astype(np.float32)
    p /= p.sum()
    key = jax.random.key(5)
    want = np.asarray(jax.random.choice(key, 300, (512, 3), replace=True,
                                        p=jnp.asarray(p)))
    got = tcr.choice(JaxKeyDraws(key), 300, (512, 3), torch.from_numpy(p))
    np.testing.assert_array_equal(np_(got), want)


@pytest.mark.parametrize("dt,da,thre", [
    (1.0, 0.0, (2.0, 10.0)), (1.0, 0.0, (0.5, 10.0)),
    (0.3, 12.0, (2.0, 10.0)), (4.99, 24.9, (5.0, 25.0)),
])
def test_double_check_tran_matches_reference(dt, da, thre):
    T_pred = np.asarray(jse3.make_transform(
        jnp.asarray([3.0, -1.0, 0.2]), jnp.asarray([0.01, 0.0, 0.5])))
    dT = np.asarray(jse3.make_transform(
        jnp.asarray([dt, 0.0, 0.0]), jnp.asarray([0.0, 0.0, np.radians(da)])))
    T_c = (T_pred @ dT).astype(np.float32)
    j = jcr.double_check_tran(jnp.asarray(T_c), jnp.asarray(T_pred), *thre)
    t = tcr.double_check_tran(torch.from_numpy(T_c),
                              torch.from_numpy(T_pred), *thre)
    assert bool(t) == bool(j)


def test_coarse_reg_bev_matches_reference_within_a_cell():
    rng = np.random.default_rng(8)
    tgt = _structured_scene(rng)
    yaw = np.radians(25.0)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    t = np.array([9.0, -4.0, 0.3], np.float32)
    src = ((tgt - t) @ R).astype(np.float32)
    ones_s, ones_t = np.ones(len(src), bool), np.ones(len(tgt), bool)
    j = jcr.coarse_reg_bev(jnp.asarray(src), jnp.asarray(ones_s),
                           jnp.asarray(tgt), jnp.asarray(ones_t))
    p = tcr.coarse_reg_bev(torch.from_numpy(src), torch.from_numpy(ones_s),
                           torch.from_numpy(tgt), torch.from_numpy(ones_t))
    Tj, Tp = np.asarray(j.transform), np_(p.transform)
    assert bool(p.valid) == bool(j.valid)
    # one grid cell (res 0.5 m) and one yaw step (3 deg)
    assert np.all(np.abs(Tp[:2, 3] - Tj[:2, 3]) <= 0.5 + 1e-6)
    assert abs(Tp[2, 3] - Tj[2, 3]) < 1e-5
    cos = (np.trace(Tp[:3, :3] @ Tj[:3, :3].T) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) <= 3.0 + 1e-3
    assert abs(int(p.inlier_count) - int(j.inlier_count)) <= 1


def test_nanmedian_is_jax_nanmedian():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 9)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.3] = np.nan
    x[4] = np.nan  # a row with no valid entry
    for dim in (0, 1):
        want = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=dim))
        got = np_(tcr.nanmedian(torch.from_numpy(x), dim))
        np.testing.assert_array_equal(got, want)


# --- pose graph ---------------------------------------------------------------


def _graph_to_torch(g) -> tpgo.PoseGraph:
    f = {k: (None if getattr(g, k) is None
             else torch.from_numpy(np.array(getattr(g, k))))
         for k in g._fields}
    f["edge_i"] = f["edge_i"].long()
    f["edge_j"] = f["edge_j"].long()
    return tpgo.PoseGraph(**f)


def _graphs():
    rng = np.random.default_rng(21)
    g, _ = _chain_graph(rng)
    m = g.num_nodes
    bounded = g._replace(t_limit=jnp.full((m,), 0.05, jnp.float32),
                         r_limit=jnp.full((m,), 0.01, jnp.float32))
    # a wrong loop edge that the check must flag
    bad = g._replace(edge_t=g.edge_t.at[-1].add(jnp.asarray([30.0, 0, 0])))
    # rotated nodes and measurements
    q = np.asarray(jse3.quat_from_rotation(jse3.euler_to_rotation(
        jnp.asarray(rng.normal(scale=0.2, size=(m, 3)), jnp.float32))))
    rot = g._replace(node_q=jnp.asarray(q))
    return {"chain": g, "bounded": bounded, "wrong_edge": bad,
            "rotated": rot}


@pytest.mark.parametrize("solver,name", [
    ("dense", "bounded"), ("dense", "rotated"), ("dense_huber", "wrong_edge"),
    ("cg", "chain"), ("cg", "wrong_edge")])
def test_optimize_and_check_matches_reference(solver, name):
    g = _graphs()[name]
    kw = dict(iterations=20, tran_thre=2.0, rot_thre_deg=10.0)
    if solver == "cg":
        g = g._replace(t_limit=None, r_limit=None)
        j = np.asarray(jpgo.optimize_and_check_cg(g, **kw))
        t = np_(tpgo.optimize_and_check_cg(_graph_to_torch(g), **kw))
    else:
        kw["robust_kernel"] = solver == "dense_huber"
        j = np.asarray(jpgo.optimize_and_check(g, **kw))
        t = np_(tpgo.optimize_and_check(_graph_to_torch(g), **kw))
    m = g.num_nodes
    # CG on a graph with a 30 m contradiction stops where float32
    # residuals cross its tolerance, which rounding moves: 2 cm there
    tol = 2e-2 if (solver, name) == ("cg", "wrong_edge") else 1e-3
    np.testing.assert_allclose(t[:3 * m], j[:3 * m], atol=tol)
    np.testing.assert_allclose(t[3 * m:7 * m], j[3 * m:7 * m], atol=tol)
    np.testing.assert_array_equal(t[7 * m + 1:], j[7 * m + 1:])
    if name == "wrong_edge":
        assert t[7 * m + 1:].any()  # the wrong loop edge shows


def test_copied_sparse_solver_matches_reference_at_scale():
    """The g2o selection's numpy solver is a copy: bit-equal on the
    600-node drifted loop of tests/test_backend.py."""
    rng = np.random.default_rng(3)
    m = 600
    ang = np.linspace(0, 2 * np.pi, m)
    gt_t = np.stack([80 * np.cos(ang), 80 * np.sin(ang),
                     np.zeros(m)], -1).astype(np.float32)
    noise = gt_t + np.concatenate(
        [[np.zeros(3)],
         np.cumsum(0.03 * rng.normal(size=(m - 1, 3)), 0)]).astype(np.float32)
    nq = np.zeros((m, 4), np.float32)
    nq[:, 0] = 1.0
    ei = np.asarray(list(range(m - 1)) + [0, 100, 200])
    ej = np.asarray(list(range(1, m)) + [m - 1, 400, 500])
    et = np.stack([noise[i + 1] - noise[i] for i in range(m - 1)] + [
        gt_t[m - 1] - gt_t[0], gt_t[400] - gt_t[100], gt_t[500] - gt_t[200]])
    eq = np.zeros((len(ei), 4), np.float32)
    eq[:, 0] = 1.0
    info = np.broadcast_to(np.eye(6, dtype=np.float32), (len(ei), 6, 6))
    fixed = np.asarray([True] + [False] * (m - 1))
    args = (noise, nq, ei, ej, et, eq, info, fixed)
    j = jsparse.optimize_pose_graph_sparse(*args, iterations=20,
                                           robust_kernel=True)
    t = tsparse.optimize_pose_graph_sparse(*args, iterations=20,
                                           robust_kernel=True)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


# --- end-of-run refinement ----------------------------------------------------


def _trajectories(n=40):
    rng = np.random.default_rng(9)
    gt = np.tile(np.eye(4), (n, 1, 1))
    yaw = np.cumsum(np.full(n, 0.03))
    gt[:, 0, 0] = gt[:, 1, 1] = np.cos(yaw)
    gt[:, 0, 1], gt[:, 1, 0] = -np.sin(yaw), np.sin(yaw)
    gt[:, :3, 3] = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw),
                                       np.zeros(n)], -1), 0)
    odom = gt.copy()
    odom[:, :3, 3] += np.cumsum(0.02 * rng.normal(size=(n, 3)), 0)
    return gt, odom


def test_inner_submap_refine_matches_reference():
    gt, odom = _trajectories()
    poses = odom.copy()
    bounds = [(0, 9), (10, 24), (25, 39)]
    for lo, hi in bounds:  # endpoints corrected to the truth
        poses[lo], poses[hi] = gt[lo], gt[hi]
    kw = dict(iterations=15, t_limit=0.1, r_limit=0.01)
    j = jrefine.inner_submap_refine(poses, odom, bounds, **kw)
    t = trefine.inner_submap_refine(poses, odom, bounds, **kw)
    np.testing.assert_array_equal(t, j)  # the same numpy solver


def test_framewise_pgo_matches_reference():
    gt, odom = _trajectories()
    reg = [(0, 39, np.linalg.inv(gt[0]) @ gt[39], 100.0 * np.eye(6)),
           (5, 30, np.linalg.inv(gt[5]) @ gt[30], 100.0 * np.eye(6))]
    j = jrefine.framewise_pgo(odom, reg, iterations=25)
    t = trefine.framewise_pgo(odom, reg, iterations=25, device="cpu")
    np.testing.assert_allclose(t[:, :3, 3], j[:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(t[:, :3, :3], j[:, :3, :3], atol=1e-4)


# --- the bank's packed rows -----------------------------------------------------


def _banks(T_true):
    a_cl, a_d = _synth_submap(7)
    b_cl, b_d = _synth_submap(7, T=np.linalg.inv(T_true))
    jb = jbank.init_bank(a_cl, a_d, capacity=4)
    jb = jbank.bank_store(jb, jnp.int32(0), a_cl, a_d)
    jb = jbank.bank_store(jb, jnp.int32(1), b_cl, b_d)

    def desc(d):
        return TDesc(vec=torch.from_numpy(np.array(d.vec)),
                     mask=torch.from_numpy(np.array(d.mask)))

    ta = {k: cloud_to_torch(c) for k, c in a_cl.items()}
    tb = {k: cloud_to_torch(c) for k, c in b_cl.items()}
    bank = tbank.init_bank(ta, desc(a_d), capacity=4)
    tbank.bank_store(bank, 0, ta, desc(a_d))
    tbank.bank_store(bank, 1, tb, desc(b_d))
    return jb, bank


def _assert_same_rows(t, j):
    """Codes and iterations equal; T within 1e-4; sigma, confidence and
    information within float rounding of the two ICPs."""
    t, j = np.atleast_2d(t), np.atleast_2d(j)
    np.testing.assert_array_equal(t[:, 13], j[:, 13])  # codes
    np.testing.assert_array_equal(t[:, 15], j[:, 15])  # iterations
    np.testing.assert_allclose(t[:, :12], j[:, :12], atol=1e-4)
    np.testing.assert_allclose(t[:, 12], j[:, 12], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(t[:, 14], j[:, 14], atol=1e-6)
    np.testing.assert_allclose(t[:, 16:52], j[:, 16:52], rtol=2e-3,
                               atol=1e-2 * np.abs(j[:, 16:52]).max())
    if t.shape[1] > tbank.REG_ROW:
        np.testing.assert_array_equal(t[:, 52:54], j[:, 52:54])  # flags
        np.testing.assert_allclose(t[:, 54:], j[:, 54:], atol=1e-3)


def test_pair_m2m_row_matches_reference():
    T_true = np.eye(4)
    T_true[:3, 3] = [0.4, -0.25, 0.05]
    jb, bank = _banks(T_true)
    jcfg, tcfg = JConfig(), TConfig()
    j = np.asarray(jbank.pair_m2m(jb, jnp.int32(0), jnp.int32(1),
                                  jnp.eye(4, dtype=jnp.float32), jcfg,
                                  jcfg.reg.reg_max_iter_num_m2m))
    t = np_(tbank.pair_m2m(bank, 0, 1, torch.eye(4), tcfg,
                           tcfg.reg.reg_max_iter_num_m2m))
    _assert_same_rows(t, j)
    np.testing.assert_allclose(tbank.unpack_reg(t)["T"][:3, 3],
                               T_true[:3, 3], atol=0.05)
    np.testing.assert_allclose(np_(tbank.local_bounds(
        tbank.slot(bank.clouds, 0))), np.asarray(jbank.local_bounds(
            jbank._slot(jb.clouds, 0))), atol=1e-6)


def test_loop_eval_batch_rows_match_reference():
    """Candidate 0 with the coarse stage (NCC + GNC recover a 3.4 m offset
    the odometry guess is blind to), candidate 1 from the guess only; the
    reference's key tree replayed."""
    T_true = np.eye(4)
    T_true[:3, 3] = [3.0, 1.5, 0.0]
    jb, bank = _banks(T_true)
    jcfg, tcfg = JConfig(), TConfig()
    key = jax.random.key(0)
    Tg = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    cm = np.full((2, 2), 3.0, np.float32)
    j = np.asarray(jbank.loop_eval_batch(
        jb, jnp.asarray([0, 0], jnp.int32), jnp.int32(1), jnp.asarray(Tg),
        jnp.asarray([True, False]), jnp.asarray(cm), key, jcfg))
    t = np_(tbank.loop_eval_batch(bank, [0, 0], 1, torch.from_numpy(Tg),
                                  [True, False], torch.from_numpy(cm),
                                  JaxKeyDraws(key), tcfg))
    assert t.shape == (2, tbank.LOOP_ROW)
    d0 = tbank.unpack_loop(t[0])
    assert d0["coarse_used"] and d0["code"] == 1
    _assert_same_rows(t, j)
