"""The port's batched sequence axis: S = 3 sequences stepped as one
``[S, ...]`` batch against three calls of the same functions without a
batch, bit for bit — the plain kernels, ``extract_features``,
``mm_lls_icp``, ``update_local_map``, the whole step through
``MultiSeqPipeline`` against ``OdometryPipeline`` alone — and the pieces
that make it so: the stacked draws and the host frame counter.

Each sequence has its own seeded inputs (numpy) and its own draws; the
width is the parity tests' (``__graft_entry__._small_cfg()``).  One torch
thread, as tests/test_torch_multiseq.py pins."""

import dataclasses

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from mulls_tpu_torch.core.batch import fsum, matmul, matvec
from mulls_tpu_torch.core.cloud import FeatureCloud, pack_raw_host
from mulls_tpu_torch.core.draws import GeneratorDraws, StackedDraws
from mulls_tpu_torch.core.tree import tree_map
from mulls_tpu_torch.frontend.features import extract_features
from mulls_tpu_torch.frontend.icp import mm_lls_icp
from mulls_tpu_torch.mapping.local_map import (init_local_map,
                                               update_local_map)
from mulls_tpu_torch.ops import kernels
from mulls_tpu_torch.parallel.mesh import make_mesh
from mulls_tpu_torch.parallel.multiseq import (MultiSeqPipeline,
                                               put_sharded, stack_states)
from mulls_tpu_torch.pipeline import odometry
from mulls_tpu_torch.pipeline.odometry import (OdometryPipeline, init_state,
                                               slam_step)
from test_pipeline import _ListDataset, _loop_world, _simulate_scan
from torch_parity import JaxKeyDraws, raw_to_torch

S = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _equal(batched, alone, s):
    """Every leaf of entry ``s`` of a batched tree equals the tree alone,
    bit for bit."""
    got = []
    tree_map(lambda b, a: got.append(torch.equal(b[s], a)), batched, alone)
    assert got and all(got), (s, got)


# --- the kernels' plain versions and the order-fixed arithmetic -------------

def _clouds(seed, qn, pn):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.uniform(-6, 6, (S, qn, 3)).astype(np.float32))
    p = torch.from_numpy(rng.uniform(-6, 6, (S, pn, 3)).astype(np.float32))
    qm = torch.from_numpy(rng.uniform(size=(S, qn)) < 0.9)
    pm = torch.from_numpy(rng.uniform(size=(S, pn)) < 0.8)
    r2 = torch.from_numpy(rng.uniform(0.5, 4.0, (S, qn)).astype(np.float32))
    f = torch.from_numpy(rng.uniform(-1, 1, (S, pn, 5)).astype(np.float32))
    return q, qm, p, pm, r2, f


def test_batched_plain_kernels_equal_their_calls_alone():
    q, qm, p, pm, r2, f = _clouds(3, 300, 700)
    kernels.reset_launch_counts()
    nn_b = kernels.nn_grouped([(q, qm, p, pm), (p, pm, q, qm)])
    one = kernels.nn(q, qm, p, pm)
    mom = kernels.moments(q, p, pm, r2, f, 0.5 * r2)
    f1 = f[..., :1].contiguous()
    mom1 = kernels.moments(q, p, pm, r2, f1)
    pca = kernels.pca_moments(q, p, pm, r2)
    for s in range(S):
        alone = kernels.nn_grouped([(q[s], qm[s], p[s], pm[s]),
                                    (p[s], pm[s], q[s], qm[s])])
        _equal(nn_b, alone, s)
        _equal(one, kernels.nn(q[s], qm[s], p[s], pm[s]), s)
        _equal(mom, kernels.moments(q[s], p[s], pm[s], r2[s], f[s],
                                    0.5 * r2[s]), s)
        _equal(mom1[0], kernels.moments(q[s], p[s], pm[s], r2[s],
                                        f1[s])[0], s)
        _equal(pca, kernels.pca_moments(q[s], p[s], pm[s], r2[s]), s)
    assert mom1[1] is None
    # the plain versions launch nothing
    assert all(v == 0 for v in kernels.launch_counts().values())


def test_batched_wrappers_check_every_entry_shape():
    q, qm, p, pm, r2, f = _clouds(4, 20, 30)
    with pytest.raises(ValueError, match="shape"):
        kernels.nn(q, qm[:2], p, pm)
    with pytest.raises(ValueError, match="shape"):
        kernels.moments(q, p, pm, r2[:, :5], f)
    with pytest.raises(ValueError, match="shape"):
        kernels.pca_moments(q, p[:2], pm, r2)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1200, 20480])
def test_order_fixed_sums_and_products_ignore_the_batch(n):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(size=(S, n, 3)).astype(np.float32))
    A = torch.from_numpy(rng.normal(size=(S, 6, 6)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(S, 6)).astype(np.float32))
    out = (fsum(x, -2), fsum(x[..., 0], -1), matmul(A, A.flip(0)),
           matvec(A, v))
    for s in range(S):
        alone = (fsum(x[s], -2), fsum(x[s, :, 0], -1),
                 matmul(A[s], A.flip(0)[s]), matvec(A[s], v[s]))
        _equal(out, alone, s)
    np.testing.assert_allclose(fsum(x, -2).numpy(), x.sum(-2).numpy(),
                               rtol=1e-5, atol=1e-4)


# --- the stacked draws -------------------------------------------------------

def test_stacked_draws_give_each_sequence_its_own_stream():
    seeds = (5, 6, 7)
    stacked = StackedDraws([GeneratorDraws(s, "cpu") for s in seeds])
    alone = [GeneratorDraws(s, "cpu") for s in seeds]
    k_b = stacked.split(3)[1]
    u = k_b.uniform((S, 4, 2))
    b = k_b.bits((S, 9))
    for s in range(S):
        k = alone[s].split(3)[1]
        assert torch.equal(u[s], k.uniform((4, 2)))
        assert torch.equal(b[s], k.bits((9,)))
    with pytest.raises(ValueError, match=r"\[3, \.\.\.\]"):
        stacked.uniform((4, 2))
    state = stacked.get_state()
    first = stacked.uniform((S, 3))
    stacked.set_state(state)
    assert torch.equal(stacked.uniform((S, 3)), first)


def test_stacked_draws_replay_each_sequences_jax_key():
    import jax
    keys = [jax.random.key(30 + s) for s in range(S)]
    stacked = StackedDraws([JaxKeyDraws(k) for k in keys])
    kids = stacked.split(16)
    u = kids[4].uniform((S, 100))
    b = kids[7].bits((S, 1, 12))
    for s in range(S):
        alone = JaxKeyDraws(keys[s]).split(16)
        assert torch.equal(u[s], alone[4].uniform((100,)))
        assert torch.equal(b[s], alone[7].bits((1, 12)))


# --- the front end's functions -----------------------------------------------

@pytest.fixture(scope="module")
def frames():
    """Three seeded scans through ``extract_features``, batched and alone,
    each with its own generator."""
    cfg = ge._small_cfg()
    raws = [raw_to_torch(ge._synthetic_raw(cfg, seed=20 + s))
            for s in range(S)]
    batched = extract_features(_stack(raws), cfg, StackedDraws(
        [GeneratorDraws(40 + s, "cpu") for s in range(S)]))
    alone = [extract_features(raws[s], cfg, GeneratorDraws(40 + s, "cpu"))
             for s in range(S)]
    return cfg, batched, alone


def test_batched_extract_features_equals_each_frame_alone(frames):
    _, batched, alone = frames
    for s in range(S):
        _equal(batched, alone[s], s)
    # the frames differ, so the check is not of three copies
    assert not torch.equal(batched.full["facade"].xyz[0],
                           batched.full["facade"].xyz[1])


def test_batched_update_local_map_equals_each_map_alone(frames):
    cfg, batched, alone = frames
    rng = np.random.default_rng(8)
    T = torch.from_numpy(np.stack([
        _pose(rng.normal(0, 0.3, 3), rng.normal(0, 0.02, 3))
        for _ in range(S)]))
    dyn = torch.tensor([0.3, 0.9, 1.6])
    ok = torch.tensor([True, False, True])
    m_b = _stack([init_local_map(cfg.map, "cpu")] * S)
    maps = [init_local_map(cfg.map, "cpu") for _ in range(S)]
    d_b = StackedDraws([GeneratorDraws(60 + s, "cpu") for s in range(S)])
    d_a = [GeneratorDraws(60 + s, "cpu") for s in range(S)]
    for step in range(2):
        Ts = T if step else torch.eye(4).expand(S, 4, 4)
        m_b = update_local_map(m_b, batched, Ts, dyn, cfg.map, d_b,
                               removal_enabled=ok)
        maps = [update_local_map(maps[s], alone[s], Ts[s], dyn[s], cfg.map,
                                 d_a[s], removal_enabled=ok[s])
                for s in range(S)]
    for s in range(S):
        _equal(m_b, maps[s], s)
    refreshed = odometry.refresh_linear_map_vectors(m_b)
    for s in range(S):
        _equal(refreshed, odometry.refresh_linear_map_vectors(maps[s]), s)


def _pose(t, e):
    from mulls_tpu_torch.core import se3
    return se3.make_transform(torch.tensor(t, dtype=torch.float32),
                              torch.tensor(e, dtype=torch.float32)).numpy()


def test_batched_mm_lls_icp_equals_each_registration_alone(frames):
    """Each frame's down clouds against its own full clouds, moved by a
    pose of its own; the third with four points a class (code -2), so the
    entries of one batch stop at different iterations."""
    cfg, batched, alone = frames
    rng = np.random.default_rng(9)
    guesses = torch.from_numpy(np.stack([
        _pose(rng.normal(0, 0.4, 3), rng.normal(0, 0.03, 3))
        for _ in range(S)]))
    src_b = {}
    for name, c in batched.down.items():
        cut = torch.arange(c.capacity) < 4
        src_b[name] = c.replace(mask=torch.stack(
            [c.mask[0], c.mask[1], c.mask[2] & cut]))
    add = torch.tensor([0.0, 0.5, 1.0])
    res_b = mm_lls_icp(src_b, batched.full, cfg.reg, guesses, max_iter=12,
                       dis_thre_add=add)
    codes = []
    for s in range(S):
        src = {n: FeatureCloud(*[getattr(c, k)[s] for k in (
            "xyz", "normal", "intensity", "strength", "height", "ts_ratio",
            "mask")]) for n, c in src_b.items()}
        r = mm_lls_icp(src, alone[s].full, cfg.reg, guesses[s], max_iter=12,
                       dis_thre_add=add[s])
        _equal(res_b, r, s)
        codes.append(int(r.process_code))
    assert len(set(int(i) for i in res_b.iterations)) > 1, res_b.iterations
    assert codes[2] == -2


# --- the step ------------------------------------------------------------------

def _sequences(cfg, lengths):
    rng = np.random.default_rng(77)
    world = _loop_world(rng, n=60000, extent=40.0)
    out = []
    for s, n in enumerate(lengths):
        ang = 2 * np.pi * s / len(lengths) + 0.3
        d = np.array([np.cos(ang), np.sin(ang), 0.0])
        gt = []
        for k in range(n):
            T = np.eye(4)
            T[:3, 3] = 0.6 * k * d
            gt.append(T)
        out.append(_ListDataset(
            _simulate_scan(world, g, cfg.shapes.n_raw, 30.0, rng)
            for g in gt))
    return out


def test_multiseq_batch_equals_each_sequence_alone():
    """Three sequences (one a frame shorter) on a one-entry mesh: one
    batch of three, a warm segment and a steady one; each sequence equals
    ``OdometryPipeline`` alone, bit for bit."""
    cfg = ge._small_cfg()
    seqs = _sequences(cfg, (4, 3, 4))
    pipe = MultiSeqPipeline(cfg, make_mesh(1, device="cpu"), segment=3)
    res = pipe.run(seqs)
    assert [len(r.poses) for r in res] == [4, 3, 4]
    for s in range(S):
        alone = OdometryPipeline(pipe.cfg.replace(seed=cfg.seed + s),
                                 segment=3, device="cpu").run(seqs[s])
        assert alone.codes == res[s].codes
        np.testing.assert_array_equal(alone.poses, res[s].poses)
        assert alone.sigmas == res[s].sigmas
    assert len(pipe.block_launches) == 1
    assert len(pipe.launches) == S and pipe.launches[0] is pipe.launches[2]


def test_stack_states_and_put_sharded():
    cfg = ge._small_cfg()
    states = [init_state(cfg.replace(seed=s), "cpu") for s in range(4)]
    stacked = stack_states(states)
    assert isinstance(stacked.draws, StackedDraws)
    assert stacked.pose.shape == (4, 4, 4)
    assert stacked.local_map.clouds["facade"].xyz.shape[0] == 4
    blocks = put_sharded(stacked.replace(draws=None),
                         make_mesh(2, device="cpu"), 4)
    assert len(blocks) == 2
    for b, (lo, hi) in enumerate(((0, 2), (2, 4))):
        assert torch.equal(blocks[b].local_map.clouds["ground"].mask,
                           stacked.local_map.clouds["ground"].mask[lo:hi])
        assert blocks[b].draws is None


def test_batched_step_branches_on_the_host_frame_counter(monkeypatch):
    """The warm-up s2s and the map refresh follow ``frame=``, not the
    state's ``frame_idx`` (which is set to disagree with it)."""
    cfg = ge._small_cfg()
    cfg = cfg.replace(map=dataclasses.replace(
        cfg.map, inframe_recovery_on=False, dynamic_sanity_veto_on=False,
        local_map_recalculation_frequency=30))
    seqs = _sequences(cfg, (1, 1, 1))
    raw = _stack([pack_raw_host(seqs[s][0]) for s in range(S)])
    icp_calls, refreshes = [], []
    monkeypatch.setattr(odometry, "mm_lls_icp", lambda *a, **k: (
        icp_calls.append(1), mm_lls_icp(*a, **k))[1])
    monkeypatch.setattr(odometry, "refresh_linear_map_vectors",
                        lambda m: (refreshes.append(1), m)[1])

    def step(frame_idx, frame):
        state = stack_states([init_state(cfg.replace(seed=s), "cpu")
                              for s in range(S)])
        state = state.replace(frame_idx=torch.full((S,), frame_idx,
                                                   dtype=torch.int32))
        icp_calls.clear()
        refreshes.clear()
        slam_step(state, raw, cfg, frame=frame)
        return len(icp_calls), len(refreshes)

    # the tensor says steady (5), the host says warm-up (0): s2s + s2m
    assert step(5, 0) == (2, 0)
    # the tensor says warm-up (0), the host says steady (5): s2m only
    assert step(0, 5) == (1, 0)
    # the refresh after the 30th frame: the host's 29, not the tensor's 0
    assert step(0, 29) == (1, 1)
    assert step(29, 0) == (2, 0)


def test_batched_options_off_the_main_path_equal_each_call_alone():
    """The options the default config leaves off, batched against alone:
    the voxel pre-filter, the ROI band, distance-adaptive PCA, PCA ground
    normals and the non-ground rate per sequence in ``extract_features``;
    normal-shooting correspondences in ``mm_lls_icp``; motion
    compensation's azimuth ratio and undistortion."""
    from mulls_tpu_torch.ops import motion
    cfg = ge._small_cfg()
    cfg = cfg.replace(
        preprocess=dataclasses.replace(cfg.preprocess, cloud_down_res=0.1,
                                       apply_roi_filter=True),
        feature=dataclasses.replace(cfg.feature,
                                    use_distance_adaptive_pca=True),
        ground=dataclasses.replace(cfg.ground, ground_normal_method=1),
        reg=dataclasses.replace(cfg.reg, normal_shooting_on=True))
    raws = [raw_to_torch(ge._synthetic_raw(cfg, seed=50 + s))
            for s in range(S)]
    rate = torch.tensor([1.0, 1.5, 2.0])
    batched = extract_features(_stack(raws), cfg, StackedDraws(
        [GeneratorDraws(70 + s, "cpu") for s in range(S)]),
        nonground_rate=rate)
    alone = [extract_features(raws[s], cfg, GeneratorDraws(70 + s, "cpu"),
                              nonground_rate=rate[s]) for s in range(S)]
    rng = np.random.default_rng(10)
    T = torch.from_numpy(np.stack([
        _pose(rng.normal(0, 0.3, 3), rng.normal(0, 0.02, 3))
        for _ in range(S)]))
    res_b = mm_lls_icp(batched.down, batched.full, cfg.reg, T, max_iter=6)
    xyz_b = _stack([r.xyz for r in raws])
    mask_b = _stack([r.mask for r in raws])
    ts_b = motion.timestamp_ratio_from_azimuth(xyz_b, mask_b)
    und_b = motion.undistort(xyz_b, ts_b, mask_b, T, min_range=2.0)
    for s in range(S):
        _equal(batched, alone[s], s)
        _equal(res_b, mm_lls_icp(alone[s].down, alone[s].full, cfg.reg, T[s],
                                 max_iter=6), s)
        ts = motion.timestamp_ratio_from_azimuth(raws[s].xyz, raws[s].mask)
        _equal((ts_b, und_b), (ts, motion.undistort(
            raws[s].xyz, ts, raws[s].mask, T[s], min_range=2.0)), s)


def test_batch_bits_tool_on_the_cpu():
    """``tools/batch_bits.py`` on the CPU at small sizes: every operation
    the batched step relies on gives each entry its call's bits."""
    from mulls_tpu_torch.tools import batch_bits
    res = batch_bits.check(torch.device("cpu"), points=(1200, 33),
                           batches=(2, 3))
    relied_on = ("fsum", "norm", "stable sort", "argmin",
                 "by fsum of products", "core.batch", "linalg")
    used = {k: v for k, v in res.items()
            if any(w in k for w in relied_on)}
    assert len(used) == 2 * 8 + 2 * 6
    assert all(used.values()), [k for k, v in used.items() if not v]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batch_bits.main(["--device", "cuda"])
