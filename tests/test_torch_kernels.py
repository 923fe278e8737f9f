"""Parity of the port's kernel module (mulls_tpu_torch/ops/kernels.py).

On the CPU every wrapper takes its plain PyTorch version; those are held
against the Pallas originals run with ``interpret=True`` and against the
reference's plain-XLA path, at the shapes and tolerances of
tests/test_kernels.py.  The CUDA kernels themselves run only on a card:
tests/test_torch_cuda.py holds them against these plain versions there,
and chip_smoke.py does so at the main path's shapes."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulls_tpu.ops import neighbors
from mulls_tpu.ops.kernels import moments_pallas, nn_pallas, pca_moments_pallas
from mulls_tpu_torch.ops import kernels
from mulls_tpu_torch.ops.neighbors import cov_from_moments

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clouds(seed, qn=300, pn=2500):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-40, 40, (qn, 3)).astype(np.float32)
    p = rng.uniform(-40, 40, (pn, 3)).astype(np.float32)
    qm = rng.uniform(size=qn) < 0.9
    pm = rng.uniform(size=pn) < 0.9
    return q, qm, p, pm


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_nn_plain_matches_pallas_and_xla():
    q, qm, p, pm = _clouds(0)
    idx, d2 = kernels.nn(*_t(q, qm, p, pm))
    idx, d2 = idx.numpy(), d2.numpy()
    for ref_idx, ref_d2 in (nn_pallas(q, qm, p, pm, interpret=True),
                            neighbors.nearest_neighbor(q, qm, p, pm)):
        ref_idx, ref_d2 = np.asarray(ref_idx), np.asarray(ref_d2)
        # tolerance of tests/test_kernels.py: the reference expands
        # |q|^2 + |p|^2 - 2 q.p (fp32 rounding ~1e-3 m^2 at 40 m)
        np.testing.assert_allclose(d2[qm], ref_d2[qm], rtol=1e-4, atol=1e-3)
        d_port = np.sum((q - p[idx]) ** 2, -1)
        d_ref = np.sum((q - p[ref_idx]) ** 2, -1)
        np.testing.assert_allclose(d_port[qm], d_ref[qm], rtol=1e-4,
                                   atol=1e-3)
        assert np.all(d2[~qm] > 1e30) and np.all(ref_d2[~qm] > 1e30)
    assert idx.dtype == np.int32


def test_nn_all_support_invalid():
    q, qm, p, _ = _clouds(1, qn=64, pn=128)
    pm = np.zeros(128, bool)
    idx, d2 = kernels.nn(*_t(q, qm, p, pm))
    ref_idx, ref_d2 = nn_pallas(q, qm, p, pm, interpret=True)
    assert np.all(d2.numpy() > 1e30) and np.all(np.asarray(ref_d2) > 1e30)
    # no valid support: index 0, like the reference's argmin over +BIG
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


def test_moments_plain_matches_pallas_and_xla():
    q, qm, p, pm = _clouds(2, qn=257, pn=2100)
    feats = np.random.default_rng(3).uniform(0, 1, (2100, 5)).astype(
        np.float32)
    r = 3.0
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    stack = np.concatenate([np.stack([np.ones_like(x), x, y, z, x * x, x * y,
                                      x * z, y * y, y * z, z * z], 1),
                            feats], 1).astype(np.float32)
    r2 = np.full((q.shape[0],), r * r, np.float32)
    sums, csums = kernels.moments(*_t(q, p, pm, r2, stack, 0.64 * r2))
    qmf = qm.astype(np.float32)[:, None]
    sums, csums = sums.numpy() * qmf, csums.numpy() * qmf
    ps, pc = moments_pallas(q, p, pm, r2, stack, 0.64 * r2, interpret=True)
    ref = neighbors.radius_moments(q, qm, p, pm, r, p_feats=feats,
                                   close_fraction_sq=0.64)
    # tolerances of tests/test_kernels.py
    for s, c in ((np.asarray(ps) * qmf, np.asarray(pc) * qmf),
                 (np.concatenate([np.asarray(ref["count"])[:, None],
                                  np.asarray(ref["sum_xyz"]),
                                  np.asarray(ref["sum_outer"]),
                                  np.asarray(ref["feat_sum"])], 1),
                  np.concatenate([np.asarray(ref["close_count"])[:, None],
                                  np.zeros((257, 9), np.float32),
                                  np.asarray(ref["close_feat_sum"])], 1))):
        np.testing.assert_allclose(sums[:, 0], s[:, 0], rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(sums[:, 1:4], s[:, 1:4], rtol=1e-3,
                                   atol=1e-2)
        np.testing.assert_allclose(sums[:, 4:10], s[:, 4:10], rtol=1e-3,
                                   atol=0.5)
        np.testing.assert_allclose(sums[:, 10:], s[:, 10:], rtol=1e-3,
                                   atol=1e-2)
        np.testing.assert_allclose(csums[:, 0], c[:, 0], rtol=1e-5,
                                   atol=1e-3)
        np.testing.assert_allclose(csums[:, 10:], c[:, 10:], rtol=1e-3,
                                   atol=1e-2)


def test_knn_class_counts_matches_xla():
    """The NCC descriptor's two moments passes, against the reference."""
    from mulls_tpu_torch.ops import neighbors as tnbr
    rng = np.random.default_rng(9)
    q, qm, p, pm = _clouds(9, qn=200, pn=3000)
    q, p = q / 8.0, p / 8.0  # ~10 neighbors in a 1 m radius
    onehot = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 3000)][:, 1:]
    inten = rng.integers(0, 255, 3000).astype(np.float32)
    r = rng.uniform(0.8, 1.2, 200).astype(np.float32)
    out = tnbr.knn_class_counts(*_t(q, qm, p, pm, r), k=6,
                                class_onehot=torch.from_numpy(onehot),
                                p_intensity=torch.from_numpy(inten),
                                close_r2=0.64)
    ref = neighbors.knn_class_counts(q, qm, p, pm, r, k=6,
                                     class_onehot=onehot, p_intensity=inten,
                                     close_r2=0.64)
    # the reference forms distances through a bf16 hi/lo matmul, the port
    # exactly in fp32: a support point within ~1e-5 m^2 of a radius may
    # fall on the other side, so counts agree on at least 97 % of queries
    # and exactly wherever the neighborhoods are the same
    same = np.ones(200, bool)
    for key in ("count", "close_counts", "far_counts"):
        a, b = out[key].numpy(), np.asarray(ref[key])
        same &= np.all((a == b).reshape(200, -1), axis=1)
    assert same.mean() >= 0.97
    assert np.asarray(ref["count"])[qm].max() > 3
    np.testing.assert_allclose(out["int_sum"].numpy()[same],
                               np.asarray(ref["int_sum"])[same], rtol=1e-6)


def test_moments_without_close_and_width_limits():
    q, qm, p, pm = _clouds(4, qn=100, pn=600)
    r2 = np.full((100,), 16.0, np.float32)
    ones = np.ones((600, 1), np.float32)
    sums, csums = kernels.moments(*_t(q, p, pm, r2, ones))
    assert csums is None and sums.shape == (100, 1)
    with pytest.raises(ValueError):
        kernels.moments(*_t(q, p, pm, r2, np.ones((600, 17), np.float32)))


def test_pca_moments_plain_matches_pallas_and_xla():
    import mulls_tpu.ops.pca as jpca
    q, qm, p, pm = _clouds(5, qn=300, pn=2500)
    qo = np.asarray(jpca.morton_order(jnp.asarray(q)))
    q, qm = q[qo], qm[qo]
    r = 3.0
    r2 = np.full((300,), r * r, np.float32)
    cnt, sx, so = kernels.pca_moments(*_t(q, p, pm, r2))
    cov = cov_from_moments(cnt, sx, so).numpy()
    pcnt, psx, pso = pca_moments_pallas(q, p, pm, r2, interpret=True)
    cov_pallas = np.asarray(neighbors.cov_from_moments(pcnt, psx, pso))
    ref = neighbors.radius_moments(q, qm, p, pm, r)
    cov_xla = np.asarray(neighbors.cov_from_moments(
        ref["count"], ref["sum_xyz"], ref["sum_outer"]))
    m = qm & (np.asarray(ref["count"]) > 3)
    # tolerances of tests/test_kernels.py (the reference's bf16 hi/lo and
    # uncentred f32 paths are the looser side)
    np.testing.assert_allclose(cnt.numpy()[qm], np.asarray(pcnt)[qm],
                               atol=0.5)
    np.testing.assert_allclose(cnt.numpy()[qm],
                               np.asarray(ref["count"])[qm], atol=0.5)
    np.testing.assert_allclose(cov[m], cov_pallas[m], atol=2e-2)
    np.testing.assert_allclose(cov[m], cov_xla[m], atol=2e-2)


def test_pca_moments_centred_keeps_plane_thickness_far_out():
    """Query-centred sums keep the smallest eigenvalue of a thin plane 100 m
    out (the lesson of mulls_tpu/ops/kernels.py:279-286)."""
    rng = np.random.default_rng(6)
    n = 4000
    p = np.stack([100.0 + rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
                  0.002 * rng.normal(size=n)], 1).astype(np.float32)
    q = p[:200].copy()
    cnt, sx, so = kernels.pca_moments(*_t(q, p, np.ones(n, bool),
                                          np.full(200, 1.0, np.float32)))
    cov = cov_from_moments(cnt, sx, so).numpy().astype(np.float64)
    lam3 = np.linalg.eigvalsh(cov)[:, 0]
    # true lambda_3 is 4e-6 m^2: an error of ~1e-5 would swamp it
    assert np.all(np.abs(lam3 - 4e-6) < 2e-6)


def test_pca_chunk_fills_the_card_and_stays_whole():
    """The chunk of csrc/pca_moments.cu: the largest for the frame's PCA,
    halved for the map refresh's small shapes until the grid covers the
    H100's 132 SMs or the chunk reaches its floor; always whole votes."""
    assert kernels.pca_chunk(10240, 20480) == kernels.PCA_CHUNK
    assert kernels.pca_chunk(1536, 1536) == 128  # 12 x 12 = 144 blocks
    assert kernels.pca_chunk(1024, 1024) == kernels.PCA_MIN_CHUNK
    for qn in (0, 1, 127, 129, 700, 1536, 4096, 10240, 20480):
        for pn in (0, 1, 255, 1025, 5000, 20480):
            chunk = kernels.pca_chunk(qn, pn)
            assert kernels.PCA_MIN_CHUNK <= chunk <= kernels.PCA_CHUNK
            assert chunk % 16 == 0  # 4 points a lane per vote, 4 lanes
            tiles = -(-qn // kernels.PCA_TILE_Q)
            assert chunk == kernels.PCA_MIN_CHUNK or \
                tiles * -(-pn // chunk) >= 132
            if chunk < kernels.PCA_CHUNK:  # halved only while too few
                assert tiles * -(-pn // (2 * chunk)) < 132


def test_wrappers_take_plain_path_on_cpu_and_count_nothing():
    q, qm, p, pm = _t(*_clouds(7, qn=50, pn=300))
    kernels.reset_launch_counts()
    a = kernels.nn(q, qm, p, pm)
    b = kernels.nn_plain(q, qm, p, pm)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    (c,) = kernels.nn_grouped([(q, qm, p, pm)])
    assert torch.equal(c[0], b[0]) and torch.equal(c[1], b[1])
    r2 = torch.full((50,), 9.0)
    assert torch.equal(kernels.pca_moments(q, p, pm, r2)[0],
                       kernels.pca_moments_plain(q, p, pm, r2)[0])
    assert torch.equal(kernels.count_within(q, p, pm, r2),
                       kernels.count_within_plain(q, p, pm, r2))
    assert kernels.launch_counts() == {"nn": 0, "nn_grouped": 0,
                                       "moments": 0, "pca_moments": 0,
                                       "count_within": 0}


def _nn_group(seed):
    """numpy problems of one nn group: an ordinary one, an empty member,
    one without valid support, Q = 1, P = 1, and support whose second half
    repeats its first (every nearest point is tied with a copy)."""
    rng = np.random.default_rng(seed)

    def problem(qn, pn, p_valid=0.9):
        q = rng.uniform(-40, 40, (qn, 3)).astype(np.float32)
        p = rng.uniform(-40, 40, (pn, 3)).astype(np.float32)
        return (q, rng.uniform(size=qn) < 0.9, p,
                rng.uniform(size=pn) < p_valid)

    q, qm, p, _ = problem(80, 400)
    dup = (q, qm, np.concatenate([p, p]), np.ones(800, bool))
    return [problem(300, 2500), problem(0, 50), problem(40, 60, p_valid=0.0),
            problem(1, 100), problem(30, 1, p_valid=1.0), dup]


def _nn_numpy(q, qm, p, pm):
    """Independent 1-NN in numpy float32, the distance formed as the port
    forms it; np.argmin keeps the first (lowest) index of a tie."""
    d = q[:, None, :] - p[None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    d2 = np.where(pm[None, :], d2, np.float32(3.0e38))
    idx = np.argmin(d2, axis=1).astype(np.int32)
    best = np.take_along_axis(d2, idx[:, None].astype(np.int64), 1)[:, 0]
    return idx, np.where(qm, best, np.float32(3.0e38))


def test_nn_grouped_plain_matches_nn_plain_pallas_and_xla():
    probs = _nn_group(10)
    out = kernels.nn_grouped([_t(*pr) for pr in probs])
    assert len(out) == len(probs)
    for k, ((q, qm, p, pm), (idx, d2)) in enumerate(zip(probs, out)):
        # the group is nn_plain per problem, and equals an independent
        # numpy scan bit for bit (same distance form, first index of a tie)
        ridx, rd2 = kernels.nn_plain(*_t(q, qm, p, pm))
        assert torch.equal(idx, ridx) and torch.equal(d2, rd2), k
        assert idx.dtype == torch.int32 and d2.dtype == torch.float32
        nidx, nd2 = _nn_numpy(q, qm, p, pm)
        np.testing.assert_array_equal(idx.numpy(), nidx)
        np.testing.assert_array_equal(d2.numpy(), nd2)
        if len(q) == 0:
            assert idx.shape == (0,) and d2.shape == (0,)
            continue
        idx, d2 = idx.numpy(), d2.numpy()
        if not pm.any():
            # no valid support: the sentinel, and index 0 as the Pallas
            # kernel's argmin over +BIG gives
            pidx, pd2 = nn_pallas(q, qm, p, pm, interpret=True)
            assert np.all(d2 > 1e30) and np.all(np.asarray(pd2) > 1e30)
            np.testing.assert_array_equal(idx, np.asarray(pidx))
            continue
        for ref_idx, ref_d2 in (nn_pallas(q, qm, p, pm, interpret=True),
                                neighbors.nearest_neighbor(q, qm, p, pm)):
            ref_idx, ref_d2 = np.asarray(ref_idx), np.asarray(ref_d2)
            # tolerance of tests/test_kernels.py: the reference expands
            # |q|^2 + |p|^2 - 2 q.p (fp32 rounding ~1e-3 m^2 at 40 m)
            np.testing.assert_allclose(d2[qm], ref_d2[qm], rtol=1e-4,
                                       atol=1e-3)
            d_ref = np.sum((q - p[ref_idx]) ** 2, -1)
            np.testing.assert_allclose(np.sum((q - p[idx]) ** 2, -1)[qm],
                                       d_ref[qm], rtol=1e-4, atol=1e-3)
            assert np.all(d2[~qm] > 1e30) and np.all(ref_d2[~qm] > 1e30)
    # ties go to the lowest index: the copy in the second half never wins
    assert np.all(out[-1][0].numpy() < 400)


def test_nn_grouped_checks_every_problem():
    probs = [_t(*pr) for pr in _nn_group(11)]
    assert kernels.nn_grouped([]) == []
    bad = list(probs)
    bad[3] = (bad[3][0].double(),) + tuple(bad[3][1:])
    with pytest.raises(TypeError, match="problem 3"):
        kernels.nn_grouped(bad)
    empty = list(probs)
    q, qm = empty[0][:2]
    empty[0] = (q, qm, torch.zeros((0, 3)), torch.zeros((0,), dtype=bool))
    with pytest.raises(ValueError, match="empty support"):
        kernels.nn_grouped(empty)


def _count_calls(monkeypatch, name):
    calls = []
    fn = getattr(kernels, name)

    def counted(*args, **kwargs):
        calls.append(len(args[0]) if name == "nn_grouped" else 1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(kernels, name, counted)
    return calls


def _feature_clouds(rng, caps, n_valid):
    from mulls_tpu_torch.core.cloud import FeatureCloud
    out = {}
    for name, cap in caps.items():
        nrm = rng.normal(size=(cap, 3))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        out[name] = FeatureCloud(
            xyz=torch.from_numpy(rng.uniform(-15, 15, (cap, 3)).astype(
                np.float32)),
            normal=torch.from_numpy(nrm.astype(np.float32)),
            intensity=torch.from_numpy(rng.uniform(0, 200, cap).astype(
                np.float32)),
            strength=torch.zeros(cap), height=torch.zeros(cap),
            ts_ratio=torch.zeros(cap),
            mask=torch.arange(cap) < min(n_valid, cap))
    return out


def test_mm_lls_icp_makes_one_grouped_nn_call_per_iteration(monkeypatch):
    from mulls_tpu_torch.config import RegConfig
    from mulls_tpu_torch.frontend.icp import mm_lls_icp
    grouped = _count_calls(monkeypatch, "nn_grouped")
    single = _count_calls(monkeypatch, "nn")
    rng = np.random.default_rng(12)
    caps = {"ground": 96, "pillar": 32, "facade": 64, "beam": 16,
            "roof": 16}
    src = _feature_clouds(rng, caps, 40)
    tgt = _feature_clouds(rng, {n: 2 * c for n, c in caps.items()}, 120)
    res = mm_lls_icp(src, tgt, RegConfig(), torch.eye(4), max_iter=6)
    # every iteration runs (a done ICP is frozen, not stopped), and each
    # makes one call for all five classes of the default "111110"
    assert grouped == [5] * 6 and single == []
    assert int(res.iterations) >= 1


def test_update_local_map_makes_one_grouped_nn_call(monkeypatch):
    from mulls_tpu_torch.config import MapConfig, MapShapeConfig
    from mulls_tpu_torch.core.cloud import (FEATURE_NAMES, FeatureFrame,
                                            VertexDescriptors)
    from mulls_tpu_torch.core.draws import GeneratorDraws
    from mulls_tpu_torch.mapping.local_map import (init_local_map,
                                                   update_local_map)
    grouped = _count_calls(monkeypatch, "nn_grouped")
    single = _count_calls(monkeypatch, "nn")
    rng = np.random.default_rng(13)
    cfg = MapConfig(local_map_max_pt_num=50, shapes=MapShapeConfig(
        ground=64, pillar=32, beam=32, facade=64, roof=32, vertex=32))
    caps = {n: 24 for n in FEATURE_NAMES}
    m = init_local_map(cfg, "cpu")
    draws = GeneratorDraws(0, "cpu")
    for _ in range(2):
        down = _feature_clouds(rng, caps, 20)
        frame = FeatureFrame(full=down, down=down,
                             descriptors=VertexDescriptors.empty(24, "cpu"),
                             bbx_min=torch.full((3,), -15.0),
                             bbx_max=torch.full((3,), 15.0))
        m = update_local_map(m, frame, torch.eye(4), torch.tensor(1.0), cfg,
                             draws)
    # one call per update, for the three dynamic-removal classes
    assert grouped == [3, 3] and single == []
    assert int(m.clouds["facade"].count) > 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "mask"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    q, qm, p, pm = _t(*_clouds(8, qn=20, pn=40))
    if bad == "dtype":
        q = q.double()
    elif bad == "shape":
        q = q[:, :2].contiguous()
    elif bad == "contiguity":
        q = torch.cat([q, q], 1)[:, ::2]
    else:
        qm = qm.to(torch.uint8)
    with pytest.raises((TypeError, ValueError)):
        kernels.nn(q, qm, p, pm)


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of mulls_tpu_torch imports without jax, flax or
    mulls_tpu (a subprocess: this test process has jax loaded)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mulls_tpu_torch\n"
        "for m in pkgutil.walk_packages(mulls_tpu_torch.__path__,\n"
        "                               'mulls_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'mulls_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len([n for n in sys.modules\n"
        "                 if n.startswith('mulls_tpu_torch')]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[1]) >= 20


def test_launch_counters_under_thread_contention():
    """The SLAM pipeline launches from two host threads: totals and each
    thread's own record (``count_launches``) lose no update when 16
    threads count at a shortened switch interval."""
    import threading

    n_threads, per = 16, 2000
    kernels.reset_launch_counts()
    records = [None] * n_threads

    def work(k):
        with kernels.count_launches() as rec:
            for _ in range(per):
                kernels._count(kernels.nn)
                kernels._count(kernels.moments)
        records[k] = rec

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert kernels.launch_counts() == {"nn": n_threads * per, "nn_grouped": 0,
                                 "moments": n_threads * per,
                                 "pca_moments": 0, "count_within": 0}
    assert all(r == {"nn": per, "nn_grouped": 0, "moments": per,
                     "pca_moments": 0, "count_within": 0} for r in records)
    kernels.reset_launch_counts()
