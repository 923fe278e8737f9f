"""The port's multi-device layer against the JAX package's:
``backend/pgo.py::optimize_pose_graph_sharded`` on the 8-device CPU mesh
(tests/conftest.py) against the reference's and against the port's
one-device solver, within 1e-3 m; ``distributed_slam_step`` against the
reference's on 4 small-width pairs (transforms within the parity bounds,
2 cm / 0.2 deg; nodes within 1e-3); ``make_mesh``'s devices; the
``distributed`` helpers; and a 2-process gloo group (``file://`` init,
``spawn``, a timeout) whose sharded PGO equals the one-process result on
a 2-entry mesh bit for bit."""

import json
import multiprocessing

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from mulls_tpu.backend.pgo import PoseGraph as JPoseGraph
from mulls_tpu.backend.pgo import \
    optimize_pose_graph_sharded as j_sharded
from mulls_tpu.core.cloud import FeatureCloud as JFeatureCloud
from mulls_tpu.parallel.mesh import distributed_slam_step as j_step
from mulls_tpu.parallel.mesh import make_mesh as j_make_mesh
from mulls_tpu_torch.backend.pgo import (optimize_pose_graph,
                                         optimize_pose_graph_sharded)
from mulls_tpu_torch.core.cloud import RawCloud
from mulls_tpu_torch.core.draws import GeneratorDraws
from mulls_tpu_torch.frontend.features import extract_features
from mulls_tpu_torch.parallel import distributed as dist
from mulls_tpu_torch.parallel.mesh import (batched_icp,
                                           distributed_slam_step, make_mesh)
from mulls_tpu_torch.parallel.ring_check import (ring_graph, sharded_rank,
                                                 torch_graph)
from torch_parity import CLOUD_FIELDS

from test_torch_pipeline import _assert_same_motion


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j_graph(g):
    return JPoseGraph(**{k: jnp.asarray(
        v.astype(np.int32) if k in ("edge_i", "edge_j") else v)
        for k, v in g.items() if k != "t_true"})


@pytest.mark.parametrize("robust", [False, True])
def test_sharded_pgo_matches_reference_and_the_local_solver(robust):
    g = ring_graph()
    t_ref, q_ref, chi_ref = j_sharded(_j_graph(g), j_make_mesh(8),
                                      iterations=15, robust_kernel=robust)
    t, q, chi2 = optimize_pose_graph_sharded(
        torch_graph(g), make_mesh(8, device="cpu"), iterations=15,
        robust_kernel=robust)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=1e-3)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_ref), atol=1e-4)
    np.testing.assert_allclose(float(chi2), float(chi_ref), atol=1e-4)
    t1, _, _ = optimize_pose_graph(torch_graph(g), iterations=15,
                                   robust_kernel=robust)
    np.testing.assert_allclose(t.numpy(), t1.numpy(), atol=1e-3)
    np.testing.assert_allclose(t.numpy()[:, 0], g["t_true"][:, 0],
                               atol=0.05)


def test_sharded_pgo_needs_edges_in_whole_blocks():
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        optimize_pose_graph_sharded(torch_graph(ring_graph()),
                                    make_mesh(3, device="cpu"))


def _features(cfg, d, seed):
    raw = RawCloud.from_numpy(d, "cpu")
    return extract_features(raw, cfg, GeneratorDraws(seed, "cpu")).down


def test_distributed_slam_step_matches_reference():
    """Four small-width pairs of distinct worlds with distinct offsets
    (``__graft_entry__.dryrun_multichip``'s), one per mesh entry: the
    same features into both steps."""
    cfg = ge._small_cfg()
    srcs, tgts, true_Ts = [], [], []
    for s in range(4):
        world = ge._make_world(100 + s)
        rng = np.random.default_rng(100 + s)
        ang = 0.02 + 0.005 * s
        T = np.eye(4, dtype=np.float32)
        T[:2, :2] = [[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]]
        T[:3, 3] = [0.4 + 0.05 * s, -0.2, 0.03]
        true_Ts.append(T)
        tgts.append(_features(cfg, ge._render_scan(world, np.eye(4), cfg,
                                                   rng), 2 * s))
        srcs.append(_features(cfg, ge._render_scan(world, T, cfg, rng),
                              2 * s + 1))

    def stack_t(cl):
        return {k: type(cl[0][k])(**{f: torch.stack([getattr(c[k], f)
                                                       for c in cl])
                                     for f in CLOUD_FIELDS})
                for k in cl[0]}

    def stack_j(cl):
        return {k: JFeatureCloud(**{f: jnp.asarray(np.stack(
            [getattr(c[k], f).numpy() for c in cl])) for f in CLOUD_FIELDS})
            for k in cl[0]}

    m = 5
    guesses = np.broadcast_to(np.eye(4, dtype=np.float32), (4, 4, 4)).copy()
    e_i, e_j = np.arange(4), np.arange(1, 5)
    node_t = np.zeros((m, 3), np.float32)
    node_q = np.zeros((m, 4), np.float32)
    node_q[:, 0] = 1.0
    nt_r, nq_r, T_r, sig_r = j_step(j_make_mesh(4), cfg.reg, 8, m)(
        stack_j(srcs), stack_j(tgts), jnp.asarray(guesses),
        jnp.asarray(e_i, jnp.int32), jnp.asarray(e_j, jnp.int32),
        jnp.asarray(node_t), jnp.asarray(node_q))
    step = distributed_slam_step(make_mesh(4, device="cpu"), cfg.reg, 8, m)
    nt, nq, T, sig = step(stack_t(srcs), stack_t(tgts),
                          torch.from_numpy(guesses), torch.from_numpy(e_i),
                          torch.from_numpy(e_j), torch.from_numpy(node_t),
                          torch.from_numpy(node_q))
    _assert_same_motion(T.numpy().astype(np.float64),
                        np.asarray(T_r).astype(np.float64))
    np.testing.assert_allclose(nt.numpy(), np.asarray(nt_r), atol=1e-3)
    np.testing.assert_allclose(nq.numpy(), np.asarray(nq_r), atol=1e-3)
    for s in range(4):
        err = np.linalg.inv(true_Ts[s]) @ T[s].numpy()
        assert np.linalg.norm(err[:3, 3]) < 0.1, s
    # the step's transforms are batched_icp's, pair by pair
    one = batched_icp(stack_t(srcs[:1]), stack_t(tgts[:1]),
                      torch.from_numpy(guesses[:1]), cfg.reg, 8)
    assert torch.equal(one[0].transform, T[0])
    assert torch.equal(one[0].sigma, sig[0])


def test_make_mesh_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda mesh is in "
                    "tests/test_torch_cuda.py")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dist.global_mesh()
    mesh = make_mesh(2, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert (mesh.size, mesh.rank, mesh.world_size) == (2, 0, 1)
    assert mesh.blocks(6) == [(0, 3), (3, 6)]
    assert make_mesh(device="cpu").size == 1


def test_distributed_helpers_without_a_process_group(monkeypatch):
    for k in ("MULLS_TPU_COORDINATOR", "RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert dist.initialize_from_env() is False
    assert dist.process_slice(10) == (0, 10)
    assert dist.describe() == "one process (no process group)"
    assert dist.global_mesh(device="cpu").size == 1
    padded = dist.shard_sequences([1, 2, 3], make_mesh(8, device="cpu"))
    assert len(padded) == 8 and padded[:3] == [1, 2, 3]
    assert all(x == 3 for x in padded[3:])
    with pytest.raises(ValueError, match="number of processes"):
        dist.initialize_from_env("localhost:1")


def test_two_process_gloo_group_equals_one_process(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp_path / 'rendezvous'}"
    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    procs = [ctx.Process(target=sharded_rank, args=(r, 2, init, outs[r]))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive), "a rank did not finish within 120 s"
    assert [p.exitcode for p in procs] == [0, 0]
    recs = []
    for o in outs:
        with open(o) as f:
            recs.append(json.load(f))
    t, q, chi2 = optimize_pose_graph_sharded(
        torch_graph(ring_graph()), make_mesh(2, device="cpu"),
        iterations=15)
    for r, rec in enumerate(recs):
        assert rec["describe"] == f"rank {r} of 2, backend gloo"
        assert rec["mesh_size"] == 2
        np.testing.assert_array_equal(np.float32(rec["t"]), t.numpy())
        np.testing.assert_array_equal(np.float32(rec["q"]), q.numpy())
        assert np.float32(rec["chi2"]) == chi2.numpy()
        assert rec["whole"] == [0.0, 1.0, 2.0, 10.0, 11.0, 12.0]
    assert [tuple(r["slice"]) for r in recs] == [(0, 5), (5, 10)]
