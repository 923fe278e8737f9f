"""Multi-session merge of the port (``backend/merge.py``,
``apps/map_merge.py``) against the JAX package on the CPU.

The sessions are ``tests/test_merge.py``'s: two short runs over its
asymmetric world with opposite headings, each in its own frame 0, at the
parity tests' small width, run once by the port's ``SlamPipeline`` on the
CPU, which writes each session's checkpoint.  The port's CLI merges the
two checkpoints (the reference's key 0 replayed as its draws); the
reference merges the same submaps and edges, read from the same
checkpoints and handed over as numpy.

Tolerances: the same vote count and cluster size, the same set of
inter-session edges and the same PGO verdict, exactly; the session
transform within 2 cm / 0.2 deg and every merged frame pose within
5 cm / 0.5 deg of the reference's (the m2m ICPs and the PGO start from
equal inputs); against the truth, the bounds of ``tests/test_merge.py``
(session transform 1 m / 5 deg, frame positions 1 m)."""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulls_tpu.backend import merge as jmerge
from mulls_tpu.backend.submap import Edge as JEdge
from mulls_tpu.backend.submap import Submap as JSubmap
from mulls_tpu.core.cloud import FeatureCloud as JCloud
from mulls_tpu.core.cloud import VertexDescriptors as JDesc
from mulls_tpu_torch.apps import map_merge as tcli
from mulls_tpu_torch.backend import merge as tmerge
from mulls_tpu_torch.pipeline.checkpoint import save_checkpoint
from mulls_tpu_torch.pipeline.odometry import init_state
from mulls_tpu_torch.pipeline.slam import SlamPipeline
from test_merge import (_asymmetric_world, _merge_cfg, _session_gt,
                        _unrelated_world)
from test_pipeline import _simulate_scan
from torch_parity import CLOUD_FIELDS, JaxKeyDraws


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread a test worker: the runs are thousands of small
    operations on a CPU the suite's workers share."""
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
    dt = float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
    dr = _rot_deg(a[:3, :3], b[:3, :3])
    assert dt < tol_m and dr < tol_deg, (dt, dr)


def _run(cfg, world, gt, rng, ckpt=None):
    frames = [_simulate_scan(world, p, cfg.shapes.n_raw, 35.0, rng)
              for p in gt]
    return SlamPipeline(cfg, segment=2, device="cpu",
                        checkpoint_path=ckpt).run(frames)


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """The two sessions of tests/test_merge.py run by the port, with their
    checkpoints, and the unrelated session of its rejection test."""
    root = tmp_path_factory.mktemp("sessions")
    cfg = _merge_cfg()
    rng = np.random.default_rng(11)
    world = _asymmetric_world(rng)
    gA = _session_gt(10, (-10.0, 0.0, 0.0), 0.0)
    gB = _session_gt(10, (10.0, 3.0, 0.0), np.pi)
    paths = [str(root / f"s{i}.ckpt") for i in range(2)]
    runs = [_run(cfg, world, g, rng, p) for g, p in zip((gA, gB), paths)]
    for r in runs:
        assert all(c == 1 for c in r.codes), r.codes
        assert len(r.backend.submaps) >= 2
    rng_far = np.random.default_rng(23)
    far = _run(cfg, _unrelated_world(rng_far),
               _session_gt(6, (-6.0, -3.0, 0.0), 0.3), rng_far)
    return {"cfg": cfg, "paths": paths, "gA": gA, "gB": gB,
            "far": far, "root": root}


def _to_reference(sess: tmerge.SessionData) -> jmerge.SessionData:
    """The port's session as the reference's: the same clouds, descriptors,
    poses and edges as numpy."""
    subs = [JSubmap(
        sid=s.sid, pose=s.pose.copy(),
        clouds={n: JCloud(**{f: jnp.asarray(getattr(c, f).numpy())
                             for f in CLOUD_FIELDS})
                for n, c in s.clouds.items()},
        descriptors=JDesc(vec=jnp.asarray(s.descriptors.vec.numpy()),
                          mask=jnp.asarray(s.descriptors.mask.numpy())),
        frame_begin=s.frame_begin, frame_end=s.frame_end, stable=s.stable,
        span_min_conf=s.span_min_conf, span_mean_conf=s.span_mean_conf,
        local_bbx=s.local_bbx) for s in sess.submaps]
    edges = [JEdge(i=e.i, j=e.j, T=e.T.copy(), info=e.info.copy(),
                   kind=e.kind, sigma=e.sigma, confidence=e.confidence)
             for e in sess.edges]
    return jmerge.SessionData(submaps=subs, edges=edges, poses=sess.poses,
                              name=sess.name)


@pytest.fixture(scope="module")
def merged(sessions, tmp_path_factory):
    """The port's CLI on the two checkpoints (its draws the reference's
    key 0), its MergeResult kept; and the reference's merge of the same
    sessions."""
    out = tmp_path_factory.mktemp("merged")
    results = []
    mp = pytest.MonkeyPatch()
    mp.setattr(tcli, "MullsConfig", _merge_cfg)
    mp.setattr(tmerge, "GeneratorDraws",
               lambda seed, dev: JaxKeyDraws(jax.random.key(0)))

    def keep(*a, **kw):
        results.append(tmerge.merge_sessions(*a, **kw))
        return results[-1]

    mp.setattr(tcli, "merge_sessions", keep)
    try:
        rc = tcli.main(["--checkpoints", ",".join(sessions["paths"]),
                        "--output_dir", str(out / "poses"),
                        "--output_map_pcd", str(out / "map.pcd"),
                        "--output_map_html", str(out / "map.html"),
                        "--json_out", str(out / "merge.json"),
                        "--device", "cpu"])
    finally:
        mp.undo()
    ref = jmerge.merge_sessions(
        [_to_reference(tmerge.session_from_checkpoint(p))
         for p in sessions["paths"]], sessions["cfg"], key=jax.random.key(0))
    return {"rc": rc, "port": results[0], "ref": ref, "out": out}


def _votes(events):
    """(votes, best cluster) of the NCC pass."""
    m = re.search(r"NCC pass — (\d+) votes .* best cluster (\d+)",
                  "\n".join(events))
    return int(m.group(1)), int(m.group(2))


def test_merge_matches_reference(merged):
    port, ref = merged["port"], merged["ref"]
    assert _votes(port.events) == _votes(ref.events)
    _assert_close_T(port.session_transforms[1], ref.session_transforms[1],
                    0.02, 0.2)
    inter = lambda r: sorted((e.i, e.j) for e in r.edges
                             if e.kind == 2)
    assert inter(port) == inter(ref) and port.inter_edges >= 1
    assert port.inter_edges == ref.inter_edges
    assert port.pgo_accepted == ref.pgo_accepted
    for pp, pr in zip(port.poses, ref.poses):
        for a, b in zip(pp, pr):
            _assert_close_T(a, b, 0.05, 0.5)


def test_merged_session_lands_on_the_truth(sessions, merged):
    port = merged["port"]
    gA, gB = sessions["gA"], np.stack(sessions["gB"])
    T_true = np.linalg.inv(gA[0]) @ gB[0]
    _assert_close_T(port.session_transforms[1], T_true, 1.0, 5.0)
    assert port.pgo_accepted
    gt_B_in_A = np.einsum("ij,njk->nik", np.linalg.inv(gA[0]), gB)
    err = np.linalg.norm(port.poses[1][:, :3, 3] - gt_B_in_A[:, :3, 3],
                         axis=1)
    assert err.max() < 1.0, err
    # the anchor session stays where it was (pinned nodes)
    anchor = tmerge.session_from_checkpoint(sessions["paths"][0])
    np.testing.assert_allclose(port.poses[0], anchor.poses, atol=1e-6)
    # every merged submap owns its clouds: no bank slot, no fetch
    assert all(s.slot == -1 and s._fetch is None for s in port.submaps)


def test_map_merge_cli_writes_its_outputs(merged):
    out = merged["out"]
    assert merged["rc"] == 0
    rec = json.loads((out / "merge.json").read_text())
    assert rec["sessions"] == 2 and rec["inter_edges"] >= 1
    assert rec["pgo_accepted"] and set(rec["timings_ms"]) == {
        "vote", "edges", "pgo"}
    for name in ("session_0_pose.txt", "session_1_pose.txt",
                 "merged_submap_poses.txt"):
        assert os.path.getsize(out / "poses" / name) > 0
    assert len(np.loadtxt(out / "poses" / "session_1_pose.txt")) == 10
    assert os.path.getsize(out / "map.pcd") > 10_000
    assert os.path.getsize(out / "map.html") > 10_000


@pytest.mark.parametrize("min_votes", [2, 3])
def test_unrelated_session_gets_the_reference_verdict(sessions, min_votes):
    """tests/test_merge.py's unrelated session.  At ``min_votes`` 3 its NCC
    votes and then the BEV fallback's find no cluster, and both packages
    raise ValueError.  At the default 2, two of its NCC votes agree by
    chance on this data, and both packages accept the alignment (rigid
    only: every fine edge fails), a weakness of the reference's vote that
    the port keeps."""
    cfg = sessions["cfg"]
    anchor = tmerge.session_from_checkpoint(sessions["paths"][0])
    far = tmerge.SessionData(submaps=sessions["far"].backend.submaps,
                             edges=sessions["far"].backend.edges,
                             poses=sessions["far"].poses, name="unrelated")
    ref_args = ([_to_reference(anchor), _to_reference(far)], cfg)
    if min_votes == 3:
        with pytest.raises(ValueError, match="could not be localized"):
            tmerge.merge_sessions([anchor, far], cfg, min_votes=3,
                                  draws=JaxKeyDraws(jax.random.key(0)),
                                  device="cpu")
        with pytest.raises(ValueError, match="could not be localized"):
            jmerge.merge_sessions(*ref_args, min_votes=3,
                                  key=jax.random.key(0))
        return
    port = tmerge.merge_sessions([anchor, far], cfg,
                                 draws=JaxKeyDraws(jax.random.key(0)),
                                 device="cpu")
    ref = jmerge.merge_sessions(*ref_args, key=jax.random.key(0))
    assert port.events == ref.events
    assert port.inter_edges == ref.inter_edges == 0
    assert not port.pgo_accepted and not ref.pgo_accepted


def test_map_merge_cli_refuses_unusable_checkpoints(sessions, tmp_path):
    """Exit 1 on an odometry-only checkpoint (no back end) or a missing
    file, 2 on fewer than two checkpoints."""
    cfg = sessions["cfg"]
    odo = str(tmp_path / "odometry.ckpt")
    poses = np.tile(np.eye(4), (3, 1, 1))
    save_checkpoint(odo, init_state(cfg, "cpu"), 3, poses, poses,
                    [1, 1, 1], [0.0, 0.0, 0.0])
    with pytest.raises(ValueError, match="no back-end"):
        tmerge.session_from_checkpoint(odo)
    first = sessions["paths"][0]
    args = ["--output_dir", str(tmp_path / "out"), "--device", "cpu"]
    assert tcli.main(["--checkpoints", f"{first},{odo}"] + args) == 1
    assert tcli.main(["--checkpoints",
                      f"{first},{tmp_path / 'missing.ckpt'}"] + args) == 1
    assert tcli.main(["--checkpoints", first] + args) == 2
    assert not os.path.exists(tmp_path / "out")


def test_merge_runs_on_the_card_unless_asked(sessions):
    """Without a card the default device raises; the CPU runs only when
    asked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    anchor = tmerge.session_from_checkpoint(sessions["paths"][0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmerge.merge_sessions([anchor, anchor], sessions["cfg"])
