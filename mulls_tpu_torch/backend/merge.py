"""Multi-session submap merging — port of ``mulls_tpu/backend/merge.py``
(the "multi-session submap merging" workload of BASELINE.md configs #5).

The reference program is single-session; merging runs reuses the
in-run loop-closure blocks (``backend/submap.py``): NCC keypoint matching
with GNC coarse registration, map-to-map MULLS-ICP fine edges and the
pose-graph optimizer with its wrong-edge veto.

Per added session, merged into the growing "anchor" graph:

1. **Place recognition by voting.**  Every (anchor submap, new submap)
   pair gets an NCC + GNC coarse alignment (no initial guess exists
   across sessions).  Each valid pair implies a session transform
   ``T_s = pose_a @ T_pair @ pose_b^-1``; the largest cluster of votes
   that agree within a translation / rotation tolerance is the session's
   alignment.  When the cluster is too small, the BEV correlation search
   runs over all pairs instead, with the new side's stacks kept and a
   one-entry cache of the anchor's.
2. **Fine inter-session edges.**  With the new session moved by ``T_s``,
   the voting pairs and the overlapping pairs (centre distance and bbx IoU
   gates, `build_pose_graph.cpp:123-209`) are registered map to map;
   survivors become REGISTRATION edges.
3. **Joint PGO** over every session's submaps with the anchor session
   pinned (`graph_optimizer.cpp:594-629` node freezing) and the standard
   veto.

Per-frame trajectories are corrected by each submap's rigid correction.
Sessions come from the port's own checkpoints
(``pipeline/checkpoint.py``, the back end as ``backend/convert.py``
writes it).  Registration and PGO run on the back end's device.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple

import numpy as np

from mulls_tpu_torch.backend.convert import edges_from_numpy, submaps_from_numpy
from mulls_tpu_torch.backend.submap import (REG_EDGE, Edge, SlamBackend,
                                            Submap, _bbx_iou_2d,
                                            bev_align_submaps, bev_stack_of,
                                            coarse_align_submaps, to_host)
from mulls_tpu_torch.config import MullsConfig
from mulls_tpu_torch.core import trace
from mulls_tpu_torch.core.device import resolve_device
from mulls_tpu_torch.core.draws import Draws, GeneratorDraws


@dataclass
class SessionData:
    """One finished run: its submaps and pose-graph edges (ids local to the
    session), and optionally its per-frame trajectory."""
    submaps: List[Submap]
    edges: List[Edge]
    poses: Optional[np.ndarray] = None  # [N,4,4] frame poses (session frame)
    name: str = ""


def session_from_checkpoint(path: str, name: str = "") -> SessionData:
    """A session from a SLAM checkpoint of this package
    (``pipeline/checkpoint.py``); raises ValueError when the checkpoint
    carries no back end (an odometry-only run)."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if payload.get("backend") is None:
        raise ValueError(f"{path}: checkpoint has no back-end (odometry-"
                         "only run?) — nothing to merge")
    b = payload["backend"]
    n = int(payload["frame_idx"])
    return SessionData(submaps=submaps_from_numpy(b),
                       edges=edges_from_numpy(b),
                       poses=np.asarray(payload["poses"])[:n],
                       name=name or path)


@dataclass
class MergeResult:
    submaps: List[Submap]  # merged graph, global sids, optimized poses
    edges: List[Edge]
    # rigid transform applied to each input session (anchor = identity)
    session_transforms: List[np.ndarray]
    # [S0, S1, ...) node-id offset of each session in the merged graph
    session_offsets: List[int]
    # corrected per-frame trajectories in the anchor frame (None where the
    # input session carried no trajectory)
    poses: List[Optional[np.ndarray]]
    inter_edges: int = 0
    pgo_accepted: bool = False
    events: List[str] = field(default_factory=list)
    # host-clock ms, results fetched: "vote" (step 1 for every added
    # session), "edges" (step 2), "pgo" (step 3)
    timings: dict = field(default_factory=dict)


def _rot_deg(R: np.ndarray) -> float:
    c = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    return float(np.degrees(np.arccos(c)))


def find_session_transform(anchor: List[Submap], new: List[Submap],
                           cfg: MullsConfig, draws: Draws,
                           tran_tol: float = 3.0, rot_tol_deg: float = 5.0,
                           min_votes: int = 2,
                           events: Optional[list] = None, device="cuda"
                           ) -> Tuple[Optional[np.ndarray],
                                      List[Tuple[int, int]]]:
    """Voting global alignment (step 1 above) on ``device``.  Returns
    (T_s, supporting (anchor_idx, new_idx) pairs) or (None, []).  Each
    pair takes one split of ``draws``, as the reference splits its key."""
    def _collect(align):
        nonlocal draws
        votes = []  # (ai, bi, T_s)
        for ai, a in enumerate(anchor):
            for bi, b in enumerate(new):
                draws, k = draws.split(2)
                T_pair, ok = align(ai, bi, a, b, k)
                if not ok:
                    continue
                votes.append((ai, bi, a.pose @ T_pair @ np.linalg.inv(b.pose)))
        return votes

    def _best_cluster(votes):
        best: List[int] = []
        for _, _, T0 in votes:
            support = [k for k, (_, _, T) in enumerate(votes)
                       if (np.linalg.norm(T[:3, 3] - T0[:3, 3]) < tran_tol
                           and _rot_deg(T0[:3, :3].T @ T[:3, :3])
                           < rot_tol_deg)]
            if len(support) > len(best):
                best = support
        return best

    votes = _collect(lambda ai, bi, a, b, k: coarse_align_submaps(
        a, b, cfg, k, device))
    best_support = _best_cluster(votes)
    if events is not None:
        events.append(f"merge: NCC pass — {len(votes)} votes from "
                      f"{len(anchor)}x{len(new)} pairs, best cluster "
                      f"{len(best_support)}")
    if len(best_support) < min_votes and anchor and new:
        # descriptor matching degraded: the dense BEV correlation search
        # per pair.  The new side's stacks serve every anchor, so all B are
        # kept; an anchor's serve one inner sweep, so one is cached
        stacks_b = [bev_stack_of(s, device) for s in new]
        a_cache: dict = {}

        def _stack_a(ai, a):
            if ai not in a_cache:
                a_cache.clear()
                a_cache[ai] = bev_stack_of(a, device)
            return a_cache[ai]

        votes = _collect(lambda ai, bi, a, b, k: bev_align_submaps(
            a, b, device=device, stack_a=_stack_a(ai, a),
            stack_b=stacks_b[bi]))
        best_support = _best_cluster(votes)
        if events is not None:
            events.append(f"merge: BEV fallback — {len(votes)} votes, "
                          f"best cluster {len(best_support)}")
    if len(best_support) < min_votes:
        if events is not None:
            events.append(f"merge: best cluster has {len(best_support)} "
                          f"vote(s) < {min_votes} — alignment rejected")
        return None, []
    # average the cluster: mean translation + chordal-mean rotation (SVD
    # of the summed rotation matrices)
    Ts = [votes[k][2] for k in best_support]
    t = np.mean([T[:3, 3] for T in Ts], axis=0)
    u, _, vt = np.linalg.svd(np.sum([T[:3, :3] for T in Ts], axis=0))
    R = u @ np.diag([1.0, 1.0, np.linalg.det(u @ vt)]) @ vt
    T_s = np.eye(4)
    T_s[:3, :3] = R
    T_s[:3, 3] = t
    pairs = [(votes[k][0], votes[k][1]) for k in best_support]
    if events is not None:
        events.append(f"merge: session transform from {len(pairs)} "
                      f"agreeing pairs, |t|={np.linalg.norm(t):.2f} m")
    return T_s, pairs


def _own_copy(sm: Submap, sid: int, pose: np.ndarray) -> Submap:
    """A host-resident copy of ``sm`` that owns its clouds (a copy of the
    host clouds, never a fetch from a bank) with a new id and pose."""
    out = Submap(sid=sid, pose=pose, clouds=to_host(sm.clouds),
                 descriptors=to_host(sm.descriptors),
                 frame_begin=sm.frame_begin, frame_end=sm.frame_end,
                 stable=sm.stable, span_min_conf=sm.span_min_conf,
                 span_mean_conf=sm.span_mean_conf, local_bbx=sm.local_bbx)
    out.compute_bounds()
    return out


def merge_sessions(sessions: List[SessionData], cfg: MullsConfig,
                   draws: Optional[Draws] = None, min_votes: int = 2,
                   max_inter_edges_per_session: int = 8,
                   device="cuda") -> MergeResult:
    """Merge >= 2 sessions into one globally consistent submap graph on
    ``device``.  Sessions after the first are aligned onto the growing
    anchor graph in order; raises ValueError if a session cannot be
    localized.  ``draws`` defaults to a generator seeded from
    ``cfg.seed``."""
    if len(sessions) < 2:
        raise ValueError("need at least two sessions to merge")
    dev = resolve_device(device)
    if draws is None:
        draws = GeneratorDraws(cfg.seed, dev)
    events: List[str] = []
    timings = {"vote": 0.0, "edges": 0.0, "pgo": 0.0}

    merged: List[Submap] = []
    edges: List[Edge] = []
    offsets: List[int] = []
    transforms: List[np.ndarray] = [np.eye(4)]
    pre_merge_poses: List[List[np.ndarray]] = []  # per session, per submap

    def _append_session(sess: SessionData, T_s: np.ndarray):
        off = len(merged)
        offsets.append(off)
        pre = []
        for sm in sess.submaps:
            sm2 = _own_copy(sm, off + sm.sid, T_s @ sm.pose)
            pre.append(sm2.pose.copy())
            merged.append(sm2)
        pre_merge_poses.append(pre)
        for e in sess.edges:
            edges.append(replace(e, i=e.i + off, j=e.j + off, T=e.T.copy(),
                                 info=e.info.copy()))

    _append_session(sessions[0], np.eye(4))

    backend = SlamBackend(cfg, dev)  # m2m registration + PGO, no bank
    s_cfg = cfg.submap
    total_inter = 0

    for sess in sessions[1:]:
        draws, k_align = draws.split(2)
        with trace.span("merge.vote", timed=True) as sp:
            T_s, support = find_session_transform(
                list(merged), sess.submaps, cfg, k_align,
                min_votes=min_votes, events=events, device=dev)
        timings["vote"] += sp.ms
        if T_s is None:
            raise ValueError(
                f"session '{sess.name}' could not be localized against the "
                f"anchor map ({events[-1] if events else 'no votes'})")
        transforms.append(T_s)
        _append_session(sess, T_s)
        off = offsets[-1]

        # fine inter-session edges on overlapping pairs; voting pairs
        # first (they are known to overlap), then IoU-gated extras
        with trace.span("merge.edges", timed=True) as sp:
            cand = list(dict.fromkeys(
                [(ai, off + bi) for ai, bi in support]
                + [(ai, off + bi)
                   for ai in range(off) for bi in range(len(sess.submaps))
                   if (np.linalg.norm(merged[ai].center[:2]
                                      - merged[off + bi].center[:2])
                       < s_cfg.neighbor_search_dist
                       and _bbx_iou_2d(merged[ai], merged[off + bi])
                       > s_cfg.min_iou_thre)]))
            n_ok = 0
            for attempted, (ai, bj) in enumerate(cand):
                if n_ok >= max_inter_edges_per_session:
                    events.append(f"merge: inter-edge cap "
                                  f"({max_inter_edges_per_session}) reached, "
                                  f"{len(cand) - attempted} candidates unused")
                    break
                a, b = merged[ai], merged[bj]
                res = backend.map_to_map(a, b, np.linalg.inv(a.pose) @ b.pose)
                code, conf = int(res.process_code), float(res.confidence)
                if code != 1:
                    events.append(f"merge edge {a.sid}->{b.sid}: fine reg "
                                  f"code {code}")
                    continue
                if conf < s_cfg.map_to_map_min_cor_ratio:
                    events.append(f"merge edge {a.sid}->{b.sid}: corr ratio "
                                  f"{conf:.3f} too low")
                    continue
                sigma = float(res.sigma)
                edges.append(Edge(
                    i=a.sid, j=b.sid,
                    T=res.transform.cpu().numpy().astype(np.float64),
                    info=res.information.cpu().numpy().astype(np.float64),
                    kind=REG_EDGE, sigma=sigma, confidence=conf))
                n_ok += 1
                events.append(f"merge edge {a.sid}->{b.sid}: accepted, sigma "
                              f"{sigma:.4f}")
        total_inter += n_ok
        timings["edges"] += sp.ms

    # joint PGO with the anchor session pinned
    backend.submaps = merged
    backend.edges = edges
    backend.events = events
    anchor_fixed = np.zeros(len(merged), bool)
    anchor_fixed[:offsets[1] if len(offsets) > 1 else len(merged)] = True
    # a submap's in-run "stable" status must not clamp the cross-session
    # correction: non-anchor nodes fall back to the growing free-node
    # bounds (`graph_optimizer.cpp:594-629` semantics for unconfirmed
    # nodes)
    for sm in merged[len(sessions[0].submaps):]:
        sm.stable = False
    accepted = False
    if total_inter > 0:
        with trace.span("merge.pgo", timed=True) as sp:
            accepted = backend.optimize(extra_fixed=anchor_fixed) is not None
        timings["pgo"] = sp.ms
        events.append("merge: joint PGO "
                      + ("accepted" if accepted else "vetoed"))
    else:
        events.append("merge: no inter-session fine edges — rigid "
                      "alignment only, PGO skipped")

    # per-frame trajectory correction: frame pose -> anchor frame via T_s,
    # then the containing submap's PGO correction
    out_poses: List[Optional[np.ndarray]] = []
    for si, sess in enumerate(sessions):
        if sess.poses is None:
            out_poses.append(None)
            continue
        poses = np.einsum("ij,njk->nik", transforms[si],
                          np.asarray(sess.poses))
        off = offsets[si]
        for li, sm in enumerate(sess.submaps):
            corr = merged[off + li].pose @ np.linalg.inv(
                pre_merge_poses[si][li])
            lo = sm.frame_begin
            hi = (sess.submaps[li + 1].frame_begin
                  if li + 1 < len(sess.submaps) else len(poses))
            poses[lo:hi] = np.einsum("ij,njk->nik", corr, poses[lo:hi])
        out_poses.append(poses)

    return MergeResult(submaps=merged, edges=edges,
                       session_transforms=transforms,
                       session_offsets=offsets, poses=out_poses,
                       inter_edges=total_inter, pgo_accepted=accepted,
                       events=events, timings=timings)


def merged_feature_map(result: MergeResult, max_points_per_submap: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All submaps' feature clouds in the anchor frame: (xyz [N,3],
    class_id [N] uint8, intensity [N]) for map export and the WebGL viewer
    (class ids follow ``viz/html_viewer.CLASS_NAMES``)."""
    from mulls_tpu_torch.viz.html_viewer import feature_map_points
    return feature_map_points(result.submaps, max_points_per_submap)
