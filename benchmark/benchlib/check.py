"""The comparison that decides ``correct``: what the timed path produced,
stage by stage, against the plain reference, at frames drawn from the
seed, for every sequence of the batch.

At a probed frame (see :class:`benchlib.probe.StageProbe`) the step's
inputs and outputs are kept as the program handed them over.  For each
sequence the reference then works out, from the same inputs:

* the features: ``mulls_ref``'s extractor (a frozen copy of the port's
  unbatched extractor, with the plain neighbourhood operations) on the
  benchmark's own scan, from the sequence's draws at the step's start and
  the state's non-ground rate.  ``feat_miss``: the share of feature points
  (full and down-sampled clouds, every class) on either side with no point
  of the same class on the other within ``feat_match_m``;
* the registration: MULLS-ICP written plainly in float64
  (``mulls_ref/plain64.py``) of the program's down-sampled features onto
  the map the state held, from the state's motion prior, with the state's
  gate widening, followed to the iteration at which the program stopped
  (the program's float32 cannot resolve the stated rotation threshold,
  0.001 degrees, so it stops some iterations earlier than float64 would,
  and the annealed gates then move the two answers apart by centimetres).
  ``reg_code_miss``: the share of registrations whose stop the reference
  does not bear out (:func:`stop_agrees`); ``reg_miss``: the share of the
  program's successful registrations whose transform parts from the
  reference's at the same iteration by more than ``reg_match_m`` or
  ``reg_match_deg``;
* the map insertion: written plainly in float64 too, of the program's
  features with the program's answer into the map the state held, with the
  draws at the insertion, against the map of the state the step returns
  (no frame is probed at which the map refreshes its line directions).
  ``map_miss``: the share of map points on either side with no point of
  the same class on the other within ``map_match_m``;
* the carry between frames: ``carry_gap_m``, the largest gap between the
  motion prior the state holds and the answer of the frame before, and
  between the pose that the step returns and the pose it was handed
  composed with its answer.

The kernels' own outputs are held to their plain versions at every segment
start, for every sequence (:func:`kernel_gaps`).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchlib.catalog import apply_overrides


def reference_config(config: dict):
    """The reference's steady config, as ``MultiSeqPipeline`` runs the
    configuration's ``mulls_config``: the in-frame ladder and the mover
    veto off (at the probed frames, after the warm-up scan-to-scan, the
    warm and the steady configs step alike)."""
    from mulls_ref.config import MullsConfig
    cfg = apply_overrides(MullsConfig(), config.get("mulls_config", {}))
    return apply_overrides(cfg, {"map": {"inframe_recovery_on": False,
                                         "dynamic_sanity_veto_on": False,
                                         "warmup_s2s_on": False}})


def probed_frames(seed: int, n_frames: int, segment: int,
                  refresh: int, first: int = 3, skip=()) -> List[int]:
    """One frame a segment drawn from the seed, after the warm-up
    scan-to-scan frames (``first``), none in the segments ``skip``, and
    none at which the map refreshes its line directions (frame ``f`` with
    ``(f + 1) % refresh == 0``)."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    out = []
    for a in range(0, n_frames, segment):
        if a // segment in skip:
            continue
        ok = [f for f in range(max(a, first), min(a + segment, n_frames))
              if not (0 < refresh < 99999 and (f + 1) % refresh == 0)]
        if ok:
            out.append(ok[int(rng.integers(len(ok)))])
    return out


def entry(obj, s: Optional[int]):
    """Batch entry ``s`` of a tree of tensors (dataclasses and dicts, the
    dataclasses as dicts without their draws); ``s`` None: the tree
    itself, unbatched."""
    if torch.is_tensor(obj):
        return obj if s is None else obj[s]
    if isinstance(obj, dict):
        return {k: entry(v, s) for k, v in obj.items()}
    if hasattr(obj, "__dataclass_fields__"):
        return {k: entry(getattr(obj, k), s)
                for k in obj.__dataclass_fields__ if k != "draws"}
    return obj


def clouds(d: dict) -> Dict[str, dict]:
    """A dict of clouds (as :func:`entry` gives them) with the fields that
    the plain reference reads."""
    return {n: {k: c[k] for k in ("xyz", "normal", "intensity", "mask")}
            for n, c in d.items()}


def _T(vec) -> torch.Tensor:
    """The [4, 4] float64 transform packed in a result's first 12 numbers."""
    T = torch.eye(4, dtype=torch.float64)
    T[:3, :] = torch.as_tensor(np.asarray(vec[:12], np.float64)).reshape(3, 4)
    return T


def _angle_deg(Ra: torch.Tensor, Rb: torch.Tensor) -> float:
    """The angle between two rotations, from the chord between them."""
    chord = float(torch.linalg.matrix_norm(Ra.double() - Rb.double()))
    return math.degrees(2.0 * math.asin(min(1.0, chord / (2.0 * math.sqrt(2.0)))))


# what float32 resolves of an ICP step (the program's precision): its
# rotation angle, an arccos of the trace, reads 0 below ~3.5e-4 rad (the
# trace's own rounding adds some); its translation, built from coordinates
# of tens of metres, is off by ~1e-5 m
ROT_RES_RAD = 6e-4
TRAN_RES_M = 2e-5


def stop_agrees(code: int, n: int, at: Optional[dict], reg) -> bool:
    """Whether the program's stop (status ``code`` after ``n``
    iterations) is the reference's at its iteration ``n`` (``at``): the
    same failure, or, for a success, the last iteration or a step under
    the convergence thresholds, as far as float32 resolves them, after the
    first three iterations, with sigma under its threshold."""
    if at is None:
        return False
    if code != 1:
        return at["code"] == code
    if at["code"] == 1:
        return True
    return (at["code"] == 0 and n > 3 and at["sigma"] < reg.sigma_thre
            and at["step_t"] < reg.converge_tran + TRAN_RES_M
            and at["step_r"] < max(math.radians(reg.converge_rot_d),
                                   ROT_RES_RAD))


def stage_gaps(rec: dict, s: Optional[int], frame: int, scan: dict,
               vec: np.ndarray, vec_prev: np.ndarray, cfg, limits: dict,
               device) -> dict:
    """One sequence's readings at one probed frame.  ``rec``: the probe's
    record of the frame (batched for ``s`` an index); ``scan``: the
    benchmark's scan (host arrays); ``vec``, ``vec_prev``: the program's
    packed answers for this frame and the one before."""
    from mulls_ref import plain64
    from mulls_ref.core.cloud import pack_raw_host, unpack_raw
    from mulls_ref.core.draws import GeneratorDraws
    from mulls_ref.frontend.features import extract_features
    dev = torch.device(device)
    k = 0 if s is None else s
    st_in, st_out = entry(rec["state_in"], s), entry(rec["state_out"], s)
    feats = entry(rec["feats"], s)
    out = {"frame": frame, "seq": k}
    t0 = time.perf_counter()

    # features from the benchmark's scan and the sequence's draws
    draws = GeneratorDraws(0, dev)
    draws.set_state(rec["draws_step"][k])
    raw = unpack_raw(pack_raw_host(scan, with_ts=False).to(dev))
    ng = st_in["nonground_rate"] if cfg.feature.adaptive_parameters_on \
        else None
    ref = extract_features(raw, cfg, draws, nonground_rate=ng)
    miss = total = 0
    for part in ("full", "down"):
        m, t = plain64.cloud_miss(clouds(feats[part]),
                                  clouds(entry(ref, None)[part]),
                                  float(limits["feat_match_m"]))
        miss, total = miss + m, total + t
    out.update(feat_miss=miss, feat_total=total)
    del ref, raw
    t1 = time.perf_counter()

    # registration of the program's features onto the map it held, the
    # reference's ICP followed to the program's iteration count
    down = clouds(feats["down"])
    target = clouds(st_in["local_map"]["clouds"])
    guess = st_in["T_prev"].to(dev)
    T_prog = _T(vec)
    code = int(round(float(vec[13])))
    n = int(round(float(vec[15])))
    r = plain64.icp(down, target, cfg.reg, guess,
                    cfg.reg.reg_max_iter_num_s2m,
                    float(st_in["add_length"]), until=n)
    at = r["path"][n - 1] if 1 <= n <= len(r["path"]) else None
    out.update(code=code, iters=n, ref_code=r["code"],
               ref_iters=r["iterations"], sigma=float(vec[12]),
               ref_sigma=r["sigma"], stop_ok=stop_agrees(code, n, at, cfg.reg))
    if code < 0 and at is not None:  # why it failed, for the record
        out.update(ref_counts=at["counts"], ref_conf=at["confidence"])
    if code == 1 and at is not None:
        out.update(dt_m=float((at["T"][:3, 3].cpu() - T_prog[:3, 3]).norm()),
                   dr_deg=_angle_deg(at["T"][:3, :3].cpu(), T_prog[:3, :3]))
    del r
    t2 = time.perf_counter()

    # the carry: the prior is the last answer, the pose composes
    prior = st_in["T_prev"].double().cpu()
    pose = st_in["pose"].double().cpu() @ T_prog
    out["carry_gap_m"] = max(
        float((prior[:3, :] - _T(vec_prev)[:3, :]).abs().max()),
        float((st_out["pose"].double().cpu()[:3, 3] - pose[:3, 3]).norm()))

    # the map insertion of the program's features with its answer
    conf = float(vec[14])
    ema = float(st_in["conf_ema"])
    baseline = conf if ema < 0.0 else ema
    removal = code >= 0 and conf >= (cfg.map.dynamic_removal_confidence_drop
                                     * baseline)
    caps = {c: cfg.map.shapes.capacity(c) for c in plain64.CLASSES}
    n_rows = sum(caps[c] + down[c]["mask"].shape[-1] for c in plain64.CLASSES)
    draws.set_state(rec["draws_map"][k])
    u = draws.uniform((n_rows,))
    ref_map = plain64.insert(target, down, T_prog.to(dev), caps, cfg.map, u,
                             removal)
    m, t = plain64.cloud_miss(clouds(st_out["local_map"]["clouds"]),
                              ref_map, float(limits["map_match_m"]))
    out.update(map_miss=m, map_total=t,
               seconds=[t1 - t0, t2 - t1, time.perf_counter() - t2])
    return out


def stage_numbers(records: List[dict], limits: dict) -> dict:
    """The compared numbers over the records of :func:`stage_gaps`."""
    if not records:
        return {}
    feat = sum(r["feat_miss"] for r in records) / max(
        sum(r["feat_total"] for r in records), 1)
    mp = sum(r["map_miss"] for r in records) / max(
        sum(r["map_total"] for r in records), 1)
    ok = [r for r in records if "dt_m" in r]
    tm, td = float(limits["reg_match_m"]), float(limits["reg_match_deg"])
    far = [r for r in ok if r["dt_m"] > tm or r["dr_deg"] > td]
    dts = sorted(r["dt_m"] for r in ok) or [0.0]
    return {
        "feat_miss": feat, "map_miss": mp,
        "reg_code_miss": sum(not r["stop_ok"] for r in records)
        / len(records),
        "reg_miss": len(far) / max(len(ok), 1),
        "carry_gap_m": max(r["carry_gap_m"] for r in records),
        "reg_gap_p50_m": float(np.median(dts)),
        "reg_gap_p90_m": float(np.quantile(dts, 0.9)),
        "reg_gap_max_m": dts[-1],
        "reg_gap_max_deg": max([r["dr_deg"] for r in ok] or [0.0]),
        "registrations": len(records), "registrations_ok": len(ok),
        "codes_differ": sum(r["code"] != r["ref_code"] for r in records),
    }


def kernel_gaps(calls: dict) -> dict:
    """Kept kernel calls (``{name: (args, kw, outputs)}``, see
    :mod:`benchlib.probe`) against the plain versions in float32 on the
    same inputs:

    * ``nn_miss``: the share of valid queries whose nearest squared
      distance differs from the brute-force one (the kernel promises the
      same bits);
    * ``pca_miss``: the share of queries whose neighbour count differs;
      ``pca_gap``: the largest gap of the query-centred second moments, a
      neighbour (m^2), over the queries whose counts agree;
    * ``moments_gap``: the largest gap of the neighbourhood sums, relative
      to the sum (at least 1)."""
    from mulls_ref.ops import kernels as K
    out = {}
    if "nn_grouped" in calls:
        args, _, res = calls["nn_grouped"]
        miss = total = 0
        for (q, qm, p, pm), (_, d2) in zip(args[0], res):
            _, d2p = K.nn(q, qm, p, pm)
            v = qm.bool()
            miss += int(((d2 != d2p) & v).sum())
            total += int(v.sum())
        out["nn_miss"] = miss / max(total, 1)
    if "pca_moments" in calls:
        (q, p, pm, r2), _, (cnt, _, s2) = calls["pca_moments"]
        c, _, a2 = K.pca_moments(q, p, pm, r2)
        out["pca_miss"] = float((cnt != c).float().mean())
        same = (cnt == c)[..., None]
        gap = torch.where(same, (s2 - a2).abs(), 0.0) \
            / c.clamp(min=1.0)[..., None]
        out["pca_gap"] = float(gap.max()) if gap.numel() else 0.0
    if "moments" in calls:
        args, kw, res = calls["moments"]
        close = args[5] if len(args) > 5 else kw.get("close_r2")
        plain = K.moments(*args[:5], close)
        gaps = [float(((r - pl).abs() / pl.abs().clamp(min=1.0)).max())
                for r, pl in zip(res, plain)
                if r is not None and r.numel()]
        out["moments_gap"] = max(gaps) if gaps else 0.0
    return out


def merge(parts: List[dict]) -> dict:
    """The worst of each number over the parts."""
    out = {}
    for p in parts:
        for k, v in p.items():
            out[k] = max(out.get(k, v), v)
    return out


def compared(limits: dict) -> list:
    """The numbers compared: those the limits give a ``limit``."""
    return [k for k, v in limits.items()
            if isinstance(v, dict) and "limit" in v]


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) for every number compared; a
    number that is missing fails."""
    checks, ok = {}, True
    for name in compared(limits):
        lim = float(limits[name]["limit"])
        val = numbers.get(name)
        checks[name] = {"value": val, "limit": lim}
        if val is None or not (val <= lim):
            ok = False
    return ok, checks
