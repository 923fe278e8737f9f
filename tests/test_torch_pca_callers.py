"""Parity of the two callers of ``pca_moments`` that no other test holds to
the JAX package: the periodic map refresh (``refresh_linear_map_vectors``)
on pillar and beam clouds filled to their default capacities, and
distance-adaptive ``pca_features`` (a radius for each query).

Same inputs (numpy, seeded) through both packages on the CPU.  The port
centres the moments at each query and forms d^2 as (q - p)^2; the
reference's CPU path sums uncentred f32 moments and expands
|q|^2 + |p|^2 - 2 q.p.  So a few points on a radius or a threshold differ
between the two; each tolerance below says how many and why."""

import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as ge
from mulls_tpu.config import MapConfig
from mulls_tpu.core.cloud import FeatureCloud as JCloud
from mulls_tpu.mapping import local_map as jlm
from mulls_tpu.ops import pca as jpca
from mulls_tpu_torch.core.cloud import FeatureCloud as TCloud
from mulls_tpu_torch.mapping import local_map as tlm
from mulls_tpu_torch.ops import pca as tpca
from torch_parity import CLOUD_FIELDS, np_


def _linear_map_cloud(rng, n, kind):
    """``n`` rows of a map's pillar or beam cloud within 50 m: 16-point
    poles (vertical, 4 m) or bars (horizontal, 4 m) with 2 cm noise, a
    tenth of the rows scattered clutter, 4 % of the rows masked."""
    n_lines = (n - n // 10) // 16
    c = rng.uniform(-50, 50, (n_lines, 3)) * np.array([1.0, 1.0, 0.0])
    if kind == "pillar":
        d = np.tile([0.0, 0.0, 1.0], (n_lines, 1))
    else:
        a = rng.uniform(0, np.pi, n_lines)
        d = np.stack([np.cos(a), np.sin(a), np.zeros(n_lines)], 1)
    t = rng.uniform(-2, 2, (n_lines, 16))
    pts = (c[:, None, :] + t[..., None] * d[:, None, :]).reshape(-1, 3)
    pts = pts + 0.02 * rng.normal(size=pts.shape)
    clutter = rng.uniform(-50, 50, (n - len(pts), 3))
    xyz = np.concatenate([pts, clutter]).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return {"xyz": xyz, "normal": nrm,
            "intensity": rng.uniform(0, 255, n).astype(np.float32),
            "strength": rng.uniform(size=n).astype(np.float32),
            "height": rng.uniform(0, 3, n).astype(np.float32),
            "ts_ratio": rng.uniform(size=n).astype(np.float32),
            "mask": rng.uniform(size=n) >= 0.04}


def test_refresh_linear_map_vectors_matches_reference():
    caps = MapConfig().shapes
    rng = np.random.default_rng(31)
    clouds = {name: _linear_map_cloud(rng, caps.capacity(name), name)
              for name in ("pillar", "beam")}
    jm = jlm.init_local_map(MapConfig())
    jm = jlm.LocalMap(clouds={**jm.clouds, **{
        k: JCloud(**{f: jnp.asarray(v[f]) for f in CLOUD_FIELDS})
        for k, v in clouds.items()}}, vertex_desc=jm.vertex_desc)
    tm = tlm.init_local_map(MapConfig(), "cpu")
    tm = tlm.LocalMap(clouds={**tm.clouds, **{
        k: TCloud(**{f: torch.from_numpy(v[f]) for f in CLOUD_FIELDS})
        for k, v in clouds.items()}}, vertex_desc=tm.vertex_desc)
    jr = jlm.refresh_linear_map_vectors(jm)
    tr = tlm.refresh_linear_map_vectors(tm)
    for name, cap in (("pillar", caps.pillar), ("beam", caps.beam)):
        jc, tc = jr.clouds[name], tr.clouds[name]
        jk, tk = np.asarray(jc.mask), np_(tc.mask)
        # the lines survive, the clutter goes: most rows stay on both sides
        assert 0.6 * cap < jk.sum() < 0.95 * cap, (name, jk.sum())
        # kept masks: a row on a threshold (linearity 0.65, the direction
        # gate, the 6-point count) may flip between uncentred and centred
        # f32 moments; at most 0.5 % of the rows here
        assert np.sum(jk != tk) <= 0.005 * cap, (name, np.sum(jk != tk))
        both = jk & tk
        # directions of the kept rows agree up to sign: on 4 m lines with
        # 2 cm noise the principal axis is well separated, so the two f32
        # formulations agree to ~1e-4
        dots = np.abs(np.sum(np_(tc.normal)[both]
                             * np.asarray(jc.normal)[both], -1))
        assert np.all(dots > 1 - 1e-3), (name, dots.min())
        # linearity (the strength) of the kept rows.  The reference's
        # uncentred f32 sums round the covariance by ~|p|^2 x 1e-7: ~2e-4
        # m^2 within 50 m, ~5e-4 m^2 at 60 m, where the 1.8 m neighbourhood
        # at a line's end has lambda_1 of only ~0.3 m^2 (measured: 1.6e-3
        # within 50 m, 9.8e-3 at 61 m)
        near = both & (np.linalg.norm(clouds[name]["xyz"], axis=1) < 50.0)
        np.testing.assert_allclose(np_(tc.strength)[near],
                                   np.asarray(jc.strength)[near], atol=3e-3)
        np.testing.assert_allclose(np_(tc.strength)[both],
                                   np.asarray(jc.strength)[both], atol=2e-2)
        # rows that neither side keeps are left as they were
        gone = ~jk & ~tk
        np.testing.assert_array_equal(np_(tc.normal)[gone],
                                      clouds[name]["normal"][gone])
    for name in ("ground", "facade", "roof", "vertex"):
        np.testing.assert_array_equal(np_(tr.clouds[name].mask),
                                      np.asarray(jr.clouds[name].mask))


def test_distance_adaptive_pca_features_matches_reference():
    cfg = ge._small_cfg()
    d = ge._synthetic_raw(cfg, seed=2)
    valid = np.where(d["mask"])[0]
    sel = np.random.default_rng(32).choice(valid, 8000, replace=False)
    p = d["xyz"][sel]
    q = p[:2000]
    qm = np.random.default_rng(33).uniform(size=2000) < 0.95
    pm = np.ones(len(p), bool)
    kw = dict(radius=1.0, min_k=7, distance_adaptive=True, unit_dist=10.0)
    j = jpca.pca_features(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(p),
                          jnp.asarray(pm), **kw)
    t = tpca.pca_features(*[torch.from_numpy(x) for x in (q, qm, p, pm)],
                          **kw)
    # the radius grows with range (x 1.4 at 20 m, x 1.7 at 30 m): far
    # queries see more support than a fixed 1 m would give them
    rng_q = np.linalg.norm(q, axis=1)
    far = qm & (rng_q > 20.0)
    assert far.sum() > 100
    fixed = tpca.pca_features(*[torch.from_numpy(x) for x in (q, qm, p, pm)],
                              radius=1.0, min_k=7)
    assert np.all(np_(t.count)[far] >= np_(fixed.count)[far])
    assert np.mean(np_(t.count)[far] > np_(fixed.count)[far]) > 0.5
    # counts: the reference's expanded d2 may move a boundary point by one
    cnt_diff = np.abs(np_(t.count) - np.asarray(j.count))
    assert np.mean(cnt_diff == 0) > 0.99 and cnt_diff.max() <= 2
    np.testing.assert_array_equal(np_(t.count)[~qm], 0)
    both = np_(t.valid) & np.asarray(j.valid) & (cnt_diff == 0)
    assert both.sum() > 1000
    # uncentred f32 moments on the reference's side (~1e-4 m^2 at 30 m):
    # eigenvalues within 2e-3 m^2
    np.testing.assert_allclose(np_(t.eigvals)[both],
                               np.asarray(j.eigvals)[both], atol=2e-3)
    # planar points: normals agree up to sign
    planar = both & (np.asarray(j.planarity) > 0.62)
    dots = np.abs(np.sum(np_(t.normal)[planar]
                         * np.asarray(j.normal)[planar], -1))
    assert planar.sum() > 100 and np.mean(dots > 0.99) > 0.98
