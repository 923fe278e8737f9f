"""The label paths of the port's feature stage against the JAX package:
``extract_features`` with Semantic-KITTI labels and
``semantic_assist_on`` (the moving-object / outlier pre-filter, the
pillar / facade label gates, the ground label gate), one frame, the same
key replayed.

As ``tests/test_semantic.py`` does, the reference compiles this
extraction variant in a fresh interpreter (it has crashed XLA's compiler
inside a long-lived suite process); its clouds come back as an npz.

Tolerance: that of ``tests/test_torch_frontend.py`` — per-class valid
counts within 3 % (+2) and >= 99 % of the port's full-cloud points within
1 mm of the reference's (a few threshold points flip between the two
packages' distance and moment formulations), >= 95 % for the ~100 vertex
keypoints (NMS picks); no kept point carries a moving or outlier
label."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import __graft_entry__ as ge
from mulls_tpu_torch.frontend.features import extract_features as t_extract
from torch_parity import JaxKeyDraws, match_fraction, np_, raw_to_torch

KEY = 11
CLASSES = ("ground", "pillar", "facade", "beam", "roof", "vertex")

_REFERENCE = r"""
import sys
import numpy as np
import mulls_tpu  # noqa: F401  (honours JAX_PLATFORMS)
import jax
import jax.numpy as jnp
sys.path.insert(0, sys.argv[2])
import test_torch_semantic as t
from mulls_tpu.core.cloud import RawCloud
from mulls_tpu.frontend.features import extract_features
cfg, d = t.semantic_input()
raw = RawCloud(**{k: jnp.asarray(v) for k, v in d.items()})
f = jax.jit(extract_features, static_argnames=("cfg",))(
    raw, cfg, jax.random.key(t.KEY))
np.savez(sys.argv[1], **{f"{n}_{k}": np.asarray(getattr(f.full[n], k))
                         for n in t.CLASSES for k in ("xyz", "mask")})
"""


def semantic_input():
    """The small config with ``semantic_assist_on`` and one synthetic
    frame labelled from its geometry: ground road (40), walls building
    (50), the rest pole (80) or vegetation (70); 10 % moving-car (252) and
    2 % outlier (1) at random."""
    cfg = ge._small_cfg()
    cfg = dataclasses.replace(cfg, feature=dataclasses.replace(
        cfg.feature, semantic_assist_on=True))
    d = ge._synthetic_raw(cfg, seed=2)
    rng = np.random.default_rng(23)
    n = cfg.shapes.n_raw
    xyz = d["xyz"]
    label = np.where(xyz[:, 2] < -1.5, 40,
                     np.where(rng.uniform(size=n) < 0.5, 50,
                              np.where(rng.uniform(size=n) < 0.7, 80, 70)))
    u = rng.uniform(size=n)
    label = np.where(u < 0.10, 252, np.where(u < 0.12, 1, label))
    d["label"] = label.astype(np.int32)
    return cfg, d


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    out = tmp_path_factory.mktemp("semantic") / "reference.npz"
    p = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(out),
         os.path.dirname(os.path.abspath(__file__))],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=900)
    assert p.returncode == 0, (p.stdout or "")[-2000:] + (p.stderr
                                                        or "")[-2000:]
    ref = np.load(out)
    cfg, d = semantic_input()
    tf = t_extract(raw_to_torch(d), cfg, JaxKeyDraws(jax.random.key(KEY)))
    return d, ref, tf


@pytest.mark.parametrize("name", CLASSES)
def test_extract_features_with_labels_matches_reference(frames, name):
    d, ref, tf = frames
    jm, jx = ref[f"{name}_mask"], ref[f"{name}_xyz"]
    tc = tf.full[name]
    tm, tx = np_(tc.mask), np_(tc.xyz)
    assert abs(int(jm.sum()) - int(tm.sum())) <= 0.03 * jm.sum() + 2, \
        (name, int(jm.sum()), int(tm.sum()))
    # vertex keypoints are NMS picks among near-equal saliencies: one
    # flipped neighbour moves a pick (3 of ~100 here)
    assert match_fraction(tx[tm], jx[jm], 1e-3) >= (
        0.95 if name == "vertex" else 0.99)
    # no kept point is a moving or outlier point of the frame
    raw = d["xyz"][d["mask"]]
    lab = d["label"][d["mask"]]
    if tm.any():
        d2 = ((tx[tm][:, None, :] - raw[None, :, :]) ** 2).sum(-1)
        nearest = lab[d2.argmin(1)]
        assert not np.any((nearest >= 250) | (nearest == 1)), name
