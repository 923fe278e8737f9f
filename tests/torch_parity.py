"""Helpers shared by the parity tests of the PyTorch port
(``tests/test_torch_*.py``): the JAX key tree replayed as the port's
``Draws``, and conversions between the two packages' clouds and states.
Data crosses between JAX and PyTorch as numpy arrays."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mulls_tpu_torch.core.cloud import (FeatureCloud, FeatureFrame, RawCloud,
                                        VertexDescriptors)

CLOUD_FIELDS = ("xyz", "normal", "intensity", "strength", "height",
                "ts_ratio", "mask")


class JaxKeyDraws:
    """``Draws`` that replays a ``jax.random`` key tree: ``split`` splits
    the key, ``uniform`` / ``bits`` draw exactly what the reference draws
    from the same key, so both packages see the same numbers."""

    def __init__(self, key):
        self.key = key

    def split(self, n: int):
        return [JaxKeyDraws(k) for k in jax.random.split(self.key, n)]

    def uniform(self, shape):
        return torch.from_numpy(np.array(
            jax.random.uniform(self.key, tuple(shape))))

    def bits(self, shape):
        return torch.from_numpy(np.array(
            jax.random.bits(self.key, tuple(shape), jnp.uint32)
        ).astype(np.int64))


def np_(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t_(x, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(x)) if dtype is None else \
        torch.from_numpy(np.array(x)).to(dtype)


def raw_to_torch(d: dict) -> RawCloud:
    return RawCloud.from_numpy(d, "cpu")


def cloud_to_torch(c) -> FeatureCloud:
    return FeatureCloud(**{f: t_(getattr(c, f)) for f in CLOUD_FIELDS})


def frame_to_torch(frame) -> FeatureFrame:
    return FeatureFrame(
        full={k: cloud_to_torch(c) for k, c in frame.full.items()},
        down={k: cloud_to_torch(c) for k, c in frame.down.items()},
        descriptors=VertexDescriptors(vec=t_(frame.descriptors.vec),
                                      mask=t_(frame.descriptors.mask)),
        bbx_min=t_(frame.bbx_min), bbx_max=t_(frame.bbx_max))


def state_to_numpy(obj):
    """A reference ``SlamState`` (flax dataclasses) as nested dicts of numpy
    arrays, leaf by leaf; the PRNG key is dropped."""
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return {f.name: state_to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if f.name != "key"}
    if isinstance(obj, dict):
        return {k: state_to_numpy(v) for k, v in obj.items()}
    return np.asarray(obj)


def backend_tree(backend) -> dict:
    """A reference ``SlamBackend`` as the numpy tree of
    ``mulls_tpu_torch.backend.convert.backend_to_numpy``: each submap's
    clouds, descriptors, pose, frame span, bounds and span confidences;
    the edges; the segmentation accumulators."""
    subs = []
    for s in backend.submaps:
        clouds = jax.device_get(s.clouds)
        desc = jax.device_get(s.descriptors)
        subs.append({
            "sid": s.sid, "pose": np.array(s.pose),
            "frame_begin": s.frame_begin, "frame_end": s.frame_end,
            "stable": bool(s.stable), "span_min_conf": s.span_min_conf,
            "span_mean_conf": s.span_mean_conf,
            "center": np.array(s.center), "local_bbx": s.local_bbx,
            "bbx_min": s._bbx_min, "bbx_max": s._bbx_max,
            "clouds": {n: {f: np.array(getattr(c, f)) for f in CLOUD_FIELDS}
                       for n, c in clouds.items()},
            "descriptors": {"vec": np.array(desc.vec),
                            "mask": np.array(desc.mask)}})
    return {
        "submaps": subs,
        "edges": [{"i": e.i, "j": e.j, "T": np.array(e.T),
                   "info": np.array(e.info), "kind": e.kind,
                   "sigma": e.sigma, "confidence": e.confidence}
                  for e in backend.edges],
        "events": list(backend.events), "cooling": backend.cooling,
        "accu": (backend._accu_tran, backend._accu_rot_deg,
                 backend._accu_frames),
        "span": (backend._span_min_conf, backend._span_conf_sum,
                 backend._span_conf_n),
        "frames_wo_opt": backend.frames_wo_opt,
        "optimized": backend.optimized}


def match_fraction(a: np.ndarray, b: np.ndarray, tol: float) -> float:
    """Fraction of the rows of ``a`` with a row of ``b`` within ``tol``."""
    if len(a) == 0:
        return 1.0 if len(b) == 0 else 0.0
    if len(b) == 0:
        return 0.0
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return float(np.mean(d2.min(1) <= tol * tol))
