"""The back end's state as plain numpy, and back.

:func:`backend_to_numpy` turns a :class:`SlamBackend` into nested dicts,
lists and numpy arrays (no tensors, no device buffers); a checkpoint
pickles that.  :func:`backend_from_numpy` builds a back end from such a
tree on a device and uploads the newest submaps into its bank.  A
reference ``mulls_tpu`` back end converted leaf by leaf to the same tree
(its submaps' clouds, descriptors, pose, frame span and span confidences,
its edges and its segmentation accumulators) gives the port the same
submaps, which is how the parity tests hand both packages one state.
"""

from __future__ import annotations

import numpy as np
import torch

from mulls_tpu_torch.backend.submap import Edge, SlamBackend, Submap
from mulls_tpu_torch.config import MullsConfig
from mulls_tpu_torch.core.cloud import FeatureCloud, VertexDescriptors

CLOUD_FIELDS = ("xyz", "normal", "intensity", "strength", "height",
                "ts_ratio", "mask")


def _np(x):
    return None if x is None else np.array(x)


def backend_to_numpy(backend: SlamBackend) -> dict:
    """The back end's host state: submaps (clouds copied from the bank),
    edges, decision log, cooling, segmentation accumulators, drift
    counter and the last optimized poses."""
    subs = []
    for s in backend.submaps:
        clouds, desc = s.clouds, s.descriptors
        subs.append({
            "sid": s.sid, "pose": np.array(s.pose),
            "frame_begin": s.frame_begin, "frame_end": s.frame_end,
            "stable": bool(s.stable),
            "span_min_conf": float(s.span_min_conf),
            "span_mean_conf": float(s.span_mean_conf),
            "center": _np(s.center), "local_bbx": _np(s.local_bbx),
            "bbx_min": _np(s._bbx_min), "bbx_max": _np(s._bbx_max),
            "clouds": {n: {f: getattr(c, f).cpu().numpy()
                           for f in CLOUD_FIELDS} for n, c in clouds.items()},
            "descriptors": {"vec": desc.vec.cpu().numpy(),
                            "mask": desc.mask.cpu().numpy()}})
    return {
        "submaps": subs,
        "edges": [{"i": e.i, "j": e.j, "T": np.array(e.T),
                   "info": np.array(e.info), "kind": int(e.kind),
                   "sigma": float(e.sigma), "confidence": float(e.confidence)}
                  for e in backend.edges],
        "events": list(backend.events),
        "cooling": int(backend.cooling),
        "accu": (backend._accu_tran, backend._accu_rot_deg,
                 backend._accu_frames),
        "span": (backend._span_min_conf, backend._span_conf_sum,
                 backend._span_conf_n),
        "frames_wo_opt": int(backend.frames_wo_opt),
        "optimized": _np(backend.optimized),
    }


def _cloud(d: dict) -> FeatureCloud:
    return FeatureCloud(**{
        f: torch.as_tensor(np.array(d[f]), dtype=(
            torch.bool if f == "mask" else torch.float32))
        for f in CLOUD_FIELDS})


def submaps_from_numpy(tree: dict) -> list:
    """Host-resident submaps (clouds and descriptors as CPU tensors, no
    bank slot) from :func:`backend_to_numpy`'s tree."""
    subs = []
    for d in tree["submaps"]:
        subs.append(Submap(
            sid=int(d["sid"]), pose=np.array(d["pose"], np.float64),
            clouds={n: _cloud(c) for n, c in d["clouds"].items()},
            descriptors=VertexDescriptors(
                vec=torch.as_tensor(np.array(d["descriptors"]["vec"]),
                                    dtype=torch.float32),
                mask=torch.as_tensor(np.array(d["descriptors"]["mask"]),
                                     dtype=torch.bool)),
            frame_begin=int(d["frame_begin"]), frame_end=int(d["frame_end"]),
            center=_np(d.get("center")), bbx_min=_np(d.get("bbx_min")),
            bbx_max=_np(d.get("bbx_max")),
            stable=bool(d.get("stable", False)),
            span_min_conf=float(d.get("span_min_conf", 1.0)),
            span_mean_conf=float(d.get("span_mean_conf", 1.0)),
            local_bbx=_np(d.get("local_bbx"))))
    return subs


def edges_from_numpy(tree: dict) -> list:
    """The pose-graph edges of :func:`backend_to_numpy`'s tree."""
    return [Edge(i=int(e["i"]), j=int(e["j"]),
                 T=np.array(e["T"], np.float64),
                 info=np.array(e["info"], np.float64),
                 kind=int(e["kind"]), sigma=float(e["sigma"]),
                 confidence=float(e["confidence"]))
            for e in tree.get("edges", [])]


def backend_from_numpy(tree: dict, cfg: MullsConfig, device="cuda"
                       ) -> SlamBackend:
    """A back end on ``device`` from :func:`backend_to_numpy`'s tree.
    Clouds arrive as host (CPU) tensors, and the newest
    ``submap_bank_capacity`` submaps are uploaded into the bank
    (``SlamBackend.rebuild_bank``), as a resumed run needs."""
    be = SlamBackend(cfg, device)
    be.submaps = submaps_from_numpy(tree)
    be.edges = edges_from_numpy(tree)
    be.events = list(tree.get("events", []))
    be.cooling = int(tree.get("cooling", 0))
    (be._accu_tran, be._accu_rot_deg, be._accu_frames) = tree.get(
        "accu", (0.0, 0.0, 0))
    (be._span_min_conf, be._span_conf_sum, be._span_conf_n) = tree.get(
        "span", (1.0, 0.0, 0))
    be.frames_wo_opt = int(tree.get("frames_wo_opt", 0))
    be.optimized = _np(tree.get("optimized"))
    be.rebuild_bank()
    return be
