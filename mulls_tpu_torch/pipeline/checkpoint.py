"""Mid-run checkpoint / resume — port of
``mulls_tpu/pipeline/checkpoint.py``.

A checkpoint captures the whole session: the front end's state (local
map, pose, motion model) with every tensor stored as numpy, the back end
(submaps with their clouds, edges, cooling and accumulators, as
``backend/convert.py`` writes them) and the trajectory so far, as one
pickle written atomically.  The state of both random streams is stored
when the streams can give it (``Draws.get_state``), so a resumed run
continues with the draws the uninterrupted run would have made; the
reference restores its front-end key and restarts its back-end key.  On
resume the back end's bank is rebuilt from the restored clouds.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
from typing import Optional

import numpy as np
import torch


def _state_to_numpy(obj):
    """A ``SlamState`` as nested dicts of numpy arrays, without its draws."""
    if obj is None:
        return None
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj):
        return {f.name: _state_to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if f.name != "draws"}
    if isinstance(obj, dict):
        return {k: _state_to_numpy(v) for k, v in obj.items()}
    return obj


def _draws_state(draws):
    get = getattr(draws, "get_state", None)
    return get() if get is not None else None


def save_checkpoint(path: str, state, frame_idx: int, poses: np.ndarray,
                    poses_odom: np.ndarray, codes, sigmas, backend=None,
                    backend_draws=None) -> None:
    from mulls_tpu_torch.backend.convert import backend_to_numpy
    payload = {
        "version": 1,
        "frame_idx": int(frame_idx),
        "state": _state_to_numpy(state),
        "draws": _draws_state(state.draws),
        "poses": np.asarray(poses),
        "poses_odom": np.asarray(poses_odom),
        "codes": list(codes),
        "sigmas": list(sigmas),
    }
    if backend is not None:
        payload["backend"] = backend_to_numpy(backend)
        payload["backend_draws"] = _draws_state(backend_draws)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)  # atomic
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, cfg, device="cuda", draws=None,
                    backend_draws=None) -> Optional[dict]:
    """The payload with ``state`` rebuilt on ``device`` (its draws are
    ``draws``, moved to the stored stream state where one was stored) and
    ``backend`` rebuilt as a ``SlamBackend`` with its bank (or None), or
    None when there is no checkpoint.  ``backend_draws``, when given, is
    moved to the stored back-end stream state."""
    from mulls_tpu_torch.backend.convert import backend_from_numpy
    from mulls_tpu_torch.pipeline.odometry import state_from_numpy
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        payload = pickle.load(f)
    state = state_from_numpy(payload["state"], cfg, device, draws=draws)
    if payload.get("draws") is not None and hasattr(state.draws,
                                                    "set_state"):
        state.draws.set_state(payload["draws"])
    payload["state"] = state
    if payload.get("backend") is not None:
        payload["backend"] = backend_from_numpy(payload["backend"], cfg,
                                                device)
        if (backend_draws is not None
                and payload.get("backend_draws") is not None):
            backend_draws.set_state(payload["backend_draws"])
    return payload
