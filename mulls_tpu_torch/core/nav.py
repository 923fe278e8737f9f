"""Navigation helpers — reference `src/common_nav.cpp` + `include/nav/`; a
copy of ``mulls_tpu/core/nav.py`` (numpy only, so the port keeps its own).

* :func:`zupt_treatment` — zero-velocity update: lock z (and optionally
  roll/pitch) when the platform is (near) stationary
  (`common_nav.cpp:6-22`).
* :func:`estimate_velocity` — sliding 2 s-window speed estimate used for
  the dynamic-removal gate and logging (`common_nav.cpp:24-55`).
* :func:`tran_rot_magnitude` — translation / rotation magnitudes of a
  relative transform (`common_nav.cpp:57-90`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def zupt_treatment(T_rel: np.ndarray, tran_thre: float = 0.02,
                   lock_attitude: bool = False) -> np.ndarray:
    """If the frame-to-frame translation is below ``tran_thre`` the
    platform is treated as stationary: z-translation is zeroed (full
    attitude optionally locked)."""
    out = np.asarray(T_rel, np.float64).copy()
    if np.linalg.norm(out[:3, 3]) < tran_thre:
        out[2, 3] = 0.0
        if lock_attitude:
            out[:3, :3] = np.eye(3)
    return out


def estimate_velocity(poses: np.ndarray, frame_idx: int,
                      frame_per_second: float = 10.0,
                      window_s: float = 2.0) -> float:
    """Mean speed (m/s) over the trailing ``window_s`` seconds
    (`common_nav.cpp:24-55`; 10 Hz assumed like `common_nav.h:20`)."""
    k = int(window_s * frame_per_second)
    lo = max(frame_idx - k, 0)
    if frame_idx <= lo:
        return 0.0
    seg = poses[lo:frame_idx + 1, :3, 3]
    dist = float(np.linalg.norm(np.diff(seg, axis=0), axis=1).sum())
    return dist * frame_per_second / (frame_idx - lo)


def tran_rot_magnitude(T: np.ndarray) -> Tuple[float, float]:
    """(translation [m], rotation [deg]) of a relative transform."""
    t = float(np.linalg.norm(T[:3, 3]))
    c = np.clip((np.trace(T[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
    return t, float(np.degrees(np.arccos(c)))
