"""Fixed-shape masked clouds — port of ``mulls_tpu/core/cloud.py``.

The reference's processing unit is a pointer-rich `cloudblock_t` holding six
variable-length feature clouds plus kd-trees (`utility.hpp:233-553`).  Here,
as in the JAX package, it is a dataclass of fixed-capacity struct-of-array
tensors with validity masks; every kernel treats masked slots as absent.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from mulls_ref.core.batch import rotate, take
from mulls_ref.core.tree import Struct, tree_map

# feature class order mirrors the reference's used_feature_type bitstring
# (ground, pillar, facade, beam, roof, vertex — `mulls_slam.cpp` comment)
FEATURE_NAMES = ("ground", "pillar", "facade", "beam", "roof", "vertex")


@dataclass
class RawCloud(Struct):
    """A raw (or pre-filtered) scan: [N, 3] xyz + per-point scalars."""

    xyz: torch.Tensor  # [N, 3] f32
    intensity: torch.Tensor  # [N] f32
    ts_ratio: torch.Tensor  # [N] f32, in-frame timestamp ratio
    mask: torch.Tensor  # [N] bool
    label: Optional[torch.Tensor] = None  # [N] int32 Semantic-KITTI class id

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @property
    def count(self) -> torch.Tensor:
        return torch.sum(self.mask, dim=-1)

    @staticmethod
    def from_numpy(data: dict, device) -> "RawCloud":
        """A padded host frame dict (``io.dataset.pad_cloud``) on ``device``."""
        t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,
                                          device=device)
        return RawCloud(
            xyz=t(data["xyz"], torch.float32),
            intensity=t(data["intensity"], torch.float32),
            ts_ratio=t(data["ts_ratio"], torch.float32),
            mask=t(data["mask"], torch.bool),
            label=(t(data["label"], torch.int32) if "label" in data
                   else None))


# Host->device wire format: scans travel quantized (9 B/point instead of
# 21): xyz as int16 fixed-point, intensity as uint8, timestamp ratio as
# uint16, and the validity mask as a single prefix count.  4 mm quantization
# is far below LiDAR range noise (~2 cm) and covers +/-131 m.
XYZ_SCALE = 250.0  # ticks per metre -> 4 mm resolution


@dataclass
class PackedRawCloud(Struct):
    """Quantized scan for cheap host->device transfer; decode on device."""

    xyz_q: torch.Tensor  # [N, 3] int16, metres * XYZ_SCALE
    intensity_q: torch.Tensor  # [N] uint8
    # uint16 ratio * 65535 (held in int32: torch has no uint16 arithmetic),
    # or None — timestamps are only shipped when
    # motion_compensation_method == 1 needs them
    ts_q: Optional[torch.Tensor]
    n: torch.Tensor  # [] int32 valid-point count (prefix is valid)
    label: Optional[torch.Tensor] = None  # [N] int32 semantic class id

    @property
    def capacity(self) -> int:
        return self.xyz_q.shape[-2]

    def to(self, device, non_blocking: bool = False) -> "PackedRawCloud":
        return tree_map(lambda a: a.to(device, non_blocking=non_blocking),
                        self)

    def pin_memory(self) -> "PackedRawCloud":
        return tree_map(lambda a: a.pin_memory(), self)


def pack_raw_host(data: dict, with_ts: bool = True) -> PackedRawCloud:
    """Pack a padded host frame dict (numpy arrays) into the wire format
    (host tensors).  ``with_ts=False`` drops the timestamp plane — correct
    whenever the run does not use per-point sensor timestamps."""
    xyz = np.clip(np.rint(data["xyz"] * XYZ_SCALE), -32767, 32767)
    return PackedRawCloud(
        xyz_q=torch.from_numpy(xyz.astype(np.int16)),
        intensity_q=torch.from_numpy(
            np.clip(np.rint(data["intensity"] * 255.0), 0, 255)
            .astype(np.uint8)),
        ts_q=(torch.from_numpy(
            np.clip(np.rint(data["ts_ratio"] * 65535.0), 0, 65535)
            .astype(np.int32)) if with_ts else None),
        n=torch.tensor(int(data["mask"].sum()), dtype=torch.int32),
        label=(torch.from_numpy(data["label"].astype(np.int32))
               if "label" in data else None),
    )


def unpack_raw(p: PackedRawCloud) -> RawCloud:
    """Device-side decode (the first stage of the per-frame step); a
    packed batch ``[S, N, ...]`` with counts ``n`` [S] decodes to a batch
    of clouds."""
    n = p.capacity
    dev = p.xyz_q.device
    mask = torch.arange(n, dtype=torch.int32, device=dev) < p.n[..., None]
    return RawCloud(
        xyz=p.xyz_q.to(torch.float32) * (1.0 / XYZ_SCALE),
        intensity=p.intensity_q.to(torch.float32) * (1.0 / 255.0),
        ts_ratio=(p.ts_q.to(torch.float32) * (1.0 / 65535.0)
                  if p.ts_q is not None
                  else torch.zeros(p.xyz_q.shape[:-1], dtype=torch.float32,
                                   device=dev)),
        mask=mask,
        label=(p.label.to(torch.int32) if p.label is not None else None),
    )


@dataclass
class FeatureCloud(Struct):
    """One feature class: points + direction vector + saliency.

    ``normal`` stores the plane normal for planar classes (ground, facade,
    roof) and the principal direction for linear classes (pillar, beam,
    vertex), exactly like the reference overloads the PCL normal fields
    (`pca.hpp:437-454`).  ``strength`` is the reference's `normal[3]`
    (planarity / linearity / 5*curvature), used as the NMS saliency.
    ``height`` is the reference's `data[3]` height-above-ground.
    """

    xyz: torch.Tensor  # [N, 3] f32
    normal: torch.Tensor  # [N, 3] f32
    intensity: torch.Tensor  # [N] f32
    strength: torch.Tensor  # [N] f32
    height: torch.Tensor  # [N] f32
    ts_ratio: torch.Tensor  # [N] f32
    mask: torch.Tensor  # [N] bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @property
    def count(self) -> torch.Tensor:
        return torch.sum(self.mask, dim=-1)

    @staticmethod
    def empty(n: int, device) -> "FeatureCloud":
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
        return FeatureCloud(
            xyz=z(n, 3), normal=z(n, 3), intensity=z(n), strength=z(n),
            height=z(n), ts_ratio=z(n),
            mask=torch.zeros((n,), dtype=torch.bool, device=device))

    def gather(self, idx: torch.Tensor, valid: torch.Tensor) -> "FeatureCloud":
        """Select rows by index (per batch entry: ``idx`` [..., K]) with a
        fresh validity mask."""
        return FeatureCloud(
            xyz=take(self.xyz, idx), normal=take(self.normal, idx),
            intensity=take(self.intensity, idx),
            strength=take(self.strength, idx),
            height=take(self.height, idx), ts_ratio=take(self.ts_ratio, idx),
            mask=valid & take(self.mask, idx))

    def transform(self, T: torch.Tensor,
                  rotate_normals: bool = True) -> "FeatureCloud":
        """``T`` [..., 4, 4] applied to the cloud [..., N]."""
        R = T[..., :3, :3]
        xyz = rotate(R, self.xyz) + T[..., None, :3, 3]
        normal = rotate(R, self.normal) if rotate_normals else self.normal
        return self.replace(xyz=xyz, normal=normal)

    def concat(self, other: "FeatureCloud") -> "FeatureCloud":
        """The two clouds' rows, along the point axis of each entry."""
        return tree_map(lambda a, b: torch.cat(
            [a, b], dim=self.mask.dim() - 1), self, other)


@dataclass
class VertexDescriptors(Struct):
    """NCC keypoint descriptors for the vertex cloud (reference
    `cfilter.hpp:1071-1181`): 8 neighborhood-category counts (close/far x
    pillar/beam/facade/roof) + normalized intensity + curvature + height,
    decoded to the 11-dim comparison vector of `cregistration.hpp:444-515`."""

    vec: torch.Tensor  # [N, 11] f32
    mask: torch.Tensor  # [N] bool

    @staticmethod
    def empty(n: int, device) -> "VertexDescriptors":
        return VertexDescriptors(
            vec=torch.zeros((n, 11), dtype=torch.float32, device=device),
            mask=torch.zeros((n,), dtype=torch.bool, device=device))


@dataclass
class FeatureFrame(Struct):
    """Per-frame feature set: 'full' clouds (map fodder / registration
    targets) + 'down' clouds (registration sources), the cloudblock_t
    equivalent (`utility.hpp:233-553`)."""

    full: Dict[str, FeatureCloud]
    down: Dict[str, FeatureCloud]
    descriptors: VertexDescriptors
    bbx_min: torch.Tensor  # [3]
    bbx_max: torch.Tensor  # [3]


# --- masked helpers ---------------------------------------------------------

_BIG = 1e30


def masked_min(x: torch.Tensor, mask: torch.Tensor, dim=None):
    v = torch.where(mask, x, _BIG)
    return torch.amin(v) if dim is None else torch.amin(v, dim=dim)


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim=None):
    v = torch.where(mask, x, -_BIG)
    return torch.amax(v) if dim is None else torch.amax(v, dim=dim)


def top_k_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last axis, ties to
    the lower index — ``lax.top_k``'s order (``torch.topk`` promises no tie
    order)."""
    return torch.sort(score, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def compact_topk_random(mask: torch.Tensor, k: int, u: torch.Tensor,
                        prefer: Optional[torch.Tensor] = None):
    """Pick up to ``k`` valid rows uniformly at random (the equivalent of
    the reference's `random_downsample_pcl` fixed-num path,
    `cfilter.hpp:606-754`).  ``u`` is the uniform draw of ``mask``'s shape
    (``draws.uniform(mask.shape)``; the reference draws it here,
    `core/cloud.py:247`).  Returns (indices [k], valid [k]).

    ``prefer`` (optional, same shape as mask, >=0) biases selection:
    rows with larger values win ties deterministically.
    """
    score = u if prefer is None else u + prefer
    score = torch.where(mask, score, -_BIG)
    idx = top_k_indices(score, k)
    return idx, take(mask, idx)


def compact_topk_score(mask: torch.Tensor, score: torch.Tensor, k: int):
    """Pick the top-k valid rows by score. Returns (indices [k], valid [k])."""
    s = torch.where(mask, score, -_BIG)
    idx = top_k_indices(s, k)
    return idx, take(mask, idx)
