"""The drives: synthetic LiDAR sequences made on the device from a seed.

One general generator, read by every traffic mix (``traffic/<mix>.json``):
each sequence of a configuration gets a world (a city block driven round a
rounded-rectangle loop, or a sparse open highway), a trajectory at the
mix's pace, and one scan a frame, simulated as the synthetic accuracy
bench's ``simulate`` does it: the world in the sensor's frame, cropped to
the sensor's range, ``n_raw`` points drawn from what is in range, Gaussian
noise, an intensity from the world's coordinates.  The geometry is that of
the bench's numpy worlds (``build_world``, ``build_world_highway``,
``loop_trajectory``, ``highway_trajectory``); the draws come from one
``torch.Generator`` on the device, in a few large calls, so a run's
~3,000 scans take seconds.

Each drive (:class:`Drive`) is handed over as the fleet CLI's native
KITTI reader hands a sequence to the program's feed: ``packed_segments``
gives a segment of frames at a time, already quantized to the wire format
(``xyz_q`` int16, ``intensity_q`` uint8, ``ts_q`` uint16, ``n`` int32, as
``io/native.py``'s packed prefetcher gives them), from host memory, so the
feed's pinning and upload stay in the timed path.  Indexed, a drive gives
the host frame that was quantized, a dict of ``xyz`` [n_raw, 3] float32,
``intensity`` [n_raw] float32 in [0, 1) (a KITTI .bin's reflectance),
``ts_ratio`` and ``mask`` [n_raw] (the valid points first): what the plain
reference reads.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from mulls_ref.core.cloud import XYZ_SCALE

WORLDS = ("urban", "highway")


def sequence_seed(seed: int, s: int, salt: int = 0) -> int:
    """A 63-bit seed for sequence ``s`` of a run seeded with ``seed``."""
    return (int(seed) * 1_000_003 + 7919 * int(s) + salt) % (1 << 63)


class _Draw:
    """Uniform and normal draws of one generator on one device."""

    def __init__(self, seed: int, device: torch.device):
        self.dev = device
        self.g = torch.Generator(device=device)
        self.g.manual_seed(seed)

    def u(self, lo, hi, *shape) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(shape, generator=self.g,
                                           device=self.dev)

    def n(self, *shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.g, device=self.dev)

    def sign(self, *shape) -> torch.Tensor:
        return torch.where(self.u(0.0, 1.0, *shape) < 0.5, -1.0, 1.0)


def _steps(d: _Draw, start, lo: float, hi: float, end: float, n: int):
    """Positions ``start + cumsum(U(lo, hi))`` below ``end`` (``n`` draws
    cover it): the irregular spacing of posts along a road, [..., n] with a
    mask of those in range."""
    x = start[..., None] + torch.cumsum(d.u(lo, hi, *start.shape, n), -1)
    return x, x < end


def build_urban(d: _Draw, half: float = 120.0) -> torch.Tensor:
    """City block: ground plane, building walls on a 60 m street grid with a
    piecewise depth profile per facade, lampposts at irregular spacing,
    parked-car boxes at the curbs (``build_world``'s geometry)."""
    parts = []
    n_g = 900_000
    parts.append(torch.stack([d.u(-half, half, n_g), d.u(-half, half, n_g),
                              0.04 * d.n(n_g) - 1.73], -1))
    # nine buildings, 22 m half width, 4-14 m tall, 26,000 points each
    c = torch.tensor([-60.0, 0.0, 60.0], device=d.dev)
    cx, cy = [a.reshape(9, 1) for a in torch.meshgrid(c, c, indexing="ij")]
    w, n_w = 22.0, 26_000
    h = d.u(4.0, 14.0, 9, 1)
    side = torch.floor(d.u(0.0, 4.0, 9, n_w)).clamp(max=3).long()
    u = d.u(-w, w, 9, n_w)
    prof = d.u(-1.2, 1.2, 9, 4, 11)
    seg = ((u + w) / (2 * w) * 11).long().clamp(0, 10)
    depth = w + prof[torch.arange(9, device=d.dev)[:, None], side, seg] \
        + 0.03 * d.n(9, n_w)
    wx = cx + torch.where(side == 0, depth,
                          torch.where(side == 1, -depth, u))
    wy = cy + torch.where(side < 2, u, torch.where(side == 2, depth, -depth))
    wz = -1.5 + (h + 1.5) * d.u(0.0, 1.0, 9, n_w)
    parts.append(torch.stack([wx, wy, wz], -1).reshape(-1, 3))
    # lampposts: along four lanes, 7-14 m apart, two posts a step
    lanes = torch.tensor([-31.0, -29.0, 29.0, 31.0], device=d.dev)
    x0 = -half + d.u(2.0, 8.0, 4, 1)
    gaps = d.u(7.0, 14.0, 4, 39)
    x = x0 + torch.cat([torch.zeros_like(x0), torch.cumsum(gaps, -1)], -1)
    ok = x < half
    first = torch.stack([x + d.u(-0.8, 0.8, 4, 40),
                         lanes[:, None] + d.u(-0.6, 0.6, 4, 40)], -1)
    second = torch.stack([lanes[:, None] + d.u(-0.6, 0.6, 4, 40),
                          x + d.u(-0.8, 0.8, 4, 40)], -1)
    posts = torch.cat([first, second], 1)[torch.cat([ok, ok], 1)]  # [P, 2]
    per = 90
    z = torch.linspace(-1.6, 4.2, per, device=d.dev)
    n_p = posts.shape[0]
    parts.append(torch.stack([
        posts[:, None, 0] + 0.015 * d.n(n_p, per),
        posts[:, None, 1] + 0.015 * d.n(n_p, per),
        z.expand(n_p, per)], -1).reshape(-1, 3))
    # parked cars: 60 boxes at the curbs, 700 points each
    n_c, n_b = 60, 700
    lane = 33.5 * d.sign(n_c, 1)
    along = d.u(-half + 5, half - 5, n_c, 1)
    swap = d.u(0.0, 1.0, n_c, 1) < 0.5
    bx = torch.where(swap, along, lane)
    by = torch.where(swap, lane, along)
    parts.append(torch.stack([bx + d.u(-2.2, 2.2, n_c, n_b),
                              by + d.u(-0.9, 0.9, n_c, n_b),
                              d.u(-1.7, -0.2, n_c, n_b)], -1).reshape(-1, 3))
    return torch.cat(parts).contiguous()


def build_highway(d: _Draw, length: float = 1100.0) -> torch.Tensor:
    """Sparse open highway along +x: crowned road, embankments, two
    guardrails a shoulder, delineator posts, sign gantries, roadside trees
    (``build_world_highway``'s geometry)."""
    parts = []
    n_r = 700_000
    y = d.u(-6.5, 6.5, n_r)
    parts.append(torch.stack([d.u(-20.0, length, n_r), y,
                              -1.73 - 0.01 * y.abs() + 0.03 * d.n(n_r)], -1))
    n_e = 250_000
    off = d.u(6.5, 20.0, n_e)
    parts.append(torch.stack([
        d.u(-20.0, length, n_e), d.sign(n_e) * off,
        -1.73 - 0.18 * (off - 6.5) + 0.05 * d.n(n_e)], -1))
    n_gr = 60_000
    for lane in (-7.2, 7.2):
        for z0 in (-1.0, -0.55):
            parts.append(torch.stack([
                d.u(-20.0, length, n_gr), lane + 0.02 * d.n(n_gr),
                z0 + 0.02 * d.n(n_gr)], -1))
    # delineator posts every 18-45 m on both shoulders, 60 points each
    zero = torch.zeros((), device=d.dev)
    x, ok = _steps(d, zero, 18.0, 45.0, length, 70)
    xs = x[_prev_ok(ok)]
    per = 60
    z = torch.linspace(-1.7, 0.6, per, device=d.dev)
    for lane in (-7.4, 7.4):
        k = xs.shape[0]
        parts.append(torch.stack([
            xs[:, None] + 0.01 * d.n(k, per), lane + 0.01 * d.n(k, per),
            z.expand(k, per)], -1).reshape(-1, 3))
    # gantries every 120-260 m: two 6 m pillars, a crossbeam, a sign panel
    x, ok = _steps(d, zero, 120.0, 260.0, length, 12)
    gx = x[_prev_ok(ok)]
    k = gx.shape[0]
    z = torch.linspace(-1.7, 5.0, 140, device=d.dev)
    for lane in (-8.0, 8.0):
        parts.append(torch.stack([
            gx[:, None] + 0.02 * d.n(k, 140), lane + 0.02 * d.n(k, 140),
            z.expand(k, 140)], -1).reshape(-1, 3))
    parts.append(torch.stack([
        gx[:, None] + 0.02 * d.n(k, 300), d.u(-8.0, 8.0, k, 300),
        5.0 + 0.03 * d.n(k, 300)], -1).reshape(-1, 3))
    parts.append(torch.stack([
        gx[:, None] + 0.03 * d.n(k, 500), d.u(-4.0, 4.0, k, 500),
        d.u(3.2, 5.0, k, 500)], -1).reshape(-1, 3))
    # roadside trees: one every 12 m of road, 250 points each
    n_t, per = int(length / 12), 250
    tx = d.u(0.0, length, n_t, 1)
    ty = d.sign(n_t, 1) * d.u(10.0, 25.0, n_t, 1)
    top = d.u(0.5, 4.0, n_t, 1)
    parts.append(torch.stack([
        tx + 0.8 * d.n(n_t, per), ty + 0.8 * d.n(n_t, per),
        -1.6 + (top + 1.6) * d.u(0.0, 1.0, n_t, per)], -1).reshape(-1, 3))
    return torch.cat(parts).contiguous()


def _prev_ok(ok: torch.Tensor) -> torch.Tensor:
    """A step is taken while the position before it is in range (the
    bench's ``while x < end: x += step; place``): the first always."""
    return torch.cat([torch.ones_like(ok[..., :1]), ok[..., :-1]], -1)


def loop_poses(n: int, step: float, start: float,
               corner_step: Optional[float] = None) -> np.ndarray:
    """[n, 4, 4] poses round the centre block's rounded-rectangle loop
    (30 m half side, 8 m corner radius) from arc length ``start``, ``step``
    metres a frame on the straights and ``corner_step`` (default ``step``)
    on the corners' arcs, a frame that crosses from one to the other
    moving at each pace for its share of the frame (``loop_trajectory``)."""
    L, r = 30.0, 8.0
    straight, arc = 2 * (L - r), 0.5 * math.pi * r
    total = 4 * (straight + arc)
    corner_step = step if corner_step is None else corner_step
    out = np.tile(np.eye(4), (n, 1, 1))
    pos = start
    for k in range(n):
        sd = pos % total
        edge = int(sd // (straight + arc))
        f = sd - edge * (straight + arc)
        if f <= straight:
            dd = f - (L - r)
            x, y, yaw = [(dd, -L, 0.0), (L, dd, math.pi / 2),
                         (-dd, L, math.pi), (-L, -dd, -math.pi / 2)][edge]
        else:
            a = (f - straight) / r
            base = edge * math.pi / 2
            cx, cy = [(L - r, -L + r), (L - r, L - r), (-L + r, L - r),
                      (-L + r, -L + r)][edge]
            ang = base - math.pi / 2 + a
            x, y, yaw = cx + r * math.cos(ang), cy + r * math.sin(ang), \
                base + a
        c, s = math.cos(yaw), math.sin(yaw)
        out[k, :2, :2] = [[c, -s], [s, c]]
        out[k, :3, 3] = [x, y, 0.0]
        if corner_step == step:
            pos = start + (k + 1) * step
            continue
        left = 1.0  # the share of the frame still to drive
        for _ in range(8):
            f = pos % total % (straight + arc)
            on_arc = f >= straight
            to_end = (straight + arc - f) if on_arc else (straight - f)
            pace = corner_step if on_arc else step
            if pace * left <= to_end:
                pos += pace * left
                break
            pos += to_end
            left -= to_end / pace
    return out


def highway_poses(n: int, step: float, start: float) -> np.ndarray:
    """[n, 4, 4] poses along the highway from ``x = start``, ``step`` metres
    a frame, with a gentle lane drift (``highway_trajectory``)."""
    out = np.tile(np.eye(4), (n, 1, 1))
    for k in range(n):
        x = start + k * step
        y = 1.8 * math.sin(2 * math.pi * x / 400.0)
        yaw = math.atan2(1.8 * 2 * math.pi / 400.0
                         * math.cos(2 * math.pi * x / 400.0), 1.0)
        c, s = math.cos(yaw), math.sin(yaw)
        out[k, :2, :2] = [[c, -s], [s, c]]
        out[k, :3, 3] = [x, y, 0.0]
    return out


def simulate(world: torch.Tensor, pose: np.ndarray, n_raw: int, d: _Draw,
             sensor_range: float, min_range: float, noise: float) -> tuple:
    """One scan on the device: (xyz [n_raw, 3], intensity [n_raw], valid
    count as a 0-d tensor); the valid points first, in random order."""
    R = torch.as_tensor(pose[:3, :3], dtype=torch.float32, device=d.dev)
    t = torch.as_tensor(pose[:3, 3], dtype=torch.float32, device=d.dev)
    local = (world - t) @ R
    r = torch.linalg.vector_norm(local[:, :2], dim=-1)
    keep = (r < sensor_range) & (r > min_range)
    key = torch.where(keep, torch.rand(world.shape[0], generator=d.g,
                                       device=d.dev), 2.0)
    order = torch.argsort(key)[:n_raw]
    valid = keep[order]
    pts = local[order] + noise * d.n(order.shape[0], 3)
    w = world[order]
    inten = torch.abs(torch.sin(0.7 * w[:, 0]) + torch.cos(1.3 * w[:, 1])) \
        * (120.0 / 255.0)
    pts = torch.where(valid[:, None], pts, 0.0)
    inten = torch.where(valid, inten, 0.0)
    if order.shape[0] < n_raw:  # a world smaller than a scan
        pad = n_raw - order.shape[0]
        pts = torch.cat([pts, pts.new_zeros(pad, 3)])
        inten = torch.cat([inten, inten.new_zeros(pad)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return pts, inten, valid


def world_of(traffic: dict, sequence: str) -> str:
    """The world a mix gives a sequence (by its name in the
    configuration): ``sequence_world`` names it, else ``default_world``."""
    name = traffic.get("sequence_world", {}).get(
        sequence, traffic["default_world"])
    if name not in WORLDS:
        raise ValueError(f"world {name!r}: one of {WORLDS}")
    return name


class Drive:
    """One sequence's drive: ``len``, indexing and iteration give its host
    frames (see the module note); ``packed_segments`` hands the same frames
    over quantized, a segment at a time."""

    def __init__(self, frames: list, xyz_q: np.ndarray,
                 intensity_q: np.ndarray, n: np.ndarray):
        self.frames = frames
        self.xyz_q, self.intensity_q, self.n = xyz_q, intensity_q, n

    def __len__(self) -> int:
        return len(self.frames)

    def __getitem__(self, k):
        return self.frames[k]

    def __iter__(self):
        return iter(self.frames)

    def packed_segments(self, segment: int) -> "PackedSegments":
        return PackedSegments(self, segment)


class PackedSegments:
    """``packed_segments``' iterator, as the native reader's: (frames in
    the batch, {``xyz_q`` [segment, n_raw, 3] int16, ``intensity_q``
    [segment, n_raw] uint8, ``ts_q`` [segment, n_raw] uint16, ``n``
    [segment] int32}), a short last batch filled with its last frame."""

    def __init__(self, drive: Drive, segment: int):
        self.drive, self.segment = drive, int(segment)
        n_raw = drive.xyz_q.shape[1]
        ts = np.linspace(0.0, 1.0, n_raw, dtype=np.float32)
        self.ts_q = np.tile(
            np.clip(np.rint(ts * 65535.0), 0, 65535).astype(np.uint16),
            (self.segment, 1))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self) -> None:
        pass

    def __iter__(self):
        d, seg = self.drive, self.segment
        for i0 in range(0, len(d), seg):
            k = min(seg, len(d) - i0)
            idx = (slice(i0, i0 + seg) if k == seg
                   else np.minimum(np.arange(i0, i0 + seg), len(d) - 1))
            yield k, {"xyz_q": d.xyz_q[idx], "intensity_q": d.intensity_q[idx],
                      "ts_q": self.ts_q, "n": d.n[idx]}


def make_drives(traffic: dict, sequences: List[str], n_raw: int, seed: int,
                device) -> List[Drive]:
    """One drive a sequence, each ``traffic["frames"]`` frames long (see
    the module note).  Sequence ``s`` draws from its own generator, seeded
    from ``seed`` and ``s``; a world's ``corner_pace_m`` (default its
    ``pace_m``) is its pace on the loop's corners."""
    dev = torch.device(device)
    frames = int(traffic["frames"])
    rng_cfg: Dict[str, dict] = traffic["worlds"]
    drives = []
    ts = np.linspace(0.0, 1.0, n_raw, dtype=np.float32)
    for s, name in enumerate(sequences):
        kind = world_of(traffic, name)
        d = _Draw(sequence_seed(seed, s), dev)
        world = build_urban(d) if kind == "urban" else build_highway(d)
        pace = float(rng_cfg[kind]["pace_m"])
        poses = (loop_poses(frames, pace, 0.0,
                            float(rng_cfg[kind].get("corner_pace_m", pace)))
                 if kind == "urban" else highway_poses(frames, pace, 0.0))
        xyz = torch.empty((frames, n_raw, 3), device=dev)
        inten = torch.empty((frames, n_raw), device=dev)
        mask = torch.empty((frames, n_raw), dtype=torch.bool, device=dev)
        for k in range(frames):
            xyz[k], inten[k], mask[k] = simulate(
                world, poses[k], n_raw, d, float(traffic["sensor_range_m"]),
                float(traffic["min_range_m"]), float(traffic["noise_m"]))
        del world
        # the wire format, quantized as the reader's packing does it
        xyz_q = torch.round(xyz * XYZ_SCALE).clamp(-32767, 32767).to(
            torch.int16)
        inten_q = torch.round(inten * 255.0).clamp(0, 255).to(torch.uint8)
        count = mask.sum(-1, dtype=torch.int32)
        xyz_h, inten_h, mask_h, xyz_qh, inten_qh, count_h = (
            a.cpu().numpy() for a in (xyz, inten, mask, xyz_q, inten_q,
                                      count))
        del xyz, inten, mask, xyz_q, inten_q, count
        drives.append(Drive([{"xyz": xyz_h[k], "intensity": inten_h[k],
                              "ts_ratio": ts, "mask": mask_h[k]}
                             for k in range(frames)],
                            xyz_qh, inten_qh, count_h))
    return drives
