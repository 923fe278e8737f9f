"""The synthetic accuracy bench's worlds, as numpy: the port's own copy of
the world functions of ``tools/synthetic_accuracy_bench.py`` and of the
per-frame assembly of its ``main``.

``make_run`` draws from one ``np.random.default_rng(seed)`` in the bench's
order (the world, the trajectory's handheld sway, the moving cars, then
each scan), so for the same options it gives the bench's scans, array for
array (``tests/test_torch_accuracy.py`` holds them equal).  Worlds:
``urban`` (a city block around a rounded-rectangle loop), ``highway``
(a straight, sparse open road), ``dynamic`` (the urban loop with moving
cars), ``highway_loop`` (the highway wrapped onto a 1.12 km stadium
circuit) and ``urban_hard`` (the urban loop with clutter, range-scaled
noise and occlusion wedges, at three levels).
"""

from __future__ import annotations

import numpy as np

WORLDS = ("urban", "highway", "dynamic", "highway_loop", "urban_hard")

# urban_hard's levels: the pipeline's noise cliff sits near sigma
# ~0.08-0.1 m (the PCA planarity scale); the levels step toward it
HARD_LEVELS = {
    1: dict(noise_base=0.02, noise_range_coef=0.0006, occl_sectors=2),
    2: dict(noise_base=0.025, noise_range_coef=0.0007, occl_sectors=3),
    3: dict(noise_base=0.03, noise_range_coef=0.0008, occl_sectors=3),
}


def build_world(rng, half: float = 120.0) -> np.ndarray:
    """City block: ground plane, building walls on a street grid, posts."""
    pts = []
    # ground, ~6 pts/m^2 over the drivable area
    n_g = 900_000
    pts.append(np.stack([
        rng.uniform(-half, half, n_g), rng.uniform(-half, half, n_g),
        0.04 * rng.normal(size=n_g) - 1.73], -1))
    # buildings: walls along a 60 m grid, height 4-14 m, leave street gaps.
    # Each facade gets a random piecewise depth profile (insets/protrusions
    # every few meters) so no two building sides look alike — a regular
    # grid of identical flat walls is perceptually aliased in a way real
    # streets are not, and invites wrong-mode loop registrations.
    for cx in (-60.0, 0.0, 60.0):
        for cy in (-60.0, 0.0, 60.0):
            w = 22.0  # half building width; streets are ~16 m wide
            h = float(rng.uniform(4.0, 14.0))
            n_w = 26_000
            side = rng.integers(0, 4, n_w)
            u = rng.uniform(-w, w, n_w)
            # per-side piecewise facade depth: 11 random segments
            prof = rng.uniform(-1.2, 1.2, (4, 11))
            seg = np.clip(((u + w) / (2 * w) * 11).astype(int), 0, 10)
            d = np.full(n_w, w) + prof[side, seg] \
                + 0.03 * rng.normal(size=n_w)
            wx = cx + np.where(side == 0, d, np.where(side == 1, -d, u))
            wy = cy + np.where(side < 2, u, np.where(side == 2, d, -d))
            pts.append(np.stack(
                [wx, wy, rng.uniform(-1.5, h, n_w)], -1))
    # lampposts along the streets at IRREGULAR spacing (7-14 m) and
    # jittered lateral offsets — a perfectly periodic post grid aliases at
    # the grid period
    posts = []
    for lane in (-31.0, -29.0, 29.0, 31.0):
        x = -half + rng.uniform(2, 8)
        while x < half:
            posts.append((x + rng.uniform(-0.8, 0.8),
                          lane + rng.uniform(-0.6, 0.6)))
            posts.append((lane + rng.uniform(-0.6, 0.6),
                          x + rng.uniform(-0.8, 0.8)))
            x += rng.uniform(7.0, 14.0)
    per = 90
    for (px, py) in posts:
        z = np.linspace(-1.6, 4.2, per)
        posts_xyz = np.stack([
            px + 0.015 * rng.normal(size=per),
            py + 0.015 * rng.normal(size=per), z], -1)
        pts.append(posts_xyz)
    # street clutter: parked-car-sized boxes at random curb spots (unique
    # local geometry for the descriptor/intensity channels)
    for _ in range(60):
        lane = rng.choice([-33.5, 33.5])
        along = rng.uniform(-half + 5, half - 5)
        cx2, cy2 = (along, lane) if rng.random() < 0.5 else (lane, along)
        n_c = 700
        box = np.stack([
            cx2 + rng.uniform(-2.2, 2.2, n_c),
            cy2 + rng.uniform(-0.9, 0.9, n_c),
            rng.uniform(-1.7, -0.2, n_c)], -1)
        pts.append(box)
    return np.concatenate(pts).astype(np.float32)


def build_world_highway(rng, length: float = 1100.0,
                        road_z_noise: float = 0.03) -> np.ndarray:
    """Structurally different from the urban block: a sparse open highway
    along +x — road surface, guardrails (beam features), posts/signs at
    irregular spacing, embankment slopes, sparse roadside clutter.  No
    facades, no closed loop; the feature diet is ground+beam+pillar-heavy,
    matching the `lo_gflag_list_kitti_highway.txt` operating point's
    intent (sparse geometry at speed)."""
    pts = []
    n_r = 700_000
    # crowned road surface, 13 m wide
    y = rng.uniform(-6.5, 6.5, n_r)
    pts.append(np.stack([
        rng.uniform(-20, length, n_r), y,
        -1.73 - 0.01 * np.abs(y)
        + road_z_noise * rng.normal(size=n_r)], -1))
    # embankment slopes falling off both sides
    n_e = 250_000
    side = rng.choice([-1.0, 1.0], n_e)
    off = rng.uniform(6.5, 20.0, n_e)
    pts.append(np.stack([
        rng.uniform(-20, length, n_e), side * off,
        -1.73 - 0.18 * (off - 6.5) + 0.05 * rng.normal(size=n_e)], -1))
    # guardrails: two horizontal rails at z=-1.0/-0.55, both shoulders
    for lane in (-7.2, 7.2):
        for z0 in (-1.0, -0.55):
            n_gr = 60_000
            pts.append(np.stack([
                rng.uniform(-20, length, n_gr),
                np.full(n_gr, lane) + 0.02 * rng.normal(size=n_gr),
                np.full(n_gr, z0) + 0.02 * rng.normal(size=n_gr)], -1))
    # delineator posts + overhead sign gantries at irregular spacing
    x = 0.0
    while x < length:
        x += rng.uniform(18.0, 45.0)
        for lane in (-7.4, 7.4):
            per = 60
            pts.append(np.stack([
                np.full(per, x) + 0.01 * rng.normal(size=per),
                np.full(per, lane) + 0.01 * rng.normal(size=per),
                np.linspace(-1.7, 0.6, per)], -1))
    x = 0.0
    while x < length:
        x += rng.uniform(120.0, 260.0)
        # gantry: two 6 m pillars + a crossbeam + a sign panel
        for lane in (-8.0, 8.0):
            per = 140
            pts.append(np.stack([
                np.full(per, x) + 0.02 * rng.normal(size=per),
                np.full(per, lane) + 0.02 * rng.normal(size=per),
                np.linspace(-1.7, 5.0, per)], -1))
        n_b = 300
        pts.append(np.stack([
            np.full(n_b, x) + 0.02 * rng.normal(size=n_b),
            rng.uniform(-8, 8, n_b), np.full(n_b, 5.0)
            + 0.03 * rng.normal(size=n_b)], -1))
        n_s = 500
        pts.append(np.stack([
            np.full(n_s, x) + 0.03 * rng.normal(size=n_s),
            rng.uniform(-4, 4, n_s), rng.uniform(3.2, 5.0, n_s)], -1))
    # sparse roadside bushes/trees
    for _ in range(int(length / 12)):
        cx = rng.uniform(0, length)
        cy = rng.choice([-1.0, 1.0]) * rng.uniform(10.0, 25.0)
        n_t = 250
        pts.append(np.stack([
            cx + 0.8 * rng.normal(size=n_t), cy + 0.8 * rng.normal(size=n_t),
            rng.uniform(-1.6, rng.uniform(0.5, 4.0), n_t)], -1))
    return np.concatenate(pts).astype(np.float32)


def _stadium(L: float = 420.0, r: float = 45.0):
    """Closed 'stadium' circuit (two straights + two 180-deg arcs, total
    2L + 2*pi*r ~ 1.12 km): the interchange-loop variant of the highway,
    sparse geometry with loop closure.  Returns (total_length,
    centerline(s) -> (x[...], y[...], yaw[...]) vectorized over arc
    length s)."""
    total = 2 * L + 2 * np.pi * r

    def centerline(s):
        s = np.asarray(s, np.float64) % total
        x = np.empty_like(s)
        y = np.empty_like(s)
        yaw = np.empty_like(s)
        m1 = s < L                          # straight 1: +x along y=0
        x[m1], y[m1], yaw[m1] = s[m1], 0.0, 0.0
        m2 = (s >= L) & (s < L + np.pi * r)  # arc 1 (left, centered L, r)
        th = -np.pi / 2 + (s[m2] - L) / r
        x[m2] = L + r * np.cos(th)
        y[m2] = r + r * np.sin(th)
        yaw[m2] = th + np.pi / 2
        m3 = (s >= L + np.pi * r) & (s < 2 * L + np.pi * r)  # straight 2
        x[m3] = L - (s[m3] - L - np.pi * r)
        y[m3] = 2 * r
        yaw[m3] = np.pi
        m4 = s >= 2 * L + np.pi * r          # arc 2 (centered 0, r)
        th = np.pi / 2 + (s[m4] - 2 * L - np.pi * r) / r
        x[m4] = r * np.cos(th)
        y[m4] = r + r * np.sin(th)
        yaw[m4] = th + np.pi / 2
        return x, y, yaw

    return total, centerline


def build_world_highway_loop(rng, L: float = 420.0,
                             r: float = 45.0) -> np.ndarray:
    """Highway feature diet wrapped onto the closed stadium circuit: the
    straight-highway generator runs in (s, lateral) road coordinates and
    the centerline map bends them around the loop (guardrails, posts and
    gantries follow the curve like a real interchange ramp)."""
    total, centerline = _stadium(L, r)
    flat = build_world_highway(rng, length=total)
    s, lat, z = flat[:, 0].astype(np.float64), flat[:, 1], flat[:, 2]
    x, y, yaw = centerline(s)
    nx, ny = -np.sin(yaw), np.cos(yaw)  # left normal
    return np.stack([x + nx * lat, y + ny * lat, z],
                    -1).astype(np.float32)


def highway_loop_trajectory(n_frames: int, step: float = 2.2,
                            L: float = 420.0, r: float = 45.0):
    """Drive the stadium circuit at highway speed with gentle lane drift;
    after one lap (~510 frames) the vehicle re-traverses mapped road —
    loop-closure opportunities on sparse geometry."""
    total, centerline = _stadium(L, r)
    s = np.arange(n_frames) * step
    x, y, yaw = centerline(s)
    lat = 1.2 * np.sin(2 * np.pi * s / 300.0)
    nx, ny = -np.sin(yaw), np.cos(yaw)
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    c, si = np.cos(yaw), np.sin(yaw)
    poses[:, 0, 0], poses[:, 0, 1] = c, -si
    poses[:, 1, 0], poses[:, 1, 1] = si, c
    poses[:, 0, 3] = x + nx * lat
    poses[:, 1, 3] = y + ny * lat
    return poses


def build_world_hard_extras(rng, half: float = 120.0) -> np.ndarray:
    """KITTI-hardness additions for the urban world (a deliberately hard
    calibration row): dense street-level clutter
    (parked cars, bins, hedges — occluders and false planar/linear
    structure at exactly the feature scales the classifier keys on)."""
    pts = []
    for _ in range(260):
        # parked-car-sized boxes hugging the lane edges + random yard blobs
        cx = rng.uniform(-half, half)
        cy = rng.choice([-1.0, 1.0]) * rng.uniform(24.0, 36.0)
        if rng.uniform() < 0.5:
            cx, cy = cy, cx
        n_c = 300
        yawb = rng.uniform(0, np.pi)
        u = rng.uniform(-2.1, 2.1, n_c)
        v = rng.uniform(-0.9, 0.9, n_c)
        pts.append(np.stack([
            cx + u * np.cos(yawb) - v * np.sin(yawb),
            cy + u * np.sin(yawb) + v * np.cos(yawb),
            rng.uniform(-1.7, -0.25, n_c)], -1))
    for _ in range(150):
        # hedges / bushes: noisy blobs 0.5-2.5 m tall
        cx, cy = rng.uniform(-half, half, 2)
        n_b = 160
        pts.append(np.stack([
            cx + 0.7 * rng.normal(size=n_b),
            cy + 0.7 * rng.normal(size=n_b),
            rng.uniform(-1.7, rng.uniform(-1.0, 0.8), n_b)], -1))
    return np.concatenate(pts).astype(np.float32)


def highway_trajectory(n_frames: int, step: float = 2.2):
    """Straight-ish drive at ~80 km/h (2.2 m / 100 ms frame) with gentle
    lane drift — no loop closure opportunities by construction."""
    poses = []
    for k in range(n_frames):
        x = k * step
        y = 1.8 * np.sin(2 * np.pi * x / 400.0)
        yaw = np.arctan2(1.8 * 2 * np.pi / 400.0
                         * np.cos(2 * np.pi * x / 400.0), 1.0)
        T = np.eye(4)
        c, si = np.cos(yaw), np.sin(yaw)
        T[:3, :3] = [[c, -si, 0], [si, c, 0], [0, 0, 1]]
        T[:3, 3] = [x, y, 0.0]
        poses.append(T)
    return np.stack(poses)


def dynamic_traffic(rng, n_frames: int, lanes=(-2.0, 2.0)):
    """Per-frame moving objects for the urban loop: car-sized point boxes
    driving the street lanes at 0.6-1.4 m/frame — exercises map-based
    dynamic removal under real (moving) outliers instead of static
    clutter.  Returns a list of [n_dyn, 3] arrays, one per frame."""
    cars = []
    for _ in range(14):
        axis = rng.integers(0, 2)  # 0: along x, 1: along y
        lane_c = rng.choice([-30.0, 30.0]) + rng.choice(lanes)
        pos0 = rng.uniform(-110.0, 110.0)
        vel = rng.choice([-1.0, 1.0]) * rng.uniform(0.6, 1.4)
        cars.append((axis, lane_c, pos0, vel))
    per = 420
    out = []
    for k in range(n_frames):
        frames_pts = []
        for axis, lane_c, pos0, vel in cars:
            p = -110.0 + (pos0 + 110.0 + vel * k) % 220.0
            body = np.stack([
                p + rng.uniform(-2.2, 2.2, per),
                lane_c + rng.uniform(-0.9, 0.9, per),
                rng.uniform(-1.7, -0.3, per)], -1)
            if axis == 1:
                body = body[:, [1, 0, 2]]
            frames_pts.append(body)
        out.append(np.concatenate(frames_pts).astype(np.float32))
    return out


def handheld_sway(poses: np.ndarray, rng) -> np.ndarray:
    """Superimpose handheld carry motion on a trajectory: ~1 Hz gait
    bob (+-4 cm), body sway (+-2.5 deg roll/pitch wander) and heading
    jitter — the motion regime the Newer College handheld flagfile is
    tuned for (slow translation, persistent small rotations)."""
    n = len(poses)
    t = np.arange(n)
    bob = 0.04 * np.sin(2 * np.pi * t / 10.0)
    roll = np.radians(2.5) * np.sin(2 * np.pi * t / 23.0 + 1.2)
    pitch = np.radians(2.0) * np.sin(2 * np.pi * t / 17.0)
    yaw_j = np.radians(1.2) * np.cumsum(rng.normal(size=n)) / np.sqrt(
        np.maximum(t, 1))
    out = poses.copy()
    for k in range(n):
        cr, sr = np.cos(roll[k]), np.sin(roll[k])
        cp, sp = np.cos(pitch[k]), np.sin(pitch[k])
        cy, sy = np.cos(yaw_j[k]), np.sin(yaw_j[k])
        Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
        out[k, :3, :3] = poses[k, :3, :3] @ (Rz @ Ry @ Rx)
        out[k, 2, 3] += bob[k]
    return out


def loop_trajectory(n_frames: int, step: float = 0.8):
    """Rounded-rectangle loop in the street lanes around the center block:
    straight segments + quarter-circle corner arcs (r = 8 m, ~9 deg/frame
    peak yaw rate — a vehicle turn, not a pirouette)."""
    L, r = 30.0, 8.0
    straight = 2 * (L - r)
    arc = 0.5 * np.pi * r
    total = 4 * (straight + arc)

    def at(sd):
        """(x, y, yaw) at arc-length sd along the loop, counterclockwise
        starting at (-L + r, -L) heading +x."""
        sd = sd % total
        quarter = straight + arc
        edge = int(sd // quarter)
        f = sd - edge * quarter
        if f <= straight:  # straight part
            d = f - (L - r)  # -.. to +.. along the edge center
            if edge == 0:
                return (d, -L, 0.0)
            if edge == 1:
                return (L, d, np.pi / 2)
            if edge == 2:
                return (-d, L, np.pi)
            return (-L, -d, -np.pi / 2)
        a = (f - straight) / r  # 0..pi/2 along the corner arc
        base = edge * np.pi / 2
        cx = [(L - r, -L + r), (L - r, L - r),
              (-L + r, L - r), (-L + r, -L + r)][edge]
        ang = base - np.pi / 2 + a
        return (cx[0] + r * np.cos(ang), cx[1] + r * np.sin(ang),
                base + a)

    poses = []
    for k in range(n_frames):
        x, y, yaw = at(k * step)
        T = np.eye(4)
        c, si = np.cos(yaw), np.sin(yaw)
        T[:3, :3] = [[c, -si, 0], [si, c, 0], [0, 0, 1]]
        T[:3, 3] = [x, y, 0.0]
        poses.append(T)
    return np.stack(poses)


def simulate(world, pose, n_raw, rng, sensor_range=65.0, beams=0,
             vertical_ang_err_deg=0.0, noise_base=0.01,
             noise_range_coef=0.0, occl_sectors=0):
    """One scan: crop world to range, downsample, sensor-frame + noise.

    Hard-world knobs: ``noise_base`` +
    ``noise_range_coef`` model per-point noise growing with range
    (sigma = base + coef * r, the beam-divergence/incidence falloff a
    real HDL-64 shows); ``occl_sectors`` drops that many random 25-deg
    azimuth wedges per frame (passing trucks / self-occlusion).

    ``beams > 0`` applies a scanner elevation-beam mask (evenly spaced
    beams from -24.8 to +2 deg, HDL/OS1-style): only points within a
    fraction of the beam spacing of some beam elevation survive, so a
    16-beam profile sees the genuinely sparse vertical structure the
    16/32/128-beam reference flagfiles were tuned for — not just fewer
    uniform random points.

    ``vertical_ang_err_deg`` models the scanner's vertical-angle
    INTRINSIC error (the HDL-64 bias that
    `--vertical_ang_correction_deg=0.195` exists to undo): each return
    keeps its range/azimuth but its reported elevation is biased by
    -err.  A flagfile that turns the calibration on expects data from a
    sensor WITH this intrinsic; feeding it perfect data instead bends
    every cloud into a cone (dz = r*sin(err), +0.20 m at 60 m), whose
    motion with the sensor integrates into a pitch ratchet
    (-0.012 deg/frame measured on the straight highway world -> 40 m
    z-climb)."""
    inv = np.linalg.inv(pose)
    # cheap pre-crop in world coords before the exact transform
    c = pose[:3, 3]
    rough = (np.abs(world[:, 0] - c[0]) < sensor_range + 2) \
        & (np.abs(world[:, 1] - c[1]) < sensor_range + 2)
    w = world[rough]
    local = w @ inv[:3, :3].T + inv[:3, 3]
    r = np.linalg.norm(local[:, :2], axis=1)
    keep = (r < sensor_range) & (r > 1.8)
    if beams:
        # rotating-scanner geometry: one return per (elevation beam,
        # azimuth bin) — a 16-beam profile genuinely sees ~16 x 2048
        # points with sparse vertical structure, not just fewer uniform
        # random samples
        el = np.degrees(np.arctan2(local[:, 2], r))
        lo_deg, hi_deg = -24.8, 2.0
        spacing = (hi_deg - lo_deg) / max(beams - 1, 1)
        b = np.clip(np.round((el - lo_deg) / spacing), 0, beams - 1)
        on_beam = keep & (np.abs(el - (lo_deg + b * spacing))
                          < 0.35 * spacing) & (el >= lo_deg - 0.5) \
            & (el <= hi_deg + 0.5)
        az_bins = 2048
        az = np.floor((np.arctan2(local[:, 1], local[:, 0]) + np.pi)
                      / (2 * np.pi) * az_bins).astype(np.int64) % az_bins
        cell = b.astype(np.int64) * az_bins + az
        # nearest return wins inside each cell (scanner returns the first
        # surface hit along the ray)
        order = np.lexsort((r, cell))
        oc = cell[order]
        first = np.ones(len(order), bool)
        first[1:] = oc[1:] != oc[:-1]
        hit = np.zeros(len(keep), bool)
        hit[order[first & on_beam[order]]] = True
        keep = hit
    if occl_sectors:
        az_deg = np.degrees(np.arctan2(local[:, 1], local[:, 0]))
        for _ in range(occl_sectors):
            a0 = rng.uniform(-180.0, 180.0)
            d = (az_deg - a0 + 180.0) % 360.0 - 180.0
            keep = keep & ~(np.abs(d) < 12.5)
    sel = np.where(keep)[0]
    if len(sel) > n_raw:
        sel = rng.choice(sel, n_raw, replace=False)
    sigma = noise_base + noise_range_coef * r[sel]
    pts = local[sel] + sigma[:, None] * rng.normal(size=(len(sel), 3))
    if vertical_ang_err_deg:
        # bias the reported elevation by -err (inverse of the pipeline's
        # vertical_intrinsic_calibration, `cfilter.hpp:250-292`)
        dang = np.radians(vertical_ang_err_deg)
        dist = np.linalg.norm(pts, axis=-1)
        v = np.arcsin(np.clip(pts[:, 2] / np.maximum(dist, 1e-12), -1, 1))
        v_b = v - dang
        hs = np.cos(v_b) / np.maximum(np.cos(v), 1e-12)
        pts = np.stack([pts[:, 0] * hs, pts[:, 1] * hs,
                        dist * np.sin(v_b)], -1)
    out = np.zeros((n_raw, 3), np.float32)
    out[:len(sel)] = pts
    mask = np.zeros(n_raw, bool)
    mask[:len(sel)] = True
    inten = np.zeros(n_raw, np.float32)
    ws = w[sel]
    inten[:len(sel)] = np.abs(np.sin(0.7 * ws[:, 0])
                              + np.cos(1.3 * ws[:, 1])) * 120.0
    return {"xyz": out, "intensity": inten,
            "ts_ratio": np.linspace(0, 1, n_raw, dtype=np.float32),
            "mask": mask}


def fog_span(frames: int, fog: bool) -> tuple:
    """The fog bank's frames [lo, hi): 25-40 % of the run, or none."""
    return (int(0.25 * frames), int(0.40 * frames)) if fog else (0, 0)


def make_run(world: str, seed: int, frames: int, n_raw: int,
             fog: bool = False, beams: int = 0, hardness: int = 1,
             traj_step: float = 0.0, handheld: bool = False,
             v_err: float = 0.0) -> tuple:
    """(scans, ground truth relative to frame 0, meta) of one bench run.

    ``v_err``: the simulated sensor's vertical-angle intrinsic in degrees
    (the bench sets it from the config's calibration, 0 at the defaults).
    ``meta``: the world's point count, the fog span and the path length."""
    if world not in WORLDS:
        raise ValueError(f"unknown world {world!r}: one of {WORLDS}")
    rng = np.random.default_rng(seed)
    sim_kw = {}
    if world == "highway":
        pts = build_world_highway(rng)
        world_g = highway_trajectory(frames)
    elif world == "highway_loop":
        pts = build_world_highway_loop(rng)
        world_g = highway_loop_trajectory(frames)
    elif world == "urban_hard":
        pts = np.concatenate([build_world(rng), build_world_hard_extras(rng)])
        world_g = loop_trajectory(frames)
        sim_kw = HARD_LEVELS[max(1, min(hardness, 3))]
    else:
        pts = build_world(rng)
        world_g = (loop_trajectory(frames, step=traj_step)
                   if traj_step > 0 else loop_trajectory(frames))
    if handheld:
        world_g = handheld_sway(world_g, rng)
    gt = np.einsum("ij,njk->nik", np.linalg.inv(world_g[0]), world_g)
    fog_lo, fog_hi = fog_span(frames, fog)
    dyn = dynamic_traffic(rng, frames) if world == "dynamic" else None
    scans = [simulate(np.concatenate([pts, dyn[k]]) if dyn is not None
                      else pts,
                      world_g[k], n_raw, rng,
                      sensor_range=(20.0 if fog_lo <= k < fog_hi else 65.0),
                      beams=beams, vertical_ang_err_deg=v_err, **sim_kw)
             for k in range(frames)]
    meta = {"world_points": int(len(pts)),
            "fog": [fog_lo, fog_hi] if fog else None,
            "loop_length_m": float(np.sum(np.linalg.norm(
                np.diff(gt[:, :3, 3], axis=0), axis=1)))}
    return scans, gt, meta


def stationary_scans(seed: int, n: int, n_raw: int) -> list:
    """``n`` scans of the urban world (from ``seed``) taken from one pose,
    the loop's start: the recovery ladder's warm state and its next scan."""
    rng = np.random.default_rng(seed)
    pts = build_world(rng)
    pose = loop_trajectory(1)[0]
    return [simulate(pts, pose, n_raw, rng) for _ in range(n)]


class LazyDrive:
    """An indexable drive that simulates each scan on demand from a
    per-index seed, so a resumed run sees the same scans; a long drive
    precomputed would take ~2 MB of host memory a frame."""

    def __init__(self, world: np.ndarray, poses: np.ndarray, n_raw: int,
                 seed: int):
        self.world = world
        self.poses = poses
        self.n_raw = n_raw
        self.seed = seed

    def __len__(self) -> int:
        return len(self.poses)

    def __getitem__(self, k: int) -> dict:
        rng = np.random.default_rng(self.seed * 1_000_003 + k)
        return simulate(self.world, self.poses[k], self.n_raw, rng)
