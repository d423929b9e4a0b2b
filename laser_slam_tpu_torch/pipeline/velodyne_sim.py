"""Beam-model Velodyne simulator: ray-cast scans with real sensor geometry.

Uniform-random sampling of a world point set (replay.SyntheticStream) has
no ring structure, so it never exercises the projective matcher's
elevation binning or the assembler's azimuth ordering the way a real
spinning LiDAR does.  This module casts an
HDL-64-class beam pattern — a fixed elevation table, azimuth-discretized
firings, occlusion via nearest-surface intersection — against an analytic
scene (ground plane + four walls + box obstacles, the same world shape as
SyntheticStream), producing scans whose (ring, azimuth) structure matches
what the reference's velodyne_assembler consumes from the real driver
(velodyne_assembler_ros.cpp:57-143).

Everything here is host-side numpy (scan generation is replay-time IO,
not device compute).

Port copy: the same code as ``laser_slam_tpu/pipeline/velodyne_sim.py``
(one seed gives bit-identical frames), with the port's ``ScanFrame``,
the port's range encoder, ``VLP16_ELEV_DEG`` from the port's ``native``
and the port's one definition of ``encode_velodyne_packet`` (which
``bag_writer`` re-exports).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

# VLP16_ELEV_DEG: the VLP-16 table in FIRING order (the raw packet's
# channel order, as the packet decoder reads it).
from laser_slam_tpu_torch.native import VLP16_ELEV_DEG
from laser_slam_tpu_torch.pipeline.replay import ScanFrame

# HDL-64E-class elevation table: 64 beams from +2 deg down to -24.8 deg
# (the KITTI sensor's span), top-to-bottom ring order.
HDL64_ELEV_DEG = np.linspace(2.0, -24.8, 64)
# VLP-16 table in RING order (top to bottom), for 16-beam workloads.
VLP16_ELEV_DEG_SORTED = np.linspace(15.0, -15.0, 16)


@dataclasses.dataclass
class BeamScene:
    """Analytic surfaces for ray casting."""
    half_size: float                 # walls at x,y = +-half_size
    wall_height: float               # walls span z in [0, wall_height]
    boxes: np.ndarray                # [K,2,3] AABB (min, max) corners
    ground_z: float = 0.0
    # Sloped (non-planar) terrain: ground plane z = ground_z + sx*x +
    # sy*y.  The reference's ICP stack makes no flat-world assumption
    # (point-to-plane uses per-point normals), but a flat simulator never
    # exercises roll/pitch observability — this does.
    ground_slope: tuple = (0.0, 0.0)
    # Dynamic objects: per-box velocity [K,3] m/scan.  Moving surfaces
    # violate the static-world assumption behind scan-to-submap ICP
    # (laser_track.cpp:466-519 registers against past scans as if rigid);
    # the trimmed-distance outlier stage is what absorbs them.  None =
    # static scene.  BeamStream shifts box AABBs by i*velocity at scan i.
    box_velocity: Optional[np.ndarray] = None

    def at_scan(self, i: int) -> 'BeamScene':
        """Scene snapshot at scan index ``i`` (applies box velocities)."""
        if self.box_velocity is None or i == 0:
            return self
        shifted = self.boxes + i * self.box_velocity[:, None, :]
        return dataclasses.replace(self, boxes=shifted)


def make_beam_scene(seed: int = 0, world_size_m: float = 60.0,
                    n_boxes: int = 12, box_height_m: float = 3.0
                    ) -> BeamScene:
    """Box room + scattered box obstacles (SyntheticStream's world shape,
    as solid surfaces instead of point samples)."""
    rng = np.random.default_rng(seed)
    half = world_size_m / 2
    centers = rng.uniform(-half * 0.7, half * 0.7, size=(n_boxes, 2))
    half_extents = rng.uniform(0.8, 2.0, size=(n_boxes, 2))
    boxes = np.zeros((n_boxes, 2, 3), np.float64)
    boxes[:, 0, :2] = centers - half_extents
    boxes[:, 1, :2] = centers + half_extents
    boxes[:, 0, 2] = 0.0
    boxes[:, 1, 2] = box_height_m
    return BeamScene(half_size=half, wall_height=8.0, boxes=boxes)


def make_corridor_scene(length_m: float = 120.0, width_m: float = 6.0,
                        wall_height_m: float = 4.0) -> BeamScene:
    """Featureless corridor: two parallel wall slabs + ground, nothing
    else within sensor range (the outer box is pushed past max range and
    flattened to zero height).

    The adversarial geometry for point-to-plane ICP: every surface normal
    is perpendicular to the corridor axis (+x), so the Gauss-Newton
    normal equations are RANK-DEFICIENT along x — the matched reference
    constrains y/z/roll/pitch/yaw but says nothing about forward motion.
    The expected behavior (reference parity: libpointmatcher converges to
    whatever the initial guess said along the null direction) is that x
    follows odometry while the constrained axes stay locked; what must
    NOT happen is NaN poses or divergence (tests/test_adversarial.py).
    """
    slabs = np.zeros((2, 2, 3), np.float64)
    slabs[0] = [[-20.0, -width_m / 2 - 0.6, 0.0],
                [length_m, -width_m / 2, wall_height_m]]
    slabs[1] = [[-20.0, width_m / 2, 0.0],
                [length_m, width_m / 2 + 0.6, wall_height_m]]
    return BeamScene(half_size=500.0, wall_height=0.0, boxes=slabs)


def make_repeated_rooms_scene(n_rooms: int = 4,
                              room_spacing_m: float = 30.0,
                              seed: int = 0) -> BeamScene:
    """Perceptual-aliasing world: the SAME box cluster tiled every
    ``room_spacing_m`` along +x.  Scan-context descriptors of different
    rooms are near-identical (the aliasing failure mode named at
    pipeline/online.py verify_closure), so a detector without geometric
    verification will link distinct places tens of meters apart.  Used to
    measure the ICP gate's rejection rate (tests/test_adversarial.py,
    experiments/adversarial_validation.py)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-8.0, 8.0, size=(6, 2))
    half_extents = rng.uniform(0.8, 2.0, size=(6, 2))
    cluster = np.zeros((6, 2, 3), np.float64)
    cluster[:, 0, :2] = centers - half_extents
    cluster[:, 1, :2] = centers + half_extents
    cluster[:, 0, 2] = 0.0
    cluster[:, 1, 2] = 3.0
    rooms = []
    for k in range(n_rooms):
        shifted = cluster.copy()
        shifted[:, :, 0] += k * room_spacing_m
        rooms.append(shifted)
    return BeamScene(half_size=500.0, wall_height=0.0,
                     boxes=np.concatenate(rooms, axis=0))


def make_dynamic_scene(seed: int = 0, world_size_m: float = 80.0,
                       n_static: int = 12, n_moving: int = 6,
                       speed_m_per_scan: float = 0.35) -> BeamScene:
    """Static box room + ``n_moving`` boxes translating every scan
    (vehicles/pedestrians crossing the mapped area).  Moving surfaces
    land in the submap at stale positions, so their correspondences are
    wrong by up to speed*nscan_in_sub_map metres — the trimmed-distance
    outlier stage (icp_default.yaml ratio 0.75 parity) must reject them
    for the trajectory to stay bounded (tests/test_adversarial.py)."""
    base = make_beam_scene(seed=seed, world_size_m=world_size_m,
                           n_boxes=n_static + n_moving)
    rng = np.random.default_rng(seed + 1)
    vel = np.zeros((n_static + n_moving, 3))
    ang = rng.uniform(0, 2 * np.pi, n_moving)
    vel[n_static:, 0] = np.cos(ang) * speed_m_per_scan
    vel[n_static:, 1] = np.sin(ang) * speed_m_per_scan
    return dataclasses.replace(base, box_velocity=vel)


def make_sloped_clutter_scene(seed: int = 0, world_size_m: float = 80.0,
                              slope: tuple = (0.06, 0.03),
                              n_boxes: int = 48) -> BeamScene:
    """Non-planar terrain (6%/3% grade) + heavy clutter: boxes sit ON the
    sloped ground (their z-extents follow the terrain at their center).
    Exercises roll/pitch observability and high outlier-stage load — the
    two axes the benign flat box-room never stresses."""
    rng = np.random.default_rng(seed)
    half = world_size_m / 2
    centers = rng.uniform(-half * 0.7, half * 0.7, size=(n_boxes, 2))
    half_extents = rng.uniform(0.4, 1.6, size=(n_boxes, 2))
    heights = rng.uniform(0.8, 3.5, size=n_boxes)
    ground = slope[0] * centers[:, 0] + slope[1] * centers[:, 1]
    boxes = np.zeros((n_boxes, 2, 3), np.float64)
    boxes[:, 0, :2] = centers - half_extents
    boxes[:, 1, :2] = centers + half_extents
    boxes[:, 0, 2] = ground - 0.5          # sink into the slope
    boxes[:, 1, 2] = ground + heights
    return BeamScene(half_size=half, wall_height=10.0, boxes=boxes,
                     ground_slope=slope)


def _raycast(scene: BeamScene, origin: np.ndarray,
             dirs: np.ndarray) -> np.ndarray:
    """Nearest-intersection distances [R] for world-frame rays (inf=miss)."""
    o = origin.astype(np.float64)
    d = dirs.astype(np.float64)
    R = len(d)
    t_best = np.full(R, np.inf)
    eps = 1e-9
    half, zh = scene.half_size, scene.wall_height

    # Ground plane z = ground_z + sx*x + sy*y (flat when slope is zero).
    dz = d[:, 2]
    sx, sy = scene.ground_slope
    if sx == 0.0 and sy == 0.0:
        tg = np.where(dz < -eps,
                      (scene.ground_z - o[2]) / np.minimum(dz, -eps),
                      np.inf)
    else:
        denom = dz - sx * d[:, 0] - sy * d[:, 1]
        num = scene.ground_z + sx * o[0] + sy * o[1] - o[2]
        tg = np.where(np.abs(denom) > eps, num / denom, np.inf)
        tg = np.where(tg > 0, tg, np.inf)
    hit = (tg > 0) & np.isfinite(tg)
    xy = o[None, :2] + tg[:, None] * d[:, :2]
    hit &= (np.abs(xy) <= half).all(axis=1)
    t_best = np.where(hit, np.minimum(t_best, tg), t_best)

    # Four walls: axis-aligned planes with a height/extent aperture.
    for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1)):
        da = d[:, axis]
        denom = np.where(np.abs(da) > eps, da, eps)
        tw = (sign * half - o[axis]) / denom
        other = 1 - axis
        po = o[other] + tw * d[:, other]
        pz = o[2] + tw * dz
        ok = ((tw > 0) & (np.abs(po) <= half) & (pz >= 0) & (pz <= zh)
              & (np.sign(da) == sign))
        t_best = np.where(ok, np.minimum(t_best, tw), t_best)

    # Boxes: slab method, vectorized over rays x boxes.
    if len(scene.boxes):
        lo = scene.boxes[None, :, 0, :]           # [1,K,3]
        hi = scene.boxes[None, :, 1, :]
        dd = d[:, None, :]                        # [R,1,3]
        oo = o[None, None, :]
        inv = 1.0 / np.where(np.abs(dd) > eps, dd, eps)
        t1 = (lo - oo) * inv
        t2 = (hi - oo) * inv
        tmin = np.minimum(t1, t2).max(axis=2)     # [R,K]
        tmax = np.maximum(t1, t2).min(axis=2)
        okb = (tmax >= tmin) & (tmax > 0)
        tb = np.where(okb & (tmin > 0), tmin, np.inf)
        t_best = np.minimum(t_best, tb.min(axis=1))

    return t_best


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw])


def _np_compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """pose7 composition a*b, numpy (mirrors ops.se3.compose)."""
    q = _quat_mul(a[:4], b[:4])
    t = a[4:] + _quat_to_matrix(a[:4]) @ b[4:]
    return np.concatenate([q / np.linalg.norm(q), t])


def _np_inverse(p: np.ndarray) -> np.ndarray:
    qc = np.array([p[0], -p[1], -p[2], -p[3]])
    return np.concatenate([qc, -(_quat_to_matrix(qc) @ p[4:])])


def _np_se3_exp(xi: np.ndarray) -> np.ndarray:
    """pose7 = exp([omega, v]) with the left-Jacobian translation
    (mirrors ops.se3.exp — rot-first tangent convention)."""
    w, v = xi[:3], xi[3:]
    th = np.linalg.norm(w)
    if th < 1e-9:
        q = np.array([1.0, 0.5 * w[0], 0.5 * w[1], 0.5 * w[2]])
        return np.concatenate([q / np.linalg.norm(q), v])
    axis = w / th
    q = np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * axis])
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    V = (np.eye(3) + (1 - np.cos(th)) / th * K
         + (th - np.sin(th)) / th * (K @ K))
    return np.concatenate([q, V @ v])


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def beam_directions(elev_deg: np.ndarray, n_azimuth: int) -> np.ndarray:
    """Sensor-frame unit directions [n_beams, n_azimuth, 3]; azimuth 0 at
    +x, increasing counter-clockwise; ring-major layout (the raw packet
    order after revolution assembly)."""
    elev = np.deg2rad(np.asarray(elev_deg, np.float64))[:, None]
    az = (2 * np.pi * (np.arange(n_azimuth) + 0.5) / n_azimuth)[None, :]
    ce = np.cos(elev)
    x = ce * np.cos(az)
    y = ce * np.sin(az)
    z = np.broadcast_to(np.sin(elev), x.shape)
    return np.stack([x, y, z], axis=-1)


def beam_scan(scene: BeamScene, pose7: np.ndarray,
              elev_deg: np.ndarray = HDL64_ELEV_DEG,
              n_azimuth: int = 1024, max_range_m: float = 80.0,
              min_range_m: float = 1.5, range_noise_m: float = 0.02,
              rng: Optional[np.random.Generator] = None):
    """One full-revolution scan from ``pose7`` (sensor frame points).

    Returns ``(points [M,3] float32, hit_image [n_beams, n_azimuth] bool)``
    — only rays hitting a surface within [min_range, max_range] return
    points (no-echo rays are dropped, like zero-distance packet returns).
    """
    rng = rng or np.random.default_rng(0)
    dirs_s = beam_directions(elev_deg, n_azimuth)         # [B,C,3]
    B, C, _ = dirs_s.shape
    Rm = _quat_to_matrix(np.asarray(pose7[:4], np.float64))
    dirs_w = dirs_s.reshape(-1, 3) @ Rm.T
    origin = np.asarray(pose7[4:], np.float64)
    t = _raycast(scene, origin, dirs_w)
    hit = np.isfinite(t) & (t >= min_range_m) & (t <= max_range_m)
    r = t + rng.normal(size=t.shape) * range_noise_m
    pts = (dirs_s.reshape(-1, 3) * r[:, None])[hit]
    return pts.astype(np.float32), hit.reshape(B, C)


def beam_scan_packed(scene: BeamScene, pose7: np.ndarray,
                     elev_deg: np.ndarray = HDL64_ELEV_DEG,
                     n_azimuth: int = 1024, max_range_m: float = 80.0,
                     min_range_m: float = 1.5, range_noise_m: float = 0.02,
                     rng: Optional[np.random.Generator] = None):
    """:func:`beam_scan` in the sensor's native encoding.

    Returns ``(points [M,3] float32, range_words [n_beams, n_azimuth]
    uint16)`` from ONE raycast with one noise draw: ``points`` is the
    exact xyz expansion the xyz ingest path would see, ``range_words`` the
    packed scan (0 = no echo, 2 mm units — ops/spherical.py) whose
    on-device decode reproduces ``points`` up to range quantization.
    Used to bench/test the packed ingest path against the xyz path on
    identical scans.
    """
    from laser_slam_tpu_torch.ops import spherical
    rng = rng or np.random.default_rng(0)
    dirs_s = beam_directions(elev_deg, n_azimuth)
    B, C, _ = dirs_s.shape
    Rm = _quat_to_matrix(np.asarray(pose7[:4], np.float64))
    dirs_w = dirs_s.reshape(-1, 3) @ Rm.T
    origin = np.asarray(pose7[4:], np.float64)
    t = _raycast(scene, origin, dirs_w)
    hit = np.isfinite(t) & (t >= min_range_m) & (t <= max_range_m)
    r = t + rng.normal(size=t.shape) * range_noise_m
    pts = (dirs_s.reshape(-1, 3) * r[:, None])[hit]
    ranges = spherical.encode_ranges(
        np.where(hit, r, 0.0).reshape(B, C), hit.reshape(B, C))
    return pts.astype(np.float32), ranges


class BeamStream:
    """Beam-model replay stream: SyntheticStream's trajectories and world
    shape, with ray-cast HDL-64-class scans instead of uniform sampling.

    Yields :class:`replay.ScanFrame` — drop-in for SyntheticStream in
    benches and parity tests (n_beams x n_azimuth caps the per-scan point
    count; occlusion and no-echo dropout make the real count lower)."""

    def __init__(self, n_scans: int = 50, n_beams: int = 64,
                 n_azimuth: int = 1024, trajectory: str = 'circle',
                 radius_m: float = 20.0, world_size_m: float = 60.0,
                 range_noise_m: float = 0.02, odom_noise: float = 0.0,
                 seed: int = 0, period_ns: int = int(1e8),
                 step_m: float = 1.0, laps: int = 1,
                 sensor_height_m: float = 1.5,
                 center_m: tuple = (0.0, 0.0),
                 packed: bool = False, scene: Optional[BeamScene] = None):
        self.n_scans = n_scans
        self.trajectory = trajectory
        self.radius_m = radius_m
        self.step_m = step_m
        self.laps = laps
        self.center_m = center_m
        self.period_ns = period_ns
        self.odom_noise = odom_noise
        self.range_noise_m = range_noise_m
        self.n_azimuth = n_azimuth
        self.sensor_height_m = sensor_height_m
        if n_beams == 64:
            self.elev_deg = HDL64_ELEV_DEG
        elif n_beams == 16:
            self.elev_deg = VLP16_ELEV_DEG_SORTED
        else:
            self.elev_deg = np.linspace(2.0, -24.8, n_beams)
        self._rng = np.random.default_rng(seed)
        self.scene = (scene if scene is not None
                      else make_beam_scene(seed=seed,
                                           world_size_m=world_size_m))
        self.last_hit_rate: float = float('nan')
        # packed=True: frames additionally carry the sensor-native uint16
        # range image in ScanFrame.range_words (same raycast + noise draw,
        # so points and ranges describe the identical scan).
        self.packed = packed

    def gt_pose(self, i: int) -> np.ndarray:
        if self.trajectory == 'circle':
            ang = 2 * np.pi * i * self.laps / self.n_scans
            yaw = ang + np.pi / 2
            q = np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)],
                         np.float32)
            t = np.array([self.center_m[0] + self.radius_m * np.cos(ang),
                          self.center_m[1] + self.radius_m * np.sin(ang),
                          self.sensor_height_m], np.float32)
        elif self.trajectory == 'line':
            q = np.array([1, 0, 0, 0], np.float32)
            t = np.array([self.step_m * i, 0.0, self.sensor_height_m],
                         np.float32)
        else:
            raise ValueError(self.trajectory)
        # Terrain-following height on sloped ground (sensor stays
        # upright; the scan geometry sees the full roll/pitch-exciting
        # slope either way).
        sx, sy = self.scene.ground_slope
        if sx != 0.0 or sy != 0.0:
            t[2] += self.scene.ground_z + sx * t[0] + sy * t[1]
        return np.concatenate([q, t]).astype(np.float32)

    def scan_at(self, pose7: np.ndarray, scan_index: int = 0) -> np.ndarray:
        pts, hit = beam_scan(self.scene.at_scan(scan_index), pose7,
                             self.elev_deg, self.n_azimuth,
                             range_noise_m=self.range_noise_m,
                             rng=self._rng)
        self.last_hit_rate = float(hit.mean())
        return pts

    def _scan_with_ranges(self, pose7: np.ndarray, scan_index: int = 0):
        pts, ranges = beam_scan_packed(self.scene.at_scan(scan_index),
                                       pose7, self.elev_deg,
                                       self.n_azimuth,
                                       range_noise_m=self.range_noise_m,
                                       rng=self._rng)
        self.last_hit_rate = float((ranges > 0).mean())
        return pts, ranges

    def __iter__(self) -> Iterator[ScanFrame]:
        # Pure numpy odometry chain: keeps the stream jax-free so CPU
        # baselines can replay it before any jax runtime threads exist.
        odom = None
        prev_gt = None
        for i in range(self.n_scans):
            gt = self.gt_pose(i)
            if prev_gt is None:
                odom = gt.astype(np.float64)
            else:
                rel = _np_compose(_np_inverse(prev_gt.astype(np.float64)),
                                  gt.astype(np.float64))
                if self.odom_noise > 0:
                    rel = _np_compose(rel, _np_se3_exp(
                        self._rng.normal(size=6) * self.odom_noise))
                odom = _np_compose(odom, rel)
            prev_gt = gt
            if self.packed:
                pts, ranges = self._scan_with_ranges(gt, scan_index=i)
            else:
                pts, ranges = self.scan_at(gt, scan_index=i), None
            yield ScanFrame(time_ns=i * self.period_ns,
                            odom_pose7=odom.astype(np.float32),
                            points=pts, gt_pose7=gt, range_words=ranges)


def velodyne_packets_for_pose(scene: BeamScene, pose7: np.ndarray,
                              n_blocks: int = 180,
                              elev_deg: Optional[np.ndarray] = None,
                              max_range_m: float = 80.0,
                              min_range_m: float = 1.0,
                              range_noise_m: float = 0.0,
                              rng: Optional[np.random.Generator] = None,
                              blocks_per_rev: Optional[int] = None,
                              az_start_deg: float = 0.0):
    """Ray-cast ``n_blocks`` firings from ``pose7`` directly into RAW
    Velodyne data packets (list of 1206-byte blobs, ``n_blocks/12``).

    The inverse of the native decoder (native/io.cpp:102-158): each
    block carries 32 channels (two 16-laser firing sequences, elevation
    ``elev_deg[c % 16]`` in FIRING order) at the decoder's interpolated
    azimuth ``az_block + gap * c/32``, so decode(packets) reproduces the
    cast rays exactly.  Misses and out-of-range returns encode as word 0
    (no echo).  Feed through :class:`bag_writer.BagWriter`'s
    ``write_velodyne_scan`` to synthesize full sensor bags
    (tests/test_bag_e2e.py; the reference validates against exactly such
    a recorded bag, velodyne_assembler/launch/test/test.launch:4-21).

    By default the blocks cover one full revolution.  To simulate a
    MOVING sensor, call once per packet (``n_blocks=12``) with
    ``blocks_per_rev`` fixing the angular step and ``az_start_deg``
    advancing 12 blocks per call while ``pose7`` follows the trajectory
    — the motion skew the assembler's de-skew chain then has to undo
    (velodyne_assembler_ros.cpp:115-138).
    """
    if n_blocks % 12:
        raise ValueError('n_blocks must be a multiple of 12')
    elev = np.asarray(VLP16_ELEV_DEG if elev_deg is None
                      else elev_deg, np.float64)
    n_lasers = len(elev)
    gap = 360.0 / (blocks_per_rev if blocks_per_rev else n_blocks)
    if gap > 10.0:
        # The decoder treats block-azimuth gaps above 10 deg as stream
        # discontinuities and skips interpolation (io.cpp:132), so the
        # synthesized interpolated rays would not round-trip.  Real
        # sensors fire >=180 blocks per revolution (gap <= 2 deg).
        raise ValueError(
            f'azimuth gap {gap:.1f} deg exceeds the decoder\'s 10 deg '
            'interpolation threshold; use >=36 blocks per revolution')
    blocks = az_start_deg + np.arange(n_blocks, dtype=np.float64) * gap
    ch = np.arange(32, dtype=np.float64)
    az_deg = blocks[:, None] + gap * ch[None, :] / 32.0        # [NB,32]
    a = np.deg2rad(az_deg)
    d = np.deg2rad(elev[(np.arange(32) % n_lasers)])[None, :]  # [1,32]
    # Decoder geometry: x = r cos(d) sin(a), y = r cos(d) cos(a),
    # z = r sin(d)  (io.cpp:71-73).
    dirs_s = np.stack([np.cos(d) * np.sin(a), np.cos(d) * np.cos(a),
                       np.broadcast_to(np.sin(d), a.shape)], axis=-1)
    Rm = _quat_to_matrix(np.asarray(pose7[:4], np.float64))
    dirs_w = dirs_s.reshape(-1, 3) @ Rm.T
    t = _raycast(scene, np.asarray(pose7[4:], np.float64), dirs_w)
    t = t.reshape(n_blocks, 32)
    if range_noise_m > 0:
        rng = rng or np.random.default_rng(0)
        t = t + rng.normal(size=t.shape) * range_noise_m
    dist = np.where(np.isfinite(t) & (t >= min_range_m)
                    & (t <= max_range_m), t, 0.0)
    return [encode_velodyne_packet(blocks[12 * p:12 * (p + 1)],
                                   dist[12 * p:12 * (p + 1)])
            for p in range(n_blocks // 12)]


def encode_velodyne_packet(azimuths_deg: np.ndarray,
                           dist_m: np.ndarray,
                           intensity: int = 7,
                           return_mode: int = 0x37) -> bytes:
    """One 1206-byte Velodyne data packet (single-return).

    azimuths_deg: [12] block azimuths (0.01-degree words on the wire).
    dist_m: [12, 32] per-(block, channel) distances in metres; 0 or
    NaN/inf encodes no-echo (the decoder drops those returns, and ranges
    beyond the 2-mm word ceiling of 131.07 m are encoded as no-echo, the
    same convention as ops/spherical.encode_ranges).
    """
    azimuths_deg = np.asarray(azimuths_deg, np.float64)
    dist_m = np.asarray(dist_m, np.float64)
    if azimuths_deg.shape != (12,) or dist_m.shape != (12, 32):
        raise ValueError('expected azimuths [12] and dist_m [12,32], got '
                         f'{azimuths_deg.shape} / {dist_m.shape}')
    words = np.round(dist_m / 0.002)
    words = np.where(np.isfinite(words) & (words >= 1) & (words <= 65535),
                     words, 0.0).astype(np.uint16)
    pkt = bytearray(1206)
    for b in range(12):
        off = b * 100
        pkt[off:off + 2] = (0xEEFF).to_bytes(2, 'little')
        az_word = int(round(float(azimuths_deg[b]) % 360.0 * 100)) % 36000
        pkt[off + 2:off + 4] = az_word.to_bytes(2, 'little')
        for c in range(32):
            ro = off + 4 + c * 3
            pkt[ro:ro + 2] = int(words[b, c]).to_bytes(2, 'little')
            pkt[ro + 2] = intensity
    pkt[1204] = return_mode        # factory bytes: return mode + model
    pkt[1205] = 0x22
    return bytes(pkt)
