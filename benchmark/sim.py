"""Beam-model LiDAR simulator, the benchmark's frozen copy.

The same semantics as ``laser_slam_tpu_torch/pipeline/velodyne_sim.py``
(``make_beam_scene``, ``make_repeated_rooms_scene``, ``beam_directions``,
``_raycast``, ``beam_scan``): an HDL-64E-class elevation table, azimuth
firings, the nearest intersection with a ground plane, four walls and
box obstacles, Gaussian range noise.  The scenes are built with numpy's
generator exactly as there, so one scene seed gives the same boxes.  The
rays are cast in torch float64 on whatever device the caller names, for
many scans in one call, so a run makes its inputs on the card.

The program under test may change; this file may not: it is part of the
yardstick.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# HDL-64E elevation table (the KITTI odometry sensor's span): 64 beams
# from +2 deg down to -24.8 deg, top to bottom.
HDL64_ELEV_DEG = (2.0, -24.8, 64)


@dataclasses.dataclass(frozen=True)
class Scene:
    """Analytic surfaces: walls at x, y = +-half_size spanning z in [0,
    wall_height] (none when wall_height is 0), a flat ground at z =
    ground_z, and axis-aligned boxes [K,2,3] (min, max corners)."""
    half_size: float
    wall_height: float
    boxes: np.ndarray
    ground_z: float = 0.0


def outdoor_scene(seed: int, world_size_m: float = 60.0, n_boxes: int = 12,
                  box_height_m: float = 3.0) -> Scene:
    """Box room with scattered box obstacles (``make_beam_scene``)."""
    rng = np.random.default_rng(seed)
    half = world_size_m / 2
    centers = rng.uniform(-half * 0.7, half * 0.7, size=(n_boxes, 2))
    half_extents = rng.uniform(0.8, 2.0, size=(n_boxes, 2))
    boxes = np.zeros((n_boxes, 2, 3), np.float64)
    boxes[:, 0, :2] = centers - half_extents
    boxes[:, 1, :2] = centers + half_extents
    boxes[:, 1, 2] = box_height_m
    return Scene(half_size=half, wall_height=8.0, boxes=boxes)


def repeated_rooms_scene(seed: int, n_rooms: int = 4,
                         room_spacing_m: float = 30.0) -> Scene:
    """The same cluster of six boxes every ``room_spacing_m`` along +x,
    no walls within range (``make_repeated_rooms_scene``)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-8.0, 8.0, size=(6, 2))
    half_extents = rng.uniform(0.8, 2.0, size=(6, 2))
    cluster = np.zeros((6, 2, 3), np.float64)
    cluster[:, 0, :2] = centers - half_extents
    cluster[:, 1, :2] = centers + half_extents
    cluster[:, 1, 2] = 3.0
    rooms = []
    for k in range(n_rooms):
        shifted = cluster.copy()
        shifted[:, :, 0] += k * room_spacing_m
        rooms.append(shifted)
    return Scene(half_size=500.0, wall_height=0.0,
                 boxes=np.concatenate(rooms, axis=0))


SCENES = {'outdoor': outdoor_scene, 'repeated_rooms': repeated_rooms_scene}


def make_scene(spec: dict) -> Scene:
    """The scene a traffic file describes: ``{"kind": ..., **kwargs}``."""
    kw = {k: v for k, v in spec.items() if k != 'kind'}
    return SCENES[spec['kind']](**kw)


def clearance(scene: Scene, xy: np.ndarray) -> np.ndarray:
    """Distance in the plane from each point [P,2] to the nearest box
    (negative inside one)."""
    lo = scene.boxes[None, :, 0, :2]
    hi = scene.boxes[None, :, 1, :2]
    p = np.asarray(xy, np.float64)[:, None, :]
    outside = np.linalg.norm(np.maximum(np.maximum(lo - p, p - hi), 0.0),
                             axis=-1)
    inside = np.min(np.minimum(p - lo, hi - p), axis=-1)
    d = np.where(outside > 0.0, outside, -inside)
    return d.min(axis=1) if len(scene.boxes) else np.full(len(xy), np.inf)


def elevation_table(spec) -> torch.Tensor:
    """Elevations in degrees from ``(top, bottom, beams)``."""
    top, bottom, n = spec
    return torch.linspace(float(top), float(bottom), int(n),
                          dtype=torch.float64)


def beam_directions(elev_deg: torch.Tensor, n_azimuth: int,
                    device) -> torch.Tensor:
    """Sensor-frame unit directions [beams * n_azimuth, 3], ring-major,
    azimuth 0 at +x counter-clockwise at the centre of each firing."""
    elev = torch.deg2rad(elev_deg.to(device))[:, None]
    az = (2 * math.pi * (torch.arange(n_azimuth, dtype=torch.float64,
                                      device=device) + 0.5)
          / n_azimuth)[None, :]
    ce = torch.cos(elev)
    x = ce * torch.cos(az)
    y = ce * torch.sin(az)
    z = torch.sin(elev).expand_as(x)
    return torch.stack([x, y, z], dim=-1).reshape(-1, 3)


def raycast(scene: Scene, origins: torch.Tensor,
            dirs: torch.Tensor) -> torch.Tensor:
    """Nearest-intersection distances [S,R] (inf = miss) of world-frame
    rays dirs [S,R,3] from origins [S,3], float64."""
    o = origins[:, None, :]
    d = dirs
    eps = 1e-9
    half, zh = scene.half_size, scene.wall_height
    inf = torch.full(d.shape[:2], math.inf, dtype=d.dtype, device=d.device)

    dz = d[..., 2]
    tg = torch.where(dz < -eps,
                     (scene.ground_z - o[..., 2]) / torch.clamp(dz, max=-eps),
                     inf)
    xy = o[..., :2] + tg[..., None] * d[..., :2]
    hit = (tg > 0) & torch.isfinite(tg) & torch.all(torch.abs(xy) <= half,
                                                    dim=-1)
    t_best = torch.where(hit, tg, inf)

    for axis, sign in ((0, 1.0), (0, -1.0), (1, 1.0), (1, -1.0)):
        da = d[..., axis]
        denom = torch.where(torch.abs(da) > eps, da,
                            torch.full_like(da, eps))
        tw = (sign * half - o[..., axis]) / denom
        other = 1 - axis
        po = o[..., other] + tw * d[..., other]
        pz = o[..., 2] + tw * dz
        ok = ((tw > 0) & (torch.abs(po) <= half) & (pz >= 0) & (pz <= zh)
              & (torch.sign(da) == sign))
        t_best = torch.where(ok, torch.minimum(t_best, tw), t_best)

    if len(scene.boxes):
        boxes = torch.as_tensor(scene.boxes, dtype=d.dtype, device=d.device)
        lo = boxes[None, None, :, 0, :]
        hi = boxes[None, None, :, 1, :]
        dd = d[:, :, None, :]
        inv = 1.0 / torch.where(torch.abs(dd) > eps, dd,
                                torch.full_like(dd, eps))
        t1 = (lo - o[:, :, None, :]) * inv
        t2 = (hi - o[:, :, None, :]) * inv
        tmin = torch.minimum(t1, t2).amax(dim=-1)
        tmax = torch.maximum(t1, t2).amin(dim=-1)
        okb = (tmax >= tmin) & (tmax > 0) & (tmin > 0)
        tb = torch.where(okb, tmin, torch.full_like(tmin, math.inf))
        t_best = torch.minimum(t_best, tb.amin(dim=-1))
    return t_best


def yaw_matrix(yaw: torch.Tensor) -> torch.Tensor:
    """Rotations [...,3,3] about +z by ``yaw`` radians."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, one = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack([c, -s, z, s, c, z, z, z, one],
                       dim=-1).reshape(yaw.shape + (3, 3))


def cast_scans(scene: Scene, rot: torch.Tensor, origin: torch.Tensor,
               elev_deg: torch.Tensor, n_azimuth: int, gen: torch.Generator,
               max_range_m: float = 80.0, min_range_m: float = 1.5,
               range_noise_m: float = 0.02, chunk: int = 8):
    """Full revolutions from S sensor poses (rot [S,3,3], origin [S,3],
    world frame), in chunks of ``chunk`` scans.  Returns sensor-frame
    points [S,R,3] float64 and the hit mask [S,R]: a ray returns a point
    when it meets a surface within [min_range, max_range] (``beam_scan``).
    The noise comes from ``gen``, one draw a ray."""
    device = origin.device
    dirs_s = beam_directions(elev_deg, n_azimuth, device)
    pts, hits = [], []
    for s in range(0, origin.shape[0], chunk):
        R = rot[s:s + chunk]
        dirs_w = torch.einsum('sij,rj->sri', R, dirs_s)
        t = raycast(scene, origin[s:s + chunk], dirs_w)
        hit = torch.isfinite(t) & (t >= min_range_m) & (t <= max_range_m)
        noise = torch.randn(t.shape, generator=gen, dtype=torch.float64,
                            device=device) * range_noise_m
        r = torch.where(hit, t + noise, torch.zeros_like(t))
        pts.append(dirs_s[None] * r[..., None])
        hits.append(hit)
    return torch.cat(pts), torch.cat(hits)


def pick(hit: torch.Tensor, keep_prob: float, capacity: int,
         gen: torch.Generator):
    """Random selection of at most ``capacity`` hit rays a scan [S,R]:
    each hit is kept with ``keep_prob`` (upstream's RandomSampling), then
    the kept ones beyond ``capacity`` are dropped at random.  Returns
    (rows [S,capacity] int64, mask [S,capacity]): the rays in random
    order, the mask False where fewer were kept."""
    u = torch.rand(hit.shape, generator=gen, dtype=torch.float64,
                   device=hit.device)
    u = torch.where(hit & (u < keep_prob), u, torch.full_like(u, 2.0))
    vals, rows = torch.topk(u, capacity, dim=-1, largest=False, sorted=True)
    return rows, vals < keep_prob
