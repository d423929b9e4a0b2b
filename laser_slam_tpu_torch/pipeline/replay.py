"""Replay streams: synthetic scans + odometry, with numpy and the port's se3.

Counterpart of ``ScanFrame`` and ``SyntheticStream`` in
``laser_slam_tpu/pipeline/replay.py``: the same box-room world, the same
trajectories and the same numpy random stream, so one seed gives the
same scans as the JAX package's stream; the portable npz log format
(:func:`save_npz_stream` / :func:`load_npz_stream`); and the replay main
loop of the host API (:func:`run_worker_on_stream`).  The KITTI reader
is still to be ported (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from laser_slam_tpu_torch.ops import se3


@dataclasses.dataclass
class ScanFrame:
    time_ns: int
    odom_pose7: Optional[np.ndarray]   # odometry estimate (None if absent)
    points: np.ndarray                 # [N,3] float32, sensor frame
    gt_pose7: Optional[np.ndarray] = None  # ground truth if known
    # Sensor-native packed scan (uint16 [n_beams, n_azimuth], 0 = no
    # echo), when the stream provides one (velodyne_sim.BeamStream with
    # packed=True); feed it to a runner after enable_packed_ingest.
    range_words: Optional[np.ndarray] = None


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


class SyntheticStream:
    """Simulated LiDAR scans in a structured world.

    The world is a box room with walls, floor and scattered box obstacles
    — plane-rich so point-to-plane ICP is well conditioned.  Trajectories:
    'circle' (loop for loop-closure tests) or 'line'.
    """

    def __init__(self, n_scans: int = 50, points_per_scan: int = 8192,
                 trajectory: str = 'circle', radius_m: float = 20.0,
                 world_size_m: float = 60.0, noise_m: float = 0.01,
                 odom_noise: float = 0.0, seed: int = 0,
                 period_ns: int = int(1e8), step_m: float = 1.0,
                 world_points: int = 65536, laps: int = 1,
                 center_m: tuple = (0.0, 0.0)):
        """``center_m`` offsets the circle trajectory from the room
        center (breaks the square room's 180-degree symmetry)."""
        self.n_scans = n_scans
        self.laps = laps
        self.center_m = center_m
        self.points_per_scan = points_per_scan
        self.trajectory = trajectory
        self.radius_m = radius_m
        self.step_m = step_m
        self.noise_m = noise_m
        self.odom_noise = odom_noise
        self.period_ns = period_ns
        self._rng = np.random.default_rng(seed)
        self.world_points = world_points
        self.world = self._make_world(world_size_m)

    def _make_world(self, size: float) -> np.ndarray:
        rng = self._rng
        n = self.world_points
        half = size / 2
        n6 = n // 6
        parts = [
            # floor
            np.stack([rng.uniform(-half, half, n6),
                      rng.uniform(-half, half, n6), np.zeros(n6)], 1),
            # four walls
            np.stack([rng.uniform(-half, half, n6), np.full(n6, half),
                      rng.uniform(0, 8, n6)], 1),
            np.stack([rng.uniform(-half, half, n6), np.full(n6, -half),
                      rng.uniform(0, 8, n6)], 1),
            np.stack([np.full(n6, half), rng.uniform(-half, half, n6),
                      rng.uniform(0, 8, n6)], 1),
            np.stack([np.full(n6, -half), rng.uniform(-half, half, n6),
                      rng.uniform(0, 8, n6)], 1),
        ]
        # box obstacles
        m = n - 5 * n6
        centers = rng.uniform(-half * 0.7, half * 0.7, size=(12, 2))
        boxes = []
        per = m // 12
        for cx, cy in centers:
            face = rng.integers(0, 4, per)
            u = rng.uniform(-1.5, 1.5, per)
            z = rng.uniform(0, 3, per)
            x = np.where(face == 0, cx + 1.5, np.where(face == 1, cx - 1.5,
                                                       cx + u))
            y = np.where(face < 2, cy + u, np.where(face == 2, cy + 1.5,
                                                    cy - 1.5))
            boxes.append(np.stack([x, y, z], 1))
        parts.append(np.concatenate(boxes)[:m])
        return np.concatenate(parts).astype(np.float32)

    def gt_pose(self, i: int) -> np.ndarray:
        if self.trajectory == 'circle':
            # laps > 1 revisits the same poses (loop-closure workloads).
            ang = 2 * np.pi * i * self.laps / self.n_scans
            yaw = ang + np.pi / 2
            q = np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)], np.float32)
            t = np.array([self.center_m[0] + self.radius_m * np.cos(ang),
                          self.center_m[1] + self.radius_m * np.sin(ang),
                          1.5], np.float32)
        elif self.trajectory == 'line':
            q = np.array([1, 0, 0, 0], np.float32)
            t = np.array([self.step_m * i, 0.0, 1.5], np.float32)
        else:
            raise ValueError(self.trajectory)
        return np.concatenate([q, t]).astype(np.float32)

    def scan_at(self, pose7: np.ndarray) -> np.ndarray:
        """Sample a scan: world points visible within range, in the sensor
        frame, with measurement noise."""
        local = se3.apply(se3.inverse(_t(pose7)), _t(self.world)).numpy()
        d = np.linalg.norm(local, axis=1)
        vis = d < 50.0
        idx = np.flatnonzero(vis)
        if len(idx) > self.points_per_scan:
            idx = self._rng.choice(idx, self.points_per_scan, replace=False)
        pts = local[idx]
        return (pts + self._rng.normal(size=pts.shape) * self.noise_m
                ).astype(np.float32)

    def __iter__(self) -> Iterator[ScanFrame]:
        odom = None
        prev_gt = None
        for i in range(self.n_scans):
            gt = self.gt_pose(i)
            if prev_gt is None:
                odom = gt.copy()
            else:
                rel = se3.compose(se3.inverse(_t(prev_gt)), _t(gt))
                if self.odom_noise > 0:
                    rel = se3.compose(rel, se3.exp(_t(
                        self._rng.normal(size=6).astype(np.float32)
                        * self.odom_noise)))
                odom = se3.normalize(se3.compose(_t(odom), rel)).numpy()
            prev_gt = gt
            yield ScanFrame(time_ns=i * self.period_ns,
                            odom_pose7=odom.copy(),
                            points=self.scan_at(gt),
                            gt_pose7=gt)


def make_scene(rng: np.random.Generator, n_world: int = 200_000,
               extent: float = 80.0) -> np.ndarray:
    """bench.py's Velodyne-like structured scene (bench.py:129-152):
    ground, a ring of walls and 40 boxes, [n_world, 3] f32."""
    n1 = n_world // 3
    ground = np.stack([rng.uniform(-extent, extent, n1),
                       rng.uniform(-extent, extent, n1),
                       rng.normal(0, 0.02, n1)], 1)
    n2 = n_world // 3
    angs = rng.uniform(0, 2 * np.pi, n2)
    walls = np.stack([extent * 0.9 * np.cos(angs),
                      extent * 0.9 * np.sin(angs),
                      rng.uniform(0, 6, n2)], 1)
    m = n_world - n1 - n2
    centers = rng.uniform(-60, 60, size=(40, 2))
    boxes = []
    per = m // 40
    for cx, cy in centers:
        face = rng.integers(0, 4, per)
        u = rng.uniform(-2, 2, per)
        z = rng.uniform(0, 4, per)
        x = np.where(face == 0, cx + 2, np.where(face == 1, cx - 2, cx + u))
        y = np.where(face < 2, cy + u, np.where(face == 2, cy + 2, cy - 2))
        boxes.append(np.stack([x, y, z], 1))
    pts = np.concatenate([ground, walls] + boxes)[:n_world]
    return pts.astype(np.float32)


def sample_scan(rng: np.random.Generator, world: np.ndarray,
                pose_t: np.ndarray, n_pts: int,
                noise: float = 0.02) -> np.ndarray:
    """bench.py's scan of ``make_scene`` (bench.py:155-161): up to
    ``n_pts`` points within 75 m of ``pose_t``, in its frame, with
    Gaussian noise."""
    local = world - pose_t[None, :]
    d = np.linalg.norm(local, axis=1)
    idx = np.flatnonzero(d < 75.0)
    idx = rng.choice(idx, min(n_pts, len(idx)), replace=False)
    return (local[idx] + rng.normal(size=(len(idx), 3)) * noise
            ).astype(np.float32)


def save_npz_stream(frames: Sequence[ScanFrame], path: str) -> None:
    """Persist a stream as one npz (ragged scans stored object-free by
    concatenation + offsets), in the JAX package's format."""
    points = np.concatenate([f.points for f in frames])
    offsets = np.cumsum([0] + [len(f.points) for f in frames])
    np.savez_compressed(
        path,
        points=points, offsets=offsets,
        times=np.asarray([f.time_ns for f in frames], np.int64),
        odom=np.stack([f.odom_pose7 if f.odom_pose7 is not None
                       else np.full(7, np.nan) for f in frames]),
        gt=np.stack([f.gt_pose7 if f.gt_pose7 is not None
                     else np.full(7, np.nan) for f in frames]))


def load_npz_stream(path: str) -> List[ScanFrame]:
    with np.load(path) as z:
        times, offsets = z['times'], z['offsets']
        points, odoms, gts = z['points'], z['odom'], z['gt']
    frames = []
    for i in range(len(times)):
        odom, gt = odoms[i], gts[i]
        frames.append(ScanFrame(
            time_ns=int(times[i]),
            odom_pose7=None if np.isnan(odom[0]) else odom.astype(np.float32),
            points=points[offsets[i]:offsets[i + 1]].astype(np.float32),
            gt_pose7=None if np.isnan(gt[0]) else gt.astype(np.float32)))
    return frames


def run_worker_on_stream(worker, stream, max_scans: Optional[int] = None,
                         loop_closure_hook=None):
    """Drive a LaserSlamWorker over a stream (the replay main loop).

    ``loop_closure_hook(worker, frame_index)`` is called after each
    integrated scan, so tests and benchmarks can inject closures (the
    reference's closures come from the external segmatch node).
    Returns the number of integrated scans.
    """
    n = 0
    for i, frame in enumerate(stream):
        if max_scans is not None and i >= max_scans:
            break
        ok = worker.process_scan(frame.time_ns, frame.points,
                                 frame.odom_pose7)
        if ok:
            n += 1
            if loop_closure_hook is not None:
                loop_closure_hook(worker, i)
    return n
