"""Replay streams: synthetic scans + odometry, with numpy and the port's se3.

Counterpart of ``ScanFrame`` and ``SyntheticStream`` in
``laser_slam_tpu/pipeline/replay.py``: the same box-room world, the same
trajectories and the same numpy random stream, so one seed gives the
same scans as the JAX package's stream.  The npz and KITTI readers are
still to be ported (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

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
