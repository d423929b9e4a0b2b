"""Time-indexed SE(3) trajectory container.

Counterpart of ``laser_slam_tpu/core/trajectory.py`` (the reference's
mincurves ``curves::DiscreteSE3Curve``, laser_track.hpp:147,208): a
growable (times, poses, keys) table on the host whose keys the
estimator allocates.  Evaluation at a knot returns it exactly; between
knots it interpolates on the connecting geodesic (slerp + lerp), as
``findNearestPose`` and the odometry-free mode use it
(laser_slam_worker.cpp:148).  The interpolation runs the port's se3 on
CPU tensors: one 7-float pose is not worth a launch and a read.
"""

from __future__ import annotations

import numpy as np
import torch

from laser_slam_tpu_torch.core.types import Time
from laser_slam_tpu_torch.ops import se3


class SE3Trajectory:
    def __init__(self, capacity: int = 256):
        self._times = np.zeros((capacity,), np.int64)
        self._poses = np.zeros((capacity, 7), np.float32)
        self._poses[:, 0] = 1.0
        self._keys = np.zeros((capacity,), np.int64)
        self.size = 0

    # -- capacity -----------------------------------------------------------
    def _grow(self):
        cap = self._times.shape[0] * 2
        for name in ('_times', '_poses', '_keys'):
            old = getattr(self, name)
            new = np.zeros((cap,) + old.shape[1:], old.dtype)
            new[:old.shape[0]] = old
            setattr(self, name, new)
        self._poses[self.size:, 0] = 1.0

    # -- mutation -----------------------------------------------------------
    def extend(self, time_ns: Time, pose7, key: int) -> None:
        """Append a knot (DiscreteSE3Curve::extend,
        laser_track.cpp:573-582).  Times must be strictly increasing."""
        if self.size and time_ns <= self._times[self.size - 1]:
            raise ValueError(
                f'non-increasing trajectory time {time_ns} after '
                f'{self._times[self.size - 1]}')
        if self.size == self._times.shape[0]:
            self._grow()
        self._times[self.size] = time_ns
        self._poses[self.size] = np.asarray(pose7, np.float32)
        self._keys[self.size] = key
        self.size += 1

    def update_from_values(self, values: np.ndarray) -> None:
        """Overwrite knot poses from a solver result table indexed by key
        (DiscreteSE3Curve::updateFromGTSAMValues,
        laser_track.cpp:416-419)."""
        keys = self._keys[:self.size]
        self._poses[:self.size] = values[keys]

    # -- queries ------------------------------------------------------------
    def is_empty(self) -> bool:
        return self.size == 0

    def min_time(self) -> Time:
        return int(self._times[0]) if self.size else 0

    def max_time(self) -> Time:
        return int(self._times[self.size - 1]) if self.size else 0

    def times(self) -> np.ndarray:
        return self._times[:self.size].copy()

    def keys(self) -> np.ndarray:
        return self._keys[:self.size].copy()

    def poses(self) -> np.ndarray:
        return self._poses[:self.size].copy()

    def key_at(self, time_ns: Time) -> int:
        i = int(np.searchsorted(self._times[:self.size], time_ns))
        if i >= self.size or self._times[i] != time_ns:
            raise KeyError(f'no trajectory node at time {time_ns}')
        return int(self._keys[i])

    def evaluate(self, time_ns: Time) -> np.ndarray:
        """Pose at a time: exact at knots, interpolated between them
        (DiscreteSE3Curve::evaluate semantics)."""
        if not self.size:
            raise ValueError('empty trajectory')
        t = self._times[:self.size]
        if time_ns <= t[0]:
            return self._poses[0].copy()
        if time_ns >= t[self.size - 1]:
            return self._poses[self.size - 1].copy()
        i = int(np.searchsorted(t, time_ns))
        if t[i] == time_ns:
            return self._poses[i].copy()
        t0, t1 = t[i - 1], t[i]
        alpha = float(time_ns - t0) / float(t1 - t0)
        a = torch.from_numpy(self._poses[i - 1].copy())
        b = torch.from_numpy(self._poses[i].copy())
        return se3.retract(a, alpha * se3.local(a, b)).numpy()

    def as_dict(self):
        """Trajectory as {time_ns: pose7} (getTrajectory,
        laser_track.cpp:268-278)."""
        return {int(self._times[i]): self._poses[i].copy()
                for i in range(self.size)}

    def save_csv(self, path: str) -> None:
        """time_ns,x,y,z rows (exportTrajectories format,
        laser_slam_worker.cpp:551-565)."""
        m = np.zeros((self.size, 4))
        m[:, 0] = self._times[:self.size]
        m[:, 1:] = self._poses[:self.size, 4:]
        np.savetxt(path, m, delimiter=',', fmt='%.9g')
