"""CSV helpers mirroring the reference's free functions
(laser_slam/include/laser_slam/common.hpp:155-230): ``writeCSV``,
``loadCSV``, ``writeEigenMatrixXdCSV``, ``loadEigenMatrixXdCSV`` and the
(time -> value) map conversion ``toEigenMatrixXd`` (common.hpp:232-242),
plus KITTI and TUM trajectory writers.  Counterpart of
``laser_slam_tpu/core/csvio.py``, in numpy only."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def write_csv(rows: Sequence[Sequence[str]], path: str) -> None:
    """Write a matrix of strings as comma-separated rows
    (writeCSV, common.hpp:155-170)."""
    if len(rows) < 1:
        raise ValueError('Provided matrix of strings had no entries.')
    with open(path, 'w') as f:
        for row in rows:
            if len(row) < 1:
                raise ValueError('String matrix row has no entries.')
            f.write(','.join(str(x) for x in row) + '\n')


def load_csv(path: str) -> List[List[str]]:
    """Read a CSV into a matrix of strings (loadCSV, common.hpp:189-208)."""
    with open(path) as f:
        return [line.rstrip('\n').split(',') for line in f]


def write_matrix_csv(matrix: np.ndarray, path: str) -> None:
    """(writeEigenMatrixXdCSV, common.hpp:173-186)."""
    np.savetxt(path, np.atleast_2d(np.asarray(matrix)), delimiter=',',
               fmt='%.9g')


def load_matrix_csv(path: str) -> np.ndarray:
    """(loadEigenMatrixXdCSV, common.hpp:211-230)."""
    return np.atleast_2d(np.loadtxt(path, delimiter=',', dtype=np.float64))


def time_value_map_to_matrix(values: Dict[int, float]) -> np.ndarray:
    """{time: value} -> [N,2] matrix (toEigenMatrixXd, common.hpp:232-242)."""
    out = np.zeros((len(values), 2))
    for i, (t, v) in enumerate(sorted(values.items())):
        out[i] = (t, v)
    return out


def _rotation_matrices(q: np.ndarray) -> np.ndarray:
    """[N,4] wxyz quaternions -> [N,3,3] rotations, in float32 as the
    JAX package's ``se3.quat_to_matrix``."""
    w, x, y, z = (q[:, i] for i in range(4))
    one, two = np.float32(1), np.float32(2)
    return np.stack([
        np.stack([one - two * (y * y + z * z), two * (x * y - w * z),
                  two * (x * z + w * y)], -1),
        np.stack([two * (x * y + w * z), one - two * (x * x + z * z),
                  two * (y * z - w * x)], -1),
        np.stack([two * (x * z - w * y), two * (y * z + w * x),
                  one - two * (x * x + y * y)], -1)], -2)


def write_trajectory_kitti(times_poses, path: str) -> None:
    """KITTI odometry pose format: one row per pose, the 3x4 [R|t] of
    T_world_sensor flattened row-major (12 floats, space-separated, no
    timestamps), for standard odometry evaluators (evo, kitti-devkit);
    the reference only exported its own CSV
    (laser_slam_worker.cpp:551-603).

    times_poses: iterable of (time_ns, pose7 [qw,qx,qy,qz,tx,ty,tz]),
    written in iteration order (sort by time first for KITTI tools).
    """
    p = np.asarray([np.asarray(pose, np.float32) for _, pose in times_poses],
                   np.float32).reshape(-1, 7)
    rt = np.concatenate([_rotation_matrices(p[:, :4]), p[:, 4:, None]], -1)
    np.savetxt(path, rt.reshape(-1, 12), fmt='%.9f')


def write_trajectory_tum(times_poses, path: str) -> None:
    """TUM trajectory format: ``timestamp tx ty tz qx qy qz qw`` per row
    (timestamp in seconds).  The quaternion is xyzw-LAST, unlike the
    wxyz-first pose7 convention."""
    rows = []
    for t_ns, p in times_poses:
        p = np.asarray(p, np.float64)
        rows.append([t_ns * 1e-9, p[4], p[5], p[6], p[1], p[2], p[3], p[0]])
    np.savetxt(path, np.asarray(rows), fmt='%.9f')
