"""Core host-side data types.

Counterpart of ``laser_slam_tpu/core/types.py``: the reference's
``Pose``, ``RelativePose``, ``LaserScan`` structs
(laser_slam/include/laser_slam/common.hpp:87-120) and
``OptimizationResult`` (common.hpp:244-261).  Times are integer
nanoseconds; transforms are numpy pose7 arrays ([qw,qx,qy,qz,tx,ty,tz],
see ops.se3).  A scan's cloud and normals are tensors on the track's
device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

Time = int  # nanoseconds


def identity_pose7() -> np.ndarray:
    return np.array([1.0, 0, 0, 0, 0, 0, 0], np.float32)


@dataclass
class Pose:
    """Absolute transform + time stamp (common.hpp:87-94)."""
    T_w: np.ndarray = field(default_factory=identity_pose7)  # pose7
    time_ns: Time = 0
    key: int = 0


@dataclass
class RelativePose:
    """Relative transform between two stamped nodes (common.hpp:97-110).

    ``track_id_a/b`` support cross-track (multi-robot) loop closures.
    """
    T_a_b: np.ndarray = field(default_factory=identity_pose7)  # pose7
    time_a_ns: Time = 0
    time_b_ns: Time = 0
    key_a: int = 0
    key_b: int = 0
    track_id_a: int = 0
    track_id_b: int = 0


@dataclass
class LaserScan:
    """A point-cloud scan + time stamp (common.hpp:113-120).

    ``cloud`` is an ops.cloud.Cloud on the track's device; ``normals``
    [N,3] are estimated once at ingest (rigid transforms preserve them,
    so the reference's per-reference SamplingSurfaceNormal is not
    repeated).
    """
    cloud: object = None          # ops.cloud.Cloud
    time_ns: Time = 0
    key: int = 0
    normals: object = None        # torch.Tensor [N,3] or None


@dataclass
class OptimizationResult:
    """Solver run summary (common.hpp:244-261)."""
    num_iterations: int = 0
    num_intermediate_steps: int = 0
    num_variables: int = 0
    initial_error: float = 0.0
    final_error: float = 0.0
    duration_ms: float = 0.0
    duration_cpu_ms: float = 0.0


# Trajectory: time_ns -> pose7, mirroring typedef std::map<Time, SE3>
# (common.hpp:133).
Trajectory = Dict[Time, np.ndarray]
