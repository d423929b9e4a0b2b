"""LaserSlamWorker: the per-robot orchestrator of the host API.

Counterpart of ``laser_slam_tpu/pipeline/worker.py`` (the reference's
``LaserSlamWorker``, laser_slam_ros/include/laser_slam_ros/
laser_slam_worker.hpp:19-166, src/laser_slam_worker.cpp) with ROS
transport replaced by an in-process stream API: the worker consumes
``(time_ns, odom_pose7, points)`` frames (pipeline.replay) and returns
results as arrays.

* scan gating by minimum travel distance (scanCallback:109-120);
* odometry-free mode: a constant-velocity pose guess when no odometry is
  available (scanCallback:135-162);
* LaserTrack + IncrementalEstimator per scan (:128-173);
* the world-to-odom correction (:175-191);
* the local map and its voxel/cylindrical filtering with optional
  distant-map separation (:235-246, getFilteredMap:415-488), and its
  re-rigidification after loop closures (updateLocalMap:522-540);
* trajectory exports (exportTrajectories:551-603) and the full (scans +
  optimized poses) dump (getLaserTracksServiceCall:260-317).

The split between host and device is the JAX package's: the map buffer
is a host numpy array of ``local_map_capacity`` rows, each scan's world
points are read back to it, and ``get_filtered_map`` filters it on the
estimator's device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from laser_slam_tpu_torch.config import WorkerConfig
from laser_slam_tpu_torch.core import benchmarker as bench
from laser_slam_tpu_torch.core import csvio
from laser_slam_tpu_torch.core.estimator import IncrementalEstimator
from laser_slam_tpu_torch.core.laser_track import host_pose
from laser_slam_tpu_torch.core.types import Pose, Time
from laser_slam_tpu_torch.ops import cloud as pc
from laser_slam_tpu_torch.ops import se3


def _filter_local_map(points, mask, center, radius, height, voxel_size,
                      min_points):
    """Cylindrical + voxel filtering of the local map
    (getFilteredMap, laser_slam_worker.cpp:423-440): (near, far) clouds."""
    c = pc.Cloud(points, mask)
    near = pc.cylindrical_filter(c, center, radius, height, False)
    near = pc.voxel_filter(near, voxel_size, min_points)
    far = pc.cylindrical_filter(c, center, radius, height, True)
    far = pc.voxel_filter(far, voxel_size, min_points)
    return near, far


def _valid_points(cloud: pc.Cloud) -> np.ndarray:
    """A cloud's valid points on the host, [n,3] (one read)."""
    return cloud.points[cloud.mask].cpu().numpy()


class LaserSlamWorker:
    def __init__(self, params: WorkerConfig,
                 incremental_estimator: IncrementalEstimator,
                 worker_id: int = 0):
        """The worker runs on its estimator's device."""
        self.params = params
        self.estimator = incremental_estimator
        self.device = incremental_estimator.device
        self.worker_id = worker_id
        self.laser_track = incremental_estimator.get_laser_track(worker_id)

        self._last_pose: Optional[np.ndarray] = None  # distance gate
        self._last_pose_sent: Optional[Pose] = None   # odometry-free mode
        self._base_time_ns: Optional[int] = None
        # world_to_odom correction (identity until the first estimate,
        # laser_slam_worker.cpp:74-79).
        self.world_to_odom = se3.identity().numpy()

        # scanCallback gate used by loop-closure handlers
        # (setLockScanCallback, laser_slam_worker.cpp:255-258).
        self._lock_scan_callback = False

        cap = params.local_map_capacity
        self._map_points = np.full((cap, 3), pc.SENTINEL, np.float32)
        self._map_count = 0
        self._local_map_queue: List[np.ndarray] = []
        # Distant map: an amortized-doubling buffer (appends happen on
        # every get_filtered_map call).
        self._distant_buf = np.zeros((0, 3), np.float32)
        self._distant_count = 0
        self._local_map_filtered: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    # Time rebasing (laser_slam_worker.cpp:394-405)
    # ------------------------------------------------------------------

    def _to_curve_time(self, time_ns: Time) -> Time:
        if self._base_time_ns is None:
            self._base_time_ns = time_ns
        return time_ns - self._base_time_ns

    def curve_time_to_stream_time(self, time_ns: Time) -> Time:
        if self._base_time_ns is None:
            raise ValueError('no scan processed yet')
        return time_ns + self._base_time_ns

    # ------------------------------------------------------------------
    # Per-scan processing (scanCallback, laser_slam_worker.cpp:96-253)
    # ------------------------------------------------------------------

    def process_scan(self, time_ns: Time, points: np.ndarray,
                     odom_pose7: Optional[np.ndarray] = None) -> bool:
        """Process one assembled scan.  Returns True if the scan passed the
        distance gate and was integrated."""
        bench.notify_new_step()
        if self._lock_scan_callback:
            return False
        if odom_pose7 is None and self.params.use_odometry_information:
            raise ValueError('odometry pose required when '
                             'use_odometry_information is set')

        if odom_pose7 is not None:
            odom_pose7 = np.asarray(odom_pose7, np.float32)
            # Distance gate (scanCallback:109-120).
            if self._last_pose is not None:
                dist = float(se3.translation_distance(
                    host_pose(odom_pose7), host_pose(self._last_pose)))
                if dist <= self.params.minimum_distance_to_add_pose:
                    return False
            self._last_pose = odom_pose7

        curve_time = self._to_curve_time(time_ns)

        if self.params.use_odometry_information:
            pose = Pose(T_w=odom_pose7, time_ns=curve_time)
        else:
            pose = self._odometry_free_pose(curve_time)

        with bench.scoped_timer('worker.process_scan'):
            factors, values, is_prior = \
                self.laser_track.process_pose_and_laser_scan(
                    pose, points, curve_time)
            if is_prior:
                result = self.estimator.register_prior(
                    factors, values, self.worker_id)
            else:
                result = self.estimator.estimate(factors, values, curve_time)
            self.laser_track.update_from_values(result)
            if self.laser_track.config.update_covariances:
                # appendCovariances (laser_track.cpp:421-429; the
                # reference declares it but never wires it: opt-in).
                new_key = self.laser_track.scans[-1].key
                self.laser_track.append_covariances(
                    self.estimator.marginal_covariances([new_key]))

        # world_to_odom correction (scanCallback:175-191).
        if odom_pose7 is not None:
            self.world_to_odom = se3.compose(
                host_pose(self.laser_track.get_current_pose().T_w),
                se3.inverse(host_pose(odom_pose7))).numpy()

        # Local map accumulation (scanCallback:196-246).
        if self.params.create_filtered_map:
            self._accumulate_local_map(curve_time)
        return True

    def _odometry_free_pose(self, curve_time: Time) -> Pose:
        """Constant-velocity propagation when odometry is unavailable
        (scanCallback:135-162)."""
        pose = Pose(T_w=se3.identity().numpy(), time_ns=curve_time)
        track = self.laser_track
        if track.get_num_scans() > 2:
            current = track.get_current_pose()
            dt = curve_time - current.time_ns
            prev_time = current.time_ns - dt
            if (current.time_ns > dt and
                    track.get_min_time() <= prev_time <= track.get_max_time()):
                prev = host_pose(track.evaluate(prev_time))
                last_sent = host_pose(self._last_pose_sent.T_w
                                      if self._last_pose_sent
                                      else se3.identity())
                T = se3.compose(last_sent, se3.compose(
                    se3.inverse(prev), host_pose(current.T_w)))
                pose.T_w = se3.normalize(T).numpy()
        self._last_pose_sent = pose
        return pose

    # ------------------------------------------------------------------
    # Local map maintenance
    # ------------------------------------------------------------------

    def _accumulate_local_map(self, curve_time: Time):
        fixed = self.laser_track.get_local_cloud_in_world_frame(curve_time)
        if self.params.remove_ground_from_local_map:
            z = float(self.laser_track.get_current_pose().T_w[6])
            fixed = pc.ground_filter(
                fixed, z, self.params.ground_distance_to_robot_center_m)
        pts = _valid_points(fixed)
        if len(pts) == 0:
            return
        cap = self._map_points.shape[0]
        if self._map_count + len(pts) > cap:
            self._compact_map()
        n = min(len(pts), cap - self._map_count)
        self._map_points[self._map_count:self._map_count + n] = pts[:n]
        self._map_count += n
        self._local_map_queue.append(pts)

    def _compact_map(self):
        """Voxel-compact the local map buffer in place when full."""
        c = pc.make_cloud(self._map_points[:self._map_count],
                          device=self.device)
        pts = _valid_points(pc.voxel_filter(c, self.params.voxel_size_m, 1))
        self._map_points[:] = pc.SENTINEL
        self._map_points[:len(pts)] = pts
        self._map_count = len(pts)

    def set_lock_scan_callback(self, locked: bool) -> None:
        """Pause/resume scan processing around map updates
        (setLockScanCallback, laser_slam_worker.cpp:255-258)."""
        self._lock_scan_callback = locked

    def get_queued_points(self) -> List[np.ndarray]:
        """Drain the per-scan world-frame cloud queue
        (getQueuedPoints, laser_slam_worker.cpp:407-412)."""
        out, self._local_map_queue = self._local_map_queue, []
        return out

    def get_filtered_map(self) -> np.ndarray:
        """Voxel-filtered map with optional distant separation
        (getFilteredMap, laser_slam_worker.cpp:415-488), as an [M,3]
        array.  With ``separate_distant_map``, far points migrate to the
        distant map (filtered once, then static until a loop closure)."""
        if self._map_count == 0:
            return np.zeros((0, 3), np.float32)
        current = self.laser_track.get_current_pose().T_w
        cap = self._map_points.shape[0]
        near, far = _filter_local_map(
            torch.from_numpy(self._map_points).to(self.device),
            torch.arange(cap, device=self.device) < self._map_count,
            host_pose(current[4:]).to(self.device),
            self.params.distance_to_consider_fixed,
            self.params.cylinder_height_m, self.params.voxel_size_m,
            self.params.minimum_point_number_per_voxel)

        near_np = _valid_points(near)
        if self.params.separate_distant_map:
            far_np = _valid_points(far)
            if len(far_np):
                self._append_distant(far_np)
            # Keep only the near points in the live local map.
            self._map_points[:] = pc.SENTINEL
            self._map_points[:len(near_np)] = near_np
            self._map_count = len(near_np)
            self._local_map_filtered = near_np
            if self._distant_count:
                return np.concatenate(
                    [near_np, self._distant_buf[:self._distant_count]])
            return near_np
        self._local_map_filtered = near_np
        return near_np

    def _append_distant(self, pts: np.ndarray) -> None:
        need = self._distant_count + len(pts)
        if need > len(self._distant_buf):
            cap = max(1024, len(self._distant_buf))
            while cap < need:
                cap *= 2
            buf = np.zeros((cap, 3), np.float32)
            buf[:self._distant_count] = self._distant_buf[:self._distant_count]
            self._distant_buf = buf
        self._distant_buf[self._distant_count:need] = pts
        self._distant_count = need

    @property
    def _distant_points(self) -> np.ndarray:
        """The distant map as a contiguous [M,3] view (checkpoint format)."""
        return self._distant_buf[:self._distant_count]

    @_distant_points.setter
    def _distant_points(self, pts: np.ndarray) -> None:
        self._distant_buf = np.asarray(pts, np.float32).reshape(-1, 3).copy()
        self._distant_count = len(self._distant_buf)

    def get_local_map_filtered(self) -> np.ndarray:
        if self._local_map_filtered is None:
            return np.zeros((0, 3), np.float32)
        return np.asarray(self._local_map_filtered)

    def clear_local_map(self):
        self._map_points[:] = pc.SENTINEL
        self._map_count = 0
        self._local_map_filtered = None

    def update_local_map(self, last_pose_before_update: np.ndarray,
                         last_pose_timestamp_ns: Time):
        """Re-rigidify the accumulated map after a loop closure
        (updateLocalMap, laser_slam_worker.cpp:522-540): move it by
        new_last_pose * old_last_pose^-1, on the device."""
        T = se3.compose(
            host_pose(self.laser_track.evaluate(last_pose_timestamp_ns)),
            se3.inverse(host_pose(last_pose_before_update))).to(self.device)

        def moved(pts):
            return se3.apply(T, torch.from_numpy(pts).to(self.device)
                             ).cpu().numpy()

        n = self._map_count
        if n:
            self._map_points[:n] = moved(self._map_points[:n])
        if len(self._distant_points):
            self._distant_points = moved(self._distant_points)

    def get_transform_between_poses(self, start_pose: np.ndarray,
                                    end_pose_timestamp_ns: Time):
        """(getTransformBetweenPoses, laser_slam_worker.cpp:542-549)."""
        last = host_pose(self.laser_track.evaluate(end_pose_timestamp_ns))
        return se3.compose(last, se3.inverse(host_pose(start_pose))).numpy()

    # ------------------------------------------------------------------
    # Exports
    # ------------------------------------------------------------------

    def get_trajectory(self) -> Dict[Time, np.ndarray]:
        return self.laser_track.get_trajectory()

    def get_odometry_trajectory(self) -> Dict[Time, np.ndarray]:
        return self.laser_track.get_odometry_trajectory()

    def export_trajectory(self, path: str):
        """CSV time,x,y,z (exportTrajectories,
        laser_slam_worker.cpp:551-565)."""
        self.laser_track.trajectory.save_csv(path)

    def export_trajectory_kitti(self, path: str):
        """KITTI odometry pose format (12-float [R|t] rows) for standard
        evaluators (csvio.write_trajectory_kitti)."""
        csvio.write_trajectory_kitti(sorted(self.get_trajectory().items()),
                                     path)

    def export_trajectory_tum(self, path: str):
        """TUM format (t tx ty tz qx qy qz qw), csvio.write_trajectory_tum."""
        csvio.write_trajectory_tum(sorted(self.get_trajectory().items()),
                                   path)

    def export_trajectory_head(self, head_duration_ns: Time, path: str):
        """(exportTrajectoryHead, laser_slam_worker.cpp:567-596)."""
        traj = sorted(self.get_trajectory().items())
        end = traj[-1][0]
        start = end - head_duration_ns if end > head_duration_ns else 0
        rows = [(t, p[4], p[5], p[6]) for t, p in traj if t > start]
        np.savetxt(path, np.asarray(rows), delimiter=',', fmt='%.9g')

    def get_laser_tracks_data(self):
        """All (time, scan points, optimized world pose) tuples across all
        tracks, time-sorted: the GetLaserTrackSrv equivalent
        (laser_slam_worker.cpp:260-317)."""
        data = []
        for track in self.estimator.get_all_laser_tracks():
            traj = track.get_trajectory()
            for scan in track.scans:
                data.append((scan.time_ns, _valid_points(scan.cloud),
                             traj[scan.time_ns]))
        data.sort(key=lambda x: x[0])
        # Drop duplicate time-0 entries (reference :297-311).
        out, zero_added = [], False
        for item in data:
            if item[0] == 0:
                if zero_added:
                    continue
                zero_added = True
            out.append(item)
        return out
