"""LaserTrack: one robot's scan-matching front end and trajectory owner.

Counterpart of ``laser_slam_tpu/core/laser_track.py`` (the reference's
``LaserTrack``, laser_slam/include/laser_slam/laser_track.hpp:17-236,
src/laser_track.cpp):

* one robot's pose measurements, odometry deltas, ICP results, loop
  closures, laser scans and SE(3) trajectory;
* the per-scan path ``process_pose_and_laser_scan`` (laser_track.cpp:
  122-231): filter the scan, extend the trajectory by the odometry delta,
  run scan-to-submap ICP, and emit the prior/odometry/ICP factors and
  initial values for the estimator;
* submaps around a time for loop-closure ICP (``build_submap_around_time``,
  laser_track.cpp:602-651).

The track keeps a fixed-shape ring of its last ``nscan_in_sub_map`` scans
(points, masks, normals) on its device, newest at index -1.  The ring's
relative poses come from the host trajectory and are uploaded once a
scan with the ICP's initial guess; the ICP result is read back (the JAX
package's read point).  ICP with ``matcher='pallas'`` launches K2 (K1
with ``pallas_prune=False``) on the card.

Port notes: where the JAX track draws ``jax.random`` keys from a numpy
generator (seeded ``1234 + track_id``), this track draws from a
``torch.Generator`` on its device with the same seed; the streams differ,
and a draw is made only where a sampling ratio is below 1.
"""

from __future__ import annotations

import os
import tempfile
import time as _time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from laser_slam_tpu_torch.config import LaserTrackConfig
from laser_slam_tpu_torch.core import benchmarker as bench
from laser_slam_tpu_torch.core.trajectory import SE3Trajectory
from laser_slam_tpu_torch.core.types import LaserScan, Pose, RelativePose, Time
from laser_slam_tpu_torch.ops import cloud as pc
from laser_slam_tpu_torch.ops import icp as icp_mod
from laser_slam_tpu_torch.ops import se3
from laser_slam_tpu_torch.pipeline.online import (assemble_submap,
                                                  ingest_track,
                                                  resolve_device,
                                                  sample_reading)


def host_pose(a) -> torch.Tensor:
    """A pose7 as a CPU float32 tensor (host-side se3 arithmetic)."""
    return torch.tensor(np.asarray(a, np.float32))


def _scan_to_submap_icp(ring_points, ring_mask, ring_normals, ring_rel,
                        reading: pc.Cloud, generator, initial_guess,
                        config: LaserTrackConfig) -> icp_mod.IcpResult:
    """Scan-to-submap ICP against the ring of previous scans
    (localScanToSubMap, laser_track.cpp:466-519): ``ring_rel[k]`` moves
    ring scan k into the submap frame (the frame of the newest ring
    entry, the second-last scan overall).  The reading is sampled at the
    ICP config's ratio and decimated to its budget, then registered
    point to plane."""
    submap, submap_normals = assemble_submap(ring_points, ring_mask,
                                             ring_normals, ring_rel)
    return icp_mod.icp_point_to_plane(
        sample_reading(reading, config.icp, generator), submap,
        submap_normals, initial_guess, config.icp)


class LaserTrack:
    """One robot's front-end track (reference laser_track.hpp:17-236).
    ``device`` is the card unless the caller names another."""

    def __init__(self, config: LaserTrackConfig, track_id: int,
                 key_allocator: Callable[[], int], device='cuda'):
        self.config = config
        self.track_id = track_id
        self.device = resolve_device(device)
        self._alloc_key = key_allocator
        self.trajectory = SE3Trajectory()
        # Pose measurements (odometry input), time -> pose7.
        self.pose_measurement_times: List[Time] = []
        self.pose_measurements: List[np.ndarray] = []
        self._pose_meas_index: Dict[Time, int] = {}
        self.odometry_measurements: List[RelativePose] = []
        self.icp_transformations: List[RelativePose] = []
        self.loop_closures: List[RelativePose] = []
        self.scans: List[LaserScan] = []
        self.scan_matching_times: Dict[Time, float] = {}
        self.covariances: List[np.ndarray] = []
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(1234 + track_id)

        # The reference's submap is the second-last scan plus up to
        # nscan_in_sub_map-1 scans before it (laser_track.cpp:476-486),
        # so the ring holds nscan_in_sub_map scans of the stored size.
        K = max(config.nscan_in_sub_map, 1)
        f = config.input_filters
        N = f.store_capacity or f.scan_capacity
        self._ring_points = torch.full((K, N, 3), pc.SENTINEL,
                                       dtype=torch.float32,
                                       device=self.device)
        self._ring_mask = torch.zeros((K, N), dtype=torch.bool,
                                      device=self.device)
        self._ring_normals = torch.zeros((K, N, 3), dtype=torch.float32,
                                         device=self.device)
        self._ring_times = np.zeros((K,), np.int64) - 1

    # ------------------------------------------------------------------
    # Measurement accessors (reference laser_track.cpp:88-104,521-571)
    # ------------------------------------------------------------------

    def _pose_measurement_at(self, time_ns: Time) -> np.ndarray:
        """Pose measurement at an exact time (findPose,
        laser_track.cpp:539-555); the time -> index map is rebuilt
        whenever the measurement list has grown."""
        if len(self._pose_meas_index) != len(self.pose_measurement_times):
            self._pose_meas_index = {
                t: i for i, t in enumerate(self.pose_measurement_times)}
        idx = self._pose_meas_index.get(time_ns)
        if idx is None:
            raise KeyError(f'no pose measurement at time {time_ns}')
        return self.pose_measurements[idx]

    def get_num_scans(self) -> int:
        return len(self.scans)

    def get_min_time(self) -> Time:
        return self.trajectory.min_time()

    def get_max_time(self) -> Time:
        return self.trajectory.max_time()

    def get_laser_scans_times(self) -> List[Time]:
        return [s.time_ns for s in self.scans]

    def evaluate(self, time_ns: Time) -> np.ndarray:
        return self.trajectory.evaluate(time_ns)

    def get_trajectory(self):
        return self.trajectory.as_dict()

    def get_odometry_trajectory(self):
        """(getOdometryTrajectory, laser_track.cpp:313-319)."""
        return {t: p.copy() for t, p in zip(self.pose_measurement_times,
                                            self.pose_measurements)}

    def get_current_pose(self) -> Pose:
        if self.trajectory.is_empty():
            return Pose()
        t = self.trajectory.max_time()
        return Pose(T_w=self.trajectory.evaluate(t), time_ns=t,
                    key=self.trajectory.key_at(t))

    def get_previous_pose(self) -> Pose:
        times = self.trajectory.times()
        if len(times) < 2:
            return Pose()
        t = int(times[-2])
        return Pose(T_w=self.trajectory.evaluate(t), time_ns=t,
                    key=self.trajectory.key_at(t))

    # ------------------------------------------------------------------
    # Per-scan path (reference laser_track.cpp:122-231)
    # ------------------------------------------------------------------

    def process_pose_and_laser_scan(self, pose: Pose, raw_points: np.ndarray,
                                    time_ns: Optional[Time] = None):
        """Process one (pose measurement, scan) pair.

        Returns (new_factors, new_values, is_prior): factor spec dicts for
        the estimator and key -> initial pose7 (the raw odometry pose,
        laser_track.cpp:228-230)."""
        with bench.scoped_timer('laser_track.process_scan'):
            return self._process(pose, raw_points, time_ns)

    def _process(self, pose, raw_points, time_ns):
        t_start = _time.perf_counter()
        time_ns = pose.time_ns if time_ns is None else time_ns

        scan_cloud, normals = self._ingest(raw_points)
        scan = LaserScan(cloud=scan_cloud, time_ns=time_ns, normals=normals)

        self.pose_measurement_times.append(pose.time_ns)
        self.pose_measurements.append(np.asarray(pose.T_w, np.float32))

        new_factors = []
        new_values = {}

        if self.trajectory.is_empty():
            key = self._alloc_key()
            self.trajectory.extend(time_ns, pose.T_w, key)
            scan.key = key
            self.scans.append(scan)
            self._push_ring(scan)

            prior_T = np.asarray(pose.T_w, np.float32)
            if self.config.force_priors:
                # Offset tracks along y (laser_track.cpp:166-170).
                prior_T = np.array(
                    [1, 0, 0, 0, 0,
                     self.config.distance_between_prior_poses_m *
                     self.track_id, 0], np.float32)
            new_factors.append(dict(
                type='prior', key=key, T=prior_T,
                track_id=self.track_id))
            new_values[key] = np.asarray(pose.T_w, np.float32)
            return new_factors, new_values, True

        # Relative odometry measurement (laser_track.cpp:178-201).
        t_last = self.trajectory.max_time()
        last_meas = host_pose(self._pose_measurement_at(t_last))
        rel = RelativePose(
            T_a_b=se3.compose(se3.inverse(last_meas),
                              host_pose(pose.T_w)).numpy(),
            time_a_ns=t_last, time_b_ns=time_ns,
            key_a=self.trajectory.key_at(t_last),
            track_id_a=self.track_id, track_id_b=self.track_id)

        # Extend with the odometry-propagated pose.
        propagated = se3.compose(host_pose(self.trajectory.evaluate(t_last)),
                                 host_pose(rel.T_a_b))
        key = self._alloc_key()
        self.trajectory.extend(time_ns, propagated.numpy(), key)
        scan.key = key
        rel.key_b = key
        self.scans.append(scan)
        self.odometry_measurements.append(rel)

        # Scan-to-submap ICP (laser_track.cpp:204-205,460-519).
        icp_rel = None
        if self.config.use_icp_factors and len(self.scans) > 1:
            icp_rel = self._compute_icp_transformation()

        self._push_ring(scan)
        self.scan_matching_times[time_ns] = (
            (_time.perf_counter() - t_start) * 1e3)
        bench.record_value('laser_track.scan_matching_ms',
                           self.scan_matching_times[time_ns])

        if self.config.use_odom_factors:
            new_factors.append(dict(
                type='relative', key_a=rel.key_a, key_b=rel.key_b,
                T_a_b=rel.T_a_b,
                sigmas=np.asarray(self.config.odometry_noise_model,
                                  np.float32),
                robust=self.config.add_m_estimator_on_odom))
        if icp_rel is not None:
            new_factors.append(dict(
                type='relative', key_a=icp_rel.key_a, key_b=icp_rel.key_b,
                T_a_b=icp_rel.T_a_b,
                sigmas=np.asarray(self.config.icp_noise_model, np.float32),
                robust=self.config.add_m_estimator_on_icp))
        new_values[key] = np.asarray(pose.T_w, np.float32)
        return new_factors, new_values, False

    def _ingest(self, raw_points: np.ndarray):
        """Pad the scan to capacity, upload it, and run the input filters
        and normals on the device (laser_track.cpp:146)."""
        cap = self.config.input_filters.scan_capacity
        pts = np.asarray(raw_points, np.float32)
        n = min(len(pts), cap)
        padded = np.full((cap, 3), pc.SENTINEL, np.float32)
        padded[:n] = pts[:n]
        return ingest_track(torch.from_numpy(padded).to(self.device), n,
                            self.config, self.generator)

    def _push_ring(self, scan: LaserScan):
        """Roll the ring by one and put ``scan`` last (newest at -1)."""
        for name, value in (('_ring_points', scan.cloud.points),
                            ('_ring_mask', scan.cloud.mask),
                            ('_ring_normals', scan.normals)):
            ring = getattr(self, name)
            setattr(self, name, torch.cat([ring[1:], value[None]]))
        self._ring_times = np.roll(self._ring_times, -1)
        self._ring_times[-1] = scan.time_ns

    def _compute_icp_transformation(self) -> Optional[RelativePose]:
        """Scan-to-submap ICP for the newest scan (localScanToSubMap).

        The submap frame is the second-last scan's frame; the ring holds
        exactly the scans the reference would concatenate
        (laser_track.cpp:474-486).  Empty ring slots move by identity."""
        last = self.scans[-1]
        second_last_t = self.scans[-2].time_ns
        T_a_w = se3.inverse(host_pose(self.trajectory.evaluate(second_last_t)))
        rels = torch.stack([
            se3.identity() if t < 0 else
            se3.compose(T_a_w, host_pose(self.trajectory.evaluate(int(t))))
            for t in self._ring_times])
        # Initial guess from the trajectory (laser_track.cpp:488-491).
        guess = se3.compose(T_a_w,
                            host_pose(self.trajectory.evaluate(last.time_ns)))
        up = torch.cat([rels, guess[None]]).to(self.device)
        result = _scan_to_submap_icp(
            self._ring_points, self._ring_mask, self._ring_normals, up[:-1],
            last.cloud, self.generator, up[-1], self.config)
        T = result.T.cpu().numpy()

        icp_rel = RelativePose(
            T_a_b=T, time_a_ns=second_last_t, time_b_ns=last.time_ns,
            key_a=self.trajectory.key_at(second_last_t),
            key_b=self.trajectory.key_at(last.time_ns),
            track_id_a=self.track_id, track_id_b=self.track_id)
        self.icp_transformations.append(icp_rel)

        if self.config.save_icp_results:
            self._save_icp_debug(last, up[-1], result.T)
        return icp_rel

    def _save_icp_debug(self, last_scan, guess, solution):
        """Debug dumps of the ICP inputs and outputs as .xyz clouds under
        the temporary directory (save_icp_results, laser_track.cpp:504-513;
        the reference writes VTK)."""
        out = os.path.join(tempfile.gettempdir(), 'laser_slam_tpu_icp')
        os.makedirs(out, exist_ok=True)

        def dump(name, cloud):
            pts = cloud.points[cloud.mask].cpu().numpy()
            np.savetxt(os.path.join(out, name), pts, fmt='%.4f')

        dump('last_scan.xyz', last_scan.cloud)
        dump('last_scan_aligned_by_initial_guess.xyz',
             pc.transform(guess, last_scan.cloud))
        dump('last_scan_aligned_by_solution.xyz',
             pc.transform(solution, last_scan.cloud))

    # ------------------------------------------------------------------
    # Submaps for loop closures (laser_track.cpp:602-651)
    # ------------------------------------------------------------------

    def build_submap_around_time(self, time_ns: Time, radius: int):
        """The scans within +-radius of the scan at ``time_ns``, moved into
        that scan's frame and concatenated.  Returns (Cloud, normals)."""
        times = self.get_laser_scans_times()
        try:
            center = times.index(time_ns)
        except ValueError:
            raise KeyError(f'no scan at time {time_ns}') from None
        lo = max(0, center - radius)
        hi = min(len(times), center + radius + 1)
        sel = self.scans[lo:hi]
        T_a_w = se3.inverse(host_pose(self.trajectory.evaluate(time_ns)))
        rels = torch.stack([
            se3.compose(T_a_w, host_pose(self.trajectory.evaluate(s.time_ns)))
            for s in sel]).to(self.device)
        return assemble_submap(torch.stack([s.cloud.points for s in sel]),
                               torch.stack([s.cloud.mask for s in sel]),
                               torch.stack([s.normals for s in sel]), rels)

    # ------------------------------------------------------------------
    # Solver sync (laser_track.cpp:411-429)
    # ------------------------------------------------------------------

    def update_from_values(self, values: np.ndarray) -> None:
        self.trajectory.update_from_values(values)

    def append_covariances(self, covs: np.ndarray) -> None:
        for c in covs:
            self.covariances.append(np.asarray(c))

    def get_covariances(self):
        return list(self.covariances)

    def get_point_cloud_of_time_interval(self, start_ns: Time,
                                         end_ns: Time) -> pc.Cloud:
        """All scans with start <= t <= end, concatenated in the world
        frame.  (The reference declares this but leaves it a TODO,
        laser_track.cpp:239-245.)"""
        sel = [s for s in self.scans if start_ns <= s.time_ns <= end_ns]
        if not sel:
            return pc.empty_cloud(1, device=self.device)
        return pc.concatenate([pc.transform(
            host_pose(self.trajectory.evaluate(s.time_ns)).to(self.device),
            s.cloud) for s in sel])

    def get_local_cloud_in_world_frame(self, time_ns: Time) -> pc.Cloud:
        """The scan at ``time_ns`` moved by its optimized pose
        (getLocalCloudInWorldFrame, laser_track.cpp:247-266)."""
        for s in reversed(self.scans):
            if s.time_ns == time_ns:
                T = host_pose(self.trajectory.evaluate(time_ns))
                return pc.transform(T.to(self.device), s.cloud)
        raise KeyError(f'no scan at time {time_ns}')
