"""IncrementalEstimator: the global pose-graph back end.

Counterpart of ``laser_slam_tpu/core/estimator.py`` (the reference's
``IncrementalEstimator``, laser_slam/include/laser_slam/
incremental_estimator.hpp:17-81, src/incremental_estimator.cpp):

* N LaserTracks and the global factor graph and key space
  (incremental_estimator.cpp:22-26);
* the per-scan incremental estimate (``estimate``,
  incremental_estimator.cpp:151-163): a warm-started Gauss-Newton/PCG
  solve (graph.solver) in place of iSAM2's 3 updates;
* loop closures with optional submap-ICP refinement
  (``process_loop_closure``, incremental_estimator.cpp:63-149);
* multi-robot prior bookkeeping: linked-worker groups and the removal of
  the absorbed group's prior when two groups link (``estimate_and_remove``,
  incremental_estimator.cpp:165-266).

The graph (``HostGraph``) and the pose table live on the host; every
solve uploads the padded graph and the poses to the estimator's device
and reads the poses back, as the JAX package does.  The estimator also
counts the off-chain factors on the host (``HostGraph.offchain_count``)
and passes the count to every solve and covariance call, so choosing
the solver's matvec reads nothing more back.
"""

from __future__ import annotations

import time as _time
from typing import Dict, List, Sequence

import numpy as np
import torch

from laser_slam_tpu_torch.config import EstimatorConfig
from laser_slam_tpu_torch.core import benchmarker as bench
from laser_slam_tpu_torch.core.laser_track import LaserTrack, host_pose
from laser_slam_tpu_torch.core.types import (OptimizationResult,
                                             RelativePose, Time)
from laser_slam_tpu_torch.graph import factors as fg
from laser_slam_tpu_torch.graph import solver as sv
from laser_slam_tpu_torch.ops import icp as icp_mod
from laser_slam_tpu_torch.ops import se3
from laser_slam_tpu_torch.pipeline.online import resolve_device


class IncrementalEstimator:
    def __init__(self, config: EstimatorConfig, n_laser_slam_workers: int = 1,
                 device='cuda'):
        """``device`` is the card unless the caller names another
        (``'cpu'`` for the CPU); without a card the default raises."""
        self.config = config
        self.device = resolve_device(device)
        self.n_workers = n_laser_slam_workers
        self.graph = fg.HostGraph(
            rel_capacity=config.solver.factor_capacity,
            prior_capacity=max(16, 2 * n_laser_slam_workers))

        # Global key space (GTSAM Values equivalent): poses indexed by key.
        self._pose_capacity = config.solver.pose_capacity
        self._poses = np.zeros((self._pose_capacity, 7), np.float32)
        self._poses[:, 0] = 1.0
        self._n_keys = 0

        self.laser_tracks: List[LaserTrack] = [
            LaserTrack(config.laser_track, i, self._allocate_key,
                       device=self.device)
            for i in range(n_laser_slam_workers)]

        # Multi-robot prior bookkeeping (incremental_estimator.cpp:176-257).
        self._linked_workers: List[List[int]] = []
        self._prior_factor_of_worker: Dict[int, int] = {}

        self.last_result = OptimizationResult()

    # ------------------------------------------------------------------
    # Key space
    # ------------------------------------------------------------------

    def _allocate_key(self) -> int:
        if self._n_keys == self._pose_capacity:
            self._pose_capacity *= 2
            new = np.zeros((self._pose_capacity, 7), np.float32)
            new[:, 0] = 1.0
            new[:self._n_keys] = self._poses
            self._poses = new
        key = self._n_keys
        self._n_keys += 1
        return key

    @property
    def num_keys(self) -> int:
        return self._n_keys

    def pose_values(self) -> np.ndarray:
        """Current estimate table indexed by key (GTSAM Values analog)."""
        return self._poses[:self._n_keys].copy()

    def get_laser_track(self, track_id: int) -> LaserTrack:
        return self.laser_tracks[track_id]

    def get_all_laser_tracks(self) -> List[LaserTrack]:
        return list(self.laser_tracks)

    # ------------------------------------------------------------------
    # Factor ingestion
    # ------------------------------------------------------------------

    def _apply_new_values(self, new_values: Dict[int, np.ndarray]):
        for key, T in new_values.items():
            self._poses[key] = np.asarray(T, np.float32)

    def _add_factors(self, new_factors: Sequence[dict]) -> List[tuple]:
        indices = []
        for f in new_factors:
            if f['type'] == 'prior':
                sig = np.full(6, self.config.prior_noise_sigma, np.float32)
                idx = self.graph.add_prior(f['key'], f['T'], sig)
                indices.append(('prior', idx, f.get('track_id', 0)))
            elif f['type'] == 'relative':
                idx = self.graph.add_relative(
                    f['key_a'], f['key_b'], f['T_a_b'], f['sigmas'],
                    robust=bool(f.get('robust', False)),
                    fixed_a=bool(f.get('fixed_a', False)))
                indices.append(('relative', idx, None))
            else:
                raise ValueError(f"unknown factor type {f['type']}")
        return indices

    # ------------------------------------------------------------------
    # Solving
    # ------------------------------------------------------------------

    def _bucket(self, n: int, minimum: int = 64) -> int:
        cap = minimum
        while cap < n:
            cap *= 2
        return cap

    def _padded_poses(self):
        """(poses [cap,7], pose mask [cap]) on the device, padded to a
        power-of-two bucket of the key count."""
        n = max(self._n_keys, 1)
        cap = self._bucket(n)
        poses = np.zeros((cap, 7), np.float32)
        poses[:, 0] = 1.0
        poses[:n] = self._poses[:n]
        mask = np.zeros((cap,), bool)
        mask[:n] = True
        return (torch.from_numpy(poses).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def _solve(self) -> np.ndarray:
        """One warm-started incremental solve over the whole padded graph:
        the poses and the result's three scalars come back in two reads."""
        t0 = _time.perf_counter()
        n = max(self._n_keys, 1)
        poses, mask = self._padded_poses()
        result = sv.solve(self.graph.to_device(device=self.device), poses,
                          mask, self.config.solver,
                          offchain=self.graph.offchain_count())
        self._poses[:n] = result.poses[:n].cpu().numpy()
        pcg_it, e0, e1 = torch.stack([
            result.pcg_iterations.to(torch.float32), result.error_initial,
            result.error_final]).cpu().tolist()

        dt = (_time.perf_counter() - t0) * 1e3
        self.last_result = OptimizationResult(
            num_iterations=self.config.solver.gn_iterations,
            num_intermediate_steps=int(pcg_it),
            num_variables=n, initial_error=e0, final_error=e1,
            duration_ms=dt)
        bench.record_value('estimator.solve_ms', dt)
        return self.pose_values()

    def estimate(self, new_factors: Sequence[dict],
                 new_values: Dict[int, np.ndarray],
                 timestamp_ns: Time = 0) -> np.ndarray:
        """Per-scan incremental estimate (incremental_estimator.cpp:151-163).

        Returns the full key -> pose7 value table; callers push it back
        into their tracks with ``update_from_values``.
        """
        with bench.scoped_timer('estimator.estimate'):
            self._add_factors(new_factors)
            self._apply_new_values(new_values)
            return self._solve()

    def register_prior(self, new_factors: Sequence[dict],
                       new_values: Dict[int, np.ndarray],
                       worker_id: int) -> np.ndarray:
        """First-scan prior registration (incremental_estimator.cpp:268-291).

        Records the prior factor index of workers > 0 so that it can be
        removed when the worker's graph becomes linked to worker 0's.
        """
        indices = self._add_factors(new_factors)
        self._apply_new_values(new_values)
        prior_indices = [i for kind, i, _ in indices if kind == 'prior']
        if len(prior_indices) != 1:
            raise ValueError('register_prior expects exactly one prior '
                             f'factor, got {len(prior_indices)}')
        if worker_id > 0:
            self._prior_factor_of_worker[worker_id] = prior_indices[0]
        self._linked_workers.append([worker_id])
        return self._solve()

    def estimate_and_remove(self, new_factors: Sequence[dict],
                            new_association_factors: Sequence[dict],
                            new_values: Dict[int, np.ndarray],
                            affected_worker_ids: Sequence[int],
                            timestamp_ns: Time = 0) -> np.ndarray:
        """Loop-closure estimate with linked-group prior removal
        (incremental_estimator.cpp:165-266).

        When the closure links two previously unlinked worker groups, the
        prior of the group NOT containing worker 0 is removed and the
        tighter 'first-association' factor is used instead.
        """
        if len(affected_worker_ids) != 2:
            raise ValueError('estimate_and_remove expects two worker ids')
        a, b = affected_worker_ids
        removed_prior = None

        if a != b:
            group_a = self._find_group(a)
            group_b = self._find_group(b)
            if group_a is not group_b:
                keep, drop = (group_a, group_b) if 0 in group_a else \
                    (group_b, group_a)
                for wid in drop:
                    if wid in self._prior_factor_of_worker:
                        removed_prior = self._prior_factor_of_worker.pop(wid)
                keep.extend(drop)
                self._linked_workers.remove(drop)

        if removed_prior is not None:
            self.graph.remove_prior(removed_prior)
            chosen = new_association_factors
        else:
            chosen = new_factors
        self._add_factors(chosen)
        self._apply_new_values(new_values)
        return self._solve()

    def _find_group(self, worker_id: int) -> List[int]:
        for group in self._linked_workers:
            if worker_id in group:
                return group
        # A worker that never registered a prior (estimator used
        # standalone) is a group of its own.
        group = [worker_id]
        self._linked_workers.append(group)
        return group

    # ------------------------------------------------------------------
    # Loop closures (incremental_estimator.cpp:63-149)
    # ------------------------------------------------------------------

    def process_loop_closure(self, loop_closure: RelativePose) -> None:
        lc = loop_closure
        track_a = self.laser_tracks[lc.track_id_a]
        track_b = self.laser_tracks[lc.track_id_b]
        if lc.track_id_a == lc.track_id_b and not lc.time_a_ns < lc.time_b_ns:
            raise ValueError('loop closure has invalid time')
        for track, t in ((track_a, lc.time_a_ns), (track_b, lc.time_b_ns)):
            if not track.get_min_time() <= t <= track.get_max_time():
                raise ValueError(f'loop closure time {t} outside track '
                                 f'{track.track_id}')

        # The caller supplies a world-frame alignment w_T_a_b; convert it
        # to the relative frame of node a (incremental_estimator.cpp:83-87).
        T_w_a = host_pose(track_a.evaluate(lc.time_a_ns))
        T_w_b = host_pose(track_b.evaluate(lc.time_b_ns))
        a_T_a_b = se3.compose(se3.inverse(T_w_a),
                              se3.compose(host_pose(lc.T_a_b), T_w_b))

        if self.config.do_icp_step_on_loop_closures:
            with bench.scoped_timer('estimator.loop_closure_icp'):
                a_T_a_b = self._refine_loop_closure(lc, a_T_a_b)

        key_a = track_a.trajectory.key_at(lc.time_a_ns)
        key_b = track_b.trajectory.key_at(lc.time_b_ns)
        T_ab_np = a_T_a_b.cpu().numpy()

        lc_factor = dict(
            type='relative', key_a=key_a, key_b=key_b, T_a_b=T_ab_np,
            sigmas=np.asarray(self.config.loop_closure_noise_model,
                              np.float32),
            robust=self.config.add_m_estimator_on_loop_closures)
        assoc_factor = dict(
            type='relative', key_a=key_a, key_b=key_b, T_a_b=T_ab_np,
            sigmas=np.asarray(self.config.first_association_noise_model,
                              np.float32),
            robust=False)

        stored = RelativePose(
            T_a_b=T_ab_np, time_a_ns=lc.time_a_ns, time_b_ns=lc.time_b_ns,
            key_a=key_a, key_b=key_b,
            track_id_a=lc.track_id_a, track_id_b=lc.track_id_b)
        track_b.loop_closures.append(stored)

        values = self.estimate_and_remove(
            [lc_factor], [assoc_factor], {},
            [lc.track_id_a, lc.track_id_b], lc.time_b_ns)

        for track in self.laser_tracks:
            track.update_from_values(values)

    def _refine_loop_closure(self, lc: RelativePose,
                             a_T_a_b: torch.Tensor) -> torch.Tensor:
        """Submap-to-submap ICP refinement (incremental_estimator.cpp:
        90-115): the whole submap around time_b (of track b) registered
        against the submap around time_a (of track a), from the
        frame-converted estimate.  A failed ICP keeps the estimate."""
        radius = self.config.loop_closures_sub_maps_radius
        sub_a, normals_a = self.laser_tracks[lc.track_id_a] \
            .build_submap_around_time(lc.time_a_ns, radius)
        sub_b, _ = self.laser_tracks[lc.track_id_b] \
            .build_submap_around_time(lc.time_b_ns, radius)
        guess = a_T_a_b.to(self.device)
        result = icp_mod.icp(sub_b, sub_a, normals_a, guess,
                             self.config.laser_track.icp)
        return torch.where(result.valid, result.T, guess)

    # ------------------------------------------------------------------
    # Covariances (laser_track.cpp:421-429 path)
    # ------------------------------------------------------------------

    def marginal_covariances(self, keys: Sequence[int]) -> np.ndarray:
        """[K,6,6] marginal covariances of ``keys`` by the solver's probes
        (one read)."""
        poses, mask = self._padded_poses()
        covs = sv.marginal_covariance(
            self.graph.to_device(device=self.device), poses, mask,
            torch.as_tensor(np.asarray(keys, np.int64), device=self.device),
            self.config.solver, offchain=self.graph.offchain_count())
        return covs.cpu().numpy()
