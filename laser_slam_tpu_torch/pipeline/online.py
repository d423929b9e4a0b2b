"""Device-resident online SLAM step and its host runner.

Counterpart of the core of ``laser_slam_tpu/pipeline/online.py``: the
per-scan pipeline (input filters -> normals -> scan-to-submap ICP ->
factor append -> full-graph Gauss-Newton solve -> ring push) over a state
of fixed-capacity device tensors, fed one scan at a time by
:class:`OnlineRunner` (scanCallback -> processPoseAndLaserScan ->
estimate, laser_slam_worker.cpp:96-253, laser_track.cpp:122-231,
incremental_estimator.cpp:151-163).

Port notes:
* The JAX step donates its state; :func:`online_step` and the loop-
  closure functions write the state's buffers in place and return it.
* Counters (``n_poses``, ``n_rel``, ``n_prior``) stay 0-d device tensors
  and rows are written through them, so a scan needs no device read.
  The first-scan ``lax.cond`` becomes a host bool: the runner knows
  whether the track has been seen.
* ``rng_key`` becomes a ``torch.Generator`` held by the runner; the state
  carries no RNG (the slice configuration makes no draw).
* Not ported yet (ROADMAP queue 1): the window solve, chunked and packed
  ingest, the scan archive, refined/cached closures, place recognition,
  device maps, multi-robot linking and the benchmarker timers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from laser_slam_tpu_torch.config import EstimatorConfig
from laser_slam_tpu_torch.graph.factors import FactorGraphData
from laser_slam_tpu_torch.graph import solver as sv
from laser_slam_tpu_torch.ops import cloud as pc
from laser_slam_tpu_torch.ops import icp as icp_mod
from laser_slam_tpu_torch.ops import se3
from laser_slam_tpu_torch.ops.range_image import compute_normals


class OnlineState(NamedTuple):
    """All-device SLAM state (pose table, scan rings, factor graph).

    Field names, shapes and dtypes follow the JAX ``OnlineState`` minus
    ``rng_key`` (see :func:`state_from_numpy`)."""
    # Trajectory / pose table; key == index (global across tracks).
    traj_poses: torch.Tensor      # [C,7] current estimates
    pose_meas: torch.Tensor       # [C,7] raw odometry measurement per key
    n_poses: torch.Tensor         # int32 scalar
    # Per-track scan rings: the last K scans (newest at index -1).
    ring_points: torch.Tensor     # [T,K,N,3]
    ring_mask: torch.Tensor       # [T,K,N]
    ring_normals: torch.Tensor    # [T,K,N,3]
    ring_keys: torch.Tensor       # [T,K] int32 (-1 = empty)
    track_last_key: torch.Tensor  # [T] int32 (-1 = track has no scans yet)
    # Factor graph.
    rel_meas: torch.Tensor        # [F,7]
    rel_keys: torch.Tensor        # [F,2]
    rel_sqrt_info: torch.Tensor   # [F,6]
    rel_robust: torch.Tensor      # [F]
    rel_weight: torch.Tensor      # [F]
    n_rel: torch.Tensor           # int32
    prior_meas: torch.Tensor      # [P,7]
    prior_keys: torch.Tensor      # [P]
    prior_sqrt_info: torch.Tensor  # [P,6]
    prior_weight: torch.Tensor    # [P]
    n_prior: torch.Tensor         # int32
    # Last-step diagnostics (stay on device).
    last_icp_valid: torch.Tensor
    last_icp_inliers: torch.Tensor
    last_error: torch.Tensor


class StepInfo(NamedTuple):
    key: torch.Tensor
    icp_valid: torch.Tensor
    icp_inliers: torch.Tensor
    solve_error: torch.Tensor


def resolve_device(device) -> torch.device:
    """The entry points' device: the card unless the caller names another.
    Asking for CUDA on a machine without a card raises; there is no
    silent CPU run."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the port runs on the card by '
                           "default; pass device='cpu' to run on the CPU")
    return device


def _eye_rows(n: int, device) -> torch.Tensor:
    rows = torch.zeros((n, 7), dtype=torch.float32, device=device)
    rows[:, 0] = 1.0
    return rows


def init_state(config: EstimatorConfig, pose_capacity: int = 4096,
               factor_capacity: int = 8192, prior_capacity: int = 8,
               n_tracks: int = 1, device='cuda') -> OnlineState:
    device = resolve_device(device)
    lt = config.laser_track
    # Submap = second-last scan + nscan_in_sub_map-1 earlier scans
    # (laser_track.cpp:476-486) -> the ring holds nscan_in_sub_map scans.
    K = max(lt.nscan_in_sub_map, 1)
    N = lt.input_filters.store_capacity or lt.input_filters.scan_capacity
    T = n_tracks
    f32, i32 = torch.float32, torch.int32

    def zeros(shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def scalar(value, dtype):
        return torch.tensor(value, dtype=dtype, device=device)

    return OnlineState(
        traj_poses=_eye_rows(pose_capacity, device),
        pose_meas=_eye_rows(pose_capacity, device),
        n_poses=scalar(0, i32),
        ring_points=torch.full((T, K, N, 3), pc.SENTINEL, dtype=f32,
                               device=device),
        ring_mask=zeros((T, K, N), torch.bool),
        ring_normals=zeros((T, K, N, 3)),
        ring_keys=torch.full((T, K), -1, dtype=i32, device=device),
        track_last_key=torch.full((T,), -1, dtype=i32, device=device),
        rel_meas=_eye_rows(factor_capacity, device),
        rel_keys=zeros((factor_capacity, 2), i32),
        rel_sqrt_info=zeros((factor_capacity, 6)),
        rel_robust=zeros((factor_capacity,), torch.bool),
        rel_weight=zeros((factor_capacity,)),
        n_rel=scalar(0, i32),
        prior_meas=_eye_rows(prior_capacity, device),
        prior_keys=zeros((prior_capacity,), i32),
        prior_sqrt_info=zeros((prior_capacity, 6)),
        prior_weight=zeros((prior_capacity,)),
        n_prior=scalar(0, i32),
        last_icp_valid=scalar(False, torch.bool),
        last_icp_inliers=scalar(0, i32),
        last_error=scalar(0.0, f32),
    )


def _pad_rows(a: torch.Tensor, n_new: int) -> torch.Tensor:
    extra = torch.zeros((n_new - a.shape[0],) + a.shape[1:], dtype=a.dtype,
                        device=a.device)
    return torch.cat([a, extra])


def _pad_pose_rows(a: torch.Tensor, n_new: int) -> torch.Tensor:
    return torch.cat([a, _eye_rows(n_new - a.shape[0], a.device)])


def grow_state(state: OnlineState, pose_capacity: Optional[int] = None,
               factor_capacity: Optional[int] = None,
               prior_capacity: Optional[int] = None) -> OnlineState:
    """Re-bucket the device state to larger capacities (the runner grows
    the buffers before a write would run past them)."""
    P = pose_capacity or state.traj_poses.shape[0]
    F = factor_capacity or state.rel_meas.shape[0]
    R = prior_capacity or state.prior_meas.shape[0]
    return state._replace(
        traj_poses=_pad_pose_rows(state.traj_poses, P),
        pose_meas=_pad_pose_rows(state.pose_meas, P),
        rel_meas=_pad_pose_rows(state.rel_meas, F),
        rel_keys=_pad_rows(state.rel_keys, F),
        rel_sqrt_info=_pad_rows(state.rel_sqrt_info, F),
        rel_robust=_pad_rows(state.rel_robust, F),
        rel_weight=_pad_rows(state.rel_weight, F),
        prior_meas=_pad_pose_rows(state.prior_meas, R),
        prior_keys=_pad_rows(state.prior_keys, R),
        prior_sqrt_info=_pad_rows(state.prior_sqrt_info, R),
        prior_weight=_pad_rows(state.prior_weight, R))


def state_from_numpy(d: dict, device='cuda') -> OnlineState:
    """An :class:`OnlineState` on ``device`` from numpy arrays keyed by the
    JAX ``OnlineState`` field names (e.g. ``{k: np.asarray(v)}`` over a JAX
    runner's state).  ``rng_key`` is ignored: the port's randomness lives
    in the runner's ``torch.Generator``."""
    device = resolve_device(device)
    return OnlineState(**{
        name: torch.as_tensor(np.array(d[name]), device=device)
        for name in OnlineState._fields})


def state_to_numpy(state: OnlineState) -> dict:
    """The state's fields as numpy arrays (one host transfer each)."""
    return {name: getattr(state, name).cpu().numpy()
            for name in OnlineState._fields}


def _graph_view(state: OnlineState) -> FactorGraphData:
    """The state's factor arrays as a solver graph (no copies).
    fixed_a is unused in the online path."""
    return FactorGraphData(
        rel_meas=state.rel_meas, rel_keys=state.rel_keys,
        rel_sqrt_info=state.rel_sqrt_info, rel_robust=state.rel_robust,
        rel_fixed_a=torch.zeros_like(state.rel_robust),
        rel_weight=state.rel_weight,
        prior_meas=state.prior_meas, prior_keys=state.prior_keys,
        prior_sqrt_info=state.prior_sqrt_info,
        prior_weight=state.prior_weight)


def _put(buf: torch.Tensor, row: torch.Tensor, value) -> None:
    """buf[row] = value with a 0-d device index (no host read).  A Python
    scalar fills the row."""
    rows = row.reshape(1).long()
    if isinstance(value, (bool, int, float)):
        buf.index_fill_(0, rows, value)
        return
    value = torch.as_tensor(value, dtype=buf.dtype, device=buf.device)
    buf.index_copy_(0, rows, value.expand(buf.shape[1:])[None])


def online_step(state: OnlineState, points: torch.Tensor,
                n_valid: int, odom_pose7: torch.Tensor,
                config: EstimatorConfig, first_scan: bool,
                track_id: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[OnlineState, StepInfo]:
    """Integrate one scan of one track.  ``points`` padded to capacity.

    ``first_scan`` (host bool) selects the prior branch for a track's
    first scan — the JAX step's ``lax.cond(prev_key < 0, ...)``.
    ``generator`` feeds the random-sampling filters when their ratio is
    below 1.  The JAX step's odometry-free mode comes in slice 2, forced
    priors (multi-robot) in slice 3.
    """
    lt = config.laser_track
    dev = points.device
    f32 = torch.float32
    if lt.force_priors:
        raise NotImplementedError('force_priors (multi-robot placement) '
                                  'comes with slice 3')
    if config.solver.window > 0:
        raise NotImplementedError('SolverConfig.window > 0 (the window '
                                  'solve) comes in slice 2')

    # --- ingest: filters + normals (laser_track.cpp:146) ---------------
    f = lt.input_filters
    if f.chain:
        raise NotImplementedError('InputFilterConfig.chain (the configurable '
                                  'filter chain) comes in slice 2')
    mask = torch.arange(points.shape[0], device=dev) < n_valid
    scan = pc.park_invalid(pc.Cloud(points, mask))
    scan = pc.range_filter(scan, f.min_distance_m, f.max_distance_m)
    if f.random_sampling_ratio < 1.0:
        scan = pc.random_sampling_filter(scan, f.random_sampling_ratio,
                                         generator)
    store_cap = f.store_capacity or f.scan_capacity
    if store_cap < scan.points.shape[0]:
        # Even stride over the packed valid points (a plain compact would
        # keep only the first beams of a ring-major scan).
        scan = pc.compact_decimate(scan, store_cap)
    normals = compute_normals(scan, lt.icp)

    i = state.n_poses
    odom = se3.normalize(odom_pose7)

    if first_scan:
        _put(state.traj_poses, i, odom)
        _put(state.pose_meas, i, odom)
        _put(state.prior_meas, state.n_prior, odom)
        _put(state.prior_keys, state.n_prior, i)
        _put(state.prior_sqrt_info, state.n_prior,
             1.0 / config.prior_noise_sigma)
        _put(state.prior_weight, state.n_prior, 1.0)
        state = state._replace(
            n_prior=state.n_prior + 1,
            last_icp_valid=torch.ones((), dtype=torch.bool, device=dev),
            last_icp_inliers=torch.zeros((), dtype=torch.int32, device=dev))
    else:
        prev_key = state.track_last_key[track_id].long()
        prev_meas = state.pose_meas[prev_key]
        prev_traj = state.traj_poses[prev_key]
        ring_keys = state.ring_keys[track_id].long()
        ident = se3.identity(device=dev)
        rel = se3.compose(se3.inverse(prev_meas), odom)
        propagated = se3.normalize(se3.compose(prev_traj, rel))

        # Scan-to-submap ICP in the previous scan's frame
        # (laser_track.cpp:466-519).
        T_a_w = se3.inverse(prev_traj)
        ring_rel = torch.where(
            (ring_keys >= 0)[:, None],
            se3.compose(T_a_w, state.traj_poses[torch.clamp(ring_keys,
                                                            min=0)]),
            ident)
        ring_points = state.ring_points[track_id]
        ring_mask = state.ring_mask[track_id]
        pts = se3.apply(ring_rel[:, None, :], ring_points)
        nrm = se3.quat_rotate(ring_rel[:, None, :4],
                              state.ring_normals[track_id])
        K, N, _ = ring_points.shape
        submap = pc.Cloud(
            torch.where(ring_mask[..., None], pts,
                        torch.full_like(pts, pc.SENTINEL)).reshape(K * N, 3),
            ring_mask.reshape(K * N))
        submap_normals = nrm.reshape(K * N, 3)

        reading = scan
        if lt.icp.reading_sampling_ratio < 1.0:
            reading = pc.random_sampling_filter(
                reading, lt.icp.reading_sampling_ratio, generator)
        # Even decimation to the reading budget (see compact_decimate).
        reading = pc.compact_decimate(reading, lt.icp.reading_capacity)

        icp_res = icp_mod.icp_point_to_plane(
            reading, submap, submap_normals, rel, lt.icp)

        # Factors (laser_track.cpp:211-222).
        n_rel = state.n_rel
        n_rel1 = n_rel + 1
        keys_ab = torch.stack([prev_key, i.long()]).to(torch.int32)
        _put(state.rel_meas, n_rel, rel)
        _put(state.rel_meas, n_rel1, icp_res.T)
        _put(state.rel_keys, n_rel, keys_ab)
        _put(state.rel_keys, n_rel1, keys_ab)
        _put(state.rel_sqrt_info, n_rel,
             1.0 / torch.tensor(lt.odometry_noise_model, dtype=f32))
        _put(state.rel_sqrt_info, n_rel1,
             1.0 / torch.tensor(lt.icp_noise_model, dtype=f32))
        _put(state.rel_robust, n_rel, lt.add_m_estimator_on_odom)
        _put(state.rel_robust, n_rel1, lt.add_m_estimator_on_icp)
        _put(state.rel_weight, n_rel, 1.0 if lt.use_odom_factors else 0.0)
        _put(state.rel_weight, n_rel1, torch.where(
            icp_res.valid, 1.0 if lt.use_icp_factors else 0.0, 0.0))
        _put(state.traj_poses, i, propagated)
        _put(state.pose_meas, i, odom)
        state = state._replace(
            n_rel=n_rel + 2,
            last_icp_valid=icp_res.valid,
            last_icp_inliers=icp_res.num_inliers.to(torch.int32))

    # --- incremental solve (incremental_estimator.cpp:151-163) ----------
    pose_mask = torch.arange(state.traj_poses.shape[0], device=dev) < (i + 1)
    result = sv.solve(_graph_view(state), state.traj_poses, pose_mask,
                      config.solver)
    # Ring push for this track (newest scan last).
    for ring, value in ((state.ring_points, scan.points),
                        (state.ring_mask, scan.mask),
                        (state.ring_normals, normals)):
        ring[track_id] = torch.cat([ring[track_id, 1:], value[None]])
    state.ring_keys[track_id] = torch.cat(
        [state.ring_keys[track_id, 1:], i.reshape(1)])
    state.track_last_key[track_id] = i
    state = state._replace(traj_poses=result.poses, n_poses=i + 1,
                           last_error=result.error_final)
    info = StepInfo(key=i, icp_valid=state.last_icp_valid,
                    icp_inliers=state.last_icp_inliers,
                    solve_error=state.last_error)
    return state, info


def _append_lc_factor(state: OnlineState, key_a: int, key_b: int,
                      a_T_a_b: torch.Tensor, config: EstimatorConfig,
                      remove_prior_slot: int, use_association: bool
                      ) -> Tuple[OnlineState, torch.Tensor]:
    """Append one loop-closure factor (frame of key_a); returns the new
    factor's index.  Linking closures use the first-association sigmas
    and deactivate the absorbed track's prior (``remove_prior_slot`` >= 0;
    a negative slot writes nothing — JAX's out-of-bounds drop)."""
    if use_association:
        sig = 1.0 / torch.tensor(config.first_association_noise_model,
                                 dtype=torch.float32)
        robust = False
    else:
        sig = 1.0 / torch.tensor(config.loop_closure_noise_model,
                                 dtype=torch.float32)
        robust = config.add_m_estimator_on_loop_closures
    n_rel = state.n_rel
    _put(state.rel_meas, n_rel, a_T_a_b)
    _put(state.rel_keys, n_rel, [key_a, key_b])
    _put(state.rel_sqrt_info, n_rel, sig)
    _put(state.rel_robust, n_rel, robust)
    _put(state.rel_weight, n_rel, 1.0)
    if remove_prior_slot >= 0:
        state.prior_weight[remove_prior_slot] = 0.0
    return state._replace(n_rel=n_rel + 1), n_rel


def _append_lc_and_solve(state: OnlineState, key_a: int, key_b: int,
                         a_T_a_b: torch.Tensor, config: EstimatorConfig,
                         remove_prior_slot: int, use_association: bool,
                         align_mask=None) -> Tuple[OnlineState, StepInfo]:
    """Append one loop-closure factor and full-solve (the preconditioner
    is built cold each time)."""
    if align_mask is not None:
        raise NotImplementedError('align_mask (multi-robot group alignment) '
                                  'comes with slice 3')
    state, _ = _append_lc_factor(state, key_a, key_b, a_T_a_b, config,
                                 remove_prior_slot, use_association)
    dev = state.traj_poses.device
    pose_mask = (torch.arange(state.traj_poses.shape[0], device=dev)
                 < state.n_poses)
    result = sv.solve(_graph_view(state), state.traj_poses, pose_mask,
                      config.solver)
    state = state._replace(traj_poses=result.poses,
                           last_error=result.error_final)
    info = StepInfo(key=torch.tensor(key_b, dtype=torch.int32, device=dev),
                    icp_valid=torch.ones((), dtype=torch.bool, device=dev),
                    icp_inliers=torch.zeros((), dtype=torch.int32,
                                            device=dev),
                    solve_error=result.error_final)
    return state, info


def online_solve(state: OnlineState, config: EstimatorConfig
                 ) -> Tuple[OnlineState, torch.Tensor]:
    """Re-run the full-graph solve on the current state (no new factors).
    Returns (state, final solve error)."""
    dev = state.traj_poses.device
    pose_mask = (torch.arange(state.traj_poses.shape[0], device=dev)
                 < state.n_poses)
    result = sv.solve(_graph_view(state), state.traj_poses, pose_mask,
                      config.solver)
    return state._replace(traj_poses=result.poses,
                          last_error=result.error_final), result.error_final


def online_loop_closure(state: OnlineState, key_a: int, key_b: int,
                        w_T_a_b: torch.Tensor, config: EstimatorConfig,
                        remove_prior_slot: int = -1,
                        use_association: bool = False,
                        align_mask=None) -> Tuple[OnlineState, StepInfo]:
    """Add a loop-closure factor between two existing keys and re-solve.

    ``w_T_a_b`` is the world-frame alignment from place recognition; it is
    converted to the relative frame of key_a exactly as
    incremental_estimator.cpp:83-87.
    """
    T_w_a = state.traj_poses[key_a]
    T_w_b = state.traj_poses[key_b]
    a_T_a_b = se3.compose(se3.inverse(T_w_a),
                          se3.compose(se3.normalize(w_T_a_b), T_w_b))
    return _append_lc_and_solve(state, key_a, key_b, a_T_a_b, config,
                                remove_prior_slot, use_association,
                                align_mask)


def extract_trajectory(state: OnlineState) -> np.ndarray:
    """One bulk device->host transfer: the valid trajectory [n,7]."""
    n = int(state.n_poses)
    return state.traj_poses[:n].cpu().numpy()


class OnlineRunner:
    """Host loop of the online path: distance gating on host odometry,
    everything else on the device.  Single track; the multi-robot
    bookkeeping, scan archive, device map and place recognition of the
    JAX runner come in later slices."""

    def __init__(self, config: EstimatorConfig, pose_capacity: int = 4096,
                 factor_capacity: int = 8192,
                 minimum_distance_to_add_pose: float = 0.0, seed: int = 0,
                 device='cuda'):
        """``seed`` seeds the runner's ``torch.Generator`` (the JAX
        runner's ``rng_key``).  ``device`` is the card unless the caller
        names another (``'cpu'`` for the CPU).  The odometry-free mode
        (``use_odometry_information=False``) comes in slice 2."""
        self.config = config
        self.device = resolve_device(device)
        self.state = init_state(config, pose_capacity, factor_capacity,
                                device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.min_dist = minimum_distance_to_add_pose
        self._last_odom: Optional[np.ndarray] = None
        # time_ns per key, in key order.
        self.key_info: list = []
        self.scan_cap = config.laser_track.input_filters.scan_capacity
        self._tracks_seen: set = set()
        self._n_priors_seen = 0
        # Host mirror of the device factor counter (2 per normal scan,
        # 1 per loop closure) for capacity guarding.
        self._n_rel_host = 0

    def _ensure_capacity(self, new_poses: int = 0, new_rels: int = 0,
                         new_priors: int = 0) -> None:
        """Grow device buffers before an append would overflow them (the
        row writes of the step have no out-of-bounds guard)."""
        P = self.state.traj_poses.shape[0]
        F = self.state.rel_meas.shape[0]
        R = self.state.prior_meas.shape[0]
        n_poses = len(self.key_info)
        kw = {}
        if n_poses + new_poses > P:
            kw['pose_capacity'] = max(P * 2, n_poses + new_poses)
        if self._n_rel_host + new_rels > F:
            kw['factor_capacity'] = max(F * 2, self._n_rel_host + new_rels)
        if self._n_priors_seen + new_priors > R:
            kw['prior_capacity'] = max(R * 2,
                                       self._n_priors_seen + new_priors)
        if kw:
            self.state = grow_state(self.state, **kw)

    def process_scan(self, time_ns: int, points: np.ndarray,
                     odom_pose7: Optional[np.ndarray] = None,
                     track_id: int = 0) -> bool:
        """Gate on travelled distance and integrate one scan; returns
        whether it was integrated."""
        if track_id != 0:
            raise NotImplementedError('multi-track runs come with slice 3')
        if odom_pose7 is None:
            raise ValueError('odometry pose required (the odometry-free '
                             'mode comes in slice 2)')
        odom_pose7 = np.asarray(odom_pose7, np.float32)
        last = self._last_odom
        if last is not None and self.min_dist > 0:
            if np.linalg.norm(odom_pose7[4:] - last[4:]) <= self.min_dist:
                return False
        self._last_odom = odom_pose7
        return self._integrate_one(time_ns, points, odom_pose7, track_id)

    def _integrate_one(self, time_ns: int, points: np.ndarray,
                       odom_pose7: np.ndarray, track_id: int = 0) -> bool:
        """Single online_step for an already-gated frame."""
        first_scan_of_track = track_id not in self._tracks_seen
        self._tracks_seen.add(track_id)
        self._ensure_capacity(new_poses=1,
                              new_rels=0 if first_scan_of_track else 2,
                              new_priors=1 if first_scan_of_track else 0)
        if not first_scan_of_track:
            self._n_rel_host += 2
        pts = np.asarray(points, np.float32)
        n = min(len(pts), self.scan_cap)
        padded = np.full((self.scan_cap, 3), pc.SENTINEL, np.float32)
        padded[:n] = pts[:n]
        self.state, _ = online_step(
            self.state, torch.from_numpy(padded).to(self.device), n,
            torch.tensor(odom_pose7, device=self.device), self.config,
            first_scan=first_scan_of_track, track_id=track_id,
            generator=self.generator)
        self.key_info.append(time_ns)
        if first_scan_of_track:
            self._n_priors_seen += 1
        return True

    def add_loop_closure(self, key_a: int, key_b: int,
                         w_T_a_b: np.ndarray,
                         verify_with_icp: bool = False) -> bool:
        """Inject a loop closure between two keys of the track and solve
        the full graph (the uncached, unrefined path of the JAX runner).
        ``verify_with_icp`` needs the scan archive of slice 3."""
        if verify_with_icp:
            raise NotImplementedError('verify_with_icp needs the scan '
                                      'archive, which comes with slice 3')
        self._ensure_capacity(new_rels=1)
        self._n_rel_host += 1
        w_T = torch.tensor(np.asarray(w_T_a_b, np.float32),
                           device=self.device)
        self.state, _ = online_loop_closure(
            self.state, int(key_a), int(key_b), w_T, self.config)
        return True

    def trajectory(self) -> dict:
        """{time_ns: pose7}."""
        poses = extract_trajectory(self.state)
        return {t: poses[i] for i, t in enumerate(self.key_info)}
