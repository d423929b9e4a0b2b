"""Device-resident online SLAM step and its host runner.

Counterpart of the core of ``laser_slam_tpu/pipeline/online.py``: the
per-scan pipeline (input filters -> normals -> scan-to-submap ICP ->
factor append -> incremental Gauss-Newton solve, full-graph or over a
sliding window -> ring push) over a state of fixed-capacity device
tensors, fed one scan at a time or in chunks by :class:`OnlineRunner`
(scanCallback -> processPoseAndLaserScan -> estimate,
laser_slam_worker.cpp:96-253, laser_track.cpp:122-231,
incremental_estimator.cpp:151-163).  Scans arrive as xyz points or as
the sensor's packed uint16 range words (:func:`online_step_ranges`).

Port notes:
* The JAX step donates its state; :func:`online_step` and the loop-
  closure functions write the state's buffers in place and return it.
* Counters (``n_poses``, ``n_rel``, ``n_prior``) stay 0-d device tensors
  and rows are written through them, so a scan needs no device read.
  The window solve slices the pose table and the factor buffers with
  index tensors built from them, not with host integers.
  The first-scan ``lax.cond`` becomes a host bool: the runner knows
  whether the track has been seen.
* ``rng_key`` becomes a ``torch.Generator`` held by the runner; the state
  carries no RNG.
* :func:`online_chunk` is a loop over :func:`online_step` on inputs
  uploaded once a chunk (JAX's ``lax.scan``); it computes the same as
  the per-scan calls, draws included.
* Loop closures: the scan archive (:class:`ScanArchive`) keeps every
  key's scan, strided to a point budget, for submap ICP around old keys;
  a closure is verified (:func:`verify_closure`), refined
  (:func:`online_loop_closure_refined`) and solved cold or with a
  persisted :class:`solver.WoodburyCache`
  (:func:`online_loop_closure_refined_cached`).  With a scan-context
  detector attached the runner finds closures itself: every scan's
  descriptor is added on the device, every ``detect_every``-th key is
  queried, and the rows are fetched ``fetch_every`` queries at a time
  (:meth:`OnlineRunner.flush_detections`).
* Multi-robot SLAM: N tracks share the pose table and the graph; a
  track's first scan takes a forced prior parked ``d * track_id`` along
  y, and a closure that links two groups of tracks drops the absorbed
  group's prior, uses the first-association sigmas and rigidly
  pre-aligns the absorbed group (:func:`_apply_group_alignment`).  Each
  track keeps its own device map (``pipeline/device_map.py``), fed from
  the ring per scan or from ``online_chunk(return_scans=True)``.
* The full-graph solves take ``offchain``, the runner's host count of
  the factors that may lie off the block-tridiagonal chain, so choosing
  the matvec reads nothing back (solver port notes).
* The JAX runner's background growth precompile hides XLA recompiles and
  has no counterpart here; neither has the delta closure solve
  (``closure_solve='delta'``, ROADMAP "Do not port").
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import dataclasses

import numpy as np
import torch

from laser_slam_tpu_torch.config import EstimatorConfig, LaserTrackConfig
from laser_slam_tpu_torch.core import benchmarker as bench
from laser_slam_tpu_torch.graph.factors import FactorGraphData
from laser_slam_tpu_torch.graph import solver as sv
from laser_slam_tpu_torch.ops import cloud as pc
from laser_slam_tpu_torch.ops import icp as icp_mod
from laser_slam_tpu_torch.ops import scan_context as sc
from laser_slam_tpu_torch.ops import se3
from laser_slam_tpu_torch.ops import spherical
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


def clone_state(state: OnlineState) -> OnlineState:
    """A copy of a state, every tensor cloned (the step writes into its
    state's tensors)."""
    return type(state)(*(t.clone() for t in state))


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


class ScanArchive(NamedTuple):
    """Downsampled per-key scan history for loop-closure submap ICP
    (buildSubMapAroundTime needs scans far older than the submap ring
    keeps, laser_track.cpp:602-651).  Row k holds the scan whose pose key
    is k, strided down to a fixed point budget.  The per-track index
    (``track_pos``/``track_keys``/``track_count``) windows a submap over
    the track's own scan sequence."""
    points: torch.Tensor       # [A,M,3] sensor frame, SENTINEL-parked
    mask: torch.Tensor         # [A,M]
    normals: torch.Tensor      # [A,M,3]
    track: torch.Tensor        # [A] int32 owning track (-1 = empty row)
    track_pos: torch.Tensor    # [A] int32 scan's position within its track
    track_keys: torch.Tensor   # [T,A] int32 global key at track position
    track_count: torch.Tensor  # [T] int32 scans stored per track


def init_archive(pose_capacity: int, points_per_scan: int,
                 n_tracks: int = 1, device='cuda') -> ScanArchive:
    device = resolve_device(device)
    A, M, i32 = pose_capacity, points_per_scan, torch.int32
    return ScanArchive(
        points=torch.full((A, M, 3), pc.SENTINEL, dtype=torch.float32,
                          device=device),
        mask=torch.zeros((A, M), dtype=torch.bool, device=device),
        normals=torch.zeros((A, M, 3), dtype=torch.float32, device=device),
        track=torch.full((A,), -1, dtype=i32, device=device),
        track_pos=torch.zeros((A,), dtype=i32, device=device),
        track_keys=torch.full((n_tracks, A), -1, dtype=i32, device=device),
        track_count=torch.zeros((n_tracks,), dtype=i32, device=device))


def archive_append(archive: ScanArchive, points: torch.Tensor,
                   mask: torch.Tensor, normals: torch.Tensor, key,
                   track_id: int = 0) -> ScanArchive:
    """Store a (filtered) scan at its pose key (a 0-d device tensor or an
    int), strided to the archive's point budget M.  Above M valid points
    are packed first and strided evenly over the VALID count (striding
    the padded range would dilute the row by the scan's fill ratio).
    Writes the archive in place and returns it."""
    N = points.shape[0]
    M = archive.points.shape[1]
    if N > M:
        # Sort-free pack: valid rows to the front, the rest to an overflow
        # row N that is cut off (JAX's scatter with mode='drop').
        dest = torch.where(mask, torch.cumsum(mask, dim=0) - 1,
                           torch.full((N,), N, device=mask.device))

        def pack(a, fill):
            out = a.new_full((N + 1,) + tuple(a.shape[1:]), fill)
            out[dest] = a
            return out[:N]

        nv = torch.sum(mask)
        i = torch.arange(M, device=points.device)
        stride_rows = (i.to(torch.float32)
                       * (nv.to(torch.float32) / M)).to(torch.int64)
        rows = torch.where(nv > M, torch.clamp(stride_rows, 0, N - 1), i)
        pts = pack(points, pc.SENTINEL)[rows]
        msk = pack(mask, False)[rows]
        nrm = pack(normals, 0.0)[rows]
    else:
        pad = M - N
        pts = torch.cat([points, points.new_full((pad, 3), pc.SENTINEL)])
        msk = torch.cat([mask, mask.new_zeros((pad,))])
        nrm = torch.cat([normals, normals.new_zeros((pad, 3))])
    pts = torch.where(msk[:, None], pts, torch.full_like(pts, pc.SENTINEL))
    pos = archive.track_count[track_id]
    _put(archive.points, key, pts)
    _put(archive.mask, key, msk)
    _put(archive.normals, key, nrm)
    _put(archive.track, key, track_id)
    _put(archive.track_pos, key, pos)
    _put(archive.track_keys[track_id], pos, key)
    archive.track_count[track_id] += 1
    return archive


def grow_archive(archive: ScanArchive, pose_capacity: int) -> ScanArchive:
    """Match a grown pose table (rows keyed by pose key)."""
    extra = pose_capacity - archive.points.shape[0]
    return archive._replace(
        points=torch.cat([archive.points, archive.points.new_full(
            (extra,) + tuple(archive.points.shape[1:]), pc.SENTINEL)]),
        mask=_pad_rows(archive.mask, pose_capacity),
        normals=_pad_rows(archive.normals, pose_capacity),
        track=torch.cat([archive.track, archive.track.new_full((extra,),
                                                               -1)]),
        track_pos=_pad_rows(archive.track_pos, pose_capacity),
        track_keys=torch.cat([archive.track_keys, archive.track_keys.new_full(
            (archive.track_keys.shape[0], extra), -1)], dim=1))


def archive_from_numpy(d: dict, device='cuda') -> ScanArchive:
    """A :class:`ScanArchive` on ``device`` from numpy arrays keyed by the
    JAX ``ScanArchive`` field names."""
    device = resolve_device(device)
    return ScanArchive(**{
        name: torch.as_tensor(np.array(d[name]), device=device)
        for name in ScanArchive._fields})


def archive_to_numpy(archive: ScanArchive) -> dict:
    return {name: getattr(archive, name).cpu().numpy()
            for name in ScanArchive._fields}


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


def _put(buf: torch.Tensor, row, value) -> None:
    """buf[row] = value with a 0-d device index (no host read) or an int.
    A Python scalar fills the row."""
    rows = torch.as_tensor(row, device=buf.device).reshape(1).long()
    if isinstance(value, (bool, int, float)):
        buf.index_fill_(0, rows, value)
        return
    value = torch.as_tensor(value, dtype=buf.dtype, device=buf.device)
    buf.index_copy_(0, rows, value.expand(buf.shape[1:])[None])


# The window's frozen predecessors and its slots for out-of-window poses
# that loop-closure factors reach (values of the JAX package).
WINDOW_MARGIN, WINDOW_ANCHORS = 8, 8


def _window_solve(state: OnlineState, i: torch.Tensor,
                  config: EstimatorConfig):
    """Solve the sliding window as a compact dense subproblem.

    Gathers the last ``window + WINDOW_MARGIN`` poses into a small table
    (plus ``WINDOW_ANCHORS`` rows holding out-of-window poses that
    loop-closure factors reference, each a frozen anchor), remaps the
    newest ``2 * window + 2`` factors' keys into it, solves it with the
    dense method and writes the window back.  The slices start at device
    counters (``base``, ``start_f``) and are gathers over ``start +
    arange``, so nothing is read back.  Returns (traj_poses, final
    error); ``state.traj_poses`` is written in place."""
    W = config.solver.window
    ANCHORS = WINDOW_ANCHORS
    traj = state.traj_poses
    dev = traj.device
    C = traj.shape[0]
    F = state.rel_meas.shape[0]
    Mw = min(W + WINDOW_MARGIN, C)
    i = i.long()
    base = torch.clamp(i + 1 - Mw, 0, C - Mw)
    Fw = min(2 * W + 2, F)
    start_f = torch.clamp(state.n_rel.long() - Fw, 0, F - Fw)
    fidx = start_f + torch.arange(Fw, device=dev)
    rel_keys = state.rel_keys[fidx].long()
    rel_weight = state.rel_weight[fidx]

    keys_l = rel_keys - base
    Mt = Mw + ANCHORS
    # Factors whose key_a predates the table (closures into the past)
    # anchor against a gathered copy of that pose; key_b is recent for
    # chronologically appended factors.  Factors with both keys out of
    # the table are dropped (all-frozen, they contribute nothing).
    b_in = (keys_l[:, 1] >= 0) & (keys_l[:, 1] < Mw)
    need = (keys_l[:, 0] < 0) & b_in & (rel_weight > 0)
    slot = torch.cumsum(need.long(), dim=0) - 1
    ok = need & (slot < ANCHORS)
    key_a_l = torch.where(ok, Mw + slot, keys_l[:, 0])
    drop = (need & ~ok) | ~b_in | ((keys_l[:, 0] < 0) & ~need)
    weight = torch.where(drop, torch.zeros_like(rel_weight), rel_weight)
    anchors = _eye_rows(ANCHORS + 1, dev)          # last row: overflow
    anchors[torch.where(ok, slot, torch.full_like(slot, ANCHORS))] = \
        traj[torch.clamp(rel_keys[:, 0], 0, C - 1)]
    key_a_l = torch.clamp(key_a_l, 0, Mt - 1)
    key_b_l = torch.clamp(keys_l[:, 1], 0, Mt - 1)

    pk_l = state.prior_keys.long() - base
    p_in = (pk_l >= 0) & (pk_l < Mw)
    graph_w = FactorGraphData(
        rel_meas=state.rel_meas[fidx],
        rel_keys=torch.stack([key_a_l, key_b_l], dim=1),
        rel_sqrt_info=state.rel_sqrt_info[fidx],
        rel_robust=state.rel_robust[fidx],
        rel_fixed_a=torch.zeros((Fw,), dtype=torch.bool, device=dev),
        rel_weight=weight,
        prior_meas=state.prior_meas,
        prior_keys=torch.clamp(pk_l, 0, Mt - 1),
        prior_sqrt_info=state.prior_sqrt_info,
        prior_weight=torch.where(p_in, state.prior_weight,
                                 torch.zeros_like(state.prior_weight)))

    g_idx = base + torch.arange(Mw, device=dev)
    poses_tab = torch.cat([traj[g_idx], anchors[:ANCHORS]])
    mask_w = (g_idx < i + 1) & (g_idx >= i + 1 - W)
    mask_tab = torch.cat([mask_w, torch.zeros((ANCHORS,), dtype=torch.bool,
                                              device=dev)])
    scfg = dataclasses.replace(config.solver, method='dense')
    result = sv.solve(graph_w, poses_tab, mask_tab, scfg)
    new_window = torch.where(mask_w[:, None], result.poses[:Mw],
                             poses_tab[:Mw])
    traj.index_copy_(0, g_idx, new_window)
    return traj, result.error_final


def ingest(points: torch.Tensor, n_valid, config: EstimatorConfig,
           generator: Optional[torch.Generator] = None):
    """The step's first stage: input filters, the store decimation and
    per-point normals (laser_track.cpp:146).  Returns (scan, normals)."""
    return ingest_track(points, n_valid, config.laser_track, generator)


def ingest_track(points: torch.Tensor, n_valid, lt: LaserTrackConfig,
                 generator: Optional[torch.Generator] = None):
    """:func:`ingest` for one track's config; ``LaserTrack`` calls it too
    (the JAX package's ``laser_track._ingest_scan``)."""
    f = lt.input_filters
    scan = store_decimate(input_filters(points, n_valid, f, generator), f)
    return scan, compute_normals(scan, lt.icp)


def input_filters(points: torch.Tensor, n_valid, f,
                  generator: Optional[torch.Generator] = None) -> pc.Cloud:
    """The input filters of :func:`ingest_track` (``f`` an
    InputFilterConfig): the configured chain, or the range filter and
    random sampling."""
    mask = torch.arange(points.shape[0], device=points.device) < n_valid
    scan = pc.park_invalid(pc.Cloud(points, mask))
    if f.chain:
        # The configured ordered chain (laser_track.cpp:24-30).
        return pc.apply_filter_chain(scan, f.chain, generator)
    scan = pc.range_filter(scan, f.min_distance_m, f.max_distance_m)
    if f.random_sampling_ratio < 1.0:
        scan = pc.random_sampling_filter(scan, f.random_sampling_ratio,
                                         generator)
    return scan


def store_decimate(scan: pc.Cloud, f) -> pc.Cloud:
    """The stored scan: ``scan`` decimated to the store capacity when it
    holds more rows."""
    store_cap = f.store_capacity or f.scan_capacity
    if store_cap < scan.points.shape[0]:
        # Even stride over the packed valid points (a plain compact would
        # keep only the first beams of a ring-major scan).
        scan = pc.compact_decimate(scan, store_cap)
    return scan


def submap(state: OnlineState, track_id: int = 0):
    """The track's ring of scans in the frame of its newest scan
    (laser_track.cpp:466-519): (cloud [K*N], normals [K*N, 3])."""
    prev_traj = state.traj_poses[state.track_last_key[track_id].long()]
    ring_keys = state.ring_keys[track_id].long()
    ring_rel = torch.where(
        (ring_keys >= 0)[:, None],
        se3.compose(se3.inverse(prev_traj),
                    state.traj_poses[torch.clamp(ring_keys, min=0)]),
        se3.identity(device=prev_traj.device))
    return assemble_submap(state.ring_points[track_id],
                           state.ring_mask[track_id],
                           state.ring_normals[track_id], ring_rel)


def assemble_submap(points: torch.Tensor, masks: torch.Tensor,
                    normals: torch.Tensor, rels: torch.Tensor):
    """K stacked scans [K,N,...] moved by ``rels`` [K,7] and concatenated:
    (cloud [K*N], normals [K*N, 3]); the device core of
    buildSubMapAroundTime (laser_track.cpp:602-651)."""
    pts = se3.apply(rels[:, None, :], points)
    nrm = se3.quat_rotate(rels[:, None, :4], normals)
    K, N, _ = points.shape
    cloud = pc.Cloud(
        torch.where(masks[..., None], pts,
                    torch.full_like(pts, pc.SENTINEL)).reshape(K * N, 3),
        masks.reshape(K * N))
    return cloud, nrm.reshape(K * N, 3)


def reading_of(scan: pc.Cloud, config: EstimatorConfig,
               generator: Optional[torch.Generator] = None) -> pc.Cloud:
    """The ICP reading: the scan sampled at ``reading_sampling_ratio`` and
    decimated evenly to ``reading_capacity`` (a prefix of a ring-major
    beam scan would keep only its top rings)."""
    return sample_reading(scan, config.laser_track.icp, generator)


def sample_reading(scan: pc.Cloud, icp_cfg,
                   generator: Optional[torch.Generator] = None) -> pc.Cloud:
    """:func:`reading_of` for an ICP config; ``LaserTrack`` calls it
    too."""
    if icp_cfg.reading_sampling_ratio < 1.0:
        scan = pc.random_sampling_filter(
            scan, icp_cfg.reading_sampling_ratio, generator)
    return pc.compact_decimate(scan, icp_cfg.reading_capacity)


def online_step(state: OnlineState, points: torch.Tensor,
                n_valid, odom_pose7: torch.Tensor,
                config: EstimatorConfig, first_scan: bool,
                track_id: int = 0,
                generator: Optional[torch.Generator] = None,
                odometry_free: bool = False, offchain: Optional[int] = None
                ) -> Tuple[OnlineState, StepInfo]:
    """Integrate one scan of one track.  ``points`` padded to capacity,
    the first ``n_valid`` (a host int or a 0-d device tensor) valid.

    ``first_scan`` (host bool) selects the prior branch for a track's
    first scan — the JAX step's ``lax.cond(prev_key < 0, ...)``.  With
    ``force_priors`` that prior parks the track at y = d * track_id
    (laser_track.cpp:166-170).  ``generator`` feeds the random-sampling
    filters when their ratio is below 1.  ``odometry_free``: ignore
    ``odom_pose7`` after the first scan and propagate by constant
    velocity — the relative motion between the last two solved poses is
    replayed as the pseudo-odometry measurement (laser_slam_worker.cpp:
    135-162).  ``offchain``: the full-graph solve's off-chain bound
    (:func:`solver.solve`); the window solve needs none.
    """
    lt = config.laser_track
    dev = points.device
    f32 = torch.float32

    scan, normals = ingest(points, n_valid, config, generator)

    i = state.n_poses
    odom = se3.normalize(odom_pose7)

    if first_scan:
        prior_T = odom
        if lt.force_priors:
            # Offset tracks along y (laser_track.cpp:166-170), the f32
            # product of the JAX step.
            prior_T = se3.identity(device=dev)
            prior_T[5] = float(np.float32(lt.distance_between_prior_poses_m)
                               * np.float32(track_id))
        _put(state.traj_poses, i, prior_T)
        _put(state.pose_meas, i, odom)
        _put(state.prior_meas, state.n_prior, prior_T)
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
        prev_traj = state.traj_poses[prev_key]
        rel, odom_eff = step_guess(state, odom, track_id, odometry_free)
        propagated = se3.normalize(se3.compose(prev_traj, rel))

        # Scan-to-submap ICP in the previous scan's frame.
        reference, ref_normals = submap(state, track_id)
        icp_res = icp_mod.icp_point_to_plane(
            reading_of(scan, config, generator), reference, ref_normals,
            rel, lt.icp)

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
        _put(state.pose_meas, i, odom_eff)
        state = state._replace(
            n_rel=n_rel + 2,
            last_icp_valid=icp_res.valid,
            last_icp_inliers=icp_res.num_inliers.to(torch.int32))

    # --- incremental solve (incremental_estimator.cpp:151-163) ----------
    if config.solver.window > 0:
        # The newest `window` poses as a compact dense subproblem: the
        # online path appends factors chronologically (2 a scan), so the
        # window's factors are the newest ones.
        traj, error = _window_solve(state, i, config)
    else:
        pose_mask = (torch.arange(state.traj_poses.shape[0], device=dev)
                     < (i + 1))
        result = sv.solve(_graph_view(state), state.traj_poses, pose_mask,
                          config.solver, offchain)
        traj, error = result.poses, result.error_final
    # Ring push for this track (newest scan last).
    for ring, value in ((state.ring_points, scan.points),
                        (state.ring_mask, scan.mask),
                        (state.ring_normals, normals)):
        ring[track_id] = torch.cat([ring[track_id, 1:], value[None]])
    state.ring_keys[track_id] = torch.cat(
        [state.ring_keys[track_id, 1:], i.reshape(1)])
    state.track_last_key[track_id] = i
    state = state._replace(traj_poses=traj, n_poses=i + 1,
                           last_error=error)
    info = StepInfo(key=i, icp_valid=state.last_icp_valid,
                    icp_inliers=state.last_icp_inliers,
                    solve_error=state.last_error)
    return state, info


def step_guess(state: OnlineState, odom: torch.Tensor, track_id: int = 0,
               odometry_free: bool = False):
    """The motion since the track's last scan, as :func:`online_step`
    takes it for a scan after the first.  Returns (rel, odom_eff): the
    ICP guess and odometry factor, and the odometry pose stored for the
    new key.  ``odometry_free``: constant velocity, the relative motion
    between the last two solved poses replayed (identity until two poses
    exist)."""
    prev_key = state.track_last_key[track_id].long()
    prev_meas = state.pose_meas[prev_key]
    if not odometry_free:
        return se3.compose(se3.inverse(prev_meas), odom), odom
    ring_keys = state.ring_keys[track_id].long()
    prev2_key = (ring_keys[-2] if ring_keys.shape[0] >= 2
                 else torch.full((), -1, dtype=torch.int64,
                                 device=odom.device))
    prev_traj = state.traj_poses[prev_key]
    prev2 = state.traj_poses[torch.clamp(prev2_key, min=0)]
    rel = torch.where(
        prev2_key >= 0,
        se3.normalize(se3.compose(se3.inverse(prev2), prev_traj)),
        se3.identity(device=odom.device))
    return rel, se3.normalize(se3.compose(prev_meas, rel))


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


def _apply_group_alignment(state: OnlineState, key_a, key_b,
                           a_T_a_b: torch.Tensor,
                           align_mask: torch.Tensor) -> OnlineState:
    """Rigidly pre-align the absorbed group's poses so that the new
    linking factor holds when the solve starts.

    A cross-track link asks for a ~100 m move of every pose of the
    absorbed track; from the parked state that is a valley of near-zero
    curvature, and with interleaved keys no factor of the track lies on
    the chain the preconditioner carries (the JAX package's docstring).
    The correction C = T_a meas T_b^-1 (or its reverse, when key_a's side
    is the absorbed one: ``align_mask[key_b]`` picks on the device) is
    applied to every pose of the group, as the reference shifts a
    worker's whole odom frame (laser_slam_worker.cpp:522-540)."""
    T_w_a = state.traj_poses[key_a]
    T_w_b = state.traj_poses[key_b]
    C_b = se3.compose(T_w_a, se3.compose(a_T_a_b, se3.inverse(T_w_b)))
    C_a = se3.compose(T_w_b, se3.compose(se3.inverse(a_T_a_b),
                                         se3.inverse(T_w_a)))
    C = torch.where(align_mask[key_b], C_b, C_a)
    aligned = se3.normalize(se3.compose(C[None], state.traj_poses))
    return state._replace(traj_poses=torch.where(
        align_mask[:, None], aligned, state.traj_poses))


def _append_lc_and_solve(state: OnlineState, key_a: int, key_b: int,
                         a_T_a_b: torch.Tensor, config: EstimatorConfig,
                         remove_prior_slot: int, use_association: bool,
                         align_mask=None, offchain: Optional[int] = None
                         ) -> Tuple[OnlineState, StepInfo]:
    """Append one loop-closure factor and full-solve (the preconditioner
    is built cold each time).  ``align_mask`` ([C] bool, linking
    closures): the absorbed group, pre-aligned first."""
    if align_mask is not None:
        state = _apply_group_alignment(state, key_a, key_b, a_T_a_b,
                                       align_mask)
    state, _ = _append_lc_factor(state, key_a, key_b, a_T_a_b, config,
                                 remove_prior_slot, use_association)
    result = sv.solve(_graph_view(state), state.traj_poses,
                      _pose_mask(state), config.solver, offchain)
    return _lc_result(state, key_b, result)


def _pose_mask(state: OnlineState) -> torch.Tensor:
    dev = state.traj_poses.device
    return (torch.arange(state.traj_poses.shape[0], device=dev)
            < state.n_poses)


def _lc_result(state: OnlineState, key_b: int, result: sv.SolveResult):
    """The state after a closure solve, and its StepInfo."""
    dev = state.traj_poses.device
    state = state._replace(traj_poses=result.poses,
                           last_error=result.error_final)
    info = StepInfo(key=torch.tensor(key_b, dtype=torch.int32, device=dev),
                    icp_valid=torch.ones((), dtype=torch.bool, device=dev),
                    icp_inliers=torch.zeros((), dtype=torch.int32,
                                            device=dev),
                    solve_error=result.error_final)
    return state, info


def _append_lc_and_solve_cached(state: OnlineState, cache: sv.WoodburyCache,
                                key_a: int, key_b: int,
                                a_T_a_b: torch.Tensor,
                                config: EstimatorConfig,
                                remove_prior_slot: int,
                                use_association: bool, align_mask=None,
                                offchain: Optional[int] = None):
    """Cached-preconditioner closure solve: absorb the new factor into the
    persisted WoodburyCache (a rank-6 extension of its capacitance
    factor) and solve with it, as iSAM2 updates its Bayes tree instead
    of refactoring (incremental_estimator.cpp:151-163).  Returns (state,
    cache, info); the cache is extended in place."""
    if config.solver.closure_solve != 'full':
        raise NotImplementedError(
            f"closure_solve={config.solver.closure_solve!r}: the port runs "
            "'full' only; the delta solve (solve_closure_cached) is on the "
            "ROADMAP's \"Do not port\" list")
    if align_mask is not None:
        state = _apply_group_alignment(state, key_a, key_b, a_T_a_b,
                                       align_mask)
    state, idx = _append_lc_factor(state, key_a, key_b, a_T_a_b, config,
                                   remove_prior_slot, use_association)
    graph, pose_mask = _graph_view(state), _pose_mask(state)
    cache = sv.extend_cache(graph, state.traj_poses, pose_mask, cache, idx,
                            config.solver)
    result = sv.solve_cached(graph, state.traj_poses, pose_mask, cache,
                             config.solver, offchain)
    state, info = _lc_result(state, key_b, result)
    return state, cache, info


def online_step_ranges(state: OnlineState, words: torch.Tensor,
                       table: spherical.BeamTable, odom_pose7: torch.Tensor,
                       config: EstimatorConfig, first_scan: bool,
                       track_id: int = 0,
                       generator: Optional[torch.Generator] = None,
                       odometry_free: bool = False,
                       range_unit_m: Optional[float] = None,
                       offchain: Optional[int] = None
                       ) -> Tuple[OnlineState, StepInfo]:
    """:func:`online_step` fed by the sensor's native encoding: integer
    range words ``[B, A]`` on the device (0 = no echo;
    :func:`spherical.words_to_device`) and a device-resident
    :class:`spherical.BeamTable`, decoded to points as the step's first
    stage.  The decode lands the points in the packed ring-major layout
    of the xyz path, so the two paths differ only by the range
    quantization."""
    if range_unit_m is None:
        range_unit_m = spherical.RANGE_UNIT_M
    points, n_valid = spherical.decode_and_pack(words, table, range_unit_m)
    return online_step(state, points, n_valid, odom_pose7, config,
                       first_scan, track_id, generator,
                       odometry_free=odometry_free, offchain=offchain)


def decode_ranges_chunk(words: torch.Tensor, table: spherical.BeamTable,
                        range_unit_m: Optional[float] = None):
    """Decode a chunk of range images ``[C, B, A]`` into device-resident
    ``(points [C, B*A, 3], n_valid [C])`` for :func:`online_chunk`."""
    if range_unit_m is None:
        range_unit_m = spherical.RANGE_UNIT_M
    return spherical.decode_and_pack(words, table, range_unit_m)


def online_chunk(state: OnlineState, archive, points: torch.Tensor,
                 n_valid: torch.Tensor, odom_pose7s: torch.Tensor,
                 track_ids, config: EstimatorConfig,
                 odometry_free: bool = False, with_archive: bool = False,
                 return_scans: bool = False, pr_db=None, pr_keys=None,
                 pr_n=None, pr_config=None, first_scan: bool = False,
                 generator: Optional[torch.Generator] = None,
                 offchain=None):
    """Integrate C scans from device-resident stacks: points [C,N,3],
    n_valid [C], odom_pose7s [C,7]; ``track_ids`` host ints [C].

    The JAX package scans its step over the chunk in one program; here
    it is a loop over :func:`online_step` on inputs uploaded once, with
    the same result as C per-scan calls (the generator's draws
    included).  ``first_scan`` says that the chunk's first scan is its
    track's first.

    ``with_archive``: append each scan to ``archive`` (in place).
    ``pr_db``/``pr_keys`` (the detector's tables, written in place),
    ``pr_n`` (its host count) and ``pr_config`` (a
    PlaceRecognitionConfig) run the scan-context cadence as further
    stages of each scan: its descriptor is added to the database, and
    every ``detect_every``-th key is first queried against it; the rows
    (matched key, distance, yaw), or the sentinel (-1, inf, 0) where no
    query ran, stay on the device as one [C,3] tensor.  Cooldown
    filtering waits for the flush (OnlineRunner.flush_detections).
    ``return_scans``: also stack each scan's stored points and mask and
    the pose solved at that step, for ``DeviceMapper.accumulate_chunk``
    (the ring keeps only the last few scans).  ``offchain``: each step's
    off-chain bound (host ints [C], :func:`online_step`).

    Returns (state, archive, infos[, (scan_pts [C,N,3], scan_msk [C,N],
    pose7s [C,7])][, (pr_db, pr_keys, pr_n, pr_rows)]) with the infos'
    fields stacked."""
    use_pr = pr_config is not None
    infos, rows, scans = [], [], []
    for c in range(points.shape[0]):
        tid = int(track_ids[c])
        state, info = online_step(
            state, points[c], n_valid[c], odom_pose7s[c], config,
            first_scan=first_scan and c == 0, track_id=tid,
            generator=generator, odometry_free=odometry_free,
            offchain=None if offchain is None else offchain[c])
        infos.append(info)
        scan_pts = state.ring_points[tid, -1]
        scan_msk = state.ring_mask[tid, -1]
        if return_scans:
            # Copies: the ring and the pose table are written in place by
            # the next steps.
            scans.append((scan_pts.clone(), scan_msk.clone(),
                          state.traj_poses[info.key.long()].clone()))
        if with_archive:
            archive = archive_append(archive, scan_pts, scan_msk,
                                     state.ring_normals[tid, -1], info.key,
                                     tid)
        if use_pr:
            rows.append(_pr_stage(pr_db, pr_keys, pr_n, scan_pts, scan_msk,
                                  info.key, pr_config))
            pr_n += 1
    out = (state, archive,
           StepInfo(*(torch.stack(v) for v in zip(*infos))))
    if return_scans:
        out += (tuple(torch.stack(v) for v in zip(*scans)),)
    if use_pr:
        out += ((pr_db, pr_keys, pr_n, torch.stack(rows)),)
    return out


def _pr_stage(db, db_keys, n: int, points, mask, key, c) -> torch.Tensor:
    """One scan's detector stage inside a chunk: query the database when
    ``key`` is on the ``detect_every`` cadence (and the database is not
    empty), then add the scan's descriptor at slot ``n``.  Returns the
    [3] row, the sentinel (-1, inf, 0) where no query ran."""
    desc, dist, shift = sc.descriptor_and_query(
        db, db_keys, points, mask, key - c.exclude_recent_keys,
        n_rings=c.n_rings, n_sectors=c.n_sectors,
        max_radius_m=c.max_radius_m, z_offset_m=c.z_offset_m)
    row = sc.best_row(dist, shift, db_keys, c.n_sectors)
    do_q = (key % max(c.detect_every, 1) == 0) & (n > 0)
    # Filled on the device: a host tensor would be a blocking copy.
    sentinel = torch.zeros_like(row)
    sentinel[0], sentinel[1] = -1.0, float('inf')
    row = torch.where(do_q, row, sentinel)
    db[n] = desc
    db_keys[n] = key
    return row


def online_solve(state: OnlineState, config: EstimatorConfig,
                 offchain: Optional[int] = None
                 ) -> Tuple[OnlineState, torch.Tensor]:
    """Re-run the full-graph solve on the current state (no new factors).
    A cross-track link's ~100 m correction leaves chain rotations that
    one solve's trust region does not absorb; extra passes (``refine``)
    polish them.  Returns (state, final solve error)."""
    dev = state.traj_poses.device
    pose_mask = (torch.arange(state.traj_poses.shape[0], device=dev)
                 < state.n_poses)
    result = sv.solve(_graph_view(state), state.traj_poses, pose_mask,
                      config.solver, offchain)
    return state._replace(traj_poses=result.poses,
                          last_error=result.error_final), result.error_final


def online_loop_closure(state: OnlineState, key_a: int, key_b: int,
                        w_T_a_b: torch.Tensor, config: EstimatorConfig,
                        remove_prior_slot: int = -1,
                        use_association: bool = False,
                        align_mask=None, offchain: Optional[int] = None
                        ) -> Tuple[OnlineState, StepInfo]:
    """Add a loop-closure factor between two existing keys and re-solve.

    ``w_T_a_b`` is the world-frame alignment from place recognition; it is
    converted to the relative frame of key_a exactly as
    incremental_estimator.cpp:83-87.  Linking closures pass
    ``remove_prior_slot``, ``use_association`` and ``align_mask`` (the
    absorbed group, rigidly pre-aligned: :func:`_apply_group_alignment`).
    """
    return _append_lc_and_solve(
        state, key_a, key_b, _relative_guess(state, key_a, key_b, w_T_a_b),
        config, remove_prior_slot, use_association, align_mask, offchain)


def _relative_guess(state: OnlineState, key_a, key_b, w_T_a_b):
    """The world-frame alignment in key_a's frame (incremental_estimator.
    cpp:83-87): T_w_a^-1 w_T_a_b T_w_b."""
    return se3.compose(se3.inverse(state.traj_poses[key_a]),
                       se3.compose(se3.normalize(w_T_a_b),
                                   state.traj_poses[key_b]))


def online_loop_closure_cached(state: OnlineState, cache: sv.WoodburyCache,
                               key_a: int, key_b: int,
                               w_T_a_b: torch.Tensor,
                               config: EstimatorConfig,
                               remove_prior_slot: int = -1,
                               use_association: bool = False,
                               align_mask=None,
                               offchain: Optional[int] = None):
    """:func:`online_loop_closure` with a persisted solver cache: the new
    factor extends the cached capacitance factor instead of a rebuild.
    Returns (state, cache, info)."""
    return _append_lc_and_solve_cached(
        state, cache, key_a, key_b,
        _relative_guess(state, key_a, key_b, w_T_a_b), config,
        remove_prior_slot, use_association, align_mask, offchain)


def _gather_submap(state: OnlineState, archive: ScanArchive, center_key,
                   frame_T_inv: torch.Tensor, radius: int):
    """Submap around a key from the archive, in ``frame_T_inv``'s frame
    (buildSubMapAroundTime, laser_track.cpp:602-651): the ``radius``
    preceding and following scans OF THE CENTER KEY'S TRACK, moved by
    their current pose estimates.  Returns (cloud [(2R+1)*M], normals).
    Every index is clamped: JAX clamps its out-of-range gathers, torch
    would raise."""
    A = archive.points.shape[0]
    dev = archive.points.device
    track = archive.track[center_key].long()
    tid = torch.clamp(track, min=0)
    ps = (archive.track_pos[center_key].long()
          + torch.arange(-radius, radius + 1, device=dev))
    ks = archive.track_keys[tid, torch.clamp(ps, 0, A - 1)].long()
    ksc = torch.clamp(ks, 0, A - 1)
    valid_k = ((ps >= 0) & (ps < archive.track_count[tid]) &
               (ks >= 0) & (ks < state.n_poses) & (track >= 0))
    msk = archive.mask[ksc] & valid_k[:, None]
    rel = se3.compose(frame_T_inv, state.traj_poses[ksc])      # [2R+1,7]
    return assemble_submap(archive.points[ksc], msk, archive.normals[ksc],
                           rel)


def _closure_icp(state: OnlineState, archive: ScanArchive, key_a, key_b,
                 w_T_a_b, config: EstimatorConfig):
    """Submap ICP of a closure candidate (incremental_estimator.cpp:
    90-115): radius submaps around both keys from the archive, key_b's
    compacted to the reading budget and registered point-to-plane onto
    key_a's, from the candidate's alignment.  Returns (guess, reading,
    icp result)."""
    R = config.loop_closures_sub_maps_radius
    guess = _relative_guess(state, key_a, key_b, w_T_a_b)
    submap_a, normals_a = _gather_submap(
        state, archive, key_a, se3.inverse(state.traj_poses[key_a]), R)
    submap_b, _ = _gather_submap(
        state, archive, key_b, se3.inverse(state.traj_poses[key_b]), R)
    icp_cfg = config.laser_track.icp
    reading = pc.compact(submap_b, icp_cfg.reading_capacity)
    res = icp_mod.icp_point_to_plane(reading, submap_a, normals_a, guess,
                                     icp_cfg)
    return guess, reading, res


def _refine_lc_meas(state: OnlineState, archive: ScanArchive, key_a, key_b,
                    w_T_a_b, config: EstimatorConfig):
    """Submap-ICP refinement of a closure alignment; a failed ICP falls
    back to the guess (the reference's ConvergenceError path,
    laser_track.cpp:495-502).  Returns (meas, icp result)."""
    guess, _, res = _closure_icp(state, archive, key_a, key_b, w_T_a_b,
                                 config)
    return torch.where(res.valid, res.T, guess), res


def online_loop_closure_refined(state: OnlineState, archive: ScanArchive,
                                key_a: int, key_b: int,
                                w_T_a_b: torch.Tensor,
                                config: EstimatorConfig,
                                remove_prior_slot: int = -1,
                                use_association: bool = False,
                                align_mask=None,
                                offchain: Optional[int] = None
                                ) -> Tuple[OnlineState, StepInfo]:
    """Loop closure with submap-ICP refinement of the alignment (see
    :func:`_refine_lc_meas`), solved cold."""
    meas, res = _refine_lc_meas(state, archive, key_a, key_b, w_T_a_b,
                                config)
    state, info = _append_lc_and_solve(state, key_a, key_b, meas, config,
                                       remove_prior_slot, use_association,
                                       align_mask, offchain)
    return state, info._replace(icp_valid=res.valid,
                                icp_inliers=res.num_inliers)


def online_loop_closure_refined_cached(state: OnlineState,
                                       archive: ScanArchive,
                                       cache: sv.WoodburyCache,
                                       key_a: int, key_b: int,
                                       w_T_a_b: torch.Tensor,
                                       config: EstimatorConfig,
                                       remove_prior_slot: int = -1,
                                       use_association: bool = False,
                                       align_mask=None,
                                       offchain: Optional[int] = None):
    """:func:`online_loop_closure_refined` with a persisted solver cache
    (see :func:`online_loop_closure_cached`).  Returns (state, cache,
    info)."""
    meas, res = _refine_lc_meas(state, archive, key_a, key_b, w_T_a_b,
                                config)
    state, cache, info = _append_lc_and_solve_cached(
        state, cache, key_a, key_b, meas, config, remove_prior_slot,
        use_association, align_mask, offchain)
    return state, cache, info._replace(icp_valid=res.valid,
                                       icp_inliers=res.num_inliers)


def verify_closure(state: OnlineState, archive: ScanArchive, key_a, key_b,
                   w_T_a_b: torch.Tensor,
                   config: EstimatorConfig) -> torch.Tensor:
    """Geometric verification of a loop-closure CANDIDATE (no state
    change): submap ICP from the candidate alignment, scored by fit.
    The reference trusts whatever segmatch sends (incremental_estimator.
    cpp:63-149); with in-tree detection a gate is needed, since descriptor
    matching is subject to perceptual aliasing.

    Returns [4] f32 on the device: (icp_valid, mean |p2pl residual| m,
    inlier fraction of the reading, reading point count)."""
    _, reading, res = _closure_icp(state, archive, key_a, key_b, w_T_a_b,
                                   config)
    n_read = torch.clamp(torch.sum(reading.mask), min=1).to(torch.float32)
    frac = res.num_inliers.to(torch.float32) / n_read
    return torch.stack([res.valid.to(torch.float32), res.mean_error, frac,
                        n_read])


def extract_trajectory(state: OnlineState) -> np.ndarray:
    """One bulk device->host transfer: the valid trajectory [n,7]."""
    n = int(state.n_poses)
    return state.traj_poses[:n].cpu().numpy()


class OnlineRunner:
    """Host loop of the online path: distance gating on host odometry,
    everything else on the device.  N tracks (robots) share one pose
    table and graph; each track's scans come as xyz points or, after
    :meth:`enable_packed_ingest`, as uint16 range images, one at a time
    (:meth:`process_scan`) or in chunks (:meth:`process_scans`).  A
    closure that links two groups of tracks follows the reference's
    linked-worker semantics (incremental_estimator.cpp:165-266) through
    host bookkeeping and device writes.  With a scan archive and a
    place-recognition detector it finds, verifies and injects loop
    closures itself; with a map config it keeps a device map per
    track."""

    def __init__(self, config: EstimatorConfig, pose_capacity: int = 4096,
                 factor_capacity: int = 8192,
                 minimum_distance_to_add_pose: float = 0.0, seed: int = 0,
                 use_odometry_information: bool = True,
                 archive_points: int = 0, place_recognition=None,
                 n_tracks: int = 1, map_config=None, device='cuda'):
        """``seed`` seeds the runner's ``torch.Generator`` (the JAX
        runner's ``rng_key``).  ``use_odometry_information=False``
        switches to the constant-velocity odometry-free mode (pass
        ``odom_pose7=None``).  ``archive_points`` > 0 keeps a per-key scan
        archive of that many points a scan on the device: closures can
        then be verified, and are refined by submap ICP when
        ``config.do_icp_step_on_loop_closures`` is set.
        ``place_recognition`` (a PlaceRecognitionConfig) attaches the
        scan-context detector, so loop closures are detected and injected
        automatically (pair it with ``archive_points``).  ``n_tracks``
        robots share the graph (``config.laser_track.force_priors`` parks
        each at its own prior).  ``map_config`` (a WorkerConfig) attaches
        a device map per track (:class:`device_map.DeviceMapper`).
        ``device`` is the card unless the caller names another (``'cpu'``
        for the CPU)."""
        self.config = config
        self.device = resolve_device(device)
        self.n_tracks = n_tracks
        self.state = init_state(config, pose_capacity, factor_capacity,
                                n_tracks=n_tracks, device=self.device)
        self.seed = seed
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.min_dist = minimum_distance_to_add_pose
        self.use_odometry = use_odometry_information
        self._last_odom: list = [None] * n_tracks
        self.archive = (init_archive(pose_capacity, archive_points,
                                     n_tracks, device=self.device)
                        if archive_points > 0 else None)
        self.mapper = None
        if map_config is not None:
            from laser_slam_tpu_torch.pipeline.device_map import DeviceMapper
            self.mapper = DeviceMapper(map_config, n_tracks=n_tracks,
                                       device=self.device)
        self.detector = None
        if place_recognition is not None:
            from laser_slam_tpu_torch.pipeline.place_recognition import (
                ScanContextDetector)
            self.detector = ScanContextDetector(place_recognition,
                                                device=self.device)
        self.detections: list = []       # (key_a, key_b, distance, yaw)
        # Candidates that failed a gate: (key_a, key_b, distance,
        # inlier_fraction, mean_residual_m); a fraction of -1 marks the
        # odometry-consistency gate, with the separation in metres last.
        self.rejected_detections: list = []
        self._pr_pending: list = []      # unfetched (keys, device rows)
        # (track_id, time_ns) per key, in key order.
        self.key_info: list = []
        self.scan_cap = config.laser_track.input_filters.scan_capacity
        # Multi-robot bookkeeping (IncrementalEstimator's): the groups of
        # linked tracks and the prior slot of each unlinked track > 0.
        self._linked_groups: list = []
        self._prior_slot_of_track: dict = {}
        self._tracks_seen: set = set()
        self._n_priors_seen = 0
        # Host mirror of the device factor counter (2 per normal scan,
        # 1 per loop closure) for capacity guarding.
        self._n_rel_host = 0
        # Host bound on the factors off the block-tridiagonal chain (key_b
        # != key_a + 1, or a prior's key), which picks the solver's matvec
        # without a device read; the keys of the priors and each track's
        # last key feed it.
        self._n_offchain_host = 0
        self._prior_keys: set = set()
        self._last_key: dict = {}
        # Packed (uint16 range-image) ingest — see enable_packed_ingest.
        self._beam_table = None
        self._range_unit_m = None
        # Persisted closure-solve cache (solver.WoodburyCache): built on
        # the first closure, extended rank-6 per closure, rebuilt after
        # cache_rebuild_after appended factors or any growth.
        self._solver_cache = None
        self._cache_rel_count = 0

    def enable_packed_ingest(self, elev_deg, n_azimuth: int,
                             range_unit_m: Optional[float] = None) -> None:
        """Accept scans as sensor-native uint16 range images.

        After this call, :meth:`process_scan` / :meth:`process_scans` take
        a 2-D uint16 ``points`` payload ``[n_beams, n_azimuth]`` (0 = no
        echo, else range in ``range_unit_m`` units) as a packed scan: it
        is uploaded as-is (2 B/point against 12 B for xyz) and decoded on
        the device.  Float ``[N, 3]`` payloads keep working.  ``elev_deg``
        is the sensor's per-ring elevation table (e.g.
        ``velodyne_sim.HDL64_ELEV_DEG``)."""
        self._beam_table = spherical.beam_table(elev_deg, n_azimuth,
                                                device=self.device)
        self._range_unit_m = float(range_unit_m if range_unit_m is not None
                                   else spherical.RANGE_UNIT_M)

    def _is_packed_scan(self, points) -> bool:
        packed = (getattr(points, 'dtype', None) == np.uint16
                  and getattr(points, 'ndim', 0) == 2)
        if packed and self._beam_table is None:
            raise ValueError('uint16 range-image scan received but packed '
                             'ingest is not configured; call '
                             'enable_packed_ingest(elev_deg, n_azimuth) '
                             'first')
        return packed

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
            if self.archive is not None and 'pose_capacity' in kw:
                self.archive = grow_archive(self.archive,
                                            kw['pose_capacity'])
            # The solver cache's chain factorization is sized to the old
            # pose capacity.
            self._solver_cache = None

    def _check_track(self, track_id: int) -> None:
        if not 0 <= track_id < self.n_tracks:
            raise ValueError(f'track_id {track_id} outside the runner\'s '
                             f'n_tracks={self.n_tracks}')

    def _gate(self, odom_pose7, track_id: int) -> Optional[np.ndarray]:
        """The odometry to integrate a frame with, or None when the frame
        has not moved far enough since the track's last one."""
        if odom_pose7 is None:
            if self.use_odometry:
                raise ValueError('odometry pose required when '
                                 'use_odometry_information is set')
            return se3.identity().numpy()
        odom_pose7 = np.asarray(odom_pose7, np.float32)
        last = self._last_odom[track_id]
        if last is not None and self.min_dist > 0:
            if np.linalg.norm(odom_pose7[4:] - last[4:]) <= self.min_dist:
                return None
        self._last_odom[track_id] = odom_pose7
        return odom_pose7

    def process_scan(self, time_ns: int, points: np.ndarray,
                     odom_pose7: Optional[np.ndarray] = None,
                     track_id: int = 0) -> bool:
        """Gate on travelled distance and integrate one scan (xyz
        ``[N, 3]`` or, with packed ingest, uint16 ``[B, A]``) of track
        ``track_id``; returns whether it was integrated.  Timed as
        ``online.process_scan`` when the benchmarker is on (host time:
        the card runs asynchronously)."""
        self._check_track(track_id)
        with bench.scoped_timer('online.process_scan'):
            odom = self._gate(odom_pose7, track_id)
            if odom is None:
                return False
            return self._integrate_one(time_ns, points, odom, track_id)

    def process_scans(self, frames, track_id: int = 0,
                      chunk_size: int = 8) -> int:
        """Chunked ingestion of ``(time_ns, points, odom_pose7)`` tuples
        (or ScanFrame-likes) of one track: ``chunk_size`` scans a chunk,
        uploaded in one transfer and run by :func:`online_chunk`; a
        remainder runs through the per-scan step.  Gives the same result
        as :meth:`process_scan` per frame; returns the number of scans
        accepted (min-distance gating applies).  An attached mapper
        accumulates each chunk from its ``return_scans`` outputs.  Timed
        as ``online.process_scans``."""
        self._check_track(track_id)
        frames = [(f.time_ns, f.points, f.odom_pose7)
                  if hasattr(f, 'points') else f for f in frames]
        with bench.scoped_timer('online.process_scans'):
            accepted = []
            for t, p, o in frames:
                odom = self._gate(o, track_id)
                if odom is not None:
                    accepted.append((t, p, odom))
            chunk_size = max(int(chunk_size), 1)
            # Chunks are payload-homogeneous (one uint16 [C,B,A] or one
            # f32 [C,N,3] upload), so a mixed stream is split into
            # same-kind runs.
            runs = []
            for frame in accepted:
                kind = self._is_packed_scan(frame[1])
                if runs and runs[-1][0] == kind:
                    runs[-1][1].append(frame)
                else:
                    runs.append((kind, [frame]))
            for _, run in runs:
                n_chunks = len(run) // chunk_size if chunk_size > 1 else 0
                for ci in range(n_chunks):
                    self._dispatch_chunk(
                        run[ci * chunk_size:(ci + 1) * chunk_size],
                        track_id)
                for t, p, o in run[n_chunks * chunk_size:]:
                    self._integrate_one(t, p, o, track_id)
            return len(accepted)

    def _pad_xyz(self, points) -> Tuple[np.ndarray, int]:
        pts = np.asarray(points, np.float32)
        n = min(len(pts), self.scan_cap)
        padded = np.full((self.scan_cap, 3), pc.SENTINEL, np.float32)
        padded[:n] = pts[:n]
        return padded, n

    def _may_be_offchain(self, key_a: int, key_b: int) -> bool:
        """Whether a factor between two keys may land off the solver's
        block-tridiagonal chain: keys not consecutive, or a key a prior
        may freeze."""
        return (key_b != key_a + 1 or key_a in self._prior_keys
                or key_b in self._prior_keys)

    def _begin(self, n_scans: int, track_id: int):
        """Capacity and counters for ``n_scans`` new scans of a track.
        Returns whether the first of them is the track's first, and the
        off-chain bound at each of them."""
        first = track_id not in self._tracks_seen
        self._tracks_seen.add(track_id)
        new_rels = 2 * n_scans - (2 if first else 0)
        self._ensure_capacity(new_poses=n_scans, new_rels=new_rels,
                              new_priors=1 if first else 0)
        self._n_rel_host += new_rels
        bounds = []
        prev = self._last_key.get(track_id)
        for key in range(len(self.key_info), len(self.key_info) + n_scans):
            if prev is None:
                self._prior_keys.add(key)
            elif self._may_be_offchain(prev, key):
                self._n_offchain_host += 2
            bounds.append(self._n_offchain_host)
            prev = key
        self._last_key[track_id] = prev
        return first, bounds

    def _register_track(self, track_id: int) -> None:
        """A track's first scan is in: prior slots are allocated in
        first-scan order (registerPrior, incremental_estimator.cpp:
        268-291) and the track starts a group of its own."""
        if track_id > 0:
            self._prior_slot_of_track[track_id] = self._n_priors_seen
        self._n_priors_seen += 1
        self._linked_groups.append([track_id])

    def _dispatch_chunk(self, chunk, track_id: int) -> None:
        """One online_chunk call over pre-gated frames."""
        C = len(chunk)
        first, bounds = self._begin(C, track_id)
        odos = torch.from_numpy(np.stack([o for _, _, o in chunk]).astype(
            np.float32)).to(self.device)
        if self._is_packed_scan(chunk[0][1]):
            words = spherical.words_to_device(
                np.stack([p for _, p, _ in chunk]), self.device)
            pts, nv = decode_ranges_chunk(words, self._beam_table,
                                          self._range_unit_m)
        else:
            padded = [self._pad_xyz(p) for _, p, _ in chunk]
            pts = torch.from_numpy(np.stack([a for a, _ in padded])).to(
                self.device)
            nv = torch.tensor([n for _, n in padded], dtype=torch.int32,
                              device=self.device)
        pr_kw = {}
        if self.detector is not None:
            # The detector cadence runs inside the chunk (adds, and every
            # detect_every-th key's query); its rows come back as one
            # [C,3] device tensor, read at the flush.
            self.detector.ensure_room(C)
            pr_kw = dict(pr_db=self.detector.db,
                         pr_keys=self.detector.db_keys, pr_n=self.detector.n,
                         pr_config=self.detector.config)
        out = list(online_chunk(
            self.state, self.archive, pts, nv, odos, [track_id] * C,
            self.config, odometry_free=not self.use_odometry,
            with_archive=self.archive is not None,
            return_scans=self.mapper is not None, first_scan=first,
            generator=self.generator, offchain=bounds, **pr_kw))
        if self.detector is not None:
            _, _, self.detector.n, pr_rows = out.pop()
        self.state, self.archive = out[0], out[1]
        if self.mapper is not None:
            self.mapper.accumulate_chunk(*out[3], track_id=track_id)
        base_key = len(self.key_info)
        self.key_info.extend((track_id, t) for t, _, _ in chunk)
        if self.detector is not None:
            self._pr_pending.append((list(range(base_key, base_key + C)),
                                     pr_rows))
            de = max(self.detector.config.detect_every, 1)
            n_queries = sum(1 for ks, _ in self._pr_pending for k in ks
                            if k % de == 0)
            if n_queries >= max(self.detector.config.fetch_every, 1):
                self.flush_detections()
        # After the flush, as the JAX runner does.
        if first:
            self._register_track(track_id)

    def _integrate_one(self, time_ns: int, points: np.ndarray,
                       odom_pose7: np.ndarray, track_id: int = 0) -> bool:
        """Single online_step for an already-gated frame, then the
        archive append, the map and the detector stage."""
        first, (bound,) = self._begin(1, track_id)
        odom = torch.tensor(odom_pose7, device=self.device)
        if self._is_packed_scan(points):
            self.state, info = online_step_ranges(
                self.state, spherical.words_to_device(points, self.device),
                self._beam_table, odom, self.config, first_scan=first,
                track_id=track_id, generator=self.generator,
                odometry_free=not self.use_odometry,
                range_unit_m=self._range_unit_m, offchain=bound)
        else:
            padded, n = self._pad_xyz(points)
            self.state, info = online_step(
                self.state, torch.from_numpy(padded).to(self.device), n,
                odom, self.config, first_scan=first, track_id=track_id,
                generator=self.generator,
                odometry_free=not self.use_odometry, offchain=bound)
        if self.archive is not None:
            self.archive = archive_append(
                self.archive, self.state.ring_points[track_id, -1],
                self.state.ring_mask[track_id, -1],
                self.state.ring_normals[track_id, -1], info.key, track_id)
        if self.mapper is not None:
            self.mapper.accumulate(self.state, track_id)
        self.key_info.append((track_id, time_ns))
        if first:
            self._register_track(track_id)
        if self.detector is not None:
            self._pr_scan(track_id, len(self.key_info) - 1)
        return True

    def _pr_scan(self, track_id: int, key: int) -> None:
        """Feed the newest filtered scan (sensor frame, on the device in
        the submap ring) to the detector.  A query runs on the
        ``detect_every`` cadence outside the cooldown; its row stays on
        the device, and ``fetch_every`` rows are read in one transfer."""
        pts = self.state.ring_points[track_id, -1]
        msk = self.state.ring_mask[track_id, -1]
        pr_cfg = self.detector.config
        cooldown = (self.detections and key - self.detections[-1][1]
                    < pr_cfg.min_keys_between_detections)
        if (key % max(pr_cfg.detect_every, 1) != 0 or self.detector.n == 0
                or cooldown):
            self.detector.add(pts, msk, key)
            return
        res = self.detector.query_async(pts, msk, key, add=True)
        self._pr_pending.append(([key], res[None]))
        if len(self._pr_pending) >= max(pr_cfg.fetch_every, 1):
            self.flush_detections()

    def flush_detections(self) -> None:
        """Read every pending query row in ONE device-to-host transfer and
        inject the closures that pass the threshold, the cooldown and the
        verification gates.  Runs by itself every ``fetch_every`` queries;
        call it to drain before reading final results.  Timed as
        ``online.flush_detections``."""
        if not self._pr_pending:
            return
        with bench.scoped_timer('online.flush_detections'):
            pending, self._pr_pending = self._pr_pending, []
            keys = [k for ks, _ in pending for k in ks]
            rows = torch.cat([r for _, r in pending]).cpu().numpy()
            pr_cfg = self.detector.config
            for key, row in zip(keys, rows):
                det = self.detector.to_detection(row)
                if det is None:
                    continue
                if (self.detections and key - self.detections[-1][1]
                        < pr_cfg.min_keys_between_detections):
                    continue
                self._inject_detection(det, key)


    def _inject_detection(self, det, key: int) -> None:
        """Gate one detection and add it as a loop closure.  Reads the two
        keys' poses (one transfer) and, to verify, four floats."""
        pr_cfg = self.detector.config
        pair = self.state.traj_poses[[det.key, key]].cpu()
        # Odometry-consistency gate: a same-track candidate asserts
        # co-location, so the implied correction (the keys' estimated
        # separation) must be explainable by odometry drift.  It catches
        # perfect aliasing, which registers with zero ICP residual.
        k_sig = pr_cfg.odom_consistency_sigmas
        if k_sig > 0 and self.key_info[det.key][0] == self.key_info[key][0]:
            sigma_t = max(self.config.laser_track.odometry_noise_model[3:6])
            allowed = k_sig * sigma_t * float(np.sqrt(abs(key - det.key)))
            sep_m = float(np.linalg.norm(pair[0, 4:].numpy()
                                         - pair[1, 4:].numpy()))
            if sep_m > allowed:
                self.rejected_detections.append(
                    (det.key, key, det.distance, -1.0, sep_m))
                return
        # a_T_a_b ~= Rz(yaw) (same place, another heading), so w_T_a_b =
        # T_w_a Rz(yaw) T_w_b^-1 (incremental_estimator.cpp:83-87).
        half = 0.5 * det.yaw_rad
        rz = torch.tensor([np.cos(half), 0.0, 0.0, np.sin(half), 0.0, 0.0,
                           0.0], dtype=torch.float32)
        w_T_a_b = se3.compose(pair[0], se3.compose(rz, se3.inverse(pair[1])))
        if pr_cfg.verify_with_icp and self.archive is not None:
            # Only the detector's check is timed, as in the JAX runner.
            with bench.scoped_timer('online.verify_closure'):
                passed = self._verify(det.key, key, w_T_a_b,
                                      pr_cfg.min_inlier_fraction,
                                      pr_cfg.max_mean_residual_m,
                                      det.distance)
            if not passed:
                return
        self.detections.append((det.key, key, det.distance, det.yaw_rad))
        self.add_loop_closure(det.key, key, w_T_a_b.numpy())

    def _verify(self, key_a: int, key_b: int, w_T_a_b, min_inlier_fraction,
                max_mean_residual_m, distance) -> bool:
        """Score a candidate with :func:`verify_closure` (one read of its
        four floats); record it in ``rejected_detections`` and return
        False when it fails."""
        ok, mean_err, frac, _ = verify_closure(
            self.state, self.archive, key_a, key_b,
            torch.tensor(np.asarray(w_T_a_b, np.float32),
                         device=self.device),
            self.config).cpu().numpy()
        if (ok > 0.5 and frac >= min_inlier_fraction
                and mean_err <= max_mean_residual_m):
            return True
        self.rejected_detections.append(
            (key_a, key_b, distance, float(frac), float(mean_err)))
        return False

    def marginal_covariances(self, keys, exact: bool = False) -> np.ndarray:
        """Per-key 6x6 marginal covariances of the current graph (the
        reference's Marginals query, laser_track.cpp:421-429): ``keys``,
        a sequence of global pose keys -> [K,6,6] numpy, one read.

        The f32 probes (:func:`solver.marginal_covariance`, one batched
        PCG on the runner's device, ``config.solver``'s budget) serve
        well-observed modes; ``exact`` takes the float64 dense
        factorization on the same device
        (:func:`solver.marginal_covariance_exact`), which weakly anchored
        modes need.  On interleaved multi-robot keys no factor lies on the
        chain the preconditioner factors, and the probes need thousands
        of PCG iterations.  Where the JAX runner holds a live Woodbury
        cache it takes ``marginal_covariance_cached``; the port always
        takes the one-shot probes (ROADMAP queue 3)."""
        graph, traj = _graph_view(self.state), self.state.traj_poses
        pose_mask = _pose_mask(self.state)
        if exact:
            return sv.marginal_covariance_exact(
                graph, traj, pose_mask, np.asarray(keys, np.int64),
                self.config.solver, n_used=len(self.key_info))
        keys = torch.as_tensor(np.asarray(keys, np.int64), device=self.device)
        return sv.marginal_covariance(
            graph, traj, pose_mask, keys, self.config.solver,
            offchain=self._n_offchain_host).cpu().numpy()

    def refine(self, iterations: int = 1,
               gn_iterations: Optional[int] = None,
               pcg_iterations: Optional[int] = None,
               pcg_tolerance: Optional[float] = None) -> float:
        """Extra full-graph solve passes (:func:`online_solve`), with
        optional stronger solver settings than the per-scan config (after
        a cross-track link, e.g. ``refine(2, gn_iterations=6,
        pcg_iterations=128, pcg_tolerance=1e-8)``).  Returns the last
        solve's error (one read at the end)."""
        cfg = self.config
        s = cfg.solver
        s = dataclasses.replace(
            s,
            gn_iterations=(s.gn_iterations if gn_iterations is None
                           else gn_iterations),
            pcg_iterations=(s.pcg_iterations if pcg_iterations is None
                            else pcg_iterations),
            pcg_tolerance=(s.pcg_tolerance if pcg_tolerance is None
                           else pcg_tolerance))
        cfg = dataclasses.replace(cfg, solver=s)
        err = None
        for _ in range(max(iterations, 1)):
            self.state, err = online_solve(self.state, cfg,
                                           self._n_offchain_host)
        return float(err)

    def add_loop_closure(self, key_a: int, key_b: int,
                         w_T_a_b: np.ndarray,
                         verify_with_icp: bool = False,
                         min_inlier_fraction: float = 0.3,
                         max_mean_residual_m: float = 0.3) -> bool:
        """Inject a loop closure between two global keys and solve the
        full graph.  A cross-track closure that links two groups of
        tracks keeps the group holding track 0, removes the absorbed
        group's prior, uses the first-association noise model and
        rigidly pre-aligns the absorbed group (estimateAndRemove,
        incremental_estimator.cpp:165-266).  With a scan archive and
        ``do_icp_step_on_loop_closures`` the alignment is first refined by
        submap ICP (incremental_estimator.cpp:90-115); with
        ``preconditioner='woodbury'`` the solve extends the persisted
        cache instead of building its preconditioner cold.  The solve is
        timed as ``online.lc_solve_dispatch``.  An attached mapper
        re-rigidifies each track's map by that track's own correction.

        ``verify_with_icp`` (needs the archive): score the closure with
        :func:`verify_closure` against the given thresholds first, and
        drop it (recorded in ``rejected_detections``, returns False) when
        the submaps do not align.  Returns True when injected."""
        key_a, key_b = int(key_a), int(key_b)
        if verify_with_icp:
            if self.archive is None:
                raise ValueError('verify_with_icp needs a scan archive '
                                 '(archive_points > 0)')
            if not self._verify(key_a, key_b, w_T_a_b, min_inlier_fraction,
                                max_mean_residual_m, float('nan')):
                return False
        self._ensure_capacity(new_rels=1)
        self._n_rel_host += 1
        if self._may_be_offchain(key_a, key_b):
            self._n_offchain_host += 1
        remove_slot, use_assoc, align_mask = -1, False, None
        track_a, track_b = self.key_info[key_a][0], self.key_info[key_b][0]
        if track_a != track_b:
            ga, gb = self._find_group(track_a), self._find_group(track_b)
            if ga is not gb:
                keep, drop = (ga, gb) if 0 in ga else (gb, ga)
                for tid in drop:
                    if tid in self._prior_slot_of_track:
                        remove_slot = self._prior_slot_of_track.pop(tid)
                        use_assoc = True
                # The absorbed group's poses, uploaded once.
                dropped = set(drop)
                m = np.zeros((self.state.traj_poses.shape[0],), bool)
                m[[k for k, (t, _) in enumerate(self.key_info)
                   if t in dropped]] = True
                align_mask = torch.from_numpy(m).to(self.device)
                keep.extend(drop)
                self._linked_groups.remove(drop)
        old_lasts = None
        if self.mapper is not None:
            # Last pose of EVERY track: the solve moves all linked tracks,
            # and each map follows its own track's correction (per-worker
            # updateLocalMap, laser_slam_worker.cpp:522-540).
            old_lasts = self.state.traj_poses[
                torch.clamp(self.state.track_last_key, min=0).long()]
        w_T = torch.tensor(np.asarray(w_T_a_b, np.float32),
                           device=self.device)
        cache = self._lc_solver_cache()
        with bench.scoped_timer('online.lc_solve_dispatch'):
            self.state, self._solver_cache = self._closure(
                self.state, cache, key_a, key_b, w_T, remove_slot,
                use_assoc, align_mask, self._n_offchain_host)
        if self.mapper is not None:
            new_lasts = self.state.traj_poses[
                torch.clamp(self.state.track_last_key, min=0).long()]
            # Tracks without scans have no map; the host knows which.
            for tid in sorted(self._tracks_seen):
                self.mapper.rigidify(se3.compose(
                    new_lasts[tid], se3.inverse(old_lasts[tid])), tid)
        return True

    def _closure(self, state: OnlineState, cache, key_a: int, key_b: int,
                 w_T: torch.Tensor, remove_prior_slot: int = -1,
                 use_association: bool = False, align_mask=None,
                 offchain: Optional[int] = None):
        """The closure program this runner's config calls for: refined
        (archive + ``do_icp_step_on_loop_closures``) or not, cached
        (a Woodbury cache) or cold.  Returns (state, cache)."""
        refined = (self.archive is not None
                   and self.config.do_icp_step_on_loop_closures)
        kw = dict(remove_prior_slot=remove_prior_slot,
                  use_association=use_association, align_mask=align_mask,
                  offchain=offchain)
        if cache is not None and refined:
            state, cache, _ = online_loop_closure_refined_cached(
                state, self.archive, cache, key_a, key_b, w_T, self.config,
                **kw)
        elif cache is not None:
            state, cache, _ = online_loop_closure_cached(
                state, cache, key_a, key_b, w_T, self.config, **kw)
        elif refined:
            state, _ = online_loop_closure_refined(
                state, self.archive, key_a, key_b, w_T, self.config, **kw)
        else:
            state, _ = online_loop_closure(state, key_a, key_b, w_T,
                                           self.config, **kw)
        return state, cache

    def warmup_closure_path(self, use_association: bool = False) -> None:
        """Run the closure programs once, so the first real closure of a
        stream does not pay the first-call costs (library handles, kernel
        loads, allocator growth): the verification (when a detector with
        ``verify_with_icp`` is attached) and the refined / cached / plain
        closure solve :meth:`add_loop_closure` will call, on keys 0 and
        1; ``use_association`` warms the linking variant (first-
        association sigmas and a group alignment, here of no pose).  It
        builds the solver cache when ``preconditioner='woodbury'`` and
        keeps it, as the first closure would.  The closure programs write
        the state and the cache in place, so they run on clones that are
        then dropped; the archive is only read.  The runner's state is
        untouched.  Needs >= 2 keys."""
        if len(self.key_info) < 2:
            raise ValueError('warmup_closure_path needs >= 2 keys '
                             '(process some scans first)')
        ident = se3.identity(device=self.device)
        if (self.archive is not None and self.detector is not None
                and self.detector.config.verify_with_icp):
            verify_closure(self.state, self.archive, 0, 1, ident,
                           self.config)
        amask = (torch.zeros((self.state.traj_poses.shape[0],),
                             dtype=torch.bool, device=self.device)
                 if use_association else None)
        cache = self._lc_solver_cache()
        self._closure(clone_state(self.state),
                      None if cache is None else sv.clone_cache(cache),
                      0, 1, ident, use_association=use_association,
                      align_mask=amask, offchain=self._n_offchain_host + 1)

    def _lc_solver_cache(self):
        """The persisted WoodburyCache for closure solves, or None when
        the preconditioner is not 'woodbury' (the cold solve builds its
        own).  Built on first use and rebuilt once more than
        ``cache_rebuild_after`` factors were appended since the last build
        (appended chain factors ride identity rows of the cached chain
        factorization: stale, but PCG still converges).  Timed as
        ``online.lc_cache_build``."""
        s = self.config.solver
        if s.preconditioner != 'woodbury':
            return None
        if (self._solver_cache is None
                or self._n_rel_host - self._cache_rel_count
                > max(s.cache_rebuild_after, 0)):
            with bench.scoped_timer('online.lc_cache_build'):
                self._solver_cache = sv.build_cache(
                    _graph_view(self.state), self.state.traj_poses,
                    _pose_mask(self.state), s)
            self._cache_rel_count = self._n_rel_host
        return self._solver_cache

    def _find_group(self, track_id: int) -> list:
        for g in self._linked_groups:
            if track_id in g:
                return g
        g = [track_id]
        self._linked_groups.append(g)
        return g

    def trajectory(self, track_id: Optional[int] = None) -> dict:
        """{time_ns: pose7}, after applying any pending detections; pass
        ``track_id`` to select one track."""
        if self.detector is not None:
            self.flush_detections()
        poses = extract_trajectory(self.state)
        return {t: poses[i] for i, (tid, t) in enumerate(self.key_info)
                if track_id is None or tid == track_id}
