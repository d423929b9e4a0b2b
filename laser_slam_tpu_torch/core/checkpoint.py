"""Checkpoint and resume of the whole SLAM state.

Counterpart of ``laser_slam_tpu/core/checkpoint.py``, in its file format:
one ``.npz`` under the same keys, so a file either package writes loads
in the other's loader.

* :func:`save_checkpoint` / :func:`load_checkpoint`: the host API's
  estimator (graph factors, pose table, trajectories, measurement logs,
  scans with normals, scan rings, multi-robot link bookkeeping) and its
  workers (map state).
* :func:`save_online_checkpoint` / :func:`load_online_checkpoint`: an
  ``OnlineRunner`` (its device state, host bookkeeping, scan archive,
  place-recognition database and per-track device maps).

Randomness.  The port draws from ``torch.Generator`` objects where JAX
draws from keys, so it stores each generator's ``get_state()`` under
keys of its own (``t{i}_generator_state``, ``generator_state``) that the
JAX loaders never read; a resume on the same kind of device is then
bit-identical on the CPU, sampling ratios below 1 included.  The JAX
online loader reads ``s_rng_key`` unconditionally, so a port file
carries one too: the uint32 key data of ``jax.random.key(seed)`` for the
runner's seed.  A file without the port's generator state (JAX's), or
with one from another kind of device, resumes with a generator seeded
anew: a track's from ``1234 + track_id``, a runner's from the last word
of ``s_rng_key``.

What the JAX files have no field for is rebuilt at load from the file:
the runner's off-chain count from its factor keys, the device maps' host
cursor bounds from their cursors.  The closure solver's Woodbury cache is
left empty and rebuilt at the next closure, as JAX's loader leaves it.
Older online files of the same format version load as in JAX's loader:
an archive without its per-track index gets it rebuilt from its track
column, and single-map ``ml_``/``md_`` keys become track 0's maps.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from laser_slam_tpu_torch.config import Config
from laser_slam_tpu_torch.core.estimator import IncrementalEstimator
from laser_slam_tpu_torch.core.types import LaserScan, RelativePose
from laser_slam_tpu_torch.ops import cloud as pc
from laser_slam_tpu_torch.pipeline import device_map, online
from laser_slam_tpu_torch.pipeline.worker import LaserSlamWorker

_FORMAT_VERSION = 2
_ONLINE_FORMAT_VERSION = 1


def _relposes_to_arrays(rels: Sequence[RelativePose]):
    """Split pose (float32 [N,7]) from times/keys (int64 [N,6]).

    Times are epoch nanoseconds and exceed float64's 2**53 integer range;
    a float array would round them and break the exact time-key lookups
    (trajectory.key_at, _pose_measurement_at) on resume.
    """
    poses = np.zeros((len(rels), 7), np.float32)
    meta = np.zeros((len(rels), 6), np.int64)
    for i, r in enumerate(rels):
        poses[i] = r.T_a_b
        meta[i] = (r.time_a_ns, r.time_b_ns, r.key_a, r.key_b,
                   r.track_id_a, r.track_id_b)
    return poses, meta


def _relposes_from_arrays(poses: np.ndarray,
                          meta: np.ndarray) -> List[RelativePose]:
    return [RelativePose(T_a_b=p.astype(np.float32),
                         time_a_ns=int(m[0]), time_b_ns=int(m[1]),
                         key_a=int(m[2]), key_b=int(m[3]),
                         track_id_a=int(m[4]), track_id_b=int(m[5]))
            for p, m in zip(poses, meta)]


def _jax_key_data(seed: int) -> np.ndarray:
    """The uint32 key data of ``jax.random.key(seed)`` (threefry: the
    seed's high and low 32-bit words)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def _get(z, key: str):
    """An array of the file, or None when it has none under ``key``."""
    return z[key] if key in z else None


def _restore_generator(generator: torch.Generator, saved) -> None:
    """Set a generator to a saved ``get_state()``; left as it is when
    there is none or it is from another kind of device."""
    if saved is None:
        return
    state = torch.from_numpy(np.asarray(saved, np.uint8).copy())
    if state.numel() == generator.get_state().numel():
        generator.set_state(state)


# ---------------------------------------------------------------------------
# The online runner
# ---------------------------------------------------------------------------

def save_online_checkpoint(path: str, runner) -> None:
    """Checkpoint an ``OnlineRunner`` (pipeline.online): its device state
    (one host transfer a field), its host bookkeeping, the scan archive,
    the per-track device maps and the detector's database.  Pending
    detection queries are flushed first, as the JAX package does, so no
    closure is lost on resume."""
    if runner.detector is not None:
        runner.flush_detections()
    data = {'online_format_version': _ONLINE_FORMAT_VERSION,
            'n_tracks': runner.n_tracks,
            'min_dist': np.float64(runner.min_dist),
            'scan_cap': np.int64(runner.scan_cap),
            'n_rel_host': np.int64(runner._n_rel_host),
            'n_priors_seen': np.int64(runner._n_priors_seen),
            'tracks_seen': np.asarray(sorted(runner._tracks_seen), np.int64),
            'key_info': np.asarray(runner.key_info, np.int64).reshape(-1, 2),
            'linked_flat': np.asarray(
                [t for g in runner._linked_groups for t in g], np.int64),
            'linked_sizes': np.asarray(
                [len(g) for g in runner._linked_groups], np.int64),
            'prior_slot_keys': np.asarray(
                list(runner._prior_slot_of_track.keys()), np.int64),
            'prior_slot_vals': np.asarray(
                list(runner._prior_slot_of_track.values()), np.int64),
            'last_odom_valid': np.asarray(
                [o is not None for o in runner._last_odom]),
            'last_odom': np.stack(
                [o if o is not None else np.zeros(7, np.float32)
                 for o in runner._last_odom]),
            'use_odometry': np.bool_(runner.use_odometry),
            's_rng_key': _jax_key_data(runner.seed),
            'generator_state': runner.generator.get_state().numpy()}
    for name, leaf in online.state_to_numpy(runner.state).items():
        data['s_' + name] = leaf
    if runner.archive is not None:
        for name, leaf in online.archive_to_numpy(runner.archive).items():
            data['a_' + name] = leaf
    if runner.mapper is not None:
        data['mapper_n_tracks'] = np.int64(runner.mapper.n_tracks)
        for t in range(runner.mapper.n_tracks):
            for pre, m in ((f'ml{t}_', runner.mapper.local_maps[t]),
                           (f'md{t}_', runner.mapper.distant_maps[t])):
                for name, leaf in m._asdict().items():
                    data[pre + name] = leaf.cpu().numpy()
    if runner.detector is not None:
        data['pr_db'] = runner.detector.db.cpu().numpy()
        data['pr_keys'] = runner.detector.db_keys.cpu().numpy()
        data['pr_n'] = np.int64(runner.detector.n)
    data['detections'] = np.asarray(runner.detections,
                                    np.float64).reshape(-1, 4)
    np.savez_compressed(path, **data)


def _offchain_count(rel_keys: np.ndarray, n_rel: int,
                    prior_keys: np.ndarray, n_prior: int) -> int:
    """The runner's off-chain count (OnlineRunner._may_be_offchain over
    every appended factor): key_b != key_a + 1, or a key that took a
    prior."""
    keys = rel_keys[:n_rel]
    priors = prior_keys[:n_prior]
    off = ((keys[:, 1] != keys[:, 0] + 1) | np.isin(keys[:, 0], priors)
           | np.isin(keys[:, 1], priors))
    return int(np.count_nonzero(off))


def _track_index(track: np.ndarray, n_tracks: int) -> dict:
    """The archive's per-track index (``track_pos``, ``track_keys``,
    ``track_count``) rebuilt from its track column, for files written
    before the archive kept it: keys were appended in ascending global
    order (laser_slam_tpu/core/checkpoint.py:144-160)."""
    A = len(track)
    tpos = np.zeros((A,), np.int32)
    tkeys = np.full((n_tracks, A), -1, np.int32)
    counts = np.zeros((n_tracks,), np.int32)
    for k, t in enumerate(int(t) for t in track):
        if t < 0:
            continue
        tpos[k] = counts[t]
        tkeys[t, counts[t]] = k
        counts[t] += 1
    return dict(track_pos=tpos, track_keys=tkeys, track_count=counts)


def load_online_checkpoint(path: str, config, map_config=None,
                           place_recognition=None, device='cuda'):
    """Rebuild an ``OnlineRunner`` from a file of
    :func:`save_online_checkpoint` or of the JAX package's.

    ``config`` is the run's ``EstimatorConfig`` (capacities come from the
    file's arrays, so a grown state restores at its grown size).  Pass
    the run's ``map_config`` (WorkerConfig) to restore the device maps
    and its ``place_recognition`` (PlaceRecognitionConfig) to restore the
    scan-context database; the file's state without them raises.
    ``device`` is the card unless the caller names another."""
    with np.load(path, allow_pickle=False) as z:
        return _runner_from(z, config, map_config, place_recognition, device)


def _runner_from(z, config, map_config, place_recognition, device):
    version = int(z['online_format_version'])
    if version != _ONLINE_FORMAT_VERSION:
        raise ValueError(
            f'unsupported online checkpoint format version {version} '
            f'(this build reads version {_ONLINE_FORMAT_VERSION})')
    has_maps = 'ml0_points' in z or 'ml_points' in z
    if has_maps and map_config is None:
        raise ValueError(
            'checkpoint contains device-map state but map_config is None; '
            'pass the run\'s WorkerConfig to restore the map (resuming '
            'without it would silently continue with an empty map)')
    if 'pr_db' in z and place_recognition is None:
        raise ValueError(
            'checkpoint contains a place-recognition database but '
            'place_recognition is None; pass the run\'s '
            'PlaceRecognitionConfig (resuming without it would silently '
            'stop detecting loop closures)')
    seed = int(np.asarray(z['s_rng_key']).reshape(-1)[-1])
    n_tracks = int(z['n_tracks'])
    # Minimal capacities: the file's arrays replace every buffer.
    runner = online.OnlineRunner(
        config, pose_capacity=1, factor_capacity=1,
        minimum_distance_to_add_pose=float(z['min_dist']), seed=seed,
        use_odometry_information=bool(z['use_odometry'])
        if 'use_odometry' in z else True,
        archive_points=z['a_points'].shape[1] if 'a_points' in z else 0,
        place_recognition=place_recognition if 'pr_db' in z else None,
        n_tracks=n_tracks, map_config=map_config if has_maps else None,
        device=device)
    dev = runner.device
    _restore_generator(runner.generator, _get(z, 'generator_state'))
    runner.state = online.state_from_numpy(
        {name: z['s_' + name] for name in online.OnlineState._fields}, dev)
    if 'a_points' in z:
        leaves = {name: z['a_' + name] for name in online.ScanArchive._fields
                  if 'a_' + name in z}
        if 'track_pos' not in leaves:
            leaves.update(_track_index(z['a_track'], n_tracks))
        runner.archive = online.archive_from_numpy(leaves, dev)
    if has_maps:
        for t in range(int(z['mapper_n_tracks'])
                       if 'mapper_n_tracks' in z else 1):
            # 'ml_'/'md_' (no index) is the single-map format; it maps
            # onto track 0 (laser_slam_tpu/core/checkpoint.py:178-181).
            lp = f'ml{t}_' if f'ml{t}_points' in z else 'ml_'
            dp = f'md{t}_' if f'md{t}_points' in z else 'md_'
            for pre, maps in ((lp, runner.mapper.local_maps),
                              (dp, runner.mapper.distant_maps)):
                maps[t] = device_map.MapState(**{
                    name: torch.as_tensor(np.array(z[pre + name]),
                                          device=dev)
                    for name in device_map.MapState._fields})
            runner.mapper._cursor_bound[t] = int(z[lp + 'cursor'])
    if 'pr_db' in z:
        runner.detector.db = torch.as_tensor(np.array(z['pr_db']),
                                             device=dev)
        runner.detector.db_keys = torch.as_tensor(np.array(z['pr_keys']),
                                                  device=dev)
        runner.detector.n = int(z['pr_n'])
    runner.detections = [(int(r[0]), int(r[1]), float(r[2]), float(r[3]))
                         for r in z['detections']]
    runner.scan_cap = int(z['scan_cap'])
    runner._n_rel_host = int(z['n_rel_host'])
    runner._n_priors_seen = int(z['n_priors_seen'])
    runner._tracks_seen = {int(t) for t in z['tracks_seen']}
    runner.key_info = [(int(a), int(b)) for a, b in z['key_info']]
    groups, off = [], 0
    for size in z['linked_sizes']:
        groups.append([int(t) for t in z['linked_flat'][off:off + size]])
        off += int(size)
    runner._linked_groups = groups
    runner._prior_slot_of_track = {
        int(k): int(v) for k, v in zip(z['prior_slot_keys'],
                                       z['prior_slot_vals'])}
    runner._last_odom = [
        np.asarray(o, np.float32) if ok else None
        for o, ok in zip(z['last_odom'], z['last_odom_valid'])]
    # Host bookkeeping the JAX runner has no field for, from the file's
    # arrays (numpy already: no device read).
    n_prior = int(z['s_n_prior'])
    runner._prior_keys = {int(k) for k in z['s_prior_keys'][:n_prior]}
    runner._last_key = {t: k for k, (t, _) in enumerate(runner.key_info)}
    runner._n_offchain_host = _offchain_count(
        z['s_rel_keys'], int(z['s_n_rel']), z['s_prior_keys'], n_prior)
    return runner


# ---------------------------------------------------------------------------
# The host API's estimator and workers
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, estimator: IncrementalEstimator,
                    workers: Optional[Sequence] = None,
                    include_scans: bool = True) -> None:
    data = {'format_version': _FORMAT_VERSION,
            'n_workers': estimator.n_workers,
            'n_keys': estimator._n_keys,
            'poses': estimator._poses[:estimator._n_keys],
            'linked_workers_flat': np.asarray(
                [w for g in estimator._linked_workers for w in g], np.int64),
            'linked_workers_sizes': np.asarray(
                [len(g) for g in estimator._linked_workers], np.int64),
            'prior_factor_keys': np.asarray(
                list(estimator._prior_factor_of_worker.keys()), np.int64),
            'prior_factor_vals': np.asarray(
                list(estimator._prior_factor_of_worker.values()), np.int64)}

    g = estimator.graph
    data.update(
        g_n_rel=g.n_rel, g_n_prior=g.n_prior,
        g_rel_meas=g.rel_meas[:g.n_rel], g_rel_keys=g.rel_keys[:g.n_rel],
        g_rel_sqrt_info=g.rel_sqrt_info[:g.n_rel],
        g_rel_robust=g.rel_robust[:g.n_rel],
        g_rel_fixed_a=g.rel_fixed_a[:g.n_rel],
        g_rel_weight=g.rel_weight[:g.n_rel],
        g_prior_meas=g.prior_meas[:g.n_prior],
        g_prior_keys=g.prior_keys[:g.n_prior],
        g_prior_sqrt_info=g.prior_sqrt_info[:g.n_prior],
        g_prior_weight=g.prior_weight[:g.n_prior])

    for i, track in enumerate(estimator.laser_tracks):
        p = f't{i}_'
        traj = track.trajectory
        data[p + 'traj_times'] = traj._times[:traj.size]
        data[p + 'traj_poses'] = traj._poses[:traj.size]
        data[p + 'traj_keys'] = traj._keys[:traj.size]
        data[p + 'pose_meas_times'] = np.asarray(
            track.pose_measurement_times, np.int64)
        data[p + 'pose_meas'] = (np.stack(track.pose_measurements)
                                 if track.pose_measurements
                                 else np.zeros((0, 7), np.float32))
        for name, rels in (('odom', track.odometry_measurements),
                           ('icp', track.icp_transformations),
                           ('lc', track.loop_closures)):
            rp, rm = _relposes_to_arrays(rels)
            data[p + name] = rp
            data[p + name + '_meta'] = rm
        data[p + 'ring_times'] = track._ring_times
        data[p + 'generator_state'] = track.generator.get_state().numpy()
        if include_scans:
            data[p + 'scan_times'] = np.asarray(
                [s.time_ns for s in track.scans], np.int64)
            data[p + 'scan_keys'] = np.asarray(
                [s.key for s in track.scans], np.int64)
            if track.scans:
                for name, rows in (
                        ('scan_points', [s.cloud.points for s in track.scans]),
                        ('scan_masks', [s.cloud.mask for s in track.scans]),
                        ('scan_normals', [s.normals for s in track.scans])):
                    data[p + name] = torch.stack(rows).cpu().numpy()

    if workers:
        for i, w in enumerate(workers):
            p = f'w{i}_'
            data[p + 'world_to_odom'] = w.world_to_odom
            data[p + 'base_time'] = np.int64(
                w._base_time_ns if w._base_time_ns is not None else -1)
            data[p + 'last_pose'] = (w._last_pose if w._last_pose is not None
                                     else np.full(7, np.nan, np.float32))
            data[p + 'map_points'] = w._map_points[:w._map_count]
            data[p + 'distant_points'] = w._distant_points

    np.savez_compressed(path, **data)


def load_checkpoint(path: str, config: Config, workers_cls=None,
                    device='cuda'):
    """Rebuild (estimator, workers) from a file of :func:`save_checkpoint`
    or of the JAX package's, on ``device`` (the card unless the caller
    names another).

    ``workers_cls`` defaults to pipeline.worker.LaserSlamWorker; workers
    is None when the file holds none.
    """
    with np.load(path, allow_pickle=False) as z:
        return _estimator_from(z, config, workers_cls, device)


def _estimator_from(z, config: Config, workers_cls, device):
    version = int(z['format_version'])
    if version != _FORMAT_VERSION:
        raise ValueError(
            f'unsupported checkpoint format version {version} '
            f'(this build reads version {_FORMAT_VERSION})')
    n_workers = int(z['n_workers'])
    est = IncrementalEstimator(config.estimator, n_workers, device=device)
    dev = est.device

    n_keys = int(z['n_keys'])
    while est._pose_capacity < n_keys:
        est._pose_capacity *= 2
    est._poses = np.zeros((est._pose_capacity, 7), np.float32)
    est._poses[:, 0] = 1.0
    est._poses[:n_keys] = z['poses']
    est._n_keys = n_keys

    groups, off = [], 0
    for size in z['linked_workers_sizes']:
        groups.append([int(x) for x in
                       z['linked_workers_flat'][off:off + size]])
        off += int(size)
    est._linked_workers = groups
    est._prior_factor_of_worker = {
        int(k): int(v) for k, v in zip(z['prior_factor_keys'],
                                       z['prior_factor_vals'])}

    g = est.graph
    n_rel, n_prior = int(z['g_n_rel']), int(z['g_n_prior'])
    while g._rel_cap < n_rel:
        g._grow_rel()
    while g._prior_cap < n_prior:
        g._grow_prior()
    g.n_rel, g.n_prior = n_rel, n_prior
    for name in ('rel_meas', 'rel_keys', 'rel_sqrt_info', 'rel_robust',
                 'rel_fixed_a', 'rel_weight'):
        getattr(g, name)[:n_rel] = z['g_' + name]
    for name in ('prior_meas', 'prior_keys', 'prior_sqrt_info',
                 'prior_weight'):
        getattr(g, name)[:n_prior] = z['g_' + name]

    def up(a):
        return torch.from_numpy(np.array(a)).to(dev)

    for i, track in enumerate(est.laser_tracks):
        p = f't{i}_'
        for t, pose, key in zip(z[p + 'traj_times'], z[p + 'traj_poses'],
                                z[p + 'traj_keys']):
            track.trajectory.extend(int(t), pose, int(key))
        track.pose_measurement_times = [int(t) for t in
                                        z[p + 'pose_meas_times']]
        track.pose_measurements = [row for row in z[p + 'pose_meas']]
        track.odometry_measurements = _relposes_from_arrays(
            z[p + 'odom'], z[p + 'odom_meta'])
        track.icp_transformations = _relposes_from_arrays(
            z[p + 'icp'], z[p + 'icp_meta'])
        track.loop_closures = _relposes_from_arrays(
            z[p + 'lc'], z[p + 'lc_meta'])
        _restore_generator(track.generator, _get(z, p + 'generator_state'))
        if p + 'scan_points' in z:
            pts = z[p + 'scan_points']
            msk = z[p + 'scan_masks']
            nrm = z[p + 'scan_normals']
            for k in range(len(z[p + 'scan_times'])):
                track.scans.append(LaserScan(
                    cloud=pc.Cloud(up(pts[k]), up(msk[k])),
                    time_ns=int(z[p + 'scan_times'][k]),
                    key=int(z[p + 'scan_keys'][k]),
                    normals=up(nrm[k])))
            # Rebuild the scan ring from the newest scans.  The file's
            # scan capacity wins over the config's (a mismatched config
            # would otherwise break the ring shapes).
            K, n_ckpt = track._ring_points.shape[0], pts.shape[1]
            if n_ckpt != track._ring_points.shape[1]:
                track._ring_points = torch.full(
                    (K, n_ckpt, 3), pc.SENTINEL, dtype=torch.float32,
                    device=dev)
                track._ring_mask = torch.zeros((K, n_ckpt),
                                               dtype=torch.bool, device=dev)
                track._ring_normals = torch.zeros(
                    (K, n_ckpt, 3), dtype=torch.float32, device=dev)
            for s in track.scans[-K:]:
                track._push_ring(s)
        track._ring_times = z[p + 'ring_times'].copy()

    workers = None
    if 'w0_world_to_odom' in z:
        if workers_cls is None:
            workers_cls = LaserSlamWorker
        workers = []
        for i in range(n_workers):
            p = f'w{i}_'
            w = workers_cls(config.worker, est, i)
            w.world_to_odom = z[p + 'world_to_odom']
            bt = int(z[p + 'base_time'])
            w._base_time_ns = None if bt < 0 else bt
            lp = z[p + 'last_pose']
            w._last_pose = None if np.isnan(lp[0]) else lp
            mp = z[p + 'map_points']
            w._map_points[:len(mp)] = mp
            w._map_count = len(mp)
            w._distant_points = z[p + 'distant_points']
            workers.append(w)
    return est, workers
