"""Device-resident local/distant map for the online path.

Counterpart of ``laser_slam_tpu/pipeline/device_map.py``: scans are
appended straight from the online state's scan ring (or from
``online_chunk(return_scans=True)``), voxel/cylindrical filtering and
the near/far (local/distant) separation run on the device, and a loop
closure re-rigidifies a map with one batched transform.  The reference's
map pipeline:

* accumulation         — scanCallback, laser_slam_worker.cpp:235-246
* filtering/separation — getFilteredMap, laser_slam_worker.cpp:415-488
* re-rigidify          — updateLocalMap, laser_slam_worker.cpp:522-540

Port notes.  JAX compacts a full buffer inside its step with
``lax.cond(cursor + N > M, compact, identity)``.  Here the host decides:
:class:`DeviceMapper` keeps an upper bound of each map's cursor (+N a
scan; a filter pass only lowers the cursor) and reads the true cursor
only when the bound says the next scan may not fit, then once more
after a compaction.  With the bound far from the capacity, a scan reads
nothing back.  JAX's ``mode='drop'`` scatters past the capacity become
writes of the rows that fit (a host count in that rare path) and, for
the distant map, writes into one overflow row that is cut off.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from laser_slam_tpu_torch.config import WorkerConfig
from laser_slam_tpu_torch.ops import cloud as pc
from laser_slam_tpu_torch.ops import se3
from laser_slam_tpu_torch.pipeline.online import resolve_device


class MapState(NamedTuple):
    """Fixed-capacity world-frame point buffer (SENTINEL-parked)."""
    points: torch.Tensor  # [M,3]
    mask: torch.Tensor    # [M]
    cursor: torch.Tensor  # int32 next write row (rows < cursor may be invalid)


def init_map(capacity: int, device='cuda') -> MapState:
    device = resolve_device(device)
    return MapState(
        points=torch.full((capacity, 3), pc.SENTINEL, dtype=torch.float32,
                          device=device),
        mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
        cursor=torch.zeros((), dtype=torch.int32, device=device))


def _as_cloud(m: MapState) -> pc.Cloud:
    return pc.Cloud(m.points, m.mask)


def _compact_map(m: MapState, voxel_size_m: float) -> MapState:
    """Voxel-compact when the buffer runs out of rows (worker._compact_map
    semantics)."""
    c = pc.voxel_filter(_as_cloud(m), voxel_size_m, 1)
    c = pc.compact(c, m.points.shape[0])
    return MapState(points=c.points, mask=c.mask,
                    cursor=torch.sum(c.mask).to(torch.int32))


def _accumulate(m: MapState, scan_points: torch.Tensor,
                scan_mask: torch.Tensor, T_w: torch.Tensor,
                config: WorkerConfig, cursor: Optional[int] = None
                ) -> MapState:
    """Append one sensor-frame scan, transformed to world, to the map.

    The scan's N rows land at ``cursor`` (invalid rows keep mask False
    and stay parked).  When fewer than N rows remain the buffer is first
    voxel-compacted (laser_slam_worker.cpp:235-246 with the capacity
    policy the reference leaves to unbounded PCL vectors).  ``cursor``:
    None when the caller knows that N rows fit (nothing is read back);
    else the map's cursor as a host int, which decides the compaction
    as JAX's ``lax.cond`` does; a compaction reads its new cursor.  The
    buffers are written in place."""
    N = scan_points.shape[0]
    M = m.points.shape[0]
    world = se3.apply(T_w, scan_points)
    mask = scan_mask
    if config.remove_ground_from_local_map:
        z = T_w[6]
        keep = world[:, 2] > (z - config.ground_distance_to_robot_center_m)
        mask = mask & keep
    world = torch.where(mask[:, None], world, torch.full_like(world,
                                                              pc.SENTINEL))
    n_fit = N
    if cursor is not None:
        if cursor + N > M:
            m = _compact_map(m, config.voxel_size_m)
            cursor = int(m.cursor)
        n_fit = max(min(N, M - cursor), 0)
    rows = m.cursor.long() + torch.arange(n_fit, device=world.device)
    m.points.index_copy_(0, rows, world[:n_fit])
    m.mask.index_copy_(0, rows, mask[:n_fit])
    return m._replace(cursor=torch.clamp(m.cursor + N, max=M))


def accumulate_scan(m: MapState, scan_points, scan_mask, T_w,
                    config: WorkerConfig) -> MapState:
    """:func:`_accumulate` for a caller without a cursor bound: the
    cursor is read back (one sync)."""
    return _accumulate(m, scan_points, scan_mask, T_w, config,
                       int(m.cursor))


def accumulate_scans(m: MapState, scan_points, scan_mask, T_ws,
                     config: WorkerConfig) -> MapState:
    """Chunked accumulate of C scans ([C,N,3]/[C,N]/[C,7]): the same as C
    :func:`accumulate_scan` calls (a cursor read each, which
    :class:`DeviceMapper` saves with its bound)."""
    for c in range(scan_points.shape[0]):
        m = accumulate_scan(m, scan_points[c], scan_mask[c], T_ws[c], config)
    return m


def filter_and_separate(local: MapState, distant: MapState, center,
                        config: WorkerConfig) -> Tuple[MapState, MapState]:
    """Voxel-filter the local map and move far points to the distant map
    (getFilteredMap, laser_slam_worker.cpp:415-488).

    Near points (inside the cylinder around ``center``) stay in the live
    local map, voxel-filtered and compacted; far points are voxel-filtered
    once and appended to the distant buffer (static thereafter, except
    for loop-closure re-rigidification).  Distant rows past its capacity
    are dropped."""
    c = _as_cloud(local)
    center = torch.as_tensor(center, dtype=torch.float32,
                             device=local.points.device)
    M = local.points.shape[0]
    near = pc.cylindrical_filter(c, center,
                                 config.distance_to_consider_fixed,
                                 config.cylinder_height_m, False)
    near = pc.voxel_filter(near, config.voxel_size_m,
                           config.minimum_point_number_per_voxel)
    near = pc.compact(near, M)
    new_local = MapState(points=near.points, mask=near.mask,
                         cursor=torch.sum(near.mask).to(torch.int32))
    if not config.separate_distant_map:
        return new_local, distant

    far = pc.cylindrical_filter(c, center,
                                config.distance_to_consider_fixed,
                                config.cylinder_height_m, True)
    far = pc.voxel_filter(far, config.voxel_size_m,
                          config.minimum_point_number_per_voxel)
    far = pc.compact(far, M)
    D = distant.points.shape[0]
    rows = distant.cursor.long() + torch.arange(M, device=center.device)
    rows = torch.where(rows < D, rows, torch.full_like(rows, D))
    pts = torch.cat([distant.points, distant.points.new_zeros((1, 3))])
    msk = torch.cat([distant.mask, distant.mask.new_zeros((1,))])
    pts[rows] = torch.where(far.mask[:, None], far.points,
                            torch.full_like(far.points, pc.SENTINEL))
    msk[rows] = far.mask
    new_distant = MapState(
        points=pts[:D], mask=msk[:D],
        cursor=torch.clamp(distant.cursor
                           + torch.sum(far.mask).to(torch.int32), max=D))
    return new_local, new_distant


def rigidify(m: MapState, T: torch.Tensor) -> MapState:
    """Transform the whole map by ``T`` after a loop closure
    (updateLocalMap, laser_slam_worker.cpp:522-540)."""
    pts = se3.apply(T, m.points)
    return m._replace(points=torch.where(m.mask[:, None], pts,
                                         torch.full_like(pts, pc.SENTINEL)))


class DeviceMapper:
    """Host driver of the device maps, companion to
    ``pipeline.online.OnlineRunner``.

    Keeps ONE (local, distant) map pair PER TRACK, as the reference keeps
    one per worker (laser_slam_worker.hpp:157-159): a loop-closure
    correction re-rigidifies a track's own map, never points of another
    robot (updateLocalMap, laser_slam_worker.cpp:522-540).

    Call :meth:`accumulate` after each processed scan (the newest ring
    entry and its solved pose, straight from the online state),
    :meth:`refresh` to filter and separate, and :meth:`rigidify` after
    loop closures.  ``device`` is the card unless the caller names
    another; asking for the card without one raises."""

    def __init__(self, config: WorkerConfig, distant_capacity: int = 0,
                 n_tracks: int = 1, device='cuda'):
        self.config = config
        self.n_tracks = n_tracks
        cap = config.local_map_capacity
        self.local_maps: List[MapState] = [init_map(cap, device)
                                           for _ in range(n_tracks)]
        self.distant_maps: List[MapState] = [
            init_map(distant_capacity or cap, device)
            for _ in range(n_tracks)]
        self.device = self.local_maps[0].points.device
        # Host upper bound of each local map's cursor (module docstring).
        self._cursor_bound = [0] * n_tracks

    # Single-track views (most deployments run one robot).
    @property
    def local(self) -> MapState:
        return self.local_maps[0]

    @local.setter
    def local(self, m: MapState) -> None:
        self.local_maps[0] = m

    @property
    def distant(self) -> MapState:
        return self.distant_maps[0]

    @distant.setter
    def distant(self, m: MapState) -> None:
        self.distant_maps[0] = m

    def _append(self, track_id: int, pts, msk, T_w) -> None:
        """One scan into a track's local map; the cursor is read back only
        when its bound says the scan may not fit."""
        m = self.local_maps[track_id]
        N, M = pts.shape[0], m.points.shape[0]
        if self._cursor_bound[track_id] + N <= M:
            m = _accumulate(m, pts, msk, T_w, self.config)
            self._cursor_bound[track_id] += N
        else:
            m = _accumulate(m, pts, msk, T_w, self.config, int(m.cursor))
            self._cursor_bound[track_id] = int(m.cursor)
        self.local_maps[track_id] = m

    def accumulate(self, online_state, track_id: int = 0) -> None:
        """Append the newest scan of ``track_id`` from the online state's
        ring, moved by its solved pose, to that track's map."""
        key = torch.clamp(online_state.track_last_key[track_id], min=0)
        self._append(track_id, online_state.ring_points[track_id, -1],
                     online_state.ring_mask[track_id, -1],
                     online_state.traj_poses[key.long()])

    def accumulate_chunk(self, scan_points, scan_mask, pose7s,
                         track_id: int = 0) -> None:
        """Append a chunk's scans (the ``return_scans`` outputs of
        ``online.online_chunk``) to ``track_id``'s map: the same as one
        :meth:`accumulate` a scan."""
        for c in range(scan_points.shape[0]):
            self._append(track_id, scan_points[c], scan_mask[c], pose7s[c])

    def refresh(self, center, track_id: int = 0) -> None:
        """Filter and near/far separation around ``center`` (world [3]).
        The local cursor can only fall, so its bound stays an upper
        bound."""
        self.local_maps[track_id], self.distant_maps[track_id] = \
            filter_and_separate(self.local_maps[track_id],
                                self.distant_maps[track_id],
                                center, self.config)

    def rigidify(self, T_pose7, track_id: int = 0) -> None:
        """Apply a loop-closure correction to ONE track's maps."""
        T = torch.as_tensor(T_pose7, dtype=torch.float32, device=self.device)
        self.local_maps[track_id] = rigidify(self.local_maps[track_id], T)
        self.distant_maps[track_id] = rigidify(self.distant_maps[track_id],
                                               T)

    def local_points(self, track_id: int = 0) -> np.ndarray:
        """Host copy of a track's live local map, valid points [n,3]."""
        m = self.local_maps[track_id]
        return m.points.cpu().numpy()[m.mask.cpu().numpy()]

    def full_map(self, track_id: int = 0) -> np.ndarray:
        """Host copy of a track's local + distant valid points [n,3]."""
        m = self.distant_maps[track_id]
        d = m.points.cpu().numpy()[m.mask.cpu().numpy()]
        return np.concatenate([self.local_points(track_id), d])
