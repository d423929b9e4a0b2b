"""Fleet mode: many independent trajectories, and batched serving, on one
card.

Counterpart of ``laser_slam_tpu/parallel/fleet.py``, where ``jax.vmap``
turns the single-robot ops into a fleet.  Here the ops take the lane axis
themselves: ``ops/icp.py`` registers [B,N,3] readings at once (K1L/K2L,
``nn_brute_lanes`` or per-lane range images for per-lane references; one
search of the flattened queries for a shared one), and
``graph/solver.solve_lanes`` solves B graphs as one joined graph with
per-lane PCG scalars.  A lane costs no launch of its own: one fleet step
issues what one lane would.

* :func:`fleet_icp_odometry`: scan-to-scan ICP odometry of B lanes over T
  scans (JAX's ``lax.scan`` over T inside ``vmap`` over B): a loop over
  the T-1 steps with every lane in each call.
* :func:`batched_icp`: B readings against one shared reference, the
  serving path behind the README's batched scan-pairs/s.  JAX splits a
  batch of exactly 64 into two halves to dodge a TPU scheduling fault;
  the port does not (it changes no result).
* :func:`fleet_solve` / :func:`build_fleet_chain_graphs`: the batched
  pose-graph solve of the fleet's chains.
* :class:`FleetMaps`, :func:`init_fleet_maps`, :func:`fleet_accumulate`,
  :func:`fleet_map_query`: per-lane world-frame local maps and their
  exact 1-NN queries (K1L on the card; the JAX package sweeps
  ``nn_brute`` under ``vmap``).  The JAX accumulate compacts an
  overflowing lane under a per-lane ``lax.cond``; here a host upper bound
  of each lane's cursor (``FleetMaps.cursor_bound``, as
  ``pipeline/device_map.DeviceMapper`` keeps) says when a lane may
  overflow, and only then are the cursors read.

The functions that take tensors run where the tensors lie; there is no
fallback from the card to the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from laser_slam_tpu_torch.config import IcpConfig, SolverConfig
from laser_slam_tpu_torch.graph import solver as sv
from laser_slam_tpu_torch.graph.factors import (  # noqa: F401  (re-export)
    FactorGraphData, build_fleet_chain_graphs)
from laser_slam_tpu_torch.ops import cloud as pc
from laser_slam_tpu_torch.ops import icp as icp_mod
from laser_slam_tpu_torch.ops import nn_kernels
from laser_slam_tpu_torch.ops import se3


class FleetOdometryResult(NamedTuple):
    poses: torch.Tensor        # [B,T,7] estimated world poses
    rel_icp: torch.Tensor      # [B,T,7] per-step ICP relative transforms
    valid: torch.Tensor        # [B,T] ICP validity per step
    iterations: torch.Tensor   # [B,T]


def fleet_icp_odometry(points, masks, normals, init_pose, odom_rel,
                       config: IcpConfig) -> FleetOdometryResult:
    """Scan-to-scan ICP odometry for a whole fleet.

    points:  [B,T,N,3] per-lane scan sequences (padded)
    masks:   [B,T,N]
    normals: [B,T,N,3] per-scan normals (ops.cloud.estimate_normals)
    init_pose: [B,7] world pose of each lane's first scan
    odom_rel:  [B,T,7] odometry-predicted relative motion scan t-1 -> t
               (identity for t=0; used as the ICP initial guess)

    Registers scan t against scan t-1 in every lane (one lane-axis ICP
    call a step, each lane against its own reference) and integrates the
    relative transforms.
    """
    B, T = points.shape[:2]
    dev = points.device
    pose = init_pose
    poses = [init_pose]
    rels = [se3.identity(device=dev).expand(B, 7)]
    valids = [torch.ones((B,), dtype=torch.bool, device=dev)]
    iters = [torch.zeros((B,), dtype=torch.int32, device=dev)]
    for t in range(1, T):
        res = icp_mod.icp_point_to_plane(
            pc.Cloud(points[:, t], masks[:, t]),
            pc.Cloud(points[:, t - 1], masks[:, t - 1]), normals[:, t - 1],
            odom_rel[:, t], config)
        pose = se3.normalize(se3.compose(pose, res.T))
        poses.append(pose)
        rels.append(res.T)
        valids.append(res.valid)
        iters.append(res.iterations)
    return FleetOdometryResult(torch.stack(poses, dim=1),
                               torch.stack(rels, dim=1),
                               torch.stack(valids, dim=1),
                               torch.stack(iters, dim=1))


def fleet_solve(graphs: FactorGraphData, poses, pose_masks,
                config: SolverConfig, offchain: Optional[int] = None):
    """Batched pose-graph solve: every field of ``graphs`` and ``poses``
    carries a leading fleet axis [B, ...] (``solver.solve_lanes``).
    ``offchain`` bounds any one lane's off-chain factors (one a lane for
    :func:`build_fleet_chain_graphs`: the factor on the gauge-fixed first
    pose); without it the count is read once per linearization."""
    return sv.solve_lanes(graphs, poses, pose_masks, config, offchain)


def batched_icp(points, masks, reference: pc.Cloud, ref_normals, guesses,
                config: IcpConfig):
    """Point-to-plane ICP of a batch of readings [B,N,3] (masks [B,N],
    guesses [B,7]) against one SHARED reference: the serving path behind
    the headline benchmark.  The reference is searched once for all
    lanes' queries (one K1/K2 call, brute block or range image an
    iteration)."""
    return icp_mod.icp_point_to_plane(pc.Cloud(points, masks), reference,
                                      ref_normals, guesses, config)


class FleetMaps(NamedTuple):
    """Per-lane world-frame local maps: fixed-capacity SENTINEL-parked
    buffers, one per lane.  ``cursor_bound`` is a host upper bound of
    each lane's cursor (numpy [B]; None when unknown, which reads the
    cursors at the next compacting accumulate)."""
    points: torch.Tensor   # [B,M,3]
    mask: torch.Tensor     # [B,M]
    cursor: torch.Tensor   # [B] int32 next write row
    cursor_bound: Optional[np.ndarray] = None


def init_fleet_maps(n_lanes: int, capacity: int,
                    device='cuda') -> FleetMaps:
    """Empty maps on ``device``: the card unless the caller names
    another (asking for the card without one raises)."""
    from laser_slam_tpu_torch.pipeline.online import resolve_device
    device = resolve_device(device)
    return FleetMaps(
        points=torch.full((n_lanes, capacity, 3), pc.SENTINEL,
                          dtype=torch.float32, device=device),
        mask=torch.zeros((n_lanes, capacity), dtype=torch.bool,
                         device=device),
        cursor=torch.zeros((n_lanes,), dtype=torch.int32, device=device),
        cursor_bound=np.zeros((n_lanes,), np.int64))


def fleet_maps_to_numpy(maps: FleetMaps) -> dict:
    """The maps' state as numpy arrays under the JAX ``FleetMaps`` field
    names (points, mask, cursor)."""
    return {name: getattr(maps, name).cpu().numpy()
            for name in ('points', 'mask', 'cursor')}


def fleet_maps_from_numpy(d: dict, device='cuda') -> FleetMaps:
    """:class:`FleetMaps` on ``device`` from numpy arrays keyed by the JAX
    field names (a JAX ``FleetMaps`` passed through ``np.asarray``); the
    cursors are known on the host, so the bound is exact."""
    from laser_slam_tpu_torch.pipeline.online import resolve_device
    device = resolve_device(device)
    cursor = np.asarray(d['cursor'])
    return FleetMaps(
        points=torch.as_tensor(np.array(d['points'], np.float32),
                               device=device),
        mask=torch.as_tensor(np.array(d['mask'], bool), device=device),
        cursor=torch.as_tensor(cursor.astype(np.int32), device=device),
        cursor_bound=cursor.astype(np.int64))


def _scatter_rows(buf, rows, values):
    """buf[b, rows[b, i]] = values[b, i], rows == M dropped (JAX's
    ``mode='drop'``: they land in an overflow row that is cut off)."""
    B, M = buf.shape[:2]
    ext = torch.cat([buf, torch.zeros((B, 1) + buf.shape[2:],
                                      dtype=buf.dtype, device=buf.device)],
                    dim=1)
    idx = rows.reshape(rows.shape + (1,) * (buf.dim() - 2)).expand(
        values.shape)
    ext.scatter_(1, idx, values)
    return ext[:, :M].contiguous()


def fleet_accumulate(maps: FleetMaps, scan_points: torch.Tensor,
                     scan_masks: torch.Tensor, poses: torch.Tensor,
                     voxel_size_m: float = 0.0) -> FleetMaps:
    """Append one scan per lane to its map, transformed by its pose.

    scan_points [B,N,3] (sensor frame), poses [B,7].  When a lane's buffer
    would overflow it is voxel-compacted first (``voxel_size_m`` > 0) or
    the overflow rows are dropped (bounded-memory policy, the same trade
    as pipeline.device_map).  The cursors are read back only when the
    host bound says a lane may overflow and ``voxel_size_m`` > 0.
    """
    N = scan_points.shape[1]
    M = maps.points.shape[1]
    world = se3.apply(poses[:, None, :], scan_points)
    world = torch.where(scan_masks[..., None], world,
                        torch.full_like(world, pc.SENTINEL))
    pts, msk, cur = maps.points, maps.mask, maps.cursor
    bound = maps.cursor_bound
    if voxel_size_m > 0.0 and (bound is None or np.any(bound + N > M)):
        cur_host = cur.cpu().numpy().astype(np.int64)
        over = np.flatnonzero(cur_host + N > M)
        if over.size:
            sel = torch.as_tensor(over, device=pts.device)
            c = pc.compact(pc.voxel_filter(pc.Cloud(pts[sel], msk[sel]),
                                           voxel_size_m, 1), M)
            pts = pts.index_copy(0, sel, c.points)
            msk = msk.index_copy(0, sel, c.mask)
            kept = torch.sum(c.mask, dim=-1).to(torch.int32)
            cur = cur.index_copy(0, sel, kept)
            cur_host[over] = kept.cpu().numpy()
        bound = cur_host
    rows = cur[:, None].long() + torch.arange(N, device=cur.device)
    rows = torch.clamp(rows, max=M)
    return FleetMaps(
        points=_scatter_rows(pts, rows, world),
        mask=_scatter_rows(msk, rows, scan_masks),
        cursor=torch.clamp(cur + N, max=M),
        cursor_bound=None if bound is None else np.minimum(bound + N, M))


def fleet_map_query(maps: FleetMaps, queries: torch.Tensor):
    """Batched exact 1-NN of per-lane queries against per-lane maps.

    queries [B,Q,3] (world frame) -> (indices [B,Q] int32, sq-distances
    [B,Q]).  On the card one K1L launch serves every lane
    (``nn_kernels.nn_indices_lanes``); CPU tensors take its plain version,
    ``neighbors.nn_brute_lanes``.  Distances are coordinate-wise f32,
    where the JAX package expands |q|^2 - 2 q.r + |r|^2, so a near-tie
    may pick another neighbour than JAX's.
    """
    d2, idx = nn_kernels.nn_indices_lanes(queries.contiguous(),
                                          maps.points.contiguous())
    return idx, d2
