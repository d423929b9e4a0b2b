"""Padded point clouds, the input filters of the online step, and normals.

Counterpart of ``laser_slam_tpu/ops/cloud.py``.  A cloud is a
``Cloud(points[N,3], mask[N])`` of fixed capacity N; invalid slots are
masked out and parked at a far sentinel position so they never win a
nearest-neighbour query.  Filters only flip mask bits (and compact), so
every consumer sees fixed shapes.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from laser_slam_tpu_torch.ops import se3
from laser_slam_tpu_torch.ops.neighbors import knn_brute

# Far-away parking spot for invalid points; large enough to lose any NN
# query, small enough to stay well inside f32 range when squared.
SENTINEL = 1.0e6


class Cloud(NamedTuple):
    """Fixed-capacity point cloud. points: [N,3] f32, mask: [N] bool."""
    points: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    def count(self) -> torch.Tensor:
        """Number of valid points (0-d tensor)."""
        return torch.sum(self.mask, dim=-1)


def _parked(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None], points,
                       torch.full_like(points, SENTINEL))


def make_cloud(points, mask=None, capacity: Optional[int] = None,
               device=None) -> Cloud:
    """Build a Cloud from raw points [M,3], padding/truncating to capacity."""
    if not isinstance(points, torch.Tensor):
        points = np.array(points, dtype=np.float32)   # writable copy
    points = torch.as_tensor(points, dtype=torch.float32, device=device)
    n = points.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=points.device)
    else:
        mask = torch.as_tensor(mask, dtype=torch.bool, device=points.device)
    if capacity is None:
        capacity = n
    if n > capacity:
        points, mask = points[:capacity], mask[:capacity]
        n = capacity
    pad = capacity - n
    if pad:
        points = torch.cat([points, torch.full((pad, 3), SENTINEL,
                                               dtype=points.dtype,
                                               device=points.device)])
        mask = torch.cat([mask, torch.zeros((pad,), dtype=torch.bool,
                                            device=mask.device)])
    return Cloud(_parked(points, mask), mask)


def park_invalid(cloud: Cloud) -> Cloud:
    """Move masked-out points to the sentinel position."""
    return Cloud(_parked(cloud.points, cloud.mask), cloud.mask)


def transform(pose7, cloud: Cloud) -> Cloud:
    """Rigid-transform a cloud; invalid points stay parked."""
    return Cloud(_parked(se3.apply(pose7, cloud.points), cloud.mask),
                 cloud.mask)


def empty_cloud(capacity: int, device=None) -> Cloud:
    return Cloud(torch.full((capacity, 3), SENTINEL, dtype=torch.float32,
                            device=device),
                 torch.zeros((capacity,), dtype=torch.bool, device=device))


def concatenate(clouds, capacity: Optional[int] = None) -> Cloud:
    """Concatenate clouds along the point axis, optionally compacted to
    ``capacity``."""
    out = Cloud(torch.cat([c.points for c in clouds], dim=-2),
                torch.cat([c.mask for c in clouds], dim=-1))
    if capacity is not None and capacity != out.capacity:
        out = compact(out, capacity)
    return out


def _pack_scatter(cloud: Cloud, capacity: int) -> Cloud:
    """Order-preserving pack of valid points to the front of a
    ``capacity``-sized cloud via cumsum + scatter.

    JAX drops out-of-bounds scatter rows (``mode='drop'``); torch would
    raise, so invalid points and valid points packed beyond ``capacity``
    are sent to one extra overflow row per cloud that is cut off
    afterwards (same tail-drop semantics as sorting then truncating).
    Leading batch dimensions are packed independently."""
    mask = cloud.mask
    batch = tuple(mask.shape[:-1])
    n = mask.shape[-1]
    mask = mask.reshape(-1, n)
    dest = torch.cumsum(mask, dim=-1) - 1              # packed position
    dest = torch.where(mask & (dest < capacity), dest,
                       torch.full_like(dest, capacity))
    rows = torch.arange(mask.shape[0], device=dest.device)[:, None]
    dest = (dest + rows * (capacity + 1)).reshape(-1)
    dev, dt = cloud.points.device, cloud.points.dtype
    m = mask.shape[0]
    out_pts = torch.full((m, capacity + 1, 3), SENTINEL, dtype=dt,
                         device=dev)
    out_msk = torch.zeros((m, capacity + 1), dtype=torch.bool, device=dev)
    out_pts.view(-1, 3)[dest] = cloud.points.reshape(-1, 3)
    out_msk.view(-1)[dest] = mask.reshape(-1)
    return Cloud(out_pts[:, :capacity].reshape(batch + (capacity, 3)),
                 out_msk[:, :capacity].reshape(batch + (capacity,)))


def compact(cloud: Cloud, capacity: int) -> Cloud:
    """Pack valid points to the front and resize to ``capacity`` (the
    tail is dropped when more than ``capacity`` points are valid)."""
    return _pack_scatter(cloud, capacity)


def compact_decimate(cloud: Cloud, capacity: int) -> Cloud:
    """Pack valid points first, then EVENLY stride-decimate down to
    ``capacity``.

    A spinning-LiDAR scan is ring-major, so prefix truncation would keep
    only the top rings (no ground, ICP unconstrained in z/pitch); the
    even stride samples the whole packed range instead.
    """
    n = cloud.capacity
    if capacity >= n:
        return compact(cloud, capacity)
    packed = _pack_scatter(cloud, n)                # sort-free pack
    nv = torch.sum(cloud.mask, dim=-1)
    i = torch.arange(capacity, device=cloud.points.device)
    # f32 stride as in the JAX package; rounding may duplicate the odd
    # row, which is harmless (still a valid point).
    stride_rows = (i.to(torch.float32)
                   * (nv.to(torch.float32) / capacity)).to(torch.int64)
    rows = torch.where(nv > capacity, torch.clamp(stride_rows, 0, n - 1), i)
    return park_invalid(Cloud(packed.points[rows], packed.mask[rows]))


# ---------------------------------------------------------------------------
# Filters (mask-only, shape preserving)
# ---------------------------------------------------------------------------

def range_filter(cloud: Cloud, min_dist: float = 0.0,
                 max_dist: float = math.inf) -> Cloud:
    """Keep points with min_dist <= ||p|| <= max_dist (sensor frame)."""
    d2 = torch.sum(cloud.points * cloud.points, dim=-1)
    keep = (d2 >= min_dist * min_dist) & (d2 <= max_dist * max_dist)
    return park_invalid(Cloud(cloud.points, cloud.mask & keep))


def random_sampling_filter(cloud: Cloud, prob: float,
                           generator: Optional[torch.Generator]) -> Cloud:
    """Keep each valid point with probability ``prob``.

    ``generator`` replaces the JAX package's PRNG key.  The two streams
    differ for the same seed, so tests that compare the packages set the
    ratio to 1.0 (no draw is made then)."""
    if prob >= 1.0:
        return cloud
    keep = torch.rand(cloud.mask.shape, generator=generator,
                      device=cloud.mask.device) < prob
    return park_invalid(Cloud(cloud.points, cloud.mask & keep))


def box_filter(cloud: Cloud, center, half_extent) -> Cloud:
    """Keep points inside an axis-aligned box."""
    center = torch.as_tensor(center, dtype=cloud.points.dtype,
                             device=cloud.points.device)
    half_extent = torch.as_tensor(half_extent, dtype=cloud.points.dtype,
                                  device=cloud.points.device)
    inside = torch.all(torch.abs(cloud.points - center) <= half_extent,
                       dim=-1)
    return park_invalid(Cloud(cloud.points, cloud.mask & inside))


def cylindrical_filter(cloud: Cloud, center, radius_m: float,
                       height_m: float, remove_inside: bool) -> Cloud:
    """Keep (or, with ``remove_inside``, remove) points inside a vertical
    cylinder around ``center`` (applyCylindricalFilter,
    laser_slam_ros/common.hpp:194-223)."""
    center = torch.as_tensor(center, dtype=cloud.points.dtype,
                             device=cloud.points.device)
    d = cloud.points[..., :2] - center[:2]
    d2 = torch.sum(d * d, dim=-1)
    dz = torch.abs(cloud.points[..., 2] - center[2])
    inside = (d2 <= radius_m * radius_m) & (dz <= height_m / 2.0)
    keep = ~inside if remove_inside else inside
    return park_invalid(Cloud(cloud.points, cloud.mask & keep))


def ground_filter(cloud: Cloud, robot_height_m, ground_clearance_m) -> Cloud:
    """Remove points below robot_height - clearance
    (laser_slam_worker.cpp:221-233)."""
    keep = cloud.points[..., 2] > (robot_height_m - ground_clearance_m)
    return park_invalid(Cloud(cloud.points, cloud.mask & keep))


def voxel_filter(cloud: Cloud, voxel_size_m: float,
                 min_points_per_voxel: int = 1,
                 hash_capacity: Optional[int] = None) -> Cloud:
    """Voxel-grid downsample: keep the first valid point hashed into each
    voxel, and drop voxels with fewer than ``min_points_per_voxel``
    points (PCL VoxelGrid, laser_slam_worker.cpp:70-72,439-440, with a
    first-point representative as in the JAX package)."""
    n = cloud.capacity
    if hash_capacity is None:
        hash_capacity = max(2 * n, 1024)
    cell = torch.floor(cloud.points / voxel_size_m).to(torch.int32)
    h = _hash_cells(cell, hash_capacity)
    h = torch.where(cloud.mask, h, torch.full_like(h, hash_capacity))
    counts = torch.zeros(hash_capacity + 1, dtype=torch.int64,
                         device=h.device)
    counts.index_add_(0, h, torch.ones_like(h))
    idx = torch.arange(n, device=h.device)
    first = torch.full((hash_capacity + 1,), n, dtype=torch.int64,
                       device=h.device)
    first.scatter_reduce_(0, h, idx, reduce='amin')
    keep = ((first[h] == idx) & (counts[h] >= min_points_per_voxel)
            & cloud.mask)
    return park_invalid(Cloud(cloud.points, keep))


def _hash_cells(cell_ijk: torch.Tensor, capacity: int) -> torch.Tensor:
    """Spatial hash of integer cells [...,3] -> [0, capacity) (int64).

    The JAX package multiplies in wrapping int32 and takes an unsigned
    modulo.  torch has no uint32 ``%``, so the products are formed in
    int64, cut to their low 32 bits after the XOR, and reduced there:
    the same bits, hence the same bucket, for negative cells too."""
    c = cell_ijk.to(torch.int64)
    h = ((c[..., 0] * 73856093) ^ (c[..., 1] * 19349663)
         ^ (c[..., 2] * 83492791)) & 0xFFFFFFFF
    return h % capacity


def apply_filter_chain(cloud: Cloud, chain,
                       generator: Optional[torch.Generator] = None) -> Cloud:
    """Apply an ordered filter chain (the canonical tuple of
    ``config._canonical_chain``; laser_track.cpp:24-30,146).  Only
    'random_sampling' draws, from ``generator``."""
    for name, raw in chain:
        p = dict(raw)
        if name == 'range':
            cloud = range_filter(cloud, p.get('min_distance_m', 0.0),
                                 p.get('max_distance_m', math.inf))
        elif name == 'random_sampling':
            if generator is None:
                raise ValueError("filter chain contains 'random_sampling' "
                                 'but no generator was provided')
            cloud = random_sampling_filter(cloud, float(p['prob']),
                                           generator)
        elif name == 'box':
            cloud = box_filter(cloud, p['center'], p['half_extent'])
        elif name == 'cylindrical':
            cloud = cylindrical_filter(
                cloud, p.get('center', (0.0, 0.0, 0.0)),
                float(p['radius_m']), float(p.get('height_m', 1e6)),
                bool(p.get('remove_inside', False)))
        elif name == 'ground':
            cloud = ground_filter(cloud, float(p['robot_height_m']),
                                  float(p.get('ground_clearance_m', 0.0)))
        elif name == 'voxel':
            cloud = voxel_filter(cloud, float(p['voxel_size_m']),
                                 int(p.get('min_points_per_voxel', 1)))
        else:
            raise ValueError(f'unknown input filter type {name!r}')
    return cloud


# ---------------------------------------------------------------------------
# Surface normals
# ---------------------------------------------------------------------------

def _smallest_eigvec_3x3(A) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric [...,3,3].

    Closed form: eigenvalues via the trigonometric (Cardano) formula, then
    the eigenvector as the strongest cross product of rows of (A - l I).
    """
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    tr = a00 + a11 + a22
    q = tr / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22 +
          2.0 * (a01 * a01 + a02 * a02 + a12 * a12))
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    # det(B)/2 with B = (A - qI)/p
    detB = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    # Smallest eigenvalue: q + 2 p cos(phi + 2*pi/3)
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    # Rows of (A - lam I); eigenvector is orthogonal to all of them.
    r0 = torch.stack([a00 - lam, a01, a02], dim=-1)
    r1 = torch.stack([a01, a11 - lam, a12], dim=-1)
    r2 = torch.stack([a02, a12, a22 - lam], dim=-1)
    c01 = torch.linalg.cross(r0, r1, dim=-1)
    c02 = torch.linalg.cross(r0, r2, dim=-1)
    c12 = torch.linalg.cross(r1, r2, dim=-1)
    n01 = torch.sum(c01 * c01, dim=-1, keepdim=True)
    n02 = torch.sum(c02 * c02, dim=-1, keepdim=True)
    n12 = torch.sum(c12 * c12, dim=-1, keepdim=True)
    best = torch.where(n01 >= torch.maximum(n02, n12), c01,
                       torch.where(n02 >= n12, c02, c12))
    norm = torch.sqrt(torch.clamp(
        torch.sum(best * best, dim=-1, keepdim=True), min=1e-30))
    v = best / norm
    # Degenerate (isotropic) neighborhoods: fall back to +z.
    degenerate = torch.maximum(torch.maximum(n01, n02), n12)[..., 0] < 1e-24
    up = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype, device=A.device)
    return torch.where(degenerate[..., None], up, v)


def estimate_normals(cloud: Cloud, knn: int = 10) -> torch.Tensor:
    """Per-point surface normals from the k nearest neighbours (PCA).

    Exact kNN by chunked coordinate-wise distances (``neighbors.
    knn_brute``); the JAX package uses the matmul expansion, so near-tied
    k-th neighbours may differ.  Normals point toward the sensor origin;
    masked slots get +z.  Returns unit normals [N,3].
    """
    pts = cloud.points
    idx, _ = knn_brute(pts, pts, knn)
    neigh = pts[idx.long()]                                   # [N,k,3]
    centered = neigh - torch.mean(neigh, dim=-2, keepdim=True)
    cov = torch.einsum('nki,nkj->nij', centered, centered) / knn
    normal = _smallest_eigvec_3x3(cov)
    # Deterministic orientation: point normals toward the sensor origin
    # (point-to-plane only needs a line).
    flip = torch.sum(normal * pts, dim=-1, keepdim=True) > 0
    normal = torch.where(flip, -normal, normal)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=pts.dtype, device=pts.device)
    return torch.where(cloud.mask[:, None], normal, up)
