"""Occupancy-grid mapping and export tools.

Counterpart of ``laser_slam_tpu/pipeline/occupancy.py``, the replacement
for the reference's offline tools:
* ``laser_to_octomap`` (laser_slam_tools/src/laser_to_octomap.cpp:7-115):
  replay all (scan, optimized pose) pairs into an occupancy map with
  hit/miss probability updates and save it;
* ``octomap_to_point_cloud`` (src/octomap_to_point_cloud.cpp:14-48):
  export occupied cells as a point cloud (PCD/PLY/XYZ).

The grid is a dense-hash voxel grid with log-odds updates, on the card
unless the caller names another device.  Free-space carving is a
fixed-step DDA along each beam in plain torch (the JAX package computes
it in XLA, not in Pallas): one ``index_add_`` of misses and hits a scan.
On the card ``index_add_`` is atomic, so a cell's sum may round in
another order than JAX's.  A bucket's coordinates keep one writer of
the scan's hits (``index_put_`` with duplicate indices names no winner;
rows with one hit hash carry one cell unless two cells collide, the
reference's "latest writer" rule); invalid rows are dropped before the
writes.
"""

from __future__ import annotations

import numpy as np
import torch

from laser_slam_tpu_torch.ops import se3
from laser_slam_tpu_torch.ops.cloud import _hash_cells
from laser_slam_tpu_torch.pipeline.online import resolve_device


def _logit(p):
    return float(np.log(p / (1.0 - p)))


class OccupancyGrid:
    """Hash-addressed voxel occupancy grid with log-odds updates.

    Defaults mirror laser_to_octomap.cpp:18-22 (resolution 0.075 is the
    octomap default there; hit 0.9 / miss 0.4 / max range 20).
    """

    def __init__(self, resolution: float = 0.075, prob_hit: float = 0.9,
                 prob_miss: float = 0.4, max_range: float = 20.0,
                 n_cells: int = 1 << 22, ray_steps: int = 128,
                 device='cuda'):
        self.device = resolve_device(device)
        self.resolution = resolution
        self.l_hit = _logit(prob_hit)
        self.l_miss = _logit(prob_miss)
        self.max_range = max_range
        self.n_cells = n_cells
        self.ray_steps = ray_steps
        self.log_odds = torch.zeros((n_cells,), dtype=torch.float32,
                                    device=self.device)
        # Cell coordinates of a bucket's last writer (for export; hash
        # collisions keep one writer, acceptable at 4M cells).
        self.cell_coords = torch.zeros((n_cells, 3), dtype=torch.int32,
                                       device=self.device)
        self.touched = torch.zeros((n_cells,), dtype=torch.bool,
                                   device=self.device)

    def insert_scan(self, points: np.ndarray, pose7: np.ndarray) -> None:
        """Integrate one scan taken from ``pose7`` (world frame), mirroring
        OctomapManager::insertPointcloudWithTf (laser_to_octomap.cpp:100-103).

        Scans are padded with NaN (masked out) to power-of-two buckets, so
        the caching allocator reuses a handful of buffer sizes."""
        n = len(points)
        cap = 256
        while cap < n:
            cap *= 2
        pts = np.full((cap, 3), np.nan, np.float32)
        pts[:n] = np.asarray(points, np.float32)
        _insert(self.log_odds, self.cell_coords, self.touched,
                torch.from_numpy(pts).to(self.device),
                torch.as_tensor(np.asarray(pose7, np.float32),
                                device=self.device),
                self.resolution, self.l_hit, self.l_miss, self.max_range,
                self.n_cells, self.ray_steps)

    def occupied_points(self, threshold: float = 0.5) -> np.ndarray:
        """Occupied-cell centers as an [M,3] array
        (octomap_to_point_cloud.cpp:14-48 equivalent)."""
        occ = self.touched & (self.log_odds > _logit(threshold))
        coords = self.cell_coords[occ].cpu().numpy()
        return (coords.astype(np.float32) + 0.5) * self.resolution

    def save(self, path: str, threshold: float = 0.5) -> None:
        """Save occupied cells; .npz (grid state) or .xyz/.pcd/.ply cloud
        (laser_to_octomap saveOctomapCallback + octomap_to_point_cloud),
        in the JAX package's layouts."""
        if path.endswith('.npz'):
            np.savez_compressed(
                path, log_odds=self.log_odds.cpu().numpy(),
                cell_coords=self.cell_coords.cpu().numpy(),
                touched=self.touched.cpu().numpy(),
                resolution=self.resolution)
            return
        pts = self.occupied_points(threshold)
        if path.endswith('.xyz'):
            np.savetxt(path, pts, fmt='%.6f')
        elif path.endswith('.pcd'):
            with open(path, 'w') as f:
                f.write('# .PCD v0.7 - Point Cloud Data file format\n'
                        'VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\n'
                        'TYPE F F F\nCOUNT 1 1 1\n'
                        f'WIDTH {len(pts)}\nHEIGHT 1\n'
                        'VIEWPOINT 0 0 0 1 0 0 0\n'
                        f'POINTS {len(pts)}\nDATA ascii\n')
                np.savetxt(f, pts, fmt='%.6f')
        elif path.endswith('.ply'):
            with open(path, 'w') as f:
                f.write('ply\nformat ascii 1.0\n'
                        f'element vertex {len(pts)}\n'
                        'property float x\nproperty float y\n'
                        'property float z\nend_header\n')
                np.savetxt(f, pts, fmt='%.6f')
        else:
            raise ValueError(f'unknown map format: {path}')

    @classmethod
    def load(cls, path: str, device='cuda') -> 'OccupancyGrid':
        with np.load(path) as z:
            grid = cls(resolution=float(z['resolution']),
                       n_cells=len(z['log_odds']), device=device)
            grid.log_odds = torch.from_numpy(z['log_odds']).to(grid.device)
            grid.cell_coords = torch.from_numpy(
                z['cell_coords']).to(grid.device)
            grid.touched = torch.from_numpy(z['touched']).to(grid.device)
        return grid


def _insert(log_odds, cell_coords, touched, points, pose7, resolution,
            l_hit, l_miss, max_range, n_cells, ray_steps):
    """One scan's update (``laser_slam_tpu/pipeline/occupancy.py:126-173``)
    of the grid's tensors, in place."""
    origin = pose7[4:]
    pts_w = se3.apply(pose7, points)
    ray = pts_w - origin
    dist = torch.linalg.norm(ray, dim=-1, keepdim=True)
    valid = ((dist[:, 0] > 1e-3) & (dist[:, 0] < max_range)
             & torch.all(torch.isfinite(points), dim=-1))
    # Clamp endpoints to max range.
    end = origin + ray * torch.clamp(
        max_range / torch.clamp(dist, min=1e-9), max=1.0)

    # Free-space carving: fixed-step samples along each ray (DDA on a
    # budget).  Steps are proportional positions (0,1): exclude endpoint.
    alphas = (torch.arange(ray_steps, dtype=torch.float32,
                           device=points.device) + 0.5) / ray_steps
    sample = origin + (end - origin)[:, None, :] * alphas[None, :, None]
    # Only samples strictly before the hit cell count as misses.
    samp_cell = torch.floor(sample / resolution).to(torch.int32)
    end_cell = torch.floor(end / resolution).to(torch.int32)
    not_end = torch.any(samp_cell != end_cell[:, None, :], dim=-1)
    samp_valid = valid[:, None] & not_end

    h_miss = _hash_cells(samp_cell, n_cells)
    h_hit = _hash_cells(end_cell, n_cells)

    # Count a sample only where its cell differs from the previous
    # sample's cell on the same ray (limits over-counting).
    prev = torch.cat([torch.full((samp_cell.shape[0], 1, 3), -2 ** 30,
                                 dtype=torch.int32, device=points.device),
                      samp_cell[:, :-1]], dim=1)
    fresh = torch.any(samp_cell != prev, dim=-1)
    samp_valid = samp_valid & fresh

    zero = torch.zeros((), dtype=torch.float32, device=points.device)
    upd = torch.zeros_like(log_odds)
    upd.index_add_(0, h_miss.reshape(-1),
                   torch.where(samp_valid.reshape(-1), zero + l_miss, zero))
    upd.index_add_(0, h_hit, torch.where(valid, zero + l_hit, zero))
    log_odds.add_(upd).clamp_(-10.0, 10.0)

    # Only valid rows write coordinates and the touched flag (JAX sends
    # the others out of bounds, where its scatter drops them).
    rows = torch.nonzero(valid).squeeze(1)
    cell_coords.index_put_((h_hit[rows],), end_cell[rows])
    touched.index_put_((h_hit[rows],),
                       torch.ones_like(rows, dtype=torch.bool))


def build_occupancy_from_track_data(track_data,
                                    resolution: float = 0.075,
                                    prob_hit: float = 0.9,
                                    prob_miss: float = 0.4,
                                    max_range: float = 20.0,
                                    device='cuda') -> OccupancyGrid:
    """laser_to_octomap main loop equivalent: replay all (time, scan,
    optimized pose) tuples from ``LaserSlamWorker.get_laser_tracks_data``
    into an occupancy grid (laser_to_octomap.cpp:86-104)."""
    grid = OccupancyGrid(resolution=resolution, prob_hit=prob_hit,
                         prob_miss=prob_miss, max_range=max_range,
                         device=device)
    for time_ns, points, pose7 in track_data:
        grid.insert_scan(points, pose7)
    return grid
