"""The port's occupancy grid (``pipeline/occupancy.py``) and the
``laser_to_map`` tool against the JAX package's.

Seeded scans (NaN rows, points beyond the range and near the sensor
included) go into both grids from the same poses.  Tolerances:
``touched`` equal; ``log_odds`` within 2e-6, twice the measured 9.5e-7
(a cell's sum of misses and hits rounds in scatter order);
``cell_coords`` equal on buckets with one writer, and on buckets two
cells hash to the port's coordinate is one of the candidates (counted
and printed); ``occupied_points`` set-equal; a .npz written by either
package loads in the other and keeps integrating; .xyz/.pcd/.ply
byte-equal where no bucket collides.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from laser_slam_tpu.pipeline import occupancy as jocc
from laser_slam_tpu_torch.config import Config, WorkerConfig, slice1_config
from laser_slam_tpu_torch.core import checkpoint as ck
from laser_slam_tpu_torch.core.estimator import IncrementalEstimator
from laser_slam_tpu_torch.ops import se3
from laser_slam_tpu_torch.ops.cloud import _hash_cells
from laser_slam_tpu_torch.pipeline import occupancy as occ
from laser_slam_tpu_torch.pipeline import replay
from laser_slam_tpu_torch.pipeline.worker import LaserSlamWorker

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG_ODDS_ATOL = 2e-6
GRID = dict(resolution=0.25, max_range=15.0, ray_steps=64)


def scans(seed=0, n_scans=3, n=1500):
    """(points, pose7) pairs: points around the sensor out to 20 m, with
    NaN rows and points inside 1 mm."""
    g = np.random.default_rng(seed)
    out = []
    for k in range(n_scans):
        pts = g.uniform(-20, 20, (n, 3)).astype(np.float32)
        pts[:, 2] *= 0.2
        pts[::97] = np.nan
        pts[5] = 1e-4
        yaw = 0.3 * k
        pose = np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2),
                         0.7 * k, -0.4 * k, 1.2], np.float32)
        out.append((pts, pose))
    return out


def end_cells(points, pose7, grid):
    """Hit cells and their hashes of a scan's valid rows (the port's
    formulas, on the CPU)."""
    p = torch.as_tensor(points)
    pose = torch.as_tensor(pose7)
    ray = se3.apply(pose, p) - pose[4:]
    dist = torch.linalg.norm(ray, dim=-1, keepdim=True)
    valid = ((dist[:, 0] > 1e-3) & (dist[:, 0] < grid.max_range)
             & torch.isfinite(p).all(-1))
    end = pose[4:] + ray * torch.clamp(
        grid.max_range / torch.clamp(dist, min=1e-9), max=1.0)
    cells = torch.floor(end / grid.resolution).to(torch.int32)[valid]
    return cells.numpy(), _hash_cells(cells, grid.n_cells).numpy()


def compare(grid, jgrid, data):
    """Assert the grids agree; returns (collided buckets, max log-odds
    gap)."""
    touched = grid.touched.numpy()
    assert np.array_equal(touched, np.asarray(jgrid.touched))
    gap = float(np.abs(grid.log_odds.numpy()
                       - np.asarray(jgrid.log_odds)).max())
    assert gap <= LOG_ODDS_ATOL
    candidates = {}
    for pts, pose in data:
        cells, hashes = end_cells(pts, pose, grid)
        for c, h in zip(map(tuple, cells), hashes):
            candidates.setdefault(int(h), set()).add(c)
    coords, jcoords = grid.cell_coords.numpy(), np.asarray(jgrid.cell_coords)
    collided = 0
    for h, cands in candidates.items():
        assert tuple(coords[h]) in cands
        if len(cands) == 1:
            assert np.array_equal(coords[h], jcoords[h])
        else:
            collided += 1
    assert set(candidates) == set(np.flatnonzero(touched))
    if not collided:
        a = grid.occupied_points()
        b = jgrid.occupied_points()
        assert a.tobytes() == np.asarray(b).tobytes()
    print(f'{collided} of {len(candidates)} buckets collided, log-odds gap '
          f'{gap:.3e}')
    return collided, gap


@pytest.mark.parametrize('n_cells', [1 << 12, 1 << 20])
def test_insert_scan_matches_jax(n_cells):
    data = scans(1)
    grid = occ.OccupancyGrid(n_cells=n_cells, device='cpu', **GRID)
    jgrid = jocc.OccupancyGrid(n_cells=n_cells, **GRID)
    for pts, pose in data:
        grid.insert_scan(pts, pose)
        jgrid.insert_scan(pts, pose)
    collided, _ = compare(grid, jgrid, data)
    assert collided > (100 if n_cells == 1 << 12 else 0)
    # Set-equal where no bucket collided; as many cells where some did.
    assert len(grid.occupied_points()) == len(jgrid.occupied_points())


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_npz_loads_in_the_other_package(tmp_path, writer):
    data = scans(2, n_scans=4)
    grid = occ.OccupancyGrid(n_cells=1 << 18, device='cpu', **GRID)
    jgrid = jocc.OccupancyGrid(n_cells=1 << 18, **GRID)
    for pts, pose in data[:2]:
        grid.insert_scan(pts, pose)
        jgrid.insert_scan(pts, pose)
    path = str(tmp_path / 'grid.npz')
    (grid if writer == 'port' else jgrid).save(path)
    ours, theirs = occ.OccupancyGrid.load(path, device='cpu'), \
        jocc.OccupancyGrid.load(path)
    assert ours.resolution == theirs.resolution == GRID['resolution']
    for g in (ours, theirs):
        g.max_range, g.ray_steps = GRID['max_range'], GRID['ray_steps']
    for pts, pose in data[2:]:
        ours.insert_scan(pts, pose)
        theirs.insert_scan(pts, pose)
    compare(ours, theirs, data)


def test_exports_byte_equal(tmp_path):
    data = scans(3, n=400)
    grid = occ.build_occupancy_from_track_data(
        [(k, p, q) for k, (p, q) in enumerate(data)], resolution=0.25,
        max_range=15.0, device='cpu')
    jgrid = jocc.build_occupancy_from_track_data(
        [(k, p, q) for k, (p, q) in enumerate(data)], resolution=0.25,
        max_range=15.0)
    assert compare(grid, jgrid, data)[0] == 0
    assert len(grid.occupied_points()) > 50
    for ext in ('xyz', 'pcd', 'ply'):
        ours, theirs = str(tmp_path / f'a.{ext}'), str(tmp_path / f'b.{ext}')
        grid.save(ours)
        jgrid.save(theirs)
        with open(ours, 'rb') as a, open(theirs, 'rb') as b:
            assert a.read() == b.read()
    with pytest.raises(ValueError):
        grid.save(str(tmp_path / 'a.obj'))


def test_grid_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        occ.OccupancyGrid(n_cells=16)


@pytest.fixture
def port_checkpoint(tmp_path):
    cfg = slice1_config(scan_capacity=1024, reading_capacity=512,
                        nscan_in_sub_map=3)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, pose_capacity=16, factor_capacity=64))
    est = IncrementalEstimator(cfg, 1, device='cpu')
    worker = LaserSlamWorker(WorkerConfig(minimum_distance_to_add_pose=0.3,
                                          local_map_capacity=1 << 14), est)
    frames = list(replay.SyntheticStream(
        n_scans=4, points_per_scan=1024, trajectory='line', step_m=0.5,
        noise_m=0.005, seed=7))
    assert replay.run_worker_on_stream(worker, frames) == 4
    path = str(tmp_path / 'state.npz')
    ck.save_checkpoint(path, est, [worker])
    return path, Config(estimator=cfg)


def test_laser_to_map_runs_on_a_port_checkpoint(tmp_path, port_checkpoint,
                                                capsys):
    from laser_slam_tpu_torch.tools import laser_to_map
    path, _ = port_checkpoint
    out = str(tmp_path / 'map.xyz')
    assert laser_to_map.main(['laser_to_map', path, out, 'resolution',
                              '0.2', '--cpu']) == 0
    text = capsys.readouterr().out
    assert 'Rebuilding map from 4 scans' in text
    n = int(text.split('Saved map (')[1].split(' occupied')[0])
    assert n > 100 and len(np.loadtxt(out)) == n
    # The JAX tool reads the same checkpoint to the same map.
    spec = importlib.util.spec_from_file_location(
        'jax_laser_to_map', os.path.join(REPO, 'tools', 'laser_to_map.py'))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    jout = str(tmp_path / 'jmap.xyz')
    assert jtool.main(['laser_to_map', path, jout, 'resolution', '0.2']) == 0
    ours, theirs = np.loadtxt(out), np.loadtxt(jout)
    assert ours.shape == theirs.shape
    assert {tuple(r) for r in ours} == {tuple(r) for r in theirs}
    assert laser_to_map.main(['laser_to_map', path]) == 1
    assert laser_to_map.main(['laser_to_map', path, out, 'bogus', '1']) == 1
