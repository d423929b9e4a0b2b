"""The port's device map (pipeline/device_map.py) against the JAX
package's: the module functions on identical inputs, the runner's
per-scan and chunked accumulation, and per-track maps that follow their
own track's correction after a link.

Tolerances.  World points are one f32 transform of the same inputs:
1e-5 m.  Voxel filtering keeps the first point of each voxel; the
filtered maps are compared as sorted point sets (with their counts and
cursors exact).  The port's chunked and per-scan maps are bit-equal on
the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_slam_tpu import config as jcfg
from laser_slam_tpu.ops import se3 as jse3
from laser_slam_tpu.pipeline import device_map as jdm
from laser_slam_tpu_torch.config import (EstimatorConfig, IcpConfig,
                                         InputFilterConfig, LaserTrackConfig,
                                         SolverConfig, WorkerConfig)
from laser_slam_tpu_torch.ops import se3
from laser_slam_tpu_torch.pipeline import device_map as tdm
from laser_slam_tpu_torch.pipeline import online as ton
from laser_slam_tpu_torch.pipeline import replay as trep

torch.set_num_threads(2)
N_PTS = 512


def map_config(**kw):
    kw.setdefault('local_map_capacity', 4096)
    kw.setdefault('voxel_size_m', 0.5)
    return WorkerConfig(**kw)


def jax_map_config(cfg):
    return jcfg.WorkerConfig(**dataclasses.asdict(cfg))


def scans(rng, n):
    """n sensor-frame scans (a quarter of each parked) and their poses."""
    pts = rng.uniform(-20, 20, size=(n, N_PTS, 3)).astype(np.float32)
    mask = rng.uniform(size=(n, N_PTS)) > 0.25
    pts[~mask] = 1.0e6
    xi = rng.normal(size=(n, 6)).astype(np.float32) * [0.1, 0.1, 0.5, 3, 3,
                                                       0.2]
    poses = np.stack([np.asarray(jse3.exp(jnp.asarray(x, jnp.float32)))
                      for x in xi]).astype(np.float32)
    return pts, mask, poses


def as_torch(m):
    return tdm.MapState(*(torch.tensor(np.array(a)) for a in m))


def sorted_points(points, mask):
    p = np.asarray(points)[np.asarray(mask)]
    return p[np.lexsort(p.T[::-1])]


def assert_same_map(t, j, exact_rows=True):
    """Same cursor and valid count; points within 1e-5 m, row for row or
    as sorted sets."""
    assert int(t.cursor) == int(j.cursor)
    tm, jm = t.mask.numpy(), np.asarray(j.mask)
    assert tm.sum() == jm.sum()
    if exact_rows:
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_allclose(t.points.numpy()[tm],
                                   np.asarray(j.points)[jm], atol=1e-5)
        assert np.all(t.points.numpy()[~tm] == 1.0e6)
    else:
        np.testing.assert_allclose(sorted_points(t.points, tm),
                                   sorted_points(j.points, jm), atol=1e-5)


@pytest.mark.parametrize('capacity,ground', [(4096, False), (1536, False),
                                             (1536, True)],
                         ids=['room', 'compacting', 'ground'])
def test_accumulate_matches_jax(rng, capacity, ground):
    """accumulate_scan one scan at a time and accumulate_scans over a
    chunk, with room and with compactions (1536 rows hold three scans),
    and the ground filter: the port's DeviceMapper and module functions
    against JAX's."""
    cfg = map_config(local_map_capacity=capacity,
                     remove_ground_from_local_map=ground)
    jcfg_ = jax_map_config(cfg)
    pts, mask, poses = scans(rng, 7)
    jm = jdm.init_map(capacity)
    tm = tdm.init_map(capacity, device='cpu')
    mapper = tdm.DeviceMapper(cfg, device='cpu')
    for k in range(4):
        args = (pts[k], mask[k], poses[k])
        jm = jdm.accumulate_scan(jm, *map(jnp.asarray, args), jcfg_)
        tm = tdm.accumulate_scan(tm, *map(torch.tensor, args), cfg)
        mapper.accumulate_chunk(*(torch.tensor(a[k:k + 1])
                                  for a in (pts, mask, poses)))
        assert_same_map(tm, jm)
        assert_same_map(mapper.local, jm)
    jm = jdm.accumulate_scans(jm, *(jnp.asarray(a[4:])
                                    for a in (pts, mask, poses)), jcfg_)
    tm = tdm.accumulate_scans(tm, *(torch.tensor(a[4:])
                                    for a in (pts, mask, poses)), cfg)
    mapper.accumulate_chunk(*(torch.tensor(a[4:])
                              for a in (pts, mask, poses)))
    assert_same_map(tm, jm)
    assert_same_map(mapper.local, jm)


def test_mapper_reads_the_cursor_only_near_capacity(rng, monkeypatch):
    """The DeviceMapper's host bound: no cursor read while the next scan
    surely fits; near capacity a read, and after a compaction another."""
    cfg = map_config(local_map_capacity=4 * N_PTS)
    pts, mask, poses = scans(rng, 7)
    mapper = tdm.DeviceMapper(cfg, device='cpu')
    reads = []
    real = torch.Tensor.__int__
    monkeypatch.setattr(torch.Tensor, '__int__',
                        lambda t: reads.append(1) or real(t))
    counts = []
    for k in range(7):
        mapper.accumulate_chunk(*(torch.tensor(a[k:k + 1])
                                  for a in (pts, mask, poses)))
        counts.append(len(reads))
    # Scans 0-3 fit by the bound; scan 4 reads and compacts (the cursor
    # is at capacity), and so on.
    assert counts[:4] == [0, 0, 0, 0], counts
    assert counts[4] >= 2, counts
    monkeypatch.undo()
    jm = jdm.accumulate_scans(jdm.init_map(4 * N_PTS), *(
        jnp.asarray(a) for a in (pts, mask, poses)), jax_map_config(cfg))
    assert_same_map(mapper.local, jm)


@pytest.mark.parametrize('distant_capacity', [0, 100],
                         ids=['distant-roomy', 'distant-full'])
def test_filter_separate_and_rigidify_match_jax(rng, distant_capacity):
    cfg = map_config(distance_to_consider_fixed=12.0, voxel_size_m=1.0,
                     minimum_point_number_per_voxel=2)
    jcfg_ = jax_map_config(cfg)
    pts, mask, poses = scans(rng, 6)
    jm = jdm.accumulate_scans(jdm.init_map(4096), *(
        jnp.asarray(a) for a in (pts, mask, poses)), jcfg_)
    local = as_torch(jm)
    D = distant_capacity or 4096
    jd, td = jdm.init_map(D), tdm.init_map(D, device='cpu')
    center = np.array([1.0, -2.0, 0.5], np.float32)
    for _ in range(2):
        jl, jd = jdm.filter_and_separate(jm, jd, jnp.asarray(center), jcfg_)
        tl, td = tdm.filter_and_separate(local, td, center, cfg)
        assert_same_map(tl, jl, exact_rows=False)
        assert_same_map(td, jd, exact_rows=False)
        jm, local = jl, tl
        center = center + 5.0
    assert int(td.cursor) == D if distant_capacity else int(td.cursor) > 0
    T = np.asarray(jse3.exp(jnp.asarray([0.1, -0.2, 0.3, 1, 2, 3],
                                        jnp.float32)))
    assert_same_map(tdm.rigidify(td, torch.tensor(T)),
                    jdm.rigidify(jd, jnp.asarray(T)), exact_rows=False)


def est_config(**lt):
    return EstimatorConfig(
        laser_track=LaserTrackConfig(
            nscan_in_sub_map=3,
            odometry_noise_model=(0.02,) * 3 + (0.05,) * 3,
            icp_noise_model=(0.01,) * 6,
            input_filters=InputFilterConfig(scan_capacity=2048),
            icp=IcpConfig(matcher='brute', reading_capacity=1024,
                          reading_sampling_ratio=1.0), **lt),
        solver=SolverConfig(gn_iterations=2, pcg_iterations=30))


def test_runner_map_accumulate_filter_rigidify():
    """tests/test_online.py:348 on the port: the runner's map mirrors the
    host worker's getFilteredMap (laser_slam_worker.cpp:415-488,
    522-540)."""
    cfg = map_config(local_map_capacity=1 << 14,
                     distance_to_consider_fixed=5.0, voxel_size_m=0.2)
    runner = ton.OnlineRunner(est_config(), pose_capacity=64,
                              factor_capacity=256, map_config=cfg,
                              device='cpu')
    frames = list(trep.SyntheticStream(
        n_scans=5, points_per_scan=2048, trajectory='line', step_m=0.6,
        noise_m=0.003, odom_noise=0.005, seed=43))
    for f in frames:
        runner.process_scan(f.time_ns, f.points, f.odom_pose7)
    assert len(runner.mapper.local_points()) > 1000
    center = runner.trajectory()[frames[-1].time_ns][4:]
    runner.mapper.refresh(center)
    local = runner.mapper.local_points()
    d = np.linalg.norm(local[:, :2] - center[None, :2], axis=1)
    assert len(local) > 0 and d.max() <= 5.0 + 1e-3
    full = runner.mapper.full_map()
    assert len(full) > len(local)
    runner.mapper.rigidify(np.asarray([1, 0, 0, 0, 2.0, 0, 0], np.float32))
    np.testing.assert_allclose(runner.mapper.full_map() - full,
                               np.tile([2.0, 0, 0], (len(full), 1)),
                               atol=1e-4)


def test_chunked_mapper_matches_sequential():
    """tests/test_online.py:577: online_chunk(return_scans=True) feeding
    accumulate_chunk gives the per-scan map, bit-equal."""
    cfg = map_config(local_map_capacity=1 << 14, voxel_size_m=0.2)
    frames = list(trep.SyntheticStream(
        n_scans=7, points_per_scan=1024, trajectory='line', step_m=0.5,
        noise_m=0.004, odom_noise=0.004, seed=33))
    runners = [ton.OnlineRunner(est_config(), pose_capacity=32,
                                factor_capacity=128, map_config=cfg,
                                device='cpu') for _ in range(2)]
    for f in frames:
        runners[0].process_scan(f.time_ns, f.points, f.odom_pose7)
    assert runners[1].process_scans(frames, chunk_size=3) == 7
    a, b = (r.mapper.local for r in runners)
    assert torch.equal(runners[0].state.traj_poses,
                       runners[1].state.traj_poses)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(a.cursor) == 7 * 2048     # one stored scan's rows each


def test_link_rigidifies_each_track_by_its_own_correction():
    """Two forced-prior tracks with a map each: after the link, each
    track's full map is its map before, moved by that track's own
    new_last * old_last^-1 (within 1 mm); the absorbed track's map moved
    by ~100 m."""
    cfg = map_config(local_map_capacity=1 << 14, voxel_size_m=0.2)
    runner = ton.OnlineRunner(est_config(force_priors=True),
                              pose_capacity=32, factor_capacity=128,
                              n_tracks=2, map_config=cfg, device='cpu')
    streams = [list(trep.SyntheticStream(
        n_scans=5, points_per_scan=1024, trajectory='circle', radius_m=4.0,
        noise_m=0.005, odom_noise=0.01, seed=60 + t)) for t in range(2)]
    for i in range(5):
        for t in range(2):
            f = streams[t][i]
            runner.process_scan(f.time_ns + t, f.points, f.odom_pose7,
                                track_id=t)
    before = [runner.mapper.full_map(t) for t in range(2)]
    lasts = runner.state.traj_poses[runner.state.track_last_key.long()]
    ka, kb = 4, 5
    poses = ton.extract_trajectory(runner.state)
    rel = se3.compose(se3.inverse(torch.tensor(streams[0][2].gt_pose7)),
                      torch.tensor(streams[1][2].gt_pose7))
    w_T = se3.compose(torch.tensor(poses[ka]), se3.compose(
        rel, se3.inverse(torch.tensor(poses[kb]))))
    assert runner.add_loop_closure(ka, kb, w_T.numpy())
    new = runner.state.traj_poses[runner.state.track_last_key.long()]
    moved = []
    for t in range(2):
        C = se3.compose(new[t], se3.inverse(lasts[t]))
        want = se3.apply(C, torch.tensor(before[t])).numpy()
        np.testing.assert_allclose(runner.mapper.full_map(t), want,
                                   atol=1e-3)
        moved.append(np.linalg.norm(want - before[t], axis=1).mean())
    assert moved[0] < 1.0 and 90.0 < moved[1] < 110.0, moved


def test_device_map_defaults_to_the_card():
    import inspect
    for fn in (tdm.init_map, tdm.DeviceMapper):
        assert inspect.signature(fn).parameters['device'].default == 'cuda'
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdm.DeviceMapper(WorkerConfig(local_map_capacity=8))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tdm.init_map(8)
