"""The port's host API (LaserTrack, IncrementalEstimator, LaserSlamWorker)
against the JAX package's.

Both sides take the same frames (the JAX package's SyntheticStream) and
``slice1_config`` at small capacities, so ICP matches through the K2
matcher (its plain version here, the Pallas kernel in interpret mode on
the JAX side).  Tolerances: trajectories within 1 mm / 0.01 degree per
pose (the slice-1 bound; the measured gap is ~2.5e-7 m); the
interpolated trajectory within 1e-6; the host graph, its upload and its
off-chain count exact; map rows within 1e-5 m with counts exact, voxel
outputs of one map buffer as equal sorted sets; exports byte for byte.
The JAX runs are shared through module fixtures.
"""

import dataclasses
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_slam_tpu import config as jcfg
from laser_slam_tpu.core import csvio as jcsvio
from laser_slam_tpu.core.estimator import IncrementalEstimator as JEstimator
from laser_slam_tpu.core.trajectory import SE3Trajectory as JTrajectory
from laser_slam_tpu.core.types import Pose as JPose
from laser_slam_tpu.core.types import RelativePose as JRelativePose
from laser_slam_tpu.graph import factors as jfg
from laser_slam_tpu.ops import se3 as jse3
from laser_slam_tpu.pipeline import replay as jrep
from laser_slam_tpu.pipeline.worker import LaserSlamWorker as JWorker
from laser_slam_tpu_torch.config import Config, WorkerConfig, slice1_config
from laser_slam_tpu_torch.core import checkpoint as tck
from laser_slam_tpu_torch.core import csvio
from laser_slam_tpu_torch.core.estimator import IncrementalEstimator
from laser_slam_tpu_torch.core.laser_track import LaserTrack
from laser_slam_tpu_torch.core.trajectory import SE3Trajectory
from laser_slam_tpu_torch.core.types import Pose, RelativePose
from laser_slam_tpu_torch.graph import factors as fg
from laser_slam_tpu_torch.graph import solver as sv
from laser_slam_tpu_torch.pipeline import replay
from laser_slam_tpu_torch.pipeline.worker import LaserSlamWorker

torch.set_num_threads(2)
N_SCANS, N_POINTS = 8, 1024
TRANS_TOL_M, ROT_TOL_DEG = 1e-3, 0.01
MAP_CAP = 1 << 15


def small_config(**track):
    cfg = slice1_config(scan_capacity=N_POINTS, reading_capacity=512,
                        nscan_in_sub_map=3)
    cfg = dataclasses.replace(
        cfg, loop_closures_sub_maps_radius=1,
        solver=dataclasses.replace(cfg.solver, pose_capacity=16,
                                   factor_capacity=64))
    if track:
        cfg = dataclasses.replace(cfg, laser_track=dataclasses.replace(
            cfg.laser_track, **track))
    return cfg


def worker_config(**kw):
    return WorkerConfig(**dict(dict(minimum_distance_to_add_pose=0.3,
                                    local_map_capacity=MAP_CAP,
                                    distance_to_consider_fixed=3.0), **kw))


def to_jax(cfg):
    return jcfg._from_dict(getattr(jcfg, type(cfg).__name__),
                           dataclasses.asdict(cfg))


def frames(n=N_SCANS, seed=7):
    return list(jrep.SyntheticStream(
        n_scans=n, points_per_scan=N_POINTS, trajectory='line', step_m=0.5,
        noise_m=0.005, odom_noise=0.002, seed=seed))


def with_repeat(fs, k):
    """The frames with frame k repeated 50 ms later: the distance gate
    must drop the copy."""
    rep = dataclasses.replace(fs[k], time_ns=fs[k].time_ns + 50_000_000)
    return fs[:k + 1] + [rep] + fs[k + 1:]


def gt_alignment(fs, traj, i, j):
    """World-frame alignment of frames i and j from their true relative
    pose and the live estimates (tests/test_parity.py::measured_closure)."""
    rel = jse3.compose(jse3.inverse(jnp.asarray(fs[i].gt_pose7)),
                       jnp.asarray(fs[j].gt_pose7))
    T_a = jnp.asarray(traj[fs[i].time_ns])
    T_b = jnp.asarray(traj[fs[j].time_ns])
    return np.asarray(jse3.compose(T_a, jse3.compose(rel, jse3.inverse(T_b))),
                      np.float32)


def rot_deg(q1, q2):
    """Angle of q1^-1 q2 in degrees, by atan2 (arccos of the dot product
    reads the f32 quaternions' norm error as ~0.03 degrees)."""
    w = q1[:, 0] * q2[:, 0] + np.sum(q1[:, 1:] * q2[:, 1:], axis=1)
    v = (q1[:, :1] * q2[:, 1:] - q2[:, :1] * q1[:, 1:]
         - np.cross(q1[:, 1:], q2[:, 1:]))
    return np.degrees(2 * np.arctan2(np.linalg.norm(v, axis=1), np.abs(w)))


def assert_same_trajectory(jtraj, ttraj, trans=TRANS_TOL_M, rot=ROT_TOL_DEG):
    assert list(jtraj) == list(ttraj)
    a = np.stack(list(jtraj.values())).astype(np.float64)
    b = np.stack(list(ttraj.values())).astype(np.float64)
    assert np.all(np.isfinite(b))
    assert np.linalg.norm(a[:, 4:] - b[:, 4:], axis=1).max() < trans
    assert rot_deg(a[:, :4], b[:, :4]).max() < rot


def run_single(est_cls, worker_cls, cfg, wcfg, fs, **est_kw):
    """One worker over the frames, the distance gate included, then the
    map filter and a refined closure of the first and last frames with
    the map re-rigidified.  Returns (worker, accepted, state at the
    closure)."""
    est = est_cls(cfg, 1, **est_kw)
    w = worker_cls(wcfg, est, 0)
    accepted = [w.process_scan(f.time_ns, f.points, f.odom_pose7)
                for f in fs]
    before = dict(map_points=w._map_points[:w._map_count].copy(),
                  traj=w.get_trajectory())
    w.get_filtered_map()
    before['near'] = w._map_points[:w._map_count].copy()
    before['distant'] = w._distant_points.copy()
    t_last = fs[-1].time_ns
    last_before = w.laser_track.evaluate(t_last)
    w_T = gt_alignment(fs, w.get_trajectory(), 0, len(fs) - 1)
    rel_cls = JRelativePose if est_cls is JEstimator else RelativePose
    est.process_loop_closure(rel_cls(T_a_b=w_T, time_a_ns=fs[0].time_ns,
                                     time_b_ns=t_last))
    w.update_local_map(last_before, t_last)
    return w, accepted, before


@pytest.fixture(scope='module')
def jax_single():
    fs = with_repeat(frames(), 3)
    cfg = small_config()
    w, accepted, before = run_single(JEstimator, JWorker, to_jax(cfg),
                                     to_jax(worker_config()), fs)
    covs = w.estimator.marginal_covariances([0, 3, N_SCANS - 1])
    return fs, w, accepted, before, covs


@pytest.fixture(scope='module')
def port_single(jax_single):
    fs = jax_single[0]
    w, accepted, before = run_single(IncrementalEstimator, LaserSlamWorker,
                                     small_config(), worker_config(), fs,
                                     device='cpu')
    return w, accepted, before


def test_trajectory_evaluate_matches_jax():
    rng = np.random.default_rng(3)
    jt, tt = JTrajectory(capacity=2), SE3Trajectory(capacity=2)
    for k in range(6):
        xi = rng.normal(0, 0.5, 6).astype(np.float32)
        pose = np.asarray(jse3.exp(jnp.asarray(xi)))
        jt.extend(1000 * k, pose, 10 + k)
        tt.extend(1000 * k, pose, 10 + k)
    for t in (-5, 0, 1, 250, 999, 1000, 2500, 4999, 5000, 6000):
        np.testing.assert_allclose(tt.evaluate(t), jt.evaluate(t), atol=1e-6)
    assert tt.key_at(3000) == jt.key_at(3000) == 13
    np.testing.assert_array_equal(tt.times(), jt.times())
    with pytest.raises(ValueError):
        tt.extend(5000, pose, 99)


def test_host_graph_growth_removal_and_upload_match_jax():
    rng = np.random.default_rng(4)
    jg, tg = jfg.HostGraph(4, 2), fg.HostGraph(4, 2)
    for k in range(11):
        a, b = (k, k + 1) if k % 4 else (0, k + 2)
        T = np.asarray(jse3.exp(jnp.asarray(
            rng.normal(0, 0.3, 6).astype(np.float32))))
        sig = rng.uniform(0.01, 0.1, 6).astype(np.float32)
        for g in (jg, tg):
            assert g.add_relative(a, b, T, sig, robust=bool(k % 2),
                                  fixed_a=k == 5) == k
    for k in range(5):
        for g in (jg, tg):
            g.add_prior(2 * k, np.asarray(jse3.identity()),
                        np.full(6, 1e-7 if k < 3 else 0.1, np.float32))
    for g in (jg, tg):
        g.remove_prior(1)
        g.remove_relative(7)
    want, got = jg.to_device(), tg.to_device(device='cpu')
    for name in jfg.FactorGraphData._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    e = fg.empty_graph(8, 4, device='cpu')
    for name, leaf in jfg.empty_graph(8, 4)._asdict().items():
        np.testing.assert_array_equal(getattr(e, name).numpy(),
                                      np.asarray(leaf))
    # The host count is the solver's own count of off-chain factors.
    poses = torch.from_numpy(np.asarray(jnp.broadcast_to(
        jse3.identity(), (16, 7))).copy())
    lin = sv._linearize(got, poses, torch.ones(16, dtype=torch.bool), 1.0)
    assert tg.offchain_count() == int(sv._offchain_mask(lin).sum()) > 0


def test_single_track_matches_jax(jax_single, port_single):
    """One track with ICP (K2's matcher) through the worker, the distance
    gate, then a refined loop closure of the first and last scans."""
    fs, jw, jaccepted, jbefore, _ = jax_single
    tw, taccepted, tbefore = port_single
    assert taccepted == jaccepted and taccepted.count(False) == 1
    assert_same_trajectory(jbefore['traj'], tbefore['traj'])
    assert_same_trajectory(jw.get_trajectory(), tw.get_trajectory())
    jt, tt = jw.laser_track, tw.laser_track
    assert len(tt.icp_transformations) == len(jt.icp_transformations) == 7
    assert len(tt.loop_closures) == len(jt.loop_closures) == 1
    np.testing.assert_allclose(tt.loop_closures[0].T_a_b,
                               jt.loop_closures[0].T_a_b, atol=1e-4)
    # The closure moved the trajectory (the refinement ran).
    assert not np.allclose(np.stack(list(tbefore['traj'].values())),
                           np.stack(list(tw.get_trajectory().values())))
    je, te = jw.estimator, tw.estimator
    assert (te.graph.n_rel, te.graph.n_prior) == (je.graph.n_rel,
                                                  je.graph.n_prior)
    np.testing.assert_array_equal(te.graph.rel_keys, je.graph.rel_keys)
    assert te.last_result.num_variables == je.last_result.num_variables
    np.testing.assert_allclose(te.last_result.final_error,
                               je.last_result.final_error, rtol=1e-2,
                               atol=1e-4)


def test_covariances_match_jax(jax_single, port_single):
    covs = port_single[0].estimator.marginal_covariances([0, 3, N_SCANS - 1])
    np.testing.assert_allclose(covs, jax_single[4], rtol=1e-3, atol=1e-12)


def test_worker_maps_match_jax(jax_single, port_single):
    """The accumulated map row by row, the near/far split and the closure's
    re-rigidification; the voxel filter on one map buffer as sets."""
    _, jw, _, jbefore, _ = jax_single
    tw, _, tbefore = port_single
    for key in ('map_points', 'near', 'distant'):
        assert tbefore[key].shape == jbefore[key].shape, key
        np.testing.assert_allclose(tbefore[key], jbefore[key], atol=1e-5)
    assert tw._map_count == jw._map_count
    np.testing.assert_allclose(tw._map_points[:tw._map_count],
                               jw._map_points[:jw._map_count], atol=1e-5)
    np.testing.assert_allclose(tw._distant_points, jw._distant_points,
                               atol=1e-5)
    # One buffer, one pose: the voxel outputs are the same set.
    wcfg = worker_config(voxel_size_m=0.25, minimum_point_number_per_voxel=2)
    est = IncrementalEstimator(small_config(), 1, device='cpu')
    probe = LaserSlamWorker(wcfg, est, 0)
    jprobe = JWorker(to_jax(wcfg), JEstimator(to_jax(small_config()), 1), 0)
    for w in (probe, jprobe):
        w.laser_track.trajectory.extend(0, jw.laser_track.evaluate(
            jw.laser_track.get_max_time()), 0)
        w._map_points[:jbefore['map_points'].shape[0]] = jbefore['map_points']
        w._map_count = jbefore['map_points'].shape[0]
    got, want = probe.get_filtered_map(), jprobe.get_filtered_map()
    assert got.shape == want.shape
    assert 0 < len(got) < jbefore['map_points'].shape[0]
    np.testing.assert_array_equal(got[np.lexsort(got.T)],
                                  want[np.lexsort(want.T)])
    assert probe._map_count == jprobe._map_count
    assert len(probe._distant_points) == len(jprobe._distant_points)


def test_exports_byte_for_byte(jax_single, port_single, tmp_path):
    """KITTI, TUM, CSV and the trajectory head of one trajectory (JAX's,
    set into the port's track) are the same bytes."""
    _, jw, _, _, _ = jax_single
    tw = port_single[0]
    n = jw.laser_track.trajectory.size
    tw.laser_track.trajectory._poses[:n] = jw.laser_track.trajectory._poses[:n]
    for name in ('export_trajectory', 'export_trajectory_kitti',
                 'export_trajectory_tum'):
        paths = [os.path.join(tmp_path, f'{name}_{side}.txt')
                 for side in ('jax', 'port')]
        getattr(jw, name)(paths[0])
        getattr(tw, name)(paths[1])
        with open(paths[0], 'rb') as a, open(paths[1], 'rb') as b:
            assert a.read() == b.read(), name
    paths = [os.path.join(tmp_path, f'head_{side}.csv') for side in 'jt']
    jw.export_trajectory_head(2_000_000_000, paths[0])
    tw.export_trajectory_head(2_000_000_000, paths[1])
    with open(paths[0], 'rb') as a, open(paths[1], 'rb') as b:
        assert a.read() == b.read()
    data = tw.get_laser_tracks_data()
    assert [d[0] for d in data] == [d[0] for d in jw.get_laser_tracks_data()]
    # The writers alone, on random poses.
    rng = np.random.default_rng(5)
    tp = [(int(1e9 * i), np.asarray(jse3.exp(jnp.asarray(
        rng.normal(0, 0.4, 6).astype(np.float32))))) for i in range(5)]
    for writer in ('write_trajectory_kitti', 'write_trajectory_tum'):
        paths = [os.path.join(tmp_path, f'{writer}_{s}') for s in 'jt']
        getattr(jcsvio, writer)(tp, paths[0])
        getattr(csvio, writer)(tp, paths[1])
        with open(paths[0], 'rb') as a, open(paths[1], 'rb') as b:
            assert a.read() == b.read(), writer


def test_csv_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    m = rng.normal(size=(4, 3))
    for mod, side in ((jcsvio, 'j'), (csvio, 't')):
        mod.write_matrix_csv(m, os.path.join(tmp_path, f'm_{side}.csv'))
        mod.write_csv([['a', 'b'], ['1', '2']],
                      os.path.join(tmp_path, f's_{side}.csv'))
    for name in ('m', 's'):
        with open(os.path.join(tmp_path, f'{name}_j.csv'), 'rb') as a, \
                open(os.path.join(tmp_path, f'{name}_t.csv'), 'rb') as b:
            assert a.read() == b.read()
    np.testing.assert_array_equal(
        csvio.load_matrix_csv(os.path.join(tmp_path, 'm_j.csv')),
        jcsvio.load_matrix_csv(os.path.join(tmp_path, 'm_j.csv')))
    assert csvio.load_csv(os.path.join(tmp_path, 's_j.csv')) == [
        ['a', 'b'], ['1', '2']]
    np.testing.assert_array_equal(
        csvio.time_value_map_to_matrix({10: 1.5, 5: 0.5}),
        jcsvio.time_value_map_to_matrix({10: 1.5, 5: 0.5}))


def test_odometry_free_mode_matches_jax():
    fs = [dataclasses.replace(f, odom_pose7=None) for f in frames(6)]
    wcfg = worker_config(use_odometry_information=False,
                         minimum_distance_to_add_pose=0.0,
                         create_filtered_map=False)
    trajs = []
    for est, w_cls, cfg, kw in (
            (JEstimator, JWorker, to_jax, {}),
            (IncrementalEstimator, LaserSlamWorker, lambda c: c,
             dict(device='cpu'))):
        e = est(cfg(small_config()), 1, **kw)
        w = w_cls(cfg(wcfg), e, 0)
        assert replay.run_worker_on_stream(w, fs) == len(fs)
        trajs.append((w.get_trajectory(), w.get_odometry_trajectory()))
    (jtraj, jodom), (ttraj, todom) = trajs
    assert_same_trajectory(jtraj, ttraj)
    # The constant-velocity guesses fed to the track as its odometry.
    assert_same_trajectory(jodom, todom)


def test_two_tracks_link_as_jax():
    """Two forced-prior tracks 100 m apart, registered by register_prior;
    a cross-track closure links them through estimate_and_remove, which
    drops track 1's prior (tests/test_track_estimator.py:139)."""
    fs = frames(4)
    results = []
    for est_cls, pose_cls, rel_cls, cfg, kw in (
            (JEstimator, JPose, JRelativePose, to_jax, {}),
            (IncrementalEstimator, Pose, RelativePose, lambda c: c,
             dict(device='cpu'))):
        est = est_cls(cfg(small_config(force_priors=True)), 2, **kw)
        for wid in range(2):
            track = est.get_laser_track(wid)
            for f in fs:
                factors, values, is_prior = \
                    track.process_pose_and_laser_scan(
                        pose_cls(T_w=f.odom_pose7, time_ns=f.time_ns),
                        f.points)
                result = (est.register_prior(factors, values, wid)
                          if is_prior else est.estimate(factors, values))
                track.update_from_values(result)
        t0, t1 = est.get_laser_track(0), est.get_laser_track(1)
        assert abs(t1.get_trajectory()[0][5] - 100.0) < 1.0
        t_meet = fs[2].time_ns
        w_T = np.asarray(jse3.compose(
            jnp.asarray(t0.evaluate(t_meet)),
            jse3.inverse(jnp.asarray(t1.evaluate(t_meet)))))
        est.process_loop_closure(rel_cls(T_a_b=w_T, time_a_ns=t_meet,
                                         time_b_ns=t_meet, track_id_a=0,
                                         track_id_b=1))
        assert est._prior_factor_of_worker == {}
        assert [sorted(g) for g in est._linked_workers] == [[0, 1]]
        assert est.graph.prior_weight[1] == 0.0
        results.append([t.get_trajectory() for t in (t0, t1)])
    for jtraj, ttraj in zip(*results):
        assert_same_trajectory(jtraj, ttraj)
    pa, pb = (results[1][k][fs[2].time_ns][4:] for k in (0, 1))
    assert np.linalg.norm(pa - pb) < 0.05


def test_save_icp_results_dumps_the_icp_clouds(tmp_path, monkeypatch):
    """save_icp_results writes the scan before and after ICP as .xyz
    under the temporary directory (laser_track.cpp:504-513)."""
    import tempfile
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    est = IncrementalEstimator(small_config(save_icp_results=True), 1,
                               device='cpu')
    w = LaserSlamWorker(worker_config(create_filtered_map=False), est)
    assert replay.run_worker_on_stream(w, frames(2)) == 2
    out = os.path.join(tmp_path, 'laser_slam_tpu_icp')
    for name in ('last_scan', 'last_scan_aligned_by_initial_guess',
                 'last_scan_aligned_by_solution'):
        pts = np.loadtxt(os.path.join(out, name + '.xyz'))
        assert pts.shape == (N_POINTS, 3)


def test_npz_stream_roundtrip_matches_jax(tmp_path):
    fs = frames(3)
    fs[1] = dataclasses.replace(fs[1], odom_pose7=None)
    path = os.path.join(tmp_path, 'stream.npz')
    replay.save_npz_stream(fs, path)
    got, want = replay.load_npz_stream(path), jrep.load_npz_stream(path)
    for g, w in zip(got, want):
        assert g.time_ns == w.time_ns
        assert (g.odom_pose7 is None) == (w.odom_pose7 is None)
        np.testing.assert_array_equal(g.points, w.points)
        np.testing.assert_array_equal(g.gt_pose7, w.gt_pose7)


def test_entry_points_default_to_the_card(tmp_path):
    for fn in (IncrementalEstimator, LaserTrack, tck.load_checkpoint,
               tck.load_online_checkpoint):
        assert inspect.signature(fn).parameters['device'].default == 'cuda'
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IncrementalEstimator(small_config(), 1)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        LaserTrack(small_config().laser_track, 0, lambda: 0)
    est = IncrementalEstimator(small_config(), 1, device='cpu')
    path = os.path.join(tmp_path, 'est.npz')
    tck.save_checkpoint(path, est)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tck.load_checkpoint(path, Config(estimator=small_config(),
                                         worker=worker_config()))
