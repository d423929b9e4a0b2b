"""Checkpoints of the port (core/checkpoint.py) against the JAX package's.

* The port's own resume is bit-identical to the uninterrupted run, for
  the host API's estimator and worker and for an ``OnlineRunner``, with
  sampling ratios below 1 (the generators' states round-trip).
* Files cross in both directions: a file the JAX package wrote resumes in
  the port, a file the port wrote resumes in the JAX package, and each
  resumed run matches the other package's within the stream tolerance
  (1 mm / 0.01 degree a pose, sampling 1.0 on both sides).
* An online file in the older layout of the same format version (an
  archive without its per-track index, single-map ``ml_``/``md_`` keys)
  loads in both packages with the same archive index and maps, and the
  two resumed runs agree within the stream tolerance.
* A two-track runner with device maps and a scan archive keeps its
  groups, prior slots, archive and maps, and links its tracks after the
  resume exactly as without it.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from laser_slam_tpu import config as jcfg
from laser_slam_tpu.core import checkpoint as jck
from laser_slam_tpu.core.estimator import IncrementalEstimator as JEstimator
from laser_slam_tpu.pipeline import online as jon
from laser_slam_tpu.pipeline import replay as jrep
from laser_slam_tpu.pipeline.worker import LaserSlamWorker as JWorker
from laser_slam_tpu_torch.config import Config, WorkerConfig, slice1_config
from laser_slam_tpu_torch.core import checkpoint as tck
from laser_slam_tpu_torch.core.estimator import IncrementalEstimator
from laser_slam_tpu_torch.pipeline import online as ton
from laser_slam_tpu_torch.pipeline.worker import LaserSlamWorker

torch.set_num_threads(2)
N_SCANS, N_POINTS, SPLIT = 8, 1024, 4
TRANS_TOL_M, ROT_TOL_DEG = 1e-3, 0.01
CAPS = dict(pose_capacity=16, factor_capacity=64)
# JAX's resumed runner has no packed-ingest fields, which its growth
# prefetch reads once half the pose table is used (ROADMAP queue 3): the
# runners that JAX resumes keep below that.
CROSSED_CAPS = dict(pose_capacity=32, factor_capacity=64)


def small_config(sampling=1.0):
    cfg = slice1_config(scan_capacity=N_POINTS, reading_capacity=512,
                        nscan_in_sub_map=3)
    lt = cfg.laser_track
    return dataclasses.replace(
        cfg, loop_closures_sub_maps_radius=1,
        solver=dataclasses.replace(cfg.solver, pose_capacity=16,
                                   factor_capacity=64),
        laser_track=dataclasses.replace(
            lt, input_filters=dataclasses.replace(
                lt.input_filters, random_sampling_ratio=min(1.0,
                                                            sampling + 0.2)),
            icp=dataclasses.replace(lt.icp,
                                    reading_sampling_ratio=sampling)))


def config(sampling=1.0):
    return Config(estimator=small_config(sampling),
                  worker=WorkerConfig(minimum_distance_to_add_pose=0.3,
                                      local_map_capacity=1 << 15,
                                      distance_to_consider_fixed=3.0))


def to_jax(cfg):
    return jcfg._from_dict(getattr(jcfg, type(cfg).__name__),
                           dataclasses.asdict(cfg))


def frames(n=N_SCANS, seed=21, **kw):
    return list(jrep.SyntheticStream(
        n_scans=n, points_per_scan=N_POINTS, trajectory='line', step_m=0.5,
        noise_m=0.005, odom_noise=0.002, seed=seed, **kw))


def feed(worker, fs):
    for f in fs:
        worker.process_scan(f.time_ns, f.points, f.odom_pose7)
    return worker


def feed_runner(runner, fs, **kw):
    for f in fs:
        runner.process_scan(f.time_ns, f.points, f.odom_pose7, **kw)
    return runner


def rot_deg(q1, q2):
    """Angle of q1^-1 q2 in degrees (atan2, robust at tiny angles)."""
    w = q1[:, 0] * q2[:, 0] + np.sum(q1[:, 1:] * q2[:, 1:], axis=1)
    v = (q1[:, :1] * q2[:, 1:] - q2[:, :1] * q1[:, 1:]
         - np.cross(q1[:, 1:], q2[:, 1:]))
    return np.degrees(2 * np.arctan2(np.linalg.norm(v, axis=1), np.abs(w)))


def assert_close_trajectory(a, b):
    assert list(a) == list(b)
    a = np.stack(list(a.values())).astype(np.float64)
    b = np.stack(list(b.values())).astype(np.float64)
    assert np.all(np.isfinite(b))
    assert np.linalg.norm(a[:, 4:] - b[:, 4:], axis=1).max() < TRANS_TOL_M
    assert rot_deg(a[:, :4], b[:, :4]).max() < ROT_TOL_DEG


def assert_equal_trajectory(a, b):
    assert list(a) == list(b)
    for t in a:
        np.testing.assert_array_equal(a[t], b[t])


def assert_same_estimator(a, b):
    """Every host array and every scan of two estimators bit-equal."""
    np.testing.assert_array_equal(a.pose_values(), b.pose_values())
    for name in ('rel_meas', 'rel_keys', 'rel_sqrt_info', 'rel_robust',
                 'rel_fixed_a', 'rel_weight', 'prior_meas', 'prior_keys',
                 'prior_sqrt_info', 'prior_weight'):
        np.testing.assert_array_equal(getattr(a.graph, name)[:a.graph.n_rel],
                                      getattr(b.graph, name)[:b.graph.n_rel])
    for ta, tb in zip(a.laser_tracks, b.laser_tracks):
        assert_equal_trajectory(ta.get_trajectory(), tb.get_trajectory())
        np.testing.assert_array_equal(ta._ring_times, tb._ring_times)
        for name in ('_ring_points', '_ring_mask', '_ring_normals'):
            assert torch.equal(getattr(ta, name), getattr(tb, name))
        assert [s.key for s in ta.scans] == [s.key for s in tb.scans]
        for sa, sb in zip(ta.scans, tb.scans):
            assert torch.equal(sa.cloud.points, sb.cloud.points)
            assert torch.equal(sa.normals, sb.normals)
        assert torch.equal(ta.generator.get_state(), tb.generator.get_state())


def test_estimator_resume_is_bit_identical(tmp_path):
    """Save after 4 scans, load, 4 more: the same bits as 8 straight, with
    the input filter and the ICP reading sampled (ratios 0.8 and 0.6)."""
    cfg, fs = config(sampling=0.6), frames()
    est_a = IncrementalEstimator(cfg.estimator, 1, device='cpu')
    w_a = feed(LaserSlamWorker(cfg.worker, est_a, 0), fs)

    est_b = IncrementalEstimator(cfg.estimator, 1, device='cpu')
    w_b = feed(LaserSlamWorker(cfg.worker, est_b, 0), fs[:SPLIT])
    path = os.path.join(tmp_path, 'state.npz')
    tck.save_checkpoint(path, est_b, [w_b])
    est_c, (w_c,) = tck.load_checkpoint(path, cfg, device='cpu')
    assert_same_estimator(est_b, est_c)
    np.testing.assert_array_equal(w_c._map_points[:w_c._map_count],
                                  w_b._map_points[:w_b._map_count])
    feed(w_c, fs[SPLIT:])
    assert_same_estimator(est_a, est_c)
    np.testing.assert_array_equal(w_c._map_points[:w_c._map_count],
                                  w_a._map_points[:w_a._map_count])
    np.testing.assert_array_equal(w_c.world_to_odom, w_a.world_to_odom)
    # The sampling drew: a resume from a fresh generator differs.
    est_d, (w_d,) = tck.load_checkpoint(path, cfg, device='cpu')
    est_d.laser_tracks[0].generator.manual_seed(1234)
    feed(w_d, fs[SPLIT:])
    assert not np.array_equal(est_d.pose_values(), est_a.pose_values())


def test_online_resume_is_bit_identical(tmp_path):
    cfg, fs = small_config(sampling=0.6), frames(seed=22)
    closure = np.asarray([1, 0, 0, 0, 0, 0, 0], np.float32)
    run_a = feed_runner(ton.OnlineRunner(cfg, device='cpu', seed=5, **CAPS),
                        fs)
    run_a.add_loop_closure(0, N_SCANS - 1, closure)
    run_b = feed_runner(ton.OnlineRunner(cfg, device='cpu', seed=5, **CAPS),
                        fs[:SPLIT])
    path = os.path.join(tmp_path, 'online.npz')
    tck.save_online_checkpoint(path, run_b)
    run_c = tck.load_online_checkpoint(path, cfg, device='cpu')
    for name, value in ton.state_to_numpy(run_b.state).items():
        np.testing.assert_array_equal(ton.state_to_numpy(run_c.state)[name],
                                      value)
    for name in ('_n_offchain_host', '_prior_keys', '_last_key', 'key_info',
                 '_n_rel_host', 'seed'):
        assert getattr(run_c, name) == getattr(run_b, name), name
    feed_runner(run_c, fs[SPLIT:])
    run_c.add_loop_closure(0, N_SCANS - 1, closure)
    assert_equal_trajectory(run_a.trajectory(), run_c.trajectory())
    assert run_c._n_offchain_host == run_a._n_offchain_host


@pytest.fixture(scope='module')
def crossed(tmp_path_factory):
    """Each package saves after 4 scans; each loads both files and runs
    the last 4 scans from them."""
    tmp = tmp_path_factory.mktemp('crossed')
    cfg, fs = config(), frames()
    jc = jcfg.Config(estimator=to_jax(cfg.estimator),
                     worker=to_jax(cfg.worker))
    files = {k: os.path.join(tmp, f'{k}.npz') for k in ('jax', 'port')}
    est = JEstimator(jc.estimator, 1)
    jck.save_checkpoint(files['jax'], est, [feed(JWorker(jc.worker, est),
                                                 fs[:SPLIT])])
    est = IncrementalEstimator(cfg.estimator, 1, device='cpu')
    tck.save_checkpoint(files['port'], est, [feed(LaserSlamWorker(
        cfg.worker, est), fs[:SPLIT])])
    out = {}
    for side, load, c, kw in (('jax', jck.load_checkpoint, jc, {}),
                              ('port', tck.load_checkpoint, cfg,
                               dict(device='cpu'))):
        for src, path in files.items():
            est, (w,) = load(path, c, **kw)
            out[side, src] = (est, feed(w, fs[SPLIT:]).get_trajectory())
    # The online runner, the same way.
    jrun = feed_runner(jon.OnlineRunner(to_jax(cfg.estimator),
                                        **CROSSED_CAPS), fs[:SPLIT])
    trun = feed_runner(ton.OnlineRunner(cfg.estimator, device='cpu',
                                        **CROSSED_CAPS), fs[:SPLIT])
    ofiles = {k: os.path.join(tmp, f'online_{k}.npz') for k in files}
    jck.save_online_checkpoint(ofiles['jax'], jrun)
    tck.save_online_checkpoint(ofiles['port'], trun)
    for side, load, c, kw in (('jax', jck.load_online_checkpoint,
                               to_jax(cfg.estimator), {}),
                              ('port', tck.load_online_checkpoint,
                               cfg.estimator, dict(device='cpu'))):
        for src, path in ofiles.items():
            r = feed_runner(load(path, c, **kw), fs[SPLIT:])
            out['online', side, src] = (r, r.trajectory())
    return files, ofiles, out


def test_jax_checkpoint_resumes_in_port(crossed):
    """A file JAX's save_checkpoint wrote: the port's resumed run within
    the stream tolerance of JAX's own resumed run."""
    _, _, out = crossed
    assert_close_trajectory(out['jax', 'jax'][1], out['port', 'jax'][1])
    est_j, est_p = out['jax', 'jax'][0], out['port', 'jax'][0]
    assert (est_p.graph.n_rel, est_p.num_keys) == (est_j.graph.n_rel,
                                                   est_j.num_keys)


def test_port_checkpoint_loads_in_jax(crossed, tmp_path):
    """A file the port wrote loads in JAX's load_checkpoint with every
    array as saved, and JAX's resumed run stays within the stream
    tolerance of the port's."""
    files, _, out = crossed
    cfg = config()
    z = np.load(files['port'])
    est, (w,) = jck.load_checkpoint(
        files['port'], jcfg.Config(estimator=to_jax(cfg.estimator),
                                   worker=to_jax(cfg.worker)))
    np.testing.assert_array_equal(est.pose_values(), z['poses'])
    last = est.laser_tracks[0].scans[-1]
    np.testing.assert_array_equal(np.asarray(last.normals),
                                  z['t0_scan_normals'][-1])
    np.testing.assert_array_equal(w._map_points[:w._map_count],
                                  z['w0_map_points'])
    assert_close_trajectory(out['port', 'port'][1], out['jax', 'port'][1])


def test_jax_online_checkpoint_resumes_in_port(crossed):
    _, ofiles, out = crossed
    assert_close_trajectory(out['online', 'jax', 'jax'][1],
                            out['online', 'port', 'jax'][1])
    runner = out['online', 'port', 'jax'][0]
    jrunner = out['online', 'jax', 'jax'][0]
    assert runner._n_rel_host == jrunner._n_rel_host
    assert int(runner.state.n_rel) == int(jrunner.state.n_rel)
    # No generator state in JAX's file: seeded anew from its key.
    z = np.load(ofiles['jax'])
    assert 'generator_state' not in z
    assert runner.seed == int(z['s_rng_key'].reshape(-1)[-1])


def test_port_online_checkpoint_loads_in_jax(crossed):
    _, ofiles, out = crossed
    z = np.load(ofiles['port'])
    # JAX's loader takes the port's key data as a key of the runner's seed.
    import jax
    np.testing.assert_array_equal(
        z['s_rng_key'], np.asarray(jax.random.key_data(jax.random.key(0))))
    assert_close_trajectory(out['online', 'port', 'port'][1],
                            out['online', 'jax', 'port'][1])


def test_two_track_runner_keeps_groups_archive_and_maps(tmp_path):
    """Two forced-prior tracks with a map each and a scan archive
    (tests/test_checkpoint.py:125-153): after the round trip the groups,
    prior slots, archive and maps are the same, and linking the tracks
    gives the same bits as on the uninterrupted runner."""
    cfg = dataclasses.replace(small_config(), laser_track=dataclasses.replace(
        small_config().laser_track, force_priors=True))
    map_cfg = WorkerConfig(local_map_capacity=1 << 14, voxel_size_m=0.2)
    streams = [frames(3, seed=31), frames(3, seed=32)]
    runners = []
    for _ in range(2):
        r = ton.OnlineRunner(cfg, device='cpu', n_tracks=2,
                             archive_points=512, map_config=map_cfg, **CAPS)
        for f0, f1 in zip(*streams):
            r.process_scan(f0.time_ns, f0.points, f0.odom_pose7, track_id=0)
            r.process_scan(f1.time_ns, f1.points, f1.odom_pose7, track_id=1)
        runners.append(r)
    path = os.path.join(tmp_path, 'online2.npz')
    tck.save_online_checkpoint(path, runners[1])
    r2 = tck.load_online_checkpoint(path, cfg, map_config=map_cfg,
                                    device='cpu')
    r = runners[0]
    assert r2._linked_groups == r._linked_groups == [[0], [1]]
    assert r2._prior_slot_of_track == r._prior_slot_of_track == {1: 1}
    assert r2._tracks_seen == r._tracks_seen
    assert r2._n_offchain_host == r._n_offchain_host
    for name, value in ton.archive_to_numpy(r.archive).items():
        np.testing.assert_array_equal(
            ton.archive_to_numpy(r2.archive)[name], value)
    for t in range(2):
        np.testing.assert_array_equal(r2.mapper.full_map(t),
                                      r.mapper.full_map(t))
        assert r2.mapper._cursor_bound[t] == int(r.mapper.local_maps[t]
                                                 .cursor)
    with pytest.raises(ValueError, match='map_config'):
        tck.load_online_checkpoint(path, cfg, device='cpu')
    # Link the tracks after the resume (a refined closure through the
    # archive), as on the uninterrupted runner.
    w_T = np.asarray([1, 0, 0, 0, 0, -100.0, 0], np.float32)
    for runner in (r, r2):
        runner.add_loop_closure(0, 1, w_T)
        assert runner._linked_groups == [[0, 1]]
        assert runner._prior_slot_of_track == {}
    assert_equal_trajectory(r.trajectory(), r2.trajectory())
    for t in range(2):
        np.testing.assert_array_equal(r2.mapper.full_map(t),
                                      r.mapper.full_map(t))


def legacy_layout(src, dst):
    """JAX's online file rewritten in the older layout that JAX's loader
    still reads (laser_slam_tpu/core/checkpoint.py:144-160, :166,
    :178-181): no per-track archive index, single-map ``ml_``/``md_``
    keys and no map track count."""
    dropped = ('a_track_pos', 'a_track_keys', 'a_track_count',
               'mapper_n_tracks')
    with np.load(src) as z:
        d = {k: z[k] for k in z.files if k not in dropped}
    for k in list(d):
        for old, new in (('ml0_', 'ml_'), ('md0_', 'md_')):
            if k.startswith(old):
                d[new + k[len(old):]] = d.pop(k)
    np.savez(dst, **d)


def test_legacy_online_checkpoint_resumes_in_both(tmp_path):
    """A file JAX saved, in the older layout: both loaders rebuild the
    same archive index and track-0 maps, and the resumed runs stay within
    the stream tolerance of each other."""
    cfg = small_config()
    map_cfg = WorkerConfig(local_map_capacity=1 << 14, voxel_size_m=0.2)
    fs = frames()
    jrun = feed_runner(jon.OnlineRunner(
        to_jax(cfg), archive_points=512, map_config=to_jax(map_cfg),
        **CROSSED_CAPS), fs[:SPLIT])
    src = os.path.join(tmp_path, 'online.npz')
    legacy = os.path.join(tmp_path, 'legacy.npz')
    jck.save_online_checkpoint(src, jrun)
    legacy_layout(src, legacy)
    with np.load(legacy) as z:
        assert 'ml_points' in z and 'ml0_points' not in z
        assert 'a_points' in z and 'a_track_pos' not in z
    j = jck.load_online_checkpoint(legacy, to_jax(cfg),
                                   map_config=to_jax(map_cfg))
    t = tck.load_online_checkpoint(legacy, cfg, map_config=map_cfg,
                                   device='cpu')
    for name in ('track_pos', 'track_keys', 'track_count'):
        np.testing.assert_array_equal(getattr(t.archive, name).numpy(),
                                      np.asarray(getattr(jrun.archive,
                                                         name)))
        np.testing.assert_array_equal(getattr(t.archive, name).numpy(),
                                      np.asarray(getattr(j.archive, name)))
    np.testing.assert_array_equal(t.mapper.full_map(0),
                                  j.mapper.full_map(0))
    assert t.mapper._cursor_bound[0] == int(j.mapper.local_maps[0].cursor)
    assert_close_trajectory(feed_runner(j, fs[SPLIT:]).trajectory(),
                            feed_runner(t, fs[SPLIT:]).trajectory())
