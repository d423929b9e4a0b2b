"""The port's three demos (``laser_slam_tpu_torch/examples/
{synthetic_slam_demo,auto_loop_closure_demo,multi_robot_demo}.py``)
against the JAX package's (``examples/``).

Each demo's ``main(['--cpu', ...])`` must pass the demo's own checks.
The synthetic and multi-robot flows run once more with the same config
on both sides: JAX's written out from the JAX demos' lines, the port's
from its ``estimator_config``, with ``reading_sampling_ratio`` 1.0 on
both, since the two packages' random streams differ.  The trajectories
must agree within twice the measured gap, at least 1 mm / 0.01 degree
(ROADMAP queue 3 states the gaps and where they come from).  The
auto-closure demo is held to its own checks
(``tests/test_torch_closures.py`` holds the detector path to JAX).  The JAX flows run once, through a module fixture.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from laser_slam_tpu import config as jcfg
from laser_slam_tpu.core.estimator import IncrementalEstimator as JEstimator
from laser_slam_tpu.core.types import RelativePose as JRelativePose
from laser_slam_tpu.ops import se3 as jse3
from laser_slam_tpu.pipeline import online as jonline
from laser_slam_tpu.pipeline import replay as jrep
from laser_slam_tpu.pipeline.worker import LaserSlamWorker as JWorker
from laser_slam_tpu_torch.examples import (auto_loop_closure_demo,
                                           multi_robot_demo,
                                           synthetic_slam_demo)

torch.set_num_threads(2)
# Twice the measured gaps of the flows against JAX's (ROADMAP queue 3):
# 4.493e-2 m / 0.2447 deg (synthetic) and 3.474e-3 m / 0.02096 deg
# (multi-robot) on the CPU.  JAX's kNN normals rank neighbours by the
# expansion |q|^2 - 2 q.r + |r|^2 (laser_slam_tpu/ops/neighbors.py:78-97),
# which at 12 m from the origin loses the centimetre spacing of an
# 8192-point scan; the port ranks by (q - r)^2 and ends nearer the ground
# truth (synthetic mean 0.0211 m against JAX's 0.0330).
SYNTHETIC_TOL = (0.09, 0.49)
MULTI_TOL = (7e-3, 0.042)
SAMPLING_ONE = ['--cpu', '--reading-sampling', '1.0']
DEMOS = dict(synthetic=synthetic_slam_demo, auto=auto_loop_closure_demo,
             multi=multi_robot_demo)


def jax_synthetic_config(matcher='projective', sampling=0.5):
    """examples/synthetic_slam_demo.py:45-55."""
    return jcfg.EstimatorConfig(
        laser_track=jcfg.LaserTrackConfig(
            nscan_in_sub_map=3,
            odometry_noise_model=(0.02, 0.02, 0.02, 0.05, 0.05, 0.05),
            icp_noise_model=(0.005, 0.005, 0.005, 0.005, 0.005, 0.005),
            input_filters=jcfg.InputFilterConfig(scan_capacity=8192),
            icp=jcfg.IcpConfig(matcher=matcher, reading_capacity=4096,
                               reading_sampling_ratio=sampling)),
        loop_closure_noise_model=(0.005,) * 3 + (0.005,) * 3,
        solver=jcfg.SolverConfig(gn_iterations=3, pcg_iterations=40))


def jax_auto_config():
    """examples/auto_loop_closure_demo.py:38-51."""
    return (jcfg.EstimatorConfig(
        laser_track=jcfg.LaserTrackConfig(
            nscan_in_sub_map=3,
            odometry_noise_model=(0.02,) * 3 + (0.05,) * 3,
            icp_noise_model=(0.005,) * 6,
            input_filters=jcfg.InputFilterConfig(scan_capacity=8192),
            icp=jcfg.IcpConfig(matcher='brute', reading_capacity=4096,
                               reading_sampling_ratio=0.5)),
        loop_closure_noise_model=(0.005,) * 6,
        solver=jcfg.SolverConfig(gn_iterations=3, pcg_iterations=40)),
        jcfg.PlaceRecognitionConfig(detect_every=1, exclude_recent_keys=12,
                                    distance_threshold=0.06))


def jax_multi_config(sampling=0.5):
    """examples/multi_robot_demo.py:41-49."""
    return jcfg.EstimatorConfig(
        laser_track=jcfg.LaserTrackConfig(
            nscan_in_sub_map=3, force_priors=True,
            odometry_noise_model=(0.02,) * 3 + (0.05,) * 3,
            icp_noise_model=(0.005,) * 6,
            input_filters=jcfg.InputFilterConfig(scan_capacity=8192),
            icp=jcfg.IcpConfig(matcher='projective', reading_capacity=4096,
                               reading_sampling_ratio=sampling)),
        solver=jcfg.SolverConfig(gn_iterations=3, pcg_iterations=48))


def to_jax(cfg):
    return jcfg._from_dict(getattr(jcfg, type(cfg).__name__),
                           dataclasses.asdict(cfg))


def run_jax_synthetic(frames):
    """examples/synthetic_slam_demo.py:57-84 with sampling 1.0."""
    est = JEstimator(jax_synthetic_config(sampling=1.0), 1)
    worker = JWorker(jcfg.WorkerConfig(minimum_distance_to_add_pose=0.5),
                     est, 0)
    jrep.run_worker_on_stream(worker, frames)
    t_last = worker.laser_track.get_max_time()
    T_w_a = jnp.asarray(worker.laser_track.evaluate(0))
    T_w_b = jnp.asarray(worker.laser_track.evaluate(t_last))
    true_rel = jse3.compose(jse3.inverse(jnp.asarray(frames[0].gt_pose7)),
                            jnp.asarray(frames[-1].gt_pose7))
    w_T_a_b = jse3.compose(T_w_a, jse3.compose(true_rel,
                                               jse3.inverse(T_w_b)))
    est.process_loop_closure(JRelativePose(
        T_a_b=np.asarray(w_T_a_b), time_a_ns=0, time_b_ns=t_last,
        track_id_a=0, track_id_b=0))
    return worker.get_trajectory()


def run_jax_multi(robots):
    """examples/multi_robot_demo.py:50-103 with sampling 1.0; returns the
    solved poses [keys, 7]."""
    runner = jonline.OnlineRunner(jax_multi_config(sampling=1.0),
                                  pose_capacity=128, factor_capacity=512,
                                  n_tracks=2)
    n = len(robots[0])
    for i in range(n):
        for t in (0, 1):
            f = robots[t][i]
            runner.process_scan(f.time_ns + t, f.points, f.odom_pose7,
                                track_id=t)
    keys0 = [i for i, (t, _) in enumerate(runner.key_info) if t == 0]
    keys1 = [i for i, (t, _) in enumerate(runner.key_info) if t == 1]
    key_a, key_b = keys0[0], keys1[0]
    rel = jse3.compose(jse3.inverse(jnp.asarray(robots[0][0].gt_pose7)),
                       jnp.asarray(robots[1][0].gt_pose7))
    poses = jonline.extract_trajectory(runner.state)
    w_T_a_b = jse3.compose(jnp.asarray(poses[key_a]),
                           jse3.compose(rel, jse3.inverse(
                               jnp.asarray(poses[key_b]))))
    runner.add_loop_closure(key_a, key_b, np.asarray(w_T_a_b))
    runner.refine(1, gn_iterations=6, pcg_iterations=256,
                  pcg_tolerance=1e-10)
    return np.asarray(jonline.extract_trajectory(runner.state))[
        :len(runner.key_info)]


@pytest.fixture(scope='module')
def jax_runs():
    args = synthetic_slam_demo.parse_args(SAMPLING_ONE)
    synthetic = run_jax_synthetic(synthetic_slam_demo.frames(args))
    args = multi_robot_demo.parse_args(SAMPLING_ONE)
    multi = run_jax_multi(multi_robot_demo.robot_frames(args))
    return dict(synthetic=synthetic, multi=multi)


def rot_deg(q1, q2):
    """Angle of q1^-1 q2 in degrees, by atan2."""
    w = q1[:, 0] * q2[:, 0] + np.sum(q1[:, 1:] * q2[:, 1:], axis=1)
    v = (q1[:, :1] * q2[:, 1:] - q2[:, :1] * q1[:, 1:]
         - np.cross(q1[:, 1:], q2[:, 1:]))
    return np.degrees(2 * np.arctan2(np.linalg.norm(v, axis=1), np.abs(w)))


def gaps(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.all(np.isfinite(b))
    return (float(np.linalg.norm(a[:, 4:] - b[:, 4:], axis=1).max()),
            float(rot_deg(a[:, :4], b[:, :4]).max()))


def test_demo_configs_match_the_jax_demos():
    """The port's configs carry the JAX demos' values field for field."""
    pairs = [
        (synthetic_slam_demo.estimator_config(
            synthetic_slam_demo.parse_args([])), jax_synthetic_config()),
        (synthetic_slam_demo.estimator_config(
            synthetic_slam_demo.parse_args(['--matcher', 'pallas'])),
         jax_synthetic_config('pallas')),
        (auto_loop_closure_demo.estimator_config(
            auto_loop_closure_demo.parse_args([])), jax_auto_config()[0]),
        (auto_loop_closure_demo.place_recognition_config(),
         jax_auto_config()[1]),
        (multi_robot_demo.estimator_config(multi_robot_demo.parse_args([])),
         jax_multi_config()),
    ]
    for ours, theirs in pairs:
        assert to_jax(ours) == theirs


def test_demo_streams_match_the_jax_demos():
    """The port's streams are the JAX demos' frame for frame
    (examples/synthetic_slam_demo.py:60-63, auto_loop_closure_demo.py:
    56-59, multi_robot_demo.py:56-61): points exact, poses within 1e-5
    (each package composes the noisy odometry step by step in its own
    float32 code)."""
    ours = synthetic_slam_demo.frames(synthetic_slam_demo.parse_args([]))
    theirs = list(jrep.SyntheticStream(
        n_scans=20, points_per_scan=8192, trajectory='circle',
        radius_m=12.0, noise_m=0.01, odom_noise=0.01, seed=3))
    ours_auto = auto_loop_closure_demo.frames(
        auto_loop_closure_demo.parse_args([]))
    theirs_auto = list(jrep.SyntheticStream(
        n_scans=48, points_per_scan=8192, trajectory='circle',
        radius_m=12.0, center_m=(8.0, 5.0), laps=2, noise_m=0.01,
        odom_noise=0.01, seed=3))
    ours_multi = sum(multi_robot_demo.robot_frames(
        multi_robot_demo.parse_args([])), [])
    theirs_multi = list(jrep.SyntheticStream(
        n_scans=24, points_per_scan=8192, world_points=65536,
        trajectory='circle', radius_m=12.0, noise_m=0.005, odom_noise=0.004,
        seed=42, laps=2))
    for a_all, b_all in ((ours, theirs), (ours_auto, theirs_auto),
                         (ours_multi, theirs_multi)):
        assert len(a_all) == len(b_all)
        for a, b in zip(a_all, b_all):
            assert a.time_ns == b.time_ns
            assert np.array_equal(a.points, b.points)
            np.testing.assert_allclose(a.odom_pose7, b.odom_pose7,
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(a.gt_pose7, b.gt_pose7, rtol=0,
                                       atol=1e-5)


@pytest.mark.parametrize('demo,argv', [
    ('synthetic', ['--scans', '16']),
    ('synthetic', ['--scans', '16', '--matcher', 'pallas',
                   '--points', '2048']),
    ('synthetic', ['--scans', '16', '--matcher', 'brute',
                   '--points', '2048']),
    ('auto', ['--scans', '32', '--points', '2048']),
    ('multi', ['--scans', '8']),
], ids=['synthetic', 'synthetic-pallas', 'synthetic-brute', 'auto',
        'multi'])
def test_demo_passes_its_checks_on_cpu(demo, argv):
    """Each demo at a reduced scan count on the CPU passes its own
    checks (main raises otherwise) and returns finite numbers."""
    out = DEMOS[demo].main(['--cpu'] + argv)
    if demo == 'synthetic':
        assert out['n'] == int(argv[1]) and out['error_max_m'] < 0.5
        assert out['estimator'].device.type == 'cpu'
        assert 'worker.process_scan' in out['statistics']
    elif demo == 'auto':
        assert out['detections']
        assert out['ate_with'].translation.max < 0.5
        assert out['runner'].device.type == 'cpu'
    else:
        assert out['error_max_m'] < 0.10
        assert len(out['keys'][0]) == len(out['keys'][1]) == int(argv[1])
    assert np.isfinite(out['scans_per_s']) and out['scans_per_s'] > 0


@pytest.mark.parametrize('demo', sorted(DEMOS))
def test_demo_needs_a_card_unless_told_cpu(demo):
    """Without --cpu a demo runs on the card; with none it raises before
    any work instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        DEMOS[demo].main([])


def test_synthetic_demo_matches_jax(jax_runs):
    """The synthetic flow (worker, estimator, ground-truth closure) at
    the demo's defaults, sampling 1.0 on both sides."""
    out = synthetic_slam_demo.main(SAMPLING_ONE)
    ours, theirs = out['traj'], jax_runs['synthetic']
    assert list(ours) == list(theirs)
    dt, dr = gaps(np.stack(list(theirs.values())),
                  np.stack(list(ours.values())))
    gt = np.stack([f.gt_pose7[4:] for f in synthetic_slam_demo.frames(
        synthetic_slam_demo.parse_args(SAMPLING_ONE))])
    err = [np.linalg.norm(np.stack(list(t.values()))[:, 4:] - gt, axis=1)
           for t in (theirs, ours)]
    print(f'synthetic demo vs JAX: {dt:.3e} m, {dr:.3e} deg; error to '
          f'ground truth mean/max JAX {err[0].mean():.4f}/{err[0].max():.4f}'
          f' m, port {err[1].mean():.4f}/{err[1].max():.4f} m')
    assert dt < SYNTHETIC_TOL[0] and dr < SYNTHETIC_TOL[1]
    assert err[1].mean() <= err[0].mean() + 1e-3


def test_multi_robot_demo_matches_jax(jax_runs):
    """The multi-robot flow (two forced-prior tracks interleaved, the
    cross-track closure, the strong refine) at the demo's defaults,
    sampling 1.0 on both sides: every key's solved pose."""
    from laser_slam_tpu_torch.pipeline import online
    out = multi_robot_demo.main(SAMPLING_ONE)
    runner = out['runner']
    ours = online.extract_trajectory(runner.state)[:len(runner.key_info)]
    dt, dr = gaps(jax_runs['multi'], ours)
    print(f'multi-robot demo vs JAX: {dt:.3e} m, {dr:.3e} deg')
    assert dt < MULTI_TOL[0] and dr < MULTI_TOL[1]
