"""The port's loop-closure detection against the JAX package's runner.

The stream of tests/test_place_recognition.py::
test_runner_closes_loop_automatically (SyntheticStream: 32 scans of 2048
points, two laps of an off-centre 10 m circle, seed 31; brute matcher,
sampling ratios 1.0) runs through the JAX OnlineRunner and the port's,
both with a scan archive and the scan-context detector, closures solved
through the persisted Woodbury cache.  (The tridiagonal preconditioner's
run is held to JAX in test_torch_closures.py.)

Tolerances.  The accepted and the rejected key pairs must be identical,
and each accepted yaw within 1e-4 rad.  Poses: the two packages run the
same f32 algorithm, but ICP stops on a loose differential test, so
rounding moves a stream's poses (tests/test_torch_production.py); the
run holds twice its measured gap (GAP below), at least 1 mm / 0.01 deg.
The JAX runner moves more than that against itself when the scan points
are scaled by 1 +- 2**-23 (test_torch_closures.py::
test_jax_runner_sensitivity).
"""

import dataclasses

import numpy as np
import pytest
import torch

from laser_slam_tpu import config as jcfg
from laser_slam_tpu.pipeline import online as jon
from laser_slam_tpu.pipeline import replay as jrep
from laser_slam_tpu_torch.config import (EstimatorConfig, IcpConfig,
                                         InputFilterConfig, LaserTrackConfig,
                                         PlaceRecognitionConfig, SolverConfig)
from laser_slam_tpu_torch.ops import se3
from laser_slam_tpu_torch.pipeline import online as ton

torch.set_num_threads(2)
N_SCANS, LAP = 32, 16
CAPS = dict(pose_capacity=64, factor_capacity=256, archive_points=512)
# Measured gap to the JAX runner on this stream (max m, max deg).  It is
# there before the first closure: the second scan's ICP already differs
# by 2.9 mm, as the brute matcher's distances round differently (the
# JAX package expands |q - r|^2 for its matrix unit; ops/neighbors.py).
GAP = {'woodbury': (0.0047435, 0.0357)}


def est_config(preconditioner='woodbury'):
    return EstimatorConfig(
        laser_track=LaserTrackConfig(
            nscan_in_sub_map=3,
            odometry_noise_model=(0.02,) * 3 + (0.05,) * 3,
            icp_noise_model=(0.01,) * 6,
            input_filters=InputFilterConfig(scan_capacity=2048),
            icp=IcpConfig(matcher='brute', reading_capacity=1024,
                          reading_sampling_ratio=1.0)),
        solver=SolverConfig(gn_iterations=2, pcg_iterations=30,
                            preconditioner=preconditioner))


def pr_config(**kw):
    return PlaceRecognitionConfig(detect_every=1, exclude_recent_keys=8,
                                  distance_threshold=0.25, db_capacity=64,
                                  **kw)


def to_jax(cfg, pr):
    return (jcfg._from_dict(jcfg.EstimatorConfig, dataclasses.asdict(cfg)),
            jcfg.PlaceRecognitionConfig(**dataclasses.asdict(pr)))


def rot_deg(q1, q2):
    """Angle of q1^-1 q2 in degrees, in float64 by the atan2 form (the
    arccos of an f32 dot product is off by ~0.04 deg near 0)."""
    q1, q2 = q1.astype(np.float64), q2.astype(np.float64)
    w = np.sum(q1 * q2, axis=-1)
    v = (q1[:, :1] * q2[:, 1:] - q2[:, :1] * q1[:, 1:]
         - np.cross(q1[:, 1:], q2[:, 1:]))
    return np.degrees(2 * np.arctan2(np.linalg.norm(v, axis=1), np.abs(w)))


def pose_gap(a: dict, b: dict):
    assert list(a) == list(b)
    pa, pb = np.stack(list(a.values())), np.stack(list(b.values()))
    return (float(np.linalg.norm(pa[:, 4:] - pb[:, 4:], axis=1).max()),
            float(rot_deg(pa[:, :4], pb[:, :4]).max()))


def limits(gap):
    """Twice a measured (m, deg) gap, at least 1 mm / 0.01 deg."""
    return max(2 * gap[0], 1e-3), max(2 * gap[1], 0.01)


@pytest.fixture(scope='module')
def frames():
    return list(jrep.SyntheticStream(
        n_scans=N_SCANS, points_per_scan=2048, trajectory='circle',
        radius_m=10.0, center_m=(8.0, 5.0), laps=2, noise_m=0.005,
        odom_noise=0.01, seed=31))


def run_port(frames, chunk=None, **kw):
    runner = ton.OnlineRunner(est_config(), place_recognition=pr_config(),
                              device='cpu', **{**CAPS, **kw})
    if chunk:
        runner.process_scans(frames, chunk_size=chunk)
    else:
        for f in frames:
            runner.process_scan(f.time_ns, f.points, f.odom_pose7)
    return runner


@pytest.fixture(scope='module')
def jax_run(frames):
    runner = jon.OnlineRunner(*to_jax(est_config(), pr_config())[:1],
                              place_recognition=to_jax(est_config(),
                                                       pr_config())[1],
                              **CAPS)
    for f in frames:
        runner.process_scan(f.time_ns, f.points, f.odom_pose7)
    traj = runner.trajectory()
    return runner.detections, runner.rejected_detections, traj


@pytest.fixture(scope='module')
def port_run(frames):
    runner = run_port(frames)
    return runner, runner.trajectory()


def test_runner_matches_jax_with_woodbury(jax_run, port_run, frames):
    jdet, jrej, jtraj = jax_run
    runner, ttraj = port_run
    assert jdet, 'the JAX runner found no closure on this stream'
    assert [d[:2] for d in runner.detections] == [d[:2] for d in jdet]
    assert [d[:2] for d in runner.rejected_detections] == \
        [d[:2] for d in jrej]
    for (_, _, dist_t, yaw_t), (_, _, dist_j, yaw_j) in zip(
            runner.detections, jdet):
        assert abs(yaw_t - yaw_j) <= 1e-4
        assert abs(dist_t - dist_j) <= 1e-4
    for key_a, key_b, _, yaw in runner.detections:
        assert abs((key_b - key_a) - LAP) <= 2 and abs(yaw) < 0.5
    gap = pose_gap(jtraj, ttraj)
    print('woodbury gap to the JAX runner (m, deg):', gap)
    t_lim, r_lim = limits(GAP['woodbury'])
    assert gap[0] <= t_lim and gap[1] <= r_lim, gap
    # The cache was built at the first closure (holding the two factors
    # on the gauge-frozen key 0) and extended once per accepted closure.
    assert int(runner._solver_cache.n_used) == 2 + len(runner.detections)
    assert runner._n_rel_host == 2 * (N_SCANS - 1) + len(runner.detections)
    errs = [np.linalg.norm(ttraj[f.time_ns][4:] - f.gt_pose7[4:])
            for f in frames]
    assert max(errs) < 0.5, max(errs)


def test_chunked_detection_matches_per_scan(port_run, frames):
    """process_scans in chunks of 8 runs the detector inside the chunk and
    injects at chunk boundaries: the same revisits, the count within 2
    of the per-scan run's (tests/test_place_recognition.py's rule), and
    a trajectory as good."""
    per_scan = port_run[0]
    chunked = run_port(frames, chunk=8)
    assert chunked.detector.n == N_SCANS
    np.testing.assert_array_equal(chunked.detector.db_keys[:N_SCANS].numpy(),
                                  np.arange(N_SCANS))
    assert chunked.detections
    assert abs(len(chunked.detections) - len(per_scan.detections)) <= 2
    for key_a, key_b, _, yaw in chunked.detections:
        assert abs((key_b - key_a) - LAP) <= 2 and abs(yaw) < 0.5
    traj = chunked.trajectory()
    errs = [np.linalg.norm(traj[f.time_ns][4:] - f.gt_pose7[4:])
            for f in frames]
    assert max(errs) < 0.5, max(errs)
    # The archive holds every key's scan, as the per-scan run's does.
    np.testing.assert_array_equal(chunked.archive.track_count.numpy(),
                                  per_scan.archive.track_count.numpy())
    np.testing.assert_array_equal(chunked.archive.mask.numpy(),
                                  per_scan.archive.mask.numpy())


def test_warmup_is_pure_and_manual_gate(frames):
    """warmup_closure_path runs the verification and the cached refined
    closure on clones: the state, the archive and the detector are
    bit-identical afterwards (the cache it builds is kept, as the first
    closure would).  add_loop_closure(verify_with_icp=True) rejects a
    claim that keys ~17 m apart are co-located and injects a genuine
    one (tests/test_online.py::test_manual_loop_closure_icp_gate)."""
    runner = run_port(frames[:6])
    before = ton.state_to_numpy(runner.state)
    archive = ton.archive_to_numpy(runner.archive)
    db = runner.detector.db.clone()
    runner.warmup_closure_path()
    for name, value in ton.state_to_numpy(runner.state).items():
        np.testing.assert_array_equal(value, before[name], err_msg=name)
    for name, value in ton.archive_to_numpy(runner.archive).items():
        np.testing.assert_array_equal(value, archive[name], err_msg=name)
    assert torch.equal(runner.detector.db, db) and runner.detector.n == 6
    # The build holds the two factors on key 0 (frozen by its gauge
    # prior, so off the chain) and nothing the clones added.
    assert int(runner._solver_cache.n_used) == 2
    assert runner._n_rel_host == 2 * 5 and not runner.detections

    traj = runner.trajectory()
    tp = {k: torch.tensor(traj[f.time_ns]) for k, f in enumerate(frames[:6])}
    n_rel = runner._n_rel_host
    bogus = se3.compose(tp[0], se3.inverse(tp[5])).numpy()
    assert runner.add_loop_closure(0, 5, bogus, verify_with_icp=True) is False
    assert runner._n_rel_host == n_rel and int(runner.state.n_rel) == n_rel
    assert runner.rejected_detections[-1][:2] == (0, 5)
    rel = se3.compose(se3.inverse(torch.tensor(frames[2].gt_pose7)),
                      torch.tensor(frames[3].gt_pose7))
    genuine = se3.compose(tp[2], se3.compose(rel, se3.inverse(tp[3])))
    assert runner.add_loop_closure(2, 3, genuine.numpy(),
                                   verify_with_icp=True) is True
    assert int(runner.state.n_rel) == n_rel + 1
    assert int(runner._solver_cache.n_used) == 3

    bare = ton.OnlineRunner(est_config(), device='cpu', pose_capacity=8,
                            factor_capacity=16)
    with pytest.raises(ValueError, match='archive'):
        bare.add_loop_closure(0, 1, genuine.numpy(), verify_with_icp=True)
