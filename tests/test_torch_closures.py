"""The port's closure machinery against the JAX package's: the scan
archive, submap gathering, verification, refined (and cached) closures,
and the detector-driven runner with the tridiagonal preconditioner.

One JAX runner (the stream and config of test_torch_place_recognition.py,
``preconditioner='tridiagonal'``) supplies the state and the scan archive
that the component tests carry across with ``state_from_numpy`` and
``archive_from_numpy``.

Tolerances.  ``archive_append`` and ``grow_archive`` are copies and
strides: bit-equal.  Gathered submaps compose the same f32 transforms in
another order: 2e-5 m.  Closure ICP matches with the brute matcher,
whose distances round differently from the JAX package's expansion, so a
near-tie may pick another neighbour: the verification's inlier fraction
within 0.01, its mean residual within 1 mm, a refined closure's poses
within 1 mm / 0.01 deg.  The runner holds twice its measured gap (GAP),
at least 1 mm / 0.01 deg.  That gap is there before the first closure:
the second scan's ICP already differs by 2.9 mm, and later scans
register against the moved submaps.  The JAX runner is as sensitive on
its own: with the scan points scaled by 1 +- 2**-23 it moves 2.1-10.4 cm
/ 0.15-0.45 deg with the tridiagonal preconditioner and 1.5-4.2 cm /
0.05-0.28 deg with Woodbury (test_jax_runner_sensitivity, ``slow``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_slam_tpu import config as jcfg
from laser_slam_tpu.graph import solver as jsv
from laser_slam_tpu.ops import se3 as jse3
from laser_slam_tpu.pipeline import online as jon
from laser_slam_tpu.pipeline import replay as jrep
from laser_slam_tpu_torch.config import (EstimatorConfig, IcpConfig,
                                         InputFilterConfig, LaserTrackConfig,
                                         PlaceRecognitionConfig, SolverConfig)
from laser_slam_tpu_torch.graph import solver as tsv
from laser_slam_tpu_torch.pipeline import online as ton

torch.set_num_threads(2)
N_SCANS, LAP = 32, 16
CAPS = dict(pose_capacity=64, factor_capacity=256, archive_points=512)
# Measured gap to the JAX runner (max m, max deg).
GAP = {'tridiagonal': (0.015283, 0.1470)}


def est_config(preconditioner='tridiagonal'):
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
    kw.setdefault('db_capacity', 64)
    return PlaceRecognitionConfig(detect_every=1, exclude_recent_keys=8,
                                  distance_threshold=0.25, **kw)


def jax_config(cfg):
    return jcfg._from_dict(jcfg.EstimatorConfig, dataclasses.asdict(cfg))


def rot_deg(q1, q2):
    """Angle of q1^-1 q2 in degrees, in float64 by the atan2 form (the
    arccos of an f32 dot product is off by ~0.04 deg near 0)."""
    q1, q2 = q1.astype(np.float64), q2.astype(np.float64)
    w = np.sum(q1 * q2, axis=-1)
    v = (q1[:, :1] * q2[:, 1:] - q2[:, :1] * q1[:, 1:]
         - np.cross(q1[:, 1:], q2[:, 1:]))
    return np.degrees(2 * np.arctan2(np.linalg.norm(v, axis=1), np.abs(w)))


def gaps(a, b):
    """(max translation gap m, max rotation gap deg) of two [n,7]."""
    return (float(np.linalg.norm(a[:, 4:] - b[:, 4:], axis=1).max()),
            float(rot_deg(a[:, :4], b[:, :4]).max()))


@pytest.fixture(scope='module')
def frames():
    return list(jrep.SyntheticStream(
        n_scans=N_SCANS, points_per_scan=2048, trajectory='circle',
        radius_m=10.0, center_m=(8.0, 5.0), laps=2, noise_m=0.005,
        odom_noise=0.01, seed=31))


@pytest.fixture(scope='module')
def jax_run(frames):
    """The JAX runner over the stream; numpy copies of its final state and
    archive, its detections and its trajectory."""
    runner = jon.OnlineRunner(
        jax_config(est_config()),
        place_recognition=jcfg.PlaceRecognitionConfig(
            **dataclasses.asdict(pr_config())), **CAPS)
    for f in frames:
        runner.process_scan(f.time_ns, f.points, f.odom_pose7)
    traj = runner.trajectory()
    state = {k: np.array(v) for k, v in runner.state._asdict().items()
             if k != 'rng_key'}
    archive = {k: np.array(v) for k, v in runner.archive._asdict().items()}
    return dict(state=state, archive=archive, traj=traj,
                detections=runner.detections,
                rejected=runner.rejected_detections)


def jax_state(d):
    return jon.OnlineState(**{k: jnp.array(v) for k, v in d.items()},
                           rng_key=jax.random.key(0))


def jax_archive(d):
    return jon.ScanArchive(**{k: jnp.array(v) for k, v in d.items()})


def test_runner_matches_jax_with_tridiagonal_and_growth(jax_run, frames):
    """The detector-driven runner, cold closure solves; the port starts
    at a quarter of the JAX runner's pose table and a 4-entry detector
    database, so the state, the archive and the detector all grow
    mid-run (tests/test_place_recognition.py::
    test_runner_detector_grows_mid_run)."""
    runner = ton.OnlineRunner(est_config(),
                              place_recognition=pr_config(db_capacity=4),
                              device='cpu', pose_capacity=16,
                              factor_capacity=32, archive_points=512)
    for f in frames:
        runner.process_scan(f.time_ns, f.points, f.odom_pose7)
    traj = runner.trajectory()
    assert runner.state.traj_poses.shape[0] == 32
    assert runner.state.rel_meas.shape[0] == 64
    assert runner.archive.points.shape[0] == 32
    assert runner.detector.db.shape[0] == 32 and runner.detector.n == 32
    np.testing.assert_array_equal(runner.detector.db_keys.numpy(),
                                  np.arange(32))
    assert jax_run['detections']
    assert [d[:2] for d in runner.detections] == \
        [d[:2] for d in jax_run['detections']]
    assert [d[:2] for d in runner.rejected_detections] == \
        [d[:2] for d in jax_run['rejected']]
    for t, j in zip(runner.detections, jax_run['detections']):
        assert abs(t[3] - j[3]) <= 1e-4
    assert list(traj) == list(jax_run['traj'])
    gap = gaps(np.stack(list(traj.values())),
               np.stack(list(jax_run['traj'].values())))
    print('tridiagonal gap to the JAX runner (m, deg):', gap)
    t_lim, r_lim = limits(GAP['tridiagonal'])
    assert gap[0] <= t_lim and gap[1] <= r_lim, gap
    assert runner._solver_cache is None


def limits(gap):
    """Twice a measured (m, deg) gap, at least 1 mm / 0.01 deg."""
    return max(2 * gap[0], 1e-3), max(2 * gap[1], 0.01)


@pytest.mark.slow
def test_jax_runner_sensitivity(frames):
    """The JAX runner against itself with the scan points scaled by
    1 +- 2**-23 (prints its gaps; the port's GAP values are of this
    size): the stream's poses move by centimetres under one ulp."""
    def run(precond, scale):
        runner = jon.OnlineRunner(
            jax_config(est_config(precond)),
            place_recognition=jcfg.PlaceRecognitionConfig(
                **dataclasses.asdict(pr_config())), **CAPS)
        for f in frames:
            runner.process_scan(f.time_ns, f.points * np.float32(scale),
                                f.odom_pose7)
        return runner.detections, np.stack(list(runner.trajectory().values()))
    for precond in ('tridiagonal', 'woodbury'):
        det, base = run(precond, 1.0)
        for scale in (1 + 2 ** -23, 1 - 2 ** -23):
            det_s, traj = run(precond, scale)
            assert [d[:2] for d in det_s] == [d[:2] for d in det]
            print(precond, scale, 'gap (m, deg):', gaps(traj, base))


@pytest.mark.parametrize('n_points,n_valid,budget', [
    (64, 40, 16), (64, 10, 16), (16, 12, 32)],
    ids=['stride', 'few-valid', 'pad'])
def test_archive_append_and_grow_match_jax(rng, n_points, n_valid, budget):
    """archive_append for N > M (the stride over the valid count, and
    fewer valid points than M) and N <= M (padding), then grow_archive:
    bit-equal to the JAX package."""
    pts = rng.normal(size=(3, n_points, 3)).astype(np.float32) * 10
    nrm = rng.normal(size=(3, n_points, 3)).astype(np.float32)
    masks = np.zeros((3, n_points), bool)
    for s in range(3):
        masks[s, rng.choice(n_points, n_valid, replace=False)] = True
    ja = jon.init_archive(8, budget)
    ta = ton.init_archive(8, budget, device='cpu')
    for s, key in enumerate((0, 3, 1)):
        ja = jon.archive_append(ja, jnp.asarray(pts[s]), jnp.asarray(
            masks[s]), jnp.asarray(nrm[s]), jnp.int32(key), jnp.int32(0))
        ta = ton.archive_append(ta, torch.tensor(pts[s]),
                                torch.tensor(masks[s]),
                                torch.tensor(nrm[s]),
                                torch.tensor(key, dtype=torch.int32), 0)
    ja, ta = jon.grow_archive(ja, 16), ton.grow_archive(ta, 16)
    got = ton.archive_to_numpy(ta)
    for name, want in ja._asdict().items():
        np.testing.assert_array_equal(got[name], np.asarray(want),
                                      err_msg=name)
        assert got[name].dtype == np.asarray(want).dtype, name
    back = ton.archive_from_numpy(got, device='cpu')
    assert all(torch.equal(a, b) for a, b in zip(back, ta))


def candidate(state, key_a, key_b, yaw):
    """The detector's alignment guess: T_w_a Rz(yaw) T_w_b^-1."""
    half = 0.5 * yaw
    rz = jnp.asarray([np.cos(half), 0, 0, np.sin(half), 0, 0, 0],
                     jnp.float32)
    poses = state['traj_poses']
    return np.asarray(jse3.compose(jnp.asarray(poses[key_a]), jse3.compose(
        rz, jse3.inverse(jnp.asarray(poses[key_b])))), np.float32)


def test_gather_submap_and_verify_match_jax(jax_run):
    cfg = est_config()
    jcfg_ = jax_config(cfg)
    js, ja = jax_state(jax_run['state']), jax_archive(jax_run['archive'])
    ts = ton.state_from_numpy(jax_run['state'], device='cpu')
    ta = ton.archive_from_numpy(jax_run['archive'], device='cpu')
    gather = jax.jit(jon._gather_submap, static_argnums=4)
    for key in (0, 5, 31):
        inv = jse3.inverse(js.traj_poses[key])
        jc, jn = gather(js, ja, jnp.int32(key), inv, 3)
        tc, tn = ton._gather_submap(ts, ta, key,
                                    torch.tensor(np.asarray(inv)), 3)
        np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
        m = tc.mask.numpy()
        assert m.sum() > 0
        np.testing.assert_allclose(tc.points.numpy()[m],
                                   np.asarray(jc.points)[m], atol=2e-5)
        np.testing.assert_allclose(tn.numpy()[m], np.asarray(jn)[m],
                                   atol=1e-5)
        assert np.all(tc.points.numpy()[~m] == 1.0e6)
    key_a, key_b, _, yaw = jax_run['detections'][0]
    true_pair = (key_a, key_b, candidate(jax_run['state'], key_a, key_b, yaw))
    # Half a lap apart (~20 m), claimed co-located: the gate's reject.
    aliased = (4, 12, candidate(jax_run['state'], 4, 12, 0.0))
    results = []
    for ka, kb, w_T in (true_pair, aliased):
        j = np.asarray(jon.verify_closure(js, ja, jnp.int32(ka),
                                          jnp.int32(kb), jnp.asarray(w_T),
                                          jcfg_))
        t = ton.verify_closure(ts, ta, ka, kb, torch.tensor(w_T),
                               cfg).numpy()
        assert t[0] == j[0] and t[3] == j[3], (t, j)
        assert abs(t[2] - j[2]) <= 0.01, (t, j)
        if j[0] > 0.5:
            assert abs(t[1] - j[1]) <= 1e-3, (t, j)
        results.append(t)
    pr = pr_config()
    ok = [r[0] > 0.5 and r[2] >= pr.min_inlier_fraction
          and r[1] <= pr.max_mean_residual_m for r in results]
    assert ok == [True, False], results
    # Verification changes nothing.
    for name, value in ton.state_to_numpy(ts).items():
        np.testing.assert_array_equal(value, jax_run['state'][name])


@pytest.mark.parametrize('cached', [False, True], ids=['cold', 'cached'])
def test_refined_closure_matches_jax(jax_run, cached):
    """A refined closure on the runner's final state, solved cold
    (tridiagonal) or through a freshly built Woodbury cache."""
    precond = 'woodbury' if cached else 'tridiagonal'
    cfg = est_config(precond)
    jcfg_ = jax_config(cfg)
    key_a, key_b, _, yaw = jax_run['detections'][-1]
    w_T = candidate(jax_run['state'], key_a, key_b, yaw)
    js, ja = jax_state(jax_run['state']), jax_archive(jax_run['archive'])
    ts = ton.state_from_numpy(jax_run['state'], device='cpu')
    ta = ton.archive_from_numpy(jax_run['archive'], device='cpu')
    args = (jnp.int32(key_a), jnp.int32(key_b), jnp.asarray(w_T), jcfg_)
    if cached:
        pose_mask = jnp.arange(64) < js.n_poses
        jcache = jsv.build_cache(jon._graph_view(js), js.traj_poses,
                                 pose_mask, jcfg_.solver)
        js, jcache, jinfo = jon.online_loop_closure_refined_cached(
            js, ja, jcache, *args)
        tcache = tsv.build_cache(ton._graph_view(ts), ts.traj_poses,
                                 ton._pose_mask(ts), cfg.solver)
        n_used = int(tcache.n_used)
        ts, tcache, tinfo = ton.online_loop_closure_refined_cached(
            ts, ta, tcache, key_a, key_b, torch.tensor(w_T), cfg)
        assert int(tcache.n_used) == int(jcache.n_used) == n_used + 1
        np.testing.assert_array_equal(tcache.ka.numpy(),
                                      np.asarray(jcache.ka))
        np.testing.assert_array_equal(tcache.kb.numpy(),
                                      np.asarray(jcache.kb))
    else:
        js, jinfo = jon.online_loop_closure_refined(js, ja, *args)
        ts, tinfo = ton.online_loop_closure_refined(
            ts, ta, key_a, key_b, torch.tensor(w_T), cfg)
    assert bool(tinfo.icp_valid) and bool(jinfo.icp_valid)
    assert int(ts.n_rel) == int(js.n_rel)
    n = int(js.n_poses)
    f = int(js.n_rel) - 1
    np.testing.assert_allclose(ts.rel_meas[f].numpy(),
                               np.asarray(js.rel_meas[f]), atol=1e-4)
    dt, dr = gaps(ts.traj_poses[:n].numpy(), np.asarray(js.traj_poses[:n]))
    assert dt <= 1e-3 and dr <= 0.01, (dt, dr)


def test_only_the_detector_check_is_timed(frames):
    """As in the JAX runner, 'online.verify_closure' times the detector's
    verification (_inject_detection) and not add_loop_closure's manual
    gate: the topic counts one call per verified candidate, and a
    manual verified closure adds none."""
    from laser_slam_tpu_torch.core import benchmarker as bench
    runner = ton.OnlineRunner(est_config(), place_recognition=pr_config(),
                              device='cpu', **CAPS)
    bench.enable()
    try:
        bench.reset_topic()
        for f in frames:
            runner.process_scan(f.time_ns, f.points, f.odom_pose7)
        runner.flush_detections()
        verified = len(runner.detections) + sum(
            1 for r in runner.rejected_detections if r[3] != -1.0)
        assert verified > 0
        count = bench.statistics()['online.verify_closure'][2]
        assert count == verified
        w_T = candidate(ton.state_to_numpy(runner.state), 2, 3, 0.0)
        assert runner.add_loop_closure(2, 3, w_T, verify_with_icp=True)
        assert bench.statistics()['online.verify_closure'][2] == count
        assert bench.statistics()['online.lc_solve_dispatch'][2] == \
            len(runner.detections) + 1
    finally:
        bench.disable()
