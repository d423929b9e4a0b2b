"""The port's production online path (slice 2) against the JAX package's.

``production_config`` at small sizes (64 x 128-beam scans, images of
128 columns, so the beams' azimuths fall on column centres) with both
sampling ratios at 1.0, on a 12-scan ``BeamStream`` with one loop
closure, run through the JAX ``OnlineRunner`` and the port's: xyz and
packed ingest, with odometry and odometry-free, with the production
image-PCA normals and with the tangent ('range_image') normals.

Tolerance.  Every module agrees with its JAX counterpart on its own
(tests/test_torch_{spherical,range_image,cloud,solver}.py), and one ICP
call on identical inputs agrees within 3e-7 m.  Over a stream the path
is sensitive to f32 rounding: ICP stops on a loose differential test
(1 cm / 1 mrad) after a handful of iterations, so a small change of its
inputs moves its result by a comparable amount, and the next scans
register against the moved submap.  The JAX package against itself,
with the scan points scaled by 1 +- 2**-23, moves up to 1.4-3.8 mm on
this stream.  The image-PCA normals of ill-conditioned windows differ
between the packages by up to ~1e-2 (the JAX package's jitted and eager
runs differ as much; test_torch_range_image.py), which perturbs ICP
more than one ulp does.  So each case holds the measured gap x 2, at
least 1 mm / 0.01 deg and never looser than 1 cm / 0.1 deg (ROADMAP
queue 3 records the gaps).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_slam_tpu import config as jcfg
from laser_slam_tpu.ops import se3 as jse3
from laser_slam_tpu.pipeline import online as jon
from laser_slam_tpu.pipeline import velodyne_sim as jvs
from laser_slam_tpu_torch import config as tcfg
from laser_slam_tpu_torch.pipeline import online as ton
from laser_slam_tpu_torch.pipeline import velodyne_sim as tvs

torch.set_num_threads(2)
A, N_SCANS, CLOSE_AT = 128, 12, 8
CAPS = dict(pose_capacity=32, factor_capacity=64)


def small_config(normals='image_pca', window=2, **kw):
    """production_config at the test's size; window 2 makes the window
    solve anchor the closure's old key after the closure."""
    cfg = tcfg.production_config(64 * A, 64 * A, A, A, reading_capacity=2048,
                                 reading_sampling_ratio=1.0, window=window,
                                 **kw)
    if normals != 'image_pca':
        cfg = dataclasses.replace(cfg, laser_track=dataclasses.replace(
            cfg.laser_track, icp=dataclasses.replace(
                cfg.laser_track.icp, normal_method=normals)))
    return cfg


def jax_config(cfg):
    return jcfg._from_dict(jcfg.EstimatorConfig, dataclasses.asdict(cfg))


@pytest.fixture(scope='module')
def frames():
    return list(tvs.BeamStream(
        n_scans=N_SCANS, n_beams=64, n_azimuth=A, trajectory='line',
        step_m=0.5, world_size_m=50.0, range_noise_m=0.01, odom_noise=0.003,
        seed=3, packed=True))


def closure(frames, traj, i, j):
    """World-frame alignment from the true relative pose and the live
    estimates (tests/test_parity.py::measured_closure)."""
    rel = jse3.compose(jse3.inverse(jnp.asarray(frames[i].gt_pose7)),
                       jnp.asarray(frames[j].gt_pose7))
    T_a = jnp.asarray(traj[frames[i].time_ns])
    T_b = jnp.asarray(traj[frames[j].time_ns])
    return np.asarray(jse3.compose(T_a, jse3.compose(rel, jse3.inverse(T_b))),
                      np.float32)


def gaps(a, b):
    """(max translation gap m, max rotation gap deg), in float64."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    dt = np.linalg.norm(a[:, 4:] - b[:, 4:], axis=1).max()
    # Angle of conj(qa) qb: 2 atan2(|vector part|, |scalar part|), which
    # keeps its precision at small angles and ignores the f32 norms.
    wa, va, wb, vb = a[:, 0], a[:, 1:4], b[:, 0], b[:, 1:4]
    w = wa * wb + np.sum(va * vb, axis=1)
    v = wa[:, None] * vb - wb[:, None] * va - np.cross(va, vb)
    dr = np.degrees(2 * np.arctan2(np.linalg.norm(v, axis=1), np.abs(w)))
    return dt, dr.max()


def run(runner, frames, packed, odometry, w_T=None):
    if packed:
        runner.enable_packed_ingest(tvs.HDL64_ELEV_DEG, A)
    for k, f in enumerate(frames):
        assert runner.process_scan(f.time_ns,
                                   f.range_words if packed else f.points,
                                   f.odom_pose7 if odometry else None)
        if k == CLOSE_AT:
            if w_T is None:
                w_T = closure(frames, runner.trajectory(), 0, CLOSE_AT)
            runner.add_loop_closure(0, CLOSE_AT, w_T)
    return w_T, np.stack(list(runner.trajectory().values()))


# (normals, packed, odometry): the gap measured on this stream (max over
# the poses; m, deg), rounded up.
CASES = {
    ('image_pca', False, True): (1.41e-3, 0.0139),
    ('image_pca', True, False): (1.21e-3, 0.0008),
    ('range_image', False, False): (2.6e-6, 0.0001),
    ('range_image', True, True): (6.8e-4, 0.0021),
}


@pytest.mark.parametrize('case', sorted(CASES),
                         ids=['-'.join([c[0], 'packed' if c[1] else 'xyz',
                                        'odom' if c[2] else 'odomfree'])
                              for c in sorted(CASES)])
def test_slice_matches_jax_runner(frames, case):
    normals, packed, odometry = case
    cfg = small_config(normals)
    jr = jon.OnlineRunner(jax_config(cfg), use_odometry_information=odometry,
                          **CAPS)
    tr = ton.OnlineRunner(cfg, use_odometry_information=odometry,
                          device='cpu', **CAPS)
    if packed:
        jr.enable_packed_ingest(jvs.HDL64_ELEV_DEG, A)
    w_T, jtraj = run(jr, frames, False, odometry) if not packed else (
        None, None)
    if packed:
        for k, f in enumerate(frames):
            jr.process_scan(f.time_ns, f.range_words,
                            f.odom_pose7 if odometry else None)
            if k == CLOSE_AT:
                w_T = closure(frames, jr.trajectory(), 0, CLOSE_AT)
                jr.add_loop_closure(0, CLOSE_AT, w_T)
        jtraj = np.stack(list(jr.trajectory().values()))
    _, ttraj = run(tr, frames, packed, odometry, w_T)
    assert np.all(np.isfinite(ttraj)) and ttraj.shape == (N_SCANS, 7)
    assert int(tr.state.n_rel) == 2 * (N_SCANS - 1) + 1
    dt, dr = gaps(jtraj, ttraj)
    gap_t, gap_r = CASES[case]
    tol_t = min(max(2 * gap_t, 1e-3), 1e-2)
    tol_r = min(max(2 * gap_r, 0.01), 0.1)
    assert dt <= tol_t and dr <= tol_r, (dt, dr)
    if odometry:
        # With odometry both track ground truth.  (Odometry-free, the
        # constant-velocity guess starts from rest and projective ICP
        # does not lock onto 0.5 m steps, in either package.)
        gt = np.stack([f.gt_pose7 for f in frames])
        assert np.linalg.norm(ttraj[:, 4:] - gt[:, 4:], axis=1).max() < 0.1


def test_refine_matches_jax(frames):
    cfg = small_config('range_image')
    jr = jon.OnlineRunner(jax_config(cfg), **CAPS)
    tr = ton.OnlineRunner(cfg, device='cpu', **CAPS)
    for r in (jr, tr):
        for f in frames[:6]:
            r.process_scan(f.time_ns, f.points, f.odom_pose7)
    w_T = closure(frames, jr.trajectory(), 0, 5)
    for r in (jr, tr):
        r.add_loop_closure(0, 5, w_T)
    je = jr.refine(2, gn_iterations=4, pcg_iterations=64)
    te = tr.refine(2, gn_iterations=4, pcg_iterations=64)
    assert math.isfinite(te) and abs(te - je) <= 1e-3 * max(abs(je), 1.0)
    dt, dr = gaps(np.stack(list(jr.trajectory().values())),
                  np.stack(list(tr.trajectory().values())))
    assert dt <= 1e-3 and dr <= 0.01, (dt, dr)


@pytest.mark.parametrize('packed', [False, True], ids=['xyz', 'packed'])
def test_process_scans_chunks_match_per_scan(frames, packed):
    """Two chunks of 4 and a remainder of 1 give the per-scan poses
    exactly, with the reading sampled at 0.5 (the generator's draws are
    the same either way) and a filter chain in place of the fixed
    filters."""
    cfg = small_config('range_image', window=4)
    lt = cfg.laser_track
    cfg = dataclasses.replace(cfg, laser_track=dataclasses.replace(
        lt, icp=dataclasses.replace(lt.icp, reading_sampling_ratio=0.5),
        input_filters=dataclasses.replace(lt.input_filters, chain=(
            {'type': 'range', 'min_distance_m': 1.0, 'max_distance_m': 60.0},
            {'type': 'random_sampling', 'prob': 0.8},
            {'type': 'voxel', 'voxel_size_m': 0.05}))))
    seq = ton.OnlineRunner(cfg, seed=5, device='cpu', **CAPS)
    chk = ton.OnlineRunner(cfg, seed=5, device='cpu', **CAPS)
    for r in (seq, chk):
        if packed:
            r.enable_packed_ingest(tvs.HDL64_ELEV_DEG, A)
    payload = [(f.time_ns, f.range_words if packed else f.points,
                f.odom_pose7) for f in frames[:9]]
    for t, p, o in payload:
        seq.process_scan(t, p, o)
    assert chk.process_scans(payload, chunk_size=4) == 9
    np.testing.assert_array_equal(chk.state.traj_poses.numpy(),
                                  seq.state.traj_poses.numpy())
    assert chk.trajectory().keys() == seq.trajectory().keys()
    assert int(chk.state.n_rel) == int(seq.state.n_rel) == 16


def test_packed_and_xyz_ingest_agree_within_quantization(frames):
    """The two ingest paths differ by the 2 mm range word only
    (tests/test_spherical.py's bound: 3 cm a pose)."""
    cfg = small_config('range_image')
    trajs = []
    for packed in (False, True):
        _, traj = run(ton.OnlineRunner(cfg, device='cpu', **CAPS),
                      frames[:8], packed, True)
        trajs.append(traj)
    assert np.linalg.norm(trajs[0][:, 4:] - trajs[1][:, 4:],
                          axis=1).max() < 3e-2


def test_window_solve_matches_jax(frames):
    """``_window_solve`` on one state (taken from the JAX runner) in both
    packages: a window of 2 past a closure whose old key has left the
    table, so its factor anchors against a gathered pose."""
    cfg = small_config('range_image')
    jr = jon.OnlineRunner(jax_config(cfg), **CAPS)
    for k, f in enumerate(frames[:10]):
        jr.process_scan(f.time_ns, f.points, f.odom_pose7)
        if k == CLOSE_AT:
            jr.add_loop_closure(0, CLOSE_AT, closure(
                frames, jr.trajectory(), 0, CLOSE_AT))
    st = {k: np.array(v) for k, v in jr.state._asdict().items()
          if k != 'rng_key'}
    # Perturb the window's poses so the solve has work to do.
    rng = np.random.default_rng(0)
    st['traj_poses'][7:10, 4:] += rng.normal(size=(3, 3)).astype(
        np.float32) * 0.02
    i = int(st['n_poses']) - 1
    jstate = jr.state._replace(traj_poses=jnp.asarray(st['traj_poses']))
    jtraj, jerr = jon._window_solve(jstate, jnp.int32(i), jax_config(cfg))
    tstate = ton.state_from_numpy(st, device='cpu')
    ttraj, terr = ton._window_solve(tstate, torch.tensor(i, dtype=torch.int32),
                                    cfg)
    n = i + 1
    np.testing.assert_allclose(ttraj[:n].numpy(), np.asarray(jtraj)[:n],
                               atol=1e-5)
    assert abs(float(terr) - float(jerr)) <= 1e-3 * max(float(jerr), 1.0)
    moved = np.abs(ttraj[:n].numpy() - st['traj_poses'][:n]).max(axis=1)
    assert moved[:i - 1].max() == 0 and moved[i - 1:].max() > 1e-3


def test_production_config():
    """The ``beam_cfg`` of bench.py (its KITTI cell at the defaults) with
    the HDL-64 elevation span."""
    elev_min = float(np.deg2rad(jvs.HDL64_ELEV_DEG.min()) - 0.01)
    elev_max = float(np.deg2rad(jvs.HDL64_ELEV_DEG.max()) + 0.01)
    C = jcfg
    want = C.EstimatorConfig(
        laser_track=C.LaserTrackConfig(
            nscan_in_sub_map=5,
            odometry_noise_model=(0.02,) * 3 + (0.05,) * 3,
            icp_noise_model=(0.005,) * 6,
            input_filters=C.InputFilterConfig(scan_capacity=131072,
                                              store_capacity=32768),
            icp=C.IcpConfig(matcher='projective', reading_capacity=8192,
                            reading_sampling_ratio=0.5,
                            normal_method='image_pca',
                            normal_image_rows=32, normal_image_cols=1024,
                            range_image_rows=64, range_image_cols=1024,
                            range_image_elev_min=elev_min,
                            range_image_elev_max=elev_max)),
        solver=C.SolverConfig(gn_iterations=3, gn_tolerance=1e-4,
                              pcg_iterations=32, window=64))
    assert dataclasses.asdict(tcfg.production_config()) == \
        dataclasses.asdict(want)
    c16 = tcfg.production_config(16384, 16384, 512, 256)
    assert (c16.laser_track.input_filters.store_capacity,
            c16.laser_track.icp.range_image_cols,
            c16.laser_track.icp.normal_image_cols) == (16384, 512, 256)


@pytest.mark.slow
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_production_parity_on_beam_sequence_vs_oracle(seed):
    """tests/test_parity.py::test_production_config_parity_on_beam_sequence
    with the port's runner (its generator seeded with ``seed``): the
    80-scan beam stream with 3 loop closures, held to ground truth by
    that test's rule (mean error within 2.5x the oracle's, or 5 cm) and
    to the float64 oracle within 20 cm / 1 deg.

    test_parity's own 10 cm bound is one draw of the JAX package's PRNG
    measured on a TPU; its run on the CPU ends 9.25 cm from the oracle.
    Over 80 scans the path amplifies f32 rounding and the reading's
    random draw into centimetres: the port's draws end 9.8-15.4 cm from
    the oracle over these seeds, while their mean error to ground truth
    stays near the oracle's (1.8-6.1 cm against 5.0-6.3 cm).  So the
    oracle gap is held at twice test_parity's bound (ROADMAP queue 3)."""
    from oracle import OracleSlam
    n_scans = 80
    frames = list(tvs.BeamStream(n_scans=n_scans, n_beams=64, n_azimuth=256,
                                 trajectory='circle', radius_m=15.0,
                                 world_size_m=60.0, range_noise_m=0.01,
                                 odom_noise=0.003, seed=21, laps=2))
    half = n_scans // 2
    closure_at = {i: (i - half, i) for i in range(half + 10, n_scans, 10)}
    cfg = tcfg.production_config(16384, 16384, 512, 256,
                                 reading_capacity=4096, window=32,
                                 coarse_capacity=512, gn_steps_per_match=4)
    runner = ton.OnlineRunner(cfg, pose_capacity=128, factor_capacity=512,
                              seed=seed, device='cpu')
    lt = cfg.laser_track
    oracle = OracleSlam(
        nscan_in_sub_map=lt.nscan_in_sub_map,
        odometry_sigmas=lt.odometry_noise_model,
        icp_sigmas=lt.icp_noise_model,
        loop_closure_sigmas=cfg.loop_closure_noise_model,
        prior_sigma=cfg.prior_noise_sigma,
        robust_icp=lt.add_m_estimator_on_icp,
        robust_lc=cfg.add_m_estimator_on_loop_closures,
        knn=10, solver_iterations=3)
    for idx, f in enumerate(frames):
        runner.process_scan(f.time_ns, f.points, f.odom_pose7)
        oracle.process_scan(f.time_ns, f.points, f.odom_pose7)
        if idx in closure_at:
            a, b = closure_at[idx]
            w_T = closure(frames, runner.trajectory(), a, b)
            runner.add_loop_closure(a, b, w_T)
            oracle.add_loop_closure(a, b, w_T)
    t_port = runner.trajectory()
    t_ora = oracle.trajectory()
    port = np.stack([t_port[f.time_ns] for f in frames])
    ora = np.stack([t_ora[f.time_ns] for f in frames])
    dt, dr = gaps(port, ora)
    gt = np.stack([f.gt_pose7 for f in frames])
    err = np.linalg.norm(port[:, 4:] - gt[:, 4:], axis=1).mean()
    err_ora = np.linalg.norm(ora[:, 4:] - gt[:, 4:], axis=1).mean()
    print(f'\nseed {seed}: vs oracle {100 * dt:.2f} cm, {dr:.3f} deg; mean '
          f'error to ground truth {100 * err:.2f} cm, oracle '
          f'{100 * err_ora:.2f} cm')
    assert dt < 0.20 and dr < 1.0, (dt, dr)
    assert err < max(2.5 * err_ora, 0.05), (err, err_ora)
