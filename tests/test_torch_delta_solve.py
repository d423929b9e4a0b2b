"""The port's delta closure solve and cached covariances against the JAX
package's: ``solver._stale_matvec``, the cache's build-point Hessian
(``T_B``, ``T_A``, ``cn2``), ``solve_closure_cached``,
``marginal_covariance_cached``, the runner's ``closure_solve='delta'``
(tests/test_solver_cache.py:397) and the runner's covariance route
(tests/test_online.py:698).

Each JAX program runs once, in a module fixture.  Tolerances: twice the
gap measured on the CPU, and at least 1e-5 at the solver level and 1 mm
/ 0.01 deg at the runner level.  The build-point blocks and the stale
matvec: 1e-5 of the largest entry (measured 9.3e-8 and 1.6e-7: the sums
over factors round in another order).  The delta solve's poses: 1e-5
(measured 1.2e-7).  The cached covariances: rtol 1e-3 of JAX's
(tests/test_solver_cache.py:262) with a floor of 2e-5 of the largest
entry (measured 9.4e-6 of it: both run the same f32 PCG).  The runners:
1 mm / 0.01 deg (measured 1.0e-5 m and 3.9e-5 deg).  JAX's answer for a
key added after the cache's build is the identity within 9.5e-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_slam_tpu import config as jcfg
from laser_slam_tpu.graph import factors as fg
from laser_slam_tpu.graph import solver as jsv
from laser_slam_tpu.ops import se3 as jse3
from laser_slam_tpu.pipeline import online as jon
from laser_slam_tpu.pipeline import replay as jrep
from laser_slam_tpu_torch.config import (EstimatorConfig, IcpConfig,
                                         InputFilterConfig, LaserTrackConfig,
                                         SolverConfig)
from laser_slam_tpu_torch.graph import solver as tsv
from laser_slam_tpu_torch.graph.factors import FactorGraphData
from laser_slam_tpu_torch.pipeline import online as ton

torch.set_num_threads(2)
SIG = np.full(6, 0.01, np.float32)
PRIOR_SIG = np.full(6, 1e-7, np.float32)
N = CAP = 64
# One solver config for every solver-level program, so each compiles
# once: the delta solve reads gn_*, delta_refine and cauchy_k, the probes
# the PCG budget of tests/test_solver_cache.py:254.
CFG = dict(gn_iterations=3, pcg_iterations=128, pcg_tolerance=1e-9,
           preconditioner='woodbury', offchain_capacity=8, delta_refine=3)
KEYS = [1, N // 2, N - 1]
BLOCK_RTOL = 1e-5
POSE_ATOL = 1e-5
COV_RTOL, COV_FLOOR = 1e-3, 2e-5
TRANS_TOL_M, ROT_TOL_DEG = 1e-3, 0.01
# Jitted once: eager jnp ops compile one by one.
compose, exp, inverse = (jax.jit(f) for f in (jse3.compose, jse3.exp,
                                               jse3.inverse))


def build_loopy_chain(rng, n=N, n_lc=3):
    """Chain + evenly spaced loop closures, measurements from ground
    truth (tests/test_solver_cache.py::build_loopy_chain)."""
    xis = rng.normal(size=(n - 1, 6)).astype(np.float32) * 0.1
    poses = [np.asarray(jse3.identity())]
    for i in range(n - 1):
        poses.append(np.asarray(compose(poses[-1], exp(xis[i]))))
    gt = np.stack(poses)
    g = fg.HostGraph()
    g.add_prior(0, gt[0], PRIOR_SIG)
    for i in range(n - 1):
        g.add_relative(i, i + 1, relative(gt, i, i + 1), SIG)
    for k in range(n_lc):
        a = k * (n // (n_lc + 1))
        b = a + n // 2
        if b < n:
            g.add_relative(a, b, relative(gt, a, b), SIG * 0.5)
    return g, gt


def relative(gt, a, b):
    """gt[a]^-1 gt[b] as numpy."""
    return np.array(compose(inverse(gt[a]), gt[b]))


def pad_poses(poses_np, rng, capacity=CAP, jitter=0.05):
    """tests/test_solver_cache.py::pad_poses, as numpy."""
    n = poses_np.shape[0]
    out = np.zeros((capacity, 7), np.float32)
    out[:, 0] = 1.0
    out[:n] = poses_np
    out[1:n, 4:] += rng.normal(size=(n - 1, 3)).astype(np.float32) * jitter
    mask = np.zeros(capacity, bool)
    mask[:n] = True
    return out, mask


def to_torch_graph(jgraph) -> FactorGraphData:
    return FactorGraphData(*[torch.tensor(np.asarray(a)) for a in jgraph])


def np_fields(cache, names):
    return {k: np.asarray(getattr(cache, k)) for k in names}


def assert_rel(got, want, rtol, err_msg=''):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max(),
                               err_msg=err_msg)


@pytest.fixture(scope='module')
def scene():
    """The warm loopy chain of tests/test_solver_cache.py:359 and every
    JAX result the solver-level cases compare with.  The new closure (5,
    N-8) is 5 cm off the current estimate; the stale cache is built when
    only the first half of the poses existed, so the closure's key N-8
    rides an identity row of its chain (JAX rejects that step)."""
    rng = np.random.default_rng(42)
    g, gt = build_loopy_chain(rng)
    poses, mask = pad_poses(gt, rng)
    jc = jcfg.SolverConfig(**CFG)
    jg = g.to_device()
    jm = jnp.asarray(mask)
    # The warm state is input data: the port's converged solve makes it.
    warm = tsv.solve(to_torch_graph(jg), torch.tensor(poses),
                     torch.tensor(mask), SolverConfig(**CFG)).poses.numpy()
    jw = jnp.asarray(warm)
    meas = relative(gt, 5, N - 8)
    meas[4] += 0.05
    idx = g.add_relative(5, N - 8, meas, SIG * 0.5)
    jg2 = g.to_device()
    half = mask.copy()
    half[N // 2:] = False
    built = jsv.build_cache(jg, jw, jm, jc)
    extended, delta = jsv.solve_closure_cached(jg2, jw, jm, built,
                                               jnp.int32(idx), jc)
    _, rejected = jsv.solve_closure_cached(
        jg2, jw, jm, jsv.build_cache(jg, jw, jnp.asarray(half), jc),
        jnp.int32(idx), jc)
    x = rng.normal(size=(CAP, 6)).astype(np.float32)
    stale = jax.jit(lambda c, v: jsv._stale_matvec(c)(v))
    jkeys = jnp.asarray(KEYS, jnp.int32)
    names = ('T_B', 'T_A', 'cn2', 'Ua', 'ka', 'n_used')
    return dict(
        g=jg, g2=jg2, idx=idx, warm=warm, mask=mask, half=half, x=x,
        built=np_fields(built, names), extended=np_fields(extended, names),
        mv_built=np.asarray(stale(built, jnp.asarray(x))),
        mv_extended=np.asarray(stale(extended, jnp.asarray(x))),
        delta=np.asarray(delta.poses),
        delta_error=float(delta.error_final),
        delta_iterations=int(delta.pcg_iterations),
        error_before=float(jax.jit(jsv.graph_error)(jg2, jw)),
        rejected=np.asarray(rejected.poses),
        # Covariances from the cache built on the base graph (fresh),
        # queried on the grown graph (stale), and from the extended one.
        cov_fresh=np.asarray(jsv.marginal_covariance_cached(
            jg, jw, jm, jkeys, built, jc)),
        cov_stale=np.asarray(jsv.marginal_covariance_cached(
            jg2, jw, jm, jkeys, built, jc)),
        cov_extended=np.asarray(jsv.marginal_covariance_cached(
            jg2, jw, jm, jkeys, extended, jc)))


def port_scene(scene):
    """The port's base graph, grown graph, warm poses, mask and config."""
    return (to_torch_graph(scene['g']), to_torch_graph(scene['g2']),
            torch.tensor(scene['warm']), torch.tensor(scene['mask']),
            SolverConfig(**CFG))


def test_cache_keeps_the_build_point_hessian_as_jax(scene):
    """T_B, T_A (unboosted chain blocks) and cn2 after build_cache and
    after extend_cache, beside the slots the extension writes."""
    tg, tg2, warm, mask, cfg = port_scene(scene)
    built = tsv.build_cache(tg, warm, mask, cfg)
    ext = tsv.extend_cache(tg2, warm, mask, tsv.clone_cache(built),
                           torch.tensor(scene['idx']), cfg)
    for label, tc, want in (('built', built, scene['built']),
                            ('extended', ext, scene['extended'])):
        for name in ('T_B', 'T_A', 'cn2', 'Ua'):
            assert_rel(getattr(tc, name).numpy(), want[name], BLOCK_RTOL,
                       f'{label} {name}')
        for name in ('ka', 'n_used'):
            np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                          want[name], f'{label} {name}')
    # The extension wrote cn2 at the new slot only; the chain blocks are
    # the build's (shared, not copied, by clone_cache).
    slot = int(built.n_used)
    assert float(ext.cn2[slot].min()) > 0
    assert float(built.cn2[slot].max()) == 0
    assert torch.equal(ext.cn2[:slot], built.cn2[:slot])
    assert ext.T_B is built.T_B and ext.T_A is built.T_A


@pytest.mark.parametrize('which', ['built', 'extended'])
def test_stale_matvec_matches_jax(scene, which):
    tg, tg2, warm, mask, cfg = port_scene(scene)
    cache = tsv.build_cache(tg, warm, mask, cfg)
    if which == 'extended':
        cache = tsv.extend_cache(tg2, warm, mask, cache,
                                 torch.tensor(scene['idx']), cfg)
    x = torch.tensor(scene['x'])
    mv = tsv._stale_matvec(cache)
    got = mv(x).numpy()
    want = scene['mv_' + which]
    assert_rel(got, want, BLOCK_RTOL)
    # A batch [N,6,B] is B products at once.
    xb = torch.stack([x, 2 * x, -x], dim=-1)
    np.testing.assert_allclose(mv(xb)[..., 1].numpy(), 2 * got, rtol=1e-6,
                               atol=1e-6 * np.abs(got).max())
    if which == 'built':
        # At the build point the stale Hessian is the fresh one: the
        # chain matvec of the same linearization (damping included).
        lin = tsv._linearize(tg, warm, mask, cfg.cauchy_k)
        fresh = tsv._make_matvec(lin, cfg.damping, cfg, offchain=8)(x)
        assert_rel(got, fresh.numpy(), BLOCK_RTOL)


def test_solve_closure_cached_matches_jax(scene):
    """tests/test_solver_cache.py:359: the warm chain, a closure 5 cm
    off; the poses as JAX's, the cache one slot fuller, the error down,
    and JAX's count of refinements (delta_refine a step that ran)."""
    tg, tg2, warm, mask, cfg = port_scene(scene)
    cache = tsv.build_cache(tg, warm, mask, cfg)
    n0 = int(cache.n_used)
    cache, res = tsv.solve_closure_cached(tg2, warm, mask, cache,
                                          torch.tensor(scene['idx']), cfg)
    np.testing.assert_allclose(res.poses.numpy(), scene['delta'],
                               atol=POSE_ATOL)
    assert not np.allclose(res.poses.numpy(), scene['warm'], atol=1e-3)
    assert int(cache.n_used) == n0 + 1
    assert float(res.error_final) < scene['error_before']
    assert abs(float(res.error_final) - scene['delta_error']) <= (
        1e-4 * scene['delta_error'])
    assert float(res.error_initial) == -1.0
    assert int(res.pcg_iterations) == scene['delta_iterations']


def test_solve_closure_cached_rejects_a_stale_step_as_jax(scene):
    """A cache built before the closure's key existed: the step model
    oversteps the key's identity row, the fresh gradient norm grows, and
    both packages return the input poses unchanged."""
    tg, tg2, warm, mask, cfg = port_scene(scene)
    stale = tsv.build_cache(tg, warm, torch.tensor(scene['half']), cfg)
    _, res = tsv.solve_closure_cached(tg2, warm, mask, stale,
                                      torch.tensor(scene['idx']), cfg)
    np.testing.assert_array_equal(scene['rejected'], scene['warm'])
    np.testing.assert_array_equal(res.poses.numpy(), scene['warm'])


def assert_cov_close(got, want):
    np.testing.assert_allclose(got, want, rtol=COV_RTOL,
                               atol=COV_FLOOR * np.abs(want).max())


def test_marginal_covariance_cached_matches_jax(scene):
    """tests/test_solver_cache.py:246: fresh (the cache of the graph it
    queries), stale (a closure the cache never saw is invisible: the
    pre-closure covariances) and extended (the closure absorbed: the
    one-shot probes of the grown graph)."""
    tg, tg2, warm, mask, cfg = port_scene(scene)
    keys = torch.tensor(KEYS)
    built = tsv.build_cache(tg, warm, mask, cfg)
    fresh = tsv.marginal_covariance_cached(tg, warm, mask, keys, built, cfg)
    stale = tsv.marginal_covariance_cached(tg2, warm, mask, keys, built,
                                           cfg)
    ext = tsv.extend_cache(tg2, warm, mask, tsv.clone_cache(built),
                           torch.tensor(scene['idx']), cfg)
    extended = tsv.marginal_covariance_cached(tg2, warm, mask, keys, ext,
                                              cfg)
    for got, name in ((fresh, 'fresh'), (stale, 'stale'),
                      (extended, 'extended')):
        assert_cov_close(got.numpy(), scene['cov_' + name])
    for got, graph in ((fresh, tg), (extended, tg2)):
        oneshot = tsv.marginal_covariance(graph, warm, mask, keys, cfg)
        assert_cov_close(got.numpy(), oneshot.numpy())
    assert_cov_close(stale.numpy(), fresh.numpy())
    assert not np.allclose(extended.numpy(), fresh.numpy(), rtol=COV_RTOL,
                           atol=COV_FLOOR)
    assert float(fresh[0].abs().max()) > 0      # key 1 is free


def runner_config(**solver):
    """tests/test_solver_cache.py:408's runner config."""
    return EstimatorConfig(
        laser_track=LaserTrackConfig(
            nscan_in_sub_map=3,
            odometry_noise_model=(0.02,) * 3 + (0.05,) * 3,
            icp_noise_model=(0.01,) * 6,
            input_filters=InputFilterConfig(scan_capacity=1024),
            icp=IcpConfig(matcher='brute', reading_capacity=512,
                          reading_sampling_ratio=1.0)),
        solver=SolverConfig(**solver))


DELTA_SOLVER = dict(gn_iterations=3, pcg_iterations=48, pcg_tolerance=1e-7,
                    preconditioner='woodbury', closure_solve='delta',
                    offchain_capacity=8)
DELTA_CAPS = dict(pose_capacity=32, factor_capacity=128)
# tests/test_online.py:707's runner: make_config() with its solver.
COV_SOLVER = dict(gn_iterations=2, pcg_iterations=96, pcg_tolerance=1e-9,
                  preconditioner='woodbury')
COV_CAPS = dict(pose_capacity=16, factor_capacity=64)
COV_KEYS = [0, 3, 6]


def cov_config():
    cfg = runner_config(**COV_SOLVER)
    lt = cfg.laser_track
    return dataclasses.replace(cfg, laser_track=dataclasses.replace(
        lt, input_filters=dataclasses.replace(lt.input_filters,
                                              scan_capacity=2048),
        icp=dataclasses.replace(lt.icp, reading_capacity=1024)))


def jax_config(cfg):
    return jcfg._from_dict(jcfg.EstimatorConfig, dataclasses.asdict(cfg))


def world_alignment(frames, traj, a, b):
    """w_T_a_b that encodes the true relative pose with the current
    estimates (incremental_estimator.cpp:83-87)."""
    rel = compose(inverse(frames[a].gt_pose7), frames[b].gt_pose7)
    return np.asarray(compose(traj[frames[a].time_ns], compose(
        rel, inverse(traj[frames[b].time_ns]))), np.float32)


def as_array(traj):
    return np.stack(list(traj.values()))


def rot_deg(q1, q2):
    """Angle of the relative rotation q1^-1 q2, in float64 from its
    vector part (an arccos of the dot product reads the float32 norm
    error of a quaternion, ~1e-8, as 0.01-0.04 deg)."""
    q1, q2 = q1.astype(np.float64), q2.astype(np.float64)
    w1, v1, w2, v2 = q1[:, 0], q1[:, 1:], q2[:, 0], q2[:, 1:]
    w = w1 * w2 + np.sum(v1 * v2, axis=1)
    v = w1[:, None] * v2 - w2[:, None] * v1 - np.cross(v1, v2)
    return np.degrees(2 * np.arctan2(np.linalg.norm(v, axis=1), np.abs(w)))


def assert_runner_close(got, want):
    assert np.all(np.isfinite(got))
    assert np.linalg.norm(got[:, 4:] - want[:, 4:], axis=1).max() < (
        TRANS_TOL_M)
    assert rot_deg(got[:, :4], want[:, :4]).max() < ROT_TOL_DEG


@pytest.fixture(scope='module')
def delta_runner():
    """tests/test_solver_cache.py:397's delta runner: 16 scans of a 10 m
    circle, the closures (2, 9) and (4, 12), then refine(1).  The
    alignments are JAX's, computed from its estimates."""
    frames = list(jrep.SyntheticStream(
        n_scans=16, points_per_scan=1024, trajectory='circle',
        radius_m=10.0, laps=1, noise_m=0.005, odom_noise=0.01, seed=11))
    jr = jon.OnlineRunner(jax_config(runner_config(**DELTA_SOLVER)),
                          **DELTA_CAPS)
    for f in frames:
        jr.process_scan(f.time_ns, f.points, f.odom_pose7)
    closures = []
    for a, b in ((2, 9), (4, 12)):
        closures.append((a, b, world_alignment(frames, jr.trajectory(), a,
                                               b)))
        jr.add_loop_closure(a, b, closures[-1][2])
    delta = as_array(jr.trajectory())
    jr.refine(1)
    return frames, closures, delta, as_array(jr.trajectory())


def test_runner_delta_closures_match_jax(delta_runner):
    """closure_solve='delta' through OnlineRunner.add_loop_closure: the
    port's trajectory as JAX's after the closures and after refine(1),
    and within the JAX test's own bounds to ground truth (0.35 m, then
    0.2 m)."""
    frames, closures, jdelta, jrefined = delta_runner
    tr = ton.OnlineRunner(runner_config(**DELTA_SOLVER), device='cpu',
                          **DELTA_CAPS)
    for f in frames:
        tr.process_scan(f.time_ns, f.points, f.odom_pose7)
    used = []
    for a, b, w_T in closures:
        assert tr.add_loop_closure(a, b, w_T)
        used.append(int(tr._solver_cache.n_used))
    assert used[1] == used[0] + 1
    gt = np.stack([f.gt_pose7 for f in frames])
    for want, bound in ((jdelta, 0.35), (jrefined, 0.2)):
        if bound == 0.2:
            tr.refine(1)
        got = as_array(tr.trajectory())
        assert_runner_close(got, want)
        assert np.abs(got[:, 4:] - gt[:, 4:]).max() < bound


@pytest.fixture(scope='module')
def cov_runner():
    """tests/test_online.py:698's runner (woodbury, 2 GN x 96 PCG) over 8
    scans of a 4 m circle, the closure (1, 6), covariances with its live
    cache; then 2 more scans and a query holding key 9, which the cache
    (built at the closure, 8 keys) knows only as an identity row."""
    frames = list(jrep.SyntheticStream(
        n_scans=10, points_per_scan=2048, trajectory='circle', radius_m=4.0,
        noise_m=0.005, odom_noise=0.01, seed=82))
    jr = jon.OnlineRunner(jax_config(cov_config()), **COV_CAPS)
    for f in frames[:8]:
        jr.process_scan(f.time_ns, f.points, f.odom_pose7)
    before = {k: np.array(v) for k, v in jr.state._asdict().items()
              if k != 'rng_key'}
    w_T = world_alignment(frames, jr.trajectory(), 1, 6)
    jr.add_loop_closure(1, 6, w_T)
    covs = jr.marginal_covariances(COV_KEYS)
    for f in frames[8:]:
        jr.process_scan(f.time_ns, f.points, f.odom_pose7)
    late = jr.marginal_covariances([3, 9])
    return frames, before, w_T, covs, late


@pytest.fixture(scope='module')
def port_cov_runner(cov_runner):
    """The port's runner over the same 8 scans, then put at the JAX
    runner's state before the closure, with the same closure added: the
    same cache, built from the same state."""
    frames, before, w_T, _, _ = cov_runner
    tr = ton.OnlineRunner(cov_config(), device='cpu', **COV_CAPS)
    for f in frames[:8]:
        tr.process_scan(f.time_ns, f.points, f.odom_pose7)
    tr.state = ton.state_from_numpy(before, device='cpu')
    assert tr.add_loop_closure(1, 6, w_T)
    return tr


def test_runner_covariances_take_the_cache_as_jax(cov_runner,
                                                  port_cov_runner):
    """With its live cache the port's runner answers the keys the cache
    holds by marginal_covariance_cached, as the JAX runner does."""
    jcovs = cov_runner[3]
    tr = port_cov_runner
    covs = tr.marginal_covariances(COV_KEYS)
    assert tr.covariance_route == 'cached'
    assert_cov_close(covs, jcovs)
    assert np.trace(covs[0]) < 1e-6       # the gauge-pinned first key
    tr.marginal_covariances(COV_KEYS, exact=True)
    assert tr.covariance_route == 'exact'


def test_runner_covariance_of_a_later_key_takes_the_probes(
        cov_runner, port_cov_runner):
    """The recorded departure (ROADMAP queue 3): after 2 more scans, a
    query holding key 9 (past the cache's 8 keys) takes the one-shot
    probes and matches the exact covariance, where the JAX runner
    answers about an identity 6x6 from the cache's identity row."""
    frames, jlate = cov_runner[0], cov_runner[4]
    tr = port_cov_runner
    for f in frames[8:]:
        tr.process_scan(f.time_ns, f.points, f.odom_pose7)
    assert tr._solver_cache is not None and tr._cache_pose_count == 8
    late = tr.marginal_covariances([3, 9])
    assert tr.covariance_route == 'probes'
    exact = tr.marginal_covariances([3, 9], exact=True)
    np.testing.assert_allclose(late, exact, rtol=2e-3,
                               atol=1e-5 * np.abs(exact).max())
    eye = np.eye(6)
    assert np.abs(jlate[1] - eye).max() < 1e-3, jlate[1]
    assert np.abs(late[1] - eye).max() > 0.5
    # Key 3 alone still takes the cache.
    tr.marginal_covariances([3])
    assert tr.covariance_route == 'cached'
