"""The port's marginal covariances against the JAX package's: the f32
probes (solver.marginal_covariance, one batched PCG) and the float64
exact path (solver.marginal_covariance_exact: a dense Cholesky in torch
where JAX factors with scipy's sparse LU), on the graphs of
tests/test_solver.py:153 and tests/test_solver_cache.py:467/487, an
interleaved two-track graph, and the online runner (tests/test_online.py:
479).

Tolerances, each with an absolute floor scaled to the largest entry of
the compared blocks (SCALED) for the near-zero cross terms.  Probes: rtol
1e-3 of JAX's probes (both run the same f32 PCG; sums round in another
order), floor 1e-5.  Exact: rtol 1e-9 of JAX's, floor 1e-9, on graphs
whose f32 linearization is exact (identity rotations, integer
translations, zero residuals), so both factor the same float64 matrix;
on the weakly anchored chain a Cholesky and a pivoted LU of a matrix of
condition ~1e10 differ by 8e-8 (measured; rtol 1e-6 held).  Where the
f32 linearizations themselves round differently (random rotations, a
runner's state) the exact results agree to 2.8e-5 (measured; rtol 1e-4
held).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_slam_tpu import config as jcfg
from laser_slam_tpu.config import SolverConfig as JSolverConfig
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
STEP = np.array([1, 0, 0, 0, 1, 0, 0], np.float32)


def padded(poses_np, capacity):
    out = np.zeros((capacity, 7), np.float32)
    out[:, 0] = 1.0
    out[:len(poses_np)] = poses_np
    mask = np.zeros(capacity, bool)
    mask[:len(poses_np)] = True
    return out, mask


def random_chain(rng, n, scale, closures=()):
    """Ground-truth chain with exact odometry and (a, b) closures
    (tests/test_solver_cache.py::build_loopy_chain)."""
    xis = rng.normal(size=(n - 1, 6)).astype(np.float32) * scale
    poses = [np.asarray(jse3.identity())]
    for xi in xis:
        poses.append(np.asarray(jse3.compose(jnp.asarray(poses[-1]),
                                             jse3.exp(jnp.asarray(xi)))))
    gt = np.stack(poses)
    g = fg.HostGraph()
    g.add_prior(0, gt[0], PRIOR_SIG)
    for a, b, s in [(i, i + 1, SIG) for i in range(n - 1)] + [
            (a, b, SIG * 0.5) for a, b in closures]:
        g.add_relative(a, b, np.asarray(jse3.compose(
            jse3.inverse(jnp.asarray(gt[a])), jnp.asarray(gt[b]))), s)
    return g, gt


def interleaved_tracks(n_per_track=12, linked=True):
    """Two tracks on interleaved keys (track t at keys 2i + t) along x,
    parked 100 m apart in y, both gauge-anchored; ``linked`` removes
    track 1's prior and adds a first-association link between their
    scans 3.  Identity rotations and integer translations: the f32
    linearization is exact."""
    n = 2 * n_per_track
    poses = np.zeros((n, 7), np.float32)
    poses[:, 0] = 1.0
    poses[:, 4] = np.repeat(np.arange(n_per_track), 2)
    poses[1::2, 5] = 100.0
    g = fg.HostGraph(rel_capacity=64, prior_capacity=4)
    g.add_prior(0, poses[0], PRIOR_SIG)
    p1 = g.add_prior(1, poses[1], PRIOR_SIG)
    for t in range(2):
        for i in range(n_per_track - 1):
            g.add_relative(2 * i + t, 2 * i + 2 + t, STEP, SIG)
    if linked:
        g.remove_prior(p1)
        g.add_relative(6, 7, np.array([1, 0, 0, 0, 0, 100, 0], np.float32),
                       np.full(6, 0.05, np.float32))
    return g, poses


def both(g, poses, mask, keys, **cfg):
    """(port probes, JAX probes, port exact, JAX exact)."""
    jg = g.to_device()
    tg = FactorGraphData(*[torch.tensor(np.asarray(a)) for a in jg])
    args_j = (jg, jnp.asarray(poses), jnp.asarray(mask))
    args_t = (tg, torch.tensor(poses), torch.tensor(mask))
    keys = np.asarray(keys)
    jp = np.asarray(jsv.marginal_covariance(
        *args_j, jnp.asarray(keys, jnp.int32), JSolverConfig(**cfg)))
    tp = tsv.marginal_covariance(*args_t, torch.tensor(keys),
                                 SolverConfig(**cfg)).numpy()
    je = jsv.marginal_covariance_exact(*args_j, keys, JSolverConfig(**cfg))
    te = tsv.marginal_covariance_exact(*args_t, keys, SolverConfig(**cfg))
    return tp, jp, te, je


def assert_close(got, want, rtol, floor):
    """rtol, with an absolute floor of ``floor`` times the largest entry
    (SCALED in the module docstring)."""
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * np.abs(want).max())


def assert_probes_close(tp, jp):
    assert_close(tp, jp, 1e-3, 1e-5)


@pytest.mark.parametrize('variant', [
    dict(), dict(preconditioner='woodbury', offchain_capacity=8),
    dict(preconditioner='jacobi'), dict(matvec='scatter'),
    dict(preconditioner='woodbury', pcg_init='precond')],
    ids=['tridiagonal', 'woodbury', 'jacobi', 'scatter', 'precond-init'])
def test_probes_and_exact_match_jax_on_a_loopy_chain(rng, variant):
    """tests/test_solver_cache.py:467: a 64-pose chain with three
    closures, from jittered poses; probes and exact agree with JAX's and
    with each other within rtol 2e-3 / atol 1e-5."""
    g, gt = random_chain(rng, 64, 0.1, closures=[(0, 32), (16, 48)])
    poses, mask = padded(gt, 64)
    poses[1:, 4:] += rng.normal(size=(63, 3)).astype(np.float32) * 0.02
    cfg = dict(gn_iterations=1, pcg_iterations=128, pcg_tolerance=1e-9,
               **variant)
    tp, jp, te, je = both(g, poses, mask, [0, 1, 32, 63], **cfg)
    assert_probes_close(tp, jp)
    assert_close(te, je, 1e-4, 1e-9)
    np.testing.assert_allclose(te, tp, rtol=2e-3, atol=1e-5)
    assert np.all(tp[0] == 0.0) and np.all(te[0] == 0.0)   # gauge-frozen


def test_covariance_grows_along_a_chain(rng):
    """tests/test_solver.py:153: uncertainty grows away from the prior."""
    g, gt = random_chain(rng, 6, 0.2)
    poses, mask = padded(gt, 8)
    tp, jp, te, je = both(g, poses, mask, [1, 5], gn_iterations=1,
                          pcg_iterations=200)
    assert_probes_close(tp, jp)
    assert np.trace(tp[1]) > np.trace(tp[0]) > 0
    assert np.trace(te[1]) > np.trace(te[0]) > 0


@pytest.mark.parametrize('linked', [False, True], ids=['parked', 'linked'])
def test_interleaved_tracks_match_jax_exactly(linked):
    """Two interleaved tracks: no factor lies on the chain, so both
    packages take the scatter matvec (offchain_capacity 8 < 22 off-chain
    factors); exact within rtol 1e-9 of JAX's.  The link's weak mode
    needs 256 PCG iterations (64 leave both packages' probes 5-80% short
    of it, apart by their rounding)."""
    g, gt = interleaved_tracks(linked=linked)
    poses, mask = padded(gt, 32)
    keys = [2, 3, 7, 22, 23]
    cfg = dict(gn_iterations=1, pcg_iterations=256, pcg_tolerance=1e-10,
               offchain_capacity=8)
    tp, jp, te, je = both(g, poses, mask, keys, **cfg)
    assert_close(te, je, 1e-9, 1e-9)
    assert_probes_close(tp, jp)
    if linked:
        # The absorbed track now hangs off track 0's anchor by the link.
        assert np.trace(te[4]) > np.trace(te[3]) > 0
    for c in te:
        np.testing.assert_allclose(c, c.T, atol=1e-12)
        assert np.linalg.eigvalsh(c).min() > -1e-12


def test_exact_recovers_the_weak_mode_the_probes_saturate_on():
    """tests/test_solver_cache.py:487 at 512 poses: the far key's lateral
    variance on a single-anchor chain is ~1e-4 n^3 / 3 m^2; the f32
    probes saturate far below it (as JAX's do) and the float64 path,
    within rtol 1e-6 of JAX's, recovers it."""
    n = 512
    g = fg.HostGraph(rel_capacity=1024, prior_capacity=4)
    poses = np.zeros((n, 7), np.float32)
    poses[:, 0] = 1.0
    poses[:, 4] = np.arange(n, dtype=np.float32)
    g.add_prior(0, poses[0], PRIOR_SIG)
    for i in range(n - 1):
        g.add_relative(i, i + 1, STEP, SIG)
    mask = np.ones(n, bool)
    tp, jp, te, je = both(g, poses, mask, [n - 1], gn_iterations=1,
                          pcg_iterations=32, pcg_tolerance=1e-9,
                          preconditioner='woodbury')
    np.testing.assert_allclose(te, je, rtol=1e-6)
    y_true = te[0, 4, 4]
    assert y_true > 1e3, y_true
    assert tp[0, 4, 4] < 0.1 * y_true and jp[0, 4, 4] < 0.1 * y_true


def test_batched_probes_equal_one_pcg_per_direction(rng):
    """The K x 6 batch is K x 6 independent PCG solves."""
    g, gt = random_chain(rng, 20, 0.1, closures=[(0, 10)])
    poses, mask = padded(gt, 32)
    tg = FactorGraphData(*[torch.tensor(np.asarray(a))
                           for a in g.to_device()])
    cfg = SolverConfig(gn_iterations=1, pcg_iterations=40,
                       pcg_tolerance=1e-6)
    P, M = torch.tensor(poses), torch.tensor(mask)
    keys = torch.tensor([3, 11, 19])
    cov = tsv.marginal_covariance(tg, P, M, keys, cfg)
    lin = tsv._linearize(tg, P, M, cfg.cauchy_k)
    apply_M = tsv._make_preconditioner(lin, cfg.damping, cfg)
    mv = tsv._make_matvec(lin, cfg.damping, cfg)
    for i, k in enumerate(keys.tolist()):
        for d in range(6):
            e = torch.zeros(32, 6)
            e[k, d] = 1.0
            x, _ = tsv._pcg(lin, e, cfg.damping, 40, 1e-6, apply_M,
                            matvec=mv)
            np.testing.assert_allclose(cov[i, d].numpy(), x[k].numpy(),
                                       rtol=1e-5, atol=1e-9)


def est_config():
    return EstimatorConfig(
        laser_track=LaserTrackConfig(
            nscan_in_sub_map=3,
            odometry_noise_model=(0.02,) * 3 + (0.05,) * 3,
            icp_noise_model=(0.01,) * 6,
            input_filters=InputFilterConfig(scan_capacity=2048),
            icp=IcpConfig(matcher='brute', reading_capacity=1024,
                          reading_sampling_ratio=1.0)),
        solver=SolverConfig(gn_iterations=2, pcg_iterations=30))


def test_runner_covariances_match_jax():
    """tests/test_online.py:479: symmetric positive semi-definite blocks,
    zero at the gauge-pinned first key, growing away from it; the port
    on the JAX runner's state matches the JAX runner's query."""
    cfg = est_config()
    frames = list(jrep.SyntheticStream(
        n_scans=5, points_per_scan=2048, trajectory='line', step_m=0.6,
        noise_m=0.005, odom_noise=0.01, seed=81))
    caps = dict(pose_capacity=16, factor_capacity=64)
    jr = jon.OnlineRunner(jcfg._from_dict(jcfg.EstimatorConfig,
                                          dataclasses.asdict(cfg)), **caps)
    tr = ton.OnlineRunner(cfg, device='cpu', **caps)
    for f in frames:
        jr.process_scan(f.time_ns, f.points, f.odom_pose7)
        tr.process_scan(f.time_ns, f.points, f.odom_pose7)
    keys = [0, 2, 4]
    for exact in (False, True):
        covs = tr.marginal_covariances(keys, exact=exact)
        assert covs.shape == (3, 6, 6)
        for c in covs:
            np.testing.assert_allclose(c, c.T, atol=1e-6)
            assert np.all(np.linalg.eigvalsh(c) > -1e-8)
        assert np.trace(covs[0]) < 1e-6
        assert np.trace(covs[2]) > np.trace(covs[1]) > 0
    tr.state = ton.state_from_numpy(
        {k: np.array(v) for k, v in jr.state._asdict().items()
         if k != 'rng_key'}, device='cpu')
    assert_probes_close(tr.marginal_covariances(keys),
                        jr.marginal_covariances(keys))
    assert_close(tr.marginal_covariances(keys, exact=True),
                 jr.marginal_covariances(keys, exact=True), 1e-4, 1e-9)
