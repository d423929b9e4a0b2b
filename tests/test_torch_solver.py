"""The port's Gauss-Newton/PCG solver against the JAX package's, on the
test_solver.py graphs (built with the JAX HostGraph, handed over as
numpy).

Tolerance: poses within 1e-4 — both run the same f32 PCG, but sums and
the dense root factorization round in another order, and PCG amplifies
that by the condition number of the graph.  Linearization and the
cyclic-reduction solve are compared tighter.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_slam_tpu.config import SolverConfig as JSolverConfig
from laser_slam_tpu.graph import factors as fg
from laser_slam_tpu.graph import solver as jsv
from laser_slam_tpu.ops import se3 as jse3
from laser_slam_tpu_torch.config import SolverConfig
from laser_slam_tpu_torch.graph import solver as tsv
from laser_slam_tpu_torch.graph.factors import FactorGraphData

torch.set_num_threads(2)
SIG = np.full(6, 0.01, np.float32)
PRIOR_SIG = np.full(6, 1e-7, np.float32)
POSE_ATOL = 1e-4


def build_chain(rng, n=16, noise=0.0):
    """Ground-truth chain of poses + (noisy) odometry (test_solver.py)."""
    xis = rng.normal(size=(n - 1, 6)).astype(np.float32) * 0.2
    poses = [np.asarray(jse3.identity())]
    for i in range(n - 1):
        poses.append(np.asarray(jse3.compose(jnp.asarray(poses[-1]),
                                             jse3.exp(jnp.asarray(xis[i])))))
    gt = np.stack(poses)
    g = fg.HostGraph()
    g.add_prior(0, gt[0], PRIOR_SIG)
    for i in range(n - 1):
        meas = jse3.compose(jse3.inverse(jnp.asarray(gt[i])),
                            jnp.asarray(gt[i + 1]))
        if noise > 0:
            meas = jse3.compose(meas, jse3.exp(jnp.asarray(
                rng.normal(size=6).astype(np.float32) * noise)))
        g.add_relative(i, i + 1, np.asarray(meas), SIG)
    return g, gt


# Every test graph is padded to one pose capacity so the JAX solve
# compiles once per solver config, not once per graph.
CAP = 32


def pad_poses(poses_np, capacity=CAP):
    out = np.zeros((capacity, 7), np.float32)
    out[:, 0] = 1.0
    out[:len(poses_np)] = poses_np
    mask = np.zeros(capacity, bool)
    mask[:len(poses_np)] = True
    return out, mask


def to_torch_graph(jgraph) -> FactorGraphData:
    return FactorGraphData(*[torch.tensor(np.asarray(a)) for a in jgraph])


def solve_both(g, poses, mask, **cfg):
    jg = g.to_device()
    jres = jsv.solve(jg, jnp.asarray(poses), jnp.asarray(mask),
                     JSolverConfig(**cfg))
    tres = tsv.solve(to_torch_graph(jg), torch.tensor(poses),
                     torch.tensor(mask), SolverConfig(**cfg))
    np.testing.assert_allclose(tres.poses.numpy(), np.asarray(jres.poses),
                               atol=POSE_ATOL)
    for name in ('error_initial', 'error_final'):
        j, t = float(getattr(jres, name)), float(getattr(tres, name))
        assert abs(t - j) <= 1e-3 * max(abs(j), 1.0), (name, t, j)
    return jres, tres


def graph_chain_exact(rng):
    g, gt = build_chain(rng, n=8)
    return g, *pad_poses(gt)


def graph_chain_perturbed(rng):
    g, gt = build_chain(rng, n=10)
    init = gt.copy()
    for i in range(1, 10):
        init[i] = np.asarray(jse3.compose(jnp.asarray(gt[i]), jse3.exp(
            jnp.asarray(rng.normal(size=6).astype(np.float32) * 0.05))))
    return g, *pad_poses(init)


def graph_loop_closure(rng):
    n = 20
    g, gt = build_chain(rng, n=n, noise=0.01)
    T_lc = jse3.compose(jse3.inverse(jnp.asarray(gt[0])),
                        jnp.asarray(gt[n - 1]))
    g.add_relative(0, n - 1, np.asarray(T_lc), SIG * 0.1)
    return g, *pad_poses(gt)


def graph_robust_outlier(rng):
    g, gt = build_chain(rng, n=8)
    bad = np.asarray(jse3.exp(jnp.asarray([0, 0, 0, 50, 0, 0], jnp.float32)))
    g.add_relative(0, 7, bad, SIG, robust=True)
    return g, *pad_poses(gt)


def graph_fixed_a(rng):
    g = fg.HostGraph()
    T0 = np.asarray(jse3.identity())
    T1 = np.asarray(jse3.exp(jnp.asarray([0, 0, 0, 1, 0, 0], jnp.float32)))
    g.add_prior(0, T0, PRIOR_SIG)
    T_meas = np.asarray(jse3.exp(jnp.asarray([0, 0, 0, 2, 0, 0],
                                             jnp.float32)))
    g.add_relative(0, 1, T_meas, SIG, fixed_a=True)
    return g, *pad_poses(np.stack([T0, T1]))


GRAPHS = {'chain_exact': graph_chain_exact,
          'chain_perturbed': graph_chain_perturbed,
          'loop_closure': graph_loop_closure,
          'robust_outlier': graph_robust_outlier,
          'fixed_a': graph_fixed_a}


# One solver budget for every graph keeps the JAX compiles to one per
# variant (the budgets of test_solver.py differ per graph).
BUDGET = dict(gn_iterations=3, pcg_iterations=60)


@pytest.mark.parametrize('graph', sorted(GRAPHS))
def test_solve_matches_jax(rng, graph):
    g, poses, mask = GRAPHS[graph](rng)
    solve_both(g, poses, mask, **BUDGET)


@pytest.mark.parametrize('variant', [
    dict(preconditioner='jacobi'), dict(matvec='scatter'),
    dict(offchain_capacity=0), dict(gn_tolerance=1e-3),
    dict(pcg_init='precond', compute_errors=False)],
    ids=['jacobi', 'scatter', 'chain-overflow', 'gn-tol', 'precond-init'])
def test_solve_variants_match_jax(rng, variant):
    g, poses, mask = graph_loop_closure(rng)
    solve_both(g, poses, mask, **BUDGET, **variant)


def test_prior_removal_unfreezes(rng):
    """estimateAndRemove: removing a track's prior lets a linking factor
    pull it (incremental_estimator.cpp:240-258)."""
    g = fg.HostGraph()
    T0 = np.asarray(jse3.identity())
    T1 = np.asarray(jse3.exp(jnp.asarray([0, 0, 0, 5, 0, 0], jnp.float32)))
    g.add_prior(0, T0, PRIOR_SIG)
    prior1 = g.add_prior(1, T1, PRIOR_SIG)
    T_link = np.asarray(jse3.exp(jnp.asarray([0, 0, 0, 4, 0, 0],
                                             jnp.float32)))
    g.add_relative(0, 1, T_link, SIG)
    poses, mask = pad_poses(np.stack([T0, T1]))
    _, tres = solve_both(g, poses, mask, **BUDGET)
    assert abs(float(tres.poses[1, 4]) - 5.0) < 1e-4
    g.remove_prior(prior1)
    _, tres = solve_both(g, poses, mask, **BUDGET)
    assert abs(float(tres.poses[1, 4]) - 4.0) < 1e-3


def test_long_chain_closure_with_cyclic_reduction():
    """A closure across a 500-pose chain; capacity 1024 runs one level of
    cyclic reduction above the dense 512-block root."""
    N, capacity = 500, 1024
    g = fg.HostGraph(rel_capacity=2048)
    poses = np.zeros((capacity, 7), np.float32)
    poses[:, 0] = 1
    poses[:N, 4] = np.arange(N)
    g.add_prior(0, poses[0], PRIOR_SIG)
    step = np.array([1, 0, 0, 0, 1, 0, 0], np.float32)
    for i in range(N - 1):
        g.add_relative(i, i + 1, step, SIG)
    g.add_relative(0, N - 1, np.array([1, 0, 0, 0, N - 2.0, 0, 0],
                                      np.float32), SIG * 0.1)
    mask = np.zeros(capacity, bool)
    mask[:N] = True
    _, tres = solve_both(g, poses, mask, gn_iterations=2, pcg_iterations=16)
    assert float(tres.error_final) < 15.0


def test_tridiag_solve_matches_jax_and_dense(rng):
    """Cyclic reduction (forced levels) vs JAX and a float64 dense solve,
    including non-power-of-two N and several right-hand sides."""
    N = 13
    X = rng.normal(size=(N, 8, 6)).astype(np.float32)
    D = np.einsum('nki,nkj->nij', X, X) + 3 * np.eye(6, dtype=np.float32)
    A = rng.normal(size=(N, 6, 6)).astype(np.float32) * 0.3
    A[0] = 0
    T = np.zeros((N * 6, N * 6))
    for i in range(N):
        T[i * 6:(i + 1) * 6, i * 6:(i + 1) * 6] = D[i]
        if i > 0:
            T[i * 6:(i + 1) * 6, (i - 1) * 6:i * 6] = A[i]
            T[(i - 1) * 6:i * 6, i * 6:(i + 1) * 6] = A[i].T
    r = rng.normal(size=(N, 6, 3)).astype(np.float32)
    want = np.linalg.solve(T, r.reshape(N * 6, 3)).reshape(N, 6, 3)
    for stop in (2, 512):
        jf = jax.jit(jsv._tridiag_factor, static_argnames='stop')(
            jnp.asarray(D), jnp.asarray(A), stop=stop)
        tf = tsv._tridiag_factor(torch.tensor(D), torch.tensor(A), stop=stop)
        x_t = tsv._tridiag_apply(tf, torch.tensor(r)).numpy()
        x_j = np.asarray(jax.jit(jsv._tridiag_apply)(jf, jnp.asarray(r)))
        np.testing.assert_allclose(x_t, want, atol=1e-4)
        np.testing.assert_allclose(x_t, x_j, atol=1e-5)
    x = tsv._tridiag_solve(torch.tensor(D), torch.tensor(A),
                           torch.tensor(r[..., 0])).numpy()
    np.testing.assert_allclose(x, want[..., 0], atol=1e-4)


def test_linearization_and_helpers_match_jax(rng):
    def rand_pose():
        return jse3.exp(jnp.asarray(rng.normal(size=6), jnp.float32))
    Ta = jnp.stack([rand_pose() for _ in range(8)])
    Tb = jnp.stack([rand_pose() for _ in range(8)])
    meas = jse3.compose(jse3.inverse(Ta), Tb)
    meas = jse3.compose(meas, jse3.exp(jnp.asarray(
        rng.normal(size=(8, 6)) * 0.05, jnp.float32)))
    j = jax.jit(jsv._rel_linearize_analytic)(Ta, Tb, meas)
    t = tsv._rel_linearize_analytic(*[torch.tensor(np.asarray(a))
                                      for a in (Ta, Tb, meas)])
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    jp = jax.jit(jsv._prior_linearize_analytic)(Ta, meas)
    tp = tsv._prior_linearize_analytic(torch.tensor(np.asarray(Ta)),
                                       torch.tensor(np.asarray(meas)))
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    H = np.einsum('nki,nkj->nij', *[rng.normal(size=(5, 9, 6))] * 2
                  ).astype(np.float32) + np.eye(6, dtype=np.float32)
    np.testing.assert_allclose(
        tsv._chol_inverse6(torch.tensor(H)).numpy(),
        np.asarray(jax.jit(jsv._chol_inverse6)(jnp.asarray(H))), rtol=1e-4,
        atol=1e-5)
    flags = rng.uniform(size=40) > 0.6
    for L in (3, 40):
        js, jv = jsv._first_true_indices(jnp.asarray(flags), L)
        ts, tv = tsv._first_true_indices(torch.tensor(flags), L)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_dense_and_woodbury_wait_for_later_slices(rng):
    """The dense method came with slice 2 and Woodbury with slice 3: both
    run on an exact chain and leave it where it is (held to JAX in
    test_dense_solve_matches_jax and the Woodbury tests below)."""
    g, gt = build_chain(rng, n=4)
    poses, mask = pad_poses(gt)
    graph = to_torch_graph(g.to_device())
    for variant in (dict(method='dense'), dict(preconditioner='woodbury')):
        res = tsv.solve(graph, torch.tensor(poses), torch.tensor(mask),
                        dataclasses.replace(SolverConfig(), **variant))
        np.testing.assert_allclose(res.poses.numpy(), poses, atol=1e-5)
    with pytest.raises(ValueError, match='preconditioner'):
        tsv.solve(graph, torch.tensor(poses), torch.tensor(mask),
                  dataclasses.replace(SolverConfig(), preconditioner='nope'))
    with pytest.raises(ValueError, match='method'):
        tsv.solve(graph, torch.tensor(poses), torch.tensor(mask),
                  dataclasses.replace(SolverConfig(), method='nope'))


# Dense solves: every graph at a 16-pose table (the window's size class),
# with and without the GN early-out.
DENSE = dict(method='dense', gn_iterations=3)


@pytest.mark.parametrize('graph', sorted(GRAPHS))
@pytest.mark.parametrize('gn_tol', [0.0, 1e-4])
def test_dense_solve_matches_jax(rng, graph, gn_tol):
    g, poses, mask = GRAPHS[graph](rng)
    if graph == 'loop_closure':
        poses, mask = poses[:20], mask[:20]
    else:
        poses, mask = poses[:16], mask[:16]
    solve_both(g, poses, mask, gn_tolerance=gn_tol, **DENSE)


def test_dense_factor_matches_jax_and_float64(rng):
    """The dense normal equations and their Cholesky solve against JAX
    and a float64 solve, with a frozen pose and a gauge prior."""
    g, poses, mask = graph_loop_closure(rng)
    poses, mask = poses[:20], mask[:20].copy()
    mask[12] = False
    jg = g.to_device()
    jlin = jax.jit(jsv._linearize, static_argnums=3)(
        jg, jnp.asarray(poses), jnp.asarray(mask), 1.0)
    tlin = tsv._linearize(to_torch_graph(jg), torch.tensor(poses),
                          torch.tensor(mask), 1.0)
    b = -tsv._gradient(tlin)
    x_t = tsv._dense_apply(tsv._dense_factor(tlin, 1e-6), b).numpy()
    x_j = np.asarray(jax.jit(lambda lin: jsv._dense_apply(
        jsv._dense_factor(lin, 1e-6), -jsv._gradient(lin)))(jlin))
    np.testing.assert_allclose(x_t, x_j, rtol=1e-4, atol=1e-5)
    H = np.zeros((120, 120))
    for i in range(120):
        e = np.zeros((20, 6), np.float32)
        e.flat[i] = 1.0
        H[:, i] = tsv._hessian_matvec(tlin, torch.tensor(e), 1e-6).numpy(
        ).reshape(-1)
    want = np.linalg.solve(H, b.numpy().reshape(-1).astype(np.float64))
    np.testing.assert_allclose(x_t.reshape(-1), want, rtol=1e-3, atol=1e-5)
    assert np.all(x_t[12] == 0) or np.allclose(x_t[12], 0, atol=1e-12)


def test_dense_factor_not_positive_definite_gives_nan():
    lin = tsv._LinearizedGraph(
        Ja=torch.zeros((1, 6, 6)), Jb=torch.zeros((1, 6, 6)),
        r_rel=torch.zeros((1, 6)), w_rel=torch.zeros(1),
        keys=torch.zeros((1, 2), dtype=torch.int64),
        Jp=torch.zeros((1, 6, 6)), r_prior=torch.zeros((1, 6)),
        w_prior=torch.zeros(1), prior_keys=torch.zeros(1, dtype=torch.int64),
        free=torch.ones(2))
    chol = tsv._dense_factor(lin, -1.0)
    assert bool(torch.all(torch.isnan(chol)))


# Woodbury: the preconditioner, its cache, the rank-6 extension and the
# cached solve.  The capacitance and its inverse factor are held within
# rtol 1e-4 of their largest entry (a [6L,6L] Cholesky in another
# order); poses after a solve within POSE_ATOL.
WOODBURY = dict(BUDGET, preconditioner='woodbury')


@pytest.mark.parametrize('graph', ['chain_perturbed', 'loop_closure',
                                   'robust_outlier'])
@pytest.mark.parametrize('init', ['zero', 'precond'])
def test_woodbury_solve_matches_jax(rng, graph, init):
    g, poses, mask = GRAPHS[graph](rng)
    solve_both(g, poses, mask, pcg_init=init, **WOODBURY)


def graph_two_closures(rng):
    """A noisy 20-pose chain with closures (3, 19) and (3, 12): two
    off-chain factors on one key.  Returns (graph, poses, mask, index of
    the second closure)."""
    n = 20
    g, gt = build_chain(rng, n=n, noise=0.01)
    for b in (19, 12):
        T = jse3.compose(jse3.inverse(jnp.asarray(gt[3])), jnp.asarray(gt[b]))
        idx = g.add_relative(3, b, np.asarray(T), SIG * 0.1)
    return (g, *pad_poses(gt), idx)


def assert_caches_match(tc, jc):
    for name in ('Ua', 'Ub'):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)), atol=1e-5,
                                   err_msg=name)
    for name in ('ka', 'kb', 'n_used'):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)),
                                      err_msg=name)
    want = np.asarray(jc.chol_inv)
    np.testing.assert_allclose(tc.chol_inv.numpy(), want,
                               atol=1e-4 * np.abs(want).max())


def test_woodbury_cache_and_apply_match_jax(rng):
    g, poses, mask, _ = graph_two_closures(rng)
    jg = g.to_device()
    cfg = dict(WOODBURY, offchain_capacity=8)
    jc = jsv.build_cache(jg, jnp.asarray(poses), jnp.asarray(mask),
                         JSolverConfig(**cfg))
    tc = tsv.build_cache(to_torch_graph(jg), torch.tensor(poses),
                         torch.tensor(mask), SolverConfig(**cfg))
    assert int(tc.n_used) == 3             # (0, 1) on the frozen key, 2 closures
    assert_caches_match(tc, jc)
    r = rng.normal(size=(CAP, 6)).astype(np.float32)
    want = np.asarray(jax.jit(lambda c, x: jsv._apply_from_cache(c)(x))(
        jc, jnp.asarray(r)))
    got = tsv._apply_from_cache(tc)(torch.tensor(r)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize('capacity', [8, 2], ids=['append', 'full'])
def test_extend_cache_and_solve_cached_match_jax(rng, capacity):
    """Build on the graph without its second closure on key 3, extend the
    cache with it, solve with the extended cache.  With capacity 2 the
    cache is full after the build, and the extension writes the last
    slot's own values back: the cache is unchanged."""
    g, poses, mask, idx = graph_two_closures(rng)
    jg = g.to_device()
    jg_build = jg._replace(rel_weight=jg.rel_weight.at[idx].set(0.0))
    cfg = dict(WOODBURY, offchain_capacity=capacity)
    jcfg_, tcfg_ = JSolverConfig(**cfg), SolverConfig(**cfg)
    jp, jm = jnp.asarray(poses), jnp.asarray(mask)
    tp, tm = torch.tensor(poses), torch.tensor(mask)
    tg = to_torch_graph(jg)
    jc = jsv.build_cache(jg_build, jp, jm, jcfg_)
    tc = tsv.build_cache(to_torch_graph(jg_build), tp, tm, tcfg_)
    assert int(tc.n_used) == 2
    before = tsv.clone_cache(tc)
    jc = jsv.extend_cache(jg, jp, jm, jc, jnp.int32(idx), jcfg_)
    tc = tsv.extend_cache(tg, tp, tm, tc, torch.tensor(idx), tcfg_)
    assert_caches_match(tc, jc)
    if capacity == 2:
        assert int(tc.n_used) == 2
        for name in ('Ua', 'Ub', 'ka', 'kb', 'chol_inv'):
            assert torch.equal(getattr(tc, name), getattr(before, name)), name
    else:
        assert int(tc.n_used) == 3
        assert tc.ka.tolist()[:3] == [0, 3, 3]
    jres = jsv.solve_cached(jg, jp, jm, jc, jcfg_)
    tres = tsv.solve_cached(tg, tp, tm, tc, tcfg_)
    np.testing.assert_allclose(tres.poses.numpy(), np.asarray(jres.poses),
                               atol=POSE_ATOL)
    # The same fixed point as a cold solve.
    cold = tsv.solve(tg, tp, tm, tcfg_)
    np.testing.assert_allclose(tres.poses.numpy(), cold.poses.numpy(),
                               atol=POSE_ATOL)


def test_failed_capacitance_falls_back_to_the_chain(rng):
    """A capacitance that is not positive definite factors to NaN in both
    packages (torch's cholesky_ex reports it without raising), and
    apply_M then equals the chain preconditioner's apply."""
    g, poses, mask, _ = graph_two_closures(rng)
    jg = g.to_device()
    cfg = dict(WOODBURY, offchain_capacity=8)
    jc = jsv.build_cache(jg, jnp.asarray(poses), jnp.asarray(mask),
                         JSolverConfig(**cfg))
    tc = tsv.build_cache(to_torch_graph(jg), torch.tensor(poses),
                         torch.tensor(mask), SolverConfig(**cfg))
    K = tc.chol_inv.shape[0]
    not_pd = -np.eye(K, dtype=np.float32)
    t_inv = torch.linalg.solve_triangular(
        tsv._factor_or_nan(torch.tensor(not_pd)), torch.eye(K), upper=False)
    j_inv = jax.scipy.linalg.solve_triangular(
        jnp.linalg.cholesky(jnp.asarray(not_pd)), jnp.eye(K), lower=True)
    assert bool(torch.all(torch.isnan(t_inv)))
    assert bool(jnp.all(jnp.isnan(j_inv)))
    r = rng.normal(size=(CAP, 6)).astype(np.float32)
    got = tsv._apply_from_cache(tc._replace(chol_inv=t_inv))(
        torch.tensor(r)).numpy()
    want = np.asarray(jsv._apply_from_cache(jc._replace(chol_inv=j_inv))(
        jnp.asarray(r)))
    chain = tsv._tridiag_apply(tc.factors, torch.tensor(r)).numpy()
    np.testing.assert_array_equal(got, chain)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_cholesky6_helpers_match_jax(rng):
    X = rng.normal(size=(4, 9, 6))
    H = (np.einsum('nki,nkj->nij', X, X) + np.eye(6)).astype(np.float32)
    jl = np.asarray(jax.jit(jsv._chol6_matrix)(jnp.asarray(H)))
    tl = tsv._chol6_matrix(torch.tensor(H)).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl @ np.swapaxes(tl, -1, -2), H, rtol=1e-4,
                               atol=1e-4)
    ti = tsv._lower6_inverse(torch.tensor(tl)).numpy()
    np.testing.assert_allclose(
        ti, np.asarray(jax.jit(jsv._lower6_inverse)(jnp.asarray(tl))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ti @ tl, np.broadcast_to(np.eye(6), H.shape),
                               atol=1e-4)


def graph_interleaved(rng):
    """Two noisy 8-pose chains on interleaved keys (track t at keys
    2i + t), each gauge-anchored, linked between their scans 3: no
    factor lands on the block-tridiagonal chain (the multi-robot
    runner's graphs)."""
    n = 8
    ga, gta = build_chain(rng, n=n, noise=0.01)
    gt = np.zeros((2 * n, 7), np.float32)
    gt[0::2] = gta
    _, gtb = build_chain(rng, n=n)
    gt[1::2] = gtb
    gt[1::2, 5] += 100.0
    g = fg.HostGraph()
    g.add_prior(0, gt[0], PRIOR_SIG)
    g.add_prior(1, gt[1], PRIOR_SIG)
    for t in range(2):
        for i in range(n - 1):
            a, b = 2 * i + t, 2 * i + 2 + t
            g.add_relative(a, b, np.asarray(jse3.compose(
                jse3.inverse(jnp.asarray(gt[a])), jnp.asarray(gt[b]))), SIG)
    g.add_relative(6, 7, np.asarray(jse3.compose(
        jse3.inverse(jnp.asarray(gt[6])), jnp.asarray(gt[7]))), SIG * 5)
    return g, *pad_poses(gt)


def host_offchain_bound(g):
    """The online runner's bound, from the factors' keys alone: active
    factors with key_b != key_a + 1 or on a prior's key."""
    jg = g.to_device()
    keys = np.asarray(jg.rel_keys)[np.asarray(jg.rel_weight) > 0]
    prior_keys = set(np.asarray(jg.prior_keys)[
        np.asarray(jg.prior_weight) > 0].tolist())
    return int(sum(b != a + 1 or a in prior_keys or b in prior_keys
                   for a, b in keys.tolist()))


@pytest.mark.parametrize('graph,capacity', [
    ('loop_closure', 64), ('loop_closure', 2), ('loop_closure', 1),
    ('interleaved', 64), ('interleaved', 8)])
def test_matvec_choice_matches_jax_without_a_read(rng, graph, capacity,
                                                  monkeypatch):
    """With the runner's host bound the port picks the chain or the
    scatter matvec as JAX's lax.cond does, on both sides of
    offchain_capacity (2 is the loop-closure graph's exact count: its
    closure and the factor on the gauge-frozen key 0), reads nothing
    back, and applies the same operator."""
    g, poses, mask = (graph_interleaved(rng) if graph == 'interleaved'
                      else graph_loop_closure(rng))
    cfg = dict(offchain_capacity=capacity)
    jg = g.to_device()
    jlin = jsv._linearize(jg, jnp.asarray(poses), jnp.asarray(mask), 1.0)
    covered = int(jnp.sum(jsv._offchain_mask(jlin))) <= capacity
    bound = host_offchain_bound(g)
    tlin = tsv._linearize(to_torch_graph(jg), torch.tensor(poses),
                          torch.tensor(mask), 1.0)
    assert bound >= int(torch.sum(tsv._offchain_mask(tlin)))

    def no_read(*_):
        raise AssertionError('device read while picking the matvec')
    for name in ('__int__', '__bool__', 'item'):
        monkeypatch.setattr(torch.Tensor, name, no_read)
    mv = tsv._make_matvec(tlin, 1e-6, SolverConfig(**cfg), offchain=bound)
    monkeypatch.undo()
    assert (mv.__name__ == 'mv_chain') == covered
    x = rng.normal(size=(CAP, 6)).astype(np.float32)
    want = np.asarray(jsv._make_matvec(jlin, jnp.float32(1e-6),
                                       JSolverConfig(**cfg))(jnp.asarray(x)))
    np.testing.assert_allclose(mv(torch.tensor(x)).numpy(), want,
                               rtol=1e-4, atol=1e-4 * np.abs(want).max())
    # Without the bound the count is read; the same form is picked.
    assert (tsv._make_matvec(tlin, 1e-6, SolverConfig(**cfg)).__name__
            == 'mv_chain') == covered


def test_interleaved_solve_matches_jax(rng):
    g, poses, mask = graph_interleaved(rng)
    for capacity in (64, 8):
        solve_both(g, poses, mask, offchain_capacity=capacity, **BUDGET)


def test_runner_passes_its_bound_to_every_solve(monkeypatch):
    """A two-track runner with full-graph per-scan solves, in chunks and
    per scan, then a link, a refine and a covariance query: every matvec
    is picked from the runner's host bound, which never falls below the
    true count of off-chain factors."""
    from laser_slam_tpu_torch.config import (EstimatorConfig, IcpConfig,
                                             InputFilterConfig,
                                             LaserTrackConfig)
    from laser_slam_tpu_torch.pipeline import online as ton
    from laser_slam_tpu_torch.pipeline import replay as trep
    seen = []
    real = tsv._make_matvec

    def spy(lin, damping, config, offchain=None):
        seen.append((offchain, int(torch.sum(tsv._offchain_mask(lin)))))
        return real(lin, damping, config, offchain)
    monkeypatch.setattr(tsv, '_make_matvec', spy)
    cfg = EstimatorConfig(
        laser_track=LaserTrackConfig(
            nscan_in_sub_map=3, force_priors=True,
            input_filters=InputFilterConfig(scan_capacity=512),
            icp=IcpConfig(matcher='brute', reading_capacity=256,
                          reading_sampling_ratio=1.0)),
        solver=SolverConfig(gn_iterations=2, pcg_iterations=10,
                            offchain_capacity=4))
    runner = ton.OnlineRunner(cfg, pose_capacity=32, factor_capacity=64,
                              n_tracks=2, device='cpu')
    streams = [list(trep.SyntheticStream(
        n_scans=4, points_per_scan=512, trajectory='line', step_m=0.5,
        seed=5 + t)) for t in range(2)]
    runner.process_scans(streams[0][:2], track_id=0, chunk_size=2)
    for i in range(2, 4):
        for t in range(2):
            f = streams[t][i]
            runner.process_scan(f.time_ns + t, f.points, f.odom_pose7,
                                track_id=t)
    runner.process_scans(streams[1][:2], track_id=1, chunk_size=2)
    assert runner.add_loop_closure(0, 2, np.asarray(
        [1, 0, 0, 0, 0, 100, 0], np.float32))
    runner.refine(1)
    runner.marginal_covariances([1, 3])
    assert len(seen) > 10
    assert all(bound is not None and bound >= true for bound, true in seen)
    # The bound crosses the capacity in this run, as the count does.
    assert {b > 4 for b, _ in seen} == {t > 4 for _, t in seen} == {False,
                                                                     True}
