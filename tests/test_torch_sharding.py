"""The port's multi-device sharding (parallel/sharding.py) against the JAX
package's, on an 8-shard CPU mesh.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py, the
port's on ``'cpu'`` repeated 8 times; both get the same numpy points,
masks and kNN normals (the port's ``estimate_normals``), made once from
a seed.  JAX's sharded runs are computed once, in a module fixture.

* ``fleet_slam_step`` on a (dp 4, sp 2) mesh, 'brute': within
  ``STEP_ATOL`` (1e-5) of JAX's sharded step (measured gap 6.6e-7) and
  of the port's unsharded ``fleet_icp_odometry`` +
  ``build_fleet_chain_graphs`` + ``fleet_solve`` (measured 1.2e-7, the
  same with K1L's and K2L's plain versions; 3.0e-7 with a coarse phase
  whose stride crosses the sp boundary).
* dp only (dp 8, sp 1): lane 3 of 8 equals the lane solved alone
  (measured bit-equal), and the poses lie in 8 shards.
* ``sharded_solve`` on an 8-way gp mesh, on tests/test_fleet.py's
  512-pose graph, 'scatter' and 'chain': ``error_final <
  error_initial``, and poses within ``SOLVE_ATOL`` of the port's
  single-device solve and of JAX's sharded solve.  1e-5 cannot hold
  there: the poses lie at |x| up to 511 m, where f32 spacing is 3.05e-5,
  and 12 PCG iterations at tolerance 0 carry the rounding of a sum's
  order into the 1e-5 digits of y and z too.  JAX's sharded solve
  equals its single-device solve bit for bit (XLA:CPU sums in one
  order); the port's single-device solve is already 6.1e-5 ('scatter')
  and 9.2e-5 ('chain') from JAX's, inside the 1e-4 POSE_ATOL of
  tests/test_torch_solver.py.  Measured gaps of the 8-way solve: to the
  port's single-device 6.2e-5 / 3.1e-5 (y and z 5.1e-5 / 2.1e-5, the
  quaternions 3.8e-6 / 4.2e-6); to JAX's 4.2e-5 / 9.2e-5.  SOLVE_ATOL
  is twice POSE_ATOL: the sharded sums' rounding adds to the port's own
  gap to JAX.  The reductions themselves are held tighter: the 8-way
  matvec, gradient, chain blocks and error within rtol 1e-6 of their
  largest entry of the single-device ones (measured 9.7e-8 or less;
  the chain matvec and the error bit-equal), the off-chain selection
  equal.
* The trim is global: sp shards with very different residuals give the
  whole reading's inlier masks, not each shard's own quantile (which
  differ here), and the ICP's inlier count equals the unsharded one.
* Priors counted once: a graph with several soft priors near the origin
  (f32 spacing below 1e-6), gp 8 within 1e-5 of gp 1 under every
  preconditioner and the dense method (measured 2.4e-7), and gp 1 equal
  to ``solver.solve`` bit for bit.
* The mesh: JAX's default split, no silent CPU mesh without a card, and
  a ValueError naming the axis that does not divide.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_slam_tpu import config as jcfg
from laser_slam_tpu.graph import factors as jfg
from laser_slam_tpu.parallel import sharding as jshd
from laser_slam_tpu_torch.config import IcpConfig, SolverConfig
from laser_slam_tpu_torch.graph import factors as tfg
from laser_slam_tpu_torch.graph import solver as tsv
from laser_slam_tpu_torch.ops import cloud as tpc
from laser_slam_tpu_torch.ops import icp as ticp
from laser_slam_tpu_torch.ops import se3 as tse3
from laser_slam_tpu_torch.parallel import fleet as tfleet
from laser_slam_tpu_torch.parallel import sharding as tshd
from laser_slam_tpu_torch.pipeline import replay as trep

torch.set_num_threads(2)
B, T, N = 4, 3, 1024
STEP_ATOL = 1e-5
POSE_ATOL = 1e-4
SOLVE_ATOL = 2 * POSE_ATOL
SIGMAS = np.full((6,), 0.01, np.float32)
CPU8 = ['cpu'] * 8
ICP = IcpConfig(matcher='brute', reading_capacity=N,
                reading_sampling_ratio=1.0)
STEP_SOLVER = SolverConfig(gn_iterations=2, pcg_iterations=20)
GRAPH_SOLVER = SolverConfig(gn_iterations=2, pcg_iterations=12,
                            pcg_tolerance=0.0, preconditioner='tridiagonal')


def to_jax(cfg):
    return jcfg._from_dict(getattr(jcfg, type(cfg).__name__),
                           dataclasses.asdict(cfg))


def t(a):
    return torch.tensor(np.asarray(a))


def fleet_arrays(n_lanes, n_points, seed=100):
    """Independent synthetic 'line' streams (tests/test_fleet.py), their
    kNN(8) normals and odometry guesses from ground truth, as numpy."""
    points = np.zeros((n_lanes, T, n_points, 3), np.float32)
    masks = np.zeros((n_lanes, T, n_points), bool)
    normals = np.zeros((n_lanes, T, n_points, 3), np.float32)
    init_pose = np.zeros((n_lanes, 7), np.float32)
    odom_rel = np.zeros((n_lanes, T, 7), np.float32)
    odom_rel[:, :, 0] = 1.0
    for b in range(n_lanes):
        frames = list(trep.SyntheticStream(
            n_scans=T, points_per_scan=n_points, trajectory='line',
            step_m=0.5, noise_m=0.005, seed=seed + b))
        init_pose[b] = frames[0].gt_pose7
        for i, f in enumerate(frames):
            c = tpc.make_cloud(f.points[:n_points], capacity=n_points,
                               device='cpu')
            points[b, i] = c.points.numpy()
            masks[b, i] = c.mask.numpy()
            normals[b, i] = tpc.estimate_normals(c, knn=8).numpy()
            if i:
                odom_rel[b, i] = tse3.compose(
                    tse3.inverse(t(frames[i - 1].gt_pose7)),
                    t(f.gt_pose7)).numpy()
    return points, masks, normals, init_pose, odom_rel


def chain_graph_512():
    """tests/test_fleet.py's 512-pose chain with closures every 96 poses
    and noisy start poses (both packages' HostGraph)."""
    n = 512
    poses = np.zeros((n, 7), np.float32)
    poses[:, 0] = 1.0
    poses[:, 4] = np.arange(n)
    graphs = []
    for mod in (jfg, tfg):
        g = mod.HostGraph(rel_capacity=1024, prior_capacity=16)
        g.add_prior(0, poses[0], np.full(6, 1e-7, np.float32))
        step7 = np.array([1, 0, 0, 0, 1, 0, 0], np.float32)
        for i in range(n - 1):
            g.add_relative(i, i + 1, step7, SIGMAS)
        for i in range(0, n - 64, 96):
            g.add_relative(i, i + 64,
                           np.array([1, 0, 0, 0, 64, 0, 0], np.float32),
                           SIGMAS)
        graphs.append(g)
    poses[:, 4:] += np.random.default_rng(1).normal(
        size=(n, 3)).astype(np.float32) * 0.05
    return graphs[0].to_device(), graphs[1].to_device(device='cpu'), poses


@pytest.fixture(scope='module')
def inputs():
    return fleet_arrays(B, N)


@pytest.fixture(scope='module')
def graph512():
    return chain_graph_512()


@pytest.fixture(scope='module')
def jax_runs(inputs, graph512):
    """JAX's sharded fleet step and sharded solves, once."""
    assert len(jax.devices()) == 8
    mesh = jshd.make_mesh(8)
    step = jshd.fleet_slam_step(mesh, to_jax(ICP), to_jax(STEP_SOLVER))
    poses, _ = step(*jshd.shard_fleet_inputs(mesh, *inputs),
                    jnp.asarray(SIGMAS))
    jgraph, _, poses0 = graph512
    gmesh = jshd.make_graph_mesh(8)
    solves = {}
    for matvec in ('scatter', 'chain'):
        cfg = dataclasses.replace(GRAPH_SOLVER, matvec=matvec)
        out = jshd.sharded_solve(gmesh, to_jax(cfg))(
            *jshd.shard_graph_inputs(gmesh, jgraph, jnp.asarray(poses0),
                                     jnp.ones((512,), bool)))
        solves[matvec] = np.asarray(out.poses)
    return np.asarray(poses), solves


def unsharded_step(arrays, icp_cfg, solver_cfg):
    odo = tfleet.fleet_icp_odometry(*(t(a) for a in arrays), icp_cfg)
    graphs, pose_mask = tfleet.build_fleet_chain_graphs(
        odo.rel_icp, odo.valid, t(arrays[3]), SIGMAS)
    return odo, tfleet.fleet_solve(graphs, odo.poses, pose_mask, solver_cfg)


def test_sharded_step_matches_jax(inputs, jax_runs):
    mesh = tshd.make_mesh(devices=CPU8)
    step = tshd.fleet_slam_step(mesh, ICP, STEP_SOLVER)
    poses, result = step(*tshd.shard_fleet_inputs(mesh, *inputs), SIGMAS)
    got = poses.gather('cpu').numpy()
    assert got.shape == (B, T, 7) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, jax_runs[0], atol=STEP_ATOL)
    np.testing.assert_array_equal(result.poses.gather('cpu').numpy(), got)
    assert result.error_final.gather('cpu').shape == (B,)


@pytest.mark.parametrize('variant', [
    dict(),
    dict(matcher='pallas', pallas_prune=False),
    dict(matcher='pallas', pallas_prune=True),
    dict(coarse_capacity=100, coarse_max_iterations=6),
])
def test_sharded_step_matches_unsharded(inputs, variant):
    """The (4, 2) step against the same pipeline on one device, with
    the brute search, K1L's and K2L's plain versions, and a coarse phase
    (stride 10: the second sp shard starts its picks at local row 8)."""
    cfg = dataclasses.replace(ICP, **variant)
    mesh = tshd.make_mesh(devices=CPU8)
    poses, result = tshd.fleet_slam_step(mesh, cfg, STEP_SOLVER)(
        *inputs, SIGMAS)
    odo, want = unsharded_step(inputs, cfg, STEP_SOLVER)
    assert bool(torch.all(odo.valid))
    np.testing.assert_allclose(poses.gather('cpu').numpy(),
                               want.poses.numpy(), atol=STEP_ATOL)
    for i in range(4):
        for j in range(2):
            # Replicated over sp: one tensor for the shards of a device.
            assert poses.shards[i, j] is poses.shards[i, 0]
            assert poses.shards[i, j].shape == (1, T, 7)


def test_dp_only_mesh_equals_a_lane_alone():
    arrays = fleet_arrays(8, 512, seed=200)
    cfg = dataclasses.replace(ICP, reading_capacity=512)
    mesh = tshd.make_mesh(8, dp=8, sp=1, devices=CPU8)
    assert mesh.shape == {'dp': 8, 'sp': 1}
    poses, _ = tshd.fleet_slam_step(mesh, cfg, STEP_SOLVER)(*arrays, SIGMAS)
    assert poses.shards.shape == (8, 1)
    assert all(s.shape == (1, T, 7) for s in poses.shards.flat)
    _, alone = unsharded_step([a[3:4] for a in arrays], cfg, STEP_SOLVER)
    np.testing.assert_allclose(poses.shards[3, 0].numpy(),
                               alone.poses.numpy(), atol=STEP_ATOL)


def graph_parts(graph, n):
    mesh = tshd.make_graph_mesh(devices=['cpu'] * n)
    return tshd.factor_shards(mesh, graph, torch.zeros(1),
                              torch.zeros(1))[0]


def test_sharded_reductions_equal_the_single_device_sums(graph512):
    _, graph, poses = graph512
    P, M = t(poses), torch.ones((512,), dtype=torch.bool)
    one = tsv._linearize(graph, P, M, 1.0)
    eight = tsv._linearize(graph_parts(graph, 8), P, M, 1.0)
    x = torch.tensor(np.random.default_rng(3).normal(
        size=(512, 6)).astype(np.float32))

    def close(a, b):
        a, b = a.double(), b.double()
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())

    close(tsv._hessian_matvec(eight, x, 1e-6),
          tsv._hessian_matvec(one, x, 1e-6))
    close(tsv._gradient(eight), tsv._gradient(one))
    for a, b in zip(tsv._build_tridiag(eight, 1e-6),
                    tsv._build_tridiag(one, 1e-6)):
        close(a, b)
    close(tsv.graph_error(graph_parts(graph, 8), P),
          tsv.graph_error(graph, P))
    # The off-chain selection: the same factors in the same slots (their
    # keys), one global order across the parts.
    sel8, valid8 = tsv._select_offchain(eight, 3)
    sel1, valid1 = tsv._select_offchain(one, 3)
    ua8 = tsv._offchain_blocks(eight, sel8, valid8)
    ua1 = tsv._offchain_blocks(one, sel1, valid1)
    np.testing.assert_array_equal(ua8[2].numpy(), ua1[2].numpy())
    np.testing.assert_array_equal(ua8[0].numpy(), ua1[0].numpy())
    assert int(tsv._sum_parts(eight, lambda p, v: torch.sum(v),
                              valid8)) == 3
    mv8 = tsv._make_matvec(eight, 1e-6, SolverConfig())
    mv1 = tsv._make_matvec(one, 1e-6, SolverConfig())
    close(mv8(x), mv1(x))


@pytest.mark.parametrize('matvec', ['scatter', 'chain'])
def test_factor_sharded_solve(graph512, jax_runs, matvec):
    _, graph, poses = graph512
    cfg = dataclasses.replace(GRAPH_SOLVER, matvec=matvec)
    mesh = tshd.make_graph_mesh(devices=CPU8)
    assert mesh.shape == {'gp': 8}
    out = tshd.sharded_solve(mesh, cfg)(graph, t(poses),
                                        torch.ones((512,), dtype=torch.bool))
    got = out.poses.gather('cpu').numpy()
    want = tsv.solve(graph, t(poses), torch.ones((512,), dtype=torch.bool), cfg)
    np.testing.assert_allclose(got, want.poses.numpy(), atol=SOLVE_ATOL)
    np.testing.assert_allclose(got, jax_runs[1][matvec], atol=SOLVE_ATOL)
    assert (float(out.error_final.gather('cpu'))
            < float(out.error_initial.gather('cpu')))
    # The poses moved by up to 0.22 m: the gap is not a solve left alone.
    assert np.abs(got - poses).max() > 0.1


def test_the_trim_is_global():
    """The first sp shard matches closely, the second is noisy: each
    shard's own 75% quantile would keep another set than the reading's."""
    g = np.random.default_rng(5)
    d2 = np.concatenate([g.uniform(0, 0.01, (2, 512)),
                         g.uniform(0.5, 4.0, (2, 512))], axis=1)
    valid = g.uniform(size=(2, 1024)) < 0.9
    d2, valid = t(d2.astype(np.float32)), t(valid)
    for method in ('sort', 'histogram'):
        whole = ticp._trim_mask(d2, valid, 0.75, method, 9.0)
        parts = ticp.trim_shards([d2[:, :512], d2[:, 512:]],
                                 [valid[:, :512], valid[:, 512:]], 0.75,
                                 method, 9.0, torch.device('cpu'))
        assert torch.equal(torch.cat(parts, dim=1), whole)
        apart = torch.cat([ticp._trim_mask(d2[:, s], valid[:, s], 0.75,
                                           method, 9.0)
                           for s in (slice(0, 512), slice(512, None))], 1)
        assert not torch.equal(apart, whole)
    # ICP whose second shard carries 0.3 m of noise.
    frames = list(trep.SyntheticStream(n_scans=2, points_per_scan=N,
                                       trajectory='line', step_m=0.3,
                                       seed=9))
    ref = tpc.make_cloud(frames[0].points[:N], capacity=N, device='cpu')
    normals = tpc.estimate_normals(ref, knn=8)
    pts = np.array(frames[1].points[:N], np.float32)
    pts[N // 2:] += g.normal(size=(N - N // 2, 3)).astype(np.float32) * 0.3
    reading = tpc.make_cloud(pts, capacity=N, device='cpu')
    guess = tse3.compose(tse3.inverse(t(frames[0].gt_pose7)),
                         t(frames[1].gt_pose7))
    cfg = ICP
    one = ticp.icp_point_to_plane(reading, ref, normals, guess, cfg)
    match = ticp.make_matcher(ref, normals, cfg)
    two = ticp.icp_point_shards(
        [tpc.Cloud(reading.points[:N // 2], reading.mask[:N // 2]),
         tpc.Cloud(reading.points[N // 2:], reading.mask[N // 2:])],
        [match, match], guess, cfg)
    assert int(two.num_inliers) == int(one.num_inliers)
    assert int(two.iterations) == int(one.iterations)
    np.testing.assert_allclose(two.T.numpy(), one.T.numpy(),
                               atol=STEP_ATOL)


def prior_graph():
    """A 64-pose chain near the origin with a gauge prior, four soft
    priors and two closures."""
    g = tfg.HostGraph(rel_capacity=128, prior_capacity=8)
    n = 64
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    poses = np.zeros((n, 7), np.float32)
    poses[:, 0] = 1.0
    poses[:, 4] = 2 * np.cos(ang)
    poses[:, 5] = 2 * np.sin(ang)
    g.add_prior(0, poses[0], np.full(6, 1e-7, np.float32))
    for k in (10, 25, 40, 55):
        g.add_prior(k, poses[k] + np.float32([0, 0, 0, 0, 0.05, 0, 0]),
                    np.full(6, 0.05, np.float32))
    for i in range(n - 1):
        rel = tse3.compose(tse3.inverse(t(poses[i])), t(poses[i + 1]))
        g.add_relative(i, i + 1, rel.numpy(), SIGMAS)
    for a, b in ((0, 32), (16, 48)):
        rel = tse3.compose(tse3.inverse(t(poses[a])), t(poses[b]))
        g.add_relative(a, b, rel.numpy(), SIGMAS)
    noisy = poses.copy()
    noisy[1:, 4:] += np.random.default_rng(2).normal(
        size=(n - 1, 3)).astype(np.float32) * 0.05
    return g.to_device(device='cpu'), noisy


@pytest.mark.parametrize('solver', [
    dict(), dict(matvec='scatter'), dict(preconditioner='jacobi'),
    dict(preconditioner='woodbury'), dict(method='dense')])
def test_priors_are_counted_once(solver):
    graph, poses = prior_graph()
    cfg = SolverConfig(gn_iterations=3, pcg_iterations=32, **solver)
    mask = torch.ones((64,), dtype=torch.bool)
    runs = [tshd.sharded_solve(tshd.make_graph_mesh(devices=['cpu'] * n),
                               cfg)(graph, t(poses), mask)
            for n in (1, 8)]
    one, eight = (r.poses.gather('cpu').numpy() for r in runs)
    np.testing.assert_array_equal(
        one, tsv.solve(graph, t(poses), mask, cfg).poses.numpy())
    np.testing.assert_allclose(eight, one, atol=STEP_ATOL)
    for r in runs:
        assert (float(r.error_final.gather('cpu'))
                < float(r.error_initial.gather('cpu')))


def test_the_mesh(monkeypatch):
    mesh = tshd.make_mesh(devices=CPU8)
    assert mesh.shape == {'dp': 4, 'sp': 2}
    assert tshd.make_mesh(6, devices=CPU8).shape == {'dp': 3, 'sp': 2}
    assert tshd.make_mesh(devices=['cpu']).shape == {'dp': 1, 'sp': 1}
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 0)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tshd.make_mesh()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tshd.make_graph_mesh()
    points = np.zeros((4, T, 1001, 3), np.float32)
    with pytest.raises(ValueError, match="'sp'"):
        tshd.shard_fleet_inputs(mesh, points, np.ones((4, T, 1001), bool),
                                points, np.zeros((4, 7), np.float32),
                                np.zeros((4, T, 7), np.float32))
    with pytest.raises(ValueError, match="'dp'"):
        tshd.put(mesh, np.zeros((6, 8)), ('dp', 'sp'))
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    s = tshd.put(mesh, x, ('dp', None, 'sp'))
    assert s.shards[1, 1].shape == (1, 6, 4)
    assert torch.equal(s.gather('cpu'), x)
    assert tshd.put(mesh, s, ('dp', None, 'sp')) is s
