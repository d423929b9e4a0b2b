"""The port's fleet mode (parallel/fleet.py) against the JAX package's.

The same numpy inputs, made from a seed, go through ``laser_slam_tpu.
parallel.fleet`` (its Pallas kernels in interpret mode, as the JAX
package's own tests run them on the CPU) and ``laser_slam_tpu_torch.
parallel.fleet`` (the kernels' plain versions on the CPU):

* ``fleet_icp_odometry`` with every matcher: 'pallas' under both
  ``pallas_prune`` values and 'brute' within ``POSE_ATOL`` (1e-4, as
  tests/test_torch_icp.py: both sides compute coordinate-wise distances
  or, for 'brute', near-ties that move no pose at this tolerance),
  'projective' within ``PROJ_TOL_M`` / ``PROJ_TOL_DEG``: the floor of
  1 mm / 0.01 degree, above twice the gap measured on these scenes
  (1.2e-6 m / 2.8e-7 degree; 1.7e-6 m / 5.9e-7 degree for the serving
  case), since one ulp of arcsin/atan2 can move a point to the next
  pixel.  Every matcher's measured gap was 1.3e-6 m or less.
* ``batched_icp`` with ``serving_icp_config()`` at a small size, within
  the projective tolerance; a 64-lane call equal to its two 32-lane
  halves (the JAX package splits 64 lanes so; the port does not).
* ``build_fleet_chain_graphs`` equal field by field, ``fleet_solve``
  within ``SOLVE_ATOL``.
* ``fleet_accumulate`` with and without overflow compaction, equal maps
  (points within 1e-5 m: se3.apply rounds differently), and
  ``fleet_map_query``: d2 the exact f32 distance to its pick and within
  4e-7 of |q|^2 + |r|^2 of JAX's matmul expansion (1.6e-7 measured),
  indices equal except where a float64 check finds a near-tie.
* ``nn_brute_lanes`` and the K1L/K2L plain versions against a per-lane
  loop of the single-lane plain versions (bit-equal) and against
  ``jax.vmap`` of the Pallas kernels in interpret mode (d2 within rtol
  1e-6, indices equal or tied in float64, as tests/test_torch_nn.py).
* A lane ICP with B = 1 equals the single-lane call bit for bit.
* ``fleet_solve`` with a lane whose measurement or start pose is NaN:
  every other lane equals its own ``solver.solve`` within 1e-5, under
  each preconditioner and the dense method (no JAX run: the single
  solves are the reference, as JAX's ``vmap`` solves each lane alone).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_slam_tpu import config as jcfg
from laser_slam_tpu.ops import cloud as jpc
from laser_slam_tpu.ops import icp as jicp
from laser_slam_tpu.ops import pallas_nn
from laser_slam_tpu.ops import se3 as jse3
from laser_slam_tpu.parallel import fleet as jfleet
from laser_slam_tpu.pipeline import replay as jrep
from laser_slam_tpu_torch.config import (IcpConfig, SolverConfig,
                                         fleet_icp_config,
                                         serving_icp_config)
from laser_slam_tpu_torch.graph import factors as tfg
from laser_slam_tpu_torch.ops import cloud as tpc
from laser_slam_tpu_torch.ops import icp as ticp
from laser_slam_tpu_torch.ops import neighbors as tnb
from laser_slam_tpu_torch.ops import nn_kernels as tnk
from laser_slam_tpu_torch.parallel import fleet as tfleet
from laser_slam_tpu_torch.pipeline import replay as trep

torch.set_num_threads(2)
B, T, N = 3, 3, 512
POSE_ATOL = 1e-4
PROJ_TOL_M, PROJ_TOL_DEG = 1e-3, 0.01
SOLVE_ATOL = 1e-4
CUTOFF = 3.0


def assert_same_nn(q, ref, d2_a, idx_a, d2_b, idx_b):
    """tests/test_torch_nn.py's rule: d2 within rtol 1e-6; a different
    index only at the same float64 distance (rtol 1e-6)."""
    d2_a, d2_b = np.asarray(d2_a), np.asarray(d2_b)
    idx_a = np.asarray(idx_a).astype(np.int64)
    idx_b = np.asarray(idx_b).astype(np.int64)
    np.testing.assert_allclose(d2_a, d2_b, rtol=1e-6, atol=0)
    diff = np.flatnonzero(idx_a != idx_b)
    if diff.size:
        q64, r64 = np.asarray(q, np.float64), np.asarray(ref, np.float64)
        da = ((q64[diff] - r64[idx_a[diff]]) ** 2).sum(1)
        db = ((q64[diff] - r64[idx_b[diff]]) ** 2).sum(1)
        np.testing.assert_allclose(da, db, rtol=1e-6, atol=0)


def to_jax(cfg):
    return jcfg._from_dict(getattr(jcfg, type(cfg).__name__),
                           dataclasses.asdict(cfg))


def t(a):
    return torch.tensor(np.asarray(a))


def rot_deg(q1, q2):
    """Angle of q1^-1 q2 in degrees, over the last axis."""
    q1, q2 = q1.reshape(-1, 4), q2.reshape(-1, 4)
    w = q1[:, 0] * q2[:, 0] + np.sum(q1[:, 1:] * q2[:, 1:], axis=1)
    v = (q1[:, :1] * q2[:, 1:] - q2[:, :1] * q1[:, 1:]
         - np.cross(q1[:, 1:], q2[:, 1:]))
    return np.degrees(2 * np.arctan2(np.linalg.norm(v, axis=1), np.abs(w)))


def pose_gaps(a, b):
    """(max translation gap m, max rotation gap deg) of [..., 7] poses."""
    a = np.asarray(a, np.float64).reshape(-1, 7)
    b = np.asarray(b, np.float64).reshape(-1, 7)
    return (np.linalg.norm(a[:, 4:] - b[:, 4:], axis=1).max(),
            rot_deg(a[:, :4], b[:, :4]).max())


@pytest.fixture(scope='module')
def fleet_inputs():
    """B independent synthetic streams of T scans of N points (seeded),
    their kNN normals (JAX's, given to both sides) and odometry guesses
    from ground truth (tests/test_fleet.py)."""
    points = np.zeros((B, T, N, 3), np.float32)
    masks = np.zeros((B, T, N), bool)
    normals = np.zeros((B, T, N, 3), np.float32)
    init_pose = np.zeros((B, 7), np.float32)
    odom_rel = np.zeros((B, T, 7), np.float32)
    odom_rel[:, :, 0] = 1.0
    for b in range(B):
        frames = list(jrep.SyntheticStream(
            n_scans=T, points_per_scan=N, trajectory='line', step_m=0.5,
            noise_m=0.005, seed=100 + b))
        init_pose[b] = frames[0].gt_pose7
        for i, f in enumerate(frames):
            c = jpc.make_cloud(f.points[:N], capacity=N)
            points[b, i] = np.asarray(c.points)
            masks[b, i] = np.asarray(c.mask)
            normals[b, i] = np.asarray(jpc.estimate_normals(c, knn=8))
            if i:
                odom_rel[b, i] = np.asarray(jse3.compose(
                    jse3.inverse(jnp.asarray(frames[i - 1].gt_pose7)),
                    jnp.asarray(f.gt_pose7)))
    # A ragged lane: the last scan of lane 2 keeps 3/4 of its points.
    masks[2, -1, 3 * N // 4:] = False
    points[2, -1, 3 * N // 4:] = jpc.SENTINEL
    return points, masks, normals, init_pose, odom_rel


MATCHERS = {'brute': dict(matcher='brute'),
            'pallas-pruned': dict(matcher='pallas', pallas_prune=True),
            'pallas-flat': dict(matcher='pallas', pallas_prune=False),
            'projective': dict(matcher='projective', range_image_rows=32,
                               range_image_cols=256, range_image_elev_min=-1.2,
                               range_image_elev_max=1.2)}


@pytest.fixture(scope='module')
def odometry(fleet_inputs):
    """Both packages' fleet odometry under every matcher."""
    out = {}
    for name, kw in MATCHERS.items():
        cfg = IcpConfig(reading_capacity=N, reading_sampling_ratio=1.0,
                        max_iterations=12, **kw)
        jres = jfleet.fleet_icp_odometry(
            *(jnp.asarray(a) for a in fleet_inputs), to_jax(cfg))
        tres = tfleet.fleet_icp_odometry(
            *(t(a) for a in fleet_inputs), cfg)
        out[name] = (jres, tres)
    return out


@pytest.mark.parametrize('matcher', list(MATCHERS))
def test_fleet_icp_odometry_matches_jax(odometry, matcher):
    jres, tres = odometry[matcher]
    assert tres.poses.shape == (B, T, 7)
    np.testing.assert_array_equal(tres.valid.numpy(), np.asarray(jres.valid))
    assert bool(torch.all(tres.valid))
    it_gap = np.abs(tres.iterations.numpy() - np.asarray(jres.iterations))
    assert it_gap.max() <= 1, it_gap
    for ours, theirs in ((tres.poses, jres.poses),
                         (tres.rel_icp, jres.rel_icp)):
        dt, dr = pose_gaps(ours.numpy(), theirs)
        if matcher == 'projective':
            assert dt < PROJ_TOL_M and dr < PROJ_TOL_DEG, (dt, dr)
        else:
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                       atol=POSE_ATOL)


def test_fleet_chain_graphs_and_solve_match_jax(odometry, fleet_inputs):
    """The chain graphs of the JAX K1 run, built by both packages, and
    both packages' batched solves of them."""
    jres, _ = odometry['pallas-flat']
    init_pose = fleet_inputs[3]
    sigmas = np.full((6,), 0.01, np.float32)
    valid = np.asarray(jres.valid).copy()
    valid[1, 2] = False                   # an odometry-only step
    jg, jm = jfleet.build_fleet_chain_graphs(
        jres.rel_icp, jnp.asarray(valid), jnp.asarray(init_pose),
        jnp.asarray(sigmas))
    tg, tm = tfleet.build_fleet_chain_graphs(
        t(jres.rel_icp), t(valid), t(init_pose), t(sigmas))
    for name, leaf in zip(tfg.FactorGraphData._fields, tg):
        ref = np.asarray(getattr(jg, name))
        assert leaf.shape == ref.shape, name
        np.testing.assert_array_equal(leaf.numpy(), ref, err_msg=name)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # Start away from the chain's solution so that the solve moves.
    rng = np.random.default_rng(5)
    start = np.asarray(jres.poses).copy()
    start[..., 4:] += rng.normal(size=start[..., 4:].shape) * 0.05
    cfg = SolverConfig(gn_iterations=2, pcg_iterations=30)
    jsol = jfleet.fleet_solve(jg, jnp.asarray(start), jm, to_jax(cfg))
    tsol = tfleet.fleet_solve(tg, t(start), tm, cfg, offchain=1)
    np.testing.assert_allclose(tsol.poses.numpy(), np.asarray(jsol.poses),
                               atol=SOLVE_ATOL)
    np.testing.assert_allclose(tsol.error_final.numpy(),
                               np.asarray(jsol.error_final), rtol=1e-3,
                               atol=1e-6)
    assert tsol.pcg_iterations.shape == (B,)
    # Per lane, the joined solve is each lane's own solve.
    from laser_slam_tpu_torch.graph import solver as tsv
    for b in range(B):
        one = tsv.solve(tfg.lane_graph(tg, b), t(start[b]), tm[b], cfg)
        np.testing.assert_allclose(tsol.poses[b].numpy(), one.poses.numpy(),
                                   atol=1e-5)


def _lanes_with_closures(n_lanes, n_poses, seed):
    """Chain graphs of ``n_lanes`` noisy random walks with two loop
    closures a lane (off-chain factors for the Woodbury capacitance),
    and start poses away from the solution."""
    from laser_slam_tpu_torch.ops import se3 as tse3
    rng = np.random.default_rng(seed)
    steps = np.zeros((n_lanes, n_poses, 7), np.float32)
    steps[..., 0] = 1.0
    steps[..., 1:4] = rng.normal(size=(n_lanes, n_poses, 3)) * 0.05
    steps[..., 4:] = rng.normal(size=(n_lanes, n_poses, 3)) * 0.5
    steps = tse3.normalize(t(steps))
    gt = [steps[:, 0]]
    for i in range(1, n_poses):
        gt.append(tse3.compose(gt[-1], steps[:, i]))
    gt = torch.stack(gt, dim=1)
    rel = steps.clone()
    rel[..., 4:] += t(rng.normal(size=(n_lanes, n_poses, 3)) * 0.02
                      ).float()
    graphs, mask = tfg.build_fleet_chain_graphs(
        rel, torch.ones((n_lanes, n_poses), dtype=torch.bool), gt[:, 0],
        torch.full((6,), 0.05))
    closures = [(0, n_poses - 1), (1, n_poses // 2)]
    meas = torch.stack([tse3.compose(tse3.inverse(gt[:, a]), gt[:, b])
                        for a, b in closures], dim=1)
    keys = torch.tensor(closures, dtype=torch.int32).expand(n_lanes, -1, -1)
    ones = torch.ones((n_lanes, len(closures)))
    graphs = graphs._replace(
        rel_meas=torch.cat([graphs.rel_meas, meas], 1),
        rel_keys=torch.cat([graphs.rel_keys, keys], 1),
        rel_sqrt_info=torch.cat(
            [graphs.rel_sqrt_info,
             torch.full((n_lanes, len(closures), 6), 10.0)], 1),
        rel_robust=torch.cat([graphs.rel_robust, ones.bool()], 1),
        rel_fixed_a=torch.cat([graphs.rel_fixed_a, ~ones.bool()], 1),
        rel_weight=torch.cat([graphs.rel_weight, ones], 1))
    start = gt.clone()
    start[..., 4:] += t(rng.normal(size=(n_lanes, n_poses, 3)) * 0.3).float()
    return graphs, start, mask


@pytest.mark.parametrize('bad', ['measurement', 'pose'])
@pytest.mark.parametrize('kind,cr_stop', [
    ('tridiagonal', None), ('tridiagonal', 2), ('woodbury', None),
    ('woodbury', 2), ('jacobi', None), ('dense', None)])
def test_solve_lanes_keeps_a_bad_lane_to_itself(monkeypatch, kind, cr_stop,
                                                bad):
    """A lane with a NaN measurement or a NaN start pose fails its own
    factorizations; every other lane still equals its own solve, as under
    JAX's vmap (per-lane cyclic reduction, both at the default root size
    and with levels, Woodbury capacitances and dense systems).  Within
    1e-5: the joined solve batches the same algebra differently."""
    from laser_slam_tpu_torch.graph import solver as tsv
    if cr_stop is not None:
        monkeypatch.setattr(tsv, '_CR_STOP', cr_stop)
    graphs, start, mask = _lanes_with_closures(4, 12, seed=7)
    if bad == 'measurement':
        graphs.rel_meas[1, 3, 4] = float('nan')
    else:
        start[1, 5, 5] = float('nan')
    cfg = SolverConfig(gn_iterations=3, pcg_iterations=40,
                       method='dense' if kind == 'dense' else 'pcg',
                       preconditioner='tridiagonal' if kind == 'dense'
                       else kind, offchain_capacity=4)
    res = tfleet.fleet_solve(graphs, start, mask, cfg, offchain=3)
    for b in (0, 2, 3):
        one = tsv.solve(tfg.lane_graph(graphs, b), start[b], mask[b], cfg,
                        offchain=3)
        assert torch.isfinite(res.poses[b]).all()
        assert torch.any(torch.abs(one.poses - start[b]) > 1e-3)
        np.testing.assert_allclose(res.poses[b].numpy(), one.poses.numpy(),
                                   atol=1e-5)
        # Rounding may move a PCG stop by an iteration or two.
        assert abs(int(res.pcg_iterations[b]) -
                   int(one.pcg_iterations)) <= 2


@pytest.fixture(scope='module')
def serving_scene():
    """bench.py's scene at a small size: a 4096-point reference with
    kNN(10) normals and readings of 1024 points from displaced poses."""
    rng = np.random.default_rng(0)
    world = trep.make_scene(rng, n_world=60_000)
    pose0 = np.array([0.0, 0.0, 1.8])
    ref = trep.sample_scan(rng, world, pose0, 4096)
    readings = np.stack([
        trep.sample_scan(rng, world, pose0 + rng.normal(size=3)
                         * np.array([0.5, 0.5, 0.02]), 1024)
        for _ in range(4)])
    normals = np.asarray(jpc.estimate_normals(
        jpc.make_cloud(jnp.asarray(ref)), knn=10))
    return ref, normals, readings


def test_batched_icp_serving_matches_jax(serving_scene):
    ref, normals, readings = serving_scene
    cfg = serving_icp_config(reading_capacity=1024)
    guesses = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (4, 1))
    jref = jpc.make_cloud(jnp.asarray(ref))
    jres = jax.vmap(lambda p, g: jicp.icp_point_to_plane(
        jpc.Cloud(p, jnp.ones(p.shape[0], bool)), jref, jnp.asarray(normals),
        g, to_jax(cfg)))(jnp.asarray(readings), jnp.asarray(guesses))
    tres = tfleet.batched_icp(t(readings), torch.ones(readings.shape[:2],
                                                      dtype=torch.bool),
                              tpc.make_cloud(ref), t(normals), t(guesses),
                              cfg)
    np.testing.assert_array_equal(tres.valid.numpy(), np.asarray(jres.valid))
    dt, dr = pose_gaps(tres.T.numpy(), jres.T)
    assert dt < PROJ_TOL_M and dr < PROJ_TOL_DEG, (dt, dr)
    # The readings come from ~0.5 m displaced poses (bench.py:464-468).
    assert float(np.linalg.norm(tres.T.numpy()[:, 4:], axis=1).mean()) < 1.5


def test_batched_icp_64_lanes_equal_two_halves(serving_scene):
    """64 lanes in one call give what two 32-lane calls give."""
    ref, normals, readings = serving_scene
    cfg = serving_icp_config(reading_capacity=256)
    rng = np.random.default_rng(9)
    pts = t(readings[rng.integers(0, 4, 64)][:, :256])
    pts = pts + t(rng.normal(size=(64, 256, 3)).astype(np.float32) * 0.02)
    msk = torch.ones((64, 256), dtype=torch.bool)
    guess = torch.tensor([1, 0, 0, 0, 0, 0, 0],
                         dtype=torch.float32).expand(64, 7)
    args = (tpc.make_cloud(ref), t(normals))
    whole = tfleet.batched_icp(pts, msk, *args, guess, cfg)
    halves = [tfleet.batched_icp(pts[s], msk[s], *args, guess[s], cfg)
              for s in (slice(0, 32), slice(32, 64))]
    for field, a in zip(whole._fields, whole):
        b = torch.cat([getattr(h, field) for h in halves])
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=field)


def test_lane_icp_with_one_lane_equals_single_call(fleet_inputs):
    points, masks, normals, _, odom_rel = (t(a) for a in fleet_inputs)
    for kw in MATCHERS.values():
        cfg = IcpConfig(reading_capacity=N, reading_sampling_ratio=1.0,
                        **kw)
        one = ticp.icp_point_to_plane(
            tpc.Cloud(points[0, 1], masks[0, 1]),
            tpc.Cloud(points[0, 0], masks[0, 0]), normals[0, 0],
            odom_rel[0, 1], cfg)
        lane = ticp.icp_point_to_plane(
            tpc.Cloud(points[:1, 1], masks[:1, 1]),
            tpc.Cloud(points[:1, 0], masks[:1, 0]), normals[:1, 0],
            odom_rel[:1, 1], cfg)
        for a, b in zip(one, lane):
            assert torch.equal(a, b[0]), kw


def test_fleet_config_presets():
    assert fleet_icp_config().matcher == 'brute'
    assert fleet_icp_config(512).reading_capacity == 512
    assert fleet_icp_config().max_iterations == 8
    s = serving_icp_config()
    assert (s.matcher, s.range_image_window, s.coarse_capacity,
            s.gn_steps_per_match, s.reading_sampling_ratio) == (
                'projective', 'cross', 512, 4, 1.0)


@pytest.mark.parametrize('voxel', [0.0, 2.0])
def test_fleet_maps_match_jax(fleet_inputs, voxel):
    """Three scans into maps of 2.5 scans: the third overflows.  Without
    voxels its tail is dropped; with them the lanes are compacted."""
    points, masks, _, init_pose, _ = fleet_inputs
    M = 5 * N // 2
    jm = jfleet.init_fleet_maps(B, M)
    tm = tfleet.init_fleet_maps(B, M, device='cpu')
    poses = np.asarray(init_pose)
    for i in range(T):
        jm = jfleet.fleet_accumulate(jm, jnp.asarray(points[:, i]),
                                     jnp.asarray(masks[:, i]),
                                     jnp.asarray(poses), voxel_size_m=voxel)
        tm = tfleet.fleet_accumulate(tm, t(points[:, i]), t(masks[:, i]),
                                     t(poses), voxel_size_m=voxel)
        np.testing.assert_array_equal(tm.cursor.numpy(),
                                      np.asarray(jm.cursor))
        assert np.all(tm.cursor_bound >= tm.cursor.numpy())
        np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask))
        np.testing.assert_allclose(tm.points.numpy(), np.asarray(jm.points),
                                   atol=1e-5)
    if voxel:
        assert np.all(np.asarray(jm.cursor) < M)      # compacted
        np.testing.assert_array_equal(tm.cursor_bound, tm.cursor.numpy())
    else:
        assert np.all(np.asarray(jm.cursor) == M)     # tail dropped
    # The state carried across: JAX's maps start the port's.
    back = tfleet.fleet_maps_from_numpy(
        {k: np.asarray(getattr(jm, k)) for k in ('points', 'mask', 'cursor')},
        device='cpu')
    for k, v in tfleet.fleet_maps_to_numpy(back).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jm, k)))
    # Queries near the maps' points (world frame).
    rng = np.random.default_rng(3)
    q = (points[:, 0] + rng.normal(size=points[:, 0].shape) * 0.05
         ).astype(np.float32)
    j_idx, j_d2 = jfleet.fleet_map_query(jm, jnp.asarray(q))
    t_idx, t_d2 = tfleet.fleet_map_query(back, t(q))
    j_idx, j_d2 = np.asarray(j_idx), np.asarray(j_d2)
    # The port's d2 is the f32 coordinate-wise distance to its pick; JAX's
    # expansion loses up to a few ulps of |q|^2 + |r|^2 (1.6e-7 of it
    # measured here): held within 4e-7 of it.
    picked = back.points[torch.arange(B)[:, None], t_idx.long()]
    d = t(q) - picked
    assert torch.equal(t_d2, (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
                       + d[..., 2] * d[..., 2])
    scale = (np.sum(q.astype(np.float64) ** 2, axis=-1)
             + np.sum(picked.numpy().astype(np.float64) ** 2, axis=-1))
    assert np.all(np.abs(t_d2.numpy() - j_d2) <= 4e-7 * scale + 1e-6)
    # Indices: equal, or a near-tie where JAX's pick is no farther in
    # float64 than the port's by more than f32 rounding.
    mp = np.asarray(jm.points, np.float64)
    diff = t_idx.numpy() != j_idx
    for b, i in zip(*np.nonzero(diff)):
        d_port = np.sum((mp[b, t_idx[b, i]] - q[b, i]) ** 2)
        d_jax = np.sum((mp[b, j_idx[b, i]] - q[b, i]) ** 2)
        assert d_port <= d_jax + 1e-5 * max(d_jax, 1.0), (b, i)
    assert diff.mean() < 0.01


def test_init_fleet_maps_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device works')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tfleet.init_fleet_maps(2, 16)


@pytest.fixture(scope='module')
def lane_problems():
    """Four lanes of queries against their own references: a room with
    SENTINEL-parked rows, and exact copies across reference tiles."""
    rng = np.random.default_rng(11)
    nb, nq, nr = 4, 300, 2048
    ref = (rng.normal(size=(nb, nr, 3)) * 4).astype(np.float32)
    ref[1, ::3] = jpc.SENTINEL                      # parked rows
    ref[2, 1500:1540] = ref[2, 10:50]               # copies, later tile
    q = (ref[np.arange(nb)[:, None], rng.integers(0, nr, (nb, nq))]
         + rng.normal(size=(nb, nq, 3)) * 0.3).astype(np.float32)
    q[2, :40] = ref[2, 10:50]
    q[1] = (rng.normal(size=(nq, 3)) * 4).astype(np.float32)
    return q, ref


def test_lane_plain_versions_equal_per_lane_loops(lane_problems):
    q, ref = (t(a) for a in lane_problems)
    idx, d2 = tnb.nn_brute_lanes(q, ref)
    d2_k, idx_k = tnk.nn_indices_lanes(q, ref)       # CPU: the plain K1L
    pref = tnk.build_pruned_ref_lanes(ref, rb=512)
    d2_p, idx_p = tnk.nn_indices_pruned_lanes(q, pref, CUTOFF)
    for b in range(q.shape[0]):
        i1, e1 = tnb.nn_brute(q[b], ref[b])
        assert torch.equal(idx[b], i1) and torch.equal(d2[b], e1)
        assert torch.equal(idx_k[b], i1) and torch.equal(d2_k[b], e1)
        p1 = tnk.build_pruned_ref(ref[b], rb=512)
        for a, c in zip(pref.lane(b), p1):
            assert torch.equal(a, c)
        e2, i2 = tnk.nn_indices_pruned_plain(q[b], p1, CUTOFF)
        assert torch.equal(d2_p[b], e2) and torch.equal(idx_p[b], i2)
        tables = tnk.pruned_tables(q[b], p1, CUTOFF)
        for a, c in zip(tnk.pruned_tables_lanes(q, pref, CUTOFF)[:4],
                        tables[:4]):
            assert torch.equal(a[b], c)
    # Copies across tiles: the first copy wins.
    assert torch.equal(idx[2, :40], torch.arange(10, 50, dtype=torch.int32))
    assert not bool(torch.any(idx[1] % 3 == 0))      # parked rows never win
    # Lane blocks of several lanes (small blocks force both chunkings).
    idx_s, d2_s = [], []
    for block in (1 << 12, 1 << 24):
        old = tnb._CPU_BLOCK_ELEMS
        tnb._CPU_BLOCK_ELEMS = block
        try:
            i, e = tnb.nn_brute_lanes(q, ref)
        finally:
            tnb._CPU_BLOCK_ELEMS = old
        idx_s.append(i)
        d2_s.append(e)
    for i, e in zip(idx_s, d2_s):
        assert torch.equal(i, idx) and torch.equal(e, d2)


def test_lane_plain_versions_match_vmapped_pallas(lane_problems):
    """K1L/K2L's plain versions against ``jax.vmap`` of the Pallas
    kernels in interpret mode, lane by lane as tests/test_torch_nn.py
    holds K1/K2: d2 within rtol 1e-6 (XLA may contract the sum) and the
    same indices, or picks at the same float64 distance (rtol 1e-6); K2
    so within the cutoff, and beyond it d2 > cutoff^2 on both sides."""
    q, ref = lane_problems
    jd2, jidx = jax.vmap(lambda a, r: pallas_nn.nn_indices(
        a, r, interpret=True))(jnp.asarray(q), jnp.asarray(ref))
    d2, idx = tnk.nn_indices_lanes(t(q), t(ref))
    for b in range(q.shape[0]):
        assert_same_nn(q[b], ref[b], d2[b], idx[b], jd2[b], jidx[b])

    def pruned(a, r):
        pref = pallas_nn.build_pruned_ref(r)
        d, i = pallas_nn.nn_indices_pruned(a, pref, cutoff=CUTOFF,
                                           interpret=True)
        return d, i, pref.points
    jd2, jidx, jpts = jax.vmap(pruned)(jnp.asarray(q), jnp.asarray(ref))
    pref = tnk.build_pruned_ref_lanes(t(ref))
    np.testing.assert_array_equal(pref.points.numpy(), np.asarray(jpts))
    d2, idx = tnk.nn_indices_pruned_lanes(t(q), pref, CUTOFF)
    jd2, jidx = np.asarray(jd2), np.asarray(jidx)
    inside = jd2 <= CUTOFF ** 2
    assert inside.mean() > 0.5
    for b in range(q.shape[0]):
        rows = inside[b]
        assert_same_nn(q[b][rows], jpts[b], d2[b][rows], idx[b][rows],
                       jd2[b][rows], jidx[b][rows])
    assert np.all(d2.numpy()[~inside] > CUTOFF ** 2)
