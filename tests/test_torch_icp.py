"""The port's point-to-plane ICP against the JAX package's, on the
test_icp.py and test_pallas_nn.py scenes, for the 'pallas' matcher
(pruned K2 and flat K1, their plain versions on the CPU) and 'brute'.

Both sides get the same reference normals (from the JAX package), so the
comparison isolates matching, trimming and the Gauss-Newton loop.
Tolerance: pose within 1e-4 (f32 reductions of 6x6 normal equations in
another order); validity equal, iteration and inlier counts close.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_slam_tpu.config import IcpConfig as JIcpConfig
from laser_slam_tpu.ops import cloud as jpc
from laser_slam_tpu.ops import icp as jicp
from laser_slam_tpu.ops import se3 as jse3
from laser_slam_tpu_torch.config import IcpConfig
from laser_slam_tpu_torch.ops import cloud as tpc
from laser_slam_tpu_torch.ops import icp as ticp

torch.set_num_threads(2)
POSE_ATOL = 1e-4


def synthetic_scene(rng, n=1024):
    """Floor + two walls + a box (test_icp.py)."""
    n4 = n // 4
    parts = [
        np.stack([rng.uniform(-10, 10, n4), rng.uniform(-10, 10, n4),
                  np.zeros(n4)], 1),
        np.stack([rng.uniform(-10, 10, n4), np.full(n4, 10.0),
                  rng.uniform(0, 5, n4)], 1),
        np.stack([np.full(n4, -10.0), rng.uniform(-10, 10, n4),
                  rng.uniform(0, 5, n4)], 1),
        np.stack([rng.uniform(2, 4, n - 3 * n4),
                  rng.uniform(2, 4, n - 3 * n4),
                  np.full(n - 3 * n4, 2.0)], 1)]
    pts = np.concatenate(parts).astype(np.float32)
    pts[:, 2] -= 1.0
    return pts


def run_both(ref_pts, read_pts, read_mask, guess, **cfg):
    """JAX icp and port icp on the same clouds, normals and guess."""
    n_ref, n_read = len(ref_pts), len(read_pts)
    jref = jpc.make_cloud(jnp.asarray(ref_pts), capacity=n_ref)
    jread = jpc.make_cloud(jnp.asarray(read_pts), jnp.asarray(read_mask),
                           capacity=n_read)
    normals = jpc.estimate_normals(jref, knn=10)
    jres = jicp.icp(jread, jref, normals, jnp.asarray(guess),
                    JIcpConfig(**cfg))
    tref = tpc.make_cloud(ref_pts, capacity=n_ref)
    tread = tpc.make_cloud(read_pts, read_mask, capacity=n_read)
    tres = ticp.icp(tread, tref, torch.tensor(np.asarray(normals)),
                    torch.tensor(guess), IcpConfig(**cfg))
    return jres, tres


def assert_same_result(jres, tres, counts=True):
    assert bool(tres.valid) == bool(jres.valid)
    np.testing.assert_allclose(tres.T.numpy(), np.asarray(jres.T),
                               atol=POSE_ATOL)
    assert abs(int(tres.iterations) - int(jres.iterations)) <= 1
    if counts:
        # Off for exact-copy scenes: at their ~1e-8 m residuals the trim
        # quantile's count of ties follows f32 rounding.
        assert abs(int(tres.num_inliers) - int(jres.num_inliers)) <= max(
            4, 0.02 * int(jres.num_inliers))


MATCHERS = [dict(matcher='pallas', pallas_prune=True),
            dict(matcher='pallas', pallas_prune=False),
            dict(matcher='brute')]


@pytest.mark.parametrize('matcher', MATCHERS,
                         ids=['pallas-pruned', 'pallas-flat', 'brute'])
@pytest.mark.parametrize('n', [512, 1024])
def test_icp_matches_jax(rng, matcher, n):
    pts = synthetic_scene(rng, n)
    xi = np.array([0.02, -0.03, 0.05, 0.3, -0.2, 0.1], np.float32)
    T_true = np.asarray(jse3.exp(jnp.asarray(xi)))
    reading = np.asarray(jse3.apply(jse3.inverse(jnp.asarray(T_true)),
                                    jnp.asarray(pts)))
    guess = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    jres, tres = run_both(pts, reading, np.ones(n, bool), guess,
                          max_correspondence_dist_m=3.0, **matcher)
    assert bool(tres.valid)
    assert_same_result(jres, tres, counts=False)
    err_t = np.linalg.norm(tres.T.numpy()[4:] - T_true[4:])
    assert err_t < 0.01, err_t


def test_icp_noise_partial_overlap_and_coarse_phase(rng):
    pts = synthetic_scene(rng, 2048)
    xi = np.array([0.0, 0.0, 0.03, 0.5, 0.2, 0.0], np.float32)
    T_true = np.asarray(jse3.exp(jnp.asarray(xi)))
    noisy = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.02
    keep = rng.uniform(size=2048) > 0.25
    reading = np.asarray(jse3.apply(jse3.inverse(jnp.asarray(T_true)),
                                    jnp.asarray(noisy)))
    guess = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    # The coarse run ends in a full-resolution phase, which covers the
    # default loop too.
    for extra in (dict(coarse_capacity=256), dict(gn_steps_per_match=2)):
        jres, tres = run_both(pts, reading, keep, guess, matcher='pallas',
                              **extra)
        assert_same_result(jres, tres)


def test_icp_failure_returns_initial_guess(rng):
    ref = rng.normal(size=(256, 3)).astype(np.float32) + 500.0
    reading = rng.normal(size=(256, 3)).astype(np.float32)
    guess = np.asarray(jse3.exp(jnp.asarray([0, 0, 0, 1.0, 2.0, 3.0],
                                            jnp.float32)))
    for matcher in MATCHERS:
        jres, tres = run_both(ref, reading, np.ones(256, bool), guess,
                              max_correspondence_dist_m=1.0, **matcher)
        assert not bool(tres.valid)
        np.testing.assert_allclose(tres.T.numpy(), guess, atol=1e-6)
        assert_same_result(jres, tres)


def test_projective_matcher_waits_for_slice_2(rng):
    """The projective matcher came with slice 2 and runs (held to JAX in
    tests/test_torch_range_image.py); an unknown matcher raises."""
    pts = synthetic_scene(rng, 512)
    cloud = tpc.make_cloud(pts)
    normals = tpc.estimate_normals(cloud)
    res = ticp.icp(cloud, cloud, normals, torch.tensor(
        [1.0, 0, 0, 0, 0, 0, 0]), IcpConfig(
            matcher='projective', range_image_elev_min=-0.8,
            range_image_elev_max=0.8, range_image_cols=256))
    assert bool(res.valid)
    np.testing.assert_allclose(res.T.numpy(), [1, 0, 0, 0, 0, 0, 0],
                               atol=1e-4)
    with pytest.raises(ValueError, match='matcher'):
        ticp.icp(cloud, cloud, normals, res.T, IcpConfig(matcher='nope'))


@pytest.mark.parametrize('method', ['sort', 'histogram'])
def test_trim_mask_matches_jax(rng, method):
    d2 = (rng.uniform(0, 3.0, 4096).astype(np.float32)) ** 2
    valid = rng.uniform(size=4096) > 0.1
    j = np.asarray(jicp._trim_mask(jnp.asarray(d2), jnp.asarray(valid),
                                   0.75, method=method, d2_max=9.0))
    t = ticp._trim_mask(torch.tensor(d2), torch.tensor(valid), 0.75,
                        method=method, d2_max=9.0).numpy()
    np.testing.assert_array_equal(t, j)


def test_gauss_newton_step_matches_jax(rng):
    p = rng.normal(size=(512, 3)).astype(np.float32) * 5
    q = p + rng.normal(size=(512, 3)).astype(np.float32) * 0.05
    n = rng.normal(size=(512, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    w = (rng.uniform(size=512) > 0.2).astype(np.float32)
    jd, jr = jicp._gauss_newton_step(*map(jnp.asarray, (p, q, n, w)))
    td, tr = ticp._gauss_newton_step(*map(torch.tensor, (p, q, n, w)))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5,
                               rtol=1e-4)
    # The GN stage's plain twin takes the same step from the identity: T
    # becomes normalize(exp(delta)), and the step is counted.
    inlier = torch.tensor(w > 0)
    cfg = IcpConfig()
    state = ticp.GnState(
        T=torch.tensor([1.0, 0, 0, 0, 0, 0, 0]),
        it=torch.zeros((), dtype=torch.int32),
        hist=torch.full((cfg.smooth_length, 2), float('inf')),
        done=torch.zeros((), dtype=torch.bool),
        mean_err=torch.full((), float('inf')),
        n_in=torch.zeros((), dtype=torch.int32))
    n_new = inlier.sum().to(torch.int32)
    out = ticp.gn_stage_plain([torch.tensor(p)],
                              [(torch.tensor(q), torch.tensor(n))],
                              [inlier], n_new, state, 8, cfg)
    np.testing.assert_allclose(out.T.numpy(),
                               np.asarray(jse3.normalize(jse3.exp(jd))),
                               atol=1e-5)
    assert int(out.it) == 1 and int(out.n_in) == int(n_new)
    np.testing.assert_allclose(float(out.mean_err),
                               np.abs(np.asarray(jr))[w > 0].mean(),
                               rtol=1e-5)


def jax_gn_stage(pts, q, n, w, state, S, max_iterations, cfg):
    """One GN stage of one lane as the JAX package's while loop runs it
    on fixed correspondences (``laser_slam_tpu/ops/icp.py``: the cond,
    then the body after the trim): S steps, the differential checker,
    the error and the inlier count."""
    T, it, hist, done, err, n_in = state
    if not (int(it) < max_iterations and not bool(done)):
        return state
    n_in = jnp.sum(w > 0).astype(jnp.int32)
    enough = n_in >= ticp.MIN_INLIERS
    for _ in range(S):
        delta, r = jicp._gauss_newton_step(jse3.apply(T, pts), q, n, w)
        step_on = enough & ~done & (it < max_iterations)
        delta = jnp.where(step_on, delta, 0.0)
        T = jse3.normalize(jse3.compose(jse3.exp(delta), T))
        hist = jnp.where(step_on, jnp.roll(hist, shift=-1, axis=0).at[-1].set(
            jnp.stack([jnp.linalg.norm(delta[:3]),
                       jnp.linalg.norm(delta[3:])])), hist)
        means = jnp.mean(hist, axis=0)
        converged = ((it + 1 >= cfg.smooth_length)
                     & (means[0] < cfg.min_diff_rot)
                     & (means[1] < cfg.min_diff_trans))
        err = jnp.where(step_on, jnp.sum(jnp.abs(r) * w)
                        / jnp.maximum(n_in, 1), err)
        it = it + step_on.astype(jnp.int32)
        done = done | converged | ~enough
    return (T, it, hist, done, err, n_in)


GN_CASES = {
    'lanes': dict(lanes=4, steps=1, few=(1,), done=(2,)),
    'few-inliers': dict(lanes=None, steps=1, few=(0,), done=()),
    'done-lane': dict(lanes=2, steps=1, few=(), done=(0,)),
    'steps4': dict(lanes=3, steps=4, few=(), done=()),
}


@pytest.mark.parametrize('case', list(GN_CASES))
def test_gn_stage_plain_matches_jax(rng, case):
    """Five GN stages of the plain twin (``gn_stage`` on the CPU) against
    the JAX package's loop body on the same fixed correspondences, lane
    by lane: T within 1e-5, the differential checker's window within
    1e-6, the error within rtol 1e-5, it, done and n_in equal.  Lanes in
    ``done`` start done with a state of their own and keep it; lanes in
    ``few`` keep 20 inliers (fewer than MIN_INLIERS) and end done
    without a step."""
    spec = GN_CASES[case]
    B, S, N = spec['lanes'] or 1, spec['steps'], 512
    cfg = IcpConfig(gn_steps_per_match=S)
    smooth = cfg.smooth_length
    p = rng.normal(size=(B, N, 3)).astype(np.float32) * 5
    # Motions whose first step leaves the checker's window mean after
    # four steps (a quarter of it) 25% above one threshold and far below
    # the other: the translation's on even lanes, the rotation's on odd
    # ones, so the step a lane converges at depends on each threshold.
    u = rng.normal(size=(B, 2, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    size = np.array([[0.002, 0.05], [0.005, 0.01]])[np.arange(B) % 2]
    xi = np.concatenate([u[:, 0] * size[:, :1], u[:, 1] * size[:, 1:]], 1)
    q = np.stack([np.asarray(jse3.apply(jse3.exp(jnp.asarray(
        x, jnp.float32)), jnp.asarray(pb))) for x, pb in zip(xi, p)])
    q = (q + rng.normal(size=q.shape) * 0.005).astype(np.float32)
    n = rng.normal(size=(B, N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    inlier = rng.uniform(size=(B, N)) > 0.2
    T = np.tile(np.array([1.0, 0, 0, 0, 0, 0, 0], np.float32), (B, 1))
    it, n_in = np.zeros(B, np.int32), np.zeros(B, np.int32)
    hist = np.full((B, smooth, 2), np.inf, np.float32)
    done, err = np.zeros(B, bool), np.full(B, np.inf, np.float32)
    for b in spec['few']:
        inlier[b] = False
        inlier[b, rng.choice(N, 20, replace=False)] = True
    for b in spec['done']:
        T[b] = np.asarray(jse3.exp(jnp.asarray(
            rng.normal(size=6) * 0.05, jnp.float32)))
        it[b], done[b], err[b], n_in[b] = 3, True, 0.0123, 4321
        hist[b] = rng.uniform(size=(smooth, 2)) * 1e-3
    arrays = [p, q, n, inlier, T, it, hist, done, err, n_in]
    if spec['lanes'] is None:
        arrays = [a[0] for a in arrays]
    pts, qt, nt, inl, *st = (torch.tensor(a) for a in arrays)
    state = ticp.GnState(*st)
    points, pairs, inliers = [pts], [(qt, nt)], [inl]
    n_new = inl.sum(-1).to(torch.int32)
    lanes = [tuple(jnp.asarray(a[b]) for a in (T, it, hist, done, err,
                                                 n_in)) for b in range(B)]
    w = inlier.astype(np.float32)
    for stage in range(5):
        state = ticp.gn_stage(points, pairs, inliers, n_new, state, 40, cfg,
                              ticp.gn_fused_path(state.T, points))
        lanes = [jax_gn_stage(jnp.asarray(p[b]), jnp.asarray(q[b]),
                              jnp.asarray(n[b]), jnp.asarray(w[b]), lanes[b],
                              S, 40, cfg) for b in range(B)]
        got = [a.reshape((B,) + a.shape[len(a.shape) - len(
            lanes[0][k].shape):]).numpy() for k, a in enumerate(state)]
        for b, want in enumerate(lanes):
            msg = f'lane {b} after stage {stage}'
            np.testing.assert_allclose(got[0][b], np.asarray(want[0]),
                                       atol=1e-5, err_msg=msg)
            np.testing.assert_allclose(got[2][b], np.asarray(want[2]),
                                       atol=1e-6, err_msg=msg)
            np.testing.assert_allclose(got[4][b], np.asarray(want[4]),
                                       rtol=1e-5, err_msg=msg)
            for k in (1, 3, 5):
                assert got[k][b] == np.asarray(want[k]), (
                    ticp.GnState._fields[k], msg)
    for b in spec['done']:
        for k, a in enumerate(arrays[4:]):
            np.testing.assert_array_equal(got[k][b], a[b])
    for b in spec['few']:
        assert got[3][b] and got[1][b] == 0
    assert got[3].all()


def test_config_fields_pass_through(rng):
    """The port reads the same IcpConfig fields as JAX (a replaced field
    reaches the loop)."""
    cfg = dataclasses.replace(IcpConfig(matcher='pallas'), max_iterations=3)
    pts = synthetic_scene(rng, 512)
    c = tpc.make_cloud(pts)
    res = ticp.icp(c, c, tpc.estimate_normals(c), torch.tensor(
        [1.0, 0, 0, 0, 0.2, 0, 0]), cfg)
    assert int(res.iterations) <= 3


@pytest.mark.parametrize('case', [
    dict(matcher='brute'), dict(matcher='pallas', pallas_prune=False),
    dict(matcher='pallas', pallas_prune=True),
    dict(matcher='projective', range_image_elev_min=-0.8,
         range_image_elev_max=0.8, range_image_cols=256),
    dict(matcher='pallas', coarse_capacity=256)],
    ids=['brute', 'k1-plain', 'k2-plain', 'projective', 'coarse'])
def test_frozen_iterations_change_nothing(rng, case):
    """The card runs all max_iterations with the state frozen once the
    checkers fire; on the CPU the loop breaks there.  early_break=False
    runs the card's frozen iterations on the CPU: T, the iteration
    count, the mean error and the inlier count are bit-equal."""
    pts = synthetic_scene(rng, 1024)
    xi = np.array([0.01, -0.02, 0.03, 0.2, -0.1, 0.05], np.float32)
    reading = np.array(jse3.apply(jse3.inverse(jse3.exp(jnp.asarray(xi))),
                                  jnp.asarray(pts)))
    reading += rng.normal(size=reading.shape).astype(np.float32) * 0.01
    ref = tpc.make_cloud(pts)
    normals = tpc.estimate_normals(ref)
    read = tpc.make_cloud(reading)
    cfg = IcpConfig(**case)
    guess = torch.tensor([1.0, 0, 0, 0, 0, 0, 0])
    runs = [ticp.icp_point_to_plane(read, ref, normals, guess, cfg,
                                    early_break=brk) for brk in (True, False)]
    assert bool(runs[0].valid)
    assert int(runs[0].iterations) < cfg.max_iterations + (
        cfg.coarse_max_iterations if cfg.coarse_capacity else 0)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
