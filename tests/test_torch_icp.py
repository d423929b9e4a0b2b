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
