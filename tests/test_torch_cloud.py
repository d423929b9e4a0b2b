"""The port's point-cloud ops against the JAX package's.

Packing, decimation and filters are exact (same integer arithmetic, same
f32 comparisons).  Normals: the port finds neighbours with coordinate-
wise distances, JAX with the matmul expansion, so a near-tied k-th
neighbour may differ; each normal must still agree with JAX's to
|dot| > 0.999 (sign-free: normals are lines).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_slam_tpu.ops import cloud as jpc
from laser_slam_tpu.ops import range_image as jri
from laser_slam_tpu.config import IcpConfig as JIcpConfig
from laser_slam_tpu_torch.config import IcpConfig
from laser_slam_tpu_torch.ops import cloud as tpc
from laser_slam_tpu_torch.ops import range_image as tri

torch.set_num_threads(2)


def scene(rng, n=1024):
    """Floor + two walls + a box (the test_icp.py scene)."""
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


def masked_cloud(rng, n=1000, capacity=1024, keep=0.7):
    pts = (rng.normal(size=(n, 3)) * 20).astype(np.float32)
    mask = rng.uniform(size=n) < keep
    return pts, mask, capacity


def pair(pts, mask, capacity):
    return (jpc.make_cloud(jnp.asarray(pts), jnp.asarray(mask), capacity),
            tpc.make_cloud(pts, mask, capacity))


def assert_cloud_equal(jc, tc):
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    np.testing.assert_array_equal(tc.points.numpy(), np.asarray(jc.points))


def test_make_cloud_pads_and_parks(rng):
    jc, tc = pair(*masked_cloud(rng))
    assert_cloud_equal(jc, tc)
    assert tc.capacity == 1024


@pytest.mark.parametrize('capacity', [256, 700, 1024, 2048])
def test_compact_decimate(rng, capacity):
    jc, tc = pair(*masked_cloud(rng))
    assert_cloud_equal(jpc.compact_decimate(jc, capacity),
                       tpc.compact_decimate(tc, capacity))


@pytest.mark.parametrize('capacity', [300, 1024])
def test_compact(rng, capacity):
    jc, tc = pair(*masked_cloud(rng))
    assert_cloud_equal(jpc.compact(jc, capacity), tpc.compact(tc, capacity))


@pytest.mark.parametrize('lims', [(1.0, 70.0), (5.0, 20.0), (0.0, np.inf)])
def test_range_filter(rng, lims):
    jc, tc = pair(*masked_cloud(rng))
    assert_cloud_equal(jpc.range_filter(jc, *lims),
                       tpc.range_filter(tc, *lims))


def test_transform_keeps_parked(rng):
    jc, tc = pair(*masked_cloud(rng))
    pose = np.array([0.9, 0.1, -0.3, 0.2, 1.0, -2.0, 0.5], np.float32)
    pose[:4] /= np.linalg.norm(pose[:4])
    jt, tt = jpc.transform(jnp.asarray(pose), jc), tpc.transform(
        torch.tensor(pose), tc)
    np.testing.assert_array_equal(tt.mask.numpy(), np.asarray(jt.mask))
    np.testing.assert_allclose(tt.points.numpy(), np.asarray(jt.points),
                               atol=1e-5, rtol=1e-6)


def test_random_sampling_filter(rng):
    _, tc = pair(*masked_cloud(rng))
    assert tpc.random_sampling_filter(tc, 1.0, None) is tc
    g = torch.Generator().manual_seed(0)
    out = tpc.random_sampling_filter(tc, 0.5, g)
    kept = out.mask.sum().item() / max(tc.mask.sum().item(), 1)
    assert 0.35 < kept < 0.65
    assert torch.all(out.points[~out.mask] == tpc.SENTINEL)


def test_estimate_normals_match_jax(rng):
    pts = scene(rng, 1024)
    mask = np.ones(1024, bool)
    mask[-40:] = False
    jc, tc = pair(pts, mask, 1024)
    jn = np.asarray(jpc.estimate_normals(jc, knn=10))
    tn = tpc.estimate_normals(tc, knn=10).numpy()
    dots = np.abs(np.sum(jn * tn, axis=1))
    assert np.all(dots > 0.999), np.sort(dots)[:5]
    np.testing.assert_array_equal(tn[~mask], np.tile([0, 0, 1.0], (40, 1)))


def test_smallest_eigvec_matches_jax(rng):
    X = rng.normal(size=(64, 10, 3)).astype(np.float32)
    X[:, :, 2] *= 0.05
    cov = np.einsum('nki,nkj->nij', X, X) / 10
    j = np.asarray(jpc._smallest_eigvec_3x3(jnp.asarray(cov)))
    t = tpc._smallest_eigvec_3x3(torch.tensor(cov)).numpy()
    assert np.all(np.abs(np.sum(j * t, axis=1)) > 0.99999)


def test_compute_normals_knn_and_later_slices(rng):
    """'knn' agrees with JAX; the range-image methods, which came with
    slice 2, now run (tests/test_torch_range_image.py holds them to
    JAX) and 'auto' takes knn below 8192 points."""
    pts = scene(rng, 512)
    jc, tc = pair(pts, np.ones(512, bool), 512)
    jn = np.asarray(jri.compute_normals(jc, JIcpConfig(normal_method='knn')))
    tn = tri.compute_normals(tc, IcpConfig(normal_method='knn')).numpy()
    assert np.all(np.abs(np.sum(jn * tn, axis=1)) > 0.999)
    np.testing.assert_array_equal(
        tri.compute_normals(tc, IcpConfig(normal_method='auto')).numpy(), tn)
    for method in ('image_pca', 'range_image'):
        out = tri.compute_normals(tc, IcpConfig(normal_method=method))
        assert out.shape == (512, 3)
        np.testing.assert_allclose(torch.linalg.norm(out, dim=1).numpy(),
                                   1.0, atol=1e-5)
    with pytest.raises(ValueError, match='normal_method'):
        tri.compute_normals(tc, IcpConfig(normal_method='nope'))


def test_empty_cloud_and_concatenate(rng):
    a_pts, a_mask, _ = masked_cloud(rng, n=300, capacity=400)
    b_pts, b_mask, _ = masked_cloud(rng, n=200, capacity=256)
    ja, ta = pair(a_pts, a_mask, 400)
    jb, tb = pair(b_pts, b_mask, 256)
    assert_cloud_equal(jpc.empty_cloud(64), tpc.empty_cloud(64))
    for cap in (None, 500, 656):
        assert_cloud_equal(jpc.concatenate([ja, jb], cap),
                           tpc.concatenate([ta, tb], cap))


def test_pack_scatter_batched_matches_jax(rng):
    pts = (rng.normal(size=(3, 500, 3)) * 20).astype(np.float32)
    mask = rng.uniform(size=(3, 500)) < 0.6
    jc = jpc.Cloud(jnp.asarray(pts), jnp.asarray(mask))
    tc = tpc.Cloud(torch.tensor(pts), torch.tensor(mask))
    for cap in (200, 500):
        assert_cloud_equal(jpc._pack_scatter(jc, cap),
                           tpc._pack_scatter(tc, cap))


def test_hash_cells_matches_jax_on_negative_cells(rng):
    cells = rng.integers(-2 ** 20, 2 ** 20, size=(4096, 3)).astype(np.int32)
    cells[:8] = [[-1, -1, -1], [0, 0, 0], [-1, 0, 0], [0, -1, 0],
                 [0, 0, -1], [2 ** 31 - 1, -2 ** 31, 5], [-7, 3, -11],
                 [13, -2 ** 31, -1]]
    for cap in (1024, 1000, 2 ** 20 + 7):
        j = np.asarray(jpc._hash_cells(jnp.asarray(cells), cap))
        t = tpc._hash_cells(torch.tensor(cells), cap).numpy()
        np.testing.assert_array_equal(t, j)
        assert t.min() >= 0 and t.max() < cap


def test_filters_match_jax(rng):
    jc, tc = pair(*masked_cloud(rng, n=3000, capacity=3072))
    center, half = [1.0, -2.0, 0.5], [15.0, 10.0, 8.0]
    assert_cloud_equal(
        jpc.box_filter(jc, jnp.asarray(center), jnp.asarray(half)),
        tpc.box_filter(tc, center, half))
    for inside in (False, True):
        assert_cloud_equal(
            jpc.cylindrical_filter(jc, jnp.asarray(center), 12.0, 20.0,
                                   inside),
            tpc.cylindrical_filter(tc, center, 12.0, 20.0, inside))
    assert_cloud_equal(jpc.ground_filter(jc, 1.5, 0.3),
                       tpc.ground_filter(tc, 1.5, 0.3))
    for size, min_pts in ((5.0, 1), (10.0, 3), (0.3, 1)):
        j = jpc.voxel_filter(jc, size, min_pts)
        t = tpc.voxel_filter(tc, size, min_pts)
        assert_cloud_equal(j, t)
        assert 0 < int(t.mask.sum()) <= int(tc.mask.sum())


CHAIN = ({'type': 'range', 'min_distance_m': 2.0, 'max_distance_m': 60.0},
         {'type': 'box', 'center': [0.0, 0.0, 0.0],
          'half_extent': [50.0, 50.0, 30.0]},
         {'type': 'cylindrical', 'radius_m': 3.0, 'remove_inside': True},
         {'type': 'ground', 'robot_height_m': 0.0,
          'ground_clearance_m': 40.0},
         {'type': 'voxel', 'voxel_size_m': 2.0, 'min_points_per_voxel': 1})


def test_filter_chain_matches_jax(rng):
    """Every filter of the chain in order, keep-mask for keep-mask; the
    random-sampling step draws from the port's generator."""
    from laser_slam_tpu.config import _canonical_chain as jcanon
    from laser_slam_tpu_torch.config import _canonical_chain as tcanon
    jc, tc = pair(*masked_cloud(rng, n=3000, capacity=3072))
    j = jpc.apply_filter_chain(jc, jcanon(CHAIN))
    t = tpc.apply_filter_chain(tc, tcanon(CHAIN))
    assert_cloud_equal(j, t)
    assert 0 < int(t.mask.sum()) < int(tc.mask.sum())
    sampled = tcanon(CHAIN[:1] + ({'type': 'random_sampling', 'prob': 0.5},))
    with pytest.raises(ValueError, match='generator'):
        tpc.apply_filter_chain(tc, sampled)
    outs = [tpc.apply_filter_chain(tc, sampled,
                                   torch.Generator().manual_seed(4))
            for _ in range(2)]
    assert torch.equal(outs[0].mask, outs[1].mask)
    ranged = tpc.apply_filter_chain(tc, sampled[:1])
    kept = outs[0].mask.sum().item() / ranged.mask.sum().item()
    assert 0.4 < kept < 0.6 and not bool(torch.any(outs[0].mask
                                                   & ~ranged.mask))
