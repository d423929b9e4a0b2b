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
    pts = scene(rng, 512)
    jc, tc = pair(pts, np.ones(512, bool), 512)
    jn = np.asarray(jri.compute_normals(jc, JIcpConfig(normal_method='knn')))
    tn = tri.compute_normals(tc, IcpConfig(normal_method='knn')).numpy()
    assert np.all(np.abs(np.sum(jn * tn, axis=1)) > 0.999)
    for method in ('auto', 'image_pca', 'range_image'):
        with pytest.raises(NotImplementedError, match='slice 2'):
            tri.compute_normals(tc, IcpConfig(normal_method=method))
