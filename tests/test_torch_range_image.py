"""The port's range-image matcher and normals against the JAX package's.

Projection: a point on a pixel boundary can land on either side in the
two libraries (their ``arcsin``/``atan2`` and XLA's fused arithmetic
round differently), so the matcher's inputs sit at pixel centres, where
both must agree exactly: depth, payload and occupancy equal, each
query's window candidates equal to JAX's packed neighbourhood row, and
``nn_projective`` equal (d2 within 1e-6 relative: the sum of squares
rounds in another order).

Normals: the tangent normals agree within 1e-5 per component.  The
image-PCA normal is the smallest eigenvector of an f32 covariance, and
its f32 rounding error grows as the relative gap between the two
smallest eigenvalues shrinks (the JAX package's own jitted and eager runs differ
by up to ~1e-2 on the beam scene's worst-conditioned windows).  So they
must agree within 1e-5 per component where the gap is above 0.1, and
within 2 * 2**-23 / gap**2 elsewhere: the closed-form eigenvector takes
the arccos of a ratio that nears +-1 as the two eigenvalues meet, so its
error grows as 1/gap**2 (measured worst: ~1.5e-8 / gap**2).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_slam_tpu.config import IcpConfig as JIcpConfig
from laser_slam_tpu.ops import cloud as jpc
from laser_slam_tpu.ops import icp as jicp
from laser_slam_tpu.ops import range_image as jri
from laser_slam_tpu.ops import se3 as jse3
from laser_slam_tpu.pipeline import velodyne_sim as jvs
from laser_slam_tpu_torch.config import IcpConfig
from laser_slam_tpu_torch.ops import cloud as tpc
from laser_slam_tpu_torch.ops import icp as ticp
from laser_slam_tpu_torch.ops import range_image as tri

torch.set_num_threads(2)
ROWS, COLS, EMIN, EMAX = 32, 256, -0.3, 0.3
HDL_EMIN = math.radians(-24.8) - 0.01
HDL_EMAX = math.radians(2.0) + 0.01
EPS32 = 2.0 ** -23


def centred_points(rng, n, rows=ROWS, cols=COLS, per_pixel=3):
    """Points at pixel centres (several per pixel, distinct ranges)."""
    n_pix = n // per_pixel
    r_idx = rng.integers(0, rows, n_pix)
    c_idx = rng.integers(0, cols, n_pix)
    elev = EMIN + (r_idx + 0.5) / rows * (EMAX - EMIN)
    az = (c_idx + 0.5) / cols * 2 * np.pi - np.pi
    d = np.stack([np.cos(elev) * np.cos(az), np.cos(elev) * np.sin(az),
                  np.sin(elev)], 1)
    d = np.repeat(d, per_pixel, axis=0)
    rng_m = rng.uniform(4.0, 30.0, len(d))
    pts = (d * rng_m[:, None]).astype(np.float32)
    normals = rng.normal(size=pts.shape)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return pts, normals.astype(np.float32)


def pair(pts, mask=None):
    n = len(pts)
    mask = np.ones(n, bool) if mask is None else mask
    return (jpc.make_cloud(jnp.asarray(pts), jnp.asarray(mask), n),
            tpc.make_cloud(pts, mask, n))


@pytest.mark.parametrize('window', ['3x3', 'cross', '5x5'])
def test_build_range_image_and_nn_projective_match_jax(rng, window):
    pts, normals = centred_points(rng, 3000)
    mask = rng.uniform(size=len(pts)) > 0.1
    jc, tc = pair(pts, mask)
    jimg = jri.build_range_image(jc, jnp.asarray(normals), rows=ROWS,
                                 cols=COLS, elev_min=EMIN, elev_max=EMAX,
                                 window=window)
    timg = tri.build_range_image(tc, torch.tensor(normals), rows=ROWS,
                                 cols=COLS, elev_min=EMIN, elev_max=EMAX,
                                 window=window)
    np.testing.assert_array_equal(timg.depth.numpy(), np.asarray(jimg.depth))
    np.testing.assert_array_equal(timg.payload.numpy(),
                                  np.asarray(jimg.payload))
    n_pix = ROWS * COLS
    W = len(tri._window_offsets(window))
    jnb = np.asarray(jimg.neighborhood).reshape(n_pix, W, 7)
    centre = tri._window_offsets(window).index((0, 0))
    np.testing.assert_array_equal(timg.slots[:n_pix, 6].numpy(),
                                  jnb[:, centre, 6])
    # Every pixel's window read from the slot image equals JAX's packed
    # neighbourhood row, occupancy included.
    pix = torch.arange(n_pix)
    cand = timg.slots[tri._window_index(pix // COLS, pix % COLS, timg)]
    np.testing.assert_array_equal(cand.numpy(), jnb)

    queries, _ = centred_points(rng, 2048, per_pixel=1)
    jq, jn, jd2 = jri.nn_projective(jnp.asarray(queries), jimg)
    tq, tn, td2 = tri.nn_projective(torch.tensor(queries), timg)
    jd2 = np.asarray(jd2)
    np.testing.assert_array_equal(np.isinf(td2.numpy()), np.isinf(jd2))
    fin = np.isfinite(jd2)
    assert fin.mean() > 0.3
    np.testing.assert_allclose(td2.numpy()[fin], jd2[fin], rtol=1e-6)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_zbuffer_exact_ties_go_to_the_lowest_index():
    pts = np.tile(np.array([[10.0, 0.5, 0.1]], np.float32), (4, 1))
    normals = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    img = tri.build_range_image(tpc.make_cloud(pts), torch.tensor(normals),
                                rows=8, cols=16)
    occupied = torch.nonzero(img.slots[:, 6]).flatten()
    assert occupied.numel() == 1
    np.testing.assert_array_equal(img.payload[occupied[0], 3:].numpy(),
                                  normals[0])


def plane_cloud(rng):
    """tests/test_range_image.py::test_image_pca_normals_plane."""
    xy = rng.uniform(-5, 5, size=(1024, 2))
    pts = np.concatenate([xy, np.zeros((1024, 1))], axis=1).astype(
        np.float32)
    pts[:, 2] -= 1.0
    return pts, (-1.2, 0.2)


def beam_cloud(n_azimuth):
    """A ray-cast HDL-64 scan; its azimuths are column centres when the
    image has ``n_azimuth`` columns."""
    scene = jvs.make_beam_scene(seed=1, world_size_m=50.0)
    pose = np.array([1, 0, 0, 0, 3.0, -2.0, 1.5], np.float32)
    pts, _ = jvs.beam_scan(scene, pose, jvs.HDL64_ELEV_DEG,
                           n_azimuth=n_azimuth, range_noise_m=0.01,
                           rng=np.random.default_rng(7))
    return pts, (HDL_EMIN, HDL_EMAX)


def eigen_gap(pts, mask, rows, cols, emin, emax, window='5x5'):
    """Per-point relative gap (l2 - l1) / l3 of its pixel's window
    covariance, in float64."""
    tc = tpc.make_cloud(pts, mask)
    row, col, r = tri._project(tc.points, rows, cols, emin, emax)
    flat = row * cols + col
    _, winner = tri._zbuffer(flat, r, tc.mask, rows * cols)
    grid = tri._winner_rows(tc.points, winner).double().reshape(
        rows, cols, 3).numpy()
    occ = (winner < len(pts)).double().reshape(rows, cols, 1).numpy()
    n_s, s, outer = 0.0, 0.0, 0.0
    for dr, dc in tri._window_offsets(window):
        sp = np.roll(grid, (-dr, -dc), axis=(0, 1))
        so = np.roll(occ, (-dr, -dc), axis=(0, 1))
        if dr < 0:
            so[:(-dr)] = 0.0
        elif dr > 0:
            so[-dr:] = 0.0
        d = (sp - grid) * so
        n_s, s = n_s + so, s + d
        outer = outer + d[..., :, None] * d[..., None, :]
    n_c = np.maximum(n_s, 1.0)
    mean = s / n_c
    cov = outer / n_c[..., None] - mean[..., :, None] * mean[..., None, :]
    ev = np.linalg.eigvalsh(cov.reshape(-1, 3, 3))
    gap = (ev[:, 1] - ev[:, 0]) / np.maximum(ev[:, 2], 1e-30)
    return gap[flat.numpy()]


SCENES = [('plane', 16, 128), ('beam', 32, 128), ('beam', 32, 256),
          ('beam', 16, 256)]


@pytest.mark.parametrize('scene,rows,cols', SCENES,
                         ids=[f'{s}-{r}x{c}' for s, r, c in SCENES])
def test_range_image_normals_match_jax(rng, scene, rows, cols):
    pts, (emin, emax) = (plane_cloud(rng) if scene == 'plane'
                         else beam_cloud(cols))
    mask = np.ones(len(pts), bool)
    mask[::17] = False
    jc, tc = pair(pts, mask)
    kw = dict(rows=rows, cols=cols, elev_min=emin, elev_max=emax)
    jn = np.asarray(jri.range_image_normals(jc, **kw))
    tn = tri.range_image_normals(tc, **kw).numpy()
    np.testing.assert_allclose(tn, jn, atol=1e-5)

    jn = np.asarray(jri.range_image_pca_normals(jc, **kw))
    tn = tri.range_image_pca_normals(tc, **kw).numpy()
    # Sign-free (point-to-plane reads a line): where a normal is nearly
    # perpendicular to its viewing ray, the orientation test may flip it.
    diff = np.minimum(np.abs(tn - jn).max(axis=1),
                      np.abs(tn + jn).max(axis=1))
    gap = eigen_gap(pts, mask, rows, cols, emin, emax)
    well = (gap > 0.1) & mask
    assert well.mean() > 0.2
    assert diff[well].max() <= 1e-5, diff[well].max()
    bound = np.maximum(1e-5, 2 * EPS32 / np.maximum(gap, 1e-30) ** 2)
    assert np.all(diff[mask] <= bound[mask]), (diff / bound).max()
    np.testing.assert_array_equal(tn[~mask], np.tile([0, 0, 1.0],
                                                     ((~mask).sum(), 1)))


@pytest.mark.parametrize('method', ['auto', 'image_pca', 'range_image'])
def test_compute_normals_dispatch_matches_jax(method):
    """Both packages route each method to the same function: 'auto'
    takes image_pca at 8192 points and knn below."""
    pts, (emin, emax) = beam_cloud(128)
    n = 8192
    pts = np.concatenate([pts, pts[:n - len(pts)] * 1.01]).astype(
        np.float32)
    kw = dict(normal_method=method, normal_image_rows=32,
              normal_image_cols=128, range_image_elev_min=emin,
              range_image_elev_max=emax)
    img = dict(rows=32, cols=128, elev_min=emin, elev_max=emax)
    j_fn, t_fn = ((jri.range_image_normals, tri.range_image_normals)
                  if method == 'range_image' else
                  (jri.range_image_pca_normals, tri.range_image_pca_normals))
    for m in (n, 1024):
        jc, tc = pair(pts[:m])
        jn = np.asarray(jri.compute_normals(jc, JIcpConfig(**kw)))
        tn = tri.compute_normals(tc, IcpConfig(**kw)).numpy()
        if m < 8192 and method == 'auto':
            np.testing.assert_array_equal(
                tn, tpc.estimate_normals(tc, knn=10).numpy())
            np.testing.assert_array_equal(
                jn, np.asarray(jpc.estimate_normals(jc, knn=10)))
            continue
        np.testing.assert_array_equal(tn, t_fn(tc, **img).numpy())
        np.testing.assert_array_equal(jn, np.asarray(j_fn(jc, **img)))


def lidar_scene(rng, n=4096):
    """tests/test_range_image.py::lidar_scene."""
    az = rng.uniform(-np.pi, np.pi, n)
    r = rng.uniform(8, 25, n)
    z = rng.uniform(-1.0, 2.0, n)
    return np.stack([r * np.cos(az), r * np.sin(az), z], 1).astype(
        np.float32)


@pytest.mark.parametrize('window', ['3x3', 'cross'])
def test_icp_projective_matches_jax(rng, window):
    """tests/test_range_image.py::test_icp_projective_recovers_transform
    through both packages, with the same reference normals; the prebuilt
    image gives the same result as the image built inside."""
    pts = lidar_scene(rng)
    jref, tref = pair(pts)
    normals = jpc.estimate_normals(jref, knn=10)
    T_true = jse3.exp(jnp.asarray([0.01, -0.01, 0.03, 0.3, -0.2, 0.05],
                                  jnp.float32))
    jread = jpc.transform(jse3.inverse(T_true), jref)
    tread = tpc.make_cloud(np.asarray(jread.points))
    kw = dict(matcher='projective', range_image_rows=32,
              range_image_cols=512, range_image_elev_min=-0.3,
              range_image_elev_max=0.3, range_image_window=window)
    jres = jicp.icp(jread, jref, normals, jse3.identity(), JIcpConfig(**kw))
    tn = torch.tensor(np.asarray(normals))
    tres = ticp.icp(tread, tref, tn, torch.tensor(np.asarray(
        jse3.identity())), IcpConfig(**kw))
    assert bool(tres.valid) and bool(jres.valid)
    np.testing.assert_allclose(tres.T.numpy(), np.asarray(jres.T), atol=1e-5)
    assert abs(int(tres.num_inliers) - int(jres.num_inliers)) <= 4
    err_t = np.linalg.norm(tres.T.numpy()[4:] - np.asarray(T_true)[4:])
    assert err_t < 0.02, err_t
    image = tri.build_range_image(tref, tn, rows=32, cols=512,
                                  elev_min=-0.3, elev_max=0.3,
                                  window=window)
    pre = ticp.icp_point_to_plane(tread, tref, tn, torch.tensor(
        np.asarray(jse3.identity())), IcpConfig(**kw), prebuilt_image=image)
    np.testing.assert_array_equal(pre.T.numpy(), tres.T.numpy())
