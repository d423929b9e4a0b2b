"""The port's scan-context place recognition (ops/scan_context.py,
pipeline/place_recognition.py) against the JAX package's.

Tolerances.  Descriptors are equal: the seeded points are drawn away
from ring and sector edges (more than 1e-4 of a cell from one), where
the two packages' f32 floors could land a point one cell apart.
Distances are cosines averaged over sector columns: within 1e-5.  The
best shift must be equal wherever the best and the second-best shift's
similarities differ by more than 1e-4 (near-ties may flip under another
reduction order).  The detector tests mirror
tests/test_place_recognition.py:34-108 on the port.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_slam_tpu.ops import scan_context as jsc
from laser_slam_tpu.pipeline import replay as jrep
from laser_slam_tpu_torch.config import PlaceRecognitionConfig
from laser_slam_tpu_torch.ops import cloud as pc
from laser_slam_tpu_torch.ops import scan_context as tsc
from laser_slam_tpu_torch.pipeline import place_recognition as tpr

torch.set_num_threads(2)
R, S, MAX_R = 20, 60, 80.0


def structured_scan(seed=3, n=2048, step_m=1.0):
    """One sensor-frame scan of the structured synthetic room."""
    frames = list(jrep.SyntheticStream(n_scans=2, points_per_scan=n,
                                       trajectory='line', step_m=step_m,
                                       seed=seed))
    return [f.points.astype(np.float32) for f in frames]


def rotz(points, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return (points @ rot.T).astype(np.float32)


def off_edges(points):
    """Keep the points more than 1e-4 of a cell from a ring or sector
    edge (float64)."""
    p = points.astype(np.float64)
    ring = np.hypot(p[:, 0], p[:, 1]) / MAX_R * R
    sector = (np.arctan2(p[:, 1], p[:, 0]) + np.pi) / (2 * np.pi) * S
    far = lambda v: np.abs(v - np.round(v)) > 1e-4  # noqa: E731
    return points[far(ring) & far(sector)]


def both_descriptors(points, mask):
    j = np.asarray(jsc.descriptor(jnp.asarray(points), jnp.asarray(mask)))
    t = tsc.descriptor(torch.tensor(points), torch.tensor(mask)).numpy()
    return j, t


def test_descriptor_and_ring_key_match_jax(rng):
    pts = off_edges(structured_scan()[0])
    # Points beyond the outer ring, below the z offset, masked out, and
    # SENTINEL-parked padding.
    far = off_edges(rng.uniform(-120, 120, (256, 3)).astype(np.float32))
    pts = np.concatenate([pts, far, np.full((64, 3), pc.SENTINEL,
                                            np.float32)])
    mask = rng.uniform(size=len(pts)) > 0.1
    mask[-64:] = False
    j, t = both_descriptors(pts, mask)
    assert t.shape == (R, S) and t.dtype == np.float32
    np.testing.assert_array_equal(t, j)
    assert np.mean(np.any(t > 0, axis=0)) > 0.9
    # A mean of 60 flags: within one ulp.
    np.testing.assert_allclose(
        tsc.ring_key(torch.tensor(t)).numpy(),
        np.asarray(jsc.ring_key(jnp.asarray(j))), rtol=2e-7)
    # An empty scan gives an empty descriptor.
    j0, t0 = both_descriptors(pts, np.zeros(len(pts), bool))
    assert not t0.any() and not j0.any()


def test_distance_batch_and_yaw_match_jax(rng):
    """A database of rotated views of one place, another place, an empty
    entry and an excluded entry, queried with one scan."""
    a, c = structured_scan(seed=5, step_m=20.0)
    mask = np.ones(len(a), bool)
    views = [rotz(a, -k * 2 * np.pi / S) for k in (0, 7, 31)]
    views.append(rotz(a, 0.123))
    descs = [both_descriptors(v, mask) for v in views + [c]]
    db_j = np.stack([d[0] for d in descs] + [np.zeros((R, S), np.float32)] * 2)
    db_t = np.stack([d[1] for d in descs] + [np.zeros((R, S), np.float32)] * 2)
    db_t[-1] = db_t[0]
    db_j[-1] = db_j[0]
    np.testing.assert_array_equal(db_t, db_j)
    valid = np.ones(len(db_j), bool)
    valid[-1] = False
    jd, js = jax.jit(jsc.distance_batch)(jnp.asarray(db_j), jnp.asarray(valid),
                                         jnp.asarray(db_j[0]))
    td, ts = tsc.distance_batch(torch.tensor(db_t), torch.tensor(valid),
                                torch.tensor(db_t[0]))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    assert td[0] < 1e-5 and td[-1] == 2.0 and td[-2] == 2.0
    assert td[4] > 0.3
    # Shifts, where the best shift clears the second best by 1e-4.
    margins = shift_margins(db_t, db_t[0])
    clear = margins > 1e-4
    assert clear[:4].all()
    np.testing.assert_array_equal(ts.numpy()[clear], np.asarray(js)[clear])
    assert ts.dtype == torch.int32
    # Entry k is the query's frame turned by -k sectors: a_T_b = Rz(-k d).
    for k, want in zip(range(3), (0, 7, 31)):
        yaw = float(tsc.yaw_from_shift(ts[k], S))
        true = -want * 2 * np.pi / S
        assert abs((yaw - true + np.pi) % (2 * np.pi) - np.pi) < 1e-5
    shifts = np.arange(-S, 2 * S, dtype=np.int32)
    np.testing.assert_allclose(
        tsc.yaw_from_shift(torch.tensor(shifts), S).numpy(),
        np.asarray(jsc.yaw_from_shift(jnp.asarray(shifts), S)), atol=1e-6)


def shift_margins(db, query):
    """float64 gap between the best and second-best shift's similarity
    per entry."""
    def norm(d):
        n = np.linalg.norm(d, axis=-2, keepdims=True)
        return d / np.where(n > 0, n, 1.0), n[..., 0, :] > 0
    dn, dv = norm(db.astype(np.float64))
    qn, qv = norm(query.astype(np.float64))
    idx = (np.arange(S)[None, :] + np.arange(S)[:, None]) % S
    corr = np.einsum('krj,rsj->ks', dn, qn[:, idx])
    npairs = np.einsum('kj,sj->ks', dv.astype(float), qv[idx].astype(float))
    sim = np.sort(corr / np.maximum(npairs, 1.0), axis=1)
    return sim[:, -1] - sim[:, -2]


def test_descriptor_and_query_matches_jax(rng):
    a, c = structured_scan(seed=7, step_m=20.0)
    mask = np.ones(len(a), bool)
    db = np.stack([both_descriptors(x, mask)[1] for x in (a, c, a)])
    keys = np.array([0, 5, 40, -1], np.int32)
    db = np.concatenate([db, np.zeros((1, R, S), np.float32)])
    query = off_edges(rotz(a, 0.3))
    qmask = np.ones(len(query), bool)
    for newest in (3, 39, 100):
        jdesc, jd, js = jsc.descriptor_and_query(
            jnp.asarray(db), jnp.asarray(keys), jnp.asarray(query),
            jnp.asarray(qmask), jnp.int32(newest))
        tdesc, td, ts = tsc.descriptor_and_query(
            torch.tensor(db), torch.tensor(keys), torch.tensor(query),
            torch.tensor(qmask), torch.tensor(newest, dtype=torch.int32))
        np.testing.assert_array_equal(tdesc.numpy(), np.asarray(jdesc))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
        excluded = (keys < 0) | (keys > newest)
        assert np.all(td.numpy()[excluded] == 2.0)
        row = tsc.best_row(td, ts, torch.tensor(keys), S).numpy()
        want = int(np.argmin(np.asarray(jd)))
        assert row[0] == keys[want]


def test_detector_add_query_and_temporal_exclusion():
    cfg = PlaceRecognitionConfig(exclude_recent_keys=10,
                                 distance_threshold=0.3, db_capacity=8)
    det = tpr.ScanContextDetector(cfg, device='cpu')
    pts = structured_scan(seed=5)[0]
    mask = np.ones((len(pts),), bool)
    assert det.query(pts, mask, key=0) is None          # empty database
    det.add(pts, mask, key=0)
    # key 5: entry 0 is within the exclusion window (5 - 10 < 0).
    assert det.query(pts, mask, key=5) is None
    hit = det.query(pts, mask, key=30)
    assert hit is not None and hit.key == 0
    assert hit.distance < 0.05
    assert abs(hit.yaw_rad) < 2 * np.pi / cfg.n_sectors + 1e-6
    # query_async keeps the row on the device; add=True stores the scan.
    row = det.query_async(rotz(pts, 0.5), mask, key=31, add=True)
    assert isinstance(row, torch.Tensor) and row.shape == (3,)
    assert det.n == 2 and int(det.db_keys[1]) == 31
    assert det.to_detection(np.array([-1.0, math.inf, 0.0])) is None
    assert det.to_detection(np.array([0.0, 0.31, 0.0])) is None


def test_detector_capacity_growth():
    cfg = PlaceRecognitionConfig(db_capacity=2)
    det = tpr.ScanContextDetector(cfg, device='cpu')
    pts = structured_scan(seed=5)[0]
    mask = np.ones((len(pts),), bool)
    for k in range(5):
        det.add(rotz(pts, 0.1 * k), mask, key=k)
    assert det.n == 5 and det.db.shape[0] == 8
    np.testing.assert_array_equal(det.db_keys.numpy(),
                                  [0, 1, 2, 3, 4, -1, -1, -1])
    det.ensure_room(10)
    assert det.db.shape[0] == 16 and int(det.db_keys[15]) == -1


def test_detector_defaults_to_the_card():
    if torch.cuda.is_available():
        assert tpr.ScanContextDetector().db.device.type == 'cuda'
        return
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tpr.ScanContextDetector()
