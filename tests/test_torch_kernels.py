"""The port's exact-NN kernels and plain searches, without JAX.

This file imports only torch, numpy and the port, so it also runs on the
GPU machine (which has no jax), with the repo's conftest left out:

    python3 -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_kernels.py

There the ``gpu`` test builds csrc/nn.cu and holds K1 and K2 to their
plain versions; here it skips.  Tolerances: indices equal except where
float64 shows an exact f32 tie; d2 within 1e-6 relative.
"""

import numpy as np
import pytest
import torch

from laser_slam_tpu_torch.ops import nn_kernels as nk
from laser_slam_tpu_torch.ops.neighbors import knn_brute, nn_brute

torch.set_num_threads(2)


def scene(seed, n_ref, n_q, scale=5.0):
    g = np.random.default_rng(seed)
    return ((g.normal(size=(n_q, 3)) * scale).astype(np.float32),
            (g.normal(size=(n_ref, 3)) * scale).astype(np.float32))


def assert_same_nn(q, ref, d2_a, idx_a, d2_b, idx_b):
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


def test_nn_brute_and_knn_brute_match_float64():
    q, ref = scene(0, 2048, 300)
    idx, d2 = nn_brute(torch.tensor(q), torch.tensor(ref))
    full = ((q[:, None].astype(np.float64) - ref[None]) ** 2).sum(-1)
    assert_same_nn(q, ref, d2.numpy(), idx.numpy(), full.min(1),
                   full.argmin(1))
    kidx, kd2 = knn_brute(torch.tensor(q), torch.tensor(ref), 10)
    want = np.sort(full, axis=1)[:, :10]
    np.testing.assert_allclose(kd2.numpy(), want, rtol=1e-5, atol=1e-6)
    assert kidx.dtype == torch.int32 and kidx.shape == (300, 10)


@pytest.mark.parametrize('cutoff', [0.5, 1.0, 3.0])
def test_plain_versions_match_float64(cutoff):
    q, ref = scene(1, 3001, 257)
    d2, idx = nk.nn_indices(torch.tensor(q), torch.tensor(ref))
    full = ((q[:, None].astype(np.float64) - ref[None]) ** 2).sum(-1)
    assert_same_nn(q, ref, d2.numpy(), idx.numpy(), full.min(1),
                   full.argmin(1))
    pref = nk.build_pruned_ref(torch.tensor(ref), rb=256)
    pd2, pidx = nk.nn_indices_pruned(torch.tensor(q), pref, cutoff=cutoff)
    inside = full.min(1) <= cutoff ** 2
    orig = pref.perm.numpy()[pidx.numpy()]
    assert_same_nn(q[inside], ref, pd2.numpy()[inside], orig[inside],
                   full.min(1)[inside], full.argmin(1)[inside])
    assert np.all(np.isinf(pd2.numpy()[~inside]))


def test_pruned_tables_bound_every_pair():
    """Each [query tile, reference tile] bound is <= every pair distance
    between the two tiles, and each row is sorted ascending — what lets
    the kernel stop at the first bound beyond the cutoff."""
    q, ref = scene(2, 2048, 512, scale=20.0)
    pref = nk.build_pruned_ref(torch.tensor(ref), rb=256)
    qperm, q_sorted, order, lb, qb, rb = nk.pruned_tables(
        torch.tensor(q), pref, cutoff=1e9)
    assert torch.all(lb[:, 1:] >= lb[:, :-1])
    for b in range(order.shape[0]):
        for j in range(order.shape[1]):
            t = int(order[b, j])
            qs = q_sorted[b * qb:(b + 1) * qb]
            rs = pref.points[t * rb:(t + 1) * rb]
            d = ((qs[:, None, :] - rs[None]) ** 2).sum(-1)
            assert float(lb[b, j]) <= float(d.min())


def test_wrappers_refuse_other_devices_and_dtypes():
    q = torch.zeros((4, 3), device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        nk.nn_indices(q, q)
    with pytest.raises(ValueError, match='float32'):
        nk.nn_indices(torch.zeros((4, 3), dtype=torch.float64),
                      torch.zeros((4, 3), dtype=torch.float64))
    pref = nk.PrunedRef(q, torch.zeros(4, dtype=torch.int32, device='meta'),
                        q[:1], q[:1])
    with pytest.raises(ValueError, match='CUDA'):
        nk.nn_indices_pruned(q, pref)


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    """K1 and K2 built from csrc/nn.cu against their plain versions, each
    launch counted once."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    q, ref = scene(3, 20000, 3000)
    qc, rc = torch.tensor(q, device='cuda'), torch.tensor(ref, device='cuda')
    before = nk.nn_indices.launches
    d2, idx = nk.nn_indices(qc, rc)
    assert nk.nn_indices.launches == before + 1
    pd2, pidx = nk.nn_indices_plain(qc, rc)
    torch.cuda.synchronize()
    assert_same_nn(q, ref, d2.cpu().numpy(), idx.cpu().numpy(),
                   pd2.cpu().numpy(), pidx.cpu().numpy())
    pref = nk.build_pruned_ref(rc)
    before = nk.nn_indices_pruned.launches
    d2, idx = nk.nn_indices_pruned(qc, pref, cutoff=1.0)
    assert nk.nn_indices_pruned.launches == before + 1
    pd2, pidx = nk.nn_indices_pruned_plain(qc, pref, cutoff=1.0)
    inside = (pd2 <= 1.0).cpu().numpy()
    assert_same_nn(q[inside], pref.points.cpu().numpy(),
                   d2.cpu().numpy()[inside], idx.cpu().numpy()[inside],
                   pd2.cpu().numpy()[inside], pidx.cpu().numpy()[inside])
    assert np.all(d2.cpu().numpy()[~inside] > 1.0)
