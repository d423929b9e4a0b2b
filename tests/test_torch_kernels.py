"""The port's exact-NN kernels and plain searches, without JAX.

This file imports only torch, numpy and the port, so it also runs on the
GPU machine (which has no jax), with the repo's conftest left out:

    python3 -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_kernels.py

There the ``gpu`` tests build csrc/nn.cu and csrc/nn_variants.cu and
hold K1, K2 and the shootout's kernels (E1-E6) to their plain versions;
here they skip.  Tolerances: K1, K2, E2/E3 — indices equal except where
float64 shows an exact f32 tie, d2 within 1e-6 relative; the matmul-form
kernels (E1, E4, E5, E6) — the float64 checks of ``ops/nn_variants.py``:
each d2 within ``nn_variants.score_tolerance`` (4 f32 units of roundoff of
the query's term sum against its winner) of the float64 d2 of a row it
may have picked.
"""

import numpy as np
import pytest
import torch

from laser_slam_tpu_torch.experiments import nn_shootout as sh
from laser_slam_tpu_torch.ops import nn_kernels as nk
from laser_slam_tpu_torch.ops import nn_variants as nv
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
@pytest.mark.parametrize('cutoff', [1.0, 3.0])
def test_replayed_k2_walk_skips_tiles_and_reaches_the_exact_nn(cutoff):
    """The plain replay of K2's walk (the work the card's bound counts)
    scans fewer tiles than there are, and still reaches the exact d2 of
    every query with a point within the cutoff."""
    q, ref, _ = sh.make_scene(2048, 32768, seed=4)
    q, ref = torch.tensor(q), torch.tensor(ref)
    q[::7] += 2.0                     # some queries beyond a 1 m cutoff
    pref = nk.build_pruned_ref(ref, rb=512)
    visits, d2 = nk.pruned_visits(q, pref, cutoff)
    n_tiles = pref.tile_lo.shape[0]
    assert visits.shape == (8,) and n_tiles == 64
    assert 1 <= int(visits.min()) and int(visits.sum()) < 8 * n_tiles
    want = nk.nn_indices_pruned_plain(q, pref, cutoff)[0]
    inside = want <= cutoff ** 2
    assert int(inside.sum()) > 100
    assert torch.equal(d2[inside], want[inside])
    assert bool(torch.all(d2[~inside] > cutoff ** 2))


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


def _card_scenes():
    """The shootout's scene at a mid size, and an awkward shape (3001 is
    prime: one-point E4/E6 tiles) with every third reference row parked."""
    q, ref, pay = sh.make_scene(3000, 20480, seed=5)
    q2, ref2, pay2 = sh.make_scene(1000, 3001, seed=6)
    ref2[::3] = 1.0e6
    pay2[:, :3] = ref2
    # Copies of 64 points inside their 2048-wide tile, queried nearby.
    ref[1000:1064] = ref[:64]
    pay[1000:1064] = np.concatenate([ref[:64], -pay[:64, 3:]], axis=1)
    q[:64] = ref[:64] + 0.01
    return [tuple(torch.tensor(a, device='cuda') for a in s)
            for s in ((q, ref, pay), (q2, ref2, pay2))]


@pytest.mark.gpu
def test_shootout_kernels_match_plain_on_card():
    """E1/E5, E4, E6 and E2/E3 built from csrc/nn_variants.cu against their
    plain versions, each launch counted once."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    for q, ref, pay in _card_scenes():
        for precision in nv.PRECISIONS:
            before = (nv.nn_indices_mm.launches
                      + nv.nn_indices_mm.launches_bf16)
            d2, idx = nv.nn_indices_mm(q, ref, precision)
            assert (nv.nn_indices_mm.launches
                    + nv.nn_indices_mm.launches_bf16) == before + 1
            nv.check_mm_indices(q, ref, d2, idx,
                                *nv.nn_indices_mm_plain(q, ref, precision),
                                precision=precision)
        before = nv.nn_payload.launches
        d2, out = nv.nn_payload(q, ref, pay)
        assert nv.nn_payload.launches == before + 1
        c = nv.check_payload(q, ref, pay, d2, out,
                             *nv.nn_payload_plain(q, ref, pay))
        if q.shape[0] == 3000:
            assert c['duplicates'] >= 64
            mean = 0.5 * (pay[:64] + pay[1000:1064])
            assert float(torch.max(torch.abs(out[:64] - mean))) < 1e-5
        d2, out, visits = nv.nn_payload_pruned(q, ref, pay,
                                               return_visits=True)
        nv.check_payload(q, ref, pay, d2, out,
                         *nv.nn_payload_pruned_plain(q, ref, pay))
        assert 1 <= int(visits.min()) and int(visits.max()) <= (
            ref.shape[0] // nv.pruned_tables(q, ref, pay).rb)
        want = nk.nn_indices_plain(q, ref)
        nv.check_exact_indices(q, ref, *nv.nn_vpu(q, ref), *want)
        for qb, rb in ((128, 1024), (512, 4096), (8192, 8192)):
            nv.check_exact_indices(q, ref, *nv.nn_indices_tiled(q, ref, qb,
                                                                rb), *want)


@pytest.mark.gpu
def test_tile_beyond_shared_memory_is_refused_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    q, ref, _ = _card_scenes()[1]
    with pytest.raises(nv.TileTooLarge):
        nv.nn_indices_tiled(q, ref, 8192, 65536)


@pytest.mark.gpu
def test_empty_query_sets_count_no_launch_on_card():
    """A wrapper that launches nothing for Q == 0 leaves its counter."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    ref = torch.tensor(scene(7, 4096, 1)[1], device='cuda')
    none = torch.zeros((0, 3), device='cuda')
    nv.reset_launches()
    nv.nn_vpu(none, ref)
    nv.nn_indices_tiled(none, ref, 128, 1024)
    nv.nn_indices_mm(none, ref)
    nv.nn_indices_mm(none, ref, 'bf16')
    nv.nn_payload(none, ref, torch.zeros((4096, 6), device='cuda'))
    assert (nv.nn_vpu.launches, nv.nn_indices_tiled.launches,
            nv.nn_indices_mm.launches, nv.nn_indices_mm.launches_bf16,
            nv.nn_payload.launches) == (0, 0, 0, 0, 0)
