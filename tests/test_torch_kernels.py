"""The port's exact-NN kernels and plain searches, without JAX.

This file imports only torch, numpy and the port, so it also runs on the
GPU machine (which has no jax), with the repo's conftest left out:

    python3 -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_kernels.py

There the ``gpu`` tests build csrc/nn.cu and csrc/nn_variants.cu and
hold K1, K2 (its set-up on the card equal to ``pruned_tables``), their
lane forms K1L and K2L (fleet mode) and the
shootout's kernels (E1-E6) to their plain versions
(E1/E4/E5 also at awkward shapes, with copies across tiles, and for their
work items and launches; E1's set-up bit-equal to its plain version and
its epilogue's second scoring finding every key), and
``profiling.nn_kernel_utilization``
reports K1 against its ``CardPeaks`` bound; here they skip.  Tolerances: K1 — d2 bit-equal and indices equal to its
plain version (ties go to the lowest index); K2 — within the cutoff d2
bit-equal and an index at that exact d2, beyond it d2 > cutoff^2; E2/E3
— d2 bit-equal to K1's plain version and indices equal except where
float64 shows an exact f32 tie (or within 1e-6 relative, on the mid-size
scenes of the older test); the matmul-form
kernels (E1, E4, E5, E6) — the float64 checks of ``ops/nn_variants.py``:
each d2 within ``nn_variants.score_tolerance`` (4 f32 units of roundoff of
the query's term sum against its winner) of the float64 d2 of a row it
may have picked.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from laser_slam_tpu_torch.experiments import nn_shootout as sh
from laser_slam_tpu_torch.ops import cuda_build
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


def test_k2_setup_refuses_cpu_tensors_and_a_reference_without_its_box():
    """The card's set-up takes CUDA tensors only (the CPU path is the
    plain K2, which needs no tables) and a reference that carries its
    Morton box; the box is kept by build_pruned_ref."""
    q, ref = scene(2, 512, 100)
    pref = nk.build_pruned_ref(torch.tensor(ref))
    assert pref.box.shape == (3, 3)
    with pytest.raises(ValueError, match='CUDA'):
        nk.pruned_setup(torch.tensor(q), pref, 3.0)
    with pytest.raises(ValueError, match='Morton box'):
        nk.pruned_setup(torch.tensor(q), pref._replace(box=None), 3.0)
    lanes = nk.build_pruned_ref_lanes(torch.tensor(np.stack([ref, ref])))
    assert lanes.box.shape == (2, 3, 3)
    assert torch.equal(lanes.lane(1).box, pref.box)


def test_small_lane_references_take_1024_point_tiles():
    """K2L's reference tile: lanes of at most 4096 points that 1024
    divides take 1024-point tiles, others the JAX package's tile
    (``_tile(R, 4096)``), an explicit ``rb`` its own; the sorted
    reference is the same at every tile."""
    g = np.random.default_rng(5)
    for n_ref, tiles in ((4096, 4), (2048, 2), (3001, 1), (8192, 2)):
        ref = torch.tensor(g.normal(size=(2, n_ref, 3)).astype(np.float32))
        pref = nk.build_pruned_ref_lanes(ref)
        assert pref.tile_lo.shape == (2, tiles, 3)
        wide = nk.build_pruned_ref_lanes(ref, rb=4096)
        assert torch.equal(pref.points, wide.points)
        assert torch.equal(pref.perm, wide.perm)
    assert nk.build_pruned_ref_lanes(ref, rb=512).tile_lo.shape == (2, 16, 3)


def _setup_scene(name, device):
    """Queries, reference (with a lane axis for 'lanes*'), rb, and the
    most queries a lane sorted in shared memory, for K2's set-up on the
    card."""
    g = np.random.default_rng(sorted(SETUP_SCENES).index(name) + 40)

    def pts(*shape, scale=5.0):
        return (g.normal(size=shape) * scale).astype(np.float32)

    rb, sort_keys = None, nk._SORT_KEYS
    if name == 'room':
        q, ref, _ = sh.make_scene(8192, 81920, seed=16)
    elif name == 'parked':
        q, ref = pts(3000, 3), pts(20000, 3)
        q[::5] = 1.0e6
        ref[::3] = 1.0e6
    elif name == 'all-parked':
        q, ref = pts(1000, 3), np.full((3001, 3), 1.0e6, np.float32)
    elif name == 'q1000':
        q, ref = pts(1000, 3), pts(3001, 3)
    elif name == 'prime-q':
        q, ref = pts(8191, 3), pts(20000, 3)
    elif name == 'duplicates':
        q, ref = np.tile(pts(64, 3), (128, 1)), pts(20000, 3)
    elif name == 'overlapping':
        q = g.uniform(0.0, 2.0, size=(256, 3)).astype(np.float32)
        ref = g.uniform(0.0, 2.0, size=(16384, 3)).astype(np.float32)
        rb = 128
    elif name == 'q16384':
        q, ref = pts(16384, 3), pts(20000, 3)
    elif name == 'q20000':
        q, ref = pts(20000, 3), pts(20000, 3)
    elif name == 'sort-route':
        q, ref, _ = sh.make_scene(8192, 81920, seed=17)
        sort_keys = 0
    elif name == 'prime-r':
        q, ref = pts(1000, 3), pts(4099, 3)
    elif name == 'lanes':
        q, ref = pts(3, 2000, 3), pts(3, 5000, 3)
        ref[1, ::3] = 1.0e6
        ref[2] = 1.0e6
    elif name == 'lanes-sort-routes':
        q, ref = pts(2, 20000, 3), pts(2, 4099, 3)
    else:
        raise KeyError(name)
    return (torch.tensor(q, device=device), torch.tensor(ref, device=device),
            rb, sort_keys)


SETUP_SCENES = ('room', 'parked', 'all-parked', 'q1000', 'prime-q',
                'duplicates', 'overlapping', 'q16384', 'q20000',
                'sort-route', 'prime-r', 'lanes', 'lanes-sort-routes')


@pytest.mark.gpu
@pytest.mark.parametrize('name', SETUP_SCENES)
def test_k2_setup_equals_pruned_tables_on_card(name, monkeypatch):
    """K2's set-up on the card (``pruned_setup``: the shared-memory sort or
    the torch.sort route, bounds sorted in shared memory or by torch.sort
    for 4099 tiles a row) gives pruned_tables' qperm, q_sorted, order and
    lb torch.equal, empty merge keys and, over lanes, the flat rows; K2
    through its wrapper then keeps its contract."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    q, ref, rb, sort_keys = _setup_scene(name, 'cuda')
    monkeypatch.setattr(nk, '_SORT_KEYS', sort_keys)
    lanes = q.dim() == 3
    pref = (nk.build_pruned_ref_lanes if lanes else nk.build_pruned_ref)(
        ref, rb)
    tables, keys, rows = nk.pruned_setup(q, pref, 3.0)
    want = nk.pruned_tables(q, pref, 3.0)
    assert tables[4:] == want[4:]
    for a, b in zip(tables[:4], want[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert bool(torch.all(keys == nk._INIT_KEY))
    if lanes:
        B, Q = q.shape[:2]
        assert torch.equal(rows, (want[0] + Q * torch.arange(
            B, device='cuda')[:, None]).reshape(-1))
        d2, idx = nk.nn_indices_pruned_lanes(q, pref, 3.0)
        for b in range(B):
            _k2_holds(q[b], pref.lane(b), 3.0, d2[b], idx[b])
    else:
        assert rows is None
        _k2_holds(q, pref, 3.0, *nk.nn_indices_pruned(q, pref, 3.0))


@pytest.mark.gpu
@pytest.mark.parametrize('cutoff', [1.0, 3.0])
def test_replayed_k2_walk_skips_tiles_and_reaches_the_exact_nn(cutoff):
    """The plain replay of the Pallas walk (the work K2's bound counts)
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


def _pair_d2(q, ref, idx):
    """f32 d2 of each query to ref[idx], rounded as neighbors.sqdist."""
    d = q - ref[idx.long()]
    return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]


def _k2_holds(q, pref, cutoff, d2, idx):
    """K2's contract against its plain version: within the cutoff d2
    bit-equal and idx a point at that exact d2; beyond it d2 > cutoff^2."""
    pd2 = nk.nn_indices_pruned_plain(q, pref, cutoff)[0]
    inside = pd2 <= cutoff ** 2
    assert torch.equal(d2[inside], pd2[inside])
    assert torch.equal(_pair_d2(q, pref.points, idx)[inside], d2[inside])
    assert bool(torch.all(d2[~inside] > cutoff ** 2))


@pytest.mark.gpu
@pytest.mark.parametrize('n_ref', [7, 3001, 81920])
@pytest.mark.parametrize('n_q', [1, 250, 8192])
def test_kernels_exact_at_awkward_shapes_on_card(n_q, n_ref):
    """K1 equals its plain version exactly (bit-equal d2, equal idx) and
    K2 keeps its contract at one query, a ragged query tile, the main
    path's 8192 queries, and references shorter than a tile, of prime
    length, and of the main path's 81920 points."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    q, ref = scene(8, n_ref, n_q)
    qc, rc = torch.tensor(q, device='cuda'), torch.tensor(ref, device='cuda')
    d2, idx = nk.nn_indices(qc, rc)
    pd2, pidx = nk.nn_indices_plain(qc, rc)
    assert torch.equal(d2, pd2) and torch.equal(idx, pidx)
    pref = nk.build_pruned_ref(rc)
    for cutoff in (1.0, 3.0):
        _k2_holds(qc, pref, cutoff, *nk.nn_indices_pruned(qc, pref, cutoff))


@pytest.mark.gpu
def test_k1_copies_across_reference_tiles_go_to_the_lowest_index_on_card():
    """Exact copies of 64 points in another 4096-point reference tile (and
    another work item): K1 returns the first copy, as the plain version,
    whichever item merges first."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    q, ref = scene(9, 81920, 8192)
    ref[50000:50064] = ref[100:164]
    q[:64] = ref[100:164] + 0.01
    qc, rc = torch.tensor(q, device='cuda'), torch.tensor(ref, device='cuda')
    for _ in range(3):
        d2, idx = nk.nn_indices(qc, rc)
        pd2, pidx = nk.nn_indices_plain(qc, rc)
        assert torch.equal(d2, pd2) and torch.equal(idx, pidx)
        assert torch.equal(idx[:64].cpu(),
                           torch.arange(100, 164, dtype=torch.int32))


@pytest.mark.gpu
def test_kernels_never_pick_a_parked_reference_on_card():
    """A reference with every third row at the SENTINEL: K1 equals its
    plain version and no parked row wins in K1 or K2."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    q, ref = scene(10, 3001, 1000)
    ref[::3] = 1.0e6
    qc, rc = torch.tensor(q, device='cuda'), torch.tensor(ref, device='cuda')
    d2, idx = nk.nn_indices(qc, rc)
    pd2, pidx = nk.nn_indices_plain(qc, rc)
    assert torch.equal(d2, pd2) and torch.equal(idx, pidx)
    assert not bool(torch.any(idx % 3 == 0))
    pref = nk.build_pruned_ref(rc)
    d2, idx = nk.nn_indices_pruned(qc, pref, 3.0)
    _k2_holds(qc, pref, 3.0, d2, idx)
    inside = d2 <= 9.0
    parked = pref.perm.long()[idx.long()] % 3 == 0
    assert not bool(torch.any(parked & inside))


@pytest.mark.gpu
def test_k2_counts_the_points_it_scans_on_card():
    """``_launch_pruned`` with ``scanned``: each query tile scans whole
    tiles, at least one within the cutoff, and the launch gives the same
    results as the wrapper."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    q, ref, _ = sh.make_scene(8192, 81920, seed=11)
    qc, rc = torch.tensor(q, device='cuda'), torch.tensor(ref, device='cuda')
    pref = nk.build_pruned_ref(rc)
    tables = nk.pruned_tables(qc, pref, 3.0)
    qb, rb = tables[4], tables[5]
    scanned = torch.zeros(8192 // qb, dtype=torch.int32, device='cuda')
    before = nk.nn_indices_pruned.launches
    d2, idx = nk._launch_pruned(tables, pref, 3.0, scanned=scanned)
    assert nk.nn_indices_pruned.launches == before + 1
    _k2_holds(qc, pref, 3.0, d2, idx)
    assert bool(torch.all(scanned % rb == 0))
    assert 1 <= int(scanned.min()) and int(scanned.max()) <= 81920


def _lane_scene(seed, lanes, n_q, n_ref):
    """Lanes of queries against their own references, each lane its own
    cloud; lane 0 holds exact copies of 40 points in a later reference
    tile, lane 1 has every third reference row parked."""
    g = np.random.default_rng(seed)
    ref = (g.normal(size=(lanes, n_ref, 3)) * 5).astype(np.float32)
    q = (g.normal(size=(lanes, n_q, 3)) * 5).astype(np.float32)
    if n_ref > 4200 and n_q >= 40:
        ref[0, 4100:4140] = ref[0, 10:50]
        q[0, :40] = ref[0, 10:50] + 0.01
    if lanes > 1:
        ref[1, ::3] = 1.0e6
    return q, ref


@pytest.mark.gpu
@pytest.mark.parametrize('lanes,n_q,n_ref', [(1, 250, 3001), (3, 250, 3001),
                                             (5, 1, 7), (4, 8192, 16384),
                                             (32, 4096, 4096)])
def test_lane_kernels_match_plain_on_card(lanes, n_q, n_ref):
    """K1L equals its plain version exactly and K2L keeps K2's contract
    in every lane, one launch a call, at ragged query tiles, references
    shorter than a tile, copies across tiles (the first copy wins) and
    parked rows (never win); lane b equals single-lane K1 on lane b."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    q, ref = _lane_scene(12, lanes, n_q, n_ref)
    qc, rc = torch.tensor(q, device='cuda'), torch.tensor(ref, device='cuda')
    before = nk.nn_indices_lanes.launches
    d2, idx = nk.nn_indices_lanes(qc, rc)
    assert nk.nn_indices_lanes.launches == before + 1
    pd2, pidx = nk.nn_indices_lanes_plain(qc, rc)
    assert torch.equal(d2, pd2) and torch.equal(idx, pidx)
    for b in range(lanes):
        one = nk.nn_indices(qc[b], rc[b])
        assert torch.equal(d2[b], one[0]) and torch.equal(idx[b], one[1])
    if n_ref > 4200 and n_q >= 40:
        assert torch.equal(idx[0, :40].cpu(),
                           torch.arange(10, 50, dtype=torch.int32))
    if lanes > 1:
        assert not bool(torch.any(idx[1] % 3 == 0))
    pref = nk.build_pruned_ref_lanes(rc)
    for cutoff in (1.0, 3.0):
        before = nk.nn_indices_pruned_lanes.launches
        d2, idx = nk.nn_indices_pruned_lanes(qc, pref, cutoff)
        assert nk.nn_indices_pruned_lanes.launches == before + 1
        for b in range(lanes):
            _k2_holds(qc[b], pref.lane(b), cutoff, d2[b], idx[b])
        if lanes > 1:
            inside = d2[1] <= cutoff ** 2
            parked = pref.perm[1].long()[idx[1].long()] % 3 == 0
            assert not bool(torch.any(parked & inside))


@pytest.mark.gpu
def test_k2l_counts_the_points_it_scans_on_card():
    """K2L's ``scanned`` over every lane's query tiles: whole tiles, at
    least one a query tile, and the same results as the wrapper."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    q, ref = _lane_scene(13, 6, 4096, 16384)
    qc, rc = torch.tensor(q, device='cuda'), torch.tensor(ref, device='cuda')
    pref = nk.build_pruned_ref_lanes(rc)
    tables = nk.pruned_tables_lanes(qc, pref, 3.0)
    qb, rb = tables[4], tables[5]
    scanned = torch.zeros((6, 4096 // qb), dtype=torch.int32, device='cuda')
    d2, idx = nk._launch_pruned(tables, pref, 3.0, scanned=scanned)
    for b in range(6):
        _k2_holds(qc[b], pref.lane(b), 3.0, d2[b], idx[b])
    assert bool(torch.all(scanned % rb == 0))
    assert 1 <= int(scanned.min()) and int(scanned.max()) <= 16384


@pytest.mark.gpu
def test_k2l_skips_far_tiles_on_clustered_lanes_on_card():
    """On lanes of separate clusters K2L scans fewer pairs than all of
    them (a K2L that never skips fails) and keeps K2's contract."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    g = np.random.default_rng(14)
    centres = g.uniform(-40, 40, size=(4, 16, 3))
    ref = (centres[:, :, None] + g.normal(size=(4, 16, 1024, 3))
           ).reshape(4, -1, 3).astype(np.float32)
    q = (centres[:, :4, None] + g.normal(size=(4, 4, 512, 3))
         ).reshape(4, -1, 3).astype(np.float32)
    qc, rc = torch.tensor(q, device='cuda'), torch.tensor(ref, device='cuda')
    pref = nk.build_pruned_ref_lanes(rc)
    tables = nk.pruned_tables_lanes(qc, pref, 3.0)
    qb = tables[4]
    scanned = torch.zeros((4, 2048 // qb), dtype=torch.int32, device='cuda')
    d2, idx = nk._launch_pruned(tables, pref, 3.0, scanned=scanned)
    for b in range(4):
        _k2_holds(qc[b], pref.lane(b), 3.0, d2[b], idx[b])
    assert int(scanned.sum()) * qb < 4 * 2048 * 16384


@pytest.mark.gpu
def test_spans_hold_the_launches_they_issue_on_card():
    """Spans and ``torch.profiler``'s records share one clock: under the
    device-only profiler, the runtime's launch call of every kernel that
    K2 (counters on) issues inside one span, and K2L inside another,
    lies within that span, and the launch issued between them in
    neither.  Launches are told apart by correlation id, in issue
    order."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from laser_slam_tpu_torch.core import benchmarker as bench
    q, ref, _ = sh.make_scene(2048, 16384, seed=15)
    qc, rc = torch.tensor(q, device='cuda'), torch.tensor(ref, device='cuda')
    pref = nk.build_pruned_ref(rc)
    ql, rl = _lane_scene(16, 4, 1024, 4096)
    ql, rl = torch.tensor(ql, device='cuda'), torch.tensor(rl, device='cuda')
    prefl = nk.build_pruned_ref_lanes(rl)
    nk.nn_indices_pruned(qc, pref, 3.0)             # builds the library
    torch.cuda.synchronize()
    bench.take_spans()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with bench.record_spans():
            with bench.span('k2'):
                nk.nn_indices_pruned(qc, pref, 3.0)
            torch.cuda._sleep(1000)                 # one 'spin_kernel'
            with bench.span('k2l'):
                nk.nn_indices_pruned_lanes(ql, prefl, 3.0)
        torch.cuda.synchronize()
    spans = {s.name: s for s in bench.take_spans()}
    counts = bench.take_counters()
    assert counts['nn.k2.pairs'] == 2048 * 16384
    assert counts['nn.k2l.pairs'] == 4 * 1024 * 4096
    events = list(prof.profiler.kineto_results.events())
    device = {e.correlation_id(): e.name() for e in events
              if e.device_type() == DeviceType.CUDA}
    launch = {}
    for e in events:
        if (e.device_type() == DeviceType.CPU and e.name().startswith('cu')
                and e.correlation_id() in device):
            launch[e.correlation_id()] = e.start_ns()
    assert set(launch) == set(device)
    (cut,) = [c for c, name in device.items() if 'spin_kernel' in name]
    first = [launch[c] for c in sorted(launch) if c < cut]
    second = [launch[c] for c in sorted(launch) if c > cut]
    # K2: sort, tables, items, unpack and the counters' fill, sum and add
    # (and the first call's zeroed accumulator); K2L alike.
    assert len(first) >= 7 and len(second) >= 7
    k2, k2l = spans['k2'], spans['k2l']
    assert all(k2.start_ns <= t <= k2.end_ns for t in first)
    assert all(k2l.start_ns <= t <= k2l.end_ns for t in second)
    assert k2.end_ns < launch[cut] < k2l.start_ns


@pytest.mark.gpu
@pytest.mark.parametrize('lanes', [False, True])
def test_scanned_pair_counters_match_the_kernels_count_on_card(lanes,
                                                               monkeypatch):
    """``nn.<kind>.pairs_scanned`` is the query tile times the sum of the
    kernel's own ``scanned`` count of that call, and ``nn.<kind>.pairs``
    is B x Q x R.  Which tiles the kernel scans depends on block timing,
    so the counter and a direct ``_launch_pruned(..., scanned=...)`` on
    the same tables are each held between the replayed Pallas walk's
    pairs and every pair.  With recording off nothing is counted."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from laser_slam_tpu_torch.core import benchmarker as bench
    if lanes:
        q, ref = _lane_scene(13, 6, 4096, 16384)
        qc = torch.tensor(q, device='cuda')
        pref = nk.build_pruned_ref_lanes(torch.tensor(ref, device='cuda'))
        call, tables_of, kind = (nk.nn_indices_pruned_lanes,
                                 nk.pruned_tables_lanes, 'k2l')
        B, Q, R = 6, 4096, 16384
    else:
        q, ref, _ = sh.make_scene(8192, 81920, seed=11)
        qc = torch.tensor(q, device='cuda')
        pref = nk.build_pruned_ref(torch.tensor(ref, device='cuda'))
        call, tables_of, kind = (nk.nn_indices_pruned, nk.pruned_tables,
                                 'k2')
        B, Q, R = 1, 8192, 81920
    seen = []
    launch = nk._launch_pruned

    def spy(tables, *args, scanned=None, **kw):
        out = launch(tables, *args, scanned=scanned, **kw)
        seen.append((tables[4], scanned))
        return out

    monkeypatch.setattr(nk, '_launch_pruned', spy)
    bench.take_counters()
    call(qc, pref, 3.0)
    assert bench.take_counters() == {} and seen[-1][1] is None
    with bench.record_spans():
        d2, idx = call(qc, pref, 3.0)
    counts = bench.take_counters()
    qb, scanned = seen[-1]
    assert counts[f'nn.{kind}.pairs'] == B * Q * R
    assert counts[f'nn.{kind}.pairs_scanned'] == qb * int(scanned.sum())
    for b in range(B):
        if lanes:
            _k2_holds(qc[b], pref.lane(b), 3.0, d2[b], idx[b])
        else:
            _k2_holds(qc, pref, 3.0, d2, idx)
    tables = tables_of(qc, pref, 3.0)
    direct = torch.zeros(tables[2].shape[:-1], dtype=torch.int32,
                         device='cuda')
    launch(tables, pref, 3.0, scanned=direct)
    rb = tables[5]
    walk = sum(int(nk.pruned_visits(qc[b], pref.lane(b), 3.0)[0].sum())
               for b in range(B)) if lanes else int(
                   nk.pruned_visits(qc, pref, 3.0)[0].sum())
    for pairs in (counts[f'nn.{kind}.pairs_scanned'],
                  qb * int(direct.sum())):
        assert qb * rb * walk <= pairs <= B * Q * R


@pytest.mark.gpu
def test_fleet_runs_the_lane_kernels_on_card():
    """A small fleet on the card with 'pallas' under both prune values:
    K2L or K1L launches once an ICP iteration, never K1/K2, and the poses
    agree with the same fleet on the CPU (plain versions) within 1e-4;
    the map query launches K1L once."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from laser_slam_tpu_torch.config import IcpConfig
    from laser_slam_tpu_torch.ops import cloud as pc
    from laser_slam_tpu_torch.parallel import fleet
    g = np.random.default_rng(14)
    lanes, steps, n = 4, 3, 1024
    base = (g.normal(size=(n, 3)) * [10, 10, 2]).astype(np.float32)
    pts = np.stack([np.stack([base + [0.2 * t, 0.1 * b, 0] + g.normal(
        size=(n, 3)).astype(np.float32) * 0.01 for t in range(steps)])
        for b in range(lanes)]).astype(np.float32)
    cpu = dict(points=torch.tensor(pts),
               masks=torch.ones((lanes, steps, n), dtype=torch.bool))
    cpu['normals'] = torch.stack([torch.stack([
        pc.estimate_normals(pc.Cloud(cpu['points'][b, t],
                                     cpu['masks'][b, t]), knn=8)
        for t in range(steps)]) for b in range(lanes)])
    cpu['init_pose'] = torch.tensor([1.0, 0, 0, 0, 0, 0, 0]).expand(
        lanes, 7).contiguous()
    odom = np.zeros((lanes, steps, 7), np.float32)
    odom[..., 0] = 1.0
    odom[:, 1:, 4] = 0.2
    cpu['odom_rel'] = torch.tensor(odom)
    card = {k: v.cuda() for k, v in cpu.items()}
    for prune, counter in ((True, nk.nn_indices_pruned_lanes),
                           (False, nk.nn_indices_lanes)):
        cfg = IcpConfig(matcher='pallas', pallas_prune=prune,
                        reading_capacity=n, reading_sampling_ratio=1.0,
                        max_iterations=10)
        singles = (nk.nn_indices.launches, nk.nn_indices_pruned.launches)
        before = counter.launches
        got = fleet.fleet_icp_odometry(**card, config=cfg)
        assert counter.launches - before == 10 * (steps - 1)
        assert (nk.nn_indices.launches,
                nk.nn_indices_pruned.launches) == singles
        want = fleet.fleet_icp_odometry(**cpu, config=cfg)
        np.testing.assert_allclose(got.poses.cpu().numpy(),
                                   want.poses.numpy(), atol=1e-4)
    maps = fleet.init_fleet_maps(lanes, 2 * n)
    maps = fleet.fleet_accumulate(maps, card['points'][:, 0],
                                  card['masks'][:, 0], card['init_pose'])
    before = nk.nn_indices_lanes.launches
    idx, d2 = fleet.fleet_map_query(maps, card['points'][:, 1])
    assert nk.nn_indices_lanes.launches == before + 1
    pd2, pidx = nk.nn_indices_lanes_plain(card['points'][:, 1], maps.points)
    assert torch.equal(d2, pd2) and torch.equal(idx, pidx)


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


def _ties_across_tiles():
    """The shootout's scene with reference rows 2048-2111 exact copies of
    rows 0-63 in the next 2048-wide tile, with other normals, and the first
    64 queries beside the copies."""
    q, ref, pay = sh.make_scene(8192, 65536, seed=3)
    ref[2048:2112] = ref[:64]
    pay[2048:2112] = np.concatenate([ref[:64], -pay[:64, 3:]], axis=1)
    q[:64] = ref[:64] + np.float32(0.01)
    return tuple(torch.tensor(a, device='cuda') for a in (q, ref, pay))


@pytest.mark.gpu
def test_e4_e5_items_and_one_launch_a_call_on_card():
    """E5 and E4 at the shootout's 8192 x 65536: at least 256 work items a
    launch, one launch counted a call in their own counters, results held
    to the plain versions; the two passes run again on the same tables (the
    epilogue leaves the keys empty) give the same results."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    q, ref, pay = (torch.tensor(a, device='cuda')
                   for a in sh.make_scene(8192, 65536, seed=3))
    assert nv.mm_items(8192, 65536) >= 256
    nv.reset_launches()
    d2, idx = nv.nn_indices_mm(q, ref)
    pd2, out = nv.nn_payload(q, ref, pay)
    assert (nv.nn_indices_mm.launches, nv.nn_payload.launches,
            nv.nn_indices_mm.launches_bf16,
            nv.nn_payload_pruned.launches) == (1, 1, 0, 0)
    nv.check_mm_indices(q, ref, d2, idx, *nv.nn_indices_mm_plain(q, ref))
    nv.check_payload(q, ref, pay, pd2, out,
                     *nv.nn_payload_plain(q, ref, pay))
    tab = nv.mm_setup(q, ref)
    for _ in range(2):
        assert torch.equal(nv._launch_mm_indices(q, tab)[1], idx)
        again = nv._launch_payload(q, tab, pay)
        assert torch.equal(again[0], pd2) and torch.equal(again[1], out)
    assert torch.equal(nv._launch_mm_indices(q, tab)[0], d2)
    assert (nv.nn_indices_mm.launches, nv.nn_payload.launches) == (4, 3)


@pytest.mark.gpu
@pytest.mark.parametrize('n_q,n_ref', [(1, 7), (1000, 3000), (1000, 3001),
                                       (777, 65537), (8192, 2048)])
def test_e4_e5_awkward_shapes_on_card(n_q, n_ref):
    """One query, Q % 512 != 0, R = 3000 (1500-row E4 tiles that straddle
    the 2048-row spans), R prime (3001 and 65537: one-row E4 tiles, a
    ragged last span), one span; every third reference row parked."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    q, ref, pay = sh.make_scene(n_q, n_ref, seed=6)
    ref[::3] = 1.0e6
    pay[:, :3] = ref
    q, ref, pay = (torch.tensor(a, device='cuda') for a in (q, ref, pay))
    d2, idx = nv.nn_indices_mm(q, ref)
    nv.check_mm_indices(q, ref, d2, idx, *nv.nn_indices_mm_plain(q, ref))
    assert not bool(torch.any(idx % 3 == 0))
    nv.check_payload(q, ref, pay, *nv.nn_payload(q, ref, pay),
                     *nv.nn_payload_plain(q, ref, pay))


@pytest.mark.gpu
def test_e4_e5_ties_across_tiles_on_card():
    """Copies of 64 reference rows in the next 2048-wide tile: E5 returns
    the first copy's index and E4 the first tile's payload alone, as the
    plain versions, whichever item merges first."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    q, ref, pay = _ties_across_tiles()
    want_i = nv.nn_indices_mm_plain(q, ref)
    want_p = nv.nn_payload_plain(q, ref, pay)
    for _ in range(3):
        d2, idx = nv.nn_indices_mm(q, ref)
        nv.check_mm_indices(q, ref, d2, idx, *want_i)
        assert torch.equal(idx[:64].cpu(), torch.arange(64, dtype=torch.int32))
        d2, out = nv.nn_payload(q, ref, pay)
        c = nv.check_payload(q, ref, pay, d2, out, *want_p)
        assert c['duplicates'] >= 64
        assert torch.equal(out[:64], pay[:64])


@pytest.mark.gpu
def test_e1_bf16_setup_items_and_second_scoring_on_card():
    """E1 at the shootout's 8192 x 65536: its set-up bit-equal to the plain
    set-up's bf16 rows, at least 256 work items, one launch counted a
    call, no query whose winning tile fails to score again to its key
    (index -1), the two passes run again on one table equal, and no copy
    in the next tile winning."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    q, ref, _ = _ties_across_tiles()
    assert nv.mm_bf16_items(8192, 65536) >= 256
    tab = nv.mm_bf16_setup(q, ref)
    assert torch.equal(tab.rows, nv.mm_bf16_rows_plain(ref))
    nv.reset_launches()
    d2, idx = nv.nn_indices_mm(q, ref, 'bf16')
    assert (nv.nn_indices_mm.launches_bf16,
            nv.nn_indices_mm.launches) == (1, 0)
    assert not bool(torch.any(idx < 0))
    nv.check_mm_indices(q, ref, d2, idx,
                        *nv.nn_indices_mm_plain(q, ref, 'bf16'),
                        precision='bf16')
    # The copies tie exactly: the one in the next tile never wins (bf16's
    # rank errors send some of the 64 queries to other rows).
    assert not bool(torch.any((idx >= 2048) & (idx < 2112)))
    assert int(torch.sum(idx[:64].cpu() == torch.arange(64))) >= 1
    for _ in range(2):
        again = nv._launch_mm_indices_bf16(q, tab)
        assert torch.equal(again[0], d2) and torch.equal(again[1], idx)
    assert nv.nn_indices_mm.launches_bf16 == 3


@pytest.mark.gpu
@pytest.mark.parametrize('n_q,n_ref', [(1, 7), (1000, 3000), (1000, 3001),
                                       (777, 65537), (8192, 2048)])
def test_e1_bf16_awkward_shapes_on_card(n_q, n_ref):
    """One query against 7 rows (one ragged 8-row step), Q % 256 != 0,
    ragged key tiles and spans, one span; every third reference row
    parked at 1e6 (|r|^2 = 3e12, finite in bf16)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    q, ref, _ = sh.make_scene(n_q, n_ref, seed=6)
    ref[::3] = 1.0e6
    q, ref = (torch.tensor(a, device='cuda') for a in (q, ref))
    assert torch.equal(nv.mm_bf16_setup(q, ref).rows,
                       nv.mm_bf16_rows_plain(ref))
    d2, idx = nv.nn_indices_mm(q, ref, 'bf16')
    assert not bool(torch.any(idx < 0))
    nv.check_mm_indices(q, ref, d2, idx,
                        *nv.nn_indices_mm_plain(q, ref, 'bf16'),
                        precision='bf16')
    assert not bool(torch.any(idx % 3 == 0))


@pytest.mark.gpu
def test_e4_e5_planted_d2_is_rejected_on_card():
    """A kernel result whose d2 were a tenth too large fails the checks."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    q, ref, pay = (torch.tensor(a, device='cuda')
                   for a in sh.make_scene(8192, 65536, seed=3))
    d2, idx = nv.nn_indices_mm(q, ref)
    with pytest.raises(AssertionError, match='d2 beyond'):
        nv.check_mm_indices(q, ref, 1.1 * d2, idx,
                            *nv.nn_indices_mm_plain(q, ref))
    d2, out = nv.nn_payload(q, ref, pay)
    with pytest.raises(AssertionError, match='d2 beyond'):
        nv.check_payload(q, ref, pay, 1.1 * d2, out,
                         *nv.nn_payload_plain(q, ref, pay))


def test_editing_a_shared_header_renames_both_libraries(tmp_path,
                                                        monkeypatch):
    """``cuda_build`` hashes every csrc header into each library's name,
    so an edited ``nn_common.cuh`` cannot load a stale library."""
    for name in os.listdir(cuda_build.CSRC_DIR):
        shutil.copy(os.path.join(cuda_build.CSRC_DIR, name), tmp_path)
    monkeypatch.setattr(cuda_build, 'CSRC_DIR', str(tmp_path))
    before = [cuda_build._library_path(s)[1]
              for s in ('nn.cu', 'nn_variants.cu')]
    assert before == [cuda_build._library_path(s)[1]
                      for s in ('nn.cu', 'nn_variants.cu')]
    with open(tmp_path / 'nn_common.cuh', 'a') as f:
        f.write('// edited\n')
    after = [cuda_build._library_path(s)[1]
             for s in ('nn.cu', 'nn_variants.cu')]
    assert all(a != b for a, b in zip(before, after))


def _exact_tiled_holds(q, ref, d2, idx, want):
    """E2/E3 against K1's plain version: d2 bit-equal, indices equal
    except at an exact f32 tie."""
    assert torch.equal(d2, want[0])
    nv.check_exact_indices(q, ref, d2, idx, *want)


@pytest.mark.gpu
@pytest.mark.parametrize('qb,rb', [(256, 2048)] + list(sh.SWEEP[:-1]))
def test_e3_sweep_shapes_bit_equal_on_card(qb, rb):
    """Every E3 sweep shape (and E2's 256 x 2048) at the shootout's 8192 x
    65536, with at least 256 work items, and at 1000 x 3001 (Q % qb != 0,
    ragged reference tiles) with every third reference row parked."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    q, ref, _ = (torch.tensor(a, device='cuda')
                 for a in sh.make_scene(8192, 65536, seed=3))
    assert nv.tiled_items(8192, 65536, qb, rb) >= 256
    before = nv.nn_indices_tiled.launches
    _exact_tiled_holds(q, ref, *nv.nn_indices_tiled(q, ref, qb, rb),
                       nk.nn_indices_plain(q, ref))
    assert nv.nn_indices_tiled.launches == before + 1
    q2, ref2, _ = sh.make_scene(1000, 3001, seed=6)
    ref2[::3] = 1.0e6
    q2, ref2 = torch.tensor(q2, device='cuda'), torch.tensor(ref2,
                                                            device='cuda')
    d2, idx = nv.nn_indices_tiled(q2, ref2, qb, rb)
    _exact_tiled_holds(q2, ref2, d2, idx, nk.nn_indices_plain(q2, ref2))
    assert not bool(torch.any(idx % 3 == 0))


def _tie_scene():
    """Two copies of a point straddle the boundary of E6's two 1024-wide
    sorted reference tiles, with different payloads; every other query
    lies next to them (test_torch_nn_variants' tie scene)."""
    g = np.random.default_rng(11)
    ref = g.uniform(-50, 50, (2047, 3)).astype(np.float32)
    p = ref[nv.morton_order(torch.tensor(ref)).numpy()[1023]]
    ref = np.concatenate([ref, p[None]])
    pay = np.concatenate([ref, g.standard_normal((2048, 3))], 1)
    pay = pay.astype(np.float32)
    q = g.uniform(-50, 50, (512, 3)).astype(np.float32)
    q[::2] = p + g.normal(0, 0.01, (256, 3)).astype(np.float32)
    return q, ref, pay


@pytest.mark.gpu
def test_e6_ties_across_tiles_follow_the_visit_order_on_card():
    """Query tile 0 visits reference tile 0 first and query tile 1 tile 1
    first: the kernel's merge keys pick the same copy as the plain E6,
    whichever item merges first."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    q, ref, pay = (torch.tensor(a, device='cuda') for a in _tie_scene())
    want = nv.nn_payload_pruned_plain(q, ref, pay)
    for _ in range(3):
        d2, out = nv.nn_payload_pruned(q, ref, pay)
        c = nv.check_payload(q, ref, pay, d2, out, *want)
        assert c['duplicates'] == 256
        assert torch.equal(out[::2], want[1][::2])
    copies = {tuple(row) for row in out[::2, 3:].cpu().numpy().tolist()}
    assert len(copies) == 2          # both copies win somewhere


@pytest.mark.gpu
def test_e6_counts_one_launch_and_scans_at_most_every_tile_on_card():
    """One launch counted a call in E6's own counter; each query tile scans
    between 1 and nj reference tiles; a second run of the kernel on the
    same tables (the epilogue empties the keys) gives the same result."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    q, ref, pay = (torch.tensor(a, device='cuda')
                   for a in sh.make_scene(8192, 65536, seed=3))
    nv.reset_launches()
    d2, out, visits = nv.nn_payload_pruned(q, ref, pay, return_visits=True)
    assert (nv.nn_payload_pruned.launches, nv.nn_payload.launches,
            nv.nn_indices_mm.launches) == (1, 0, 0)
    assert visits.shape == (32,)
    assert 1 <= int(visits.min()) and int(visits.max()) <= 64
    nv.check_payload(q, ref, pay, d2, out,
                     *nv.nn_payload_pruned_plain(q, ref, pay))
    tab = nv.pruned_setup(q, ref)
    first = nv._launch_pruned(tab, pay)
    again = nv._launch_pruned(tab, pay)
    assert nv.nn_payload_pruned.launches == 3
    assert torch.equal(first[0], again[0]) and torch.equal(first[1],
                                                           again[1])
    assert torch.equal(first[0], d2)


@pytest.mark.gpu
def test_e6_cloud_beyond_the_cluster_sort_on_card():
    """A reference of more than 16 x 8192 points is sorted by torch.sort
    instead of the set-up kernel's cluster; the result still passes the
    payload check against the plain E6."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    q, ref, pay = (torch.tensor(a, device='cuda')
                   for a in sh.make_scene(1024, 139264, seed=12))
    assert nv._sort_block(ref.shape[0]) > nv._E6_SORT_BLOCK
    d2, out = nv.nn_payload_pruned(q, ref, pay)
    nv.check_payload(q, ref, pay, d2, out,
                     *nv.nn_payload_pruned_plain(q, ref, pay))


@pytest.mark.gpu
def test_host_api_runs_k2_and_resumes_from_a_checkpoint_on_card(tmp_path):
    """A few scans through LaserSlamWorker on the card: every scan's ICP
    and the refined closure launch K2 (K1 never); a checkpoint saved
    after scan 4 reads back bit-equal, and the resumed run stays within
    1 cm / 0.1 degree of the uninterrupted one (float index_add_ is
    atomic on the card, so not bit-equal)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from laser_slam_tpu_torch.config import (Config, WorkerConfig,
                                             slice1_config)
    from laser_slam_tpu_torch.core import checkpoint as ck
    from laser_slam_tpu_torch.core.estimator import IncrementalEstimator
    from laser_slam_tpu_torch.core.types import RelativePose
    from laser_slam_tpu_torch.pipeline import replay
    from laser_slam_tpu_torch.pipeline.worker import LaserSlamWorker
    cfg = Config(estimator=slice1_config(scan_capacity=4096,
                                         reading_capacity=2048),
                 worker=WorkerConfig(minimum_distance_to_add_pose=0.0,
                                     local_map_capacity=1 << 16))
    fs = list(replay.SyntheticStream(n_scans=8, points_per_scan=4096,
                                     trajectory='line', step_m=0.5, seed=7))
    est = IncrementalEstimator(cfg.estimator, 1)
    w = LaserSlamWorker(cfg.worker, est)
    nk.nn_indices.launches = nk.nn_indices_pruned.launches = 0
    assert replay.run_worker_on_stream(w, fs[:4]) == 4
    k2_scans = nk.nn_indices_pruned.launches
    assert k2_scans > 0
    path = os.path.join(tmp_path, 'state.npz')
    ck.save_checkpoint(path, est, [w])
    est2, (w2,) = ck.load_checkpoint(path, cfg)
    assert est2.device.type == 'cuda'
    np.testing.assert_array_equal(est2.pose_values(), est.pose_values())
    for a, b in zip(est.laser_tracks[0].scans, est2.laser_tracks[0].scans):
        assert torch.equal(a.cloud.points, b.cloud.points)
        assert torch.equal(a.normals, b.normals)
    assert torch.equal(est.laser_tracks[0]._ring_points,
                       est2.laser_tracks[0]._ring_points)
    for worker in (w, w2):
        replay.run_worker_on_stream(worker, fs[4:])
    a = np.stack(list(w.get_trajectory().values()))
    b = np.stack(list(w2.get_trajectory().values()))
    assert np.abs(a[:, 4:] - b[:, 4:]).max() < 0.01
    assert np.abs(a[:, :4] - b[:, :4]).max() < np.radians(0.1) / 2
    before = nk.nn_indices_pruned.launches
    est.process_loop_closure(RelativePose(
        T_a_b=np.asarray([1, 0, 0, 0, 0, 0, 0], np.float32),
        time_a_ns=fs[0].time_ns, time_b_ns=fs[-1].time_ns))
    assert nk.nn_indices_pruned.launches > before
    assert nk.nn_indices.launches == 0
    assert np.all(np.isfinite(est.pose_values()))


@pytest.mark.gpu
def test_kitti_replay_runs_k2_on_card(tmp_path):
    """The KITTI example on a small KITTI-layout sequence with
    ``--matcher pallas``: every scan's ICP launches K2 on the card, and the
    trajectory ends within 1e-4 m of the same run on the CPU (both
    exact; the card's float index_add_ may round otherwise)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from laser_slam_tpu_torch.examples import kitti_replay
    from laser_slam_tpu_torch.pipeline import replay
    seq = tmp_path / 'sequences' / '00'
    os.makedirs(seq / 'velodyne')
    os.makedirs(tmp_path / 'poses')
    frames = list(replay.SyntheticStream(
        n_scans=6, points_per_scan=4096, trajectory='line', step_m=1.2,
        noise_m=0.01, seed=17))
    rows = []
    for i, f in enumerate(frames):
        np.concatenate([f.points, np.zeros((len(f.points), 1), np.float32)],
                       1).tofile(seq / 'velodyne' / f'{i:06d}.bin')
        w, x, y, z = f.gt_pose7[:4].astype(np.float64)
        R = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
              2 * (x * z + w * y)],
             [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
              2 * (y * z - w * x)],
             [2 * (x * z - w * y), 2 * (y * z + w * x),
              1 - 2 * (x * x + y * y)]]
        rows.append(np.concatenate([R, f.gt_pose7[4:, None]], 1).ravel())
    np.savetxt(tmp_path / 'poses' / '00.txt', np.asarray(rows), fmt='%.9f')
    flags = ['--root', str(tmp_path), '--sequence', '00', '--matcher',
             'pallas', '--window', '0', '--scan-capacity', '4096',
             '--reading-capacity', '2048', '--reading-sampling', '1.0']
    nk.nn_indices.launches = nk.nn_indices_pruned.launches = 0
    card = kitti_replay.main(flags)
    assert card['runner'].device.type == 'cuda'
    assert nk.nn_indices_pruned.launches >= 40 * (card['n'] - 1)
    assert nk.nn_indices.launches == 0
    cpu = kitti_replay.main(flags + ['--cpu'])
    a = np.stack([card['traj'][t] for t in sorted(cpu['traj'])])
    b = np.stack([cpu['traj'][t] for t in sorted(cpu['traj'])])
    assert np.abs(a[:, 4:] - b[:, 4:]).max() < 1e-4
    assert card['ate'].translation.mean < 0.3


@pytest.mark.gpu
def test_nn_kernel_utilization_on_card():
    """``profiling.nn_kernel_utilization`` on the card at 2048 x 20480:
    the brute and K1 keys, K1 launched, its time no less than the bound
    that ``CardPeaks`` gives (fraction in (0, 1.05]) and its rates
    consistent with that time."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from laser_slam_tpu_torch.pipeline import profiling
    q, r = scene(11, 20480, 2048, scale=10.0)
    nk.nn_indices.launches = 0
    out = profiling.nn_kernel_utilization(q, r, reps=5)
    assert nk.nn_indices.launches > 0
    assert sorted(out) == sorted([
        'nn_brute_ms', 'nn_brute_point_comparisons_per_sec',
        'nn_brute_fraction_of_bound', 'k1_ms', 'k1_bound_ms', 'k1_bound_by',
        'k1_fraction_of_bound', 'k1_achieved_hbm_gbps',
        'k1_point_comparisons_per_sec'])
    peaks = profiling.card_peaks()
    bound = peaks.bound(2048 * 20480, profiling.INSTR_EXACT,
                        profiling.nn_bytes(2048, 20480))
    assert (out['k1_bound_ms'], out['k1_bound_by']) == bound
    assert 0 < out['k1_fraction_of_bound'] <= 1.05
    assert out['k1_point_comparisons_per_sec'] == pytest.approx(
        2048 * 20480 / (out['k1_ms'] * 1e-3))
    assert out['k1_achieved_hbm_gbps'] == pytest.approx(
        profiling.nn_bytes(2048, 20480) / (out['k1_ms'] * 1e-3) / 1e9)
