"""The yardstick's arithmetic against hand-counted cases."""

import pytest
import torch

from benchmark import yardstick as ys


def test_bound_is_the_larger_of_operations_and_bytes():
    peaks = ys.CardPeaks()
    issue = 132 * 128 * 1.98e9
    ms, by = peaks.bound(1e9, 11, 1000)
    assert by == 'operations'
    assert ms == pytest.approx(1e3 * 11e9 / issue)
    ms, by = peaks.bound(10, 11, 3.35e9)
    assert by == 'bytes'
    assert ms == pytest.approx(1.0)


def test_nn_bytes_counts_each_row_once():
    # 2 queries and 3 references of 3 floats read, 2 (d2, idx) written.
    assert ys.nn_bytes(2, 3) == 4 * (6 + 9 + 4)


def test_busy_merges_overlaps():
    assert ys.busy_ns([(0, 10), (5, 15), (20, 25), (21, 22)]) == 20
    assert ys.busy_ns([]) == 0


def _cluster(center, n, spread=0.1, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.tensor(center) + spread * torch.rand((n, 3), generator=g)


def test_walk_visits_only_tiles_within_the_cutoff():
    # Lane reference of 2048 points: two Morton-sorted tiles of 1024, one
    # at the origin and one 50 m away on each axis.  512 queries at the
    # origin: two query tiles, each visits the near tile and stops at the
    # far one's bound (past cutoff^2).
    ref = torch.cat([_cluster([0.0, 0.0, 0.0], 1024),
                     _cluster([50.0, 50.0, 50.0], 1024, seed=1)])[None]
    q = _cluster([0.05, 0.05, 0.05], 512, seed=2)[None]
    visits = ys.walk_visits(q, ref, 3.0, per_lane=True)
    assert visits.tolist() == [[1, 1]]
    assert ys.walk_pairs(q, ref, 3.0, per_lane=True) == 2 * 256 * 1024


def test_walk_skips_a_tile_beyond_every_query_best():
    # The second tile's box lies within the cutoff (bound 2.43 m^2), but
    # every query already has a neighbour of the first tile within 0.2 m:
    # skipped.
    ref = torch.cat([_cluster([0.0, 0.0, 0.0], 1024),
                     _cluster([1.0, 1.0, 1.0], 1024, seed=1)])[None]
    q = _cluster([0.0, 0.0, 0.0], 256, seed=2)[None]
    assert ys.walk_visits(q, ref, 3.0, per_lane=True).tolist() == [[1]]
    # Queries halfway between the boxes: the second bound (0.6075 m^2)
    # is below the best the first tile gives, so both are scanned.
    q_far = _cluster([0.55, 0.55, 0.55], 256, spread=0.0, seed=2)[None]
    assert ys.walk_visits(q_far, ref, 3.0, per_lane=True).tolist() == [[2]]


def test_call_bound_of_the_walk():
    ref = torch.cat([_cluster([0.0, 0.0, 0.0], 1024),
                     _cluster([50.0, 50.0, 50.0], 1024, seed=1)])[None]
    q = _cluster([0.05, 0.05, 0.05], 512, seed=2)[None]
    want = ys.PEAKS.bound(2 * 256 * 1024, 11, ys.nn_bytes(512, 2048))[0]
    assert ys.nn_call_bound_ms(q, ref, 3.0, True) == pytest.approx(want)


def test_shared_reference_tiles_are_4096_points():
    assert ys.ref_tile(65536, per_lane=False) == 4096
    assert ys.ref_tile(4096, per_lane=True) == 1024
    assert ys.ref_tile(3000, per_lane=True) == 3000


def test_k2_groups_span_set_up_to_unpack():
    recs = [('elementwise', 0, 1),
            ('k2_codes_kernel(float const*)', 2, 1),
            ('cub::DeviceRadixSortOnesweepKernel', 4, 3),
            ('k2_tables_kernel', 8, 1),
            ('void nn_items_kernel<true, 8>(float const*)', 10, 50),
            ('nn_unpack_kernel', 61, 1),
            ('reduce_kernel', 63, 2),
            ('k2_sort_kernel', 70, 5),
            ('k2_tables_kernel', 76, 1),
            ('void nn_items_kernel<true, 8>(float const*)', 78, 20),
            ('nn_unpack_kernel', 99, 1)]
    groups = ys.k2_groups(recs[::-1])
    assert [len(g) for g in groups] == [5, 4]
    assert groups[0][0][0].startswith('k2_codes')
    assert groups[1][-1] == ('nn_unpack_kernel', 99, 1)
