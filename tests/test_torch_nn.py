"""The port's exact-NN module against the JAX Pallas kernels (interpret
mode), on the test_pallas_nn.py inputs.

On the CPU the wrappers run their plain torch versions.  What the CUDA
kernels add is their schedule: one work item per (query tile, reference
tile), merged exactly through packed (d2, idx) keys, and K2's skip rule
against the bests merged so far.  That schedule is checked here through
a torch model (``schedule_model``), which must reproduce the Pallas
kernels' answers in any item order.  ``kernel_model`` models the Pallas
walk itself, whose scanned tiles set K2's bound.  The kernels are
compared with their plain versions on the card in
test_torch_kernels.py.

Tolerances: indices equal, except where float64 shows an exact f32 tie;
d2 within 1e-6 relative (both compute (q-r)^2 coordinate-wise in f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_slam_tpu.ops import cloud as jpc
from laser_slam_tpu.ops import pallas_nn
from laser_slam_tpu_torch.ops import nn_kernels as nk
from laser_slam_tpu_torch.ops.neighbors import sqdist

torch.set_num_threads(2)


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


def random_scene(rng, n_ref, n_q):
    ref = rng.normal(size=(n_ref, 3)).astype(np.float32) * 5
    q = rng.normal(size=(n_q, 3)).astype(np.float32) * 5
    return q, ref


def clustered_scene(rng):
    clusters = rng.uniform(-40, 40, size=(16, 3)).astype(np.float32)
    ref = (clusters[:, None, :] + rng.normal(size=(16, 256, 3)).astype(
        np.float32)).reshape(-1, 3)
    q = (clusters[:4, None, :] + rng.normal(size=(4, 128, 3)).astype(
        np.float32)).reshape(-1, 3)
    return q, ref


def parked_scene(rng):
    ref_valid = rng.normal(size=(100, 3)).astype(np.float32)
    ref = np.asarray(jpc.make_cloud(ref_valid, capacity=128).points)
    q = np.concatenate([ref_valid[:64] + 0.01,
                        np.full((64, 3), jpc.SENTINEL, np.float32)])
    return q, ref


@pytest.mark.parametrize('shape', [(512, 4096), (192, 1536), (250, 3001)])
def test_nn_indices_plain_matches_pallas(rng, shape):
    q, ref = random_scene(rng, shape[1], shape[0])
    jd2, jidx = pallas_nn.nn_indices(jnp.asarray(q), jnp.asarray(ref),
                                     interpret=True)
    before = nk.nn_indices.launches
    td2, tidx = nk.nn_indices(torch.tensor(q), torch.tensor(ref))
    assert nk.nn_indices.launches == before      # CPU: plain, no launch
    assert tidx.dtype == torch.int32 and td2.dtype == torch.float32
    assert_same_nn(q, ref, td2.numpy(), tidx.numpy(), jd2, jidx)


def test_nn_indices_ignores_parked_ref(rng):
    q, ref = parked_scene(rng)
    d2, idx = nk.nn_indices(torch.tensor(q[:64]), torch.tensor(ref))
    assert torch.all(idx < 100) and torch.all(d2 < 1.0)


@pytest.mark.parametrize('scene,rb', [('random', None), ('clustered', 256),
                                      ('parked', None)])
def test_build_pruned_ref_matches_jax(rng, scene, rb):
    q, ref = {'random': lambda: random_scene(rng, 4096, 512),
              'clustered': lambda: clustered_scene(rng),
              'parked': lambda: parked_scene(rng)}[scene]()
    jp = pallas_nn.build_pruned_ref(jnp.asarray(ref), rb=rb)
    tp = nk.build_pruned_ref(torch.tensor(ref), rb=rb)
    np.testing.assert_array_equal(tp.perm.numpy(), np.asarray(jp.perm))
    np.testing.assert_array_equal(tp.points.numpy(), np.asarray(jp.points))
    np.testing.assert_array_equal(tp.tile_lo.numpy(), np.asarray(jp.tile_lo))
    np.testing.assert_array_equal(tp.tile_hi.numpy(), np.asarray(jp.tile_hi))


def jax_tables(q, jpref, cutoff):
    """The tables of pallas_nn.nn_indices_pruned (pallas_nn.py:313-340),
    computed with the JAX package's own helpers."""
    Q, R = q.shape[0], jpref.points.shape[0]
    qb = pallas_nn._tile(Q, pallas_nn._QB)
    rb = R // jpref.tile_lo.shape[0]
    nR = R // rb
    lo, hi = pallas_nn._finite_bounds(jpref.points)
    inv = 1.0 / jnp.maximum(hi - lo, 1e-6)
    qperm = jnp.argsort(pallas_nn._morton3d(jnp.asarray(q), lo, inv))
    q_lo, q_hi = pallas_nn._tile_aabbs(jnp.asarray(q)[qperm], qb)
    gap = jnp.maximum(jnp.maximum(jpref.tile_lo[None] - q_hi[:, None],
                                  q_lo[:, None] - jpref.tile_hi[None]), 0.0)
    lb2 = jnp.sum(gap * gap, axis=-1)
    order = jnp.argsort(lb2, axis=1).astype(jnp.int32)
    lb_sorted = jnp.take_along_axis(lb2, order, axis=1)
    keep = lb_sorted <= cutoff ** 2
    cnt = jnp.sum(keep, axis=1)
    jidx = jnp.minimum(jnp.arange(nR, dtype=jnp.int32)[None, :],
                       jnp.maximum(cnt - 1, 0)[:, None])
    order_aliased = jnp.take_along_axis(order, jidx, axis=1)
    lb_eff = jnp.where(keep, lb_sorted, jnp.inf)
    return (np.asarray(qperm), np.asarray(order_aliased),
            np.asarray(lb_eff), qb, rb)


def kernel_model(q_sorted, ref_sorted, order, lb, qb, rb, cutoff2):
    """Torch model of the Pallas ``_nn_pruned_kernel`` walk, the fixed
    walk that K2's bound counts (``nn_kernels.pruned_visits``): per query
    tile, walk the tiles of its row in order; stop at the first bound >=
    cutoff2, skip a tile whose bound is >= the tile's largest running
    best; strict '<' keeps the first (lowest index, earliest visited)
    minimum."""
    Q = q_sorted.shape[0]
    d2 = torch.full((Q,), float('inf'))
    idx = torch.zeros(Q, dtype=torch.int32)
    for b in range(order.shape[0]):
        rows = slice(b * qb, (b + 1) * qb)
        best, best_i = d2[rows].clone(), idx[rows].clone()
        for j in range(order.shape[1]):
            bound = float(lb[b, j])
            if not bound < cutoff2:
                break
            if not bound < float(best.max()):
                continue
            t = int(order[b, j])
            m, a = torch.min(sqdist(q_sorted[rows],
                                    ref_sorted[t * rb:(t + 1) * rb]), dim=1)
            take = m < best
            best = torch.where(take, m, best)
            best_i = torch.where(take, a.to(torch.int32) + t * rb, best_i)
        d2[rows], idx[rows] = best, best_i
    return d2, idx


@pytest.mark.parametrize('scene,rb,cutoff', [('random', None, 1.0),
                                             ('random', 512, 1.0),
                                             ('clustered', 256, 3.0),
                                             ('parked', None, 3.0)])
def test_pruned_tables_and_visit_rule_match_pallas(rng, scene, rb, cutoff):
    q, ref = {'random': lambda: random_scene(rng, 4096, 512),
              'clustered': lambda: clustered_scene(rng),
              'parked': lambda: parked_scene(rng)}[scene]()
    jpref = pallas_nn.build_pruned_ref(jnp.asarray(ref), rb=rb)
    tpref = nk.build_pruned_ref(torch.tensor(ref), rb=rb)
    qperm, q_sorted, order, lb, qb, rb_ = nk.pruned_tables(
        torch.tensor(q), tpref, cutoff)
    jq, jorder, jlb, jqb, jrb = jax_tables(q, jpref, cutoff)
    assert (qb, rb_) == (jqb, jrb)
    np.testing.assert_array_equal(qperm.numpy(), jq)
    np.testing.assert_array_equal(order.numpy(), jorder)
    np.testing.assert_array_equal(lb.numpy(), jlb)
    assert order.dtype == torch.int32 and lb.dtype == torch.float32

    # The kernel's visit rule over these tables gives the Pallas kernel's
    # answer for every query (also beyond the cutoff, where only the
    # visited tiles count).  XLA rounds the f32 sum of squares its own
    # way (1 ulp), hence assert_same_nn rather than bit equality.
    d2_s, idx_s = kernel_model(q_sorted, tpref.points, order, lb, qb, rb_,
                               cutoff ** 2)
    d2 = torch.empty_like(d2_s)
    idx = torch.empty_like(idx_s)
    d2[qperm], idx[qperm] = d2_s, idx_s
    jd2, jidx = pallas_nn.nn_indices_pruned(jnp.asarray(q), jpref,
                                            cutoff=cutoff, interpret=True)
    assert_same_nn(q, tpref.points.numpy(), d2.numpy(), idx.numpy(),
                   np.asarray(jd2), np.asarray(jidx))


@pytest.mark.parametrize('scene,rb,cutoff', [('random', None, 1.0),
                                             ('clustered', 256, 3.0),
                                             ('parked', None, 3.0)])
def test_nn_indices_pruned_plain_matches_pallas(rng, scene, rb, cutoff):
    q, ref = {'random': lambda: random_scene(rng, 4096, 512),
              'clustered': lambda: clustered_scene(rng),
              'parked': lambda: parked_scene(rng)}[scene]()
    jpref = pallas_nn.build_pruned_ref(jnp.asarray(ref), rb=rb)
    tpref = nk.build_pruned_ref(torch.tensor(ref), rb=rb)
    jd2, jidx = pallas_nn.nn_indices_pruned(jnp.asarray(q), jpref,
                                            cutoff=cutoff, interpret=True)
    before = nk.nn_indices_pruned.launches
    td2, tidx = nk.nn_indices_pruned(torch.tensor(q), tpref, cutoff=cutoff)
    assert nk.nn_indices_pruned.launches == before
    jd2, jidx = np.asarray(jd2), np.asarray(jidx)
    td2, tidx = td2.numpy(), tidx.numpy()
    inside = td2 <= cutoff ** 2
    assert inside.sum() > 50          # both branches exercised
    assert_same_nn(q[inside], tpref.points.numpy(), td2[inside], tidx[inside],
                   jd2[inside], jidx[inside])
    # Beyond the cutoff: plain says inf, the kernel only > cutoff^2.
    assert np.all(np.isinf(td2[~inside]))
    assert np.all(jd2[~inside] > cutoff ** 2)


def pack_keys(d2, idx):
    """csrc/nn.cu's merge key: (f32 bits of d2) << 32 | idx."""
    return (d2.view(torch.int32).to(torch.int64) << 32) | idx.to(torch.int64)


def unpack_keys(keys):
    return ((keys >> 32).to(torch.int32).view(torch.float32),
            (keys & 0xFFFFFFFF).to(torch.int32))


def schedule_model(q, ref, qt, rt, tables=None, cutoff2=None, sequence=None,
                   lag=0):
    """Torch model of csrc/nn.cu's nn_items_kernel.

    Items (query tile i of ``qt`` queries, rank j) are numbered rank-major,
    item = j * nQt + i, and run in ``sequence`` (default: that order).
    K1 (``tables`` None): item (i, j) scans reference rows [j*rt,
    (j+1)*rt), the last tile ragged.  K2 (``tables`` = (order, lb) of
    ``pruned_tables``): item (i, j) skips when lb[i, j] >= cutoff2 or when
    lb[i, j] >= the largest merged d2 over the tile's queries, read as the
    keys stood ``lag`` items earlier (items still in flight on the card
    have not merged yet), and otherwise scans tile order[i, j].  Each item
    lowers its queries' keys (d2 bits << 32 | idx) with a min, as the
    kernel's atomicMin; the first index of a tile's minimum is what the
    kernel's strict '<' keeps within its spans.  Returns (d2, idx, number
    of items scanned)."""
    Q, R = q.shape[0], ref.shape[0]
    n_qt = -(-Q // qt)
    n_rank = -(-R // rt) if tables is None else tables[0].shape[1]
    keys = torch.full((Q,), nk._INIT_KEY, dtype=torch.int64)
    seen = [keys.clone()]
    scanned = 0
    for item in (range(n_qt * n_rank) if sequence is None else sequence):
        i, j = item % n_qt, item // n_qt
        rows = slice(i * qt, min((i + 1) * qt, Q))
        if tables is None:
            first, n = j * rt, min(rt, R - j * rt)
        else:
            order, lb = tables
            bound = float(lb[i, j])
            merged = unpack_keys(seen[max(0, len(seen) - 1 - lag)][rows])[0]
            first, n = int(order[i, j]) * rt, rt
            if not (bound < cutoff2 and bound < float(merged.max())):
                n = 0
        if n:
            m, a = torch.min(sqdist(q[rows], ref[first:first + n]), dim=1)
            keys[rows] = torch.minimum(
                keys[rows], pack_keys(m, a.to(torch.int32) + first))
            scanned += 1
        seen.append(keys.clone())
    return (*unpack_keys(keys), scanned)


def copies_scene(rng):
    """Exact copies of 32 reference points 2000 rows later (another
    reference tile at 512-point tiles), queried 1 cm away: the nearest
    point is tied between the two copies."""
    q, ref = random_scene(rng, 3001, 250)
    ref[2000:2032] = ref[10:42]
    q[:32] = ref[10:42] + 0.01
    return q, ref


def ball_scene(rng):
    """256 queries in a 0.3 m ball inside a 4 m cube of reference points:
    many reference tiles lie within a 3 m cutoff, but beyond the queries'
    nearest points, so only the merged bests can skip them."""
    ref = rng.uniform(0.0, 4.0, size=(4096, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3))
    d *= 0.3 * rng.uniform(size=(256, 1)) / np.linalg.norm(d, axis=1,
                                                           keepdims=True)
    return (2.0 + d).astype(np.float32), ref


SCENES = {'random': lambda rng: random_scene(rng, 4096, 512),
          'clustered': clustered_scene,
          'parked': parked_scene,
          'copies': copies_scene,
          'ball': ball_scene}


def item_sequences(n_items, seed=0):
    """Rank-major, reversed, and a seeded shuffle of the items."""
    shuffled = np.random.default_rng(seed).permutation(n_items).tolist()
    return {'rank-major': None, 'reversed': list(range(n_items))[::-1],
            'shuffled': shuffled}


@pytest.mark.parametrize('rt', [nk._K1_RT, 512])
@pytest.mark.parametrize('scene', sorted(SCENES))
def test_k1_schedule_model_matches_pallas_in_any_item_order(rng, scene, rt):
    """K1's items merged through packed keys give the Pallas kernel's
    answer, and the plain version's bit for bit, whatever order the items
    run in; exact copies in different reference tiles go to the lowest
    index."""
    q, ref = SCENES[scene](rng)
    jd2, jidx = pallas_nn.nn_indices(jnp.asarray(q), jnp.asarray(ref),
                                     interpret=True)
    tq, tref = torch.tensor(q), torch.tensor(ref)
    pd2, pidx = nk.nn_indices_plain(tq, tref)
    n_items = -(-q.shape[0] // nk._K1_QT) * -(-ref.shape[0] // rt)
    for sequence in item_sequences(n_items).values():
        d2, idx, scanned = schedule_model(tq, tref, nk._K1_QT, rt,
                                          sequence=sequence)
        assert scanned == n_items
        assert torch.equal(d2, pd2) and torch.equal(idx, pidx)
        assert_same_nn(q, ref, d2.numpy(), idx.numpy(), np.asarray(jd2),
                       np.asarray(jidx))
        if scene == 'copies':
            want = np.arange(10, 42)
            np.testing.assert_array_equal(idx.numpy()[:32], want)
            np.testing.assert_array_equal(np.asarray(jidx)[:32], want)


@pytest.mark.parametrize('scene,rb,cutoff', [('random', None, 1.0),
                                             ('random', 512, 1.0),
                                             ('clustered', 256, 3.0),
                                             ('parked', None, 3.0),
                                             ('copies', 256, 1.0),
                                             ('ball', 128, 3.0)])
def test_k2_schedule_model_matches_pallas_in_any_item_order(rng, scene, rb,
                                                           cutoff):
    """K2's items, skipped against the merged bests (current, or stale by
    any number of items in flight), give the Pallas kernel's d2 for every
    query within the cutoff, bit-equal to the plain version, with an index
    at that exact d2; beyond the cutoff they report d2 > cutoff^2."""
    q, ref = SCENES[scene](rng)
    jpref = pallas_nn.build_pruned_ref(jnp.asarray(ref), rb=rb)
    tpref = nk.build_pruned_ref(torch.tensor(ref), rb=rb)
    jd2, jidx = pallas_nn.nn_indices_pruned(jnp.asarray(q), jpref,
                                            cutoff=cutoff, interpret=True)
    jd2, jidx = np.asarray(jd2), np.asarray(jidx)
    qperm, q_sorted, order, lb, qb, rb_ = nk.pruned_tables(
        torch.tensor(q), tpref, cutoff)
    pd2 = nk.nn_indices_pruned_plain(torch.tensor(q), tpref, cutoff)[0]
    inside = (pd2 <= cutoff ** 2).numpy()
    assert inside.sum() > 50
    n_items = order.numel()
    runs = [(s, 0) for s in item_sequences(n_items).values()]
    runs.append((None, n_items))            # every item in flight at once
    scanned = {}
    for sequence, lag in runs:
        d2_s, idx_s, scanned[sequence is None, lag] = schedule_model(q_sorted, tpref.points, qb, rb_,
                                     tables=(order, lb), cutoff2=cutoff ** 2,
                                     sequence=sequence, lag=lag)
        d2 = torch.empty_like(d2_s)
        idx = torch.empty_like(idx_s)
        d2[qperm], idx[qperm] = d2_s, idx_s
        assert torch.equal(d2[inside], pd2[inside])
        hit = sqdist(torch.tensor(q), tpref.points)[
            torch.arange(q.shape[0]), idx.long()]
        assert torch.equal(hit[inside], d2[inside])
        assert bool(torch.all(d2[~inside] > cutoff ** 2))
        assert_same_nn(q[inside], tpref.points.numpy(), d2.numpy()[inside],
                       idx.numpy()[inside], jd2[inside], jidx[inside])
        assert np.all(jd2[~inside] > cutoff ** 2)
    # Bests merged earlier only prune more: in rank-major order with
    # nothing in flight, no more items scan than with every item in
    # flight (which skips by the cutoff alone), and in the ball, fewer.
    assert scanned[True, 0] <= scanned[True, n_items]
    if scene == 'ball':
        assert scanned[True, 0] < scanned[True, n_items]


# --------------------------------------------------------------------------
# K2's set-up as the card builds it (nn_kernels.pruned_setup), through its
# plain twin pruned_tables_by_keys: packed (code << 32 | row) keys for the
# query sort, (lb bits << 32 | j) keys for each row of bounds.
# --------------------------------------------------------------------------

def _setup_scene(name):
    """(queries, reference, rb, cutoff) of each set-up scene, from a seed
    of its own."""
    rng = np.random.default_rng(sorted(SETUP_SCENES).index(name) + 160)
    if name == 'random':
        q, ref = random_scene(rng, 4096, 512)
        return q, ref, 512, 1.0
    if name == 'clustered':
        return (*clustered_scene(rng), 256, 3.0)
    if name == 'parked':
        q, ref = parked_scene(rng)
        return q, ref, 32, 3.0
    if name == 'all-parked':
        q = random_scene(rng, 1, 300)[0]
        return q, np.full((256, 3), jpc.SENTINEL, np.float32), 32, 3.0
    if name == 'duplicates':
        # 16 distinct points 32 times each: their Morton codes tie, and the
        # row decides.
        q = np.tile(random_scene(rng, 1, 16)[0], (32, 1))
        return q, random_scene(rng, 2048, 1)[1], 256, 3.0
    if name == 'overlapping':
        # One query tile spread over the whole cube overlaps each of the
        # 16 reference tiles in it: every bound is 0 and ties, and j
        # decides.
        ref = rng.uniform(0.0, 2.0, size=(2048, 3)).astype(np.float32)
        q = rng.uniform(0.0, 2.0, size=(256, 3)).astype(np.float32)
        return q, ref, 128, 1.0
    if name == 'q1000':                   # qb 250
        q, ref = random_scene(rng, 3001, 1000)
        return q, ref, None, 3.0
    if name == 'prime-q':                 # 509 queries: qb 1
        q, ref = random_scene(rng, 2048, 509)
        return q, ref, 256, 3.0
    raise KeyError(name)


SETUP_SCENES = ('random', 'clustered', 'parked', 'all-parked', 'duplicates',
                'overlapping', 'q1000', 'prime-q')


@pytest.fixture(scope='module')
def setup_runs():
    """Each set-up scene's inputs, references and JAX tables, made once
    for the module (the JAX tables compile their ops per shape)."""
    runs = {}
    for name in SETUP_SCENES:
        q, ref, rb, cutoff = _setup_scene(name)
        jpref = pallas_nn.build_pruned_ref(jnp.asarray(ref), rb=rb)
        runs[name] = (q, ref, rb, cutoff, jax_tables(q, jpref, cutoff))
    return runs


@pytest.mark.parametrize('name', SETUP_SCENES)
def test_pruned_tables_by_keys_equal_pruned_tables_and_jax(setup_runs, name):
    """The card's set-up algorithm in plain torch gives pruned_tables'
    tables bit for bit, and JAX's (pallas_nn.py:313-340): the packed
    query keys sort as the stable argsort of the codes, the packed bound
    keys as the stable argsort of each row, NaN-free bounds >= +0 order
    by their bits."""
    q, ref, rb, cutoff, (jq, jorder, jlb, jqb, jrb) = setup_runs[name]
    tpref = nk.build_pruned_ref(torch.tensor(ref), rb=rb)
    want = nk.pruned_tables(torch.tensor(q), tpref, cutoff)
    got = nk.pruned_tables_by_keys(torch.tensor(q), tpref, cutoff)
    assert got[4:] == want[4:] == (jqb, jrb)
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_array_equal(got[0].numpy(), jq)
    np.testing.assert_array_equal(got[2].numpy(), jorder)
    np.testing.assert_array_equal(got[3].numpy(), jlb)
    if name == 'duplicates':              # ties: rows in their own order
        codes = nk._morton3d(torch.tensor(q), tpref.box[0:1],
                             tpref.box[2:3])[got[0]]
        rows = got[0]
        tie = codes[1:] == codes[:-1]
        assert bool(tie.any()) and bool(torch.all(rows[1:][tie]
                                                  > rows[:-1][tie]))
    if name == 'overlapping':             # lb 0 ties: tiles in their order
        assert bool(torch.all(got[3] == 0.0))
        assert torch.equal(got[2], torch.arange(got[2].shape[1],
                                                dtype=torch.int32)
                           .expand_as(got[2]))


def test_pruned_tables_by_keys_over_lanes_equal_each_lane(rng):
    """Three lanes (one with parked rows, one all parked) in one call of
    the twin: each lane's tables equal pruned_tables of that lane alone
    and JAX's."""
    q = (rng.normal(size=(3, 500, 3)) * 5).astype(np.float32)
    ref = (rng.normal(size=(3, 2048, 3)) * 5).astype(np.float32)
    ref[1, ::3] = jpc.SENTINEL
    ref[2] = jpc.SENTINEL
    pref = nk.build_pruned_ref_lanes(torch.tensor(ref), rb=256)
    got = nk.pruned_tables_by_keys(torch.tensor(q), pref, 2.0)
    for a, b in zip(got[:4], nk.pruned_tables_lanes(torch.tensor(q), pref,
                                                    2.0)[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for b in range(3):
        one = nk.pruned_tables(torch.tensor(q[b]), pref.lane(b), 2.0)
        for x, y in zip(got[:4], one[:4]):
            assert torch.equal(x[b], y)
        jq, jorder, jlb, _, _ = jax_tables(
            q[b], pallas_nn.build_pruned_ref(jnp.asarray(ref[b]), rb=256),
            2.0)
        np.testing.assert_array_equal(got[0][b].numpy(), jq)
        np.testing.assert_array_equal(got[2][b].numpy(), jorder)
        np.testing.assert_array_equal(got[3][b].numpy(), jlb)


@pytest.mark.parametrize('lanes', [None, 3])
def test_build_pruned_ref_keeps_its_morton_box(rng, lanes):
    """The box build_pruned_ref keeps equals _finite_bounds of its sorted
    points, and JAX's, bit for bit (the unit box where a lane is all
    parked); a lane slice and a reference rebuilt from its fields carry
    it."""
    shape = (2048, 3) if lanes is None else (lanes, 2048, 3)
    ref = (rng.normal(size=shape) * 5).astype(np.float32)
    if lanes:
        ref[1, ::3] = jpc.SENTINEL
        ref[2] = jpc.SENTINEL
    pref = (nk.build_pruned_ref(torch.tensor(ref), rb=256) if lanes is None
            else nk.build_pruned_ref_lanes(torch.tensor(ref), rb=256))
    lo, hi = nk._finite_bounds(pref.points)
    inv = 1.0 / torch.clamp(hi - lo, min=1e-6)
    for got, want in ((pref.box[..., 0, :], lo), (pref.box[..., 1, :], hi),
                      (pref.box[..., 2, :], inv)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    for b in range(lanes or 1):
        one = pref if lanes is None else pref.lane(b)
        jlo, jhi = pallas_nn._finite_bounds(jnp.asarray(one.points.numpy()))
        np.testing.assert_array_equal(one.box[0].numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(one.box[1].numpy(), np.asarray(jhi))
        if lanes:
            alone = nk.build_pruned_ref(torch.tensor(ref[b]), rb=256)
            assert torch.equal(one.box, alone.box)
    if lanes:
        np.testing.assert_array_equal(pref.box[2, 0].numpy(), np.zeros(3))
        np.testing.assert_array_equal(pref.box[2, 1].numpy(), np.ones(3))
    again = nk.PrunedRef(*pref)
    assert torch.equal(again.box, pref.box)
    assert torch.equal(again._replace(points=pref.points.clone()).box,
                       pref.box)
