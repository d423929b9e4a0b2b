"""The shootout's experiment kernels E1-E6 in the port against the JAX
experiments, on the CPU.

The JAX side runs in Pallas interpret mode, with
``experiments/pallas_payload_variants.py`` loaded through importlib as the
shootout scripts load it; the port's wrappers run their plain versions
(CPU tensors).  Inputs come from numpy seeds at 512 queries x 4096
reference points (two 2048-wide tiles for E1/E4/E5, four 1024-wide tiles
for E6), in the scripts' scene: a 100 m cube, queries 5 cm from reference
points.

Tolerances (``nn_variants.score_tolerance``): one f32 evaluation of a
query's matmul-form d2 lies within 4 f32 units of roundoff (2^-24 each)
of the sum of its terms' magnitudes against its winner, ``|q|^2 +
2 sum|q_k r_k| + |r|^2``, from the float64 value (about 2.3e-3 m^2 at
50 m from the origin, 9e-5 m^2 at 10 m).  Each d2 is held to that;
indices are equal except where the two winners' float64 scores lie within
the sum of their limits; payloads equal the winner's row exactly where it
is the only row within twice the limit of the least score, and agree
within 1e-5 where those rows are exact duplicates (tie averaging).
E2/E3 (coordinate-wise, exact) agree with K1 to 1e-6 relative and equal
indices except exact ties.  E6 through the card's merge keys (the plain
decode of its two passes) equals the plain E6 exactly; the replayed
Pallas walk passes the payload check against it.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import laser_slam_tpu  # noqa: F401  (sets the HIGHEST matmul precision)
from laser_slam_tpu.ops import pallas_nn
from laser_slam_tpu_torch.experiments import nn_shootout as sh
from laser_slam_tpu_torch.ops import nn_kernels as nk
from laser_slam_tpu_torch.ops import nn_variants as nv

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q, R = 512, 4096
SENTINEL = 1.0e6


def _load_payload_variants():
    spec = importlib.util.spec_from_file_location(
        'payload_variants',
        os.path.join(REPO, 'experiments', 'pallas_payload_variants.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


pv = _load_payload_variants()


def scene(kind, seed=3):
    """(queries, reference, payload) numpy f32 for one test case:
    'scene' — the scripts' scene; 'duplicates' — exact copies of reference
    points inside one 2048-wide tile (and one across tiles) with their own
    normals, queried near the copies; 'parked' — every third reference row
    at the SENTINEL."""
    q, ref, pay = sh.make_scene(Q, R, seed)
    if kind == 'duplicates':
        src = np.arange(0, 64)
        ref[src + 1000] = ref[src]            # same 2048-wide tile
        ref[src + 3000] = ref[src]            # next tile
        ref[src + 100] = ref[src]             # same tile again
        g = np.random.default_rng(seed + 1)
        nrm = g.standard_normal((R, 3)).astype(np.float32)
        pay = np.concatenate([ref, nrm], axis=1).astype(np.float32)
        q[:64] = ref[src] + g.normal(0, 0.05, (64, 3)).astype(np.float32)
    elif kind == 'parked':
        ref[::3] = SENTINEL
        pay = np.concatenate([ref, pay[:, 3:]], axis=1)
    return q, ref, pay


def T(a):
    return torch.tensor(np.asarray(a))


# --------------------------------------------------------------------------
# E5 and E1
# --------------------------------------------------------------------------

@pytest.mark.parametrize('kind', ['scene', 'duplicates', 'parked'])
def test_e5_indices_match_jax(kind):
    q, ref, _ = scene(kind)
    jd2, jidx = pv.nn_indices(jnp.asarray(q), jnp.asarray(ref),
                              interpret=True)
    d2, idx = nv.nn_indices_mm(T(q), T(ref))
    assert idx.dtype == torch.int32 and d2.shape == (Q,)
    nv.check_mm_indices(T(q), T(ref), d2, idx, T(jd2), T(jidx))
    if kind == 'parked':
        assert bool(torch.all(idx % 3 != 0))
    if kind == 'duplicates':
        # Copies tie exactly in any arithmetic: the lowest index wins.
        assert bool(torch.all(idx[:64] < 64))


def _jax_bf16_witness(q, ref):
    """E1 at DEFAULT precision as the TPU computes it: one bf16 pass
    with f32 accumulate (``jnp.dot`` of bf16 operands into f32), then
    the lowest index of the minimum and ``max(score + |q|^2, 0)``."""
    qj, rj = jnp.asarray(q), jnp.asarray(ref)
    nq, nr = q.shape[0], ref.shape[0]
    q_ext = jnp.concatenate([qj, jnp.ones((nq, 1), jnp.float32),
                             jnp.zeros((nq, 4), jnp.float32)], axis=1)
    r_ext = jnp.concatenate([-2.0 * rj,
                             jnp.sum(rj * rj, axis=1, keepdims=True),
                             jnp.zeros((nr, 4), jnp.float32)], axis=1)
    s = jnp.dot(q_ext.astype(jnp.bfloat16), r_ext.astype(jnp.bfloat16).T,
                preferred_element_type=jnp.float32)
    idx = jnp.argmin(s, axis=1)
    d2 = jnp.maximum(jnp.min(s, axis=1) + jnp.sum(qj * qj, axis=1), 0.0)
    return np.asarray(d2), np.asarray(idx).astype(np.int32)


@pytest.mark.parametrize('kind', ['scene', 'parked'])
def test_e1_bf16_matches_jnp_dot_witness(kind):
    q, ref, _ = scene(kind)
    jd2, jidx = _jax_bf16_witness(q, ref)
    d2, idx = nv.nn_indices_mm(T(q), T(ref), precision='bf16')
    nv.check_mm_indices(T(q), T(ref), d2, idx, T(jd2), T(jidx),
                        precision='bf16')
    # The one-pass product is rank-unsafe at 50 m scale, as on the TPU.
    exact = nk.nn_indices_plain(T(q), T(ref))[0]
    assert float(torch.max(torch.abs(d2 - exact))) > 1.0
    assert float(torch.mean((idx != nk.nn_indices_plain(
        T(q), T(ref))[1]).float())) > 0.05


# --------------------------------------------------------------------------
# E4 and E6
# --------------------------------------------------------------------------

@pytest.mark.parametrize('kind', ['scene', 'duplicates', 'parked'])
def test_e4_payload_matches_jax(kind):
    q, ref, pay = scene(kind)
    jd2, jpay = pv.nn_payload(jnp.asarray(q), jnp.asarray(ref),
                              jnp.asarray(pay), interpret=True)
    d2, out = nv.nn_payload(T(q), T(ref), T(pay))
    assert out.shape == (Q, 6)
    c = nv.check_payload(T(q), T(ref), T(pay), d2, out, T(jd2), T(jpay))
    assert c['unique'] > 0.9 * Q - 64
    if kind == 'duplicates':
        assert c['duplicates'] >= 60
        # Copies 0, +100, +1000 share tile 0 and are averaged; +3000 lies
        # in tile 1 and loses to tile 0 (strict '<' across tiles).
        src = np.arange(64)
        mean = (pay[src] + pay[src + 100] + pay[src + 1000]) / 3.0
        np.testing.assert_allclose(out.numpy()[:64], mean,
                                   atol=nv.PAYLOAD_ATOL)


@pytest.mark.parametrize('kind', ['scene', 'parked'])
def test_e6_morton_order_and_boxes_match_jax(kind):
    q, ref, _ = scene(kind)
    for pts in (q, ref):
        want = np.asarray(pv.morton_order(jnp.asarray(pts)))
        np.testing.assert_array_equal(nv.morton_order(T(pts)).numpy(), want)
    srt = ref[np.asarray(pv.morton_order(jnp.asarray(ref)))]
    want = np.asarray(pv._tile_boxes(jnp.asarray(srt), 1024))[:, :6]
    np.testing.assert_array_equal(nv.tile_boxes(T(srt), 1024).numpy(), want)


@pytest.mark.parametrize('kind', ['scene', 'duplicates', 'parked'])
def test_e6_pruned_payload_matches_jax(kind):
    q, ref, pay = scene(kind)
    jd2, jpay = pv.nn_payload_pruned(jnp.asarray(q), jnp.asarray(ref),
                                     jnp.asarray(pay), interpret=True)
    d2, out = nv.nn_payload_pruned(T(q), T(ref), T(pay))
    c = nv.check_payload(T(q), T(ref), T(pay), d2, out, T(jd2), T(jpay))
    assert c['unique'] > 0.9 * Q - 64
    if kind == 'duplicates':
        assert c['duplicates'] >= 60


def _tie_scene():
    """Two copies of a point straddle the boundary of E6's two 1024-wide
    sorted reference tiles, with different payloads; every other query
    lies next to them."""
    g = np.random.default_rng(11)
    ref = g.uniform(-50, 50, (2047, 3)).astype(np.float32)
    p = ref[np.asarray(pv.morton_order(jnp.asarray(ref)))[1023]]
    ref = np.concatenate([ref, p[None]])
    pay = np.concatenate([ref, g.standard_normal((2048, 3))], 1)
    pay = pay.astype(np.float32)
    q = g.uniform(-50, 50, (512, 3)).astype(np.float32)
    q[::2] = p + g.normal(0, 0.01, (256, 3)).astype(np.float32)
    return q, ref, pay


def test_e6_ties_across_tiles_follow_the_visit_order():
    """On the tie scene query tile 0 visits reference tile 0 first and
    query tile 1 tile 1 first, so the copy that wins depends on the
    query's tile, in JAX and in the port alike."""
    q, ref, pay = _tie_scene()
    jd2, jpay = pv.nn_payload_pruned(jnp.asarray(q), jnp.asarray(ref),
                                     jnp.asarray(pay), interpret=True)
    d2, out = nv.nn_payload_pruned(T(q), T(ref), T(pay))
    c = nv.check_payload(T(q), T(ref), T(pay), d2, out, T(jd2), T(jpay))
    assert c['duplicates'] == 256
    copies = {tuple(np.asarray(jpay)[i, 3:]) for i in range(0, 512, 2)}
    assert len(copies) == 2          # both copies win somewhere


def test_e6_score_keys_order_by_score_then_visit_rank():
    """The plain twin of the kernel's merge key: monotone in the score over
    negative and positive values, one key for -0.0 and +0.0, and equal
    scores ordered by visit rank."""
    scores = torch.tensor([-3.0e4, -2.5, -1e-30, -0.0, 0.0, 1e-30, 0.5,
                           7.0e3, float('inf')])
    keys = nv.score_keys(scores, torch.zeros(len(scores), dtype=torch.int64))
    assert bool(torch.all(keys[1:] >= keys[:-1]))
    assert int(keys[3]) == int(keys[4])                  # -0.0 and +0.0
    assert bool(torch.all(keys[1:3] > keys[:2]))
    assert bool(torch.all(keys[5:] > keys[4:-1]))
    tied = nv.score_keys(torch.tensor([-1.25, -1.25, 0.0, -0.0]),
                         torch.tensor([5, 2, 9, 3]))
    assert int(tied[1]) < int(tied[0]) and int(tied[3]) < int(tied[2])
    g = np.random.default_rng(2)
    a = torch.tensor(g.normal(0, 100, 4096).astype(np.float32))
    rank = torch.tensor(g.integers(0, 64, 4096))
    ka = nv.score_keys(a, rank)
    order = torch.argsort(ka)
    want = np.lexsort((rank.numpy(), a.numpy()))
    np.testing.assert_array_equal(order.numpy(), want)


@pytest.mark.parametrize('kind', ['scene', 'duplicates', 'parked', 'ties'])
def test_e6_key_decode_matches_plain(kind):
    """The kernel's two passes in plain torch (least key -> visit rank ->
    tile -> the tile's tied rows averaged) give exactly the plain E6."""
    if kind == 'ties':
        q, ref, pay = _tie_scene()
    else:
        q, ref, pay = scene(kind)
    d2, out = nv.nn_payload_pruned_by_keys(T(q), T(ref), T(pay))
    pd2, pout = nv.nn_payload_pruned_plain(T(q), T(ref), T(pay))
    assert torch.equal(d2, pd2) and torch.equal(out, pout)


def test_e6_replayed_walk_skips_tiles_and_matches_plain():
    """The plain replay of the Pallas walk (the work E6's bound counts)
    visits fewer reference tiles than there are on the shootout scene,
    and its result passes the payload check against the plain E6."""
    q, ref, pay = (T(a) for a in sh.make_scene(2048, 32768, seed=4))
    visits, d2, out = nv.pruned_walk(q, ref, pay)
    assert visits.shape == (8,)
    assert 1 <= int(visits.min()) and int(visits.sum()) < 8 * 32
    c = nv.check_payload(q, ref, pay, d2, out,
                         *nv.nn_payload_pruned_plain(q, ref, pay))
    assert c['unique'] > 0.9 * 2048


def test_e6_visit_order_is_the_rotated_diagonal():
    q, ref, pay = scene('scene')
    tab = nv.pruned_tables(T(q), T(ref), T(pay))
    ni, nj = Q // 256, R // 1024
    assert (tab.qb, tab.rb) == (256, 1024)
    want = [[(j + i * nj // ni) % nj for j in range(nj)] for i in range(ni)]
    np.testing.assert_array_equal(tab.visit.numpy(), want)


# --------------------------------------------------------------------------
# E5 and E4 through the card's two passes (merge keys, then the winning
# tile scored again)
# --------------------------------------------------------------------------

def _copies_in_the_next_tile():
    """Reference rows 2048-2111 exact copies of rows 0-63, in the next
    2048-wide tile (E4's second tile, E5's fifth key tile), with other
    normals; the first 64 queries beside the copies."""
    q, ref, pay = sh.make_scene(Q, R, 3)
    ref[2048:2112] = ref[:64]
    pay[2048:2112] = np.concatenate([ref[:64], -pay[:64, 3:]], axis=1)
    q[:64] = ref[:64] + np.float32(0.01)
    return q, ref, pay


TWO_PASS_CASES = ['scene', 'duplicates', 'parked', 'ties', 'r3000', 'r3001']


def two_pass_case(kind):
    """The scene cases, the copies across tiles, and 256 queries against
    3000 and 3001 reference points (``_tile(R, 2048)`` = 1500 and 1)."""
    if kind == 'ties':
        return _copies_in_the_next_tile()
    if kind in ('r3000', 'r3001'):
        return sh.make_scene(256, int(kind[1:]), seed=5)
    return scene(kind)


@pytest.mark.parametrize('kind', TWO_PASS_CASES)
def test_e5_two_pass_twin_matches_plain_and_jax(kind):
    """E5 through the merge keys (least key a query over the 512-row key
    tiles, the winning tile scored again) equals the plain E5 exactly and
    passes the index check against JAX's ``nn_indices``."""
    q, ref, _ = two_pass_case(kind)
    d2, idx = nv.nn_indices_mm_by_keys(T(q), T(ref))
    pd2, pidx = nv.nn_indices_mm_plain(T(q), T(ref))
    assert torch.equal(d2, pd2) and torch.equal(idx, pidx)
    jd2, jidx = pv.nn_indices(jnp.asarray(q), jnp.asarray(ref),
                              interpret=True)
    nv.check_mm_indices(T(q), T(ref), d2, idx, T(jd2), T(jidx))
    if kind == 'parked':
        assert bool(torch.all(idx % 3 != 0))
    if kind == 'ties':
        # The copies tie exactly: the first tile's row, the lowest index.
        assert torch.equal(idx[:64], torch.arange(64, dtype=torch.int32))
        np.testing.assert_array_equal(np.asarray(jidx)[:64], np.arange(64))


@pytest.mark.parametrize('kind', TWO_PASS_CASES)
def test_e4_two_pass_twin_matches_plain_and_jax(kind):
    """E4 through the merge keys (least key a query over the
    ``_tile(R, 2048)``-wide tiles, the winning tile's tied rows averaged)
    equals the plain E4 exactly and passes the payload check against JAX's
    ``nn_payload``."""
    q, ref, pay = two_pass_case(kind)
    d2, out = nv.nn_payload_by_keys(T(q), T(ref), T(pay))
    pd2, pout = nv.nn_payload_plain(T(q), T(ref), T(pay))
    assert torch.equal(d2, pd2) and torch.equal(out, pout)
    jd2, jpay = pv.nn_payload(jnp.asarray(q), jnp.asarray(ref),
                              jnp.asarray(pay), interpret=True)
    c = nv.check_payload(T(q), T(ref), T(pay), d2, out, T(jd2), T(jpay))
    assert c['unique'] > 0.9 * q.shape[0] - 64
    if kind == 'ties':
        # A strict '<' across tiles: the first tile's row alone, its copy
        # in the next tile not averaged in.
        assert c['duplicates'] >= 64
        assert torch.equal(out[:64], T(pay[:64]))
        np.testing.assert_allclose(np.asarray(jpay)[:64], pay[:64],
                                   atol=nv.PAYLOAD_ATOL)


@pytest.mark.parametrize('kind', TWO_PASS_CASES)
def test_e1_two_pass_twin_matches_plain_and_jax(kind):
    """E1 through the merge keys (the bf16 operands, the least score a
    512-row key tile, the least key's tile, that tile's scores again)
    equals the plain E1 exactly and passes the bf16 index check against
    the ``jnp.dot`` witness."""
    q, ref, _ = two_pass_case(kind)
    d2, idx = nv.nn_indices_mm_bf16_by_keys(T(q), T(ref))
    pd2, pidx = nv.nn_indices_mm_plain(T(q), T(ref), 'bf16')
    assert torch.equal(d2, pd2) and torch.equal(idx, pidx)
    jd2, jidx = _jax_bf16_witness(q, ref)
    nv.check_mm_indices(T(q), T(ref), d2, idx, T(jd2), T(jidx),
                        precision='bf16')
    if kind == 'parked':
        assert bool(torch.all(idx % 3 != 0))
    if kind == 'ties':
        # Exact copies score the same bits in any tile, so the copy in the
        # next tile never wins.  bf16's rank errors at 50 m send some of
        # the 64 queries to other rows (in JAX too), the rest to their
        # first copy.
        assert not bool(torch.any((idx >= 2048) & (idx < 2112)))
        assert int(torch.sum(idx[:64] == torch.arange(64))) >= 1
        np.testing.assert_array_equal(np.asarray(jidx)[:64], idx[:64])


@pytest.mark.parametrize('kind', ['scene', 'parked', 'r3001'])
def test_e1_setup_rows_are_the_plain_bf16_rows(kind):
    """The plain twin of E1's set-up kernel packs exactly the bf16 rows the
    plain E1 multiplies (``round_bf16(extend_reference(ref))``: |r|^2
    summed in torch's order and in the kernel's, (x*x + y*y) + z*z, round
    alike), the pad rows up to a multiple of 8 zero."""
    _, ref, _ = two_pass_case(kind)
    rows = nv.mm_bf16_rows_plain(T(ref))
    n = ref.shape[0]
    assert rows.dtype == torch.int32 and rows.shape == (-(-n // 8) * 8, 2)
    vals = nv.bf16_row_values(rows)
    want = nv.round_bf16(nv.extend_reference(T(ref)))
    assert torch.equal(vals[:n].view(torch.int32), want.view(torch.int32))
    assert not bool(torch.any(vals[n:]))
    lo = rows[:n, 0] & 0xFFFF
    assert torch.equal(lo.to(torch.int16).view(torch.bfloat16).float(),
                       want[:, 0])


def test_e1_work_items_and_the_miss_check():
    """256-query tiles x 2048-row spans: 1024 items at the shootout's 8192
    x 65536 (at least 256); an index -1 (the epilogue's self-check) fails
    the index check."""
    assert nv.mm_bf16_items(8192, 65536) == 1024
    assert nv.mm_bf16_items(1000, 3001) == 4 * 2
    q, ref, _ = (T(a) for a in scene('scene'))
    d2, idx = nv.nn_indices_mm(q, ref, 'bf16')
    miss = idx.clone()
    miss[3] = -1
    with pytest.raises(AssertionError, match='out of range'):
        nv.check_mm_indices(q, ref, d2, idx, d2, miss, precision='bf16')


def test_e1_probe_variants_change_one_piece_each():
    """The chip probe of E1's bound edits the kernel source it reads: each
    variant differs from the source in the piece it names and no other."""
    from laser_slam_tpu_torch.experiments import e1_probe
    from laser_slam_tpu_torch.ops import cuda_build
    with open(os.path.join(cuda_build.CSRC_DIR, 'nn_variants.cu')) as f:
        src = f.read()
    texts = e1_probe.variants(src)
    assert list(texts) == ['as_is', 'no_min', 'no_mma', 'k16']
    assert texts['as_is'] == src
    changed = {name: [a for a, b in zip(src.splitlines(),
                                         text.splitlines()) if a != b]
               for name, text in texts.items()}
    assert changed['no_min'] == [e1_probe._MIN.join(['        ', ''])]
    assert 'mma.sync.aligned.m16n8k16' in texts['k16']
    assert texts['no_mma'].count('mma_bf16_1688(d, a[f][0]') == 1
    with pytest.raises(RuntimeError, match='changed'):
        e1_probe.variants(src.replace('m16n8k8', 'm16n8k4'))


def test_merge_key_pick_takes_the_lowest_tile_of_equal_minima():
    """The pick through the merge keys: the least tile minimum, equal ones
    (-0.0 against +0.0 among them) to the lowest tile, as torch.argmin's
    first minimum and the Pallas strict '<' across tiles."""
    tile_min = torch.tensor([[0.0, -0.0, 1.0], [-0.0, 0.0, -1.0],
                             [2.0, -0.0, 0.0], [5.0, 3.0, 3.0],
                             [-1e-30, -0.0, 0.0], [-0.0, -0.0, -0.0]])
    want = [0, 2, 1, 1, 0, 0]
    assert nv._least_tile(tile_min).tolist() == want
    assert torch.argmin(tile_min, dim=1).tolist() == want


def test_e4_e5_work_items_fill_the_card():
    """512-query tiles x 2048-row spans: 512 items at the shootout's 8192 x
    65536 (at least 256), ragged tiles counted whole."""
    assert nv.mm_items(8192, 65536) == 512
    assert nv.mm_items(1000, 3001) == 2 * 2
    assert nv.mm_items(1, 1) == 1


# --------------------------------------------------------------------------
# E2 and E3
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=('qb', 'rb'))
def _jax_tiled(queries, ref_points, qb, rb):
    """E3's ``nn_tiled`` (pallas_tile_sweep.py:51-80): K1's Pallas kernel
    at a (qb, rb) tile, in interpret mode."""
    nq, nr = queries.shape[0], ref_points.shape[0]
    q_ext = jnp.concatenate([queries, jnp.zeros((nq, 5), jnp.float32)],
                            axis=1)
    r_t = jnp.concatenate([ref_points.T, jnp.zeros((5, nr), jnp.float32)],
                          axis=0)
    vmem = pltpu.VMEM
    d2, idx = pl.pallas_call(
        pallas_nn._nn_idx_kernel, grid=(nq // qb, nr // rb),
        in_specs=[pl.BlockSpec((qb, 8), lambda i, j: (i, 0),
                               memory_space=vmem),
                  pl.BlockSpec((8, rb), lambda i, j: (0, j),
                               memory_space=vmem)],
        out_specs=[pl.BlockSpec((qb, 1), lambda i, j: (i, 0),
                                memory_space=vmem)] * 2,
        out_shape=[jax.ShapeDtypeStruct((nq, 1), jnp.float32),
                   jax.ShapeDtypeStruct((nq, 1), jnp.int32)],
        scratch_shapes=[vmem((qb, 1), jnp.float32),
                        vmem((qb, 1), jnp.int32)],
        interpret=True)(q_ext, r_t)
    return d2[:, 0], idx[:, 0]


@pytest.mark.parametrize('qb,rb', [(128, 1024), (256, 2048), (512, 4096)])
def test_e3_tiled_matches_jax_tile_sweep(qb, rb):
    q, ref, _ = scene('parked' if qb == 512 else 'scene')
    jd2, jidx = _jax_tiled(jnp.asarray(q), jnp.asarray(ref), qb, rb)
    d2, idx = nv.nn_indices_tiled(T(q), T(ref), qb, rb)
    nv.check_exact_indices(T(q), T(ref), d2, idx, T(jd2), T(jidx))
    kd2, kidx = pallas_nn.nn_indices(jnp.asarray(q), jnp.asarray(ref),
                                     interpret=True)
    nv.check_exact_indices(T(q), T(ref), d2, idx, T(kd2), T(kidx))


def test_e2_vpu_matches_k1():
    q, ref, _ = scene('duplicates')
    jd2, jidx = pallas_nn.nn_indices(jnp.asarray(q), jnp.asarray(ref),
                                     interpret=True)
    d2, idx = nv.nn_vpu(T(q), T(ref))
    nv.check_exact_indices(T(q), T(ref), d2, idx, T(jd2), T(jidx))
    assert bool(torch.all(idx[:64] < 64))


# --------------------------------------------------------------------------
# Wrappers and checks
# --------------------------------------------------------------------------

def test_wrappers_refuse_what_the_kernels_do_not_take():
    meta = torch.zeros((4, 3), device='meta')
    pay = torch.zeros((4, 6), device='meta')
    for call in (lambda: nv.nn_indices_mm(meta, meta),
                 lambda: nv.nn_payload(meta, meta, pay),
                 lambda: nv.nn_payload_pruned(meta, meta, pay),
                 lambda: nv.nn_vpu(meta, meta),
                 lambda: nv.nn_indices_tiled(meta, meta, 256, 2048)):
        with pytest.raises(ValueError, match='CUDA'):
            call()
    cpu = torch.zeros((4, 3))
    with pytest.raises(ValueError, match='precision'):
        nv.nn_indices_mm(cpu, cpu, precision='tf32')
    with pytest.raises(ValueError, match='payload'):
        nv.nn_payload(cpu, cpu, torch.zeros((4, 9)))
    with pytest.raises(ValueError, match='query tile'):
        nv.nn_indices_tiled(cpu, cpu, 300, 2048)
    with pytest.raises(ValueError, match='visits'):
        nv.nn_payload_pruned(cpu, cpu, torch.zeros((4, 6)),
                             return_visits=True)
    for qb in (128, 200, 8192):
        nv.check_query_tile(qb)
        d2, idx = nv.nn_indices_tiled(cpu, cpu, qb, 2048)
        assert d2.shape == idx.shape == (4,)


@pytest.mark.parametrize('kind', ['indices', 'payload'])
def test_d2_check_rejects_a_tenth_too_large(kind):
    """The d2 limit is per query, so a d2 a tenth too large fails it on
    the scripts' scene, where the typical nearest d2 is 7.5e-3 m^2."""
    q, ref, pay = (T(a) for a in scene('scene'))
    if kind == 'indices':
        d2, idx = nv.nn_indices_mm(q, ref)
        c = nv.check_mm_indices(q, ref, d2, idx, d2, idx)
        with pytest.raises(AssertionError, match='d2 beyond'):
            nv.check_mm_indices(q, ref, d2, idx, 1.1 * d2, idx)
    else:
        d2, out = nv.nn_payload(q, ref, pay)
        c = nv.check_payload(q, ref, pay, d2, out, d2, out)
        with pytest.raises(AssertionError, match='d2 beyond'):
            nv.check_payload(q, ref, pay, d2, out, 1.1 * d2, out)
    # Sound f32 results use a fraction of the limit.
    assert 0.0 < c['err_over_tol'] < 0.5


def test_checks_catch_wrong_results():
    """The float64 checks reject a result whose winner or payload is
    wrong beyond the tolerance."""
    q, ref, pay = (T(a) for a in scene('scene'))
    d2, idx = nv.nn_indices_mm(q, ref)
    bad = idx.clone()
    bad[5] = (bad[5] + 1) % R
    with pytest.raises(AssertionError, match='d2 beyond'):
        nv.check_mm_indices(q, ref, d2, idx, d2, bad)
    # The wrong winner with its own d2: the index check catches it.
    bad_d2 = d2.clone()
    bad_d2[5] = torch.sum((q[5] - ref[bad[5]]).double() ** 2).float()
    with pytest.raises(AssertionError, match='index'):
        nv.check_mm_indices(q, ref, d2, idx, bad_d2, bad)
    with pytest.raises(AssertionError, match='d2'):
        nv.check_mm_indices(q, ref, d2, idx, d2 + 1.0, idx)
    pd2, out = nv.nn_payload(q, ref, pay)
    wrong = out.clone()
    wrong[7, 3] += 1e-3
    with pytest.raises(AssertionError, match='payload'):
        nv.check_payload(q, ref, pay, pd2, out, pd2, wrong)
    with pytest.raises(AssertionError, match='not ties'):
        nv.check_exact_indices(q, ref, *nv.nn_vpu(q, ref),
                               nv.nn_vpu(q, ref)[0], bad)
