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
indices except exact ties.
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
    q_ext = jnp.concatenate([qj, jnp.ones((Q, 1), jnp.float32),
                             jnp.zeros((Q, 4), jnp.float32)], axis=1)
    r_ext = jnp.concatenate([-2.0 * rj,
                             jnp.sum(rj * rj, axis=1, keepdims=True),
                             jnp.zeros((R, 4), jnp.float32)], axis=1)
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


def test_e6_ties_across_tiles_follow_the_visit_order():
    """Two copies of a point straddle the boundary of E6's two 1024-wide
    sorted reference tiles, with different payloads.  Query tile 0 visits
    reference tile 0 first and query tile 1 tile 1 first, so the copy that
    wins depends on the query's tile, in JAX and in the port alike."""
    g = np.random.default_rng(11)
    ref = g.uniform(-50, 50, (2047, 3)).astype(np.float32)
    p = ref[np.asarray(pv.morton_order(jnp.asarray(ref)))[1023]]
    ref = np.concatenate([ref, p[None]])
    pay = np.concatenate([ref, g.standard_normal((2048, 3))], 1)
    pay = pay.astype(np.float32)
    q = g.uniform(-50, 50, (512, 3)).astype(np.float32)
    q[::2] = p + g.normal(0, 0.01, (256, 3)).astype(np.float32)
    jd2, jpay = pv.nn_payload_pruned(jnp.asarray(q), jnp.asarray(ref),
                                     jnp.asarray(pay), interpret=True)
    d2, out = nv.nn_payload_pruned(T(q), T(ref), T(pay))
    c = nv.check_payload(T(q), T(ref), T(pay), d2, out, T(jd2), T(jpay))
    assert c['duplicates'] == 256
    copies = {tuple(np.asarray(jpay)[i, 3:]) for i in range(0, 512, 2)}
    assert len(copies) == 2          # both copies win somewhere


def test_e6_visit_order_is_the_rotated_diagonal():
    q, ref, pay = scene('scene')
    tab = nv.pruned_tables(T(q), T(ref), T(pay))
    ni, nj = Q // 256, R // 1024
    assert (tab.qb, tab.rb) == (256, 1024)
    want = [[(j + i * nj // ni) % nj for j in range(nj)] for i in range(ni)]
    np.testing.assert_array_equal(tab.visit.numpy(), want)


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
    assert nv.tiled_block(128) == (128, 1)
    assert nv.tiled_block(8192) == (256, 32)


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
