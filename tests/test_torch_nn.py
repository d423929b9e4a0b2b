"""The port's exact-NN module against the JAX Pallas kernels (interpret
mode), on the test_pallas_nn.py inputs.

On the CPU the wrappers run their plain torch versions.  What the CUDA
kernels add is the visit rule of K2 over the pruning tables; that rule
is checked here through a torch model of the kernel's loop, which must
reproduce the Pallas kernel's answers (inside the cutoff and out).
The kernels themselves are compared with their plain versions on the
card in test_torch_kernels.py.

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
    """Torch model of csrc/nn.cu's nn_pruned_kernel: per query tile, walk
    the tiles of its row; stop at the first bound >= cutoff2, skip a tile
    whose bound is >= the tile's largest running best; strict '<' keeps
    the first (lowest index, earliest visited) minimum."""
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
