"""Exact 1-NN for ICP: hand-written CUDA kernels and their plain versions.

Counterpart of ``laser_slam_tpu/ops/pallas_nn.py``.  Two kernels, both
in ``csrc/nn.cu`` (see its header for the design and what bounds them):

* K1 ``nn_indices`` replaces the Pallas ``_nn_idx_kernel``: exact 1-NN of
  every query against every reference point.
* K2 ``nn_indices_pruned`` replaces the Pallas ``_nn_pruned_kernel``: the
  Morton-sorted, AABB-pruned, radius-bounded exact 1-NN that ICP uses by
  default (``IcpConfig.pallas_prune``).

Each wrapper takes its plain torch version (a chunked coordinate-wise
brute force with ``min``, which returns the first index) when the tensors
lie on the CPU.  For CUDA tensors it launches its kernel, adds one to its
``launches`` counter, or raises: there is no fallback.  Distances are
coordinate-wise f32 ``(q-r)^2`` in both, never the ``|q|^2 - 2 q.r +
|r|^2`` expansion, which loses rank order at 50 m scene scale.

The pruning tables (Morton codes, tile AABBs, the [nQ, nR] lower bounds,
their stable argsort and the aliasing of the pruned suffix) are plain
torch, as they are plain XLA in the JAX package, with the JAX tile sizes
and stable sorts so that the sorted-reference index and the visit order
match it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from laser_slam_tpu_torch.ops.neighbors import nn_brute, query_chunks, sqdist

# Tile sizes of the JAX package (pallas_nn._QB/_RB).  K2's tables keep
# them: the reference tile is the unit of pruning and of the sorted index.
_QB = 256
_RB = 4096


def _tile(n: int, preferred: int) -> int:
    t = min(preferred, n)
    while n % t:
        t -= 1
    return t


_lib = None


def _kernels() -> ctypes.CDLL:
    """Build (first use only) and bind the kernels of ``csrc/nn.cu``."""
    global _lib
    if _lib is None:
        from laser_slam_tpu_torch.ops.cuda_build import load_library
        lib = load_library('nn.cu')
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lsl_nn_indices.argtypes = [p, p, i, i, p, p, i, p]
        lib.lsl_nn_indices.restype = i
        lib.lsl_nn_indices_pruned.argtypes = [p, p, p, p, i, i, i, i, f, p,
                                              p, i, p]
        lib.lsl_nn_indices_pruned.restype = i
        _lib = lib
    return _lib


def _check_cuda(name: str, *tensors) -> torch.device:
    """Raise unless every tensor is a contiguous CUDA tensor on one card."""
    device = tensors[0].device
    for t in tensors:
        if t.device.type != 'cuda' or t.device != device:
            raise ValueError(f'{name}: expected CUDA tensors on one device '
                             f'(CPU tensors take the plain version), got '
                             f'{[str(x.device) for x in tensors]}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: tensors must be contiguous')
    return device


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with cudaError_t '
                           f'{err}')


def _check_points(name: str, **arrays) -> None:
    for key, a in arrays.items():
        if a.dtype != torch.float32 or a.ndim != 2 or a.shape[1] != 3:
            raise ValueError(f'{name}: {key} must be float32 [N,3], got '
                             f'{a.dtype} {tuple(a.shape)}')


# --------------------------------------------------------------------------
# K1: exact 1-NN
# --------------------------------------------------------------------------

def nn_indices_plain(queries: torch.Tensor, ref_points: torch.Tensor):
    """Plain torch K1 (``neighbors.nn_brute``): (d2 [Q] f32, idx [Q] i32),
    ties to the lowest index."""
    idx, d2 = nn_brute(queries, ref_points)
    return d2, idx


def nn_indices(queries: torch.Tensor, ref_points: torch.Tensor):
    """For each query, (squared distance, index) of its nearest reference
    point.  Exact — distances are computed coordinate-wise in f32.

    queries: [Q,3] f32; ref_points: [R,3] f32.  Park invalid points at
    cloud.SENTINEL (1e6): parked rows carry huge distances and can never
    win.  Returns (d2 [Q] f32, idx [Q] i32).  CPU tensors run
    :func:`nn_indices_plain`; CUDA tensors launch K1.
    """
    _check_points('nn_indices', queries=queries, ref_points=ref_points)
    if queries.device.type == 'cpu' and ref_points.device.type == 'cpu':
        return nn_indices_plain(queries, ref_points)
    device = _check_cuda('nn_indices', queries, ref_points)
    Q, R = queries.shape[0], ref_points.shape[0]
    d2 = torch.empty(Q, dtype=torch.float32, device=device)
    idx = torch.empty(Q, dtype=torch.int32, device=device)
    if Q == 0:
        return d2, idx
    if R == 0:
        raise ValueError('nn_indices: empty reference')
    err = _kernels().lsl_nn_indices(
        queries.data_ptr(), ref_points.data_ptr(), Q, R, d2.data_ptr(),
        idx.data_ptr(), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _check_launch('nn_indices', err)
    nn_indices.launches += 1
    return d2, idx


nn_indices.launches = 0


# --------------------------------------------------------------------------
# K2: Morton-pruned radius-bounded exact 1-NN
# --------------------------------------------------------------------------

class PrunedRef(NamedTuple):
    """Morton-sorted reference with per-tile AABBs (build once per
    reference cloud; reuse across ICP iterations and readings)."""
    points: torch.Tensor    # [R,3] sorted copy of the reference points
    perm: torch.Tensor      # [R] i32: sorted row -> original row
    tile_lo: torch.Tensor   # [nR,3] per-tile AABB lower corners
    tile_hi: torch.Tensor   # [nR,3] per-tile AABB upper corners


def _morton3d(points: torch.Tensor, lo: torch.Tensor,
              inv_extent: torch.Tensor) -> torch.Tensor:
    """30-bit Morton code of each point over the [lo, lo+extent] box.
    Out-of-box points (e.g. SENTINEL-parked rows) clip to the boundary
    cells, which sorts them to the box corner."""
    u = torch.clamp((points - lo) * inv_extent, 0.0, 1.0)
    g = (u * 1023.0).to(torch.int32)                       # [N,3] 10 bits

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return (spread(g[:, 0]) | (spread(g[:, 1]) << 1)
            | (spread(g[:, 2]) << 2))


def _finite_bounds(points: torch.Tensor):
    """AABB over non-parked rows (|coord| < 1e5)."""
    finite = torch.all(torch.abs(points) < 1.0e5, dim=1, keepdim=True)
    big = torch.full_like(points, 3.0e5)
    lo = torch.amin(torch.where(finite, points, big), dim=0)
    hi = torch.amax(torch.where(finite, points, -big), dim=0)
    # Degenerate (all parked): fall back to a unit box.
    bad = lo[0] > hi[0]
    lo = torch.where(bad, torch.zeros_like(lo), lo)
    hi = torch.where(bad, torch.ones_like(hi), hi)
    return lo, hi


def _tile_aabbs(points_sorted: torch.Tensor, tile: int):
    n = points_sorted.shape[0] // tile
    p = points_sorted.reshape(n, tile, 3)
    return torch.amin(p, dim=1), torch.amax(p, dim=1)


def build_pruned_ref(ref_points: torch.Tensor, rb: int | None = None
                     ) -> PrunedRef:
    """Sort the reference by Morton code and record per-tile AABBs."""
    R = ref_points.shape[0]
    rb = _tile(R, rb or _RB)
    lo, hi = _finite_bounds(ref_points)
    inv = 1.0 / torch.clamp(hi - lo, min=1e-6)
    code = _morton3d(ref_points, lo, inv)
    perm = torch.argsort(code, stable=True)
    pts = ref_points[perm]
    tlo, thi = _tile_aabbs(pts, rb)
    return PrunedRef(points=pts, perm=perm.to(torch.int32),
                     tile_lo=tlo, tile_hi=thi)


def pruned_tables(queries: torch.Tensor, pref: PrunedRef, cutoff: float):
    """K2's plain-torch set-up, as pallas_nn.py:318-340.

    Returns (qperm [Q] int64, q_sorted [Q,3], order [nQ,nR] i32 — the
    ascending-bound visit order with the pruned suffix aliased to the last
    useful tile —, lb [nQ,nR] f32 — the sorted bounds, +inf beyond the
    cutoff —, qb, rb)."""
    Q = queries.shape[0]
    R = pref.points.shape[0]
    qb = _tile(Q, _QB)
    rb = R // pref.tile_lo.shape[0]
    nR = R // rb
    cutoff2 = float(cutoff) ** 2

    lo, hi = _finite_bounds(pref.points)
    inv = 1.0 / torch.clamp(hi - lo, min=1e-6)
    qperm = torch.argsort(_morton3d(queries, lo, inv), stable=True)
    q_sorted = queries[qperm]

    # Per-query-tile AABBs -> tile-pair lower bounds [nQ, nR], summed in
    # the kernel's order so each bound stays below every pair distance.
    q_lo, q_hi = _tile_aabbs(q_sorted, qb)
    gap = torch.clamp(torch.maximum(pref.tile_lo[None] - q_hi[:, None],
                                    q_lo[:, None] - pref.tile_hi[None]),
                      min=0.0)
    lb2 = (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]) \
        + gap[..., 2] * gap[..., 2]

    order = torch.argsort(lb2, dim=1, stable=True)
    lb_sorted = torch.gather(lb2, 1, order)
    keep = lb_sorted <= cutoff2
    cnt = torch.sum(keep, dim=1)
    jidx = torch.minimum(
        torch.arange(nR, device=queries.device)[None, :],
        torch.clamp(cnt - 1, min=0)[:, None])
    order_aliased = torch.gather(order, 1, jidx).to(torch.int32)
    lb_eff = torch.where(keep, lb_sorted, torch.full_like(lb_sorted,
                                                          float('inf')))
    return qperm, q_sorted, order_aliased, lb_eff, qb, rb


def nn_indices_pruned_plain(queries: torch.Tensor, pref: PrunedRef,
                            cutoff: float = 3.0):
    """Plain torch K2: brute force over ``pref.points`` with d2=inf for
    queries whose nearest point lies beyond ``cutoff``."""
    d2, idx = nn_indices_plain(queries, pref.points)
    d2 = torch.where(d2 <= float(cutoff) ** 2, d2,
                     torch.full_like(d2, float('inf')))
    return d2, idx


def nn_indices_pruned(queries: torch.Tensor, pref: PrunedRef,
                      cutoff: float = 3.0):
    """Radius-bounded exact NN against a :class:`PrunedRef`.

    Returns (d2 [Q] f32, idx [Q] i32) in the ORIGINAL query order; idx
    indexes the SORTED reference (``pref.points``) — gather payloads from
    arrays permuted by ``pref.perm``.  Exact for every query with a
    reference point within ``cutoff``; for the others d2 > cutoff^2 (the
    plain version reports inf, the kernel inf or the distance to a point
    of a visited tile), which ICP discards.  CPU tensors run
    :func:`nn_indices_pruned_plain`; CUDA tensors launch K2.
    """
    _check_points('nn_indices_pruned', queries=queries,
                  ref_points=pref.points)
    if queries.device.type == 'cpu' and pref.points.device.type == 'cpu':
        return nn_indices_pruned_plain(queries, pref, cutoff)
    device = _check_cuda('nn_indices_pruned', queries, pref.points)
    Q = queries.shape[0]
    if Q == 0:
        return (torch.empty(0, dtype=torch.float32, device=device),
                torch.empty(0, dtype=torch.int32, device=device))
    qperm, q_sorted, order, lb, qb, rb = pruned_tables(queries, pref,
                                                       cutoff)
    nQ, nR = order.shape
    d2_s = torch.empty(Q, dtype=torch.float32, device=device)
    idx_s = torch.empty(Q, dtype=torch.int32, device=device)
    err = _kernels().lsl_nn_indices_pruned(
        q_sorted.data_ptr(), pref.points.data_ptr(), order.data_ptr(),
        lb.data_ptr(), nQ, qb, rb, nR, float(cutoff) ** 2, d2_s.data_ptr(),
        idx_s.data_ptr(), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _check_launch('nn_indices_pruned', err)
    nn_indices_pruned.launches += 1
    d2 = torch.empty_like(d2_s)
    idx = torch.empty_like(idx_s)
    d2[qperm] = d2_s
    idx[qperm] = idx_s
    return d2, idx


nn_indices_pruned.launches = 0


def pruned_visits(queries: torch.Tensor, pref: PrunedRef,
                  cutoff: float = 3.0):
    """K2's walk replayed in plain torch: per query tile, the number of
    reference tiles the kernel scans ([nQ] int64), and the best d2 the
    walk reaches ([Q] f32, original query order).

    The replay follows ``nn_pruned_kernel`` step by step: it stops at the
    first bound >= cutoff^2 and skips a tile whose bound is >= the
    largest running best of its query tile.  The bests are the same
    coordinate-wise f32 distances as the kernel's, so the replay takes
    the kernel's decisions.  A measurement aid: no path of the port calls
    it."""
    qperm, q_sorted, order, lb, qb, rb = pruned_tables(queries, pref,
                                                       cutoff)
    nQ, nR = order.shape
    R = pref.points.shape[0]
    tile_min = torch.empty((q_sorted.shape[0], nR), dtype=torch.float32,
                           device=queries.device)
    for s, e in query_chunks(q_sorted.shape[0], R):
        tile_min[s:e] = torch.amin(sqdist(q_sorted[s:e], pref.points)
                                   .reshape(e - s, nR, rb), dim=2)
    tile_min = tile_min.reshape(nQ, qb, nR)
    best = torch.full((nQ, qb), float('inf'), device=queries.device)
    visits = torch.zeros(nQ, dtype=torch.int64, device=queries.device)
    blocks = torch.arange(nQ, device=queries.device)
    cutoff2 = float(cutoff) ** 2
    for j in range(nR):
        bound = lb[:, j]
        scan = (bound < cutoff2) & (bound < torch.amax(best, dim=1))
        step = tile_min[blocks, :, order[:, j].long()]
        best = torch.where(scan[:, None], torch.minimum(best, step), best)
        visits += scan
    d2 = torch.empty(queries.shape[0], dtype=torch.float32,
                     device=queries.device)
    d2[qperm] = best.reshape(-1)
    return visits, d2
