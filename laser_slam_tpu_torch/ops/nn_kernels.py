"""Exact 1-NN for ICP: hand-written CUDA kernels and their plain versions.

Counterpart of ``laser_slam_tpu/ops/pallas_nn.py``.  Two kernels, both
in ``csrc/nn.cu`` (see its header for the design and what bounds them):

* K1 ``nn_indices`` replaces the Pallas ``_nn_idx_kernel``: exact 1-NN of
  every query against every reference point.
* K2 ``nn_indices_pruned`` replaces the Pallas ``_nn_pruned_kernel``: the
  Morton-sorted, AABB-pruned, radius-bounded exact 1-NN that ICP uses by
  default (``IcpConfig.pallas_prune``).
* K1L ``nn_indices_lanes`` and K2L ``nn_indices_pruned_lanes`` launch the
  same two kernels over a lane axis: B independent problems [B,Q,3]
  against [B,R,3] in one launch, the fleet's ``vmap`` of the Pallas call
  in the JAX package.  Their plain versions are ``neighbors.
  nn_brute_lanes`` and a per-lane loop of :func:`nn_indices_pruned_plain`.

Both run one work item per (query tile, reference tile) on the card and
merge the items' results exactly: each query's result is a 64-bit key
``(f32 bits of d2) << 32 | idx`` that the items lower with ``atomicMin``
into a scratch array the wrapper fills with :data:`_INIT_KEY` (d2 = +inf,
idx = 0) before the launch; a second kernel splits the keys into (d2,
idx).  The least key is the least d2 with ties to the lowest index,
whatever order the items run in.

Each wrapper takes its plain torch version (a chunked coordinate-wise
brute force with ``min``, which returns the first index) when the tensors
lie on the CPU.  For CUDA tensors it launches its kernel, adds one to its
``launches`` counter, or raises: there is no fallback.  Distances are
coordinate-wise f32 ``(q-r)^2`` in both, never the ``|q|^2 - 2 q.r +
|r|^2`` expansion, which loses rank order at 50 m scene scale.

K2's pruning tables (Morton codes, tile AABBs, the [nQ, nR] lower
bounds, their stable argsort and the aliasing of the pruned suffix) are
plain XLA in the JAX package.  Their plain torch version,
:func:`pruned_tables`, keeps the JAX tile sizes and stable sorts, so
that the sorted-reference index and the visit order match it, and takes
a leading lane axis as it is: each lane's Morton box comes from its own
finite points, as under JAX's ``vmap``.  On the card :func:`pruned_setup`
builds the same tables, bit for bit, in two hand-written launches
(``csrc/nn.cu`` ``k2_sort_kernel`` and ``k2_tables_kernel``), from the
Morton box that :func:`build_pruned_ref` keeps; :func:`pruned_tables_by_
keys` is that algorithm in plain torch, which the tests hold to both.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from laser_slam_tpu_torch.ops.neighbors import (nn_brute, nn_brute_lanes,
                                                query_chunks, sqdist)

# Tile sizes of the JAX package (pallas_nn._QB/_RB).  K2's tables keep
# them: the reference tile is the unit of pruning and of the sorted index.
_QB = 256
_RB = 4096
# K2L's reference tile for lanes of at most _RB points.  At _RB such a
# lane is one tile, which nothing prunes; 1024-point tiles let K2L skip
# some (the 256-lane fleet of 4096-point scans on an H100, chip_smoke.py
# phase 12: 1.76 ms a call against 1.87, 91% of the pairs scanned).  The
# tile changes neither d2 nor idx: the sorted reference does not depend
# on it.
_RB_SMALL_LANES = 1024
# K1's work item on the card (csrc/nn.cu NN_QT x NN_K1_RT).
_K1_QT = 256
_K1_RT = 4096
# The merge key of (d2 = +inf, idx = 0): (0x7f800000 << 32) | 0.
_INIT_KEY = 0x7F800000 << 32
# K2's set-up on the card (csrc/nn.cu): the most queries a lane that one
# block sorts in shared memory (K2_SORT_KEYS; more take one torch.sort of
# their codes), and the most bounds a row that one block sorts
# (K2_TABLE_KEYS; more take one torch.sort of the bound keys).
_SORT_KEYS = 16384
_TABLE_KEYS = 4096


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
        lib.lsl_nn_indices.argtypes = [p, p, i, i, p, p, p, i, p]
        lib.lsl_nn_indices.restype = i
        lib.lsl_nn_indices_pruned.argtypes = [p, p, p, p, p, i, i, i, i, f,
                                              p, p, p, p, i, p]
        lib.lsl_nn_indices_pruned.restype = i
        lib.lsl_nn_indices_lanes.argtypes = [p, p, i, i, i, p, p, p, i, p]
        lib.lsl_nn_indices_lanes.restype = i
        lib.lsl_nn_indices_pruned_lanes.argtypes = [
            p, p, p, p, p, i, i, i, i, i, f, p, p, p, p, i, p]
        lib.lsl_nn_indices_pruned_lanes.restype = i
        lib.lsl_k2_sort.argtypes = [p, p, i, i, p, i, p]
        lib.lsl_k2_sort.restype = i
        lib.lsl_k2_codes.argtypes = [p, p, i, i, p, i, p]
        lib.lsl_k2_codes.restype = i
        lib.lsl_k2_tables.argtypes = [p, p, p, p, i, i, i, i, f, i, p, p, p,
                                      p, p, p, i, p]
        lib.lsl_k2_tables.restype = i
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


def _merge_keys(n: int, device: torch.device) -> torch.Tensor:
    """The kernels' scratch: n merge keys and the item counter after
    them, all :data:`_INIT_KEY` (filled on the current stream)."""
    return torch.full((n + 1,), _INIT_KEY, dtype=torch.int64, device=device)


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with cudaError_t '
                           f'{err}')


def _check_points(name: str, ndim: int = 2, **arrays) -> None:
    want = '[N,3]' if ndim == 2 else '[B,N,3]'
    for key, a in arrays.items():
        if a.dtype != torch.float32 or a.ndim != ndim or a.shape[-1] != 3:
            raise ValueError(f'{name}: {key} must be float32 {want}, got '
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
    keys = _merge_keys(Q, device)
    err = _kernels().lsl_nn_indices(
        queries.data_ptr(), ref_points.data_ptr(), Q, R, keys.data_ptr(),
        d2.data_ptr(), idx.data_ptr(), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _check_launch('nn_indices', err)
    nn_indices.launches += 1
    return d2, idx


nn_indices.launches = 0


def nn_indices_lanes_plain(queries: torch.Tensor, ref_points: torch.Tensor):
    """Plain torch K1L (``neighbors.nn_brute_lanes``): (d2 [B,Q] f32,
    idx [B,Q] i32 within the lane), ties to the lowest index."""
    idx, d2 = nn_brute_lanes(queries, ref_points)
    return d2, idx


def nn_indices_lanes(queries: torch.Tensor, ref_points: torch.Tensor):
    """:func:`nn_indices` of each lane: queries [B,Q,3] against
    ref_points [B,R,3], one launch for every lane.  Returns (d2 [B,Q] f32,
    idx [B,Q] i32, an index into the lane's reference).  CPU tensors run
    :func:`nn_indices_lanes_plain`; CUDA tensors launch K1L."""
    _check_points('nn_indices_lanes', 3, queries=queries,
                  ref_points=ref_points)
    if queries.shape[0] != ref_points.shape[0]:
        raise ValueError('nn_indices_lanes: queries and references need '
                         'the same lanes')
    if queries.device.type == 'cpu' and ref_points.device.type == 'cpu':
        return nn_indices_lanes_plain(queries, ref_points)
    device = _check_cuda('nn_indices_lanes', queries, ref_points)
    B, Q = queries.shape[:2]
    R = ref_points.shape[1]
    d2 = torch.empty((B, Q), dtype=torch.float32, device=device)
    idx = torch.empty((B, Q), dtype=torch.int32, device=device)
    if B * Q == 0:
        return d2, idx
    if R == 0:
        raise ValueError('nn_indices_lanes: empty reference')
    keys = _merge_keys(B * Q, device)
    err = _kernels().lsl_nn_indices_lanes(
        queries.data_ptr(), ref_points.data_ptr(), B, Q, R, keys.data_ptr(),
        d2.data_ptr(), idx.data_ptr(), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _check_launch('nn_indices_lanes', err)
    nn_indices_lanes.launches += 1
    return d2, idx


nn_indices_lanes.launches = 0


# --------------------------------------------------------------------------
# K2: Morton-pruned radius-bounded exact 1-NN
# --------------------------------------------------------------------------

class PrunedRef(NamedTuple):
    """Morton-sorted reference with per-tile AABBs (build once per
    reference cloud; reuse across ICP iterations and readings).  Over
    lanes every field has a leading [B] axis."""
    points: torch.Tensor    # [R,3] sorted copy of the reference points
    perm: torch.Tensor      # [R] i32: sorted row -> original row
    tile_lo: torch.Tensor   # [nR,3] per-tile AABB lower corners
    tile_hi: torch.Tensor   # [nR,3] per-tile AABB upper corners
    # [3,3] the Morton box of the queries' codes: the finite lower and
    # upper corners (``_finite_bounds``) and 1 / max(hi - lo, 1e-6).  K2
    # on the card needs it; a reference made without it runs on the CPU.
    box: torch.Tensor | None = None

    def lane(self, b: int) -> 'PrunedRef':
        """Lane b of a lane-axis reference."""
        return PrunedRef(*(None if a is None else a[b] for a in self))


def _morton3d(points: torch.Tensor, lo: torch.Tensor,
              inv_extent: torch.Tensor) -> torch.Tensor:
    """30-bit Morton code of each point over the [lo, lo+extent] box.
    Out-of-box points (e.g. SENTINEL-parked rows) clip to the boundary
    cells, which sorts them to the box corner."""
    u = torch.clamp((points - lo) * inv_extent, 0.0, 1.0)
    g = (u * 1023.0).to(torch.int32)                     # [...,N,3] 10 bits

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return (spread(g[..., 0]) | (spread(g[..., 1]) << 1)
            | (spread(g[..., 2]) << 2))


def _finite_bounds(points: torch.Tensor):
    """AABB over non-parked rows (|coord| < 1e5), per lane."""
    finite = torch.all(torch.abs(points) < 1.0e5, dim=-1, keepdim=True)
    big = torch.full_like(points, 3.0e5)
    lo = torch.amin(torch.where(finite, points, big), dim=-2)
    hi = torch.amax(torch.where(finite, points, -big), dim=-2)
    # Degenerate (all parked): fall back to a unit box.
    bad = (lo[..., 0] > hi[..., 0])[..., None]
    lo = torch.where(bad, torch.zeros_like(lo), lo)
    hi = torch.where(bad, torch.ones_like(hi), hi)
    return lo, hi


def _morton_box(points: torch.Tensor) -> torch.Tensor:
    """[...,3,3]: the finite box of the points (lo, hi) and its inverse
    extent, the Morton frame of K2's codes (pallas_nn.py:316-317)."""
    lo, hi = _finite_bounds(points)
    inv = 1.0 / torch.clamp(hi - lo, min=1e-6)
    return torch.stack([lo, hi, inv], dim=-2)


def _tile_aabbs(points_sorted: torch.Tensor, tile: int):
    n = points_sorted.shape[-2] // tile
    p = points_sorted.reshape(points_sorted.shape[:-2] + (n, tile, 3))
    return torch.amin(p, dim=-2), torch.amax(p, dim=-2)


def _rows_of(points: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """points[perm] within each lane: [...,N,3] gathered by [...,N]."""
    if points.dim() == 2:
        return points[perm]
    return torch.gather(points, -2, perm[..., None].expand(points.shape))


def build_pruned_ref(ref_points: torch.Tensor, rb: int | None = None
                     ) -> PrunedRef:
    """Sort the reference [R,3] (or each lane of [B,R,3]) by Morton code
    and record per-tile AABBs."""
    R = ref_points.shape[-2]
    rb = _tile(R, rb or _RB)
    box = _morton_box(ref_points)
    code = _morton3d(ref_points, box[..., 0:1, :], box[..., 2:3, :])
    perm = torch.argsort(code, dim=-1, stable=True)
    pts = _rows_of(ref_points, perm)
    tlo, thi = _tile_aabbs(pts, rb)
    return PrunedRef(points=pts, perm=perm.to(torch.int32),
                     tile_lo=tlo, tile_hi=thi, box=box)


def _tile_bounds(q_sorted: torch.Tensor, pref: PrunedRef, qb: int):
    """Per-query-tile AABBs -> tile-pair lower bounds [..., nQ, nR],
    summed in the kernel's order so each bound stays below every pair
    distance."""
    q_lo, q_hi = _tile_aabbs(q_sorted, qb)
    gap = torch.clamp(torch.maximum(
        pref.tile_lo[..., None, :, :] - q_hi[..., :, None, :],
        q_lo[..., :, None, :] - pref.tile_hi[..., None, :, :]), min=0.0)
    return (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]) \
        + gap[..., 2] * gap[..., 2]


def _aliased(lb_sorted: torch.Tensor, order: torch.Tensor, cutoff2: float):
    """The visit order with the suffix past the cutoff aliased to the last
    useful tile, and the bounds with that suffix +inf."""
    nR = order.shape[-1]
    keep = lb_sorted <= cutoff2
    cnt = torch.sum(keep, dim=-1)
    jidx = torch.minimum(
        torch.arange(nR, device=order.device),
        torch.clamp(cnt - 1, min=0)[..., None])
    order_aliased = torch.gather(order, -1, jidx).to(torch.int32)
    lb_eff = torch.where(keep, lb_sorted, torch.full_like(lb_sorted,
                                                          float('inf')))
    return order_aliased, lb_eff


def pruned_tables(queries: torch.Tensor, pref: PrunedRef, cutoff: float):
    """K2's plain-torch set-up, as pallas_nn.py:318-340.

    Returns (qperm [Q] int64, q_sorted [Q,3], order [nQ,nR] i32 — the
    ascending-bound visit order with the pruned suffix aliased to the last
    useful tile —, lb [nQ,nR] f32 — the sorted bounds, +inf beyond the
    cutoff —, qb, rb); over lanes ([B,Q,3] queries and a lane-axis
    ``pref``) each array gets a leading [B] axis."""
    Q = queries.shape[-2]
    R = pref.points.shape[-2]
    qb = _tile(Q, _QB)
    rb = R // pref.tile_lo.shape[-2]
    cutoff2 = float(cutoff) ** 2

    lo, hi = _finite_bounds(pref.points)
    inv = 1.0 / torch.clamp(hi - lo, min=1e-6)
    qperm = torch.argsort(_morton3d(queries, lo[..., None, :],
                                    inv[..., None, :]), dim=-1, stable=True)
    q_sorted = _rows_of(queries, qperm)
    lb2 = _tile_bounds(q_sorted, pref, qb)

    order = torch.argsort(lb2, dim=-1, stable=True)
    lb_sorted = torch.gather(lb2, -1, order)
    return (qperm, q_sorted, *_aliased(lb_sorted, order, cutoff2), qb, rb)


def pruned_tables_by_keys(queries: torch.Tensor, pref: PrunedRef,
                          cutoff: float):
    """:func:`pruned_tables` by the algorithm of the card's set-up
    (:func:`pruned_setup`), in plain torch: the Morton box kept in
    ``pref.box``, one sort of packed ``code << 32 | row`` keys (the row
    breaks ties, so it is the stable argsort), and one sort a row of
    ``lb bits << 32 | j`` keys (lb >= +0, so its bits order like the
    float; every NaN one key, last).  Equal to :func:`pruned_tables` bit
    for bit; the tests hold it so, and no path calls it."""
    Q = queries.shape[-2]
    R = pref.points.shape[-2]
    nR = pref.tile_lo.shape[-2]
    qb, rb = _tile(Q, _QB), R // nR
    dev = queries.device
    code = _morton3d(queries, pref.box[..., 0:1, :], pref.box[..., 2:3, :])
    keys = torch.sort((code.to(torch.int64) << 32)
                      | torch.arange(Q, device=dev)).values
    qperm = keys & 0xFFFFFFFF
    q_sorted = _rows_of(queries, qperm)
    lb2 = _tile_bounds(q_sorted, pref, qb)
    bits = torch.where(torch.isnan(lb2), 0x7FFFFFFF,
                       lb2.view(torch.int32)).to(torch.int64)
    lkeys = torch.sort((bits << 32) | torch.arange(nR, device=dev)).values
    lb_sorted = (lkeys >> 32).to(torch.int32).view(torch.float32)
    order = lkeys & 0xFFFFFFFF
    return (qperm, q_sorted,
            *_aliased(lb_sorted, order, float(cutoff) ** 2), qb, rb)


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
    reference point within ``cutoff`` (d2 bit-equal to the plain version,
    idx a point at that d2); for the others d2 > cutoff^2 (the plain
    version reports inf, the kernel inf or the distance to a point of a
    tile it scanned), which ICP discards.  CPU tensors run
    :func:`nn_indices_pruned_plain`; CUDA tensors build the tables on the
    card (:func:`pruned_setup`) and launch K2 (:func:`_launch_pruned`).
    """
    _check_points('nn_indices_pruned', queries=queries,
                  ref_points=pref.points)
    if queries.device.type == 'cpu' and pref.points.device.type == 'cpu':
        return nn_indices_pruned_plain(queries, pref, cutoff)
    device = _check_cuda('nn_indices_pruned', queries, pref.points)
    if queries.shape[0] == 0:
        return (torch.empty(0, dtype=torch.float32, device=device),
                torch.empty(0, dtype=torch.int32, device=device))
    tables, keys, rows = pruned_setup(queries, pref, cutoff)
    return _launch_pruned(tables, pref, cutoff, keys=keys, rows=rows)


def pruned_setup(queries: torch.Tensor, pref: PrunedRef, cutoff: float):
    """K2's set-up on the card: the tables of :func:`pruned_tables`, bit
    for bit, by the algorithm of :func:`pruned_tables_by_keys`.

    Queries [Q,3] (or [B,Q,3] against a lane-axis ``pref``), CUDA only.
    The query sort is ``k2_sort_kernel`` (one block a lane, in shared
    memory) for at most 16384 queries a lane, else ``k2_codes_kernel``
    and one stable ``torch.sort`` of the codes: the size picks the route.
    Then ``k2_tables_kernel`` writes the sorted rows, the order and the
    bounds, and empties the merge keys; rows of more than 4096 bounds
    (reference tiles of a few points) are sorted by one ``torch.sort``
    between two of its launches.  Returns (tables as
    :func:`pruned_tables`, keys [B*Q + 1] of :data:`_INIT_KEY`, rows: the
    flat output row of each sorted query over lanes, else None)."""
    lanes = queries.dim() == 3
    name = 'nn_indices_pruned_lanes' if lanes else 'nn_indices_pruned'
    if pref.box is None:
        raise ValueError(f'{name}: the reference has no Morton box; build '
                         'it with build_pruned_ref')
    device = _check_cuda(name, queries, pref.points, pref.tile_lo,
                         pref.tile_hi, pref.box)
    B = queries.shape[0] if lanes else 1
    Q = queries.shape[-2]
    R = pref.points.shape[-2]
    nR = pref.tile_lo.shape[-2]
    qb, rb = _tile(Q, _QB), R // nR
    nQ = Q // qb
    lib = _kernels()
    stream = torch.cuda.current_stream(device).cuda_stream
    lead = queries.shape[:-2]
    if Q <= _SORT_KEYS:
        qperm = torch.empty(lead + (Q,), dtype=torch.int64, device=device)
        _check_launch(name, lib.lsl_k2_sort(
            queries.data_ptr(), pref.box.data_ptr(), B, Q, qperm.data_ptr(),
            device.index, stream))
    else:
        codes = torch.empty(lead + (Q,), dtype=torch.int32, device=device)
        _check_launch(name, lib.lsl_k2_codes(
            queries.data_ptr(), pref.box.data_ptr(), B, Q, codes.data_ptr(),
            device.index, stream))
        qperm = torch.sort(codes, dim=-1, stable=True).indices
    q_sorted = torch.empty_like(queries)
    order = torch.empty(lead + (nQ, nR), dtype=torch.int32, device=device)
    lb = torch.empty(lead + (nQ, nR), dtype=torch.float32, device=device)
    keys = torch.empty(B * Q + 1, dtype=torch.int64, device=device)
    rows = (torch.empty(B * Q, dtype=torch.int64, device=device) if lanes
            else None)

    def tables(stage, lb_keys=None):
        _check_launch(name, lib.lsl_k2_tables(
            queries.data_ptr(), qperm.data_ptr(), pref.tile_lo.data_ptr(),
            pref.tile_hi.data_ptr(), B, Q, qb, nR, float(cutoff) ** 2, stage,
            q_sorted.data_ptr(), order.data_ptr(), lb.data_ptr(),
            keys.data_ptr(), None if rows is None else rows.data_ptr(),
            None if lb_keys is None else lb_keys.data_ptr(), device.index,
            stream))

    if nR <= _TABLE_KEYS:
        tables(0)
    else:
        lb_keys = torch.empty((B * nQ, nR), dtype=torch.int64, device=device)
        tables(1, lb_keys)
        tables(2, torch.sort(lb_keys, dim=-1).values)
    return (qperm, q_sorted, order, lb, qb, rb), keys, rows


def _launch_pruned(tables, pref: PrunedRef, cutoff: float,
                   scanned: torch.Tensor | None = None,
                   keys: torch.Tensor | None = None,
                   rows: torch.Tensor | None = None):
    """Launch K2 on the tables of :func:`pruned_tables` or
    :func:`pruned_setup` and unsort its results on the card: (d2 [Q], idx
    [Q]) in the original query order.  Tables with a lane axis (and a
    lane-axis ``pref``) launch K2L and return [B,Q] results.  ``keys``
    and ``rows`` come from :func:`pruned_setup`; without them the merge
    keys are filled here and the flat rows of lanes computed in torch.

    ``scanned``, an int32 tensor of zeros shaped like ``order[..., 0]``,
    receives the number of reference points the kernel scanned for each
    query tile (which tiles it scans depends on block timing; the results
    do not)."""
    qperm, q_sorted, order, lb, qb, rb = tables
    lanes = q_sorted.dim() == 3
    name = 'nn_indices_pruned_lanes' if lanes else 'nn_indices_pruned'
    extra = () if scanned is None else (scanned,)
    device = _check_cuda(name, q_sorted, pref.points, order, lb, qperm,
                         *extra)
    B = q_sorted.shape[0] if lanes else 1
    Q = q_sorted.shape[-2]
    nR = order.shape[-1]
    if scanned is not None and (scanned.dtype != torch.int32
                                or scanned.shape != order.shape[:-1]):
        raise ValueError(f'{name}: scanned must be int32 {order.shape[:-1]}')
    if keys is None:
        keys = _merge_keys(B * Q, device)
    d2 = torch.empty(q_sorted.shape[:-1], dtype=torch.float32, device=device)
    idx = torch.empty(q_sorted.shape[:-1], dtype=torch.int32, device=device)
    if rows is not None:
        qperm = rows
    elif lanes:
        # Rows of the flat [B*Q] output.
        qperm = (qperm + Q * torch.arange(B, device=device)[:, None]
                 ).contiguous()
    lane_args = (B,) if lanes else ()
    launch = (_kernels().lsl_nn_indices_pruned_lanes if lanes
              else _kernels().lsl_nn_indices_pruned)
    err = launch(
        q_sorted.data_ptr(), pref.points.data_ptr(), order.data_ptr(),
        lb.data_ptr(), qperm.data_ptr(), *lane_args, Q, qb, rb, nR,
        float(cutoff) ** 2, keys.data_ptr(),
        None if scanned is None else scanned.data_ptr(), d2.data_ptr(),
        idx.data_ptr(), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _check_launch(name, err)
    if lanes:
        nn_indices_pruned_lanes.launches += 1
    else:
        nn_indices_pruned.launches += 1
    return d2, idx


nn_indices_pruned.launches = 0


def build_pruned_ref_lanes(ref_points: torch.Tensor,
                           rb: int | None = None) -> PrunedRef:
    """:func:`build_pruned_ref` of each lane of [B,R,3]: every field of the
    :class:`PrunedRef` gets a leading [B] axis, and each lane is sorted
    over its own Morton box.  Lanes of at most 4096 points, a multiple of
    1024, take 1024-point reference tiles unless ``rb`` says otherwise
    (:data:`_RB_SMALL_LANES`)."""
    _check_points('build_pruned_ref_lanes', 3, ref_points=ref_points)
    R = ref_points.shape[-2]
    if rb is None and R <= _RB and R % _RB_SMALL_LANES == 0:
        rb = _RB_SMALL_LANES
    return build_pruned_ref(ref_points, rb)


def pruned_tables_lanes(queries: torch.Tensor, pref: PrunedRef,
                        cutoff: float):
    """:func:`pruned_tables` of each lane (queries [B,Q,3], a
    :func:`build_pruned_ref_lanes` reference): one set of torch launches
    for all B lanes."""
    _check_points('pruned_tables_lanes', 3, queries=queries,
                  ref_points=pref.points)
    return pruned_tables(queries, pref, cutoff)


def nn_indices_pruned_lanes_plain(queries: torch.Tensor, pref: PrunedRef,
                                  cutoff: float = 3.0):
    """Plain torch K2L: :func:`nn_indices_pruned_plain` lane by lane."""
    out = [nn_indices_pruned_plain(queries[b], pref.lane(b), cutoff)
           for b in range(queries.shape[0])]
    return (torch.stack([d for d, _ in out]),
            torch.stack([i for _, i in out]))


def nn_indices_pruned_lanes(queries: torch.Tensor, pref: PrunedRef,
                            cutoff: float = 3.0):
    """:func:`nn_indices_pruned` of each lane: queries [B,Q,3] against a
    :func:`build_pruned_ref_lanes` reference, one launch for every lane.
    Returns (d2 [B,Q], idx [B,Q]) in each lane's original query order; idx
    indexes the lane's SORTED reference (``pref.points[b]``).  CPU tensors
    run :func:`nn_indices_pruned_lanes_plain`; CUDA tensors build the
    tables of every lane on the card (:func:`pruned_setup`, the same
    launches for all lanes) and launch K2L.
    """
    _check_points('nn_indices_pruned_lanes', 3, queries=queries,
                  ref_points=pref.points)
    if queries.shape[0] != pref.points.shape[0]:
        raise ValueError('nn_indices_pruned_lanes: queries and references '
                         'need the same lanes')
    if queries.device.type == 'cpu' and pref.points.device.type == 'cpu':
        return nn_indices_pruned_lanes_plain(queries, pref, cutoff)
    device = _check_cuda('nn_indices_pruned_lanes', queries, pref.points)
    if queries.shape[0] * queries.shape[1] == 0:
        return (torch.empty(queries.shape[:2], dtype=torch.float32,
                            device=device),
                torch.empty(queries.shape[:2], dtype=torch.int32,
                            device=device))
    tables, keys, rows = pruned_setup(queries, pref, cutoff)
    return _launch_pruned(tables, pref, cutoff, keys=keys, rows=rows)


nn_indices_pruned_lanes.launches = 0


def pruned_visits(queries: torch.Tensor, pref: PrunedRef,
                  cutoff: float = 3.0):
    """The Pallas kernel's walk replayed in plain torch: per query tile,
    the number of reference tiles that ``_nn_pruned_kernel`` scans ([nQ]
    int64), and the best d2 the walk reaches ([Q] f32, original query
    order).

    The replay follows the Pallas grid step by step (pallas_nn.py:273-
    274): each query tile walks its row of the tables in order, stops at
    the first bound >= cutoff^2 and skips a tile whose bound is >= the
    largest running best of the query tile.  This fixed walk is the work
    that K2's bound counts.  K2 on the card scans other tiles, in parallel
    and pruned by the bests merged so far (``_launch_pruned``'s
    ``scanned``), so its share varies from call to call.  A measurement
    aid: no path of the port calls it."""
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
