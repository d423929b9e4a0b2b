"""The exact-NN kernel shootout's variants: hand-written CUDA kernels and
their plain versions.

Counterpart of the Pallas kernels in ``experiments/pallas_nn_variants.py``,
``experiments/pallas_tile_sweep.py`` and
``experiments/pallas_payload_variants.py``.  Four kernels, all in
``csrc/nn_variants.cu`` (its header gives the design and what bounds
each on the card):

* E5/E1 :func:`nn_indices_mm` — matmul-form index 1-NN: the score
  ``[q,1]·[-2r,|r|^2]`` at precision ``'highest'`` (f32 FMAs, E5 and E1 at
  ``HIGHEST``) or ``'bf16'`` (operands rounded to bf16, tensor-core
  product, f32 accumulate: E1 at ``DEFAULT``, one bf16 pass);
  ``d2 = max(score + |q|^2, 0)``.
* E4 :func:`nn_payload` — the same scores; returns the winner's payload
  row.  Exactly tied minima inside one 2048-wide reference tile are
  averaged (the Pallas one-hot / count); across tiles a strict ``<``.
* E6 :func:`nn_payload_pruned` — E4's function over E6's own
  Morton-sorted queries and reference (1024-wide reference tiles),
  visiting the reference tiles of each 256-query tile in E6's rotated
  order and skipping a tile whose box bound reaches the tile's largest
  best.
* E2/E3 :func:`nn_vpu` / :func:`nn_indices_tiled` — K1's coordinate-wise
  exact 1-NN at a chosen (query tile, reference tile); E2 is the
  (256, 2048) instance.  Its plain version is K1's.

Each wrapper takes its plain torch version when the tensors lie on the
CPU; for CUDA tensors it launches its kernel and adds one to its
``launches`` counter, or raises.  The Morton sort, the tile boxes and the
unsort of E6 are plain torch, as they are plain XLA in the JAX code.

Within a tile the Pallas index kernels take the lowest column on ties and
across tiles a strict ``<``; for an index that is the lowest index of the
global minimum, whatever the tile width, which is what the plain versions
and the kernels compute.  Tile width matters only where payloads of tied
rows are averaged (E4, E6) and in E6's visit order.

The float64 checks at the end (``check_*``) hold two results of one
function to each other and to float64; ``chip_smoke.py`` and the tests
use them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from laser_slam_tpu_torch.ops.neighbors import query_chunks
from laser_slam_tpu_torch.ops.nn_kernels import (_check_cuda, _check_launch,
                                                 _check_points, _tile,
                                                 nn_indices_plain)

# Tile sizes of the experiment kernels (pallas_payload_variants._QB/_RB,
# and the 1024-wide reference tile of nn_payload_pruned).
_QB = 256
_RB = 2048
_RB_PRUNED = 1024
# Widest payload row the kernels keep in registers.
MAX_PAYLOAD = 8
# Rows with a coordinate this large are parked (cloud.SENTINEL = 1e6).
_PARKED = 1.0e5

PRECISIONS = ('highest', 'bf16')

_lib = None


def _kernels() -> ctypes.CDLL:
    """Build (first use only) and bind the kernels of
    ``csrc/nn_variants.cu``."""
    global _lib
    if _lib is None:
        from laser_slam_tpu_torch.ops.cuda_build import load_library
        lib = load_library('nn_variants.cu')
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lsl_mm_indices.argtypes = [p, p, i, i, i, p, p, i, p]
        lib.lsl_mm_payload.argtypes = [p, p, p, i, i, i, i, p, p, i, p]
        lib.lsl_mm_payload_pruned.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                              i, i, i, p, p, p, i, p]
        lib.lsl_nn_tiled.argtypes = [p, p, i, i, i, i, p, p, i, p]
        for fn in (lib.lsl_mm_indices, lib.lsl_mm_payload,
                   lib.lsl_mm_payload_pruned, lib.lsl_nn_tiled):
            fn.restype = i
        _lib = lib
    return _lib


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == 'cpu' for t in tensors)


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full f32; refuses to run where TF32 is switched on (it
    keeps about three decimal digits and would change the rank order)."""
    if a.is_cuda and torch.get_float32_matmul_precision() != 'highest':
        raise RuntimeError('f32 matmul precision must be "highest" (TF32 '
                           'is on)')
    return a @ b


# --------------------------------------------------------------------------
# The extended rows of the matmul form
# --------------------------------------------------------------------------

def extend_queries(queries: torch.Tensor) -> torch.Tensor:
    """[Q,4] rows ``(x, y, z, 1)`` (the non-zero columns of the Pallas
    ``q_ext``)."""
    return torch.cat([queries, torch.ones_like(queries[:, :1])], dim=1)


def extend_reference(ref_points: torch.Tensor) -> torch.Tensor:
    """[R,4] rows ``(-2x, -2y, -2z, |r|^2)``: ``q_ext · r_ext`` is
    ``|q-r|^2 - |q|^2``."""
    return torch.cat([-2.0 * ref_points,
                      torch.sum(ref_points * ref_points, dim=1,
                                keepdim=True)], dim=1).contiguous()


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and back to f32, as the bf16 variant
    rounds its operands."""
    return x.to(torch.bfloat16).to(torch.float32)


def query_norm2(queries: torch.Tensor) -> torch.Tensor:
    return torch.sum(queries * queries, dim=1)


# f32 units of roundoff (2^-24 each) of a query's term sum that one f32
# evaluation of its matmul-form d2 may lie from the float64 value of the
# same operands: to first order the three FMAs of the score and the |q|^2
# sum each err by at most one unit of the terms they add.
SCORE_ULPS = 4.0


def score_tolerance(queries: torch.Tensor,
                    winners: torch.Tensor) -> torch.Tensor:
    """[Q] float64 limit on how far one f32 evaluation of each query's
    matmul-form d2 may lie from its float64 value: ``SCORE_ULPS`` units of
    roundoff of the sum of the magnitudes of its terms against its own
    winner r, ``|q|^2 + 2 sum_k |q_k r_k| + |r|^2``.  About 2.3e-3 m^2 for
    a query 50 m from the origin, 9e-5 m^2 at 10 m."""
    q, r = queries.double(), winners.double()
    mag = (torch.sum(q * q, dim=1) + 2.0 * torch.sum(torch.abs(q * r), dim=1)
           + torch.sum(r * r, dim=1))
    return SCORE_ULPS * 2.0 ** -24 * mag


# --------------------------------------------------------------------------
# E5 / E1: matmul-form index 1-NN
# --------------------------------------------------------------------------

def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f'precision must be one of {PRECISIONS}, got '
                         f'{precision!r}')


def mm_scores(q_ext: torch.Tensor, r_ext: torch.Tensor,
              precision: str) -> tuple:
    """(q_ext, r_ext) as the product sees them: f32, or rounded to bf16."""
    _check_precision(precision)
    if precision == 'bf16':
        return round_bf16(q_ext), round_bf16(r_ext)
    return q_ext, r_ext


def nn_indices_mm_plain(queries: torch.Tensor, ref_points: torch.Tensor,
                        precision: str = 'highest'):
    """Plain torch E5/E1: chunked ``torch.matmul`` of the extended rows
    (bf16: both operands rounded first, so the TPU's rank errors are
    reproduced), ``min`` with the lowest index on ties.  Returns
    (d2 [Q] f32, idx [Q] i32)."""
    q_ext, r_ext = mm_scores(extend_queries(queries),
                             extend_reference(ref_points), precision)
    Q = queries.shape[0]
    score = torch.empty(Q, dtype=torch.float32, device=queries.device)
    idx = torch.empty(Q, dtype=torch.int32, device=queries.device)
    for s, e in query_chunks(Q, ref_points.shape[0]):
        m, i = torch.min(_f32_matmul(q_ext[s:e], r_ext.T), dim=1)
        score[s:e] = m
        idx[s:e] = i.to(torch.int32)
    return torch.clamp(score + query_norm2(queries), min=0.0), idx


def nn_indices_mm(queries: torch.Tensor, ref_points: torch.Tensor,
                  precision: str = 'highest'):
    """For each query, (d2, index) of its nearest reference point by the
    matmul-form score at ``precision`` (``'highest'``: f32, E5; ``'bf16'``:
    one bf16 pass with f32 accumulate, E1 at ``DEFAULT``).

    queries [Q,3], ref_points [R,3] f32; park invalid rows at
    cloud.SENTINEL.  Returns (d2 [Q] f32, idx [Q] i32).  CPU tensors run
    :func:`nn_indices_mm_plain`; CUDA tensors launch the kernel and count
    it in ``nn_indices_mm.launches`` (highest) or
    ``nn_indices_mm.launches_bf16``.
    """
    _check_points('nn_indices_mm', queries=queries, ref_points=ref_points)
    _check_precision(precision)
    if _on_cpu(queries, ref_points):
        return nn_indices_mm_plain(queries, ref_points, precision)
    device = _check_cuda('nn_indices_mm', queries, ref_points)
    Q, R = queries.shape[0], ref_points.shape[0]
    if R == 0:
        raise ValueError('nn_indices_mm: empty reference')
    r_ext = extend_reference(ref_points)
    score = torch.empty(Q, dtype=torch.float32, device=device)
    idx = torch.empty(Q, dtype=torch.int32, device=device)
    if Q:
        err = _kernels().lsl_mm_indices(
            queries.data_ptr(), r_ext.data_ptr(), Q, R,
            int(precision == 'bf16'), score.data_ptr(), idx.data_ptr(),
            device.index, _stream(device))
        _check_launch('nn_indices_mm', err)
        if precision == 'bf16':
            nn_indices_mm.launches_bf16 += 1
        else:
            nn_indices_mm.launches += 1
    return torch.clamp(score + query_norm2(queries), min=0.0), idx


nn_indices_mm.launches = 0
nn_indices_mm.launches_bf16 = 0


# --------------------------------------------------------------------------
# E4: payload 1-NN with tie averaging inside a reference tile
# --------------------------------------------------------------------------

def _check_payload(name: str, ref_points: torch.Tensor,
                   payload: torch.Tensor) -> None:
    if (payload.dtype != torch.float32 or payload.ndim != 2
            or payload.shape[0] != ref_points.shape[0]
            or not 1 <= payload.shape[1] <= MAX_PAYLOAD):
        raise ValueError(f'{name}: payload must be float32 [R,P] with '
                         f'1 <= P <= {MAX_PAYLOAD}, got {payload.dtype} '
                         f'{tuple(payload.shape)} for R='
                         f'{ref_points.shape[0]}')


def _payload_plain(q_ext: torch.Tensor, r_ext: torch.Tensor,
                   payload: torch.Tensor, rb: int, visit=None, qb: int = 1):
    """Tile-wise payload 1-NN on extended rows.  Per query: each rb-wide
    tile's minimum score; the winning tile is the first, in visit order,
    that attains the least of them (a strict ``<`` across tiles); its
    payload is the mean over the rows that attain the minimum, weighted
    ``1/count`` as the Pallas one-hot is.  ``visit`` [nQ, nT] gives each
    qb-query tile's visit order (default: ascending).  Returns
    (score [Q], payload [Q,P])."""
    Q, R, P = q_ext.shape[0], r_ext.shape[0], payload.shape[1]
    nT = R // rb
    dev = q_ext.device
    score = torch.empty(Q, dtype=torch.float32, device=dev)
    out = torch.zeros((Q, P), dtype=torch.float32, device=dev)
    pay_t = payload.reshape(nT, rb, P)
    for s, e in query_chunks(Q, R):
        sc = _f32_matmul(q_ext[s:e], r_ext.T).reshape(e - s, nT, rb)
        tile_min = torch.amin(sc, dim=2)                       # [c, nT]
        if visit is None:
            t = torch.argmin(tile_min, dim=1)
        else:
            order = visit[torch.arange(s, e, device=dev) // qb].long()
            t = torch.gather(order, 1, torch.argmin(
                torch.gather(tile_min, 1, order), dim=1, keepdim=True))[:, 0]
        rows = torch.arange(e - s, device=dev)
        best = tile_min[rows, t]
        hit = sc[rows, t] <= best[:, None]                     # [c, rb]
        w = 1.0 / torch.sum(hit, dim=1).to(torch.float32)
        r_i, c_i = torch.nonzero(hit, as_tuple=True)
        out[s:e].index_add_(0, r_i, w[r_i, None] * pay_t[t[r_i], c_i])
        score[s:e] = best
    return score, out


def nn_payload_plain(queries: torch.Tensor, ref_points: torch.Tensor,
                     payload: torch.Tensor):
    """Plain torch E4: (d2 [Q] f32, payload [Q,P])."""
    rb = _tile(ref_points.shape[0], _RB)
    score, pay = _payload_plain(extend_queries(queries),
                                extend_reference(ref_points), payload, rb)
    return torch.clamp(score + query_norm2(queries), min=0.0), pay


def nn_payload(queries: torch.Tensor, ref_points: torch.Tensor,
               payload: torch.Tensor):
    """For each query, the squared distance to, and the payload row of,
    its nearest reference point by the f32 matmul-form score; exactly
    tied minima inside one ``_tile(R, 2048)``-wide reference tile are
    averaged.

    queries [Q,3], ref_points [R,3], payload [R,P] f32 (P <= 8).  Returns
    (d2 [Q] f32, payload [Q,P] f32).  CPU tensors run
    :func:`nn_payload_plain`; CUDA tensors launch the kernel.
    """
    _check_points('nn_payload', queries=queries, ref_points=ref_points)
    _check_payload('nn_payload', ref_points, payload)
    if _on_cpu(queries, ref_points, payload):
        return nn_payload_plain(queries, ref_points, payload)
    device = _check_cuda('nn_payload', queries, ref_points, payload)
    Q, R, P = queries.shape[0], ref_points.shape[0], payload.shape[1]
    if R == 0:
        raise ValueError('nn_payload: empty reference')
    r_ext = extend_reference(ref_points)
    score = torch.empty(Q, dtype=torch.float32, device=device)
    out = torch.empty((Q, P), dtype=torch.float32, device=device)
    if Q:
        err = _kernels().lsl_mm_payload(
            queries.data_ptr(), r_ext.data_ptr(), payload.data_ptr(), Q, R,
            P, _tile(R, _RB), score.data_ptr(), out.data_ptr(),
            device.index, _stream(device))
        _check_launch('nn_payload', err)
        nn_payload.launches += 1
    return torch.clamp(score + query_norm2(queries), min=0.0), out


nn_payload.launches = 0


# --------------------------------------------------------------------------
# E6: Morton-sorted, box-pruned payload 1-NN
# --------------------------------------------------------------------------

def _spread_bits10(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_order(points: torch.Tensor) -> torch.Tensor:
    """E6's own Morton permutation (pallas_payload_variants.morton_order,
    not K2's): bounds over the cloud's own non-parked rows, codes
    ``clip((p - lo) * inv * 1023, 0, 1023)``, parked rows (|coord| >= 1e5)
    coded 2^30 so they sort last, and a stable sort."""
    valid = torch.all(torch.abs(points) < _PARKED, dim=1, keepdim=True)
    inf = torch.full_like(points, float('inf'))
    pts = torch.where(valid, points, torch.zeros_like(points))
    lo = torch.amin(torch.where(valid, points, inf), dim=0)
    hi = torch.amax(torch.where(valid, points, -inf), dim=0)
    inv = 1.0 / torch.clamp(hi - lo, min=1e-6)
    u = torch.clamp((pts - lo) * inv * 1023.0, 0.0, 1023.0).to(torch.int32)
    codes = (_spread_bits10(u[:, 0]) | (_spread_bits10(u[:, 1]) << 1)
             | (_spread_bits10(u[:, 2]) << 2))
    codes = torch.where(valid[:, 0], codes, torch.full_like(codes, 2 ** 30))
    return torch.argsort(codes, stable=True)


def tile_boxes(points: torch.Tensor, tile: int) -> torch.Tensor:
    """Per-tile boxes [n, 6]: (min xyz, max xyz), parked rows included."""
    p = points.reshape(points.shape[0] // tile, tile, 3)
    return torch.cat([torch.amin(p, dim=1), torch.amax(p, dim=1)], dim=1)


class PrunedTables(NamedTuple):
    """E6's plain-torch set-up: both clouds in E6's Morton order, their
    extended rows, tile boxes and each query tile's visit order."""
    q_perm: torch.Tensor     # [Q] sorted row -> original query row
    q_sorted: torch.Tensor   # [Q,3]
    q_norm2: torch.Tensor    # [Q] |q|^2 of the sorted queries
    r_ext: torch.Tensor      # [R,4] extended rows of the sorted reference
    pay_sorted: torch.Tensor  # [R,P]
    q_boxes: torch.Tensor    # [nQ,6]
    r_boxes: torch.Tensor    # [nR,6]
    visit: torch.Tensor      # [nQ,nR] i32 reference tile per step
    qb: int
    rb: int


def pruned_tables(queries: torch.Tensor, ref_points: torch.Tensor,
                  payload: torch.Tensor) -> PrunedTables:
    """Sort, boxes and visit order of pallas_payload_variants.py:380-414:
    query tile i starts at its Morton-diagonal reference tile,
    ``(j + i*nR // nQ) % nR``."""
    Q, R = queries.shape[0], ref_points.shape[0]
    qb, rb = _tile(Q, _QB), _tile(R, _RB_PRUNED)
    q_perm = morton_order(queries)
    r_perm = morton_order(ref_points)
    q_sorted = queries[q_perm].contiguous()
    r_sorted = ref_points[r_perm].contiguous()
    ni, nj = Q // qb, R // rb
    dev = queries.device
    start = torch.arange(ni, device=dev) * nj // max(ni, 1)
    visit = ((torch.arange(nj, device=dev)[None, :] + start[:, None]) % nj
             ).to(torch.int32)
    return PrunedTables(q_perm, q_sorted, query_norm2(q_sorted),
                        extend_reference(r_sorted),
                        payload[r_perm].contiguous(),
                        tile_boxes(q_sorted, qb), tile_boxes(r_sorted, rb),
                        visit, qb, rb)


def _unsort(tab: PrunedTables, score: torch.Tensor, pay: torch.Tensor):
    d2_s = torch.clamp(score + tab.q_norm2, min=0.0)
    d2 = torch.empty_like(d2_s)
    out = torch.empty_like(pay)
    d2[tab.q_perm] = d2_s
    out[tab.q_perm] = pay
    return d2, out


def nn_payload_pruned_plain(queries: torch.Tensor, ref_points: torch.Tensor,
                            payload: torch.Tensor):
    """Plain torch E6: E4's function over the sorted clouds, ties across
    tiles to the first tile in E6's visit order.  It visits every tile:
    the kernel's skipping drops only tiles whose box bound reaches the
    running best, which cannot hold a better score beyond rounding."""
    tab = pruned_tables(queries, ref_points, payload)
    score, pay = _payload_plain(extend_queries(tab.q_sorted), tab.r_ext,
                                tab.pay_sorted, tab.rb, tab.visit, tab.qb)
    return _unsort(tab, score, pay)


def nn_payload_pruned(queries: torch.Tensor, ref_points: torch.Tensor,
                      payload: torch.Tensor, return_visits: bool = False):
    """E4's function with E6's Morton sort and box pruning; results in
    the caller's order.  With ``return_visits`` (CUDA only) also the
    number of reference tiles each query tile visited ([nQ] i32, of nR).
    CPU tensors run :func:`nn_payload_pruned_plain`.
    """
    _check_points('nn_payload_pruned', queries=queries,
                  ref_points=ref_points)
    _check_payload('nn_payload_pruned', ref_points, payload)
    if _on_cpu(queries, ref_points, payload):
        if return_visits:
            raise ValueError('nn_payload_pruned: visits are counted by the '
                             'kernel (CUDA tensors)')
        return nn_payload_pruned_plain(queries, ref_points, payload)
    device = _check_cuda('nn_payload_pruned', queries, ref_points, payload)
    if ref_points.shape[0] == 0 or queries.shape[0] == 0:
        raise ValueError('nn_payload_pruned: empty queries or reference')
    tab = pruned_tables(queries, ref_points, payload)
    Q, R, P = queries.shape[0], ref_points.shape[0], payload.shape[1]
    ni, nj = tab.q_boxes.shape[0], tab.r_boxes.shape[0]
    score = torch.empty(Q, dtype=torch.float32, device=device)
    pay = torch.empty((Q, P), dtype=torch.float32, device=device)
    visits = torch.empty(ni, dtype=torch.int32, device=device)
    err = _kernels().lsl_mm_payload_pruned(
        tab.q_sorted.data_ptr(), tab.q_norm2.data_ptr(), tab.r_ext.data_ptr(),
        tab.pay_sorted.data_ptr(), tab.q_boxes.data_ptr(),
        tab.r_boxes.data_ptr(), Q, R, P, tab.qb, tab.rb, ni, nj,
        score.data_ptr(), pay.data_ptr(), visits.data_ptr(), device.index,
        _stream(device))
    _check_launch('nn_payload_pruned', err)
    nn_payload_pruned.launches += 1
    d2, out = _unsort(tab, score, pay)
    return (d2, out, visits) if return_visits else (d2, out)


nn_payload_pruned.launches = 0


# --------------------------------------------------------------------------
# E2 / E3: K1's exact 1-NN at a chosen tile shape
# --------------------------------------------------------------------------

class TileTooLarge(ValueError):
    """The reference tile does not fit one block's shared memory (the
    card's counterpart of the TPU sweep's VMEM overflow)."""


def tiled_block(qb: int) -> tuple:
    """(threads per block, queries per thread) for a qb-query tile: one
    thread per query up to 256, then 256 threads with qb/256 queries
    each (qb/256 in 1, 2, 4, 8, 16, 32)."""
    if 1 <= qb <= 256:
        return qb, 1
    if qb % 256 == 0 and qb // 256 in (1, 2, 4, 8, 16, 32):
        return 256, qb // 256
    raise ValueError(f'query tile {qb}: must be <= 256 or 256 times 1, 2, '
                     '4, 8, 16 or 32')


def _launch_tiled(wrapper, queries: torch.Tensor, ref_points: torch.Tensor,
                  qb: int, rb: int):
    """Launch the tiled kernel for ``wrapper`` and count the launch on
    ``wrapper.launches``."""
    name = wrapper.__name__
    device = _check_cuda(name, queries, ref_points)
    tiled_block(qb)
    Q, R = queries.shape[0], ref_points.shape[0]
    if R == 0 or rb < 1:
        raise ValueError(f'{name}: empty reference or tile')
    smem = 12 * rb
    props = torch.cuda.get_device_properties(device)
    limit = props.shared_memory_per_block_optin
    if smem > limit:
        raise TileTooLarge(f'{name}: a {rb}-point reference tile needs '
                           f'{smem} bytes of shared memory, the card gives '
                           f'a block {limit}')
    d2 = torch.empty(Q, dtype=torch.float32, device=device)
    idx = torch.empty(Q, dtype=torch.int32, device=device)
    if Q:
        err = _kernels().lsl_nn_tiled(
            queries.data_ptr(), ref_points.data_ptr(), Q, R, qb, rb,
            d2.data_ptr(), idx.data_ptr(), device.index, _stream(device))
        _check_launch(name, err)
        wrapper.launches += 1
    return d2, idx


def nn_indices_tiled(queries: torch.Tensor, ref_points: torch.Tensor,
                     qb: int, rb: int):
    """K1's exact 1-NN with qb queries per block and rb reference points
    staged per shared-memory tile (E3's sweep).  Returns (d2, idx) as
    ``nn_kernels.nn_indices``; raises :class:`TileTooLarge` where rb
    points do not fit a block.  CPU tensors run K1's plain version."""
    _check_points('nn_indices_tiled', queries=queries,
                  ref_points=ref_points)
    if _on_cpu(queries, ref_points):
        tiled_block(qb)
        return nn_indices_plain(queries, ref_points)
    return _launch_tiled(nn_indices_tiled, queries, ref_points, qb, rb)


nn_indices_tiled.launches = 0


def nn_vpu(queries: torch.Tensor, ref_points: torch.Tensor):
    """E2 (``vpu_kernel``): the tiled exact kernel at 256 x 2048."""
    _check_points('nn_vpu', queries=queries, ref_points=ref_points)
    if _on_cpu(queries, ref_points):
        return nn_indices_plain(queries, ref_points)
    return _launch_tiled(nn_vpu, queries, ref_points, _QB, _RB)


nn_vpu.launches = 0


def reset_launches() -> None:
    """Set every wrapper's launch counter of this module to 0."""
    nn_indices_mm.launches = nn_indices_mm.launches_bf16 = 0
    for fn in (nn_payload, nn_payload_pruned, nn_indices_tiled, nn_vpu):
        fn.launches = 0


# --------------------------------------------------------------------------
# Checks through float64 (chip_smoke.py and the tests)
# --------------------------------------------------------------------------

# Payload rows that agree where the winner is an exact duplicate group:
# the mean of the same rows, summed in another order.
PAYLOAD_ATOL = 1e-5


def _ext64(queries, ref_points, precision='highest'):
    """float64 copies of the extended rows the product sees (f32, or
    rounded to bf16)."""
    q_ext, r_ext = mm_scores(extend_queries(queries),
                             extend_reference(ref_points), precision)
    return q_ext.double(), r_ext.double()


def _raise_beyond(name, ratio) -> float:
    """Raise if any d2 error / limit exceeds 1; returns the largest."""
    n_bad = int(torch.sum(ratio > 1.0))
    if n_bad:
        raise AssertionError(f'result {name}: {n_bad} d2 beyond the '
                             f'tolerance (up to {float(ratio.max()):.3f} '
                             'times it)')
    return float(ratio.max()) if ratio.numel() else 0.0


def check_mm_indices(queries, ref_points, d2_a, idx_a, d2_b, idx_b,
                     precision='highest') -> dict:
    """Two matmul-form index results of one query set.  Each d2 lies within
    :func:`score_tolerance` of the float64 d2 of its own winner (scored
    from the operands the product sees: f32, or rounded to bf16), and the
    indices are equal except where the two winners' float64 scores lie
    within the sum of their limits.  Returns the max |d2_a - d2_b|, the
    largest d2 error as a share of its limit, and the number of differing
    indices."""
    q64, r64 = _ext64(queries, ref_points, precision)
    qn = torch.sum(queries.double() ** 2, dim=1)
    worst, scores, tols = 0.0, [], []
    for name, d2, idx in (('a', d2_a, idx_a), ('b', d2_b, idx_b)):
        if not bool(torch.all(torch.isfinite(d2))):
            raise AssertionError(f'result {name}: non-finite d2')
        i = idx.long()
        s = torch.sum(q64 * r64[i], dim=1)
        tol = score_tolerance(queries, ref_points[i])
        err = torch.abs(d2.double() - torch.clamp(s + qn, min=0.0))
        worst = max(worst, _raise_beyond(name, err / tol))
        scores.append(s)
        tols.append(tol)
    gap = torch.abs(scores[0] - scores[1])
    n_bad = int(torch.sum(gap > tols[0] + tols[1]))
    if n_bad:
        raise AssertionError(f'{n_bad} index choices differ by more than '
                             'the tolerance')
    err = torch.abs(d2_a.double() - d2_b.double())
    return dict(max_abs_err=float(err.max()) if err.numel() else 0.0,
                err_over_tol=worst,
                index_diffs=int(torch.sum(idx_a != idx_b)))


def check_exact_indices(queries, ref_points, d2_a, idx_a, d2_b,
                        idx_b) -> dict:
    """Two coordinate-wise exact results: d2 within 1e-6 relative and
    equal indices except where float64 shows an exact f32 tie."""
    err = torch.abs(d2_a.double() - d2_b.double())
    bad = err > 1e-6 * torch.clamp(torch.abs(d2_b.double()), min=1e-30)
    if bool(torch.any(bad)):
        raise AssertionError(f'{int(bad.sum())} d2 beyond 1e-6 relative '
                             f'(max abs {float(err.max())})')
    diff = torch.nonzero(idx_a != idx_b)[:, 0]
    if diff.numel():
        q = queries[diff].double()
        da = torch.sum((q - ref_points[idx_a[diff].long()].double()) ** 2, 1)
        db = torch.sum((q - ref_points[idx_b[diff].long()].double()) ** 2, 1)
        if not bool(torch.all(torch.abs(da - db) <= 1e-6 * db)):
            raise AssertionError(f'{diff.numel()} index mismatches that are '
                                 'not ties')
    return dict(max_abs_err=float(err.max()) if err.numel() else 0.0,
                index_diffs=int(diff.numel()))


def check_payload(queries, ref_points, payload, d2_a, pay_a, d2_b,
                  pay_b) -> dict:
    """Two payload results of one query set.  A query's near set is the
    reference rows whose float64 score lies within twice its
    :func:`score_tolerance` (taken at the least-score row) of the least:
    the rows either f32 evaluation may pick.  Each d2 lies within the
    limit of the float64 d2 of some row of the near set.  Where the set is
    one row, both payloads equal that row exactly; where it is copies of
    one point (exact duplicates, tied in any arithmetic), the two agree
    within ``PAYLOAD_ATOL``; elsewhere rounding picks the winner and the
    payloads are not compared."""
    for name, d2 in (('a', d2_a), ('b', d2_b)):
        if not bool(torch.all(torch.isfinite(d2))):
            raise AssertionError(f'result {name}: non-finite d2')
    q64, r64 = _ext64(queries, ref_points)
    qn = torch.sum(queries.double() ** 2, dim=1)
    counts = dict(unique=0, duplicates=0, rounding=0)
    pay_err = 0.0
    # Per result, each query's d2 error (at its nearest near row) / limit.
    ratio = torch.empty((2, queries.shape[0]), dtype=torch.float64,
                        device=queries.device)
    for s, e in query_chunks(queries.shape[0], ref_points.shape[0]):
        sc = q64[s:e] @ r64.T
        least, arg = torch.min(sc, dim=1)
        tol = score_tolerance(queries[s:e], ref_points[arg])
        near = sc <= (least + 2.0 * tol)[:, None]
        d2_rows = torch.clamp(sc + qn[s:e, None], min=0.0)
        for k, d2 in enumerate((d2_a, d2_b)):
            ratio[k, s:e] = torch.amin(torch.where(
                near, torch.abs(d2[s:e, None].double() - d2_rows),
                torch.full_like(d2_rows, float('inf'))), dim=1) / tol
        n_near = torch.sum(near, dim=1)
        first = torch.argmax(near.to(torch.int8), dim=1)
        same = torch.all(ref_points[None] == ref_points[first][:, None],
                         dim=2)
        dup = torch.all(same | ~near, dim=1) & (n_near > 1)
        uniq = n_near == 1
        pa, pb = pay_a[s:e], pay_b[s:e]
        want = payload[first]
        if bool(torch.any(uniq & ~(torch.all(pa == want, 1)
                                   & torch.all(pb == want, 1)))):
            raise AssertionError('payload of a unique winner differs')
        d = torch.amax(torch.abs(pa - pb), dim=1)
        if bool(torch.any(dup & (d > PAYLOAD_ATOL))):
            raise AssertionError('averaged payloads of a duplicate group '
                                 f'differ (max {float(d[dup].max())})')
        pay_err = max(pay_err, float(d[uniq | dup].max())
                      if bool(torch.any(uniq | dup)) else 0.0)
        counts['unique'] += int(uniq.sum())
        counts['duplicates'] += int(dup.sum())
        counts['rounding'] += int((~uniq & ~dup).sum())
    worst = max(_raise_beyond('a', ratio[0]), _raise_beyond('b', ratio[1]))
    err = torch.abs(d2_a.double() - d2_b.double())
    return dict(max_abs_err=max(float(err.max()), pay_err),
                err_over_tol=worst, **counts)
