"""The exact-NN kernel shootout's variants: hand-written CUDA kernels and
their plain versions.

Counterpart of the Pallas kernels in ``experiments/pallas_nn_variants.py``,
``experiments/pallas_tile_sweep.py`` and
``experiments/pallas_payload_variants.py``.  The kernels are in
``csrc/nn_variants.cu`` (its header gives the design and what bounds
each on the card):

* E5/E1 :func:`nn_indices_mm` — matmul-form index 1-NN: the score
  ``[q,1]·[-2r,|r|^2]`` at precision ``'highest'`` (f32 FMAs, E5 and E1 at
  ``HIGHEST``) or ``'bf16'`` (operands rounded to bf16, tensor-core
  product, f32 accumulate: E1 at ``DEFAULT``, one bf16 pass);
  ``d2 = max(score + |q|^2, 0)``.  E1 runs on the card as E5's three
  launches with the product on the tensor cores: :func:`mm_bf16_setup`
  packs the reference rows to bf16 once, then
  :func:`_launch_mm_indices_bf16` runs (256-query tile x 2048-row span)
  work items that keep one minimum a 512-row key tile and an epilogue
  that scores the winning tile again with the same instruction;
  :func:`nn_indices_mm_bf16_by_keys` is those two passes in plain torch.
* E4 :func:`nn_payload` — the same scores; returns the winner's payload
  row.  Exactly tied minima inside one 2048-wide reference tile are
  averaged (the Pallas one-hot / count); across tiles a strict ``<``.
  E5 (``'highest'``) and E4 run on the card as (512-query tile x
  2048-row span) work items that merge one key a query,
  ``(orderable score bits) << 32 | key tile``, and an epilogue that
  scores the winning key tile again (:func:`mm_setup`, then
  :func:`_launch_mm_indices` or :func:`_launch_payload`: three launches
  a call); :func:`nn_indices_mm_by_keys` and :func:`nn_payload_by_keys`
  are those two passes in plain torch.
* E6 :func:`nn_payload_pruned` — E4's function over E6's own
  Morton-sorted queries and reference (256-query x 1024-reference
  tiles): per query the least score over the reference tiles, ties
  across tiles to the first tile in E6's rotated visit order, the
  winning tile's tied rows averaged.  On the card (query tile x reference
  tile) work items merge one key a query, ``(orderable score bits) << 32
  | visit rank``, skip tiles whose box bound reaches the query tile's
  largest merged best, and an epilogue averages the payloads; the Morton
  codes and the sort (one cluster a cloud), the gathers, the boxes and
  the unsort run on the card too (:func:`pruned_setup`), four launches
  a call.
* E2/E3 :func:`nn_vpu` / :func:`nn_indices_tiled` — K1's coordinate-wise
  exact 1-NN with a chosen (query tile, reference tile) as the work item,
  merged across items as K1 merges them; E2 is the (256, 2048) instance.
  Its plain version is K1's.

Each wrapper takes its plain torch version when the tensors lie on the
CPU; for CUDA tensors it launches its kernel and adds one to its
``launches`` counter, or raises.

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
                                                 _check_points, _merge_keys,
                                                 _tile, nn_indices_plain)

# Tile sizes of the experiment kernels (pallas_payload_variants._QB/_RB,
# and the 1024-wide reference tile of nn_payload_pruned).
_QB = 256
_RB = 2048
_RB_PRUNED = 1024
# Widest payload row the kernels keep in registers.
MAX_PAYLOAD = 8
# E4/E5 work items (csrc/nn_variants.cu ITEM_QT, ITEM_SPAN): a query tile
# x a reference span; E5's key tile is the 512 rows one group of an item
# scans (ITEM_ROWS), E4's its own _tile(R, 2048).  E1's (E1_QT, E1_SPAN):
# 256-query tiles x 2048-row spans, with E5's 512-row key tiles.
_MM_QT = 512
_MM_SPAN = 2048
_MM_KEY_TILE = 512
_E1_QT = 256
_E1_SPAN = 2048
# E6's set-up sorts each cloud in one cluster of 16 blocks, at most this
# many 8-byte keys a block (8 a thread in registers, 64 KB of shared
# memory); a larger cloud is sorted by torch.sort.
_E6_CLUSTER = 16
_E6_SORT_BLOCK = 8192
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
        lib.lsl_e1_setup.argtypes = [p, i, i, i, p, p, i, p]
        lib.lsl_e1_indices.argtypes = [p, p, i, i, p, p, p, i, p]
        lib.lsl_mm_setup.argtypes = [p, i, i, p, p, i, p]
        lib.lsl_mm_indices.argtypes = [p, p, i, i, p, p, p, i, p]
        lib.lsl_mm_payload.argtypes = [p, p, p, i, i, i, i, p, p, p, i, p]
        lib.lsl_e6_morton.argtypes = [p, p, i, i, i, i, p, p, i, p]
        lib.lsl_e6_gather.argtypes = [p, p, p, i, i, i, i, p, p, p, p, p, p,
                                      p, i, p]
        lib.lsl_e6_pruned.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p, p,
                                      p, p, p, i, p]
        lib.lsl_nn_tiled.argtypes = [p, p, i, i, i, i, p, p, p, i, p]
        for fn in (lib.lsl_e1_setup, lib.lsl_e1_indices, lib.lsl_mm_setup,
                   lib.lsl_mm_indices, lib.lsl_mm_payload, lib.lsl_e6_morton,
                   lib.lsl_e6_gather, lib.lsl_e6_pruned, lib.lsl_nn_tiled):
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


def extend_reference_bf16(ref_points: torch.Tensor) -> torch.Tensor:
    """E1's reference operand: :func:`extend_reference`'s rows rounded to
    bf16, with |r|^2 summed ``(x*x + y*y) + z*z`` in f32, the one order
    the set-up kernel sums it in, on any device.  One bf16 step of |r|^2
    near 7,500 m^2 is 32 m^2, so the kernel and the plain version must
    round the same f32 value."""
    x, y, z = ref_points.unbind(1)
    n2 = (x * x + y * y) + z * z
    return round_bf16(torch.cat([-2.0 * ref_points, n2[:, None]], dim=1))


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


def mm_operands(queries: torch.Tensor, ref_points: torch.Tensor,
                precision: str) -> tuple:
    """(q_ext, r_ext) as the product sees them: f32, or rounded to bf16
    (:func:`extend_reference_bf16`)."""
    _check_precision(precision)
    if precision == 'bf16':
        return (round_bf16(extend_queries(queries)),
                extend_reference_bf16(ref_points))
    return extend_queries(queries), extend_reference(ref_points)


def nn_indices_mm_plain(queries: torch.Tensor, ref_points: torch.Tensor,
                        precision: str = 'highest'):
    """Plain torch E5/E1: chunked ``torch.matmul`` of the extended rows
    (bf16: both operands rounded first, so the TPU's rank errors are
    reproduced), ``min`` with the lowest index on ties.  Returns
    (d2 [Q] f32, idx [Q] i32)."""
    q_ext, r_ext = mm_operands(queries, ref_points, precision)
    Q = queries.shape[0]
    score = torch.empty(Q, dtype=torch.float32, device=queries.device)
    idx = torch.empty(Q, dtype=torch.int32, device=queries.device)
    for s, e in query_chunks(Q, ref_points.shape[0]):
        m, i = torch.min(_f32_matmul(q_ext[s:e], r_ext.T), dim=1)
        score[s:e] = m
        idx[s:e] = i.to(torch.int32)
    return torch.clamp(score + query_norm2(queries), min=0.0), idx


def _least_tile(tile_min: torch.Tensor) -> torch.Tensor:
    """[c] the tile the kernels' merge keys pick from per-tile minima
    [c, nT]: the least :func:`score_keys` over (tile minimum, tile), that
    is the least score in the lowest tile attaining it (-0.0 and +0.0
    alike), the Pallas rule across tiles."""
    tiles = torch.arange(tile_min.shape[1], device=tile_min.device)
    return torch.amin(score_keys(tile_min, tiles), dim=1) & 0xFFFFFFFF


def _mm_by_keys(queries: torch.Tensor, ref_points: torch.Tensor,
                precision: str):
    """E5's or E1's two passes in plain torch: per query the least merge
    key over the 512-row key tiles (the last one ragged), decoded to its
    tile, and that tile's scores again, the lowest row tied with the
    least.  The tile's scores are those of the first pass (one product
    of the same operands): the kernels' epilogues reproduce them by
    repeating the first pass's arithmetic."""
    q_ext, r_ext = mm_operands(queries, ref_points, precision)
    Q, R, w = queries.shape[0], ref_points.shape[0], _MM_KEY_TILE
    nT = -(-R // w)
    dev = queries.device
    score = torch.empty(Q, dtype=torch.float32, device=dev)
    idx = torch.empty(Q, dtype=torch.int32, device=dev)
    for s, e in query_chunks(Q, R):
        sc = torch.nn.functional.pad(_f32_matmul(q_ext[s:e], r_ext.T),
                                     (0, nT * w - R), value=float('inf'))
        sc = sc.reshape(e - s, nT, w)
        t = _least_tile(torch.amin(sc, dim=2))
        tile = sc[torch.arange(e - s, device=dev), t]           # [c, w]
        best = torch.amin(tile, dim=1)
        first = torch.argmax((tile == best[:, None]).to(torch.int8), dim=1)
        score[s:e] = best
        idx[s:e] = (t * w + first).to(torch.int32)
    return torch.clamp(score + query_norm2(queries), min=0.0), idx


def nn_indices_mm_by_keys(queries: torch.Tensor, ref_points: torch.Tensor):
    """Plain torch E5 as the kernel's two passes compute it
    (:func:`_mm_by_keys` in f32): the same function as
    :func:`nn_indices_mm_plain` at ``'highest'``, reached through the
    keys.  Returns (d2 [Q] f32, idx [Q] i32)."""
    return _mm_by_keys(queries, ref_points, 'highest')


def nn_indices_mm_bf16_by_keys(queries: torch.Tensor,
                               ref_points: torch.Tensor):
    """Plain torch E1 as its kernel's two passes compute it: the operands
    rounded to bf16 (:func:`mm_operands`), the least score a 512-row key
    tile, :func:`_least_tile`, and the winning tile's scores again, the
    lowest row tied with the least.  The same function as
    :func:`nn_indices_mm_plain` at ``'bf16'``, reached through the keys.
    Returns (d2 [Q] f32, idx [Q] i32)."""
    return _mm_by_keys(queries, ref_points, 'bf16')


def nn_indices_mm(queries: torch.Tensor, ref_points: torch.Tensor,
                  precision: str = 'highest'):
    """For each query, (d2, index) of its nearest reference point by the
    matmul-form score at ``precision`` (``'highest'``: f32, E5; ``'bf16'``:
    one bf16 pass with f32 accumulate, E1 at ``DEFAULT``).

    queries [Q,3], ref_points [R,3] f32; park invalid rows at
    cloud.SENTINEL.  Returns (d2 [Q] f32, idx [Q] i32).  CPU tensors run
    :func:`nn_indices_mm_plain`; CUDA tensors launch the kernel and count
    it in ``nn_indices_mm.launches`` (highest: :func:`mm_setup` and
    :func:`_launch_mm_indices`) or ``nn_indices_mm.launches_bf16`` (bf16:
    :func:`mm_bf16_setup` and :func:`_launch_mm_indices_bf16`).  The bf16
    kernel writes index -1 for a query whose winning tile it could not
    score again to the same bits; :func:`check_mm_indices` refuses it.
    """
    _check_points('nn_indices_mm', queries=queries, ref_points=ref_points)
    _check_precision(precision)
    if _on_cpu(queries, ref_points):
        return nn_indices_mm_plain(queries, ref_points, precision)
    _check_cuda('nn_indices_mm', queries, ref_points)
    if ref_points.shape[0] == 0:
        raise ValueError('nn_indices_mm: empty reference')
    if precision == 'bf16':
        return _launch_mm_indices_bf16(queries,
                                       mm_bf16_setup(queries, ref_points))
    return _launch_mm_indices(queries, mm_setup(queries, ref_points))


class MatmulTables(NamedTuple):
    """E4/E5's set-up on the card (:func:`mm_setup`)."""
    r_ext: torch.Tensor      # [R,4] extended reference rows
    keys: torch.Tensor       # [Q] int64 merge keys, empty between calls


def mm_items(n_queries: int, n_refs: int) -> int:
    """Work items (blocks) of one E4/E5 items launch: 512-query tiles x
    2048-row reference spans."""
    return -(-n_queries // _MM_QT) * -(-n_refs // _MM_SPAN)


def mm_setup(queries: torch.Tensor, ref_points: torch.Tensor
             ) -> MatmulTables:
    """E4/E5's set-up, one launch (``mm_prelude_kernel``): the extended
    reference rows ``(-2x, -2y, -2z, |r|^2)`` and the queries' merge keys
    emptied (nothing for an empty query set)."""
    device = queries.device
    Q, R = queries.shape[0], ref_points.shape[0]
    tab = MatmulTables(
        torch.empty((R, 4), dtype=torch.float32, device=device),
        torch.empty(Q, dtype=torch.int64, device=device))
    if Q:
        _check_launch('mm_setup', _kernels().lsl_mm_setup(
            ref_points.data_ptr(), Q, R, tab.r_ext.data_ptr(),
            tab.keys.data_ptr(), device.index, _stream(device)))
    return tab


def _launch_mm_indices(queries: torch.Tensor, tab: MatmulTables):
    """E5's two passes on the tables of :func:`mm_setup` (the queries
    they were made for): (d2 [Q] f32, idx [Q] i32), the launch counted.
    The epilogue leaves the keys empty, so the tables serve again."""
    device = queries.device
    Q, R = queries.shape[0], tab.r_ext.shape[0]
    d2 = torch.empty(Q, dtype=torch.float32, device=device)
    idx = torch.empty(Q, dtype=torch.int32, device=device)
    if Q:
        err = _kernels().lsl_mm_indices(
            queries.data_ptr(), tab.r_ext.data_ptr(), Q, R,
            tab.keys.data_ptr(), d2.data_ptr(), idx.data_ptr(),
            device.index, _stream(device))
        _check_launch('nn_indices_mm', err)
        nn_indices_mm.launches += 1
    return d2, idx


class Bf16Tables(NamedTuple):
    """E1's set-up on the card (:func:`mm_bf16_setup`)."""
    rows: torch.Tensor       # [R8, 2] int32: packed bf16 B words a row
    keys: torch.Tensor       # [Q] int64 merge keys, empty between calls
    n_refs: int              # R (rows beyond it are zero padding)


def mm_bf16_items(n_queries: int, n_refs: int) -> int:
    """Work items (blocks) of one E1 items launch: 256-query tiles x
    2048-row reference spans."""
    return -(-n_queries // _E1_QT) * -(-n_refs // _E1_SPAN)


def mm_bf16_rows_plain(ref_points: torch.Tensor) -> torch.Tensor:
    """Plain twin of E1's set-up kernel: [R8, 2] int32 words, R rounded up
    to 8 with zero rows, each row's bf16 pair ``(-2x, -2y)`` then ``(-2z,
    |r|^2)``, the first of a pair in the low half (the mma B fragment's
    order) — :func:`extend_reference_bf16` packed."""
    R = ref_points.shape[0]
    rows = torch.zeros((-(-R // 8) * 8, 4), dtype=torch.bfloat16,
                       device=ref_points.device)
    rows[:R] = extend_reference_bf16(ref_points).to(torch.bfloat16)
    return rows.view(torch.int32)


def bf16_row_values(rows: torch.Tensor) -> torch.Tensor:
    """[R8, 4] f32 values of packed E1 rows ([R8, 2] int32)."""
    return rows.contiguous().view(torch.bfloat16).to(torch.float32)


def mm_bf16_setup(queries: torch.Tensor, ref_points: torch.Tensor
                  ) -> Bf16Tables:
    """E1's set-up, one launch (``e1_prelude_kernel``): the reference rows
    as packed bf16 B words (:func:`mm_bf16_rows_plain`'s bits) and the
    queries' merge keys emptied (nothing for an empty query set)."""
    device = queries.device
    Q, R = queries.shape[0], ref_points.shape[0]
    R8 = -(-R // 8) * 8
    tab = Bf16Tables(torch.empty((R8, 2), dtype=torch.int32, device=device),
                     torch.empty(Q, dtype=torch.int64, device=device), R)
    if Q:
        _check_launch('mm_bf16_setup', _kernels().lsl_e1_setup(
            ref_points.data_ptr(), Q, R, R8, tab.rows.data_ptr(),
            tab.keys.data_ptr(), device.index, _stream(device)))
    return tab


def _launch_mm_indices_bf16(queries: torch.Tensor, tab: Bf16Tables):
    """E1's two passes on the tables of :func:`mm_bf16_setup` (the
    queries they were made for): (d2 [Q] f32, idx [Q] i32), the launch
    counted.  The epilogue leaves the keys empty, so the tables serve
    again."""
    device = queries.device
    Q = queries.shape[0]
    d2 = torch.empty(Q, dtype=torch.float32, device=device)
    idx = torch.empty(Q, dtype=torch.int32, device=device)
    if Q:
        err = _kernels().lsl_e1_indices(
            queries.data_ptr(), tab.rows.data_ptr(), Q, tab.n_refs,
            tab.keys.data_ptr(), d2.data_ptr(), idx.data_ptr(),
            device.index, _stream(device))
        _check_launch('nn_indices_mm', err)
        nn_indices_mm.launches_bf16 += 1
    return d2, idx


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
                   payload: torch.Tensor, rb: int, pick=None):
    """Tile-wise payload 1-NN on extended rows.  Per query: each rb-wide
    tile's minimum score; the winning tile is the first that attains the
    least of them (a strict ``<`` across tiles), or ``pick(tile_min [c,
    nT], s, e)``'s choice for the queries s:e; its payload is the mean over
    the rows that attain the tile's minimum, weighted ``1/count`` as the
    Pallas one-hot is.  Returns (score [Q], payload [Q,P])."""
    Q, R, P = q_ext.shape[0], r_ext.shape[0], payload.shape[1]
    nT = R // rb
    dev = q_ext.device
    score = torch.empty(Q, dtype=torch.float32, device=dev)
    out = torch.zeros((Q, P), dtype=torch.float32, device=dev)
    pay_t = payload.reshape(nT, rb, P)
    for s, e in query_chunks(Q, R):
        sc = _f32_matmul(q_ext[s:e], r_ext.T).reshape(e - s, nT, rb)
        tile_min = torch.amin(sc, dim=2)                       # [c, nT]
        t = (torch.argmin(tile_min, dim=1) if pick is None
             else pick(tile_min, s, e))
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


def nn_payload_by_keys(queries: torch.Tensor, ref_points: torch.Tensor,
                       payload: torch.Tensor):
    """Plain torch E4 as the kernel's two passes compute it: the least
    merge key a query over the ``_tile(R, 2048)``-wide tiles, decoded to
    its tile, that tile's tied rows averaged.  The same function as
    :func:`nn_payload_plain`, reached through the keys."""
    rb = _tile(ref_points.shape[0], _RB)
    score, pay = _payload_plain(extend_queries(queries),
                                extend_reference(ref_points), payload, rb,
                                lambda tile_min, s, e: _least_tile(tile_min))
    return torch.clamp(score + query_norm2(queries), min=0.0), pay


def nn_payload(queries: torch.Tensor, ref_points: torch.Tensor,
               payload: torch.Tensor):
    """For each query, the squared distance to, and the payload row of,
    its nearest reference point by the f32 matmul-form score; exactly
    tied minima inside one ``_tile(R, 2048)``-wide reference tile are
    averaged.

    queries [Q,3], ref_points [R,3], payload [R,P] f32 (P <= 8).  Returns
    (d2 [Q] f32, payload [Q,P] f32).  CPU tensors run
    :func:`nn_payload_plain`; CUDA tensors run :func:`mm_setup` and the
    kernel (:func:`_launch_payload`).
    """
    _check_points('nn_payload', queries=queries, ref_points=ref_points)
    _check_payload('nn_payload', ref_points, payload)
    if _on_cpu(queries, ref_points, payload):
        return nn_payload_plain(queries, ref_points, payload)
    _check_cuda('nn_payload', queries, ref_points, payload)
    if ref_points.shape[0] == 0:
        raise ValueError('nn_payload: empty reference')
    return _launch_payload(queries, mm_setup(queries, ref_points), payload)


def _launch_payload(queries: torch.Tensor, tab: MatmulTables,
                    payload: torch.Tensor):
    """E4's two passes on the tables of :func:`mm_setup`: (d2 [Q] f32,
    payload [Q,P] f32), the launch counted.  The epilogue leaves the keys
    empty, so the tables serve again."""
    device = queries.device
    Q, R, P = queries.shape[0], tab.r_ext.shape[0], payload.shape[1]
    d2 = torch.empty(Q, dtype=torch.float32, device=device)
    out = torch.empty((Q, P), dtype=torch.float32, device=device)
    if Q:
        err = _kernels().lsl_mm_payload(
            queries.data_ptr(), tab.r_ext.data_ptr(), payload.data_ptr(), Q,
            R, P, _tile(R, _RB), tab.keys.data_ptr(), d2.data_ptr(),
            out.data_ptr(), device.index, _stream(device))
        _check_launch('nn_payload', err)
        nn_payload.launches += 1
    return d2, out


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


def _first_in_visit_order(tab: PrunedTables):
    """``_payload_plain``'s pick of E6: the least tile minimum, ties to the
    first tile in the query tile's visit order."""
    def pick(tile_min, s, e):
        order = tab.visit[torch.arange(s, e, device=tile_min.device)
                          // tab.qb].long()
        return torch.gather(order, 1, torch.argmin(
            torch.gather(tile_min, 1, order), dim=1, keepdim=True))[:, 0]
    return pick


def nn_payload_pruned_plain(queries: torch.Tensor, ref_points: torch.Tensor,
                            payload: torch.Tensor):
    """Plain torch E6: E4's function over the sorted clouds, ties across
    tiles to the first tile in E6's visit order.  It visits every tile:
    the kernel's skipping drops only tiles whose box bound reaches the
    running best, which cannot hold a better score beyond rounding."""
    tab = pruned_tables(queries, ref_points, payload)
    score, pay = _payload_plain(extend_queries(tab.q_sorted), tab.r_ext,
                                tab.pay_sorted, tab.rb,
                                _first_in_visit_order(tab))
    return _unsort(tab, score, pay)


def score_keys(score: torch.Tensor, rank) -> torch.Tensor:
    """Plain twin of E6's merge key, ``(orderable score bits) << 32 |
    rank``: int64 keys that order as the least score, then the least
    rank.  -0.0 is made +0.0 first, so scores that compare equal order by
    rank alone.  The kernel keeps the unsigned form; here the bits are
    shifted down by 2^31 so that a signed int64 orders them."""
    bits = (score + 0.0).contiguous().view(torch.int32).to(torch.int64)
    bits = bits & 0xFFFFFFFF
    neg = bits >= 2 ** 31
    u = torch.where(neg, bits ^ 0xFFFFFFFF, bits | 2 ** 31)
    return ((u - 2 ** 31) << 32) | torch.as_tensor(rank, dtype=torch.int64,
                                                   device=score.device)


def _least_key(tab: PrunedTables, scanned=None):
    """``_payload_plain``'s pick through E6's merge keys, as the kernel's
    two passes decide: per query the least :func:`score_keys` over the
    (tile minimum, visit rank) of the tiles scanned (``scanned`` [nQ, nR]
    bool by tile; default every tile), decoded to its tile."""
    def pick(tile_min, s, e):
        dev = tile_min.device
        i = torch.arange(s, e, device=dev) // tab.qb
        order = tab.visit[i].long()
        by_rank = torch.gather(tile_min, 1, order)
        if scanned is not None:
            by_rank = torch.where(torch.gather(scanned[i], 1, order),
                                  by_rank, torch.full_like(by_rank,
                                                           float('inf')))
        rank = torch.arange(order.shape[1], device=dev)
        least = torch.amin(score_keys(by_rank, rank), dim=1)
        return torch.gather(order, 1, (least & 0xFFFFFFFF)[:, None])[:, 0]
    return pick


def nn_payload_pruned_by_keys(queries: torch.Tensor,
                              ref_points: torch.Tensor,
                              payload: torch.Tensor):
    """Plain torch E6 as the kernel's passes compute it: the least merge
    key a query over every tile, decoded to (score, visit rank), the rank
    to its tile, the tile's tied rows averaged.  The same function as
    :func:`nn_payload_pruned_plain`, reached through the keys."""
    tab = pruned_tables(queries, ref_points, payload)
    score, pay = _payload_plain(extend_queries(tab.q_sorted), tab.r_ext,
                                tab.pay_sorted, tab.rb, _least_key(tab))
    return _unsort(tab, score, pay)


def tile_bounds(q_boxes: torch.Tensor, r_boxes: torch.Tensor
                ) -> torch.Tensor:
    """[nQ, nR] squared gaps between the query and reference tile boxes,
    summed ``(gx^2 + gy^2) + gz^2`` as the kernels sum them."""
    g = torch.clamp(torch.maximum(q_boxes[:, None, :3] - r_boxes[None, :, 3:],
                                  r_boxes[None, :, :3] - q_boxes[:, None, 3:]),
                    min=0.0)
    return (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) \
        + g[..., 2] * g[..., 2]


def pruned_walk(queries: torch.Tensor, ref_points: torch.Tensor,
                payload: torch.Tensor):
    """The Pallas kernel's walk replayed in plain torch: per query tile,
    the number of reference tiles ``_pruned_kernel`` visits ([nQ] int64),
    and the walk's result (d2 [Q], payload [Q,P], caller's order).

    The replay follows the Pallas grid step by step
    (pallas_payload_variants.py:322-362): each query tile visits its
    reference tiles in the rotated order and skips a tile whose box bound
    is not below the largest (best score + |q|^2) of the query tile,
    refreshed after every visited tile.  This fixed walk is the work that
    E6's bound counts.  The kernel on the card scans other tiles, in
    parallel and pruned by the bests merged so far (``visits`` of
    :func:`nn_payload_pruned`).  A measurement aid: no path of the port
    calls it."""
    tab = pruned_tables(queries, ref_points, payload)
    nQ, nR = tab.visit.shape
    dev = queries.device
    q_ext = extend_queries(tab.q_sorted)
    tile_min = torch.empty((q_ext.shape[0], nR), dtype=torch.float32,
                           device=dev)
    for s, e in query_chunks(q_ext.shape[0], tab.r_ext.shape[0]):
        tile_min[s:e] = torch.amin(_f32_matmul(q_ext[s:e], tab.r_ext.T)
                                   .reshape(e - s, nR, tab.rb), dim=2)
    tile_min = tile_min.reshape(nQ, tab.qb, nR)
    qn2 = tab.q_norm2.reshape(nQ, tab.qb)
    lb = tile_bounds(tab.q_boxes, tab.r_boxes)
    blocks = torch.arange(nQ, device=dev)
    best = torch.full((nQ, tab.qb), float('inf'), device=dev)
    best_max = torch.full((nQ,), float('inf'), device=dev)
    scanned = torch.zeros((nQ, nR), dtype=torch.bool, device=dev)
    for j in range(nR):
        tile = tab.visit[:, j].long()
        visit = lb[blocks, tile] < best_max
        scanned[blocks, tile] = visit
        best = torch.where(visit[:, None],
                           torch.minimum(best, tile_min[blocks, :, tile]),
                           best)
        best_max = torch.where(visit, torch.amax(best + qn2, dim=1),
                               best_max)
    score, pay = _payload_plain(q_ext, tab.r_ext, tab.pay_sorted, tab.rb,
                                _least_key(tab, scanned))
    d2, out = _unsort(tab, score, pay)
    return torch.sum(scanned, dim=1), d2, out


class PrunedDeviceTables(NamedTuple):
    """E6's set-up on the card (:func:`pruned_setup`): what the plain
    :class:`PrunedTables` holds, in the kernels' layout, and the merge
    scratch."""
    perm: torch.Tensor       # [Q+R] i32 sorted query rows, then reference
    q4: torch.Tensor         # [Q,4] sorted queries (x, y, z, |q|^2)
    r_ext: torch.Tensor      # [R,4] extended rows of the sorted reference
    q_boxes: torch.Tensor    # [nQ,6]
    r_boxes: torch.Tensor    # [nR,6]
    keys: torch.Tensor       # [Q+1] int64: merge keys, then the item counter
    visits: torch.Tensor     # [nQ] int32 tiles scanned a query tile
    qb: int
    rb: int


def _sort_block(n: int) -> int:
    """Keys a block of E6's sorting cluster holds for an n-point cloud:
    the least power of two with 16 of them at least n."""
    m = 1
    while _E6_CLUSTER * m < n:
        m *= 2
    return m


def pruned_setup(queries: torch.Tensor, ref_points: torch.Tensor
                 ) -> PrunedDeviceTables:
    """E6's set-up on the card: ``e6_morton_kernel`` codes both clouds
    (E6's own Morton coding, as :func:`morton_order`) and sorts each by
    (code, row) in one cluster's shared memory, the stable order of
    :func:`morton_order`; then ``e6_gather_kernel`` writes the sorted
    rows, the tile boxes and empty keys.  A cloud of more than 16 x 8192
    points is sorted by one stable ``torch.sort`` of both clouds' codes
    instead (query codes shifted below every reference code)."""
    device = queries.device
    Q, R = queries.shape[0], ref_points.shape[0]
    qb, rb = _tile(Q, _QB), _tile(R, _RB_PRUNED)
    lib, stream = _kernels(), _stream(device)
    m_q, m_r = _sort_block(Q), _sort_block(R)
    perm = torch.empty(Q + R, dtype=torch.int32, device=device)
    if max(m_q, m_r) <= _E6_SORT_BLOCK:
        _check_launch('nn_payload_pruned', lib.lsl_e6_morton(
            queries.data_ptr(), ref_points.data_ptr(), Q, R, m_q, m_r, None,
            perm.data_ptr(), device.index, stream))
    else:
        codes = torch.empty(Q + R, dtype=torch.int32, device=device)
        _check_launch('nn_payload_pruned', lib.lsl_e6_morton(
            queries.data_ptr(), ref_points.data_ptr(), Q, R, 0, 0,
            codes.data_ptr(), None, device.index, stream))
        order = torch.sort(codes, stable=True).indices
        order[Q:] -= Q
        perm = order.to(torch.int32)
    f32 = dict(dtype=torch.float32, device=device)
    tab = PrunedDeviceTables(
        perm, torch.empty((Q, 4), **f32), torch.empty((R, 4), **f32),
        torch.empty((Q // qb, 6), **f32), torch.empty((R // rb, 6), **f32),
        torch.empty(Q + 1, dtype=torch.int64, device=device),
        torch.empty(Q // qb, dtype=torch.int32, device=device), qb, rb)
    _check_launch('nn_payload_pruned', lib.lsl_e6_gather(
        queries.data_ptr(), ref_points.data_ptr(), perm.data_ptr(), Q, R,
        qb, rb, tab.q4.data_ptr(), tab.r_ext.data_ptr(),
        tab.q_boxes.data_ptr(), tab.r_boxes.data_ptr(), tab.keys.data_ptr(),
        tab.keys[Q:].data_ptr(), tab.visits.data_ptr(), device.index,
        stream))
    return tab


def _launch_pruned(tab: PrunedDeviceTables, payload: torch.Tensor):
    """E6's two passes on the tables of :func:`pruned_setup`: (d2 [Q],
    payload [Q,P]) in the caller's order, the launch counted.  The
    epilogue leaves the keys empty, so the tables serve again;
    ``tab.visits`` then sums the tiles scanned over the calls."""
    device = tab.q4.device
    Q, R, P = tab.q4.shape[0], tab.r_ext.shape[0], payload.shape[1]
    d2 = torch.empty(Q, dtype=torch.float32, device=device)
    out = torch.empty((Q, P), dtype=torch.float32, device=device)
    err = _kernels().lsl_e6_pruned(
        tab.q4.data_ptr(), tab.r_ext.data_ptr(), tab.q_boxes.data_ptr(),
        tab.r_boxes.data_ptr(), tab.perm.data_ptr(), payload.data_ptr(), Q,
        R, P, tab.qb, tab.rb, tab.keys.data_ptr(), tab.keys[Q:].data_ptr(),
        tab.visits.data_ptr(), d2.data_ptr(), out.data_ptr(), device.index,
        _stream(device))
    _check_launch('nn_payload_pruned', err)
    nn_payload_pruned.launches += 1
    return d2, out


def nn_payload_pruned(queries: torch.Tensor, ref_points: torch.Tensor,
                      payload: torch.Tensor, return_visits: bool = False):
    """E4's function with E6's Morton sort and box pruning; results in
    the caller's order.  With ``return_visits`` (CUDA only) also the
    number of reference tiles the kernel scanned for each query tile ([nQ]
    i32, of nR; which tiles depends on block timing, the results do not).
    CPU tensors run :func:`nn_payload_pruned_plain`; CUDA tensors run
    :func:`pruned_setup` and the kernel (:func:`_launch_pruned`).
    """
    _check_points('nn_payload_pruned', queries=queries,
                  ref_points=ref_points)
    _check_payload('nn_payload_pruned', ref_points, payload)
    if _on_cpu(queries, ref_points, payload):
        if return_visits:
            raise ValueError('nn_payload_pruned: visits are counted by the '
                             'kernel (CUDA tensors)')
        return nn_payload_pruned_plain(queries, ref_points, payload)
    _check_cuda('nn_payload_pruned', queries, ref_points, payload)
    if ref_points.shape[0] == 0 or queries.shape[0] == 0:
        raise ValueError('nn_payload_pruned: empty queries or reference')
    tab = pruned_setup(queries, ref_points)
    d2, out = _launch_pruned(tab, payload)
    return (d2, out, tab.visits) if return_visits else (d2, out)


nn_payload_pruned.launches = 0


# --------------------------------------------------------------------------
# E2 / E3: K1's exact 1-NN at a chosen tile shape
# --------------------------------------------------------------------------

class TileTooLarge(ValueError):
    """The reference tile does not fit one block's shared memory (the
    card's counterpart of the TPU sweep's VMEM overflow)."""


def check_query_tile(qb: int) -> None:
    """Refuse a query tile the sweep does not take: qb is at most 256, or
    256 times 1, 2, 4, 8, 16 or 32."""
    if not (1 <= qb <= 256 or (qb % 256 == 0
                               and qb // 256 in (1, 2, 4, 8, 16, 32))):
        raise ValueError(f'query tile {qb}: must be <= 256 or 256 times 1, '
                         '2, 4, 8, 16 or 32')


def tiled_items(n_queries: int, n_refs: int, qb: int, rb: int) -> int:
    """Work items (blocks) of one E2/E3 launch: query tiles x reference
    tiles."""
    return -(-n_queries // qb) * -(-n_refs // rb)


def _launch_tiled(wrapper, queries: torch.Tensor, ref_points: torch.Tensor,
                  qb: int, rb: int):
    """Launch the tiled kernel for ``wrapper`` and count the launch on
    ``wrapper.launches``."""
    name = wrapper.__name__
    device = _check_cuda(name, queries, ref_points)
    check_query_tile(qb)
    Q, R = queries.shape[0], ref_points.shape[0]
    if R == 0 or rb < 1:
        raise ValueError(f'{name}: empty reference or tile')
    smem = 16 * rb
    props = torch.cuda.get_device_properties(device)
    limit = props.shared_memory_per_block_optin
    if smem > limit:
        raise TileTooLarge(f'{name}: a {rb}-point reference tile needs '
                           f'{smem} bytes of shared memory, the card gives '
                           f'a block {limit}')
    d2 = torch.empty(Q, dtype=torch.float32, device=device)
    idx = torch.empty(Q, dtype=torch.int32, device=device)
    if Q:
        keys = _merge_keys(Q, device)
        err = _kernels().lsl_nn_tiled(
            queries.data_ptr(), ref_points.data_ptr(), Q, R, qb, rb,
            keys.data_ptr(), d2.data_ptr(), idx.data_ptr(), device.index,
            _stream(device))
        _check_launch(name, err)
        wrapper.launches += 1
    return d2, idx


def nn_indices_tiled(queries: torch.Tensor, ref_points: torch.Tensor,
                     qb: int, rb: int):
    """K1's exact 1-NN with a work item of qb queries and rb reference
    points, the points staged whole in a block's shared memory (E3's
    sweep).  Returns (d2, idx) as
    ``nn_kernels.nn_indices``; raises :class:`TileTooLarge` where rb
    points do not fit a block.  CPU tensors run K1's plain version."""
    _check_points('nn_indices_tiled', queries=queries,
                  ref_points=ref_points)
    if _on_cpu(queries, ref_points):
        check_query_tile(qb)
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
    q_ext, r_ext = mm_operands(queries, ref_points, precision)
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
    within the sum of their limits.  An index outside [0, R) fails (E1's
    epilogue writes -1 where it could not score its winning tile again to
    the key's bits).  Returns the max |d2_a - d2_b|, the largest d2 error
    as a share of its limit, and the number of differing indices."""
    for name, idx in (('a', idx_a), ('b', idx_b)):
        n_out = int(torch.sum((idx < 0) | (idx >= ref_points.shape[0])))
        if n_out:
            raise AssertionError(f'result {name}: {n_out} indices out of '
                                 'range (-1: the second scoring missed)')
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
