"""The yardstick: peaks, bounds, the merge of busy intervals and the
replay of the pruned 1-NN's tile walk, frozen inside the benchmark.

* :class:`CardPeaks`, :func:`nn_bytes` and :data:`INSTR_EXACT`: copies of
  ``laser_slam_tpu_torch/pipeline/profiling.py``'s ``CardPeaks.bound``,
  ``nn_bytes`` and ``INSTR_EXACT``.
* :func:`busy_ns`: the merge of overlapping device intervals of
  ``profiling._busy_ms``.
* :func:`walk_pairs`: ``laser_slam_tpu_torch/ops/nn_kernels.py``'s
  ``build_pruned_ref``, ``pruned_tables`` and ``pruned_visits`` (the
  Pallas kernel ``_nn_pruned_kernel``'s walk of reference tiles, replayed
  in plain torch), over a lane axis: the (query, reference) pairs that the
  walk scans for given queries.  It is counted from the inputs alone,
  never from what a kernel reports it scanned.
* :func:`k2_groups`: which device records of a profile belong to one call
  of the pruned 1-NN (K2, or K2L over lanes) and its set-up, by the names
  of the program's kernels.

The program under test may change; this file may not.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

# f32 lane instructions a (query, reference) pair of an exact 1-NN needs:
# 3 sub, 3 mul, 2 add, a compare and 2 selects.
INSTR_EXACT = 11


@dataclasses.dataclass(frozen=True)
class CardPeaks:
    """Peak rates of an NVIDIA H100 80GB HBM3 (SXM, 700 W): 132 SMs of 128
    f32 lanes at the 1.98 GHz max SM clock, 3.35 TB/s of HBM."""
    name: str = 'NVIDIA H100 80GB HBM3'
    sm_count: int = 132
    lanes_per_sm: int = 128
    sm_clock_hz: float = 1.98e9
    hbm_bytes_per_s: float = 3.35e12

    @property
    def f32_issue_per_s(self) -> float:
        return self.sm_count * self.lanes_per_sm * self.sm_clock_hz

    def bound(self, pairs: float, instr: float,
              nbytes: float) -> Tuple[float, str]:
        """(bound_ms, bound_by): the larger of the operations over the f32
        issue rate and the bytes over HBM."""
        t_ops = pairs * instr / self.f32_issue_per_s
        t_bytes = nbytes / self.hbm_bytes_per_s
        return (1e3 * max(t_ops, t_bytes),
                'operations' if t_ops >= t_bytes else 'bytes')


PEAKS = CardPeaks()


def nn_bytes(nq: int, nr: int) -> int:
    """Bytes a 1-NN must move: queries and references [.,3] f32 read
    once, d2 and idx written once."""
    return 4 * (3 * nq + 3 * nr + 2 * nq)


def busy_ns(intervals: Sequence[Tuple[int, int]]) -> int:
    """Summed length of (start, end) intervals, overlaps merged."""
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


# --------------------------------------------------------------------------
# The Pallas walk of the pruned 1-NN
# --------------------------------------------------------------------------

# Tiles of the walk: 256 queries; 4096 reference points, or 1024 for
# per-lane references of at most 4096 points that are a multiple of 1024.
QUERY_TILE = 256
REF_TILE = 4096
REF_TILE_SMALL_LANES = 1024


def _tile(n: int, preferred: int) -> int:
    t = min(preferred, n)
    while n % t:
        t -= 1
    return t


def ref_tile(R: int, per_lane: bool) -> int:
    if per_lane and R <= REF_TILE and R % REF_TILE_SMALL_LANES == 0:
        return REF_TILE_SMALL_LANES
    return _tile(R, REF_TILE)


def _morton3d(points, lo, inv_extent):
    u = torch.clamp((points - lo) * inv_extent, 0.0, 1.0)
    g = (u * 1023.0).to(torch.int32)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return (spread(g[..., 0]) | (spread(g[..., 1]) << 1)
            | (spread(g[..., 2]) << 2))


def _finite_bounds(points):
    finite = torch.all(torch.abs(points) < 1.0e5, dim=-1, keepdim=True)
    big = torch.full_like(points, 3.0e5)
    lo = torch.amin(torch.where(finite, points, big), dim=-2)
    hi = torch.amax(torch.where(finite, points, -big), dim=-2)
    bad = (lo[..., 0] > hi[..., 0])[..., None]
    lo = torch.where(bad, torch.zeros_like(lo), lo)
    hi = torch.where(bad, torch.ones_like(hi), hi)
    return lo, hi


def _sorted_by_morton(points, lo, inv):
    perm = torch.argsort(_morton3d(points, lo[..., None, :],
                                   inv[..., None, :]), dim=-1, stable=True)
    return torch.gather(points, -2, perm[..., None].expand(points.shape))


def _tile_aabbs(points, tile):
    n = points.shape[-2] // tile
    p = points.reshape(points.shape[:-2] + (n, tile, 3))
    return torch.amin(p, dim=-2), torch.amax(p, dim=-2)


def walk_visits(queries: torch.Tensor, ref: torch.Tensor, cutoff: float,
                per_lane: bool) -> torch.Tensor:
    """Reference tiles the Pallas walk scans for each query tile, [B,nQ]:
    queries [B,Q,3] against ref [B,R,3] (one problem a lane).

    The reference is Morton-sorted over its finite box and cut into
    tiles with their boxes; the queries are sorted over the same box and
    cut into tiles of 256; each query tile visits the reference tiles in
    ascending order of the lower bound between the two boxes, stops at
    the first bound at or past cutoff^2 and skips a tile whose bound is
    at or past the largest running best of its queries."""
    B, Q = queries.shape[:2]
    R = ref.shape[1]
    qb, rb = _tile(Q, QUERY_TILE), ref_tile(R, per_lane)
    nQ, nR = Q // qb, R // rb
    lo, hi = _finite_bounds(ref)
    inv = 1.0 / torch.clamp(hi - lo, min=1e-6)
    ref_s = _sorted_by_morton(ref, lo, inv)
    tlo, thi = _tile_aabbs(ref_s, rb)
    q_s = _sorted_by_morton(queries, lo, inv)
    q_lo, q_hi = _tile_aabbs(q_s, qb)
    gap = torch.clamp(torch.maximum(
        tlo[:, None, :, :] - q_hi[:, :, None, :],
        q_lo[:, :, None, :] - thi[:, None, :, :]), min=0.0)
    lb2 = (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]) \
        + gap[..., 2] * gap[..., 2]                              # [B,nQ,nR]
    order = torch.argsort(lb2, dim=-1, stable=True)
    lb = torch.gather(lb2, -1, order)
    # Least squared distance from each sorted query to each reference
    # tile, coordinate-wise in f32 as the kernels compute it.
    tile_min = torch.empty((B, Q, nR), dtype=torch.float32,
                           device=queries.device)
    rows = max(1, (1 << 26) // R)
    for b in range(B):
        for s in range(0, Q, rows):
            e = min(Q, s + rows)
            d = q_s[b, s:e, None, :] - ref_s[b, None, :, :]
            d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
                + d[..., 2] * d[..., 2]
            tile_min[b, s:e] = torch.amin(d2.reshape(e - s, nR, rb), dim=-1)
    tile_min = tile_min.reshape(B, nQ, qb, nR)
    best = torch.full((B, nQ, qb), float('inf'), device=queries.device)
    visits = torch.zeros((B, nQ), dtype=torch.int64, device=queries.device)
    cutoff2 = float(cutoff) ** 2
    for j in range(nR):
        bound = lb[..., j]
        scan = (bound < cutoff2) & (bound < torch.amax(best, dim=-1))
        step = torch.gather(tile_min, 3, order[..., j][..., None, None]
                            .expand(B, nQ, qb, 1))[..., 0]
        best = torch.where(scan[..., None], torch.minimum(best, step), best)
        visits += scan
    return visits


def walk_pairs(queries: torch.Tensor, ref: torch.Tensor, cutoff: float,
               per_lane: bool) -> int:
    """(query, reference) pairs the walk scans: visited tiles times the
    tile sizes, over every lane."""
    Q, R = queries.shape[1], ref.shape[1]
    qb, rb = _tile(Q, QUERY_TILE), ref_tile(R, per_lane)
    return int(walk_visits(queries, ref, cutoff, per_lane).sum()) * qb * rb


def nn_call_bound_ms(queries: torch.Tensor, ref: torch.Tensor,
                     cutoff: float, per_lane: bool) -> float:
    """The bound of one pruned 1-NN call, queries [B,Q,3] against ref
    [B,R,3] (a shared reference: B = 1 with every query flattened)."""
    B, Q = queries.shape[:2]
    pairs = walk_pairs(queries, ref, cutoff, per_lane)
    return PEAKS.bound(pairs, INSTR_EXACT,
                       nn_bytes(B * Q, B * ref.shape[1]))[0]


# --------------------------------------------------------------------------
# Device records of the pruned 1-NN
# --------------------------------------------------------------------------

K2_START = ('k2_sort_kernel', 'k2_codes_kernel')
K2_END = 'nn_unpack_kernel'


def k2_groups(records: Sequence[Tuple[str, int, int]]
              ) -> List[List[Tuple[str, int, int]]]:
    """The device records (name, start ns, duration ns), in stream order,
    of each call of the pruned 1-NN: from its set-up's first kernel (the
    query sort, or the codes before a torch sort) to the unpack of its
    results, everything between included (the sorts, the tables, the
    items)."""
    groups, cur = [], None
    for rec in sorted(records, key=lambda r: r[1]):
        name = rec[0]
        if any(k in name for k in K2_START):
            cur = [rec]
        elif cur is not None:
            cur.append(rec)
            if K2_END in name:
                groups.append(cur)
                cur = None
    return groups
