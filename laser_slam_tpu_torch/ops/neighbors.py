"""Exact nearest-neighbour search in plain torch.

Counterpart of ``laser_slam_tpu/ops/neighbors.py``.  The JAX package
computes ``|q|^2 - 2 q.r + |r|^2`` so the product rides the TPU's matrix
unit; the port computes the distance coordinate-wise, ``(qx-rx)^2 +
(qy-ry)^2 + (qz-rz)^2`` in f32, which keeps the rank order exact at 50 m
scene scale (the expansion loses it, see ``ops/nn_kernels.py``).  Near
ties may therefore pick a different neighbour than the JAX package; tests
decide such cases against a float64 oracle.

Invalid reference points are parked at ``cloud.SENTINEL`` so they never
win.  Queries are processed in chunks so the [Q, R] distance matrix is
never materialized whole.
"""

from __future__ import annotations

import torch

# Elements of the [chunk, R] distance block computed at once: large on
# the card (fewer launches), cache-sized on the CPU.
_BLOCK_ELEMS = 1 << 24
_CPU_BLOCK_ELEMS = 1 << 18


def sqdist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Squared distances [Q, R] between q [Q,3] and r [R,3], coordinate-
    wise in the order ``(dx*dx + dy*dy) + dz*dz`` (the CUDA kernels in
    ``csrc/nn.cu`` round identically, so the two agree bit for bit)."""
    dx = q[:, None, 0] - r[None, :, 0]
    dy = q[:, None, 1] - r[None, :, 1]
    dz = q[:, None, 2] - r[None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


def query_chunks(n_queries: int, n_refs: int, device=None):
    """(start, stop) query ranges whose distance blocks stay bounded;
    cache-sized blocks where ``device`` is named and is the CPU."""
    block = (_CPU_BLOCK_ELEMS if device is not None
             and torch.device(device).type == 'cpu' else _BLOCK_ELEMS)
    step = max(1, min(n_queries, block // max(n_refs, 1)))
    for s in range(0, n_queries, step):
        yield s, min(s + step, n_queries)


def nn_brute(queries: torch.Tensor, ref_points: torch.Tensor):
    """Exact 1-NN: for each query [Q,3] the nearest of ref [R,3].

    Ties go to the lowest reference index.  Returns (idx [Q] int32,
    sq_dist [Q] f32)."""
    Q = queries.shape[0]
    idx = torch.empty(Q, dtype=torch.int32, device=queries.device)
    d2 = torch.empty(Q, dtype=queries.dtype, device=queries.device)
    for s, e in query_chunks(Q, ref_points.shape[0], queries.device):
        m, i = torch.min(sqdist(queries[s:e], ref_points), dim=1)
        d2[s:e] = m
        idx[s:e] = i.to(torch.int32)
    return idx, d2


def knn_brute(queries: torch.Tensor, ref_points: torch.Tensor, k: int):
    """Exact k-NN indices [Q,k] int32 and squared distances [Q,k],
    nearest first."""
    Q = queries.shape[0]
    idx = torch.empty((Q, k), dtype=torch.int32, device=queries.device)
    d2 = torch.empty((Q, k), dtype=queries.dtype, device=queries.device)
    for s, e in query_chunks(Q, ref_points.shape[0], queries.device):
        v, i = torch.topk(sqdist(queries[s:e], ref_points), k, dim=1,
                          largest=False, sorted=True)
        d2[s:e] = v
        idx[s:e] = i.to(torch.int32)
    return idx, d2
