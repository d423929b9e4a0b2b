"""Place recognition: polar scan descriptors, matched against all rotations.

Counterpart of ``laser_slam_tpu/ops/scan_context.py`` (Scan Context,
Kim & Kim, IROS 2018, at the idea level): each scan is summarized by a
polar grid over (radial ring, azimuth sector) whose cell holds the
maximum point height.  Two scans of one place from different headings
differ by a circular shift of the sector axis, so matching scores every
shift and the best one doubles as a yaw guess for the loop-closure ICP.

The whole database is scored against all rotations of the query in one
contraction; there is no ring-key prefilter.  Descriptors are built by a
scatter-max over the padded cloud.

Port notes: the scatter-max ``cells.at[flat].max(..., mode='drop')``
becomes ``scatter_reduce_('amax')`` into an ``R*S + 1`` buffer whose last
(overflow) cell takes the dropped points and is cut off; max is
order-free, so the result is deterministic on the card.  The radius is
``sqrt(x*x + y*y)``, the JAX package's op order, so ring edges fall
where they fall there.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def descriptor(points: torch.Tensor, mask: torch.Tensor, n_rings: int = 20,
               n_sectors: int = 60, max_radius_m: float = 80.0,
               z_offset_m: float = 2.0) -> torch.Tensor:
    """Polar max-height descriptor of one (padded) scan.

    points [N,3] in the sensor frame, mask [N].  Returns [R,S] float32:
    cell (r, s) holds ``max(z + z_offset_m, 0)`` over the points whose
    planar radius falls in ring r and azimuth in sector s; empty cells
    are 0.  ``z_offset_m`` keeps typical ground returns (below the
    sensor) positive so "occupied at ground level" and "empty" differ.
    """
    x, y = points[:, 0], points[:, 1]
    radius = torch.sqrt(x * x + y * y)
    azimuth = torch.atan2(y, x)                       # [-pi, pi]
    ring = torch.floor(radius / max_radius_m * n_rings).to(torch.int64)
    sector = torch.floor((azimuth + math.pi) / (2 * math.pi) * n_sectors
                         ).to(torch.int64)
    sector = torch.clamp(sector, 0, n_sectors - 1)   # azimuth == +pi edge
    valid = mask & (ring >= 0) & (ring < n_rings)
    n_cells = n_rings * n_sectors
    flat = torch.where(valid, ring * n_sectors + sector,
                       torch.full_like(ring, n_cells))
    value = torch.clamp(points[:, 2] + z_offset_m, min=0.0)
    cells = torch.zeros(n_cells + 1, dtype=torch.float32,
                        device=points.device)
    cells.scatter_reduce_(0, flat, torch.where(valid, value,
                                               torch.zeros_like(value)),
                          'amax', include_self=True)
    return cells[:n_cells].reshape(n_rings, n_sectors)


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """Rotation-invariant [R] signature: per-ring occupancy ratio (the
    original method's prefilter; the query path does not need it)."""
    return torch.mean((desc > 0).to(torch.float32), dim=-1)


def _normalize_columns(desc: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit-normalize each sector column of [..., R, S]; zero columns stay
    zero.  Returns (normalized, column-valid mask [..., S])."""
    norm = torch.linalg.norm(desc, dim=-2, keepdim=True)
    valid = norm[..., 0, :] > 0
    return desc / torch.where(norm > 0, norm, torch.ones_like(norm)), valid


def distance_batch(db: torch.Tensor, db_valid: torch.Tensor,
                   query: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan-context distance of ``query`` [R,S] to every database entry.

    db [K,R,S], db_valid [K] bool.  For each entry the distance is
    ``1 - max_shift mean_columns cos(column_db, column_query_shifted)``
    (mean over sector columns where both sides are non-empty), minimized
    over all S circular shifts of the query; the arg-max shift is the yaw
    estimate (the first maximum on ties).

    Returns (dist [K] float32, 2.0 for invalid entries; shift [K] int32).
    """
    S = query.shape[-1]
    dev = query.device
    db_n, db_cv = _normalize_columns(db)          # [K,R,S], [K,S]
    q_n, q_cv = _normalize_columns(query)         # [R,S],   [S]
    # All S rotations of the query: shifted[r, s, j] = q_n[r, (j+s) % S].
    ar = torch.arange(S, device=dev)
    idx = (ar[None, :] + ar[:, None]) % S         # [S,S]
    q_shift = q_n[:, idx]                         # [R, S(shift), S(col)]
    qv_shift = q_cv[idx]                          # [S(shift), S(col)]
    # One contraction scores every (entry, shift) pair.
    corr = torch.einsum('krj,rsj->ks', db_n, q_shift)              # [K,S]
    npairs = torch.einsum('kj,sj->ks', db_cv.to(torch.float32),
                          qv_shift.to(torch.float32))              # [K,S]
    sim = corr / torch.clamp(npairs, min=1.0)
    best = torch.argmax(sim, dim=1)
    dist = 1.0 - torch.gather(sim, 1, best[:, None])[:, 0]
    dist = torch.where(db_valid & (npairs.max(dim=1).values > 0), dist,
                       torch.full_like(dist, 2.0))
    return dist, best.to(torch.int32)


def yaw_from_shift(shift: torch.Tensor, n_sectors: int) -> torch.Tensor:
    """Relative yaw (rad) implied by the matching shift: with ``a_T_b =
    Rz(yaw)`` a point at azimuth t in b appears at t + yaw in a, which
    the match compensates by rolling the query, so yaw = -s * delta
    (wrapped to [-pi, pi))."""
    delta = 2 * math.pi / n_sectors
    yaw = -shift.to(torch.float32) * delta
    return torch.remainder(yaw + math.pi, 2 * math.pi) - math.pi


def best_row(dist: torch.Tensor, shift: torch.Tensor, db_keys: torch.Tensor,
             n_sectors: int) -> torch.Tensor:
    """[3] f32: (matched key, distance, yaw) of the arg-min entry (the
    first on ties), one small tensor so a fetch is a single transfer
    (the JAX package's ``place_recognition._best``)."""
    i = torch.argmin(dist)
    return torch.stack([db_keys[i].to(torch.float32), dist[i],
                        yaw_from_shift(shift[i], n_sectors)])


def descriptor_and_query(db: torch.Tensor, db_keys: torch.Tensor,
                         points: torch.Tensor, mask: torch.Tensor,
                         newest_allowed_key, n_rings: int = 20,
                         n_sectors: int = 60, max_radius_m: float = 80.0,
                         z_offset_m: float = 2.0):
    """Descriptor of a scan and its query against a database table.

    db [K,R,S]; db_keys [K] int32 (global pose key per slot, -1 = empty).
    Entries with key > ``newest_allowed_key`` (a host int or a 0-d device
    tensor) are excluded: the query's temporal neighbours always match.
    Returns (desc [R,S], dist [K], shift [K]).
    """
    desc = descriptor(points, mask, n_rings=n_rings, n_sectors=n_sectors,
                      max_radius_m=max_radius_m, z_offset_m=z_offset_m)
    valid = (db_keys >= 0) & (db_keys <= newest_allowed_key)
    dist, shift = distance_batch(db, valid, desc)
    return desc, dist, shift
