"""Projective correspondence and normals via spherical range images.

Counterpart of ``laser_slam_tpu/ops/range_image.py``.  The fast ICP
matcher renders the reference cloud once into a spherical range image
from the sensor origin (a z-buffer scatter-min), then finds each reading
point's correspondence by projecting it to a pixel and testing the
pixel's search window — the LOAM / KinectFusion / KISS-ICP projective
data association.  The same renders give per-point normals: the
cross product of the image tangents, or a PCA over each pixel's window.

Port notes:
* ``_project`` keeps the JAX arithmetic (``arcsin``, ``atan2``, a
  truncating cast); one ulp of difference between the two libraries'
  ``arcsin``/``atan2`` can move a point on a pixel boundary to the next
  pixel.
* The z-buffer winner write is ``.at[where(winner, flat, n_pix)].set``
  in JAX, where the order among exact-depth ties is the backend's.  Here
  the tie goes to the lowest point index (a second ``amin`` scatter over
  indices), which is deterministic on the card as well.
* The matcher's window: JAX packs each pixel's whole window into one
  ``[rows*cols, W*7]`` row, because TPU gathers pay per row.  On the
  GPU a gather pays per byte, so :class:`RangeImage` keeps the
  ``[rows*cols, 7]`` slot image (plus one empty row for window cells
  above the top or below the bottom row) and :func:`nn_projective`
  reads the W cells of each query's window from it by index.  The
  results are the same: the same candidates in the same order, empty
  where JAX's rolled rows are zero.
* Lanes: a reference [B,R,3] renders B images into one flat slot table,
  lane b's pixel p at row ``b * rows * cols + p``, with one empty row
  after all of them that every lane's out-of-image window cells read;
  queries [B,N,3] read their own lane's image.  This is the JAX package's
  ``vmap`` of the build and the match in the fleet.  A shared reference
  needs one image for every lane: pass the queries flattened, or [B,N,3]
  against a one-lane image.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from laser_slam_tpu_torch.ops.cloud import (Cloud, _smallest_eigvec_3x3,
                                            estimate_normals)

# Default Velodyne-like vertical field of view (radians).
DEFAULT_ELEV_MIN = -0.45
DEFAULT_ELEV_MAX = 0.25


class RangeImage(NamedTuple):
    """Rendered reference: per-pixel nearest point + normal + depth.

    ``slots`` is ``[rows*cols + 1, 7]``: point(3) + normal(3) +
    occupied(1) per pixel, then one empty row that window cells beyond
    the top or bottom row read.  An image of ``lanes`` lanes holds each
    lane's pixels one after the other (``[lanes*rows*cols (+1), ...]``)."""
    payload: torch.Tensor    # [rows*cols, 6] (point xyz, normal xyz)
    depth: torch.Tensor      # [rows*cols] range (inf = empty)
    slots: torch.Tensor      # [rows*cols + 1, 7]
    rows: int
    cols: int
    elev_min: float
    elev_max: float
    window: str
    lanes: int = 1


def _window_offsets(window: str):
    if window == 'cross':
        return ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
    if window == '5x5':
        return tuple((dr, dc) for dr in range(-2, 3) for dc in range(-2, 3))
    return tuple((dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1))


def _norm(points: torch.Tensor) -> torch.Tensor:
    # torch.linalg.norm rounds as jnp.linalg.norm does on the CPU (a
    # plain sum of squares differs by an ulp in ~10% of points).
    return torch.linalg.norm(points, dim=-1)


def _project(points, rows: int, cols: int, elev_min: float,
             elev_max: float):
    """Points -> (row, col, range); row and col int64, clipped to the
    image."""
    r = _norm(points)
    r_safe = torch.clamp(r, min=1e-9)
    elev = torch.arcsin(torch.clamp(points[..., 2] / r_safe, -1.0, 1.0))
    az = torch.atan2(points[..., 1], points[..., 0])
    row = (elev - elev_min) / (elev_max - elev_min) * rows
    col = (az + math.pi) / (2.0 * math.pi) * cols
    # Truncation toward zero, as XLA's f32 -> int32 convert.
    return (torch.clamp(row.to(torch.int32), 0, rows - 1).long(),
            torch.clamp(col.to(torch.int32), 0, cols - 1).long(),
            r)


def _zbuffer(flat: torch.Tensor, r: torch.Tensor, mask: torch.Tensor,
             n_pix: int):
    """Closest point per pixel: (depth [n_pix] with inf where empty,
    winner [n_pix] point index or N where empty).  Exact-depth ties go to
    the lowest index."""
    n = flat.shape[0]
    depth = torch.full((n_pix,), math.inf, dtype=r.dtype, device=r.device)
    depth.scatter_reduce_(0, flat, r, reduce='amin')
    is_winner = mask & (r <= depth[flat])
    winner = torch.full((n_pix + 1,), n, dtype=torch.int64, device=r.device)
    winner.scatter_reduce_(
        0, torch.where(is_winner, flat, torch.full_like(flat, n_pix)),
        torch.arange(n, device=r.device), reduce='amin')
    return depth, winner[:n_pix]


def _winner_rows(values: torch.Tensor, winner: torch.Tensor) -> torch.Tensor:
    """values[winner], zero where the pixel is empty (winner == N)."""
    ext = torch.cat([values, torch.zeros((1,) + values.shape[1:],
                                         dtype=values.dtype,
                                         device=values.device)])
    return ext[winner]


def build_range_image(reference: Cloud, ref_normals, rows: int = 64,
                      cols: int = 1024, elev_min: float = DEFAULT_ELEV_MIN,
                      elev_max: float = DEFAULT_ELEV_MAX,
                      window: str = '3x3') -> RangeImage:
    """Render the reference cloud (in its own sensor frame) into a range
    image keeping the CLOSEST point per pixel; a reference [B,R,3] renders
    one image a lane."""
    pts = reference.points
    lanes = pts.shape[0] if pts.dim() == 3 else 1
    row, col, r = _project(pts, rows, cols, elev_min, elev_max)
    n_pix = rows * cols
    flat = row * cols + col
    mask = reference.mask
    if pts.dim() == 3:
        flat = (flat + n_pix * torch.arange(lanes, device=flat.device)
                [:, None]).reshape(-1)
        r, mask = r.reshape(-1), mask.reshape(-1)
        pts, ref_normals = pts.reshape(-1, 3), ref_normals.reshape(-1, 3)
    r = torch.where(mask, r, torch.full_like(r, math.inf))
    depth, winner = _zbuffer(flat, r, mask, lanes * n_pix)
    payload = _winner_rows(torch.cat([pts, ref_normals], dim=1), winner)
    occupied = torch.isfinite(depth).to(payload.dtype)
    slots = torch.cat([torch.cat([payload, occupied[:, None]], dim=1),
                       torch.zeros((1, 7), dtype=payload.dtype,
                                   device=payload.device)])
    return RangeImage(payload=payload, depth=depth, slots=slots, rows=rows,
                      cols=cols, elev_min=elev_min, elev_max=elev_max,
                      window=window, lanes=lanes)


def range_image_normals(cloud: Cloud, rows: int = 64, cols: int = 1024,
                        elev_min: float = DEFAULT_ELEV_MIN,
                        elev_max: float = DEFAULT_ELEV_MAX) -> torch.Tensor:
    """Per-point normals from the cross product of the horizontal and
    vertical pixel tangents of the scan's own range image — O(N).
    Oriented toward the sensor; points whose pixel lacks valid neighbours
    get +z."""
    pts = cloud.points
    row, col, _ = _project(pts, rows, cols, elev_min, elev_max)
    flat = row * cols + col
    n_pix = rows * cols
    r = torch.where(cloud.mask, _norm(pts), torch.full_like(pts[:, 0],
                                                             math.inf))
    depth, winner = _zbuffer(flat, r, cloud.mask, n_pix)
    occupied = torch.isfinite(depth).reshape(rows, cols)
    img = _winner_rows(pts, winner).reshape(rows, cols, 3)

    # Tangents from horizontal (azimuth wraps) and vertical neighbours.
    right = torch.roll(img, -1, dims=1)
    occ_right = torch.roll(occupied, -1, dims=1)
    left = torch.roll(img, 1, dims=1)
    occ_left = torch.roll(occupied, 1, dims=1)
    du = torch.where(occ_right[..., None], right - img, img - left)
    du_ok = occ_right | occ_left
    down = torch.cat([img[1:], img[-1:]], dim=0)
    occ_down = torch.cat([occupied[1:], occupied[-1:]], dim=0)
    up = torch.cat([img[:1], img[:-1]], dim=0)
    occ_up = torch.cat([occupied[:1], occupied[:-1]], dim=0)
    dv = torch.where(occ_down[..., None], down - img, img - up)
    dv_ok = occ_down | occ_up

    n = torch.linalg.cross(du, dv, dim=-1)
    norm = torch.sqrt(torch.clamp(torch.sum(n * n, dim=-1, keepdim=True),
                                  min=1e-30))
    n = n / norm
    good = (occupied & du_ok & dv_ok & (norm[..., 0] > 1e-12)).reshape(-1)
    up_z = torch.tensor([0.0, 0.0, 1.0], dtype=pts.dtype, device=pts.device)
    n_flat = torch.where(good[:, None], n.reshape(-1, 3), up_z)

    out = n_flat[flat]
    flip = torch.sum(out * pts, dim=-1, keepdim=True) > 0
    out = torch.where(flip, -out, out)
    return torch.where(cloud.mask[:, None], out, up_z)


def range_image_pca_normals(cloud: Cloud, rows: int = 64, cols: int = 1024,
                            elev_min: float = DEFAULT_ELEV_MIN,
                            elev_max: float = DEFAULT_ELEV_MAX,
                            window: str = '5x5') -> torch.Tensor:
    """Per-point normals from a PCA over the point's range-image window.

    The PCA runs once per PIXEL over rolled images (every point sharing a
    pixel sees the same window), on neighbour coordinates centred on the
    pixel's own z-buffer winner; each point then reads its pixel's
    normal.  Windows with fewer than 3 samples give +z."""
    pts = cloud.points
    row, col, r = _project(pts, rows, cols, elev_min, elev_max)
    flat = row * cols + col
    r = torch.where(cloud.mask, r, torch.full_like(r, math.inf))
    n_pix = rows * cols
    depth, winner = _zbuffer(flat, r, cloud.mask, n_pix)
    occ = torch.isfinite(depth).to(pts.dtype)

    grid_p = _winner_rows(pts, winner).reshape(rows, cols, 3)
    grid_o = occ.reshape(rows, cols, 1)
    n_s = torch.zeros((rows, cols, 1), dtype=pts.dtype, device=pts.device)
    s = torch.zeros((rows, cols, 3), dtype=pts.dtype, device=pts.device)
    outer = torch.zeros((rows, cols, 3, 3), dtype=pts.dtype,
                        device=pts.device)
    for dr, dc in _window_offsets(window):
        sp = torch.roll(grid_p, (-dr, -dc), dims=(0, 1))
        so = torch.roll(grid_o, (-dr, -dc), dims=(0, 1))
        if dr < 0:    # top rows have no upper neighbour
            so[:(-dr)] = 0.0
        elif dr > 0:  # bottom rows have no lower neighbour
            so[-dr:] = 0.0
        # column rolls wrap naturally (azimuth wraps)
        d = (sp - grid_p) * so
        n_s = n_s + so
        s = s + d
        outer = outer + d[..., :, None] * d[..., None, :]
    n_c = torch.clamp(n_s, min=1.0)
    mean = s / n_c
    cov = outer / n_c[..., None] - mean[..., :, None] * mean[..., None, :]
    pix_normal = _smallest_eigvec_3x3(cov.reshape(n_pix, 3, 3))
    pix_ok = n_s.reshape(n_pix) >= 3.0

    normal = pix_normal[flat]                    # narrow [N,3] gather
    flip = torch.sum(normal * pts, dim=-1, keepdim=True) > 0
    normal = torch.where(flip, -normal, normal)
    ok = pix_ok[flat] & cloud.mask
    up_z = torch.tensor([0.0, 0.0, 1.0], dtype=pts.dtype, device=pts.device)
    return torch.where(ok[:, None], normal, up_z)


def compute_normals(cloud: Cloud, icp_config) -> torch.Tensor:
    """Per-scan normals dispatched on ``IcpConfig.normal_method``.

    ``'auto'`` picks ``'image_pca'`` for scans of 8192 points or more
    (capacity) and ``'knn'`` below; ``'range_image'`` is the tangent
    cross product; ``'knn'`` is kNN PCA (:func:`cloud.estimate_normals`).
    """
    method = icp_config.normal_method
    if method == 'auto':
        method = 'image_pca' if cloud.points.shape[0] >= 8192 else 'knn'
    if method == 'range_image':
        return range_image_normals(
            cloud, rows=icp_config.normal_image_rows,
            cols=icp_config.normal_image_cols,
            elev_min=icp_config.range_image_elev_min,
            elev_max=icp_config.range_image_elev_max)
    if method == 'image_pca':
        return range_image_pca_normals(
            cloud, rows=icp_config.normal_image_rows,
            cols=icp_config.normal_image_cols,
            elev_min=icp_config.range_image_elev_min,
            elev_max=icp_config.range_image_elev_max)
    if method != 'knn':
        raise ValueError(f'unknown normal_method {method!r}')
    return estimate_normals(cloud, knn=icp_config.normal_knn)


def _window_index(row, col, image: RangeImage) -> torch.Tensor:
    """Slot rows [..., Q, W] of each query pixel's window: columns wrap,
    cells beyond the top or bottom row read the empty last row.  Queries
    [B,Q] of a lane image read their own lane's pixels."""
    rows, cols = image.rows, image.cols
    off = torch.tensor(_window_offsets(image.window), dtype=torch.int64,
                       device=row.device)
    r2 = row[..., None] + off[:, 0]
    c2 = torch.remainder(col[..., None] + off[:, 1], cols)
    inside = (r2 >= 0) & (r2 < rows)
    cell = r2 * cols + c2
    if row.dim() == 2:
        cell = cell + (rows * cols * torch.arange(
            image.lanes, device=row.device))[:, None, None]
    return torch.where(inside, cell,
                       torch.full_like(r2, image.lanes * rows * cols))


def nn_projective(queries: torch.Tensor, image: RangeImage):
    """Projective 1-NN: project each query, test its pixel window, return
    (nearest point [Q,3], normal [Q,3], sq distance [Q]).  The first
    window cell wins a tie; inf where the whole window is empty.  Queries
    [B,Q,3] give [B,Q] results: against their own lanes of a lane image,
    or all against a one-lane image."""
    if queries.dim() == 3 and image.lanes == 1:
        q, n, d2 = nn_projective(queries.reshape(-1, 3), image)
        B, Q = queries.shape[:2]
        return q.reshape(B, Q, 3), n.reshape(B, Q, 3), d2.reshape(B, Q)
    if queries.dim() == 3 and queries.shape[0] != image.lanes:
        raise ValueError(f'nn_projective: {queries.shape[0]} lanes of '
                         f'queries against an image of {image.lanes}')
    row, col, _ = _project(queries, image.rows, image.cols, image.elev_min,
                           image.elev_max)
    cand = image.slots[_window_index(row, col, image)]     # [...,Q,W,7]
    d = cand[..., 0:3] - queries[..., None, :]
    d2 = torch.sum(d * d, dim=-1)
    d2 = torch.where(cand[..., 6] > 0.5, d2, torch.full_like(d2, math.inf))
    best_d2, best = torch.min(d2, dim=-1)
    sel = torch.gather(cand, -2, best[..., None, None].expand(
        best.shape + (1, 7)))[..., 0, :]
    return sel[..., 0:3], sel[..., 3:6], best_d2
