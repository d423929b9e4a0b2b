"""Point-to-plane ICP on fixed shapes.

Counterpart of ``laser_slam_tpu/ops/icp.py`` (the libpointmatcher
pipeline of icp_default.yaml: reading budget, kNN normals on the
reference, exact 1-NN matcher, trimmed-distance outlier filter,
point-to-plane minimizer, counter + differential checkers).

The JAX package's ``lax.while_loop`` exits as soon as the checkers fire.
Here the loop runs its full ``max_iterations`` count with the state
frozen by a ``done`` mask once it would have exited, which reaches the
same fixed point without reading a flag back to the host each
iteration (on the CPU, where that read is free, the loop stops at the
same point as JAX's; ``early_break=False`` runs the card's frozen
iterations there too).  On failure (too few correspondences) the initial
guess is returned and ``IcpResult.valid`` is False.

Lanes.  Readings [B,N,3] with guesses [B,7] register B problems at once,
the JAX package's ``vmap`` of this function in the fleet
(``parallel/fleet.py``): every loop variable gets a lane axis and is
frozen lane by lane, and on the CPU the loop stops once every lane is
done, where the vmapped while loop stops.  The reference is shared
([R,3]: one K1/K2 call, brute search or range image for the flattened
B x N queries) or per lane ([B,R,3]: K1L/K2L, ``nn_brute_lanes`` or one
image a lane).

Point shards.  :func:`icp_point_shards` registers a reading whose point
axis is split into parts that may lie on several devices (the 'sp' axis
of ``parallel/sharding.py``): every part is matched on its own device
by its own matcher (:func:`make_matcher`), and what spans the whole
reading is reduced explicitly onto the guess's device: the trim's
quantile (:func:`trim_shards`), the 6x6 normal equations, the inlier
count and the error sum.  The loop state lives there and goes back to
the parts as a pose a lane.  One part is :func:`icp_point_to_plane`.

GN stage.  On CUDA a GN step is two hand-written CUDA kernels
(``csrc/icp.cu``, float32 only): :func:`gn_sums`, the point-to-plane
sums of every (lane, chunk of points) on each part's device, and
:func:`gn_update`, the damped 6x6 solve, the pose update, the
differential checker and, on the match's last step, the freeze of the
loop state, in place.  On the CPU :func:`gn_stage_plain` runs the same
stage in plain torch; it is also the kernels' test oracle.

Spans.  Each iteration is three spans of ``core/benchmarker.py``, which
cost one flag check unless spans are recorded: ``icp.match`` (the points
transform, the matcher, the payload gathers, the radius test),
``icp.trim`` (the trim, the inlier count) and ``icp.gn`` (the GN steps,
the differential checker, the freeze of the loop state).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from laser_slam_tpu_torch.config import IcpConfig
from laser_slam_tpu_torch.core import benchmarker as bench
from laser_slam_tpu_torch.ops import se3
from laser_slam_tpu_torch.ops.cloud import Cloud
from laser_slam_tpu_torch.ops import neighbors as nb
from laser_slam_tpu_torch.ops.nn_kernels import _check_launch
from laser_slam_tpu_torch.parallel import sharding as shd


class IcpResult(NamedTuple):
    """Result of one ICP solve (0-d tensors except T; over lanes each
    field has a leading [B] axis).

    T: pose7 aligning reading into the reference frame (T @ reading ~ ref).
    valid: correspondence count stayed above the minimum — when False, T
        equals the initial guess (reference fallback semantics).
    iterations: iterations actually executed.
    mean_error: mean |point-to-plane residual| over inliers at the last
        iteration.
    num_inliers: trimmed-inlier count at the last iteration.
    """
    T: torch.Tensor
    valid: torch.Tensor
    iterations: torch.Tensor
    mean_error: torch.Tensor
    num_inliers: torch.Tensor


# Minimum trimmed-inlier count below which the solve is declared failed.
MIN_INLIERS = 24
# The GN system's damping, scaled by 1 + trace / 6 a lane.
GN_DAMPING = 1e-6


def _trim_threshold(d2: torch.Tensor, valid: torch.Tensor, ratio: float,
                    method: str = 'sort', d2_max: float = 9.0
                    ) -> torch.Tensor:
    """The trim's threshold along the last axis, one a lane ([..., 1]):
    the exact ``ratio`` quantile of the valid squared distances for
    'sort'; for 'histogram' the rounded-up edge of a 256-bin histogram
    of the distances (a distance, not a squared one)."""
    n_valid = torch.sum(valid, dim=-1)
    if method == 'histogram':
        bins = 256
        d = torch.sqrt(torch.clamp(d2, max=d2_max))
        scale = bins / (d2_max ** 0.5)
        idx = torch.clamp((d * scale).to(torch.int64), 0, bins - 1)
        idx = torch.where(valid, idx, torch.full_like(idx, bins))
        # One [bins + 1] histogram a lane, in one flat index_add_.
        lanes = n_valid.numel()
        offset = (bins + 1) * torch.arange(lanes, device=d2.device)
        hist = torch.zeros(lanes * (bins + 1), dtype=torch.int64,
                           device=d2.device)
        hist.index_add_(0, (idx + offset.reshape(n_valid.shape + (1,)))
                        .reshape(-1), torch.ones_like(idx).reshape(-1))
        hist = hist.reshape(n_valid.shape + (bins + 1,))
        cum = torch.cumsum(hist[..., :bins], dim=-1)
        target = (n_valid.to(torch.float32) * ratio).to(torch.int64)
        bin_idx = torch.searchsorted(cum, target[..., None])
        return (bin_idx.to(torch.float32) + 1.0) / scale
    big = torch.where(valid, d2, torch.full_like(d2, float('inf')))
    order = torch.sort(big, dim=-1).values
    k = torch.clamp((n_valid.to(torch.float32) * ratio).to(torch.int64),
                    min=1) - 1
    return torch.gather(order, -1,
                        torch.clamp(k, 0, d2.shape[-1] - 1)[..., None])


def _trim_keep(d2: torch.Tensor, valid: torch.Tensor, thresh: torch.Tensor,
               method: str = 'sort', d2_max: float = 9.0) -> torch.Tensor:
    """The valid correspondences within :func:`_trim_threshold`'s
    ``thresh``."""
    if method == 'histogram':
        return valid & (torch.sqrt(torch.clamp(d2, max=d2_max)) <= thresh)
    return valid & (d2 <= thresh)


def _trim_mask(d2: torch.Tensor, valid: torch.Tensor, ratio: float,
               method: str = 'sort', d2_max: float = 9.0) -> torch.Tensor:
    """Keep the closest ``ratio`` fraction of valid correspondences
    (TrimmedDistOutlierFilter): threshold = distance quantile among valid
    matches.  'sort' is the exact quantile; 'histogram' a 256-bin
    conservative approximation (rounds the bin up).  The quantile is taken
    along the last axis, per lane."""
    thresh = _trim_threshold(d2, valid, ratio, method, d2_max)
    return _trim_keep(d2, valid, thresh, method, d2_max)


def trim_shards(d2s, valids, ratio: float, method: str, d2_max: float,
                device):
    """:func:`_trim_mask` of a reading whose point axis is split into the
    parts ``d2s`` / ``valids`` (in order, on any devices): one threshold
    a lane from the whole reading, its parts gathered onto ``device``,
    applied to every part on the part's device.  A quantile taken part
    by part would keep another set.  One part is :func:`_trim_mask`."""
    if len(d2s) == 1:
        return [_trim_mask(d2s[0], valids[0], ratio, method, d2_max)]
    thresh = _trim_threshold(shd.gather_cat(d2s, -1, device),
                             shd.gather_cat(valids, -1, device), ratio,
                             method, d2_max)
    return [_trim_keep(d2, v, shd.to_device(thresh, d2.device), method,
                       d2_max) for d2, v in zip(d2s, valids)]


def _normal_sums(p_world, q, n, w):
    """Point-to-plane normal equations summed over the points (the last
    point axis): A = J^T W J [...,6,6], b = -J^T W r [...,6] and the
    weighted residual sum sum_i w_i |r_i| [...], plus r [...,N];
    r_i = n_i . (p_i - q_i) and J_i = [p_i x n_i, n_i].  The sums of the
    parts of a reading add up to the whole reading's."""
    r = torch.sum(n * (p_world - q), dim=-1)                   # [...,N]
    J = torch.cat([torch.linalg.cross(p_world, n, dim=-1), n], dim=-1)
    Jw = J * w[..., None]
    A = Jw.mT @ J                                              # [...,6,6]
    b = -(Jw.mT @ r[..., None])[..., 0]                        # [...,6]
    return A, b, torch.sum(torch.abs(r) * w, dim=-1), r


def _solve_normal(A, b, damping=GN_DAMPING):
    """The increment [omega, v] from summed normal equations, damped by
    each lane's trace."""
    eye = torch.eye(6, dtype=A.dtype, device=A.device)
    trace = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    A = A + damping * eye * (1.0 + trace / 6.0)
    # solve_ex: no error check, so no device read per iteration.
    return torch.linalg.solve_ex(A, b)[0]


def _gauss_newton_step(p_world, q, n, w, damping=GN_DAMPING):
    """One point-to-plane GN step.

    Minimizes sum_i w_i (n_i . (p_i - q_i))^2 over a left-multiplicative
    increment exp([omega, v]) applied to the points p.
    J_i = [p_i x n_i, n_i] in R^6.  Over lanes ([B,N,3]) A is [B,6,6], b
    [B,6] and the damping follows each lane's trace.
    """
    A, b, _, r = _normal_sums(p_world, q, n, w)
    return _solve_normal(A, b, damping), r


class GnState(NamedTuple):
    """The match/GN loop's state (over lanes each field has a leading
    [B] axis): the pose7, the GN steps taken, the differential checker's
    window [..., smooth, 2] of (|omega|, |v|), whether the checkers have
    fired, the mean |residual| and the inlier count."""
    T: torch.Tensor
    it: torch.Tensor
    hist: torch.Tensor
    done: torch.Tensor
    mean_err: torch.Tensor
    n_in: torch.Tensor


def gn_fused_path(T: torch.Tensor, points) -> bool:
    """Whether the GN stage runs the CUDA kernels (:func:`gn_stage_fused`):
    by device alone, when the pose or any part's points are on CUDA.  The
    kernels take float32 tensors on CUDA and refuse anything else
    (ValueError), so a float64 or mixed-device call there fails rather
    than falling back; CPU tensors run :func:`gn_stage_plain`."""
    return any(t.is_cuda for t in [T, *points])


def gn_stage(points, pairs, inliers, n_new, state: GnState,
             max_iterations: int, config: IcpConfig, fused: bool
             ) -> GnState:
    """The GN stage of one match/GN iteration: ``config.gn_steps_per_match``
    point-to-plane steps, the differential checker, then the freeze of the
    loop state (lane by lane, JAX's while-cond ``it < max_it & ~done``).
    ``points`` are the reading's parts, ``pairs`` each part's matched
    (q, n), ``inliers`` its trimmed inlier mask and ``n_new`` the whole
    reading's inlier count.  While spans are recorded it counts the steps
    (``icp.gn.steps``) and those the kernels took (``icp.gn.steps_fused``),
    host counts that launch nothing."""
    if bench.recording():
        steps = max(int(config.gn_steps_per_match), 1)
        bench.add_count('icp.gn.steps', steps)
        bench.add_count('icp.gn.steps_fused', steps if fused else 0)
    stage = gn_stage_fused if fused else gn_stage_plain
    return stage(points, pairs, inliers, n_new, state, max_iterations,
                 config)


def gn_stage_plain(points, pairs, inliers, n_new, state: GnState,
                   max_iterations: int, config: IcpConfig) -> GnState:
    """:func:`gn_stage` in plain torch: the CPU path (any dtype) and the
    kernels' test oracle.  Sums over the parts are
    reduced onto the state's device in part order."""
    T, it, hist, done, mean_err, n_in = state
    dev = T.device
    dt = points[0].dtype
    smooth = config.smooth_length
    S = max(int(config.gn_steps_per_match), 1)
    ws = [inlier.to(dt) for inlier in inliers]
    enough = n_new >= MIN_INLIERS
    T_b, it_b, hist_b, done_b, err_b = (T, it, hist, done, mean_err)
    for _ in range(S):
        sums = [_normal_sums(
            se3.apply(shd.to_device(T_b, pts.device)[..., None, :], pts),
            q, n, w)[:3] for pts, (q, n), w in zip(points, pairs, ws)]
        A, b, abs_sum = (shd.reduce_sum(list(s), dev) for s in zip(*sums))
        delta = _solve_normal(A, b)
        step_on = enough & ~done_b & (it_b < max_iterations)
        delta = torch.where(step_on[..., None], delta,
                            torch.zeros_like(delta))
        T_b = se3.normalize(se3.compose(se3.exp(delta), T_b))
        # Differential checker window (icp_default.yaml:24-27).
        d_rot = torch.linalg.norm(delta[..., :3], dim=-1)
        d_trans = torch.linalg.norm(delta[..., 3:], dim=-1)
        rolled = torch.cat([hist_b[..., 1:, :],
                            torch.stack([d_rot, d_trans],
                                        dim=-1)[..., None, :]], dim=-2)
        hist_b = torch.where(step_on[..., None, None], rolled, hist_b)
        means = torch.mean(hist_b, dim=-2)
        converged = ((it_b + 1 >= smooth) &
                     (means[..., 0] < config.min_diff_rot) &
                     (means[..., 1] < config.min_diff_trans))
        err_b = torch.where(step_on,
                            abs_sum / torch.clamp(n_new, min=1).to(dt),
                            err_b)
        it_b = it_b + step_on.to(torch.int32)
        done_b = done_b | converged | ~enough
    # JAX's while-cond (it < max_it & ~done) freezes the state.
    running = ~done
    return GnState(T=torch.where(running[..., None], T_b, T),
                   it=torch.where(running, it_b, it),
                   hist=torch.where(running[..., None, None], hist_b, hist),
                   done=torch.where(running, done_b, done),
                   mean_err=torch.where(running, err_b, mean_err),
                   n_in=torch.where(running, n_new, n_in))


def gn_stage_fused(points, pairs, inliers, n_new, state: GnState,
                   max_iterations: int, config: IcpConfig) -> GnState:
    """:func:`gn_stage` on the card, two launches a GN step
    (``csrc/icp.cu``): :func:`gn_sums` on each part's device, the parts'
    chunk sums gathered onto the state's device in part order, then one
    :func:`gn_update`, whose last step freezes ``state`` in place.  The
    state's tensors must be contiguous and the caller's own."""
    dev = state.T.device
    S = max(int(config.gn_steps_per_match), 1)
    src = state[:5]
    steps = None
    for k in range(S):
        partial = shd.gather_cat(
            [gn_sums(pts, q, n, w, shd.to_device(src[0], pts.device))
             for pts, (q, n), w in zip(points, pairs, inliers)], 1, dev)
        last = k == S - 1
        if last:
            dst = state[:5]
        else:
            if steps is None:
                steps = tuple(torch.empty_like(x) for x in src)
            dst = steps
        gn_update(partial, n_new, src, dst, state.n_in if last else None,
                  max_iterations, config)
        src = dst
    return state


# --------------------------------------------------------------------------
# The GN kernels (csrc/icp.cu)
# --------------------------------------------------------------------------

# Points a gn_sums block sums (csrc/icp.cu GN_CHUNK): the chunk count
# depends on N alone, so a lane's sums do not depend on its batch.
GN_CHUNK = 1024
GN_SUMS = 28

_lib = None


def _kernels() -> ctypes.CDLL:
    """Build (first use only) and bind the kernels of ``csrc/icp.cu``."""
    global _lib
    if _lib is None:
        from laser_slam_tpu_torch.ops.cuda_build import load_library
        lib = load_library('icp.cu')
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ll, d = ctypes.c_longlong, ctypes.c_double
        lib.lsl_gn_sums.argtypes = [p, ll, ll, p, ll, ll, p, ll, ll, p, ll,
                                    ll, p, ll, i, i, p, i, p]
        lib.lsl_gn_sums.restype = i
        lib.lsl_gn_update.argtypes = [p, i, p, i, i, i, i, f, f, d, p, p, p,
                                      p, p, p, p, p, p, p, p, i, i, p]
        lib.lsl_gn_update.restype = i
        _lib = lib
    return _lib


def _rows(a: torch.Tensor, lanes: bool):
    """``a`` with unit stride along its last axis (rows of 3 floats) and
    its (lane, row) strides in elements; the lane stride is 0 without a
    lane axis."""
    if a.dim() - lanes == 2 and a.stride(-1) != 1:
        a = a.contiguous()
    row = a.stride(-2) if a.dim() - lanes == 2 else a.stride(-1)
    return a, (a.stride(0) if lanes else 0), row


def _check(name: str, cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f'{name}: {msg}')


def gn_sums(pts, q, n, inlier, T) -> torch.Tensor:
    """``gn_sums_kernel``: the point-to-plane sums of one part of a
    reading, GN_SUMS a (lane, chunk of GN_CHUNK points): the 21 upper
    entries of J^T W J (row-major), the 6 of -J^T W r and sum w |r|, the
    points taken through ``T`` and weighted by the bool ``inlier``.
    pts, q, n [B,N,3] or [N,3] float32, inlier [B,N] or [N], T [B,7] or
    [7], all on one card; returns [B, ceil(N / GN_CHUNK), GN_SUMS]
    (B = 1 without a lane axis)."""
    lanes = pts.dim() == 3
    B, N = (pts.shape[0] if lanes else 1), pts.shape[-2]
    for key, a in (('pts', pts), ('q', q), ('n', n), ('T', T)):
        _check('gn_sums', a.dtype == torch.float32 and a.is_cuda
               and a.device == pts.device, f'{key} must be float32 on '
               f'{pts.device}, got {a.dtype} on {a.device}')
    _check('gn_sums', inlier.dtype == torch.bool
           and inlier.shape == pts.shape[:-1]
           and inlier.device == pts.device, 'inlier must be a bool mask of '
           'the points on their device')
    _check('gn_sums', q.shape == pts.shape and n.shape == pts.shape
           and T.shape == pts.shape[:-2] + (7,) and T.stride(-1) == 1,
           'shapes of q, n or T do not match the points')
    chunks = -(-N // GN_CHUNK)
    partial = torch.empty((B, chunks, GN_SUMS), dtype=torch.float32,
                          device=pts.device)
    if chunks == 0:
        return partial
    pts, pl, pr = _rows(pts, lanes)
    q, ql, qr = _rows(q, lanes)
    n, nl, nr = _rows(n, lanes)
    _, wl, wr = _rows(inlier, lanes)
    err = _kernels().lsl_gn_sums(
        pts.data_ptr(), pl, pr, q.data_ptr(), ql, qr, n.data_ptr(), nl, nr,
        inlier.data_ptr(), wl, wr, T.data_ptr(), T.stride(0) if lanes else 0,
        B, N, partial.data_ptr(), pts.device.index,
        torch.cuda.current_stream(pts.device).cuda_stream)
    _check_launch('gn_sums', err)
    gn_sums.launches += 1
    return partial


gn_sums.launches = 0


def gn_update(partial, n_new, src, dst, n_in, max_iterations: int,
              config: IcpConfig) -> None:
    """``gn_update_kernel``: one GN step of every lane from its chunk sums
    ``partial`` [B, C, GN_SUMS] and the inlier count ``n_new``.  Reads
    the step's state ``src`` (T, it, hist, done, mean_err), writes it to
    ``dst`` (may be ``src``).  With ``n_in`` given, ``dst`` is the loop
    state and the step is the match's last: lanes done in ``dst`` keep
    their state, the others take the step's and ``n_in = n_new``."""
    dev = partial.device
    B, C = partial.shape[0], partial.shape[1]
    freeze = n_in is not None
    _check('gn_update', partial.is_cuda and partial.dtype == torch.float32
           and partial.is_contiguous() and partial.shape[2:] == (GN_SUMS,),
           f'partial must be contiguous float32 [B, C, {GN_SUMS}] on CUDA, '
           f'got {partial.dtype} {tuple(partial.shape)} on {dev}')
    kinds = ((torch.float32, 7), (torch.int32, 1),
             (torch.float32, 2 * config.smooth_length), (torch.bool, 1),
             (torch.float32, 1))
    for a, (dtype, size) in [*zip(src, kinds), *zip(dst, kinds),
                             (n_new, kinds[1])] + ([(n_in, kinds[1])]
                                                   if freeze else []):
        _check('gn_update', a.device == dev and a.dtype == dtype
               and a.is_contiguous() and a.numel() == B * size,
               f'expected a contiguous {dtype} tensor of {size} a lane '
               f'for {B} lanes on {dev}, got {a.dtype} {tuple(a.shape)} on '
               f'{a.device}')
    err = _kernels().lsl_gn_update(
        partial.data_ptr(), C, n_new.data_ptr(), B, config.smooth_length,
        max_iterations, MIN_INLIERS, config.min_diff_rot,
        config.min_diff_trans, GN_DAMPING, *(a.data_ptr() for a in src),
        *(a.data_ptr() for a in dst),
        n_in.data_ptr() if freeze else None, int(freeze), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _check_launch('gn_update', err)
    gn_update.launches += 1


gn_update.launches = 0


def make_matcher(reference: Cloud, ref_normals: torch.Tensor,
                 config: IcpConfig, prebuilt_image=None):
    """The correspondence search of ``config.matcher`` against one
    reference, built once (the pruned kernel's Morton tables, a range
    image): ``match(p_world, mask) -> (q, n, d2, valid)``, each query's
    reference point and normal, squared distance and validity.  The
    reference is shared ([R,3]; queries with a lane axis are searched
    flattened) or one a lane ([B,R,3]); see :func:`icp_point_to_plane`."""
    if config.matcher not in ('brute', 'pallas', 'projective'):
        raise ValueError(f'unknown ICP matcher {config.matcher!r}; expected '
                         "'brute', 'pallas' or 'projective'")
    dev = reference.points.device
    cap = reference.capacity
    per_lane = reference.points.dim() == 3

    def ext(a, fill_shape):
        # One extra dead row so a miss index (== capacity) gathers a
        # well-defined row (a dead row a lane for per-lane references).
        fill = a.shape[:-len(fill_shape)] + fill_shape
        return torch.cat([a, torch.zeros(fill, dtype=a.dtype, device=dev)],
                         dim=-len(fill_shape))

    def take(a, idx):
        """Rows ``idx`` [...,N] of a shared table, or of each lane's."""
        if not per_lane:
            return a[idx]
        if a.dim() == 2:
            return torch.gather(a, 1, idx)
        return torch.gather(a, 1, idx[..., None].expand(
            idx.shape + a.shape[2:]))

    def find(p_world):
        """The matcher's ``search`` (defined below) for every lane's
        queries: against their own lane's reference, or all at once
        against a shared one ([B,N,3] -> [B*N,3] and back)."""
        if p_world.dim() == 3 and not per_lane:
            out = search(p_world.reshape(-1, 3))
            return tuple(o.reshape(p_world.shape[:-1]) for o in out)
        return search(p_world)

    ref_ext_pts = ext(reference.points, (1, 3))
    ref_ext_normals = ext(ref_normals, (1, 3))
    ref_ext_mask = ext(reference.mask, (1,))

    if config.matcher == 'projective':
        from laser_slam_tpu_torch.ops import range_image as ri
        image = prebuilt_image
        if image is None:
            image = ri.build_range_image(
                reference, ref_normals, rows=config.range_image_rows,
                cols=config.range_image_cols,
                elev_min=config.range_image_elev_min,
                elev_max=config.range_image_elev_max,
                window=config.range_image_window)

        def match_payload(p_world, msk):
            # Empty windows come back with d2 = inf, which the radius
            # test drops; the reading mask passes through unchanged.
            q, n, d2 = ri.nn_projective(p_world, image)
            return q, n, d2, msk
    elif config.matcher == 'pallas':
        from laser_slam_tpu_torch.ops import nn_kernels
        # The kernels read dense rows: a lane's slice of a scan sequence
        # is copied once here, not at every iteration.
        ref_rows = reference.points.contiguous()
        if config.pallas_prune:
            # Morton-sorted AABB-pruned kernel (K2, K2L per lane): exact
            # within the correspondence radius.  Sorted once per call —
            # the reference is fixed across iterations.
            if per_lane:
                pref = nn_kernels.build_pruned_ref_lanes(ref_rows)

                def search(p_world):
                    return nn_kernels.nn_indices_pruned_lanes(
                        p_world, pref,
                        cutoff=config.max_correspondence_dist_m)
            else:
                pref = nn_kernels.build_pruned_ref(ref_rows)

                def search(p_world):
                    return nn_kernels.nn_indices_pruned(
                        p_world, pref,
                        cutoff=config.max_correspondence_dist_m)
            perm = pref.perm.long()
            s_ext_pts = ext(take(reference.points, perm), (1, 3))
            s_ext_normals = ext(take(ref_normals, perm), (1, 3))

            def match_payload(p_world, msk):
                d2, idx = find(p_world)
                idx = torch.clamp(idx.long(), 0, cap)
                return (take(s_ext_pts, idx), take(s_ext_normals, idx), d2,
                        msk)
        else:
            def search(p_world):
                if per_lane:
                    return nn_kernels.nn_indices_lanes(p_world, ref_rows)
                return nn_kernels.nn_indices(p_world, ref_rows)

            def match_payload(p_world, msk):
                d2, idx = find(p_world)
                idx = idx.long()
                return (take(ref_ext_pts, idx), take(ref_ext_normals, idx),
                        d2, msk)
    else:
        def search(p_world):
            if per_lane:
                return nb.nn_brute_lanes(p_world, reference.points)
            return nb.nn_brute(p_world, reference.points)

        def match_payload(p_world, msk):
            idx, d2 = find(p_world)
            idx = torch.clamp(idx.long(), 0, cap)
            return (take(ref_ext_pts, idx), take(ref_ext_normals, idx), d2,
                    msk & take(ref_ext_mask, idx))
    return match_payload


def icp_point_to_plane(reading: Cloud, reference: Cloud,
                       ref_normals: torch.Tensor,
                       initial_guess: torch.Tensor,
                       config: IcpConfig,
                       prebuilt_image=None,
                       early_break: bool = True) -> IcpResult:
    """Align ``reading`` to ``reference`` starting from ``initial_guess``.

    ``ref_normals`` are per-reference-point unit normals in the reference
    frame.  The matcher comes from ``config.matcher``: 'pallas' runs the
    CUDA kernels of ``ops/nn_kernels.py`` (K2 with ``pallas_prune``, K1
    without), 'brute' the plain torch search, 'projective' the range
    image of ``ops/range_image.py`` (``prebuilt_image`` supplies one
    built beforehand, for many readings against one reference).
    ``early_break=False`` keeps a CPU run in the loop past convergence,
    through the frozen iterations the card runs; the result is the same.

    Readings [B,N,3] (mask [B,N]) with guesses [B,7] run B registrations
    at once against a shared reference [R,3] or one reference a lane
    [B,R,3] (normals alike); a ``prebuilt_image`` then has one lane or B.
    """
    if reference.points.dim() == 3 and reading.points.dim() != 3:
        raise ValueError('icp_point_to_plane: a reference per lane needs '
                         'readings with a lane axis')
    match = make_matcher(reference, ref_normals, config, prebuilt_image)
    return icp_point_shards([reading], [match], initial_guess, config,
                            early_break)


def icp_point_shards(readings, matchers, initial_guess: torch.Tensor,
                     config: IcpConfig,
                     early_break: bool = True) -> IcpResult:
    """:func:`icp_point_to_plane` of one reading split along its point
    axis: ``readings`` are its parts in order (Clouds [...,N_i,3], on any
    devices), ``matchers`` one :func:`make_matcher` a part, on the part's
    device.  The loop state and the result live on ``initial_guess``'s
    device, onto which every sum over the whole reading is reduced (the
    trim's quantile, the normal equations, the inlier count, the error
    sum); each part receives the pose a lane.  The coarse phase takes
    the points of the global stride that lie in each part, so the parts
    together pick what the whole reading picks."""
    max_corr2 = config.max_correspondence_dist_m ** 2
    smooth = config.smooth_length
    dev = initial_guess.device
    dt = readings[0].points.dtype
    lead = readings[0].points.shape[:-2]        # () or (B,)

    def run_loop(parts, T0, max_iterations: int):
        """Match/GN loop over a (possibly subset) reading in ``parts``
        (points, mask, matcher), run for its full count with the state
        frozen once the checkers have fired (lane by lane over lanes)."""
        points = [pts for pts, _, _ in parts]
        fused = gn_fused_path(T0, points)
        T = T0
        if fused:
            # The kernels update the loop state in place: T0 is the
            # caller's.
            T = T0.expand(lead + (7,)).clone(
                memory_format=torch.contiguous_format)
        it = torch.zeros(lead, dtype=torch.int32, device=dev)
        hist = torch.full(lead + (smooth, 2), float('inf'), dtype=dt,
                          device=dev)
        done = torch.zeros(lead, dtype=torch.bool, device=dev)
        mean_err = torch.full(lead, float('inf'), dtype=dt, device=dev)
        n_in = torch.zeros(lead, dtype=torch.int32, device=dev)
        state = GnState(T, it, hist, done, mean_err, n_in)
        for _ in range(max_iterations):
            with bench.span('icp.match'):
                matched = []
                for pts, msk, match in parts:
                    p_world = se3.apply(
                        shd.to_device(state.T, pts.device)[..., None, :],
                        pts)
                    q, n, d2, base_valid = match(p_world, msk)
                    matched.append((q, n, d2,
                                    base_valid & (d2 <= max_corr2)))
            with bench.span('icp.trim'):
                inliers = trim_shards([m[2] for m in matched],
                                      [m[3] for m in matched],
                                      config.trimmed_dist_ratio,
                                      config.trim_method, max_corr2, dev)
                n_new = shd.reduce_sum([torch.sum(inlier, dim=-1)
                                        for inlier in inliers],
                                       dev).to(torch.int32)
            with bench.span('icp.gn'):
                state = gn_stage(points, [m[:2] for m in matched], inliers,
                                 n_new, state, max_iterations, config, fused)
            if (early_break and dev.type == 'cpu'
                    and bool(torch.all(state.done))):
                # A host read costs nothing on the CPU: stop where JAX's
                # while loop stops (every later iteration would leave the
                # frozen state as it is); over lanes once all are done.
                break
        return state

    C = config.coarse_capacity
    N = sum(r.capacity for r in readings)
    T_start = initial_guess
    it_coarse = torch.zeros(lead, dtype=torch.int32, device=dev)
    if C and C < N:
        # Coarse phase on a strided subset (one stride for every lane):
        # global points 0, stride, ..., (C-1) stride, each taken in the
        # part that holds it; then refine at full resolution.
        stride = N // C
        coarse, offset = [], 0
        for r, match in zip(readings, matchers):
            start = (-offset) % stride
            stop = min(r.capacity, C * stride - offset)
            if stop > start:
                coarse.append((r.points[..., start:stop:stride, :],
                               r.mask[..., start:stop:stride], match))
            offset += r.capacity
        T_c, it_coarse, _, _, _, n_in_c = run_loop(
            coarse, initial_guess, config.coarse_max_iterations)
        T_start = torch.where((n_in_c >= MIN_INLIERS)[..., None], T_c,
                              initial_guess)

    T, it, _, _, mean_err, n_in = run_loop(
        [(r.points, r.mask, m) for r, m in zip(readings, matchers)],
        T_start, config.max_iterations)

    ok = n_in >= MIN_INLIERS
    T_final = torch.where(ok[..., None], T, initial_guess)
    return IcpResult(T=T_final, valid=ok, iterations=it + it_coarse,
                     mean_error=mean_err, num_inliers=n_in)


def icp(reading: Cloud, reference: Cloud, ref_normals, initial_guess,
        config: IcpConfig) -> IcpResult:
    """Entry point (the JAX package's jitted wrapper); picks the matcher
    from ``config.matcher``."""
    return icp_point_to_plane(reading, reference, ref_normals,
                              initial_guess, config)
