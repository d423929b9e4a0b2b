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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from laser_slam_tpu_torch.config import IcpConfig
from laser_slam_tpu_torch.ops import se3
from laser_slam_tpu_torch.ops.cloud import Cloud
from laser_slam_tpu_torch.ops import neighbors as nb


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


def _trim_mask(d2: torch.Tensor, valid: torch.Tensor, ratio: float,
               method: str = 'sort', d2_max: float = 9.0) -> torch.Tensor:
    """Keep the closest ``ratio`` fraction of valid correspondences
    (TrimmedDistOutlierFilter): threshold = distance quantile among valid
    matches.  'sort' is the exact quantile; 'histogram' a 256-bin
    conservative approximation (rounds the bin up).  The quantile is taken
    along the last axis, per lane."""
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
        thresh_d = (bin_idx.to(torch.float32) + 1.0) / scale
        return valid & (d <= thresh_d)
    big = torch.where(valid, d2, torch.full_like(d2, float('inf')))
    order = torch.sort(big, dim=-1).values
    k = torch.clamp((n_valid.to(torch.float32) * ratio).to(torch.int64),
                    min=1) - 1
    thresh = torch.gather(order, -1,
                          torch.clamp(k, 0, d2.shape[-1] - 1)[..., None])
    return valid & (d2 <= thresh)


def _gauss_newton_step(p_world, q, n, w, damping=1e-6):
    """One point-to-plane GN step.

    Minimizes sum_i w_i (n_i . (p_i - q_i))^2 over a left-multiplicative
    increment exp([omega, v]) applied to the points p.
    J_i = [p_i x n_i, n_i] in R^6.  Over lanes ([B,N,3]) A is [B,6,6], b
    [B,6] and the damping follows each lane's trace.
    """
    r = torch.sum(n * (p_world - q), dim=-1)                   # [...,N]
    J = torch.cat([torch.linalg.cross(p_world, n, dim=-1), n], dim=-1)
    Jw = J * w[..., None]
    A = Jw.mT @ J                                              # [...,6,6]
    eye = torch.eye(6, dtype=A.dtype, device=A.device)
    b = -(Jw.mT @ r[..., None])[..., 0]                        # [...,6]
    trace = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    A = A + damping * eye * (1.0 + trace / 6.0)
    # solve_ex: no error check, so no device read per iteration.
    delta = torch.linalg.solve_ex(A, b)[0]
    return delta, r


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
    if config.matcher not in ('brute', 'pallas', 'projective'):
        raise ValueError(f'unknown ICP matcher {config.matcher!r}; expected '
                         "'brute', 'pallas' or 'projective'")
    max_corr2 = config.max_correspondence_dist_m ** 2
    smooth = config.smooth_length
    dev, dt = reference.points.device, reference.points.dtype
    cap = reference.capacity
    lanes = reading.points.dim() == 3
    per_lane = reference.points.dim() == 3
    if per_lane and not lanes:
        raise ValueError('icp_point_to_plane: a reference per lane needs '
                         'readings with a lane axis')
    lead = reading.points.shape[:-2]        # () or (B,)

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
        if lanes and not per_lane:
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

    S = max(int(config.gn_steps_per_match), 1)

    def run_loop(pts, msk, T0, max_iterations: int):
        """Match/GN loop over a (possibly subset) reading, run for its full
        count with the state frozen once the checkers have fired (lane by
        lane over lanes)."""
        T = T0
        it = torch.zeros(lead, dtype=torch.int32, device=dev)
        hist = torch.full(lead + (smooth, 2), float('inf'), dtype=dt,
                          device=dev)
        done = torch.zeros(lead, dtype=torch.bool, device=dev)
        mean_err = torch.full(lead, float('inf'), dtype=dt, device=dev)
        n_in = torch.zeros(lead, dtype=torch.int32, device=dev)
        for _ in range(max_iterations):
            running = ~done        # JAX's while-cond: it < max_it & ~done
            p_world = se3.apply(T[..., None, :], pts)
            q, n, d2, base_valid = match_payload(p_world, msk)
            valid = base_valid & (d2 <= max_corr2)
            inlier = _trim_mask(d2, valid, config.trimmed_dist_ratio,
                                method=config.trim_method, d2_max=max_corr2)
            w = inlier.to(dt)
            n_new = torch.sum(inlier, dim=-1).to(torch.int32)
            enough = n_new >= MIN_INLIERS
            T_b, it_b, hist_b, done_b, err_b = T, it, hist, done, mean_err
            for _ in range(S):
                p_w = se3.apply(T_b[..., None, :], pts)
                delta, r = _gauss_newton_step(p_w, q, n, w)
                step_on = enough & ~done_b & (it_b < max_iterations)
                delta = torch.where(step_on[..., None], delta,
                                    torch.zeros_like(delta))
                T_b = se3.normalize(se3.compose(se3.exp(delta), T_b))
                # Differential checker window (icp_default.yaml:24-27).
                d_rot = torch.linalg.norm(delta[..., :3], dim=-1)
                d_trans = torch.linalg.norm(delta[..., 3:], dim=-1)
                rolled = torch.cat([hist_b[..., 1:, :],
                                    torch.stack([d_rot, d_trans],
                                                dim=-1)[..., None, :]],
                                   dim=-2)
                hist_b = torch.where(step_on[..., None, None], rolled,
                                     hist_b)
                means = torch.mean(hist_b, dim=-2)
                converged = ((it_b + 1 >= smooth) &
                             (means[..., 0] < config.min_diff_rot) &
                             (means[..., 1] < config.min_diff_trans))
                err_b = torch.where(
                    step_on,
                    torch.sum(torch.abs(r) * w, dim=-1)
                    / torch.clamp(n_new, min=1).to(dt),
                    err_b)
                it_b = it_b + step_on.to(torch.int32)
                done_b = done_b | converged | ~enough
            T = torch.where(running[..., None], T_b, T)
            it = torch.where(running, it_b, it)
            hist = torch.where(running[..., None, None], hist_b, hist)
            mean_err = torch.where(running, err_b, mean_err)
            n_in = torch.where(running, n_new, n_in)
            done = torch.where(running, done_b, done)
            if early_break and dev.type == 'cpu' and bool(torch.all(done)):
                # A host read costs nothing on the CPU: stop where JAX's
                # while loop stops (every later iteration would leave the
                # frozen state as it is); over lanes once all are done.
                break
        return T, it, hist, done, mean_err, n_in

    C = config.coarse_capacity
    T_start = initial_guess
    it_coarse = torch.zeros(lead, dtype=torch.int32, device=dev)
    if C and C < reading.capacity:
        # Coarse phase on a strided subset (one stride for every lane),
        # then refine at full resolution.
        stride = reading.capacity // C
        pts_c = reading.points[..., ::stride, :][..., :C, :]
        msk_c = reading.mask[..., ::stride][..., :C]
        T_c, it_coarse, _, _, _, n_in_c = run_loop(
            pts_c, msk_c, initial_guess, config.coarse_max_iterations)
        T_start = torch.where((n_in_c >= MIN_INLIERS)[..., None], T_c,
                              initial_guess)

    T, it, _, _, mean_err, n_in = run_loop(
        reading.points, reading.mask, T_start, config.max_iterations)

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
