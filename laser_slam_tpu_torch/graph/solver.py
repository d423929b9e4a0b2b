"""Gauss-Newton / PCG pose-graph solver on SE(3), core.

Counterpart of the core of ``laser_slam_tpu/graph/solver.py``: every
``solve`` runs ``gn_iterations`` Gauss-Newton steps over the padded
graph, each solved by preconditioned conjugate gradients, warm-started
from the caller's estimate (the reference's three ``isam2_.update()``
calls per scan, incremental_estimator.cpp:151-163).

Numerical notes (as in the JAX package):
* Priors with sqrt-info above ``GAUGE_FIX_THRESHOLD`` (the reference's
  sigma=1e-7 first-node prior) are gauge constraints: the pose is frozen
  and snapped to the prior instead of weighted, which keeps f32
  conditioning.  Deactivating the prior unfreezes the pose.
* Jacobians are analytic (adjoint + second-order inverse right Jacobian).

Port notes: JAX's out-of-bounds ``mode='drop'`` scatters become writes
into one extra overflow row that is cut off; duplicate-index ``.at[].add``
becomes ``index_add_``.  The PCG ``lax.while_loop`` runs its full
iteration count with the state frozen once converged (no device read per
iteration).  The ``lax.cond`` between the chain and scatter matvecs is
decided on the host from ``offchain``, the caller's upper bound on the
active off-chain factors (the online runner knows every factor's keys);
a call without it reads one count per linearization.  The GN early-out
(``gn_tolerance``) masks the later steps' results instead of skipping
them, so every step runs.  The dense method and the Woodbury capacitance
factor with ``cholesky_ex`` (no error check, no device read; a failed
factor becomes NaN, as JAX's).  Marginal covariances: the f32 probes run
all K x 6 directions as one batched PCG; the exact path factors the
Hessian densely in float64 with torch where JAX calls scipy's sparse LU.
Not ported: the delta closure solve ``solve_closure_cached`` and
``marginal_covariance_cached`` (ROADMAP, "Do not port").

Lanes (:func:`solve_lanes`, JAX's ``vmap(solve)`` in the fleet): B
graphs of one shape are joined into one graph whose pose keys are offset
by ``lane * T``, so every linearization, matvec and preconditioner runs
once for the fleet; the Hessian is block-diagonal across lanes.  What
``vmap`` keeps per lane stays per lane: PCG's dot products, step sizes
and stop; the GN early-out; the error sums; the off-chain selection of
the 'chain' matvec and the Woodbury preconditioner (``offchain_capacity``
factors a lane); every factorization.  The cyclic reduction runs on a
[lanes, T] block axis with its own padding and dense root a lane, the
Woodbury capacitance is one [6L,6L] matrix a lane, the dense method one
[6T,6T] system a lane, and the chain matvec shifts within a lane, so a
lane whose factorization fails (NaN, not positive definite) leaves every
other lane as its own solve would.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from laser_slam_tpu_torch.config import SolverConfig
from laser_slam_tpu_torch.graph.factors import (GAUGE_FIX_THRESHOLD,
                                                FactorGraphData)
from laser_slam_tpu_torch.ops import se3


def _eye6(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(6, dtype=like.dtype, device=like.device)


def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-row vector [n] shaped to broadcast over ``like`` [n, 6, ...]
    (the matvecs and preconditioners take [N,6] states or [N,6,B]
    batches of them)."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


# ---------------------------------------------------------------------------
# Analytic linearization
# ---------------------------------------------------------------------------

def _adjoint(pose7):
    """SE(3) adjoint [...,6,6] for the [omega, v] tangent convention:
    Ad(T) = [[R, 0], [[t]x R, R]]."""
    R = se3.quat_to_matrix(se3.rotation(pose7))
    t = se3.translation(pose7)
    tx = se3._hat(t)
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bot = torch.cat([tx @ R, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _ad_se3(xi):
    """Little adjoint ad(xi) [...,6,6]: [[wx, 0], [vx, wx]]."""
    wx = se3._hat(xi[..., :3])
    vx = se3._hat(xi[..., 3:])
    top = torch.cat([wx, torch.zeros_like(wx)], dim=-1)
    bot = torch.cat([vx, wx], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _jr_inv(r):
    """Inverse right Jacobian of the SE(3) log at r, to second order:
    Jr^{-1}(r) ~ I + ad(r)/2 + ad(r)^2/12 (exact at the optimum)."""
    a = _ad_se3(r)
    return _eye6(r) + 0.5 * a + (1.0 / 12.0) * (a @ a)


def _rel_error(T_a, T_b, meas):
    """E = meas^-1 Ta^-1 Tb, batched."""
    return se3.compose(se3.inverse(meas), se3.compose(se3.inverse(T_a), T_b))


def _rel_linearize_analytic(T_a, T_b, meas):
    """Residual r = log(E) and Jacobians w.r.t. right perturbations:
    Jb = Jr^{-1}(r), Ja = -Jl^{-1}(r) Ad(meas^-1) with Jl^{-1}(r) =
    Jr^{-1}(-r).  Batched over the leading axis."""
    r = se3.log(_rel_error(T_a, T_b, meas))
    Jb = _jr_inv(r)
    Ja = -_jr_inv(-r) @ _adjoint(se3.inverse(meas))
    return r, Ja, Jb


def _prior_linearize_analytic(T, meas):
    r = se3.log(se3.compose(se3.inverse(meas), T))
    return r, _jr_inv(r)


def _cauchy_weight(r_whitened, robust, k):
    """GTSAM Robust(Cauchy(k)) scalar weight per factor on the whitened
    residual norm (laser_track.cpp:38-54)."""
    sq = torch.sum(r_whitened * r_whitened, dim=-1)
    w = 1.0 / (1.0 + sq / (k * k))
    return torch.where(robust, w, torch.ones_like(w))


class _LinearizedGraph(NamedTuple):
    """One GN linearization point, ready for PCG."""
    Ja: torch.Tensor        # [F,6,6]
    Jb: torch.Tensor        # [F,6,6]
    r_rel: torch.Tensor     # [F,6] whitened residual
    w_rel: torch.Tensor     # [F] combined weight (activation * cauchy)
    keys: torch.Tensor      # [F,2] int64
    Jp: torch.Tensor        # [P,6,6]
    r_prior: torch.Tensor   # [P,6]
    w_prior: torch.Tensor   # [P]
    prior_keys: torch.Tensor  # [P] int64
    free: torch.Tensor      # [N] f32: 1 for optimizable poses, 0 frozen/invalid
    lanes: int = 1          # equal lanes joined along N and F (solve_lanes)


def _linearize(graph: FactorGraphData, poses, pose_mask,
               cauchy_k, lanes: int = 1) -> _LinearizedGraph:
    keys = graph.rel_keys.long()
    T_a = poses[keys[:, 0]]
    T_b = poses[keys[:, 1]]
    r, Ja, Jb = _rel_linearize_analytic(T_a, T_b, graph.rel_meas)
    # Whiten: multiply rows by sqrt-info diag.
    s = graph.rel_sqrt_info
    r_w = r * s
    Ja_w = Ja * s[:, :, None]
    Jb_w = Jb * s[:, :, None]
    w = graph.rel_weight * _cauchy_weight(r_w, graph.rel_robust, cauchy_k)
    # fix_first_node factors: key_a constant (laser_track.cpp:440-444).
    Ja_w = torch.where(graph.rel_fixed_a[:, None, None],
                       torch.zeros_like(Ja_w), Ja_w)

    pkeys = graph.prior_keys.long()
    rp, Jp = _prior_linearize_analytic(poses[pkeys], graph.prior_meas)
    sp = torch.clamp(graph.prior_sqrt_info, max=GAUGE_FIX_THRESHOLD)
    rp_w = rp * sp
    Jp_w = Jp * sp[:, :, None]
    wp = graph.prior_weight
    return _LinearizedGraph(Ja_w, Jb_w, r_w, w, keys, Jp_w, rp_w, wp, pkeys,
                            _free(graph, poses, pose_mask), lanes)


def _free(graph: FactorGraphData, poses, pose_mask):
    """[N] f32: 1 for optimizable poses; 0 for masked-out poses and for
    poses that a gauge-fixing prior freezes (they are snapped, not
    weighted); the JAX package's ``_free_mask`` too.  JAX's
    ``.at[keys].max(flag)``: a sum of 0/1 flags is > 0 exactly when the
    max is 1, and index_add_ handles the duplicate padding keys."""
    gauge = torch.any(graph.prior_sqrt_info > GAUGE_FIX_THRESHOLD, dim=-1)
    hits = torch.zeros(poses.shape[0], dtype=poses.dtype,
                       device=poses.device)
    hits.index_add_(0, graph.prior_keys.long(),
                    (gauge & (graph.prior_weight > 0)).to(poses.dtype))
    return (pose_mask & ~(hits > 0)).to(poses.dtype)


# ---------------------------------------------------------------------------
# Hessian matvecs
# ---------------------------------------------------------------------------

def _hessian_matvec(lin: _LinearizedGraph, x, damping):
    """y = (J^T W J + damping*I) x with frozen poses passed through; ``x``
    is [N,6] or a batch [N,6,B]."""
    ka, kb = lin.keys[:, 0], lin.keys[:, 1]
    xa = x[ka] * _rows(lin.free[ka], x)
    xb = x[kb] * _rows(lin.free[kb], x)
    Jx = (torch.einsum('fij,fj...->fi...', lin.Ja, xa) +
          torch.einsum('fij,fj...->fi...', lin.Jb, xb)) * _rows(lin.w_rel, x)
    y = torch.zeros_like(x)
    y.index_add_(0, ka, torch.einsum('fji,fj...->fi...', lin.Ja, Jx))
    y.index_add_(0, kb, torch.einsum('fji,fj...->fi...', lin.Jb, Jx))

    xp = x[lin.prior_keys] * _rows(lin.free[lin.prior_keys], x)
    Jpx = (torch.einsum('pij,pj...->pi...', lin.Jp, xp)
           * _rows(lin.w_prior, x))
    y.index_add_(0, lin.prior_keys,
                 torch.einsum('pji,pj...->pi...', lin.Jp, Jpx))

    y = y * _rows(lin.free, x) + damping * x
    # Frozen/invalid poses: identity row keeps the operator SPD.
    return y + _rows(1.0 - lin.free, x) * x


def _chain_mask(lin: _LinearizedGraph):
    """Factors whose coupling lands on the block-tridiagonal chain."""
    return ((lin.keys[:, 1] == lin.keys[:, 0] + 1) &
            (lin.free[lin.keys[:, 0]] > 0) & (lin.free[lin.keys[:, 1]] > 0))


def _offchain_mask(lin: _LinearizedGraph):
    """Active factors that do NOT land on the block-tridiagonal chain."""
    touches_free = ((lin.free[lin.keys[:, 0]] > 0) |
                    (lin.free[lin.keys[:, 1]] > 0))
    return (lin.w_rel > 0) & ~_chain_mask(lin) & touches_free


def _first_true_indices(flags, L: int, lanes: int = 1):
    """Indices [L] of the first L True entries of ``flags`` (in index
    order) plus a validity mask.  Slots beyond the True count hold the
    out-of-bounds sentinel F (JAX writes them with ``mode='drop'``; here
    they land in an overflow row that is cut off).  With ``lanes`` equal
    lanes of flags, the first L of each lane: [lanes * L] slots."""
    F = flags.shape[0]
    lane_flags = flags.reshape(lanes, -1)
    pos = torch.cumsum(lane_flags, dim=1) - 1     # rank among True entries
    slot = pos + L * torch.arange(lanes, device=flags.device)[:, None]
    dest = torch.where(lane_flags & (pos < L), slot,
                       torch.full_like(pos, lanes * L)).reshape(-1)
    sel = torch.full((lanes * L + 1,), F, dtype=torch.int64,
                     device=flags.device)
    sel[dest] = torch.arange(F, device=flags.device)
    sel = sel[:lanes * L]
    return sel, sel < F


def _lane_capacity(lin: _LinearizedGraph, capacity: int) -> int:
    """Off-chain slots a lane: ``capacity``, at most the lane's factors."""
    return min(capacity, lin.keys.shape[0] // lin.lanes)


def _select_offchain(lin: _LinearizedGraph, capacity: int):
    """Indices of up to ``capacity`` active off-chain factors a lane,
    plus a validity mask (False slots are padding)."""
    return _first_true_indices(_offchain_mask(lin),
                               _lane_capacity(lin, capacity), lin.lanes)


def _without(lin: _LinearizedGraph, sel, valid):
    """[F] weight scale that is 0 at the selected factors and 1 elsewhere.
    Padding slots (sel == F) write an overflow entry that is cut off."""
    F = lin.keys.shape[0]
    w_scale = torch.ones(F + 1, dtype=lin.w_rel.dtype, device=sel.device)
    w_scale[sel] = torch.where(valid, 0.0, 1.0).to(w_scale.dtype)
    return w_scale[:F]


def _offchain_blocks(lin: _LinearizedGraph, sel, valid):
    """Per-selected-factor U blocks: Ua/Ub [L,6(state),6(col)] with weight
    and free-gating folded in, plus their pose keys.  Padding slots gather
    their lane's last factor and get zero blocks."""
    F = lin.keys.shape[0]
    lane = torch.arange(sel.shape[0], device=sel.device) // max(
        sel.shape[0] // lin.lanes, 1)
    sc = torch.where(sel < F, sel, (lane + 1) * (F // lin.lanes) - 1)
    sw = torch.sqrt(lin.w_rel[sc] * valid)[:, None, None]
    ka = lin.keys[sc, 0]
    kb = lin.keys[sc, 1]
    Ua = lin.Ja[sc].transpose(-1, -2) * sw * lin.free[ka][:, None, None]
    Ub = lin.Jb[sc].transpose(-1, -2) * sw * lin.free[kb][:, None, None]
    return Ua, Ub, ka, kb


def _make_matvec(lin: _LinearizedGraph, damping, config, offchain=None):
    """Build ``mv(x) = (H + damping I) x`` once per linearization.

    'scatter': the general :func:`_hessian_matvec`.  'chain' (default):
    H = T + U U^T exactly, T the block-tridiagonal chain part applied as
    batched [N,6,6] contractions and two shifts, U the compact off-chain
    blocks.  Exact when every active off-chain factor fits in
    ``offchain_capacity``; otherwise the scatter form is used.  JAX picks
    with a ``lax.cond`` on the device.  Here ``offchain`` (a host int, an
    upper bound on the active off-chain factors: those with key_b !=
    key_a + 1 or on a gauge-frozen key) picks without a device read: the
    chain form when it fits, the scatter form otherwise.  The two forms
    are the same operator, so a bound above the true count changes only
    the rounding.  Without ``offchain`` the count is read back (one sync
    per linearization), which a direct call may accept.  Over lanes the
    count and the capacity are a lane's: the largest lane decides.
    """
    if getattr(config, 'matvec', 'chain') != 'chain':
        return lambda x: _hessian_matvec(lin, x, damping)

    L = _lane_capacity(lin, config.offchain_capacity)
    off = _offchain_mask(lin)
    if offchain is None:
        offchain = int(torch.amax(torch.sum(off.reshape(lin.lanes, -1),
                                            dim=1)))
    if offchain > L:
        return lambda x: _hessian_matvec(lin, x, damping)
    sel, valid = _first_true_indices(off, L, lin.lanes)
    # T excludes the selected off-chain factors entirely; their diagonal
    # AND coupling ride in U U^T (exact, no boost).
    B, A = _build_tridiag(lin, damping, w_scale=_without(lin, sel, valid),
                          boost=False)
    Ua, Ub, ka, kb = _offchain_blocks(lin, sel, valid)
    zero = torch.zeros((1, 6, 6), dtype=B.dtype, device=B.device)
    # A_up[i] = A[i+1]^T couples pose i to pose i+1.
    A_up = torch.cat([A[1:].transpose(-1, -2), zero])

    def mv_chain(x):
        # Shift within each lane: no row reads its neighbour lane.
        xl = x.reshape((lin.lanes, -1) + x.shape[1:])
        zrow = torch.zeros((lin.lanes, 1) + x.shape[1:], dtype=x.dtype,
                           device=x.device)
        x_prev = torch.cat([zrow, xl[:, :-1]], dim=1).reshape(x.shape)
        x_next = torch.cat([xl[:, 1:], zrow], dim=1).reshape(x.shape)
        y = (torch.einsum('nij,nj...->ni...', B, x)
             + torch.einsum('nij,nj...->ni...', A, x_prev)
             + torch.einsum('nij,nj...->ni...', A_up, x_next))
        t = (torch.einsum('lsc,ls...->lc...', Ua, x[ka]) +
             torch.einsum('lsc,ls...->lc...', Ub, x[kb]))
        y.index_add_(0, ka, torch.einsum('lsc,lc...->ls...', Ua, t))
        y.index_add_(0, kb, torch.einsum('lsc,lc...->ls...', Ub, t))
        return y

    return mv_chain


def _gradient(lin: _LinearizedGraph):
    """g = J^T W r (negated later); zero for frozen poses."""
    wr = lin.r_rel * lin.w_rel[:, None]
    g = torch.zeros((lin.free.shape[0], 6), dtype=wr.dtype,
                    device=wr.device)
    g.index_add_(0, lin.keys[:, 0], torch.einsum('fji,fj->fi', lin.Ja, wr))
    g.index_add_(0, lin.keys[:, 1], torch.einsum('fji,fj->fi', lin.Jb, wr))
    wrp = lin.r_prior * lin.w_prior[:, None]
    g.index_add_(0, lin.prior_keys, torch.einsum('pji,pj->pi', lin.Jp, wrp))
    return g * lin.free[:, None]


# ---------------------------------------------------------------------------
# Preconditioners
# ---------------------------------------------------------------------------

def _cholesky6(A):
    """Batched 6x6 Cholesky, unrolled (lower-triangular L with A = L L^T,
    as nested lists of [...] tensors); pivots clamp at 1e-20."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-20))
            else:
                L[i][j] = s / L[j][j]
    return L


def _chol_inverse6(A):
    """Batched SPD 6x6 inverse via unrolled Cholesky: A^-1 = L^-T L^-1."""
    n = 6
    L = _cholesky6(A)
    Linv = [[None] * n for _ in range(n)]
    for i in range(n):
        Linv[i][i] = 1.0 / L[i][i]
        for j in range(i):
            s = 0.0
            for k in range(j, i):
                s = s + L[i][k] * Linv[k][j]
            Linv[i][j] = -s / L[i][i]
    # A^-1[i,j] = sum_k Linv[k][i] * Linv[k][j]  (k >= max(i,j))
    rows = []
    for i in range(n):
        cols = []
        for j in range(n):
            s = 0.0
            for k in range(max(i, j), n):
                s = s + Linv[k][i] * Linv[k][j]
            cols.append(s)
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


def _block_jacobi(lin: _LinearizedGraph, damping):
    """Inverse 6x6 diagonal blocks of the Hessian as preconditioner."""
    n = lin.free.shape[0]
    w = lin.w_rel[:, None, None]
    H = torch.zeros((n, 6, 6), dtype=lin.Ja.dtype, device=lin.Ja.device)
    H.index_add_(0, lin.keys[:, 0],
                 torch.einsum('fji,fjk->fik', lin.Ja, lin.Ja * w))
    H.index_add_(0, lin.keys[:, 1],
                 torch.einsum('fji,fjk->fik', lin.Jb, lin.Jb * w))
    H.index_add_(0, lin.prior_keys, torch.einsum(
        'pji,pjk->pik', lin.Jp, lin.Jp * lin.w_prior[:, None, None]))
    H = H * lin.free[:, None, None] + _eye6(H) * (
        damping + (1.0 - lin.free)[:, None, None])
    return _chol_inverse6(H)


def _build_tridiag(lin: _LinearizedGraph, damping, w_scale=None,
                   boost=True):
    """Diagonal blocks B [N,6,6] and sub-diagonal blocks A [N,6,6]
    (A[i] couples pose i to pose i-1) of the Hessian's chain part.

    ``w_scale`` [F] rescales each factor's weight in the build only;
    ``boost=False`` skips the stabilizing diagonal boost (required when
    the blocks feed an exact matvec, not a factorization)."""
    n = lin.free.shape[0]
    w = (lin.w_rel if w_scale is None else lin.w_rel * w_scale)[:, None,
                                                                 None]
    B = torch.zeros((n, 6, 6), dtype=lin.Ja.dtype, device=lin.Ja.device)
    B.index_add_(0, lin.keys[:, 0],
                 torch.einsum('fji,fjk->fik', lin.Ja, lin.Ja * w))
    B.index_add_(0, lin.keys[:, 1],
                 torch.einsum('fji,fjk->fik', lin.Jb, lin.Jb * w))
    B.index_add_(0, lin.prior_keys, torch.einsum(
        'pji,pjk->pik', lin.Jp, lin.Jp * lin.w_prior[:, None, None]))
    eye = _eye6(B)
    B = B * lin.free[:, None, None] + eye * (
        damping + (1.0 - lin.free)[:, None, None])

    # Chain coupling H[b,a] = Jb^T W Ja for factors with key_b == key_a+1;
    # other factors go to an overflow row n that is cut off.
    chain = _chain_mask(lin)
    Hba = torch.einsum('fji,fjk->fik', lin.Jb, lin.Ja * w)
    A = torch.zeros((n + 1, 6, 6), dtype=B.dtype, device=B.device)
    A.index_add_(0, torch.where(chain, lin.keys[:, 1],
                                torch.full_like(lin.keys[:, 1], n)),
                 torch.where(chain[:, None, None], Hba,
                             torch.zeros_like(Hba)))
    A = A[:n]
    if boost:
        diag_mag = torch.einsum('nii->n', B) / 6.0
        B = B + (_CR_BOOST * diag_mag)[:, None, None] * eye
    return B, A


# Cyclic reduction stops at this many blocks and finishes with one dense
# root inverse; the relative diagonal boost keeps every pivot SPD in f32
# (values of the JAX package, solver.py:424-451).
_CR_STOP = 512
_CR_BOOST = 1e-3


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _tridiag_factor(B, A, stop=None, lanes: int = 1):
    """Cyclic-reduction factorization of an SPD block-tridiagonal system.

    B: [N,6,6] diagonal blocks; A: [N,6,6] sub-diagonal (A[0] ignored).
    ``lanes`` equal lanes joined along N are factored apart ([lanes, n]
    blocks; JAX's ``vmap``), each padded to a power of two with decoupled
    identity blocks.  Returns ``(levels, root_inv)`` for
    :func:`_tridiag_apply`; ``root_inv`` [lanes, 6m, 6m] is each lane's
    dense inverse of its final <= ``stop``-block system.
    """
    if stop is None:
        stop = _CR_STOP
    B = B.reshape((lanes, -1, 6, 6))
    A = A.reshape((lanes, -1, 6, 6))
    n0 = B.shape[1]
    n = _next_pow2(n0)
    eye = _eye6(B)
    if n != n0:
        pad = n - n0
        B = torch.cat([B, eye.expand(lanes, pad, 6, 6)], dim=1)
        A = torch.cat([A, torch.zeros((lanes, pad, 6, 6), dtype=A.dtype,
                                      device=A.device)], dim=1)
    zero = torch.zeros((lanes, 1, 6, 6), dtype=B.dtype, device=B.device)
    # C[i] couples i to i+1: C_i = A_{i+1}^T.
    C = torch.cat([A[:, 1:].transpose(-1, -2), zero], dim=1)
    A = torch.cat([zero, A[:, 1:]], dim=1)

    levels = []
    while B.shape[1] > stop:
        half = B.shape[1] // 2
        Be, Ae, Ce = B[:, 0::2], A[:, 0::2], C[:, 0::2]
        Bo, Ao, Co = B[:, 1::2], A[:, 1::2], C[:, 1::2]
        Bo_inv = _chol_inverse6(Bo)
        BoL_inv = torch.cat([zero, Bo_inv[:, :half - 1]], dim=1)
        AoL = torch.cat([zero, Ao[:, :half - 1]], dim=1)
        CoL = torch.cat([zero, Co[:, :half - 1]], dim=1)
        G_left = Ae @ BoL_inv
        G_right = Ce @ Bo_inv
        levels.append((Bo_inv, Ao, Co, G_left, G_right))
        B = Be - G_left @ CoL - G_right @ Ao
        A = -G_left @ AoL
        C = -G_right @ Co

    # Dense root: each lane's remaining m-block tridiagonal system as one
    # [6m,6m] SPD matrix, inverted once.
    m = B.shape[1]
    if m == 1:
        root_inv = _chol_inverse6(B)
    else:
        idx = torch.arange(m, device=B.device)
        H4 = torch.zeros((lanes, m, m, 6, 6), dtype=B.dtype, device=B.device)
        H4[:, idx, idx] = B
        H4[:, idx[1:], idx[:-1]] = A[:, 1:]
        H4[:, idx[:-1], idx[1:]] = A[:, 1:].transpose(-1, -2)
        Hd = H4.permute(0, 1, 3, 2, 4).reshape(lanes, 6 * m, 6 * m)
        # cholesky_ex: no error check, so no device read.
        chol = torch.linalg.cholesky_ex(Hd)[0]
        root_inv = torch.cholesky_inverse(chol)
    return (levels, root_inv)


def _tridiag_apply(factors, r):
    """Solve T x = r given a cyclic-reduction factorization; ``r`` is
    [N,6] or [N,6,K] (K right-hand sides together), N joining the
    factorization's lanes."""
    levels, root_inv = factors
    lanes = root_inv.shape[0]
    rest = r.shape[1:]
    r = r.reshape((lanes, -1) + rest)
    n0 = r.shape[1]
    n = _next_pow2(n0)
    if n != n0:
        r = torch.cat([r, torch.zeros((lanes, n - n0) + rest,
                                      dtype=r.dtype, device=r.device)],
                      dim=1)

    ros = []
    for Bo_inv, Ao, Co, G_left, G_right in levels:
        re, ro = r[:, 0::2], r[:, 1::2]
        ros.append(ro)
        roL = torch.cat([torch.zeros((lanes, 1) + rest, dtype=r.dtype,
                                     device=r.device), ro[:, :-1]], dim=1)
        r = (re - torch.einsum('bnij,bnj...->bni...', G_left, roL)
             - torch.einsum('bnij,bnj...->bni...', G_right, ro))

    # Dense root solve: [6m,6m] @ [6m,K...] a lane.
    m6 = root_inv.shape[-1]
    x = root_inv @ r.reshape(lanes, m6, -1)
    x = x.reshape((lanes, m6 // 6) + rest)

    for (Bo_inv, Ao, Co, _, _), ro in zip(reversed(levels), reversed(ros)):
        # x holds the even positions; recover the odds:
        # x_odd[k] = Bo_inv[k] (ro[k] - Ao[k] x_even[k] - Co[k] x_even[k+1])
        x_even_next = torch.cat(
            [x[:, 1:], torch.zeros((lanes, 1) + rest, dtype=x.dtype,
                                   device=x.device)], dim=1)
        rhs = (ro - torch.einsum('bnij,bnj...->bni...', Ao, x)
               - torch.einsum('bnij,bnj...->bni...', Co, x_even_next))
        x_odd = torch.einsum('bnij,bnj...->bni...', Bo_inv, rhs)
        out = torch.empty((lanes, x.shape[1] * 2) + rest, dtype=x.dtype,
                          device=x.device)
        out[:, 0::2] = x
        out[:, 1::2] = x_odd
        x = out
    return x[:, :n0].reshape((lanes * n0,) + rest)


def _tridiag_solve(B, A, r):
    """Solve the SPD block-tridiagonal system T x = r by cyclic reduction
    (factor + apply in one call)."""
    return _tridiag_apply(_tridiag_factor(B, A), r)


# ---------------------------------------------------------------------------
# Woodbury preconditioner: exact chain + exact low-rank off-chain part
# ---------------------------------------------------------------------------
#
# H = T0 + U U^T, T0 the chain + prior + damping part and U the 6-column
# whitened Jacobian blocks of the (few) off-chain factors; the Woodbury
# identity
#   H^-1 = T0^-1 - T0^-1 U (I + U^T T0^-1 U)^-1 U^T T0^-1
# gives a near-exact H^-1 from one cyclic-reduction factorization, one
# batched chain solve for the U columns and one dense Cholesky of the
# [6L,6L] capacitance (iSAM2's incremental Bayes-tree update,
# incremental_estimator.cpp:151-163, as batched algebra).

class WoodburyCache(NamedTuple):
    """The Woodbury preconditioner, kept across solves (the analogue of
    iSAM2 keeping its Bayes tree): the chain factorization of T0 and the
    inverse lower Cholesky factor of the capacitance.  A new loop-closure
    factor is a rank-6 extension of the factor (:func:`extend_cache`),
    not a rebuild.  Fixed shapes; unused slots are identity rows of
    ``chol_inv`` with zero U blocks.

    The JAX cache also keeps the unboosted chain blocks and column norms
    (``T_B``, ``T_A``, ``cn2``); only the delta solve reads them, which
    the port leaves out (ROADMAP, "Do not port")."""
    factors: tuple            # (levels, root_inv) cyclic-reduction of T0
    Ua: torch.Tensor          # [L,6,6] column-scaled off-chain blocks (key_a)
    Ub: torch.Tensor          # [L,6,6] (key_b)
    ka: torch.Tensor          # [L] int64 pose keys
    kb: torch.Tensor          # [L]
    chol_inv: torch.Tensor    # [K,K] INVERSE lower Cholesky of the capacitance
    #                           ([lanes,K,K] for joined lanes, K a lane's)
    n_used: torch.Tensor      # 0-d int64: occupied slots (append cursor)


def _column_scale(cn):
    """Scale and capacitance diagonal of scaled columns with norms ``cn``:
    s = 1/||col|| keeps the capacitance in f32 range (a closure's lever
    arm makes its whitened columns ~1e4); zero columns keep s = 0 and a
    unit diagonal."""
    big = cn > 1e-20
    s = torch.where(big, 1.0 / torch.clamp(cn, min=1e-20),
                    torch.zeros_like(cn))
    return s, torch.where(big, s * s, torch.ones_like(cn))


def _factor_or_nan(C):
    """Lower Cholesky factor of C; NaN where C is not positive definite
    (JAX's ``cholesky`` returns NaN there), read by no one on the host."""
    L, info = torch.linalg.cholesky_ex(C)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float('nan')))


def _build_woodbury_cache(lin: _LinearizedGraph, damping,
                          config) -> WoodburyCache:
    sel, valid = _select_offchain(lin, config.offchain_capacity)
    # T0 excludes the SELECTED off-chain factors (their diagonal rides in
    # U U^T); unselected overflow keeps its diagonal in T0, degrading
    # gracefully to 'tridiagonal'.
    lanes = lin.lanes
    factors = _tridiag_factor(*_build_tridiag(
        lin, damping, w_scale=_without(lin, sel, valid)), lanes=lanes)
    Ua, Ub, ka, kb = _offchain_blocks(lin, sel, valid)
    L = Ua.shape[0] // lanes          # slots a lane; lane b's are b*L + l
    n = lin.free.shape[0]
    K = 6 * L
    # With Utilde = U diag(s):  H^-1 = T0^-1 - T0^-1 Utilde Ctilde^-1
    # Utilde^T T0^-1,  Ctilde = diag(s^2) + Utilde^T T0^-1 Utilde.
    cn = torch.sqrt(torch.sum(Ua * Ua, dim=1) + torch.sum(Ub * Ub, dim=1))
    s, diag_c = _column_scale(cn)                         # [L,6]
    Ua = Ua * s[:, None, :]
    Ub = Ub * s[:, None, :]
    # U[k, :, l, :] += Ua[l] at k = ka[l] (and Ub at kb[l]), l the slot
    # within its lane (a key's row holds its own lane's columns only);
    # accumulate, since padding slots repeat a key (with zero blocks).
    lidx = torch.arange(lanes * L, device=Ua.device) % L
    U = torch.zeros((n, L, 6, 6), dtype=Ua.dtype, device=Ua.device)
    U.index_put_((ka, lidx), Ua, accumulate=True)
    U.index_put_((kb, lidx), Ub, accumulate=True)
    V = _tridiag_apply(factors, U.permute(0, 2, 1, 3).reshape(n, 6, K))
    Vl = V.reshape(n, 6, L, 6)                            # T0^-1 Utilde
    C = (torch.einsum('lsc,lsmd->lcmd', Ua, Vl[ka]) +
         torch.einsum('lsc,lsmd->lcmd', Ub, Vl[kb])).reshape(lanes, K, K)
    C = C + torch.diag_embed(diag_c.reshape(lanes, K))
    # Multiplicative diagonal jitter: rows span many orders of magnitude,
    # so a relative nudge toward SPD keeps the small rows.
    C = C + torch.diag_embed(1e-5 * torch.abs(torch.diagonal(
        C, dim1=-2, dim2=-1)))
    eye = torch.eye(K, dtype=C.dtype, device=C.device)
    # One capacitance a lane; one lane's is [K,K].
    chol_inv = torch.linalg.solve_triangular(_factor_or_nan(C), eye,
                                             upper=False)
    if lanes == 1:
        chol_inv = chol_inv[0]
    return WoodburyCache(factors=factors, Ua=Ua, Ub=Ub, ka=ka, kb=kb,
                         chol_inv=chol_inv, n_used=torch.sum(valid))


def _apply_from_cache(cache: WoodburyCache):
    """apply_M(r) ~= H^-1 r from a (possibly extended) WoodburyCache;
    a cache of joined lanes has one capacitance a lane."""
    L = cache.Ua.shape[0]
    Ua, Ub, ka, kb = cache.Ua, cache.Ub, cache.ka, cache.kb
    lanes = cache.factors[1].shape[0]

    def apply_M(r):
        batch = r.shape[2:]
        t1 = _tridiag_apply(cache.factors, r)
        c = (torch.einsum('lsc,ls...->lc...', Ua, t1[ka]) +
             torch.einsum('lsc,ls...->lc...', Ub, t1[kb])
             ).reshape(lanes, 6 * L // lanes, math.prod(batch))
        # C^-1 c = L^-T (L^-1 c): two products with the prebuilt inverse.
        y = (cache.chol_inv.mT @ (cache.chol_inv @ c)).reshape(
            (L, 6) + batch)
        z = torch.zeros_like(r)
        z.index_add_(0, ka, torch.einsum('lsc,lc...->ls...', Ua, y))
        z.index_add_(0, kb, torch.einsum('lsc,lc...->ls...', Ub, y))
        out = t1 - _tridiag_apply(cache.factors, z)
        # A failed capacitance factorization degrades to the chain
        # preconditioner, never poisons the trajectory.
        return torch.where(torch.isfinite(out), out, t1)

    return apply_M


def _make_preconditioner(lin: _LinearizedGraph, damping, config):
    """Build ``apply_M(r) ~= H^-1 r`` once per solve."""
    kind = config.preconditioner
    if kind == 'jacobi':
        Minv = _block_jacobi(lin, damping)
        return lambda r: torch.einsum('nij,nj...->ni...', Minv, r)
    if kind == 'tridiagonal':
        factors = _tridiag_factor(*_build_tridiag(lin, damping),
                                  lanes=lin.lanes)
        return lambda r: _tridiag_apply(factors, r)
    if kind == 'woodbury':
        return _apply_from_cache(_build_woodbury_cache(lin, damping, config))
    raise ValueError(f'unknown preconditioner {kind!r}')


# ---------------------------------------------------------------------------
# Dense direct method (small pose tables / window subproblems)
# ---------------------------------------------------------------------------

def _dense_factor(lin: _LinearizedGraph, damping):
    """Dense [6N,6N] normal equations, Cholesky-factored (lower).  Same
    semantics as :func:`_hessian_matvec`: free gating, identity rows for
    frozen poses, damping.  ``cholesky_ex`` reports failure in ``info``
    without a device read; a matrix that is not positive definite then
    gives an all-NaN factor, which the caller zeroes, as with the JAX
    package's ``cho_factor``.  Joined lanes get one [6n,6n] system a lane
    ([lanes, 6n, 6n]), so a lane that fails leaves the others alone."""
    lanes = lin.lanes
    n = lin.free.shape[0] // lanes
    w = lin.w_rel[:, None, None]
    k0, k1 = lin.keys[:, 0], lin.keys[:, 1]
    Ha = torch.einsum('fji,fjk->fik', lin.Ja, lin.Ja * w)
    Hb = torch.einsum('fji,fjk->fik', lin.Jb, lin.Jb * w)
    Hab = torch.einsum('fji,fjk->fik', lin.Ja, lin.Jb * w)
    Hp = torch.einsum('pji,pjk->pik', lin.Jp,
                      lin.Jp * lin.w_prior[:, None, None])
    H4 = torch.zeros((lanes, n, n, 6, 6), dtype=Ha.dtype, device=Ha.device)
    pk = lin.prior_keys
    for (ia, ib), blocks in (((k0, k0), Ha), ((k1, k1), Hb),
                             ((k0, k1), Hab),
                             ((k1, k0), Hab.transpose(-1, -2)),
                             ((pk, pk), Hp)):
        H4.index_put_((ia // n, ia % n, ib % n), blocks, accumulate=True)
    f = lin.free.reshape(lanes, n)
    H4 = H4 * f[:, :, None, None, None] * f[:, None, :, None, None]
    H = H4.permute(0, 1, 3, 2, 4).reshape(lanes, 6 * n, 6 * n)
    H = H + torch.diag_embed(torch.repeat_interleave(damping + (1.0 - f),
                                                     6, dim=-1))
    chol = _factor_or_nan(H)
    return chol[0] if lanes == 1 else chol


def _dense_apply(chol, b):
    lanes = chol.shape[0] if chol.dim() == 3 else 1
    n6 = b.shape[0] * b.shape[1] // lanes
    rhs = b.reshape(n6, 1) if lanes == 1 else b.reshape(lanes, n6, 1)
    return torch.cholesky_solve(rhs, chol).reshape(b.shape)


# ---------------------------------------------------------------------------
# PCG and the Gauss-Newton loop
# ---------------------------------------------------------------------------

def _dot(u, v, lanes: int = 1):
    """<u, v> of [N,6] states; one per problem for a batch [N,6,B]; one
    per lane ([lanes]) for states of ``lanes`` joined lanes."""
    if lanes > 1:
        return torch.sum((u * v).reshape(lanes, -1), dim=1)
    if u.dim() == 2:
        return torch.sum(u * v)
    return torch.sum(u * v, dim=(0, 1))


def _lane_rows(s, lanes: int, like):
    """Per-lane values [lanes] repeated over each lane's rows of ``like``
    [N, ...] (unchanged for one lane)."""
    if lanes == 1:
        return s
    n = like.shape[0]
    return s[:, None].expand(lanes, n // lanes).reshape(
        (n,) + (1,) * (like.dim() - 1))


def _pcg(lin: _LinearizedGraph, b, damping, iterations, tol, apply_M,
         matvec=None, x0=None):
    """Preconditioned CG for H x = b over [N,6] states, or B independent
    problems at once over [N,6,B] (JAX's ``vmap`` of the solve: each
    problem keeps its own step sizes and its own stop).

    Runs ``iterations`` steps; once the residual is within ``tol`` of
    ``|b|`` the state is frozen, which is where JAX's while loop stops.
    Over joined lanes (``lin.lanes``) each lane has its own step sizes and
    stop, as under JAX's ``vmap``.  Returns (x, iterations that changed
    the state; one a lane)."""
    if matvec is None:
        matvec = lambda v: _hessian_matvec(lin, v, damping)  # noqa: E731
    lanes = lin.lanes

    def dot(u, v):
        return _dot(u, v, lanes)

    def rows(s):
        return _lane_rows(s, lanes, b)

    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    z = apply_M(r)
    p = z
    rz = dot(r, z)
    b_norm = torch.sqrt(dot(b, b)) + 1e-30
    it = torch.zeros(rz.shape, dtype=torch.int32, device=b.device)
    for _ in range(iterations):
        running = torch.sqrt(dot(r, r)) > tol * b_norm
        Hp = matvec(p)
        alpha = rz / torch.clamp(dot(p, Hp), min=1e-30)
        x_n = x + rows(alpha) * p
        r_n = r - rows(alpha) * Hp
        z = apply_M(r_n)
        rz_n = dot(r_n, z)
        beta = rz_n / torch.clamp(rz, min=1e-30)
        p_n = z + rows(beta) * p
        x = torch.where(rows(running), x_n, x)
        r = torch.where(rows(running), r_n, r)
        p = torch.where(rows(running), p_n, p)
        rz = torch.where(running, rz_n, rz)
        it = it + running.to(torch.int32)
    return x, it


class SolveResult(NamedTuple):
    poses: torch.Tensor        # [N,7] optimized
    error_initial: torch.Tensor
    error_final: torch.Tensor
    pcg_iterations: torch.Tensor


def graph_error(graph: FactorGraphData, poses, lanes: int = 1
                ) -> torch.Tensor:
    """Total weighted squared error (0.5 * sum r^T W r), for diagnostics;
    one a lane ([lanes]) for a graph of joined lanes."""
    keys = graph.rel_keys.long()
    r = se3.log(_rel_error(poses[keys[:, 0]], poses[keys[:, 1]],
                           graph.rel_meas))
    r_w = r * graph.rel_sqrt_info
    sq = torch.sum(r_w * r_w, dim=-1)
    # Cauchy loss for robust factors.
    def total(x):
        if lanes > 1:
            return torch.sum(x.reshape(lanes, -1), dim=1)
        return torch.sum(x)

    e_rel = total(graph.rel_weight * torch.where(
        graph.rel_robust, torch.log1p(sq), sq))
    rp = se3.log(se3.compose(se3.inverse(graph.prior_meas),
                             poses[graph.prior_keys.long()]))
    rp_w = rp * torch.clamp(graph.prior_sqrt_info, max=GAUGE_FIX_THRESHOLD)
    e_pri = total(graph.prior_weight * torch.sum(rp_w * rp_w, dim=-1))
    return 0.5 * (e_rel + e_pri)


def _snap_gauge(graph: FactorGraphData, poses):
    """Gauge-fixing priors pin their pose AT the prior measurement.
    Non-gauge slots write the overflow row N, which is cut off (JAX
    drops them: padding slots share key 0 and must not clobber a snap)."""
    N = poses.shape[0]
    gauge = (torch.any(graph.prior_sqrt_info > GAUGE_FIX_THRESHOLD, dim=-1)
             & (graph.prior_weight > 0))
    snap_idx = torch.where(gauge, graph.prior_keys.long(),
                           torch.full_like(graph.prior_keys, N).long())
    poses_ext = torch.cat([poses, torch.zeros((1, 7), dtype=poses.dtype,
                                              device=poses.device)])
    poses_ext[snap_idx] = graph.prior_meas
    return poses_ext[:N]


def _pcg_step(graph: FactorGraphData, pose_mask, config, damping, apply_M,
              offchain=None, lanes: int = 1):
    """One GN step's linear solve by PCG with the fresh linearization's
    matvec and a preconditioner ``apply_M`` built before the loop.
    Returns ``step(poses) -> (lin, delta, pcg iterations)``."""
    def step(poses):
        lin = _linearize(graph, poses, pose_mask, config.cauchy_k, lanes)
        b = -_gradient(lin)
        mv = _make_matvec(lin, damping, config, offchain)
        x0 = apply_M(b) if config.pcg_init == 'precond' else None
        delta, pcg_it = _pcg(lin, b, damping, config.pcg_iterations,
                             config.pcg_tolerance, apply_M, matvec=mv,
                             x0=x0)
        return lin, delta, pcg_it
    return step


def solve(graph: FactorGraphData, poses, pose_mask,
          config: SolverConfig, offchain=None, lanes: int = 1
          ) -> SolveResult:
    """Run ``config.gn_iterations`` Gauss-Newton steps from ``poses``
    (warm-started; the incremental deployment calls this once per scan,
    mirroring IncrementalEstimator::estimate).  ``offchain``: the
    caller's bound on the off-chain factors, which picks the matvec
    without a device read (:func:`_make_matvec`); without it each
    linearization reads one count back.  ``lanes`` > 1: the graph joins
    that many equal lanes (:func:`solve_lanes`), and the errors and PCG
    counts come back one a lane."""
    if config.method not in ('pcg', 'dense'):
        raise ValueError(f'unknown solver method {config.method!r}')
    damping = float(config.damping)
    poses = _snap_gauge(graph, poses)
    e0 = _error(graph, poses, config, lanes)
    if config.method == 'dense':
        # The [6N,6N] normal equations are factored again at every GN
        # step (the exact Newton direction); joined lanes make one
        # block-diagonal system.
        def step(poses):
            lin = _linearize(graph, poses, pose_mask, config.cauchy_k, lanes)
            delta = _dense_apply(_dense_factor(lin, damping),
                                 -_gradient(lin))
            return lin, delta, torch.ones(() if lanes == 1 else (lanes,),
                                          dtype=torch.int32,
                                          device=poses.device)
    else:
        # The preconditioner is built once from the initial linearization
        # and reused across all GN steps (staleness only costs PCG
        # iterations).
        lin0 = _linearize(graph, poses, pose_mask, config.cauchy_k, lanes)
        step = _pcg_step(graph, pose_mask, config, damping,
                         _make_preconditioner(lin0, damping, config),
                         offchain, lanes)
    return _gauss_newton(graph, poses, pose_mask, config, step, e0, lanes)


def solve_lanes(graphs: FactorGraphData, poses, pose_masks,
                config: SolverConfig, offchain=None) -> SolveResult:
    """:func:`solve` of B independent graphs at once, JAX's
    ``vmap(solve)``: every field of ``graphs`` and ``poses`` [B,T,7],
    ``pose_masks`` [B,T] carries a leading lane axis, and so does every
    field of the result.  The lanes are joined into one graph
    (``factors.join_lanes``) and solved with per-lane PCG scalars, stops,
    gauge snaps and GN early-outs.  ``offchain``: a bound on any one
    lane's off-chain factors (without it, one count is read per
    linearization)."""
    from laser_slam_tpu_torch.graph.factors import join_lanes
    B, T = poses.shape[:2]
    res = solve(join_lanes(graphs, T), poses.reshape(B * T, 7),
                pose_masks.reshape(B * T), config, offchain, lanes=B)
    err = (lambda e: e) if config.compute_errors else (
        lambda e: e.expand(B))
    return SolveResult(poses=res.poses.reshape(B, T, 7),
                       error_initial=err(res.error_initial),
                       error_final=err(res.error_final),
                       pcg_iterations=res.pcg_iterations)


def _error(graph: FactorGraphData, poses, config,
           lanes: int = 1) -> torch.Tensor:
    """graph_error, or -1 when ``config.compute_errors`` is off."""
    if config.compute_errors:
        return graph_error(graph, poses, lanes)
    return torch.full((), -1.0, dtype=poses.dtype, device=poses.device)


def _gauss_newton(graph: FactorGraphData, poses, pose_mask, config, step,
                  e0, lanes: int = 1) -> SolveResult:
    """``config.gn_iterations`` GN steps of ``step(poses) -> (lin, delta,
    iterations)`` from the snapped ``poses``, each retracted on the free
    poses, with the ``gn_tolerance`` early-out (lane by lane over joined
    lanes)."""
    # gn_tolerance compares against the RMS step per ACTIVE pose.
    n_active = torch.clamp(torch.sum(pose_mask.to(poses.dtype).reshape(
        lanes, -1), dim=1), min=1.0)
    if lanes == 1:
        n_active = n_active[0]

    def one_step(poses):
        lin, delta, it = step(poses)
        delta = torch.nan_to_num(delta) * lin.free[:, None]
        new_poses = se3.normalize(se3.compose(poses, se3.exp(delta)))
        new_poses = torch.where(pose_mask[:, None], new_poses, poses)
        if lanes == 1:
            rms = torch.linalg.norm(delta) / torch.sqrt(n_active)
        else:
            rms = (torch.linalg.norm(delta.reshape(lanes, -1), dim=1)
                   / torch.sqrt(n_active))
        return new_poses, it, rms

    gn_tol = config.gn_tolerance
    shape = () if lanes == 1 else (lanes,)
    total = torch.zeros(shape, dtype=torch.int32, device=poses.device)
    last_delta = torch.full(shape, float('inf'), dtype=poses.dtype,
                            device=poses.device)
    for _ in range(config.gn_iterations):
        new_poses, it, dnorm = one_step(poses)
        if gn_tol > 0:
            # GN early-out: once a step's RMS falls below gn_tolerance the
            # remaining steps leave the poses as they are.
            run = last_delta >= gn_tol
            poses = torch.where(_lane_rows(run, lanes, poses), new_poses,
                                poses)
            total = total + torch.where(run, it, torch.zeros_like(it))
            last_delta = torch.where(run, dnorm, last_delta)
        else:
            poses, total, last_delta = new_poses, total + it, dnorm
    return SolveResult(poses=poses, error_initial=e0,
                       error_final=_error(graph, poses, config, lanes),
                       pcg_iterations=total)


# ---------------------------------------------------------------------------
# Cached, incremental solving (the iSAM2-reuse seam)
# ---------------------------------------------------------------------------

def _chol6_matrix(A):
    """Unrolled 6x6 Cholesky returning a dense lower-triangular matrix."""
    L = _cholesky6(A)
    zero = torch.zeros_like(A[..., 0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero
                                     for j in range(6)], dim=-1)
                        for i in range(6)], dim=-2)


def _lower6_inverse(Lm):
    """Inverse of a dense lower-triangular [6,6] matrix, unrolled
    forward substitution (elementwise)."""
    inv = [[None] * 6 for _ in range(6)]
    for i in range(6):
        inv[i][i] = 1.0 / Lm[..., i, i]
        for j in range(i):
            s = 0.0
            for k in range(j, i):
                s = s + Lm[..., i, k] * inv[k][j]
            inv[i][j] = -s / Lm[..., i, i]
    zero = torch.zeros_like(Lm[..., 0, 0])
    return torch.stack([torch.stack([inv[i][j] if j <= i else zero
                                     for j in range(6)], dim=-1)
                        for i in range(6)], dim=-2)


def build_cache(graph: FactorGraphData, poses, pose_mask,
                config: SolverConfig) -> WoodburyCache:
    """Factor the Woodbury preconditioner once, for reuse across solves.

    Valid while the graph's CHAIN part (consecutive-key factors and
    priors) is unchanged; new off-chain factors are absorbed with
    :func:`extend_cache`.  Staleness only costs PCG iterations: PCG's
    matvec uses the fresh linearization."""
    lin = _linearize(graph, poses, pose_mask, config.cauchy_k)
    return _build_woodbury_cache(lin, float(config.damping), config)


def _linearize_one_rel(graph: FactorGraphData, poses, pose_mask,
                       factor_idx, config: SolverConfig):
    """Whitened, weighted, free-gated linearization of ONE relative factor
    at ``factor_idx`` (a 0-d device tensor).  Returns (r_w, Ja_w, Jb_w,
    w, ka, kb, free)."""
    f = torch.as_tensor(factor_idx, device=poses.device).long()
    ka_n, kb_n = graph.rel_keys[f].long().unbind(0)
    r, Ja, Jb = _rel_linearize_analytic(poses[ka_n][None], poses[kb_n][None],
                                        graph.rel_meas[f][None])
    s_info = graph.rel_sqrt_info[f]
    r_w = r[0] * s_info
    Ja_w = Ja[0] * s_info[:, None]
    Jb_w = Jb[0] * s_info[:, None]
    w = graph.rel_weight[f] * _cauchy_weight(r_w, graph.rel_robust[f],
                                             config.cauchy_k)
    Ja_w = torch.where(graph.rel_fixed_a[f], torch.zeros_like(Ja_w), Ja_w)
    return r_w, Ja_w, Jb_w, w, ka_n, kb_n, _free(graph, poses, pose_mask)


def extend_cache(graph: FactorGraphData, poses, pose_mask,
                 cache: WoodburyCache, factor_idx,
                 config: SolverConfig) -> WoodburyCache:
    """Absorb ONE new off-chain (loop-closure) factor into the cache.

    With the capacitance C = L L^T factored and a new scaled column block
    u, the extended factor is [[L, 0], [X^T, Ls]] with B = U_old^T T0^-1
    u, X = L^-1 B, Ls = chol(D - X^T X); the cache stores L^-1, so the
    appended inverse row block is [-Ls^-1 X^T L^-1, Ls^-1]: one chain
    solve with 6 right-hand sides and two [K,.] products.  Slots fill in
    order at the device cursor ``n_used`` (no host read); when the
    capacity is full the slot's own values are written back and the
    cache is unchanged (the factor is then not preconditioned; PCG still
    converges, slower).

    The cache's tensors are written in place; the returned cache carries
    the advanced cursor.  Clone a cache that must stay as it was."""
    n = poses.shape[0]
    L_cap = cache.Ua.shape[0]
    dev = poses.device
    r_w, Ja_w, Jb_w, w, ka_n, kb_n, free = _linearize_one_rel(
        graph, poses, pose_mask, factor_idx, config)
    sw = torch.sqrt(w)
    Ua_n = Ja_w.T * sw * free[ka_n]              # [6(state),6(col)]
    Ub_n = Jb_w.T * sw * free[kb_n]
    # Column scaling, as _build_woodbury_cache.
    cn = torch.sqrt(torch.sum(Ua_n * Ua_n, dim=0) +
                    torch.sum(Ub_n * Ub_n, dim=0))
    s, diag_c = _column_scale(cn)
    Ua_n = Ua_n * s[None, :]
    Ub_n = Ub_n * s[None, :]

    # v = T0^-1 u (one chain solve, 6 right-hand sides).
    u = torch.zeros((n, 6, 6), dtype=poses.dtype, device=dev)
    u.index_add_(0, ka_n[None], Ua_n[None])
    u.index_add_(0, kb_n[None], Ub_n[None])
    v = _tridiag_apply(cache.factors, u)                          # [n,6,6]

    # Coupling to the existing columns and the new diagonal block.
    B = (torch.einsum('lsc,lsd->lcd', cache.Ua, v[cache.ka]) +
         torch.einsum('lsc,lsd->lcd', cache.Ub, v[cache.kb])
         ).reshape(6 * L_cap, 6)
    D = (torch.einsum('sc,sd->cd', Ua_n, v[ka_n]) +
         torch.einsum('sc,sd->cd', Ub_n, v[kb_n]) + torch.diag(diag_c))
    D = D + torch.diag(1e-5 * torch.abs(torch.diagonal(D)))

    # Block-Cholesky-inverse extension.  Rows of B at padding slots are
    # zero (their U blocks are zero), so the row written below stays
    # consistent with the identity padding.
    X = cache.chol_inv @ B                                        # [K,6]
    Ls_inv = _lower6_inverse(_chol6_matrix(D - X.T @ X))
    full = cache.n_used >= L_cap
    slot = torch.clamp(cache.n_used, max=L_cap - 1).reshape(1)
    rows6 = 6 * slot + torch.arange(6, device=dev)
    row = -Ls_inv @ (X.T @ cache.chol_inv)                        # [6,K]
    row.index_copy_(1, rows6, Ls_inv)
    # Full: write the slot's own values back.
    row = torch.where(full, cache.chol_inv[rows6], row)
    for buf, new in ((cache.Ua, Ua_n), (cache.Ub, Ub_n),
                     (cache.ka, ka_n), (cache.kb, kb_n)):
        buf.index_copy_(0, slot, torch.where(full, buf[slot], new[None]))
    cache.chol_inv.index_copy_(0, rows6, row)
    return cache._replace(n_used=torch.where(full, cache.n_used,
                                             cache.n_used + 1))


def solve_cached(graph: FactorGraphData, poses, pose_mask,
                 cache: WoodburyCache, config: SolverConfig,
                 offchain=None) -> SolveResult:
    """Gauss-Newton with a PREBUILT preconditioner, the incremental fast
    path: the same fixed point as :func:`solve` (the matvec and gradient
    use the fresh linearization; only the preconditioner is cached),
    without the chain factorization and capacitance build of a cold
    solve.  ``offchain`` as in :func:`solve`."""
    damping = float(config.damping)
    poses = _snap_gauge(graph, poses)
    e0 = _error(graph, poses, config)
    step = _pcg_step(graph, pose_mask, config, damping,
                     _apply_from_cache(cache), offchain)
    return _gauss_newton(graph, poses, pose_mask, config, step, e0)


def clone_cache(cache: WoodburyCache) -> WoodburyCache:
    """A copy of the cache that no later extension touches (extensions
    write every field but the chain factorization, which is shared)."""
    return cache._replace(**{k: getattr(cache, k).clone()
                             for k in WoodburyCache._fields
                             if k != 'factors'})


# ---------------------------------------------------------------------------
# Marginal covariances (gtsam::Marginals, laser_track.cpp:421-429)
# ---------------------------------------------------------------------------

def marginal_covariance(graph: FactorGraphData, poses, pose_mask, keys,
                        config: SolverConfig, offchain=None) -> torch.Tensor:
    """Approximate per-key 6x6 marginal covariances: H X = E_k solved by
    PCG for the 6 canonical directions of each requested key (the probe
    method).  ``keys`` [K] int -> [K,6,6] on the graph's device.

    The configured preconditioner and the fresh linearization's matvec
    (``offchain`` as in :func:`solve`); all K x 6 directions run as ONE
    batched PCG, so every iteration is a single batched matvec and
    preconditioner apply, not 6K solves.  The f32 probes are accurate
    for well-observed modes (near the gauge anchor, tied down by
    closures) and saturate on weakly observed ones (JAX package's
    accuracy envelope); :func:`marginal_covariance_exact` is the
    float64 path for those."""
    lin = _linearize(graph, poses, pose_mask, config.cauchy_k)
    damping = float(config.damping)
    apply_M = _make_preconditioner(lin, damping, config)
    # The chain-exact preconditioners converge in a few iterations; only
    # the local block-Jacobi needs the generous budget.
    iters = config.pcg_iterations * (
        4 if config.preconditioner == 'jacobi' else 1)
    return _marginal_probes(lin, damping, apply_M, iters, config, keys,
                            poses, offchain)


def _marginal_probes(lin: _LinearizedGraph, damping, apply_M, iters,
                     config: SolverConfig, keys, poses, offchain=None):
    """The probe core: unit right-hand sides E [N,6,6K] (column 6k+d is
    direction d of key k), one batched PCG, and cov[k, d, :] = X[key_k,
    :, 6k+d].  Gauge-frozen keys report 0 (their PCG identity row would
    report I)."""
    n = poses.shape[0]
    keys = torch.as_tensor(keys, device=poses.device).long().reshape(-1)
    K = keys.shape[0]
    dev = poses.device
    mv = _make_matvec(lin, damping, config, offchain)
    cols = torch.arange(6 * K, device=dev)
    E = torch.zeros((n, 6, 6 * K), dtype=poses.dtype, device=dev)
    E.index_put_((keys.repeat_interleave(6), cols % 6, cols),
                 torch.ones(6 * K, dtype=poses.dtype, device=dev))
    x0 = apply_M(E) if config.pcg_init == 'precond' else None
    X, _ = _pcg(lin, E, damping, iters, config.pcg_tolerance, apply_M,
                matvec=mv, x0=x0)
    Xk = X[keys].reshape(K, 6, K, 6)            # [k, state, k', direction]
    idx = torch.arange(K, device=dev)
    cov = Xk[idx, :, idx, :].transpose(-1, -2)  # [k, direction, state]
    return cov * lin.free[keys][:, None, None]


def marginal_covariance_exact(graph: FactorGraphData, poses, pose_mask,
                              keys, config: SolverConfig,
                              n_used=None):
    """Exact per-key 6x6 marginal covariances in float64, the tool class
    of the reference's ``gtsam::Marginals`` (laser_track.cpp:421-429).
    Returns a host ``np.ndarray`` [K,6,6] float64.

    The f32 linearization is taken to float64 and the damped, free-gated
    Hessian of the first ``n_used`` poses (all rows by default) is
    assembled densely and Cholesky-factored on the graph's device; the
    6K unit columns are solved against it.  The rows past ``n_used`` are
    identity rows that no active factor touches, so leaving them out
    changes nothing.  The JAX package factors the same matrix with
    scipy's sparse LU on the host.  With interleaved multi-robot keys the
    Hessian is far from block-tridiagonal, so a chain factor with a
    low-rank update would not stay low-rank; the dense factor serves the
    online runner's pose tables: [6n,6n] float64 is 1.2 GB and about
    6e11 flops at n = 2048, and grows as n^2 and n^3 beyond."""
    import numpy as np
    lin = _linearize(graph, poses, pose_mask, config.cauchy_k)
    n = poses.shape[0] if n_used is None else int(n_used)
    f64 = torch.float64
    free = lin.free.to(f64)
    ka, kb = lin.keys[:, 0], lin.keys[:, 1]
    w = lin.w_rel.to(f64)[:, None, None]
    # Free-gated whitened Jacobians, exactly as _hessian_matvec gates.
    Jaf = lin.Ja.to(f64) * free[ka][:, None, None]
    Jbf = lin.Jb.to(f64) * free[kb][:, None, None]
    Haa = torch.einsum('fji,fjk->fik', Jaf, Jaf * w)
    Hbb = torch.einsum('fji,fjk->fik', Jbf, Jbf * w)
    Hab = torch.einsum('fji,fjk->fik', Jaf, Jbf * w)
    pk = lin.prior_keys
    Jpf = lin.Jp.to(f64) * free[pk][:, None, None]
    Hpp = torch.einsum('pji,pjk->pik', Jpf,
                       Jpf * lin.w_prior.to(f64)[:, None, None])
    H4 = torch.zeros((n, n, 6, 6), dtype=f64, device=poses.device)
    for (ia, ib), blocks in (((ka, ka), Haa), ((kb, kb), Hbb),
                             ((ka, kb), Hab),
                             ((kb, ka), Hab.transpose(-1, -2)),
                             ((pk, pk), Hpp)):
        # Padding factors and priors sit on key 0 with zero weight; keys
        # past n_used belong to no active factor.
        inside = (ia < n) & (ib < n)
        H4.index_put_((torch.where(inside, ia, 0), torch.where(inside, ib, 0)),
                      blocks * inside[:, None, None], accumulate=True)
    H = H4.permute(0, 2, 1, 3).reshape(6 * n, 6 * n)
    # Damping on free states, identity rows for frozen or invalid ones.
    dvals = torch.where(free[:n] > 0, float(config.damping), 1.0)
    H = H + torch.diag(torch.repeat_interleave(dvals, 6))
    chol = torch.linalg.cholesky(H)
    kq = torch.as_tensor(np.asarray(keys), device=poses.device).long()
    K = kq.shape[0]
    cols = torch.arange(6 * K, device=poses.device)
    E = torch.zeros((6 * n, 6 * K), dtype=f64, device=poses.device)
    E[6 * kq.repeat_interleave(6) + cols % 6, cols] = 1.0
    X = torch.cholesky_solve(E, chol).reshape(n, 6, K, 6)
    idx = torch.arange(K, device=poses.device)
    out = X[kq, :, idx, :].transpose(-1, -2) * free[kq][:, None, None]
    return out.cpu().numpy()
