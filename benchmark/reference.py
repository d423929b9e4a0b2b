"""The plain reference: point-to-plane ICP, kNN normals and poses in plain
torch, written from the algorithm and not from the program.

It imports nothing of the program under test and takes nothing the
program made: it gets the inputs the benchmark generated and works out
again what the program derives from them (the map's normals).  It
follows libpointmatcher's pipeline of upstream laser_slam's
``icp_default.yaml`` as the configuration's ``icp`` settings state it:

* exact 1-NN of every reading point against the reference, kept when
  within ``max_correspondence_dist_m``;
* the trimmed-distance filter: the valid matches whose squared distance
  is at most the ``trimmed_dist_ratio`` quantile (the k-th smallest, k =
  max(floor(n * ratio), 1));
* one point-to-plane Gauss-Newton step on them: residual n.(p - q),
  Jacobian [p x n, n], the 6x6 normal equations damped by 1e-6 (1 +
  trace / 6), and the increment applied on the left, exp(delta) T, with
  the left Jacobian of SO(3) for its translation;
* the counter checker (``max_iterations``) and the differential checker
  (the mean of the last ``smooth_length`` increments' rotation and
  translation norms under ``min_diff_rot`` / ``min_diff_trans``), after
  which a registration stops and keeps its pose;
* fewer than 24 trimmed inliers: the registration fails and returns its
  initial guess.

Precision.  The reference runs in float64 with exact products.  The
control (``tf32=True`` in float32) rounds the operands of every matrix
product (the point transform, the distance expansion, the normal
equations) to TF32, 10 mantissa bits, as the card's TF32 tensor cores
do, and keeps the rest in float32: the precision one step below the
configuration's float32 with TF32 off.

Poses are rotation matrices [...,3,3] and translations [...,3]; the
program's pose7 ([qw, qx, qy, qz, tx, ty, tz]) is converted by
:func:`pose7_to_rt`.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import torch

MIN_INLIERS = 24
# Elements of one [rows, R] block of distances.
BLOCK_ELEMS = 1 << 27


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (1 sign, 8 exponent, 10 mantissa
    bits), to nearest with ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Precision(NamedTuple):
    dtype: torch.dtype = torch.float64
    tf32: bool = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b in this precision."""
        a, b = a.to(self.dtype), b.to(self.dtype)
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return a @ b


F64 = Precision()
TF32 = Precision(torch.float32, True)


# --------------------------------------------------------------------------
# Rotations
# --------------------------------------------------------------------------

def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [...,4] (w, x, y, z) -> rotation [...,3,3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation [...,3,3] -> unit quaternion [...,4] (w, x, y, z), w >= 0,
    by the largest of the four pivots."""
    m = R
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    piv = torch.stack([tr, m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], -1)
    k = torch.argmax(piv, dim=-1)
    s = torch.sqrt(torch.clamp(1.0 + torch.stack([
        tr, 2 * m[..., 0, 0] - tr, 2 * m[..., 1, 1] - tr,
        2 * m[..., 2, 2] - tr], -1), min=1e-30))           # 2 * |pivot|
    c = [torch.stack([s[..., 0] / 2,
                      (m[..., 2, 1] - m[..., 1, 2]) / (2 * s[..., 0]),
                      (m[..., 0, 2] - m[..., 2, 0]) / (2 * s[..., 0]),
                      (m[..., 1, 0] - m[..., 0, 1]) / (2 * s[..., 0])], -1),
         torch.stack([(m[..., 2, 1] - m[..., 1, 2]) / (2 * s[..., 1]),
                      s[..., 1] / 2,
                      (m[..., 0, 1] + m[..., 1, 0]) / (2 * s[..., 1]),
                      (m[..., 0, 2] + m[..., 2, 0]) / (2 * s[..., 1])], -1),
         torch.stack([(m[..., 0, 2] - m[..., 2, 0]) / (2 * s[..., 2]),
                      (m[..., 0, 1] + m[..., 1, 0]) / (2 * s[..., 2]),
                      s[..., 2] / 2,
                      (m[..., 1, 2] + m[..., 2, 1]) / (2 * s[..., 2])], -1),
         torch.stack([(m[..., 1, 0] - m[..., 0, 1]) / (2 * s[..., 3]),
                      (m[..., 0, 2] + m[..., 2, 0]) / (2 * s[..., 3]),
                      (m[..., 1, 2] + m[..., 2, 1]) / (2 * s[..., 3]),
                      s[..., 3] / 2], -1)]
    q = torch.gather(torch.stack(c, -2), -2,
                     k[..., None, None].expand(k.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def rt_to_pose7(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(rotation [...,3,3], translation [...,3]) -> pose7 [...,7]."""
    return torch.cat([matrix_to_quat(R), t], dim=-1)


def pose7_to_rt(p: torch.Tensor, dtype=torch.float64):
    """pose7 [...,7] -> (rotation [...,3,3], translation [...,3])."""
    p = p.to(dtype)
    return quat_to_matrix(p[..., :4]), p[..., 4:]


def hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([z, -w[..., 2], w[..., 1], w[..., 2], z, -w[..., 0],
                        -w[..., 1], w[..., 0], z],
                       dim=-1).reshape(w.shape[:-1] + (3, 3))


def exp_se3(delta: torch.Tensor):
    """exp([omega, v]) -> (R [...,3,3], t [...,3]): Rodrigues' rotation and
    the left Jacobian of SO(3) applied to v."""
    w, v = delta[..., :3], delta[..., 3:]
    th2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = th2 < 1e-12
    th2s = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2s)
    K = hat(w)
    K2 = K @ K
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2s)
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th - torch.sin(th)) / (th2s * th))
    eye = torch.eye(3, dtype=delta.dtype, device=delta.device)
    R = eye + a * K + b * K2
    V = eye + b * K + c * K2
    return R, (V @ v[..., None])[..., 0]


def rotation_angle_deg(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Angle in degrees of Ra^T Rb [...]."""
    M = Ra.transpose(-1, -2) @ Rb
    tr = M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    # Near 0 the arccos loses digits: take the angle from the skew part.
    skew = torch.stack([M[..., 2, 1] - M[..., 1, 2],
                        M[..., 0, 2] - M[..., 2, 0],
                        M[..., 1, 0] - M[..., 0, 1]], dim=-1)
    sin = 0.5 * torch.linalg.norm(skew, dim=-1)
    return torch.rad2deg(torch.atan2(sin, cos))


# --------------------------------------------------------------------------
# Nearest neighbours and normals
# --------------------------------------------------------------------------

def _row_blocks(rows: int, cols: int):
    step = max(1, min(rows, BLOCK_ELEMS // max(cols, 1)))
    for s in range(0, rows, step):
        yield s, min(s + step, rows)


def sq_distances(q: torch.Tensor, r: torch.Tensor,
                 prec: Precision) -> torch.Tensor:
    """|q - r|^2 [...,Q,R] by the expansion |q|^2 - 2 q.r + |r|^2, the
    product in ``prec``."""
    q, r = q.to(prec.dtype), r.to(prec.dtype)
    qq = torch.sum(q * q, dim=-1)[..., :, None]
    rr = torch.sum(r * r, dim=-1)[..., None, :]
    return torch.clamp(qq + rr - 2.0 * prec.mm(q, r.transpose(-1, -2)),
                       min=0.0)


def nearest(q: torch.Tensor, r: torch.Tensor, prec: Precision):
    """Exact 1-NN of q [B,Q,3] in r [B,R,3] (or [1,R,3], shared): (d2
    [B,Q], idx [B,Q]), in blocks of query rows."""
    B, Q = q.shape[:2]
    R = r.shape[1]
    d2 = torch.empty((B, Q), dtype=prec.dtype, device=q.device)
    idx = torch.empty((B, Q), dtype=torch.int64, device=q.device)
    lanes = max(1, BLOCK_ELEMS // max(Q * R, 1))
    if lanes > 1 or r.shape[0] == 1:
        for b0 in range(0, B, lanes):
            b1 = min(B, b0 + lanes)
            rb = r if r.shape[0] == 1 else r[b0:b1]
            for s, e in _row_blocks(Q, R):
                m, i = torch.min(sq_distances(q[b0:b1, s:e], rb, prec),
                                 dim=-1)
                d2[b0:b1, s:e], idx[b0:b1, s:e] = m, i
        return d2, idx
    for b in range(B):
        for s, e in _row_blocks(Q, R):
            m, i = torch.min(sq_distances(q[b, s:e], r[b], prec), dim=-1)
            d2[b, s:e], idx[b, s:e] = m, i
    return d2, idx


def knn_normals(points: torch.Tensor, k: int = 10,
                prec: Precision = F64) -> torch.Tensor:
    """Unit normals [S,N,3] of clouds [S,N,3] (every point valid): the
    eigenvector of the least eigenvalue of the covariance of each point's
    k nearest neighbours (itself included), turned towards the sensor
    origin."""
    S, N = points.shape[:2]
    pts = points.to(prec.dtype)
    out = torch.empty_like(pts)
    for s in range(S):
        for a, b in _row_blocks(N, N):
            d2 = sq_distances(pts[s, a:b], pts[s], prec)
            nb = torch.topk(d2, k, dim=-1, largest=False).indices
            neigh = pts[s][nb]                                  # [n,k,3]
            c = neigh - neigh.mean(dim=1, keepdim=True)
            cov = prec.mm(c.transpose(1, 2), c) / k
            n = torch.linalg.eigh(cov.to(torch.float64))[1][..., 0]
            n = n.to(prec.dtype)
            flip = torch.sum(n * pts[s, a:b], dim=-1, keepdim=True) > 0
            out[s, a:b] = torch.where(flip, -n, n)
    return out


# --------------------------------------------------------------------------
# ICP
# --------------------------------------------------------------------------

class IcpOut(NamedTuple):
    R: torch.Tensor          # [B,3,3]
    t: torch.Tensor          # [B,3]
    valid: torch.Tensor      # [B]
    iterations: torch.Tensor  # [B]
    # The pose every iteration started from, (R, t) [B,...] each, when
    # asked for: the queries each correspondence search received.
    iterates: Optional[List[tuple]] = None


SUPPORTED = {'trim_method': 'sort', 'gn_steps_per_match': 1,
             'coarse_capacity': 0}


def check_settings(icp: dict) -> None:
    """Raise on an ICP setting the reference does not implement."""
    for key, want in SUPPORTED.items():
        if icp.get(key, want) != want:
            raise ValueError(f'reference ICP: {key}={icp[key]!r} is not '
                             f'implemented (only {want!r})')


def icp(reading: torch.Tensor, mask: torch.Tensor, ref: torch.Tensor,
        ref_normals: torch.Tensor, R0: torch.Tensor, t0: torch.Tensor,
        settings: dict, prec: Precision = F64,
        keep_iterates: bool = False) -> IcpOut:
    """Register readings [B,N,3] (mask [B,N]) against references [B,R,3]
    with normals [B,R,3], or one shared reference [1,R,3], from the
    guesses (R0 [B,3,3], t0 [B,3]), all lanes together."""
    check_settings(settings)
    dt = prec.dtype
    B = reading.shape[0]
    dev = reading.device
    p = reading.to(dt)
    ref = ref.to(dt)
    nrm = ref_normals.to(dt)
    cut2 = float(settings['max_correspondence_dist_m']) ** 2
    ratio = float(settings['trimmed_dist_ratio'])
    smooth = int(settings['smooth_length'])
    max_it = int(settings['max_iterations'])
    R, t = R0.to(dt), t0.to(dt)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    hist = torch.full((B, smooth, 2), math.inf, dtype=dt, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    n_in = torch.zeros(B, dtype=torch.int64, device=dev)
    eye = torch.eye(6, dtype=dt, device=dev)
    iterates = [] if keep_iterates else None
    lanes = torch.arange(B, device=dev)[:, None]
    for _ in range(max_it):
        if keep_iterates:
            iterates.append((R.clone(), t.clone()))
        running = ~done
        pw = prec.mm(p, R.transpose(-1, -2)) + t[:, None, :]
        d2, idx = nearest(pw, ref, prec)
        if ref.shape[0] == 1:
            q, n = ref[0][idx], nrm[0][idx]
        else:
            q, n = ref[lanes, idx], nrm[lanes, idx]
        valid = mask & (d2 <= cut2)
        n_valid = valid.sum(dim=-1)
        srt = torch.sort(torch.where(valid, d2, torch.full_like(d2, math.inf)),
                         dim=-1).values
        k = torch.clamp(torch.floor(n_valid.to(torch.float64) * ratio)
                        .to(torch.int64), min=1) - 1
        thresh = torch.gather(srt, 1, k[:, None])
        inl = valid & (d2 <= thresh)
        n_new = inl.sum(dim=-1)
        enough = n_new >= MIN_INLIERS
        w = inl.to(dt)
        r = torch.sum(n * (pw - q), dim=-1)
        J = torch.cat([torch.linalg.cross(pw, n, dim=-1), n], dim=-1)
        Jw = J * w[..., None]
        A = prec.mm(Jw.transpose(1, 2), J)
        b = -prec.mm(Jw.transpose(1, 2), r[..., None])[..., 0]
        tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[:, None, None]
        A = A + 1e-6 * eye * (1.0 + tr / 6.0)
        delta = torch.linalg.solve(A, b[..., None])[..., 0]
        step_on = enough & ~done
        delta = torch.where(step_on[:, None], delta, torch.zeros_like(delta))
        Rd, td = exp_se3(delta)
        R_b = Rd @ R
        t_b = (Rd @ t[..., None])[..., 0] + td
        rolled = torch.cat([hist[:, 1:], torch.stack(
            [torch.linalg.norm(delta[:, :3], dim=-1),
             torch.linalg.norm(delta[:, 3:], dim=-1)], dim=-1)[:, None]],
            dim=1)
        hist_b = torch.where(step_on[:, None, None], rolled, hist)
        means = hist_b.mean(dim=1)
        converged = ((it + 1 >= smooth)
                     & (means[:, 0] < float(settings['min_diff_rot']))
                     & (means[:, 1] < float(settings['min_diff_trans'])))
        it_b = it + step_on.to(torch.int64)
        done_b = done | converged | ~enough
        R = torch.where(running[:, None, None], R_b, R)
        t = torch.where(running[:, None], t_b, t)
        it = torch.where(running, it_b, it)
        hist = torch.where(running[:, None, None], hist_b, hist)
        n_in = torch.where(running, n_new, n_in)
        done = torch.where(running, done_b, done)
    ok = n_in >= MIN_INLIERS
    R = torch.where(ok[:, None, None], R, R0.to(dt))
    t = torch.where(ok[:, None], t, t0.to(dt))
    return IcpOut(R, t, ok, it, iterates)
