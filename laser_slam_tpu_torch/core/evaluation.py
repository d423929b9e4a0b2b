"""Trajectory evaluation: ATE / RPE with closed-form alignment.

Counterpart of ``laser_slam_tpu/core/evaluation.py``, copied: that
module is numpy only, and the port keeps its own copy rather than import
the JAX package.  The reference ships no evaluation tooling (its
validation is manual rosbag replay plus external tools); this module
gives the standard odometry/SLAM metrics:

* **ATE** (absolute trajectory error): per-pose distance between the
  estimate and ground truth after an optimal rigid (or similarity)
  alignment, the global-consistency metric.
* **RPE** (relative pose error): error of the relative motion over a
  fixed frame (or distance) delta, the drift-rate metric, independent
  of global alignment.
* **Umeyama alignment**: closed-form least-squares SE(3)/Sim(3) fit
  between corresponding point sets (Umeyama, IEEE TPAMI 1991), used by
  ATE and available standalone.

Conventions match the rest of the port: pose7 = [qw,qx,qy,qz,tx,ty,tz]
(wxyz-first quaternion), trajectories as either a dict
``{time_ns: pose7}`` (the worker/runner export shape) or a pair of
arrays ``(times[N], poses[N,7])``.  Everything here is host-side float64
numpy: evaluation is offline tooling, not device compute.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np

TrajLike = Union[Dict[int, np.ndarray], Tuple[np.ndarray, np.ndarray]]


# ---------------------------------------------------------------------------
# pose7 numpy helpers (float64 twins of ops/se3.py's torch ops)
# ---------------------------------------------------------------------------

def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """[...,4] wxyz -> [...,3,3]."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = np.empty(q.shape[:-1] + (3, 3))
    m[..., 0, 0] = 1 - 2 * (y * y + z * z)
    m[..., 0, 1] = 2 * (x * y - w * z)
    m[..., 0, 2] = 2 * (x * z + w * y)
    m[..., 1, 0] = 2 * (x * y + w * z)
    m[..., 1, 1] = 1 - 2 * (x * x + z * z)
    m[..., 1, 2] = 2 * (y * z - w * x)
    m[..., 2, 0] = 2 * (x * z - w * y)
    m[..., 2, 1] = 2 * (y * z + w * x)
    m[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return m


def _quat_from_matrix(m: np.ndarray) -> np.ndarray:
    """[3,3] -> wxyz (robust single-matrix conversion)."""
    m = np.asarray(m, np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 0.0)) * 2
    q = np.empty(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q / np.linalg.norm(q)


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    w2, x2, y2, z2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], axis=-1)


def _quat_conj(q: np.ndarray) -> np.ndarray:
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _rotation_angle(qa: np.ndarray, qb: np.ndarray) -> np.ndarray:
    """Angle (rad) between batches of wxyz quaternions."""
    qa = qa / np.linalg.norm(qa, axis=-1, keepdims=True)
    qb = qb / np.linalg.norm(qb, axis=-1, keepdims=True)
    dot = np.clip(np.abs(np.sum(qa * qb, axis=-1)), 0.0, 1.0)
    return 2.0 * np.arccos(dot)


def _compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """pose7 composition a*b, batched."""
    q = _quat_mul(a[..., :4], b[..., :4])
    Ra = _quat_to_matrix(a[..., :4])
    t = a[..., 4:] + np.einsum('...ij,...j->...i', Ra, b[..., 4:])
    return np.concatenate([q, t], axis=-1)


def _inverse(p: np.ndarray) -> np.ndarray:
    qi = _quat_conj(p[..., :4])
    Ri = _quat_to_matrix(qi)
    ti = -np.einsum('...ij,...j->...i', Ri, p[..., 4:])
    return np.concatenate([qi, ti], axis=-1)


# ---------------------------------------------------------------------------
# Association + alignment
# ---------------------------------------------------------------------------

def _as_arrays(traj: TrajLike) -> Tuple[np.ndarray, np.ndarray]:
    if isinstance(traj, dict):
        times = np.asarray(sorted(traj), np.int64)
        poses = np.asarray([traj[t] for t in times], np.float64)
    else:
        times, poses = traj
        times = np.asarray(times, np.int64)
        poses = np.asarray(poses, np.float64)
        order = np.argsort(times, kind='stable')
        times, poses = times[order], poses[order]
    assert poses.ndim == 2 and poses.shape[1] == 7, poses.shape
    return times, poses


def associate(times_a: np.ndarray, times_b: np.ndarray,
              max_dt_ns: int = 20_000_000) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy nearest-timestamp association (the TUM benchmark scheme):
    for each time in ``times_a``, the closest unmatched ``times_b`` entry
    within ``max_dt_ns``.  Returns (idx_a, idx_b) index arrays."""
    ia, ib = [], []
    j = 0
    used = np.zeros(len(times_b), bool)
    for i, t in enumerate(times_a):
        while j + 1 < len(times_b) and abs(int(times_b[j + 1]) - int(t)) <= \
                abs(int(times_b[j]) - int(t)):
            j += 1
        if not used[j] and abs(int(times_b[j]) - int(t)) <= max_dt_ns:
            ia.append(i)
            ib.append(j)
            used[j] = True
    return np.asarray(ia, np.int64), np.asarray(ib, np.int64)


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares ``dst ~= s * R @ src + t`` (Umeyama 1991).

    src/dst: [N,3] corresponding points.  Returns (R [3,3], t [3], s).
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    assert src.shape == dst.shape and src.shape[0] >= 3, src.shape
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs * xs).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_s) if var_s > 0 else 1.0
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ErrorStats:
    """Summary statistics over a per-sample error array."""
    rmse: float
    mean: float
    median: float
    std: float
    max: float
    n: int

    @staticmethod
    def of(errors: np.ndarray) -> 'ErrorStats':
        e = np.asarray(errors, np.float64)
        if e.size == 0:
            return ErrorStats(*(float('nan'),) * 5, 0)
        return ErrorStats(rmse=float(np.sqrt(np.mean(e * e))),
                          mean=float(e.mean()), median=float(np.median(e)),
                          std=float(e.std()), max=float(e.max()),
                          n=int(e.size))

    def __str__(self):
        return (f'rmse {self.rmse:.4f}  mean {self.mean:.4f}  '
                f'median {self.median:.4f}  max {self.max:.4f}  (n={self.n})')


@dataclasses.dataclass
class AteResult:
    translation: ErrorStats          # metres
    rotation_deg: ErrorStats         # degrees
    errors_m: np.ndarray             # [N] per-pose translation error
    alignment: Tuple[np.ndarray, np.ndarray, float]  # (R, t, s) applied


def ate(estimate: TrajLike, reference: TrajLike, align: str = 'se3',
        max_dt_ns: int = 20_000_000) -> AteResult:
    """Absolute trajectory error of ``estimate`` against ``reference``.

    align: 'se3' (Umeyama rigid fit — the standard ATE), 'sim3' (adds
    scale — for monocular-style estimates), 'origin' (rebase both to
    their first pose — what a SLAM run with a gauge prior at the origin
    warrants), or 'none'.
    """
    te, pe = _as_arrays(estimate)
    tr, pr = _as_arrays(reference)
    ie, ir = associate(te, tr, max_dt_ns)
    if len(ie) < 2:
        raise ValueError('fewer than 2 associated poses between '
                         f'{len(te)} estimate / {len(tr)} reference stamps')
    pe, pr = pe[ie], pr[ir]

    if align in ('se3', 'sim3'):
        R, t, s = umeyama_alignment(pe[:, 4:], pr[:, 4:],
                                    with_scale=(align == 'sim3'))
        qR = _quat_from_matrix(R)
        pe_t = s * pe[:, 4:] @ R.T + t
        pe_q = _quat_mul(np.broadcast_to(qR, pe[:, :4].shape), pe[:, :4])
        pe = np.concatenate([pe_q, pe_t], axis=1)
        alignment = (R, t, s)
    elif align == 'origin':
        corr = _compose(pr[0], _inverse(pe[0]))
        pe = _compose(np.broadcast_to(corr, pe.shape), pe)
        alignment = (_quat_to_matrix(corr[:4]), corr[4:], 1.0)
    elif align == 'none':
        alignment = (np.eye(3), np.zeros(3), 1.0)
    else:
        raise ValueError(f'unknown align mode {align!r}')

    errs = np.linalg.norm(pe[:, 4:] - pr[:, 4:], axis=1)
    rot = np.degrees(_rotation_angle(pe[:, :4], pr[:, :4]))
    return AteResult(translation=ErrorStats.of(errs),
                     rotation_deg=ErrorStats.of(rot),
                     errors_m=errs, alignment=alignment)


@dataclasses.dataclass
class RpeResult:
    translation: ErrorStats          # metres per delta
    rotation_deg: ErrorStats         # degrees per delta
    delta: float
    delta_unit: str                  # 'frames' | 'm'


def rpe(estimate: TrajLike, reference: TrajLike, delta: float = 1,
        delta_unit: str = 'frames',
        max_dt_ns: int = 20_000_000) -> RpeResult:
    """Relative pose error: for associated pose pairs ``delta`` apart,
    the SE(3) difference between estimated and reference relative motion
    (drift per frame / per metre; alignment-free).

    delta_unit 'frames': pairs (i, i+delta).  'm': for each i, the first
    j with reference path length >= delta metres; the translation error
    is normalized per metre of reference path actually travelled.
    """
    te, pe = _as_arrays(estimate)
    tr, pr = _as_arrays(reference)
    ie, ir = associate(te, tr, max_dt_ns)
    if len(ie) < 2:
        raise ValueError('fewer than 2 associated poses')
    pe, pr = pe[ie], pr[ir]
    n = len(pe)

    pairs = []
    if delta_unit == 'frames':
        d = int(delta)
        pairs = [(i, i + d) for i in range(n - d)]
        norm = np.ones(len(pairs))
    elif delta_unit == 'm':
        seg = np.linalg.norm(np.diff(pr[:, 4:], axis=0), axis=1)
        cum = np.concatenate([[0.0], np.cumsum(seg)])
        js = np.searchsorted(cum, cum[:n] + float(delta))
        pairs = [(i, int(j)) for i, j in enumerate(js) if j < n]
        norm = np.asarray([max(cum[j] - cum[i], 1e-9) for i, j in pairs])
    else:
        raise ValueError(f'unknown delta_unit {delta_unit!r}')
    if not pairs:
        raise ValueError('trajectory shorter than the requested delta')

    i0 = np.asarray([p[0] for p in pairs])
    i1 = np.asarray([p[1] for p in pairs])
    rel_e = _compose(_inverse(pe[i0]), pe[i1])
    rel_r = _compose(_inverse(pr[i0]), pr[i1])
    err = _compose(_inverse(rel_r), rel_e)
    t_err = np.linalg.norm(err[:, 4:], axis=1) / norm
    r_err = np.degrees(_rotation_angle(
        err[:, :4], np.broadcast_to(np.array([1.0, 0, 0, 0]),
                                    err[:, :4].shape)))
    return RpeResult(translation=ErrorStats.of(t_err),
                     rotation_deg=ErrorStats.of(r_err),
                     delta=float(delta), delta_unit=delta_unit)


# ---------------------------------------------------------------------------
# Trajectory file readers (writers live in csvio.py)
# ---------------------------------------------------------------------------

def load_trajectory_tum(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """TUM format (``t tx ty tz qx qy qz qw``, seconds) -> (times_ns,
    poses7).  Inverse of csvio.write_trajectory_tum."""
    data = np.atleast_2d(np.loadtxt(path, dtype=np.float64))
    times = (data[:, 0] * 1e9).round().astype(np.int64)
    poses = np.concatenate([data[:, [7, 4, 5, 6]], data[:, 1:4]], axis=1)
    return times, poses


def load_trajectory_kitti(path: str,
                          times_ns: Optional[np.ndarray] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI odometry format (12 floats: row-major 3x4 [R|t]) ->
    (times_ns, poses7).  KITTI files carry no timestamps; pass
    ``times_ns`` or get 0..N-1."""
    data = np.atleast_2d(np.loadtxt(path, dtype=np.float64))
    n = data.shape[0]
    poses = np.empty((n, 7))
    for i in range(n):
        T = data[i].reshape(3, 4)
        poses[i, :4] = _quat_from_matrix(T[:, :3])
        poses[i, 4:] = T[:, 3]
    if times_ns is None:
        times_ns = np.arange(n, dtype=np.int64)
    return np.asarray(times_ns, np.int64), poses
