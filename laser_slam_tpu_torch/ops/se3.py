"""SE(3) / SO(3) geometry core on torch tensors, batched.

Counterpart of ``laser_slam_tpu/ops/se3.py``, function for function.

Representation
--------------
A pose is a plain ``[..., 7]`` tensor ``[qw, qx, qy, qz, tx, ty, tz]``
(Hamilton quaternion, scalar first — the minkindr convention).  Tangent
vectors are ``[..., 6]`` tensors ``[omega(3), v(3)]`` (rotation first),
matching the noise-sigma ordering of the configs.

All functions broadcast over leading batch dimensions.  The small-angle
branches use the double-``where`` pattern so the singular branch never
sees the singular input (no NaN under autograd at omega == 0).
"""

from __future__ import annotations

import torch

# Small-angle guard. Below this squared angle we switch to Taylor expansions.
_EPS2 = 1e-12


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity pose7."""
    return torch.tensor([1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], dtype=dtype,
                        device=device)


def make(quat_wxyz, translation) -> torch.Tensor:
    """Assemble a pose7 from quaternion [...,4] and translation [...,3]."""
    return torch.cat([quat_wxyz, translation], dim=-1)


def rotation(pose7) -> torch.Tensor:
    """Quaternion part [...,4] (wxyz)."""
    return pose7[..., :4]


def translation(pose7) -> torch.Tensor:
    """Translation part [...,3]."""
    return pose7[..., 4:]


def _cross(a, b) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# ---------------------------------------------------------------------------
# Quaternion algebra (Hamilton, wxyz)
# ---------------------------------------------------------------------------

def quat_multiply(q1, q2) -> torch.Tensor:
    """Hamilton product q1 * q2, both [...,4] wxyz."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_normalize(q) -> torch.Tensor:
    """Unit-normalize, canonicalized to qw >= 0 (double cover)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_rotate(q, v) -> torch.Tensor:
    """Rotate vectors v [...,3] by quaternion q [...,4] (two cross
    products; cheaper than building the matrix for one vector)."""
    qw = q[..., :1]
    qv = q[..., 1:]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def quat_to_matrix(q) -> torch.Tensor:
    """Quaternion [...,4] -> rotation matrix [...,3,3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_from_matrix(m) -> torch.Tensor:
    """Rotation matrix [...,3,3] -> quaternion [...,4] (wxyz, qw>=0).

    Branch-free Shepperd's method: all four candidate quaternions are
    computed and the one with the largest pivot is selected.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-24))

    qw0 = safe_sqrt(1.0 + tr)  # pivot w
    cand0 = torch.stack([qw0, (m21 - m12) / qw0, (m02 - m20) / qw0,
                         (m10 - m01) / qw0], dim=-1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22)  # pivot x
    cand1 = torch.stack([(m21 - m12) / qx1, qx1, (m01 + m10) / qx1,
                         (m02 + m20) / qx1], dim=-1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22)  # pivot y
    cand2 = torch.stack([(m02 - m20) / qy2, (m01 + m10) / qy2, qy2,
                         (m12 + m21) / qy2], dim=-1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22)  # pivot z
    cand3 = torch.stack([(m10 - m01) / qz3, (m02 + m20) / qz3,
                         (m12 + m21) / qz3, qz3], dim=-1)

    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                          -m00 - m11 + m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([cand0, cand1, cand2, cand3], dim=-2)  # [...,4,4]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return quat_normalize(0.5 * q)


# ---------------------------------------------------------------------------
# SO(3) exp / log
# ---------------------------------------------------------------------------

def so3_exp_quat(omega) -> torch.Tensor:
    """Rotation vector [...,3] -> quaternion [...,4] (NaN-safe at 0)."""
    theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    small = theta2 < _EPS2
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    half = 0.5 * theta
    # sin(t/2)/t -> 1/2 - t^2/48 for small t
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([w, k * omega], dim=-1)


def so3_log(q) -> torch.Tensor:
    """Quaternion [...,4] -> rotation vector [...,3] (NaN-safe at the
    identity quaternion)."""
    q = torch.where(q[..., :1] < 0, -q, q)  # canonical hemisphere
    qv = q[..., 1:]
    sin2 = torch.sum(qv * qv, dim=-1, keepdim=True)
    small = sin2 < _EPS2
    sin_half = torch.sqrt(torch.where(small, torch.ones_like(sin2), sin2))
    cos_half = q[..., :1]
    half = torch.atan2(torch.where(small, torch.zeros_like(sin_half),
                                   sin_half), cos_half)
    # scale = theta / sin(theta/2); with u = theta/2 and sin2 = sin^2(u),
    # 2u/sin(u) = 2/(1 - u^2/6 + ...) ~ 2 + u^2/3 ~ 2 + sin2/3.
    scale = torch.where(small, 2.0 + sin2 / 3.0, 2.0 * half / sin_half)
    return scale * qv


def _hat(omega) -> torch.Tensor:
    """[...,3] -> skew matrix [...,3,3]."""
    o = torch.zeros(omega.shape[:-1], dtype=omega.dtype, device=omega.device)
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    m = torch.stack([o, -wz, wy, wz, o, -wx, -wy, wx, o], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def _eye3(omega) -> torch.Tensor:
    return torch.eye(3, dtype=omega.dtype, device=omega.device)


def _left_jacobian(omega) -> torch.Tensor:
    """SO(3) left Jacobian V(omega) [...,3,3]: t = V @ rho in SE(3) exp."""
    theta2 = torch.sum(omega * omega, dim=-1)[..., None, None]
    small = theta2 < _EPS2
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    K = _hat(omega)
    K2 = K @ K
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2_safe * theta))
    return _eye3(omega) + a * K + b * K2


def _left_jacobian_inv(omega) -> torch.Tensor:
    """Inverse of the SO(3) left Jacobian, [...,3,3] (NaN-safe at 0)."""
    theta2 = torch.sum(omega * omega, dim=-1)[..., None, None]
    small = theta2 < _EPS2
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    K = _hat(omega)
    K2 = K @ K
    half = 0.5 * theta
    sin_half = torch.sin(half)
    sin_half_safe = torch.where(small, torch.ones_like(sin_half), sin_half)
    # (1/theta^2) * (1 - theta/2 * cot(theta/2)) -> 1/12 + theta^2/720
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / sin_half_safe) / theta2_safe,
    )
    return _eye3(omega) - 0.5 * K + cot_term * K2


# ---------------------------------------------------------------------------
# SE(3) group operations
# ---------------------------------------------------------------------------

def compose(a, b) -> torch.Tensor:
    """a * b for pose7 tensors (first apply b, then a)."""
    q = quat_multiply(rotation(a), rotation(b))
    t = translation(a) + quat_rotate(rotation(a), translation(b))
    return make(q, t)


def inverse(p) -> torch.Tensor:
    """Group inverse of pose7."""
    qi = quat_conjugate(rotation(p))
    return make(qi, -quat_rotate(qi, translation(p)))


def apply(p, pts) -> torch.Tensor:
    """Transform points by pose7 (R @ x + t); leading dims broadcast."""
    return quat_rotate(rotation(p), pts) + translation(p)


def exp(xi) -> torch.Tensor:
    """SE(3) exponential: tangent [...,6] ([omega, v]) -> pose7."""
    omega = xi[..., :3]
    v = xi[..., 3:]
    q = so3_exp_quat(omega)
    t = torch.einsum('...ij,...j->...i', _left_jacobian(omega), v)
    return make(q, t)


def log(p) -> torch.Tensor:
    """SE(3) logarithm: pose7 -> tangent [...,6] ([omega, v])."""
    omega = so3_log(rotation(p))
    v = torch.einsum('...ij,...j->...i', _left_jacobian_inv(omega),
                     translation(p))
    return torch.cat([omega, v], dim=-1)


def retract(p, xi) -> torch.Tensor:
    """Right-multiplicative retraction p * exp(xi) used by the solvers."""
    return compose(p, exp(xi))


def local(a, b) -> torch.Tensor:
    """Tangent of b in the frame of a: log(a^-1 * b)."""
    return log(compose(inverse(a), b))


def to_matrix(p) -> torch.Tensor:
    """pose7 -> homogeneous [...,4,4]."""
    R = quat_to_matrix(rotation(p))
    t = translation(p)[..., :, None]
    top = torch.cat([R, t], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=p.dtype,
                          device=p.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def from_matrix(m) -> torch.Tensor:
    """Homogeneous [...,4,4] (or [...,3,4]) -> pose7, re-orthonormalizing
    the rotation block first."""
    R = orthonormalize(m[..., :3, :3])
    return make(quat_from_matrix(R), m[..., :3, 3])


def orthonormalize(R) -> torch.Tensor:
    """Project [...,3,3] onto SO(3) via SVD polar projection."""
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vt)
    # Flip the last singular direction if improper (det = -1).
    fix = torch.cat([torch.ones(R.shape[:-2] + (2,), dtype=R.dtype,
                                device=R.device), det[..., None]], dim=-1)
    return (u * fix[..., None, :]) @ vt


def normalize(p) -> torch.Tensor:
    """Renormalize the quaternion of a pose7 (drift control)."""
    return make(quat_normalize(rotation(p)), translation(p))


def translation_distance(a, b) -> torch.Tensor:
    """Euclidean distance between the translations of two poses."""
    return torch.linalg.norm(translation(a) - translation(b), dim=-1)


def rotation_angle(a, b) -> torch.Tensor:
    """Absolute rotation angle (rad) between two poses' orientations."""
    return torch.linalg.norm(so3_log(quat_multiply(
        quat_conjugate(rotation(a)), rotation(b))), dim=-1)
