"""The port's SE(3) core against the JAX package's, on the cases of
test_se3.py: random poses, small angles and rotations near pi.

Tolerance: 1e-6 absolute plus 1e-6 relative — both sides evaluate the
same f32 formulas; only the libm of sin/cos/atan2/sqrt and the order of
a few sums differ (~1 ulp at the unit scale of the inputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from laser_slam_tpu.ops import se3 as jse3
from laser_slam_tpu_torch.ops import se3 as tse3

torch.set_num_threads(2)
TOL = dict(atol=1e-6, rtol=1e-6)


def random_poses(rng, n, scale_t=2.0):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[q[:, 0] < 0] *= -1
    t = rng.normal(size=(n, 3)) * scale_t
    return np.concatenate([q, t], 1).astype(np.float32)


def tangents(rng):
    """Random tangents (|omega| < pi), small angles and angles near pi."""
    xi = rng.normal(size=(32, 6))
    norm = np.linalg.norm(xi[:, :3], axis=1, keepdims=True)
    xi[:, :3] *= np.minimum(1.0, 3.0 / norm)
    special = [[1e-9, 0, 0, 0.5, -0.2, 0.1], [0, 0, 0, 1, 2, 3],
               [1e-5, -1e-5, 1e-5, 0.1, 0.1, 0.1], [1e-7, 0, 0, 0, 0, 0]]
    for axis in np.eye(3):
        for ang in (np.pi - 1e-3, np.pi - 1e-2, 3.0):
            special.append(list(axis * ang) + [0.3, -0.1, 0.2])
    return np.concatenate([xi, special]).astype(np.float32)


def near_pi_matrices():
    mats = []
    for axis in np.eye(3):
        for angle in [0.0, np.pi - 1e-3, np.pi / 2, 3.0]:
            mats.append(ScipyRot.from_rotvec(axis * angle).as_matrix())
    return np.asarray(mats, np.float32)


def both(name, *args):
    """Run se3.<name> on both packages with the same numpy inputs."""
    j = np.asarray(getattr(jse3, name)(*[jnp.asarray(a) for a in args]))
    t = getattr(tse3, name)(*[torch.tensor(a) for a in args]).numpy()
    return j, t


def _cases(rng):
    a, b = random_poses(rng, 16), random_poses(rng, 16)
    pts = rng.normal(size=(16, 3)).astype(np.float32) * 3
    xi = tangents(rng)
    poses_xi = np.asarray(jse3.exp(jnp.asarray(xi)))
    noisy = (np.asarray(jse3.quat_to_matrix(jnp.asarray(a[:, :4])))
             + rng.normal(size=(16, 3, 3)).astype(np.float32) * 0.05)
    return {
        'compose': (a, b), 'inverse': (a,), 'apply': (a, pts),
        'quat_rotate': (a[:, :4], pts), 'quat_multiply': (a[:, :4],
                                                          b[:, :4]),
        'quat_to_matrix': (a[:, :4],),
        'quat_from_matrix': (near_pi_matrices(),),
        'so3_exp_quat': (xi[:, :3],), 'so3_log': (poses_xi[:, :4],),
        '_left_jacobian': (xi[:, :3],), '_left_jacobian_inv': (xi[:, :3],),
        'exp': (xi,), 'log': (poses_xi,), 'retract': (a, xi[:16]),
        'local': (a, b), 'to_matrix': (a,),
        'from_matrix': (np.asarray(jse3.to_matrix(jnp.asarray(a))),),
        'orthonormalize': (noisy.astype(np.float32),),
        'normalize': (a * 1.01,), 'translation_distance': (a, b),
        'rotation_angle': (a, b),
    }


NAMES = ['compose', 'inverse', 'apply', 'quat_rotate', 'quat_multiply',
         'quat_to_matrix', 'quat_from_matrix', 'so3_exp_quat', 'so3_log',
         '_left_jacobian', '_left_jacobian_inv', 'exp', 'log', 'retract',
         'local', 'to_matrix', 'from_matrix', 'orthonormalize', 'normalize',
         'translation_distance', 'rotation_angle']


@pytest.mark.parametrize('name', NAMES)
def test_matches_jax(rng, name):
    args = _cases(rng)[name]
    j, t = both(name, *args)
    assert t.shape == j.shape
    assert np.all(np.isfinite(t))
    np.testing.assert_allclose(t, j, **TOL)


def test_small_angle_branches_are_exact():
    xi = torch.tensor([[1e-9, 0, 0, 0.5, -0.2, 0.1],
                       [0, 0, 0, 1, 2, 3],
                       [1e-5, -1e-5, 1e-5, 0.1, 0.1, 0.1]])
    p = tse3.exp(xi)
    assert torch.all(torch.isfinite(p))
    np.testing.assert_allclose(tse3.log(p).numpy(), xi.numpy(), atol=1e-6)
    np.testing.assert_allclose(p[1, 4:].numpy(), [1, 2, 3], atol=1e-6)


def test_identity_and_broadcasting(rng):
    a = torch.as_tensor(random_poses(rng, 1)[0])
    eye = tse3.identity()
    np.testing.assert_allclose(tse3.compose(eye, a).numpy(), a.numpy(),
                               atol=1e-6)
    pts = torch.as_tensor(rng.normal(size=(5, 4, 3)).astype(np.float32))
    poses = torch.as_tensor(random_poses(rng, 5))
    out = tse3.apply(poses[:, None, :], pts)
    assert out.shape == (5, 4, 3)
    np.testing.assert_allclose(out[2].numpy(),
                               tse3.apply(poses[2], pts[2]).numpy(),
                               atol=1e-6)
