"""The port's trajectory evaluation (``core/evaluation.py`` and
``tools/evaluate_trajectory.py``) against the JAX package's.

Inputs are seeded noisy trajectories.  Tolerance 1e-12 on every number
(the port's module is a float64 numpy copy); the tool's printed report
equal line for line; the TUM and KITTI loaders read files written by
either package's ``csvio`` to the same arrays.
"""

import importlib.util
import os

import numpy as np
import pytest

from laser_slam_tpu.core import csvio as jcsvio
from laser_slam_tpu.core import evaluation as jev
from laser_slam_tpu_torch.core import csvio
from laser_slam_tpu_torch.core import evaluation as ev
from laser_slam_tpu_torch.tools import evaluate_trajectory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-12


def trajectories(seed=0, n=60):
    """(reference, estimate) as (times_ns, poses7): a wavy path and a
    rotated, shifted, noisy copy stamped with jitter."""
    g = np.random.default_rng(seed)
    times = np.arange(n, dtype=np.int64) * 100_000_000
    yaw = np.cumsum(g.normal(0, 0.05, n))
    ref = np.zeros((n, 7))
    ref[:, 0], ref[:, 3] = np.cos(yaw / 2), np.sin(yaw / 2)
    ref[:, 4:] = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw),
                                     g.normal(0, 0.02, n)], 1), 0)
    q = np.array([np.cos(0.2), 0.05, -0.02, np.sin(0.2)])
    q /= np.linalg.norm(q)
    corr = np.concatenate([q, [1.5, -2.0, 0.3]])
    est = jev._compose(np.broadcast_to(corr, ref.shape), ref)
    est[:, 4:] += g.normal(0, 0.05, (n, 3))
    est[:, :4] += g.normal(0, 0.01, (n, 4))
    est[:, :4] /= np.linalg.norm(est[:, :4], axis=1, keepdims=True)
    jitter = g.integers(-5_000_000, 5_000_000, n)
    return (times, ref), (times + jitter, est)


def assert_close(a, b):
    if isinstance(a, (tuple, list)):
        for x, y in zip(a, b):
            assert_close(x, y)
    elif hasattr(a, '__dataclass_fields__'):
        for name in a.__dataclass_fields__:
            assert_close(getattr(a, name), getattr(b, name))
    elif isinstance(a, str):
        assert a == b
    else:
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_associate_matches_jax():
    (tr, _), (te, _) = trajectories(1)
    g = np.random.default_rng(2)
    for times_b in (tr, np.sort(g.choice(tr, 40, replace=False)),
                    tr + 30_000_000):
        for max_dt in (20_000_000, 1_000_000):
            a = ev.associate(te, times_b, max_dt)
            b = jev.associate(te, times_b, max_dt)
            assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize('with_scale', [False, True])
def test_umeyama_matches_jax(with_scale):
    g = np.random.default_rng(3)
    src = g.normal(size=(50, 3))
    dst = 1.3 * src @ np.diag([1, -1, -1]) + [1, 2, 3] + g.normal(
        0, 0.01, (50, 3))
    assert_close(ev.umeyama_alignment(src, dst, with_scale),
                 jev.umeyama_alignment(src, dst, with_scale))


@pytest.mark.parametrize('align', ['se3', 'sim3', 'origin', 'none'])
def test_ate_matches_jax(align):
    ref, est = trajectories(4)
    ours = ev.ate(est, ref, align=align)
    theirs = jev.ate(est, ref, align=align)
    assert_close(ours, theirs)
    as_dict = {int(t): p for t, p in zip(*est)}
    assert_close(ev.ate(as_dict, ref, align=align), theirs)
    with pytest.raises(ValueError):
        ev.ate(est, ref, align='bad')


@pytest.mark.parametrize('delta,unit', [(1, 'frames'), (5, 'frames'),
                                        (3.0, 'm'), (10.0, 'm')])
def test_rpe_matches_jax(delta, unit):
    ref, est = trajectories(5)
    assert_close(ev.rpe(est, ref, delta=delta, delta_unit=unit),
                 jev.rpe(est, ref, delta=delta, delta_unit=unit))
    with pytest.raises(ValueError):
        ev.rpe(est, ref, delta=1e6, delta_unit='m')


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_loaders_read_either_packages_files(tmp_path, writer):
    ref, _ = trajectories(6, n=12)
    rows = [(int(t), p.astype(np.float32)) for t, p in zip(*ref)]
    io = csvio if writer == 'port' else jcsvio
    tum, kitti = str(tmp_path / 't.tum'), str(tmp_path / 't.kitti')
    io.write_trajectory_tum(rows, tum)
    io.write_trajectory_kitti(rows, kitti)
    for ours, theirs in ((ev.load_trajectory_tum(tum),
                          jev.load_trajectory_tum(tum)),
                         (ev.load_trajectory_kitti(kitti, ref[0]),
                          jev.load_trajectory_kitti(kitti, ref[0])),
                         (ev.load_trajectory_kitti(kitti),
                          jev.load_trajectory_kitti(kitti))):
        assert np.array_equal(ours[0], theirs[0])
        np.testing.assert_allclose(ours[1], theirs[1], atol=ATOL, rtol=0)
    np.testing.assert_allclose(ev.load_trajectory_tum(tum)[1][:, 4:],
                               ref[1][:, 4:], atol=1e-6)


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        'jax_evaluate_trajectory',
        os.path.join(REPO, 'tools', 'evaluate_trajectory.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize('fmt,extra', [
    ('tum', []), ('tum', ['--align', 'sim3', '--rpe-unit', 'm',
                          '--rpe-delta', '5']),
    ('kitti', ['--align', 'origin']), ('csv', ['--align', 'none'])])
def test_evaluate_trajectory_tool_matches_jax(tmp_path, capsys, fmt, extra):
    ref, est = trajectories(7)
    paths = []
    for name, (t, p) in (('est', est), ('ref', ref)):
        path = str(tmp_path / f'{name}.{fmt}')
        rows = [(int(a), b) for a, b in zip(t if fmt != 'kitti' else ref[0],
                                            p)]
        if fmt == 'tum':
            csvio.write_trajectory_tum(rows, path)
        elif fmt == 'kitti':
            csvio.write_trajectory_kitti(rows, path)
        else:
            np.savetxt(path, [[a, *b[4:]] for a, b in rows], delimiter=',',
                       fmt='%.9g')
        paths.append(path)
    argv = [*paths, '--format', fmt, *extra]
    assert evaluate_trajectory.main(argv) == 0
    ours = capsys.readouterr().out
    assert jax_tool().main(argv) == 0
    theirs = capsys.readouterr().out
    assert ours == theirs and 'ATE translation' in ours
