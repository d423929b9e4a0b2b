"""The port's KITTI path (``replay.KittiStream``, the prefetch loader and
``examples/kitti_replay.py``) against the JAX package's.

Each test writes its own KITTI-layout sequence (velodyne .bin scans of
the synthetic room, times.txt, calib.txt with a KITTI-like Tr, and
camera-frame poses).  Tolerances: times exact, points byte-equal, poses
within 1e-6 (quaternions up to sign: both packages convert in float32);
the example's trajectory against the JAX runner in the same config on
the same fixture within twice the measured gap, at least 1 mm / 0.01
degree (ROADMAP queue 3 states the gap); the port's K2 ('pallas') run
against its brute run within 1e-4 m (both matchers are exact).  The JAX
example runs once, in process, through a module fixture.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from laser_slam_tpu.pipeline import online as jonline
from laser_slam_tpu.pipeline import replay as jrep
from laser_slam_tpu_torch import native
from laser_slam_tpu_torch.examples import kitti_replay
from laser_slam_tpu_torch.pipeline import replay

torch.set_num_threads(2)
N_SCANS, N_POINTS = 6, 4096
SMALL_FLAGS = ['--sequence', '00', '--matcher', 'brute', '--window', '0',
               '--cpu', '--scan-capacity', '4096', '--reading-capacity',
               '2048', '--reading-sampling', '1.0']
# Twice the measured gap of the example against the JAX runner (ROADMAP
# queue 3), at least 1 mm / 0.01 degree.
TRANS_TOL_M, ROT_TOL_DEG = 1e-3, 0.01
# A KITTI-like Tr (cam-from-velo): camera axes (right, down, forward) =
# velo (-y, -z, +x), plus a small lever arm (tests/test_kitti.py).
TR = np.array([[0.0, -1.0, 0.0, -0.01],
               [0.0, 0.0, -1.0, -0.07],
               [1.0, 0.0, 0.0, -0.27],
               [0.0, 0.0, 0.0, 1.0]])


def pose_matrix(pose7):
    q = np.asarray(pose7[:4], np.float64)
    w, x, y, z = q / np.linalg.norm(q)
    T = np.eye(4)
    T[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)],
                 [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)],
                 [2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)]]
    T[:3, 3] = pose7[4:]
    return T


def write_kitti(root, n_scans=N_SCANS, seq='00', calib=True, poses=True,
                times=True):
    """A KITTI-layout sequence of the port's SyntheticStream (seed 17);
    returns its frames."""
    frames = list(replay.SyntheticStream(
        n_scans=n_scans, points_per_scan=N_POINTS, trajectory='line',
        step_m=1.2, noise_m=0.01, seed=17))
    seq_dir = os.path.join(root, 'sequences', seq)
    os.makedirs(os.path.join(seq_dir, 'velodyne'))
    rows = []
    for i, f in enumerate(frames):
        pts4 = np.concatenate([f.points, np.full((len(f.points), 1), 0.5,
                                                 np.float32)], axis=1)
        pts4.tofile(os.path.join(seq_dir, 'velodyne', f'{i:06d}.bin'))
        T = pose_matrix(f.gt_pose7)
        rows.append((TR @ T @ np.linalg.inv(TR) if calib else T)[:3]
                    .reshape(-1))
    if times:
        np.savetxt(os.path.join(seq_dir, 'times.txt'),
                   np.arange(n_scans) * 0.1 + 0.05, fmt='%.6f')
    if poses:
        os.makedirs(os.path.join(root, 'poses'), exist_ok=True)
        np.savetxt(os.path.join(root, 'poses', seq + '.txt'),
                   np.asarray(rows), fmt='%.9f')
    if calib:
        with open(os.path.join(seq_dir, 'calib.txt'), 'w') as fh:
            fh.write('P0: ' + ' '.join(['0'] * 12) + '\n')
            fh.write('Tr: ' + ' '.join(f'{v:.9f}' for v in TR[:3].ravel())
                     + '\n')
    return frames


def rot_deg(q1, q2):
    d = np.abs(np.sum(np.asarray(q1, np.float64) * np.asarray(q2), -1))
    return np.degrees(2 * np.arccos(np.clip(d, 0.0, 1.0)))


def gaps(ta, tb):
    assert sorted(ta) == sorted(tb)
    a = np.stack([ta[t] for t in sorted(ta)]).astype(np.float64)
    b = np.stack([tb[t] for t in sorted(tb)]).astype(np.float64)
    return (float(np.linalg.norm(a[:, 4:] - b[:, 4:], axis=1).max()),
            float(rot_deg(a[:, :4], b[:, :4]).max()))


@pytest.mark.parametrize('layout', [
    dict(), dict(calib=False), dict(poses=False), dict(times=False)],
    ids=['full', 'no-calib', 'no-poses', 'no-times'])
def test_kitti_stream_matches_jax(tmp_path, layout):
    write_kitti(str(tmp_path), **layout)
    for max_scans in (None, 3):
        ours = list(replay.KittiStream(str(tmp_path), '00',
                                       max_scans=max_scans))
        theirs = list(jrep.KittiStream(str(tmp_path), '00',
                                       max_scans=max_scans))
        assert len(ours) == len(theirs) == (max_scans or N_SCANS)
        for a, b in zip(ours, theirs):
            assert a.time_ns == b.time_ns
            assert a.points.dtype == np.float32
            assert a.points.tobytes() == b.points.tobytes()
            if layout.get('poses', True):
                q_sign = np.sign(np.dot(a.odom_pose7[:4], b.odom_pose7[:4]))
                np.testing.assert_allclose(a.odom_pose7[:4] * q_sign,
                                           b.odom_pose7[:4], atol=1e-6)
                np.testing.assert_allclose(a.odom_pose7[4:],
                                           b.odom_pose7[4:], atol=1e-6)
                assert a.gt_pose7 is a.odom_pose7
            else:
                assert a.odom_pose7 is None and b.odom_pose7 is None


def test_kitti_stream_recovers_the_velodyne_poses(tmp_path):
    frames = write_kitti(str(tmp_path))
    for f, g in zip(replay.KittiStream(str(tmp_path), '00'), frames):
        np.testing.assert_allclose(f.odom_pose7[4:], g.gt_pose7[4:],
                                   atol=1e-5)
        assert abs(float(np.dot(f.odom_pose7[:4], g.gt_pose7[:4]))) > \
            1 - 1e-9
    with pytest.raises(FileNotFoundError):
        replay.KittiStream(str(tmp_path), '01')


def test_prefetch_loader_reads_the_stream(tmp_path):
    write_kitti(str(tmp_path))
    stream = replay.KittiStream(str(tmp_path), '00')
    paths = [os.path.join(stream.velo_dir, f) for f in stream.files]
    with native.PrefetchLoader(paths) as loader:
        assert loader.native
        got = list(loader)
    assert [i for i, _ in got] == list(range(N_SCANS))
    for (_, pts), f in zip(got, stream):
        assert pts.tobytes() == f.points.tobytes()


@pytest.fixture(scope='module')
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('kitti'))
    write_kitti(root)
    return root


@pytest.fixture(scope='module')
def jax_example(fixture_root, tmp_path_factory):
    """The JAX example's main() on the fixture at the small flags; its
    runner is caught to read the full poses."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'examples'))
    try:
        import kitti_replay as jexample
    finally:
        sys.path.pop(0)
    caught = []

    class Runner(jonline.OnlineRunner):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            caught.append(self)

    out = str(tmp_path_factory.mktemp('jax_out'))
    csv = os.path.join(out, 'traj.csv')
    mp = pytest.MonkeyPatch()
    mp.setattr(jonline, 'OnlineRunner', Runner)
    mp.setattr(sys, 'argv', ['kitti_replay.py', '--root', fixture_root,
                             *SMALL_FLAGS, '--traj-out', csv])
    try:
        jexample.main()
    finally:
        mp.undo()
    return caught[0].trajectory(), csv, caught[0].config


@pytest.fixture(scope='module')
def port_example(fixture_root, tmp_path_factory):
    out = str(tmp_path_factory.mktemp('port_out'))
    csv = os.path.join(out, 'traj.csv')
    res = kitti_replay.main(['--root', fixture_root, *SMALL_FLAGS,
                             '--traj-out', csv,
                             '--map-out', os.path.join(out, 'map.xyz')])
    return res, csv, out


def test_kitti_replay_matches_jax_runner(jax_example, port_example):
    jtraj, jcsv, jcfg = jax_example
    res, csv, out = port_example
    assert res['runner'].device.type == 'cpu'
    assert dataclasses.asdict(res['runner'].config) == \
        dataclasses.asdict(jcfg)
    assert res['n'] == len(res['traj']) >= 2
    dt, dr = gaps(jtraj, res['traj'])
    print(f'kitti_replay vs the JAX runner: {dt:.3e} m, {dr:.3e} deg')
    assert dt <= TRANS_TOL_M and dr <= ROT_TOL_DEG
    assert res['ate'].translation.mean < 0.3
    assert os.path.getsize(os.path.join(out, 'map.xyz')) > 0
    assert res['occupied'] > 0
    # The trajectory CSV has JAX's layout: time_ns,x,y,z per key.
    ours, theirs = np.loadtxt(csv, delimiter=','), np.loadtxt(
        jcsv, delimiter=',')
    assert ours.shape == theirs.shape and ours.shape[1] == 4
    np.testing.assert_array_equal(ours[:, 0], theirs[:, 0])
    np.testing.assert_allclose(ours[:, 1:], theirs[:, 1:], atol=TRANS_TOL_M)
    with open(csv) as a, open(jcsv) as b:
        assert [len(r.split(',')) for r in a] == [len(r.split(','))
                                                  for r in b]


def test_kitti_replay_with_k2_matches_brute(fixture_root, port_example):
    res = kitti_replay.main(['--root', fixture_root, *[
        'pallas' if f == 'brute' else f for f in SMALL_FLAGS]])
    cfg = res['runner'].config.laser_track.icp
    assert cfg.matcher == 'pallas' and cfg.pallas_prune
    dt, _ = gaps(port_example[0]['traj'], res['traj'])
    print(f'kitti_replay pallas vs brute: {dt:.3e} m')
    assert dt <= 1e-4
