"""The port's online slice against the JAX package's OnlineRunner.

Both runners take the same frames (the JAX package's SyntheticStream),
the same configuration (``slice1_config`` at small capacities) and the
same loop-closure measurement.  Held to 1 mm / 0.01 degree per pose: the
two run the same f32 algorithm; normals pick neighbours by another
distance formula and sums round in another order.
"""

import dataclasses
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_slam_tpu import config as jcfg
from laser_slam_tpu.ops import se3 as jse3
from laser_slam_tpu.pipeline import online as jon
from laser_slam_tpu.pipeline import replay as jrep
from laser_slam_tpu_torch.config import slice1_config
from laser_slam_tpu_torch.pipeline import online as ton
from laser_slam_tpu_torch.pipeline import replay as trep

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SCANS, N_POINTS = 8, 1024
TRANS_TOL_M, ROT_TOL_DEG = 1e-3, 0.01
CAPS = dict(pose_capacity=16, factor_capacity=64)


def small_config():
    return slice1_config(scan_capacity=N_POINTS, reading_capacity=512,
                         nscan_in_sub_map=3)


def jax_config(cfg):
    return jcfg._from_dict(jcfg.EstimatorConfig, dataclasses.asdict(cfg))


def rot_deg(q1, q2):
    d = np.abs(np.clip(np.sum(q1 * q2, axis=-1), -1.0, 1.0))
    return np.degrees(2.0 * np.arccos(d))


def closure(frames, traj, i, j):
    """World-frame alignment from the true relative pose and the live
    estimates (tests/test_parity.py::measured_closure)."""
    rel = jse3.compose(jse3.inverse(jnp.asarray(frames[i].gt_pose7)),
                       jnp.asarray(frames[j].gt_pose7))
    T_a = jnp.asarray(traj[frames[i].time_ns])
    T_b = jnp.asarray(traj[frames[j].time_ns])
    return np.asarray(jse3.compose(T_a, jse3.compose(rel, jse3.inverse(T_b))),
                      np.float32)


def jax_state_numpy(state):
    return {k: np.array(v) for k, v in state._asdict().items()
            if k != 'rng_key'}


@pytest.fixture(scope='module')
def jax_run():
    """The JAX runner over the frames, with one loop closure at the end;
    keeps numpy copies of its state after scans 4 and 5."""
    frames = list(jrep.SyntheticStream(
        n_scans=N_SCANS, points_per_scan=N_POINTS, trajectory='line',
        step_m=0.5, noise_m=0.005, odom_noise=0.002, seed=7))
    runner = jon.OnlineRunner(jax_config(small_config()), **CAPS)
    states = {}
    for k, f in enumerate(frames):
        runner.process_scan(f.time_ns, f.points, f.odom_pose7)
        if k in (3, 4):
            states[k + 1] = jax_state_numpy(runner.state)
    w_T = closure(frames, runner.trajectory(), 0, N_SCANS - 1)
    runner.add_loop_closure(0, N_SCANS - 1, w_T)
    return frames, states, w_T, runner.trajectory()


def test_slice_matches_jax_runner(jax_run):
    frames, _, w_T, jtraj = jax_run
    runner = ton.OnlineRunner(small_config(), device='cpu', **CAPS)
    for f in frames:
        assert runner.process_scan(f.time_ns, f.points, f.odom_pose7)
    assert bool(runner.state.last_icp_valid)
    runner.add_loop_closure(0, N_SCANS - 1, w_T)
    ttraj = runner.trajectory()
    assert list(ttraj) == list(jtraj)
    a = np.stack(list(jtraj.values()))
    b = np.stack(list(ttraj.values()))
    assert np.all(np.isfinite(b))
    assert np.linalg.norm(a[:, 4:] - b[:, 4:], axis=1).max() < TRANS_TOL_M
    assert rot_deg(a[:, :4], b[:, :4]).max() < ROT_TOL_DEG
    assert int(runner.state.n_rel) == 2 * (N_SCANS - 1) + 1


def test_state_from_numpy_then_one_step(jax_run):
    frames, states, _, _ = jax_run
    cfg = small_config()
    state = ton.state_from_numpy(states[4], device='cpu')
    assert set(ton.state_to_numpy(state)) == set(states[4])
    for name, value in ton.state_to_numpy(state).items():
        np.testing.assert_array_equal(value, states[4][name])
        assert value.dtype == states[4][name].dtype
    f = frames[4]
    padded = np.full((N_POINTS, 3), 1.0e6, np.float32)
    padded[:len(f.points)] = f.points[:N_POINTS]
    state, info = ton.online_step(
        state, torch.tensor(padded), min(len(f.points), N_POINTS),
        torch.tensor(f.odom_pose7), cfg, first_scan=False)
    want = states[5]
    got = ton.state_to_numpy(state)
    assert int(info.key) == 4
    for name in ('n_poses', 'n_rel', 'n_prior', 'ring_keys',
                 'track_last_key', 'rel_keys', 'rel_robust', 'ring_mask',
                 'last_icp_valid'):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    n = int(want['n_poses'])
    t, w = got['traj_poses'][:n], want['traj_poses'][:n]
    assert np.linalg.norm(t[:, 4:] - w[:, 4:], axis=1).max() < TRANS_TOL_M
    assert rot_deg(t[:, :4], w[:, :4]).max() < ROT_TOL_DEG
    for name, atol in (('rel_meas', 1e-4), ('rel_sqrt_info', 0),
                       ('rel_weight', 0), ('pose_meas', 1e-6),
                       ('ring_points', 0)):
        np.testing.assert_allclose(got[name], want[name], atol=atol,
                                   err_msg=name)
    dots = np.abs(np.sum(got['ring_normals'] * want['ring_normals'], -1))
    assert np.all(dots > 0.999)


def test_growth_sampling_closure_branches_and_online_solve(jax_run):
    """Port-only paths of the runner: buffers that grow mid-run give the
    same trajectory as buffers that never grow; random sampling draws from
    the runner's generator (same seed, same result); a linking closure
    writes the first-association sigmas and drops the given prior;
    online_solve on a solved state moves nothing."""
    frames = jax_run[0][:3]
    cfg = small_config()
    trajs, caps_after = [], []
    for caps in (dict(pose_capacity=2, factor_capacity=2), CAPS):
        runner = ton.OnlineRunner(cfg, device='cpu', **caps)
        for f in frames:
            runner.process_scan(f.time_ns, f.points, f.odom_pose7)
        trajs.append(np.stack(list(runner.trajectory().values())))
        caps_after.append((runner.state.traj_poses.shape[0],
                           runner.state.rel_meas.shape[0]))
    assert caps_after == [(4, 4), (16, 64)]
    np.testing.assert_allclose(trajs[0], trajs[1], atol=1e-5)

    sampled = dataclasses.replace(cfg, laser_track=dataclasses.replace(
        cfg.laser_track, icp=dataclasses.replace(
            cfg.laser_track.icp, reading_sampling_ratio=0.5)))
    runs = []
    for _ in range(2):
        runner = ton.OnlineRunner(sampled, seed=3, device='cpu', **CAPS)
        for f in frames:
            runner.process_scan(f.time_ns, f.points, f.odom_pose7)
        runs.append(np.stack(list(runner.trajectory().values())))
    np.testing.assert_array_equal(runs[0], runs[1])

    state = runner.state
    ident = torch.tensor([1.0, 0, 0, 0, 0, 0, 0])
    n_rel = int(state.n_rel)
    state, info = ton._append_lc_and_solve(
        state, 0, 2, ident, sampled, remove_prior_slot=0,
        use_association=True)
    assert int(state.n_rel) == n_rel + 1 and int(info.key) == 2
    np.testing.assert_allclose(
        state.rel_sqrt_info[n_rel].numpy(),
        1.0 / np.asarray(sampled.first_association_noise_model), rtol=1e-6)
    assert not bool(state.rel_robust[n_rel])
    assert float(state.prior_weight[0]) == 0.0

    state = ton.state_from_numpy(jax_run[1][5], device='cpu')
    before = state.traj_poses.clone()
    state, err = ton.online_solve(state, cfg)
    assert np.isfinite(float(err))
    np.testing.assert_allclose(state.traj_poses.numpy(), before.numpy(),
                               atol=1e-4)


def test_port_stream_matches_jax_stream():
    kw = dict(n_scans=3, points_per_scan=512, trajectory='circle',
              radius_m=15.0, noise_m=0.005, odom_noise=0.002, seed=7,
              laps=2)
    for jf, tf in zip(jrep.SyntheticStream(**kw), trep.SyntheticStream(**kw)):
        assert jf.time_ns == tf.time_ns
        np.testing.assert_array_equal(tf.gt_pose7, jf.gt_pose7)
        np.testing.assert_allclose(tf.odom_pose7, jf.odom_pose7, atol=1e-6)
        np.testing.assert_allclose(tf.points, jf.points, atol=1e-4)


def test_runner_gating_and_later_slices():
    runner = ton.OnlineRunner(small_config(), device='cpu',
                              minimum_distance_to_add_pose=1.0, **CAPS)
    pts = np.random.default_rng(0).normal(size=(256, 3)).astype(np.float32)
    odom = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    assert runner.process_scan(0, pts * 10, odom)
    assert not runner.process_scan(1, pts * 10, odom)   # has not moved
    # Multi-robot runs came with slice 4: a track past n_tracks raises.
    with pytest.raises(ValueError, match='n_tracks'):
        runner.process_scan(2, pts, odom, track_id=1)
    # Verification came with slice 3; it needs the scan archive.
    with pytest.raises(ValueError, match='archive'):
        runner.add_loop_closure(0, 0, odom, verify_with_icp=True)
    # The window solve came with slice 2: a windowed runner integrates.
    windowed = dataclasses.replace(
        small_config(), solver=dataclasses.replace(small_config().solver,
                                                   window=8))
    wrun = ton.OnlineRunner(windowed, device='cpu', **CAPS)
    assert wrun.process_scan(0, pts * 10, odom)
    assert wrun.process_scan(1, pts * 10, odom)
    assert np.all(np.isfinite(np.stack(list(wrun.trajectory().values()))))
    with pytest.raises(ValueError, match='n_tracks'):
        wrun.process_scans([(2, pts, odom)], track_id=1)
    # The delta closure solve came with slice 10: the closure is added
    # through the cache and the poses stay finite.
    delta = dataclasses.replace(small_config(), solver=dataclasses.replace(
        small_config().solver, preconditioner='woodbury',
        closure_solve='delta'))
    drun = ton.OnlineRunner(delta, device='cpu', **CAPS)
    moved = odom.copy()
    moved[4] = 0.5
    drun.process_scan(0, pts * 10, odom)
    drun.process_scan(1, pts * 10, moved)
    assert drun.add_loop_closure(0, 1, moved)
    assert int(drun.state.n_rel) == 3
    assert drun._solver_cache is not None
    assert np.all(np.isfinite(np.stack(list(drun.trajectory().values()))))


def test_entry_points_default_to_the_card():
    """A caller who names no device gets the card; where there is none,
    an error, not a CPU run."""
    import inspect
    for fn in (ton.init_state, ton.state_from_numpy, ton.OnlineRunner):
        assert inspect.signature(fn).parameters['device'].default == 'cuda'
    if torch.cuda.is_available():
        runner = ton.OnlineRunner(small_config(), **CAPS)
        assert runner.state.traj_poses.device.type == 'cuda'
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ton.OnlineRunner(small_config(), **CAPS)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ton.init_state(small_config(), 4, 4)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ton.state_from_numpy({})
    assert ton.resolve_device('cpu') == torch.device('cpu')


def test_port_imports_no_jax():
    """Importing the port (and loading chip_smoke.py) leaves jax, the JAX
    package and yaml out of sys.modules."""
    code = (
        'import sys, runpy; sys.path.insert(0, {repo!r})\n'
        'import laser_slam_tpu_torch\n'
        'from laser_slam_tpu_torch.pipeline import online, replay\n'
        'from laser_slam_tpu_torch.ops import nn_kernels, cuda_build\n'
        'from laser_slam_tpu_torch.ops import nn_variants\n'
        'from laser_slam_tpu_torch.ops import range_image, spherical\n'
        'from laser_slam_tpu_torch.pipeline import velodyne_sim\n'
        'from laser_slam_tpu_torch.experiments import nn_shootout\n'
        'from laser_slam_tpu_torch.ops import scan_context\n'
        'from laser_slam_tpu_torch.pipeline import place_recognition\n'
        'from laser_slam_tpu_torch.pipeline import device_map\n'
        'from laser_slam_tpu_torch.core import benchmarker\n'
        'from laser_slam_tpu_torch.parallel import fleet, sharding\n'
        "runpy.run_path({smoke!r}, run_name='chip_smoke')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'yaml' or m == 'scipy' or m.startswith('scipy.')"
        " or m == 'laser_slam_tpu'"
        " or m.startswith('laser_slam_tpu.') or m == 'experiments'"
        " or m.startswith('experiments.')]\n"
        'assert not bad, bad\n').format(
            repo=REPO, smoke=os.path.join(REPO, 'chip_smoke.py'))
    subprocess.run([sys.executable, '-c', code], check=True, timeout=120,
                   cwd=REPO)


def test_port_sources_never_import_jax():
    """No port source and no chip_smoke.py imports the JAX package (or
    jax, scipy, experiments), nor names a path into it: the JAX native
    directory, its library's file name (the port builds its own under
    ``_build/`` with a hashed name), or a path component
    ``'laser_slam_tpu'`` given to os.path.join or pathlib."""
    pattern = re.compile(r'^\s*(import|from)\s+'
                         r'(jax|laser_slam_tpu|experiments|scipy)(\.|\s|$)',
                         re.M)
    path_patterns = [
        re.compile(r'laser_slam_tpu[/\\]native'),
        re.compile(r'liblaserslamio\.so'),
        re.compile(r"""['"]laser_slam_tpu['"]"""),
        re.compile(r"""import_module\(\s*['"](jax|laser_slam_tpu)\b"""),
    ]
    files = [os.path.join(REPO, 'chip_smoke.py')]
    for root, dirs, names in os.walk(os.path.join(REPO,
                                                  'laser_slam_tpu_torch')):
        dirs[:] = [d for d in dirs if d != '_build']
        files += [os.path.join(root, n) for n in names
                  if n.endswith(('.py', '.cpp', '.cu', '.cuh'))]
    for path in files:
        with open(path) as fh:
            text = fh.read()
        assert not pattern.search(text), path
        for p in path_patterns:
            assert not p.search(text), (path, p.pattern)
    # The patterns catch what they are meant to.
    for bad in ("os.path.join(REPO, 'laser_slam_tpu', 'native')",
                'ctypes.CDLL("laser_slam_tpu/native/liblaserslamio.so")',
                "importlib.import_module('laser_slam_tpu.native')"):
        assert any(p.search(bad) for p in path_patterns), bad
