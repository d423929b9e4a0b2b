"""The port's multi-robot SLAM against the JAX package's OnlineRunner:
forced-prior tracks, cross-track linking with group alignment, chained
links, per-track archive windows and a cross-track detection.

The streams are those of tests/test_online.py and
tests/test_place_recognition.py (SyntheticStream, brute matcher,
sampling ratios 1.0).  Each JAX runner runs once, in a module fixture;
all of them share one configuration and one set of capacities (three
tracks, a scan archive), so the JAX side compiles its step once.

Tolerances.  Host bookkeeping (keys, prior slots, groups, detections) and
copies are exact.  A stream's poses hold twice their measured gap to the
JAX runner (GAP), at least 1 mm / 0.01 deg: ICP stops on a loose
differential test, so rounding moves a stream (test_torch_closures.py).
A link solved from the JAX runner's own pre-link state holds 1 cm, the
group alignment alone 1e-5.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laser_slam_tpu import config as jcfg
from laser_slam_tpu.ops import se3 as jse3
from laser_slam_tpu.pipeline import online as jon
from laser_slam_tpu.pipeline import replay as jrep
from laser_slam_tpu_torch.config import (EstimatorConfig, IcpConfig,
                                         InputFilterConfig, LaserTrackConfig,
                                         PlaceRecognitionConfig, SolverConfig)
from laser_slam_tpu_torch.ops import se3
from laser_slam_tpu_torch.pipeline import online as ton

torch.set_num_threads(2)
N = 8
CAPS = dict(pose_capacity=64, factor_capacity=256, archive_points=256,
            n_tracks=3)
# Measured gaps to the JAX runner (max m, max deg) of the two-track
# stream before its link and of the three-track stream with its chained
# links.
GAP = {'two': (0.0018476, 0.0053390), 'three': (0.0136633, 0.0306693)}


def est_config(force_priors=True, **lt):
    return EstimatorConfig(
        laser_track=LaserTrackConfig(
            nscan_in_sub_map=3, force_priors=force_priors,
            odometry_noise_model=(0.02,) * 3 + (0.05,) * 3,
            icp_noise_model=(0.01,) * 6,
            input_filters=InputFilterConfig(scan_capacity=2048),
            icp=IcpConfig(matcher='brute', reading_capacity=1024,
                          reading_sampling_ratio=1.0), **lt),
        solver=SolverConfig(gn_iterations=2, pcg_iterations=30))


def jax_config(cfg):
    return jcfg._from_dict(jcfg.EstimatorConfig, dataclasses.asdict(cfg))


def rot_deg(q1, q2):
    """Angle of q1^-1 q2 in degrees, in float64 by the atan2 form."""
    q1, q2 = q1.astype(np.float64), q2.astype(np.float64)
    w = np.sum(q1 * q2, axis=-1)
    v = (q1[:, :1] * q2[:, 1:] - q2[:, :1] * q1[:, 1:]
         - np.cross(q1[:, 1:], q2[:, 1:]))
    return np.degrees(2 * np.arctan2(np.linalg.norm(v, axis=1), np.abs(w)))


def gaps(a, b):
    """(max translation gap m, max rotation gap deg) of two [n,7]."""
    return (float(np.linalg.norm(a[:, 4:] - b[:, 4:], axis=1).max()),
            float(rot_deg(a[:, :4], b[:, :4]).max()))


def limits(gap):
    """Twice a measured (m, deg) gap, at least 1 mm / 0.01 deg."""
    return max(2 * gap[0], 1e-3), max(2 * gap[1], 0.01)


def assert_within(name, a, b):
    gap = gaps(a, b)
    print(f'{name} gap to the JAX runner (m, deg):', gap)
    t_lim, r_lim = limits(GAP[name])
    assert gap[0] <= t_lim and gap[1] <= r_lim, gap


def numpy_state(state):
    return {k: np.array(v) for k, v in state._asdict().items()
            if k != 'rng_key'}


def link_alignment(poses, gt, ka, kb, ia, ib):
    """w_T_a_b of a rendezvous from the true relative pose and the
    estimates (tests/test_online.py::test_multi_robot_link_absorbs_
    parked_offset)."""
    rel = jse3.compose(jse3.inverse(jnp.asarray(gt[0][ia])),
                       jnp.asarray(gt[1][ib]))
    return np.asarray(jse3.compose(jnp.asarray(poses[ka]), jse3.compose(
        rel, jse3.inverse(jnp.asarray(poses[kb])))), np.float32)


def expected_errors(poses, gt_a, gt_b, ka, ia, keys_b):
    """Distance of each of track b's poses from its expected place in the
    shared frame, anchored at track a's closure key."""
    Ta = jnp.asarray(poses[ka])
    out = []
    for j, kb in enumerate(keys_b):
        exp = jse3.compose(Ta, jse3.compose(
            jse3.inverse(jnp.asarray(gt_a[ia])), jnp.asarray(gt_b[j])))
        out.append(np.linalg.norm(np.asarray(exp)[4:] - poses[kb][4:]))
    return np.asarray(out)


def keys_of(runner, n_tracks):
    return [[k for k, (t, _) in enumerate(runner.key_info) if t == tid]
            for tid in range(n_tracks)]


@pytest.fixture(scope='module')
def streams():
    return [list(jrep.SyntheticStream(
        n_scans=N, points_per_scan=2048, trajectory='circle', radius_m=4.0,
        noise_m=0.005, odom_noise=0.01, seed=60 + t)) for t in range(2)]


def feed(runner, streams):
    for i in range(N):
        for t, s in enumerate(streams):
            f = s[i]
            assert runner.process_scan(f.time_ns + t, f.points, f.odom_pose7,
                                       track_id=t)


@pytest.fixture(scope='module')
def jax_link(streams):
    """tests/test_online.py:751 in the JAX package: two forced-prior
    tracks, interleaved, linked at their scan 3 (a refined closure: the
    runner keeps a scan archive)."""
    runner = jon.OnlineRunner(jax_config(est_config()), **CAPS)
    feed(runner, streams)
    pre = numpy_state(runner.state)
    poses = jon.extract_trajectory(runner.state)
    gt = [np.stack([f.gt_pose7 for f in s]) for s in streams]
    ks = keys_of(runner, 2)
    ka, kb = ks[0][3], ks[1][3]
    w_T = link_alignment(poses, gt, ka, kb, 3, 3)
    pre_track_keys = np.array(runner.archive.track_keys)
    assert runner.add_loop_closure(ka, kb, w_T)
    return dict(pre=pre, pre_poses=poses, post=numpy_state(runner.state),
                w_T=w_T, ka=ka, kb=kb, gt=gt, keys=ks,
                groups=[list(g) for g in runner._linked_groups],
                slots=dict(runner._prior_slot_of_track),
                key_info=list(runner.key_info),
                pre_track_keys=pre_track_keys)


@pytest.fixture(scope='module')
def port_pre_link(streams):
    runner = ton.OnlineRunner(est_config(), device='cpu', **CAPS)
    feed(runner, streams)
    return runner


def clone_runner(runner):
    """A runner that shares nothing mutable with ``runner``."""
    out = copy.copy(runner)
    out.state = ton.OnlineState(*(t.clone() for t in runner.state))
    out.archive = ton.ScanArchive(*(t.clone() for t in runner.archive))
    for name in ('key_info', '_linked_groups', '_prior_slot_of_track',
                 '_tracks_seen', '_prior_keys', '_last_key', '_last_odom'):
        setattr(out, name, copy.deepcopy(getattr(runner, name)))
    return out


def test_forced_priors_and_link_absorb_the_parked_offset(jax_link,
                                                         port_pre_link):
    """The port's runner over the same interleaved stream: forced priors
    park track 1 at y = 100 m; the link drops its prior, merges the
    groups and moves every absorbed pose to its shared-frame place."""
    runner = clone_runner(port_pre_link)
    pre = ton.state_to_numpy(runner.state)
    n = int(pre['n_poses'])
    assert runner.key_info == jax_link['key_info']
    for name in ('prior_keys', 'prior_meas', 'prior_weight', 'rel_keys',
                 'n_prior', 'n_rel', 'track_last_key', 'ring_keys'):
        np.testing.assert_array_equal(pre[name], jax_link['pre'][name],
                                      err_msg=name)
    np.testing.assert_array_equal(pre['prior_meas'][1],
                                  [1, 0, 0, 0, 0, 100.0, 0])
    assert_within('two', pre['traj_poses'][:n],
                  jax_link['pre']['traj_poses'][:n])
    assert runner._prior_slot_of_track == {1: 1}
    assert runner._linked_groups == [[0], [1]]
    np.testing.assert_array_equal(
        ton.archive_to_numpy(runner.archive)['track_keys'],
        jax_link['pre_track_keys'])

    ka, kb = jax_link['ka'], jax_link['kb']
    assert runner.add_loop_closure(ka, kb, jax_link['w_T'])
    assert runner._linked_groups == jax_link['groups'] == [[0, 1]]
    assert runner._prior_slot_of_track == jax_link['slots'] == {}
    post = ton.state_to_numpy(runner.state)
    np.testing.assert_array_equal(post['prior_weight'],
                                  jax_link['post']['prior_weight'])
    assert post['prior_weight'][1] == 0.0
    np.testing.assert_array_equal(post['rel_sqrt_info'][post['n_rel'] - 1],
                                  1.0 / np.float32([0.015] * 3 + [0.05] * 3))
    poses = post['traj_poses'][:n]
    gt = jax_link['gt']
    errs = expected_errors(poses, gt[0], gt[1], ka, 3, jax_link['keys'][1])
    assert errs.max() < 1.0, errs


def test_link_from_the_jax_state_matches_jax(jax_link, port_pre_link):
    """The link alone, from the JAX runner's pre-link state: every
    absorbed pose within 1 cm of the JAX runner's."""
    runner = clone_runner(port_pre_link)
    runner.state = ton.state_from_numpy(jax_link['pre'], device='cpu')
    assert runner.add_loop_closure(jax_link['ka'], jax_link['kb'],
                                   jax_link['w_T'])
    n = int(jax_link['post']['n_poses'])
    got = runner.state.traj_poses[:n].numpy()
    want = jax_link['post']['traj_poses'][:n]
    dt, dr = gaps(got, want)
    print('link from the JAX state: gap (m, deg)', dt, dr)
    assert dt <= 0.01 and dr <= 0.1, (dt, dr)
    errs = expected_errors(got, *jax_link['gt'], jax_link['ka'], 3,
                           jax_link['keys'][1])
    assert errs.max() < 1.0, errs


@pytest.mark.parametrize('absorbed', ['key_b', 'key_a'])
def test_group_alignment_matches_jax(jax_link, absorbed):
    """_apply_group_alignment on one state, the absorbed group on either
    side of the closure: within 1e-5."""
    pre = jax_link['pre']
    ka, kb = jax_link['ka'], jax_link['kb']
    if absorbed == 'key_a':
        ka, kb = kb, ka
    cap = pre['traj_poses'].shape[0]
    mask = np.zeros(cap, bool)
    mask[jax_link['keys'][1]] = True
    meas = np.asarray(jse3.compose(
        jse3.inverse(jnp.asarray(pre['traj_poses'][ka])),
        jse3.compose(jnp.asarray(jax_link['w_T']),
                     jnp.asarray(pre['traj_poses'][kb]))), np.float32)
    js = jon.OnlineState(**{k: jnp.asarray(v) for k, v in pre.items()},
                         rng_key=jax.random.key(0))
    jout = jax.jit(jon._apply_group_alignment)(
        js, jnp.int32(ka), jnp.int32(kb), jnp.asarray(meas),
        jnp.asarray(mask))
    ts = ton.state_from_numpy(pre, device='cpu')
    tout = ton._apply_group_alignment(ts, ka, kb, torch.tensor(meas),
                                      torch.tensor(mask))
    got = tout.traj_poses.numpy()
    np.testing.assert_allclose(got, np.asarray(jout.traj_poses), atol=1e-5)
    np.testing.assert_array_equal(got[~mask], pre['traj_poses'][~mask])


def test_chunked_multitrack_matches_sequential_and_jax(streams):
    """tests/test_online.py:538: track 0 x3, track 1 x3, twice, per scan
    and in chunks of 3 (forced priors on).  The port's two runs are
    bit-equal on the CPU; their poses, prior and rel keys, groups and
    prior slots match the JAX runner's."""
    fa, fb = streams[0][:6], streams[1][:6]
    cfg = est_config()
    jr = jon.OnlineRunner(jax_config(cfg), **CAPS)
    r_seq = ton.OnlineRunner(cfg, device='cpu', **CAPS)
    r_chk = ton.OnlineRunner(cfg, device='cpu', **CAPS)
    for i in (0, 3):
        for tid, fs in ((0, fa), (1, fb)):
            for f in fs[i:i + 3]:
                jr.process_scan(f.time_ns, f.points, f.odom_pose7,
                                track_id=tid)
                r_seq.process_scan(f.time_ns, f.points, f.odom_pose7,
                                   track_id=tid)
            assert r_chk.process_scans(fs[i:i + 3], track_id=tid,
                                       chunk_size=3) == 3
    seq, chk = (ton.state_to_numpy(r.state) for r in (r_seq, r_chk))
    for name, value in seq.items():
        np.testing.assert_array_equal(value, chk[name], err_msg=name)
    for a, b in zip(r_seq.archive, r_chk.archive):
        assert torch.equal(a, b)
    want = numpy_state(jr.state)
    for name in ('prior_keys', 'rel_keys', 'n_prior', 'n_rel'):
        np.testing.assert_array_equal(seq[name], want[name], err_msg=name)
    for r in (r_seq, r_chk):
        assert r._linked_groups == jr._linked_groups
        assert r._prior_slot_of_track == jr._prior_slot_of_track
        assert r.key_info == jr.key_info
    n = int(want['n_poses'])
    assert_within('two', seq['traj_poses'][:n], want['traj_poses'][:n])


@pytest.fixture(scope='module')
def three_tracks():
    """Three forced-prior tracks over one stream, interleaved (the
    stream of tests/test_online.py:499), with a scan archive."""
    return list(jrep.SyntheticStream(
        n_scans=N, points_per_scan=2048, trajectory='line', step_m=0.6,
        noise_m=0.005, odom_noise=0.005, seed=23))


def feed_three(runner, frames):
    for f in frames:
        for t in range(3):
            runner.process_scan(f.time_ns * 3 + t, f.points, f.odom_pose7,
                                track_id=t)


def chained_links(runner, frames, poses_of):
    """Link A-B at scan 4, then B-C at scan 6: each with the true
    relative pose (identity, one route) and the runner's estimates."""
    out = []
    for (ta, tb, i) in ((0, 1, 4), (1, 2, 6)):
        ka, kb = 3 * i + ta, 3 * i + tb
        poses = poses_of(runner)
        w_T = np.asarray(jse3.compose(jnp.asarray(poses[ka]), jse3.inverse(
            jnp.asarray(poses[kb]))), np.float32)
        assert runner.add_loop_closure(ka, kb, w_T)
        out.append(([list(g) for g in runner._linked_groups],
                    dict(runner._prior_slot_of_track)))
    return out


@pytest.fixture(scope='module')
def jax_three(three_tracks):
    runner = jon.OnlineRunner(jax_config(est_config()), **CAPS)
    feed_three(runner, three_tracks)
    archive = {k: np.array(v) for k, v in runner.archive._asdict().items()}
    steps = chained_links(runner, three_tracks, lambda r: np.asarray(
        jon.extract_trajectory(r.state)))
    return dict(archive=archive, steps=steps, post=numpy_state(runner.state))


def test_per_track_archive_windows(three_tracks, jax_three):
    """tests/test_online.py:499: every track's archive index windows over
    its own scans; a radius-3 submap around track 1's scan 4 (key 13)
    holds 7 scans, all of track 1.  The index arrays equal JAX's."""
    runner = ton.OnlineRunner(est_config(), device='cpu', **CAPS)
    feed_three(runner, three_tracks)
    got = ton.archive_to_numpy(runner.archive)
    for name in ('track', 'track_pos', 'track_keys', 'track_count', 'mask'):
        np.testing.assert_array_equal(got[name], jax_three['archive'][name],
                                      err_msg=name)
    center = 4 * 3 + 1
    assert runner.key_info[center][0] == 1
    cloud, _ = ton._gather_submap(runner.state, runner.archive, center,
                                  se3.identity(), 3)
    rows = cloud.mask.numpy().reshape(7, -1).any(axis=1)
    assert rows.sum() == 7, rows
    ks = got['track_keys'][1, got['track_pos'][center] - 3:
                           got['track_pos'][center] + 4]
    assert (got['track'][ks] == 1).all()


def test_chained_three_track_links_match_jax(three_tracks, jax_three):
    """A-B, then B-C: after each link the groups and prior slots equal
    the JAX runner's, and at the end only track 0's prior is active and
    the poses hold the stream's gap."""
    runner = ton.OnlineRunner(est_config(), device='cpu', **CAPS)
    feed_three(runner, three_tracks)
    steps = chained_links(runner, three_tracks,
                          lambda r: ton.extract_trajectory(r.state))
    assert steps == jax_three['steps']
    assert steps[0] == ([[0, 1], [2]], {2: 2})
    assert steps[-1] == ([[0, 1, 2]], {})
    post = ton.state_to_numpy(runner.state)
    want = jax_three['post']
    np.testing.assert_array_equal(post['prior_weight'], want['prior_weight'])
    np.testing.assert_array_equal(post['prior_weight'][:3], [1, 0, 0])
    n = int(want['n_poses'])
    assert_within('three', post['traj_poses'][:n], want['traj_poses'][:n])
    # One route: every track ends where track 0 is, at each scan.
    poses = post['traj_poses'][:n].reshape(N, 3, 7)
    for t in (1, 2):
        d = np.linalg.norm(poses[:, t, 4:] - poses[:, 0, 4:], axis=1)
        assert d.max() < 0.1, d


def test_cross_track_detection_links_the_robots():
    """tests/test_place_recognition.py:148: robot 1 re-drives robot 0's
    route; the shared detector fires cross-track detections (the same
    pairs as the JAX runner), which take the linking route.  ICP factors
    stay on here (the JAX test turns them off), so that the JAX runner
    reuses the module's compiled step."""
    cfg = est_config()
    pr = PlaceRecognitionConfig(detect_every=1, exclude_recent_keys=6,
                                min_keys_between_detections=4,
                                distance_threshold=0.1, db_capacity=64)
    kw = CAPS
    route = list(jrep.SyntheticStream(
        n_scans=N, points_per_scan=2048, trajectory='line', step_m=1.0,
        noise_m=0.005, odom_noise=0.005, seed=47))
    jr = jon.OnlineRunner(jax_config(cfg), place_recognition=(
        jcfg.PlaceRecognitionConfig(**dataclasses.asdict(pr))), **kw)
    tr = ton.OnlineRunner(cfg, place_recognition=pr, device='cpu', **kw)
    for r in (jr, tr):
        for tid, dt in ((0, 0), (1, 1)):
            for f in route:
                r.process_scan(f.time_ns + dt, f.points, f.odom_pose7,
                               track_id=tid)
    cross = [(a, b) for a, b, _, _ in tr.detections
             if tr.key_info[a][0] != tr.key_info[b][0]]
    assert cross, (tr.detections, tr.rejected_detections)
    assert [d[:2] for d in tr.detections] == [d[:2] for d in jr.detections]
    assert [d[:2] for d in tr.rejected_detections] == \
        [d[:2] for d in jr.rejected_detections]
    for a, b in cross:
        assert abs((b - a) - N) <= 1, cross
    assert tr._linked_groups == jr._linked_groups and \
        len(tr._linked_groups) == 1
    assert tr._prior_slot_of_track == {}
    poses = ton.extract_trajectory(tr.state)
    a, b = cross[0]
    assert np.linalg.norm(poses[a][4:] - poses[b][4:]) < 1.0


def test_warmup_with_association_is_pure(streams):
    """warmup_closure_path(use_association=True) warms the linking
    variant on clones: state, Woodbury cache and archive stay
    bit-equal."""
    cfg = dataclasses.replace(est_config(), solver=dataclasses.replace(
        est_config().solver, preconditioner='woodbury'))
    runner = ton.OnlineRunner(cfg, device='cpu', **CAPS)
    for i in range(3):
        for t, s in enumerate(streams):
            runner.process_scan(s[i].time_ns + t, s[i].points,
                                s[i].odom_pose7, track_id=t)
    runner._lc_solver_cache()
    before = ([t.clone() for t in runner.state],
              [t.clone() for t in runner.archive],
              {k: getattr(runner._solver_cache, k).clone()
               for k in ('Ua', 'Ub', 'ka', 'kb', 'chol_inv', 'n_used')})
    runner.warmup_closure_path(use_association=True)
    for a, b in zip(before[0], runner.state):
        assert torch.equal(a, b)
    for a, b in zip(before[1], runner.archive):
        assert torch.equal(a, b)
    for k, v in before[2].items():
        assert torch.equal(v, getattr(runner._solver_cache, k)), k
    assert runner._linked_groups == [[0], [1]]


def test_tracks_are_checked():
    runner = ton.OnlineRunner(est_config(), device='cpu', **CAPS)
    pts = np.zeros((16, 3), np.float32)
    with pytest.raises(ValueError, match='n_tracks'):
        runner.process_scan(0, pts, np.eye(1, 7, dtype=np.float32)[0],
                            track_id=3)
    with pytest.raises(ValueError, match='n_tracks'):
        runner.process_scans([], track_id=-1)
