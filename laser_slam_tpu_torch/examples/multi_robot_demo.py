"""Multi-robot demo: two robots, one graph, on the device-resident path.

Usage:
    python -m laser_slam_tpu_torch.examples.multi_robot_demo [--cpu] \
        [--scans 12]

Counterpart of ``examples/multi_robot_demo.py`` (the same config, stream
and check).  Two robots map the same world from different starting
points.  Each gets a forced prior 100 m apart (the reference's
multi-robot bootstrap, laser_track.cpp:166-170), their scans interleave
into one ``OnlineRunner(n_tracks=2)``, and a cross-track loop closure at
the shared place links the tracks: robot 1's prior is removed and its
whole trajectory pulled into robot 0's frame (estimateAndRemove,
incremental_estimator.cpp:165-266).  One strong ``refine`` converges the
linked map, whose error against ground truth in robot 0's frame aligned
to it must stay below 0.10 m.  It runs on the card unless ``--cpu`` is
given; ``--points`` and ``--reading-sampling`` shrink or fix the scans
(for tests).

:func:`main` takes the argument list and returns the runner and the
numbers it printed, so callers can drive it in process.
"""

import argparse
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--cpu', action='store_true', help='run on the CPU')
    p.add_argument('--scans', type=int, default=12)
    p.add_argument('--points', type=int, default=8192,
                   help='points a scan (the reading keeps half)')
    p.add_argument('--reading-sampling', type=float, default=0.5)
    return p.parse_args(argv)


def estimator_config(args):
    """The demo's configuration (``examples/multi_robot_demo.py:41-49``):
    forced priors, projective ICP."""
    from laser_slam_tpu_torch.config import (EstimatorConfig, IcpConfig,
                                             InputFilterConfig,
                                             LaserTrackConfig, SolverConfig)
    return EstimatorConfig(
        laser_track=LaserTrackConfig(
            nscan_in_sub_map=3, force_priors=True,
            odometry_noise_model=(0.02,) * 3 + (0.05,) * 3,
            icp_noise_model=(0.005,) * 6,
            input_filters=InputFilterConfig(scan_capacity=args.points),
            icp=IcpConfig(matcher='projective',
                          reading_capacity=args.points // 2,
                          reading_sampling_ratio=args.reading_sampling)),
        solver=SolverConfig(gn_iterations=3, pcg_iterations=48))


def robot_frames(args):
    """Both robots traverse the same world (two laps of a 12 m circle,
    seed 42): robot 1 runs the loop from the opposite phase, so the two
    meet at lap 2's first scan."""
    from laser_slam_tpu_torch.pipeline import replay
    n = args.scans
    world = list(replay.SyntheticStream(
        n_scans=2 * n, points_per_scan=args.points, world_points=65536,
        trajectory='circle', radius_m=12.0, noise_m=0.005, odom_noise=0.004,
        seed=42, laps=2))
    return [world[:n], world[n:2 * n]]


def link(runner, robots):
    """The cross-track closure at the shared place: robot 1's first scan
    revisits robot 0's first.  Place recognition would report the world
    alignment from the current estimates and the true relative pose.
    Returns each track's keys."""
    from laser_slam_tpu_torch.ops import se3
    from laser_slam_tpu_torch.pipeline import online
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    keys = [[i for i, (tid, _) in enumerate(runner.key_info) if tid == k]
            for k in (0, 1)]
    key_a, key_b = keys[0][0], keys[1][0]
    rel = se3.compose(se3.inverse(t(robots[0][0].gt_pose7)),
                      t(robots[1][0].gt_pose7))
    poses = online.extract_trajectory(runner.state)
    w_T_a_b = se3.compose(t(poses[key_a]),
                          se3.compose(rel, se3.inverse(t(poses[key_b]))))
    runner.add_loop_closure(key_a, key_b, w_T_a_b.numpy())
    return keys


def combined_errors(runner, robots, keys):
    """Each scan's position error in the shared frame (robot 0's gauge,
    its forced prior pinning key 0 at identity) aligned to ground truth
    by robot 0's first pose."""
    from laser_slam_tpu_torch.ops import se3
    from laser_slam_tpu_torch.pipeline import online
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    poses = online.extract_trajectory(runner.state)
    T_align = se3.compose(t(robots[0][0].gt_pose7),
                          se3.inverse(t(poses[keys[0][0]])))
    errs = [np.linalg.norm(se3.compose(T_align, t(poses[k])).numpy()[4:]
                           - f.gt_pose7[4:])
            for robot, ks in zip(robots, keys) for f, k in zip(robot, ks)]
    return np.asarray(errs)


def main(argv=None) -> dict:
    """Run the demo; returns {'runner', 'keys', 'errors', 'error_mean_m',
    'error_max_m', 'scans_per_s', 'integrate_s', 'refine_s'} (scans/s of
    both robots' scans, warm-up included, synchronized on the card).
    Raises AssertionError when the linked map did not converge."""
    args = parse_args(argv)
    from laser_slam_tpu_torch.pipeline import online
    device = online.resolve_device('cpu' if args.cpu else 'cuda')
    name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'cpu')
    print(f'device: {device} ({name})')

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize()

    runner = online.OnlineRunner(estimator_config(args), pose_capacity=128,
                                 factor_capacity=512, n_tracks=2,
                                 device=device)
    robots = robot_frames(args)
    n = args.scans
    t0 = time.perf_counter()
    for i in range(n):
        for tid in (0, 1):
            f = robots[tid][i]
            runner.process_scan(f.time_ns + tid, f.points, f.odom_pose7,
                                track_id=tid)
    sync()
    integrate_s = time.perf_counter() - t0
    print(f'integrated 2 x {n} scans in {integrate_s:.1f}s')
    p1_before = list(runner.trajectory(1).values())[0]
    print(f'robot 1 frame offset before linking: y = {p1_before[5]:.1f} m')

    keys = link(runner, robots)
    print('cross-track closure added: groups =', runner._linked_groups,
          '| remaining priors =', runner._prior_slot_of_track)
    # The 100 m linking jump exceeds the per-scan solver budget (3 GN x
    # 48 PCG leaves metre-level chain rotation); one strong polish solve
    # converges the linked map.
    t0 = time.perf_counter()
    runner.refine(1, gn_iterations=6, pcg_iterations=256,
                  pcg_tolerance=1e-10)
    sync()
    refine_s = time.perf_counter() - t0

    errs = combined_errors(runner, robots, keys)
    print(f'combined-map error vs ground truth: mean {errs.mean() * 100:.1f} '
          f'cm, max {errs.max() * 100:.1f} cm')
    if not errs.max() < 0.10:
        raise AssertionError('multi-robot map did not converge')
    print('OK')
    return dict(runner=runner, keys=keys, errors=errs,
                error_mean_m=float(errs.mean()),
                error_max_m=float(errs.max()),
                scans_per_s=2 * n / integrate_s, integrate_s=integrate_s,
                refine_s=refine_s)


if __name__ == '__main__':
    main()
