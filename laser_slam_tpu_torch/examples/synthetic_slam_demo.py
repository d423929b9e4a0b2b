"""End-to-end demo: synthetic LiDAR replay through the full SLAM stack.

Usage:
    python -m laser_slam_tpu_torch.examples.synthetic_slam_demo [--cpu] \
        [--scans 20] [--matcher projective|brute|pallas]

Counterpart of ``examples/synthetic_slam_demo.py`` (the same config,
stream and check): a circular trajectory with noisy odometry, scans
integrated through the host API (``LaserSlamWorker`` over an
``IncrementalEstimator``: ICP odometry and the incremental graph solve),
a loop closure at the revisit built from ground truth through
``process_loop_closure``, and the trajectory error against ground truth,
which must stay below 0.5 m.  It runs on the card unless ``--cpu`` is
given; ``--matcher pallas`` runs ICP through the hand-written pruned
exact 1-NN kernel (K2).  ``--points`` and ``--reading-sampling`` shrink
or fix the scans (for tests).

:func:`main` takes the argument list and returns the trajectory and the
numbers it printed, so callers can drive it in process.
"""

import argparse
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--cpu', action='store_true', help='run on the CPU')
    p.add_argument('--scans', type=int, default=20)
    p.add_argument('--matcher', default='projective',
                   choices=('projective', 'brute', 'pallas'))
    p.add_argument('--points', type=int, default=8192,
                   help='points a scan (the reading keeps half)')
    p.add_argument('--reading-sampling', type=float, default=0.5)
    return p.parse_args(argv)


def estimator_config(args):
    """The demo's configuration (``examples/synthetic_slam_demo.py:45-55``).
    Noise models reflect the simulated sensor: odometry drifts ~1 cm /
    1 mrad a step while ICP is good to ~mm, so ICP carries the tighter
    sigmas."""
    from laser_slam_tpu_torch.config import (EstimatorConfig, IcpConfig,
                                             InputFilterConfig,
                                             LaserTrackConfig, SolverConfig)
    return EstimatorConfig(
        laser_track=LaserTrackConfig(
            nscan_in_sub_map=3,
            odometry_noise_model=(0.02, 0.02, 0.02, 0.05, 0.05, 0.05),
            icp_noise_model=(0.005,) * 6,
            input_filters=InputFilterConfig(scan_capacity=args.points),
            icp=IcpConfig(matcher=args.matcher,
                          reading_capacity=args.points // 2,
                          reading_sampling_ratio=args.reading_sampling)),
        loop_closure_noise_model=(0.005,) * 6,
        solver=SolverConfig(gn_iterations=3, pcg_iterations=40))


def frames(args):
    """The demo's stream: one lap of a 12 m circle, seed 3."""
    from laser_slam_tpu_torch.pipeline import replay
    return list(replay.SyntheticStream(
        n_scans=args.scans, points_per_scan=args.points, trajectory='circle',
        radius_m=12.0, noise_m=0.01, odom_noise=0.01, seed=3))


def closure(worker, fs):
    """The revisit's loop closure from ground truth (place recognition
    would supply the world-frame alignment): the first and last scans."""
    from laser_slam_tpu_torch.core.types import RelativePose
    from laser_slam_tpu_torch.ops import se3
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    t_first, t_last = 0, worker.laser_track.get_max_time()
    T_w_a = t(worker.laser_track.evaluate(t_first))
    T_w_b = t(worker.laser_track.evaluate(t_last))
    true_rel = se3.compose(se3.inverse(t(fs[0].gt_pose7)),
                           t(fs[-1].gt_pose7))
    w_T_a_b = se3.compose(T_w_a, se3.compose(true_rel, se3.inverse(T_w_b)))
    return RelativePose(T_a_b=w_T_a_b.numpy(), time_a_ns=t_first,
                        time_b_ns=t_last, track_id_a=0, track_id_b=0)


def main(argv=None) -> dict:
    """Run the demo; returns {'traj', 'n', 'worker', 'estimator',
    'error_mean_m', 'error_max_m', 'scans_per_s', 'wall_s', 'statistics'}
    (``scans_per_s`` over the whole run, warm-up included, synchronized
    on the card; ``statistics`` the benchmarker's topics of this run,
    which starts by dropping the topics recorded before it).  Raises
    AssertionError when the trajectory diverged."""
    args = parse_args(argv)
    from laser_slam_tpu_torch.config import WorkerConfig
    from laser_slam_tpu_torch.core import benchmarker as bench
    from laser_slam_tpu_torch.core.estimator import IncrementalEstimator
    from laser_slam_tpu_torch.pipeline import replay
    from laser_slam_tpu_torch.pipeline.online import resolve_device
    from laser_slam_tpu_torch.pipeline.worker import LaserSlamWorker

    device = resolve_device('cpu' if args.cpu else 'cuda')
    name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'cpu')
    print(f'device: {device} ({name})')
    estimator = IncrementalEstimator(estimator_config(args), 1,
                                     device=device)
    worker = LaserSlamWorker(WorkerConfig(minimum_distance_to_add_pose=0.5),
                             estimator, 0)
    was_enabled = bench._instance.enabled
    bench.enable()
    bench.reset_topic()
    try:
        fs = frames(args)
        t0 = time.perf_counter()
        n = replay.run_worker_on_stream(worker, fs)
        if device.type == 'cuda':
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f'integrated {n} scans in {dt:.1f}s ({n / dt:.1f} scans/s '
              f'incl. warm-up)')
        estimator.process_loop_closure(closure(worker, fs))
        stats = bench.statistics()
    finally:
        if not was_enabled:
            bench.disable()

    traj = worker.get_trajectory()
    errs = [np.linalg.norm(p[4:] - f.gt_pose7[4:])
            for (_, p), f in zip(sorted(traj.items()), fs)]
    print(f'trajectory error vs ground truth: mean '
          f'{np.mean(errs) * 100:.1f} cm, max {np.max(errs) * 100:.1f} cm')
    print('benchmarker statistics:')
    for k, (mean, std, count) in stats.items():
        print(f'  {k}: {mean:.2f} ms (+-{std:.2f}) n={count}')
    if not np.max(errs) < 0.5:
        raise AssertionError('trajectory diverged')
    print('OK')
    return dict(traj=traj, n=n, worker=worker, estimator=estimator,
                error_mean_m=float(np.mean(errs)),
                error_max_m=float(np.max(errs)), scans_per_s=n / dt,
                wall_s=dt, statistics=stats)


if __name__ == '__main__':
    main()
