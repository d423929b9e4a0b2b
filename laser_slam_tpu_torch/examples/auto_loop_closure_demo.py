"""Fully autonomous SLAM demo: loop closures detected in-tree.

Usage:
    python -m laser_slam_tpu_torch.examples.auto_loop_closure_demo [--cpu] \
        [--scans 48] [--laps 2]

Counterpart of ``examples/auto_loop_closure_demo.py`` (the same configs,
stream and checks).  Where the synthetic demo builds its loop closure
from ground truth, this one runs the device-resident online path
(``OnlineRunner``) with the scan-context detector attached: revisits are
recognized, yaw-seeded, ICP-verified and refined, and injected into the
graph without ground truth.  The stream runs twice, with the detector
and without it, and the ATE of both is printed.  Checks: at least one
detection, each a lap apart (+-2 keys), and ATE max below 0.5 m with
the detector.  It runs on the card unless ``--cpu`` is given;
``--points`` shrinks the scans (for tests).

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
    p.add_argument('--scans', type=int, default=48)
    p.add_argument('--laps', type=int, default=2)
    p.add_argument('--points', type=int, default=8192,
                   help='points a scan (the reading keeps half)')
    return p.parse_args(argv)


def estimator_config(args):
    """The demo's configuration (``examples/auto_loop_closure_demo.py:
    38-47``): brute ICP."""
    from laser_slam_tpu_torch.config import (EstimatorConfig, IcpConfig,
                                             InputFilterConfig,
                                             LaserTrackConfig, SolverConfig)
    return EstimatorConfig(
        laser_track=LaserTrackConfig(
            nscan_in_sub_map=3,
            odometry_noise_model=(0.02,) * 3 + (0.05,) * 3,
            icp_noise_model=(0.005,) * 6,
            input_filters=InputFilterConfig(scan_capacity=args.points),
            icp=IcpConfig(matcher='brute', reading_capacity=args.points // 2,
                          reading_sampling_ratio=0.5)),
        loop_closure_noise_model=(0.005,) * 6,
        solver=SolverConfig(gn_iterations=3, pcg_iterations=40))


def place_recognition_config():
    """``examples/auto_loop_closure_demo.py:50-51``: 0.06 splits true
    revisits (~0.02) from the square room's rotational aliasing (~0.08)."""
    from laser_slam_tpu_torch.config import PlaceRecognitionConfig
    return PlaceRecognitionConfig(detect_every=1, exclude_recent_keys=12,
                                  distance_threshold=0.06)


def frames(args):
    """An off-centre loop (centre (8, 5); a circle centred on the square
    room is exactly 180-degree aliased), seed 3."""
    from laser_slam_tpu_torch.pipeline import replay
    return list(replay.SyntheticStream(
        n_scans=args.scans, points_per_scan=args.points, trajectory='circle',
        radius_m=12.0, center_m=(8.0, 5.0), laps=args.laps, noise_m=0.01,
        odom_noise=0.01, seed=3))


def run(cfg, fs, pr, device):
    """One runner over the frames; returns (runner, seconds, ATE)."""
    from laser_slam_tpu_torch.core import evaluation as ev
    from laser_slam_tpu_torch.pipeline import online
    runner = online.OnlineRunner(cfg, pose_capacity=128, factor_capacity=512,
                                 archive_points=1024, place_recognition=pr,
                                 device=device)
    t0 = time.perf_counter()
    for f in fs:
        runner.process_scan(f.time_ns, f.points, f.odom_pose7)
    if device.type == 'cuda':
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    gt = {f.time_ns: f.gt_pose7 for f in fs}
    # trajectory() flushes the pending detections first.
    return runner, dt, ev.ate(runner.trajectory(), gt, align='none')


def main(argv=None) -> dict:
    """Run the demo; returns {'runner', 'detections', 'ate_with',
    'ate_without', 'scans_per_s', 'wall_s'} (``scans_per_s`` of the run
    with the detector, warm-up included, synchronized on the card).
    Raises AssertionError when a check fails."""
    args = parse_args(argv)
    from laser_slam_tpu_torch.pipeline.online import resolve_device
    device = resolve_device('cpu' if args.cpu else 'cuda')
    name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'cpu')
    print(f'device: {device} ({name})')
    cfg = estimator_config(args)
    lap = args.scans // args.laps
    fs = frames(args)

    runner, dt, with_pr = run(cfg, fs, place_recognition_config(), device)
    print(f'{len(fs)} scans in {dt:.1f}s ({len(fs) / dt:.1f} scans/s '
          f'incl. warm-up)')
    print(f'detections ({len(runner.detections)}):')
    for key_a, key_b, dist, yaw in runner.detections:
        print(f'  key {key_b} recognized key {key_a} '
              f'(lap distance {key_b - key_a}, sc-dist {dist:.3f}, '
              f'yaw {np.degrees(yaw):.1f} deg)')
    _, _, without = run(cfg, fs, None, device)
    print(f'ATE without detector: mean {without.translation.mean * 100:.1f} '
          f'cm, max {without.translation.max * 100:.1f} cm')
    print(f'ATE with detector:    mean {with_pr.translation.mean * 100:.1f} '
          f'cm, max {with_pr.translation.max * 100:.1f} cm')

    if not runner.detections:
        raise AssertionError('no loop closures detected')
    for key_a, key_b, _, _ in runner.detections:
        if abs((key_b - key_a) - lap) > 2:
            raise AssertionError('detection paired wrong keys')
    if not with_pr.translation.max < 0.5:
        raise AssertionError('trajectory diverged')
    print('OK')
    return dict(runner=runner, detections=list(runner.detections),
                ate_with=with_pr, ate_without=without,
                scans_per_s=len(fs) / dt, wall_s=dt)


if __name__ == '__main__':
    main()
