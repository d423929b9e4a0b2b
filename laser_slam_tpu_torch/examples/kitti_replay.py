"""Replay a KITTI odometry sequence through the port's online SLAM path.

Usage:
    python -m laser_slam_tpu_torch.examples.kitti_replay --root /data/kitti \
        --sequence 05 --max-scans 500 --map-out /tmp/kitti05_map.ply

Counterpart of ``examples/kitti_replay.py`` (the same flags, config and
printed lines): reads velodyne .bin scans through ``replay.KittiStream``,
uses the sequence poses as odometry, runs the device-resident pipeline
on the card (``--cpu`` runs it on the CPU), reports ATE/RPE against the
sequence poses, and optionally exports the trajectory and the occupancy
map.  With ground-truth poses as odometry the ATE checks that ICP and
the solve do not spoil good odometry; it is no accuracy claim.

Scans above ``--scan-capacity`` keep their first points, as the JAX
runner keeps them; KITTI .bin files list points ring by ring, so the
default 32768 keeps the top rings of an HDL-64 scan.

:func:`main` takes the argument list and returns the trajectory and the
numbers it printed, so callers can drive it in process.
"""

import argparse
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--root', required=True, help='KITTI odometry root')
    p.add_argument('--sequence', default='05')
    p.add_argument('--max-scans', type=int, default=None)
    p.add_argument('--matcher', default='projective')
    p.add_argument('--window', type=int, default=64)
    p.add_argument('--scan-capacity', type=int, default=32768)
    p.add_argument('--reading-capacity', type=int, default=8192)
    p.add_argument('--reading-sampling', type=float, default=0.25)
    p.add_argument('--min-distance', type=float, default=2.5)
    p.add_argument('--cpu', action='store_true',
                   help='run on the CPU (tests/small fixtures)')
    p.add_argument('--place-recognition', action='store_true',
                   help='detect + inject loop closures in-tree '
                        '(scan-context, ICP-verified)')
    p.add_argument('--pr-threshold', type=float, default=0.2,
                   help='scan-context acceptance distance')
    p.add_argument('--pr-every', type=int, default=4,
                   help='query cadence in scans (D2H fetch per query)')
    p.add_argument('--pr-exclude', type=int, default=50,
                   help='temporal exclusion window in keys')
    p.add_argument('--map-out', default=None,
                   help='occupancy map output (.ply/.pcd/.xyz/.npz)')
    p.add_argument('--traj-out', default=None, help='trajectory CSV out')
    return p.parse_args(argv)


def estimator_config(args):
    """The example's configuration (``examples/kitti_replay.py``)."""
    from laser_slam_tpu_torch.config import (EstimatorConfig, IcpConfig,
                                             InputFilterConfig,
                                             LaserTrackConfig, SolverConfig)
    return EstimatorConfig(
        laser_track=LaserTrackConfig(
            nscan_in_sub_map=5,
            odometry_noise_model=(0.02,) * 3 + (0.05,) * 3,
            icp_noise_model=(0.005,) * 6,
            input_filters=InputFilterConfig(
                min_distance_m=args.min_distance, max_distance_m=70.0,
                scan_capacity=args.scan_capacity),
            icp=IcpConfig(matcher=args.matcher,
                          reading_capacity=args.reading_capacity,
                          reading_sampling_ratio=args.reading_sampling,
                          range_image_rows=64, range_image_cols=1024,
                          range_image_elev_min=-0.45,
                          range_image_elev_max=0.10)),
        solver=SolverConfig(gn_iterations=3, pcg_iterations=32,
                            window=args.window))


def main(argv=None) -> dict:
    """Run the example; returns {'traj', 'n', 'runner', 'ate', 'rpe',
    'scan_s', 'read_s', 'insert_s', 'occupied'} (per-scan host seconds,
    synchronized on the card; ``ate``/``rpe`` None without poses)."""
    args = parse_args(argv)
    from laser_slam_tpu_torch.core import benchmarker as bench
    from laser_slam_tpu_torch.pipeline import online, replay

    device = online.resolve_device('cpu' if args.cpu else 'cuda')

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize()

    cfg = estimator_config(args)
    stream = replay.KittiStream(args.root, args.sequence,
                                max_scans=args.max_scans)
    pr_cfg = None
    if args.place_recognition:
        from laser_slam_tpu_torch.config import PlaceRecognitionConfig
        pr_cfg = PlaceRecognitionConfig(
            detect_every=args.pr_every,
            distance_threshold=args.pr_threshold,
            exclude_recent_keys=args.pr_exclude, max_radius_m=80.0)
    runner = online.OnlineRunner(
        cfg, pose_capacity=1 << 13, factor_capacity=1 << 15,
        minimum_distance_to_add_pose=1.0,
        archive_points=1024 if pr_cfg else 0,
        place_recognition=pr_cfg, device=device)
    bench.enable()

    name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'cpu')
    print(f'device: {device} ({name}), scans: {len(stream)}')
    out = dict(runner=runner, scan_s=[], read_s=[], insert_s=[], ate=None,
               rpe=None, occupied=None)
    t0 = time.time()
    n = 0
    gts = {}
    frames = iter(stream)
    while True:
        t_read = time.perf_counter()
        frame = next(frames, None)
        if frame is None:
            break
        out['read_s'].append(time.perf_counter() - t_read)
        t_scan = time.perf_counter()
        added = runner.process_scan(frame.time_ns, frame.points,
                                    frame.odom_pose7)
        sync()
        out['scan_s'].append(time.perf_counter() - t_scan)
        if added:
            if frame.gt_pose7 is not None:
                gts[frame.time_ns] = frame.gt_pose7
            n += 1
            if n % 100 == 0:
                print(f'  {n} scans, {n / (time.time() - t0):.1f} scans/s')
    dt = time.time() - t0
    print(f'integrated {n} scans in {dt:.1f}s ({n / dt:.1f} scans/s '
          f'incl. warm-up)')
    if args.place_recognition:
        print(f'loop closures: {len(runner.detections)} accepted, '
              f'{len(runner.rejected_detections)} rejected by ICP gate')
        for key_a, key_b, dist, yaw in runner.detections:
            print(f'  key {key_b} -> key {key_a} (sc-dist {dist:.3f}, '
                  f'yaw {np.degrees(yaw):.1f} deg)')

    traj = runner.trajectory()
    if gts:
        from laser_slam_tpu_torch.core import evaluation as ev
        # align='none': KITTI ground truth and the runner share the first
        # pose as origin, and unaligned ATE is the honest SLAM error.
        res = ev.ate(traj, gts, align='none')
        out['ate'] = res
        print(f'ATE vs KITTI poses: mean {res.translation.mean:.3f} m, '
              f'max {res.translation.max:.3f} m over {res.translation.n} '
              f'poses (rmse {res.translation.rmse:.3f} m, rot mean '
              f'{res.rotation_deg.mean:.3f} deg)')
        try:
            rpe = ev.rpe(traj, gts, delta=10.0, delta_unit='m')
            out['rpe'] = rpe
            print(f'RPE per 10 m: {rpe.translation.mean * 100:.2f}% trans, '
                  f'{rpe.rotation_deg.mean:.3f} deg')
        except ValueError:
            pass  # trajectory shorter than the 10 m delta

    if args.traj_out:
        rows = np.asarray([[t, *traj[t][4:]] for t in sorted(traj)])
        np.savetxt(args.traj_out, rows, delimiter=',', fmt='%.9g')
        print('trajectory ->', args.traj_out)

    if args.map_out:
        from laser_slam_tpu_torch.pipeline import occupancy as occ
        grid = occ.OccupancyGrid(resolution=0.2, max_range=50.0,
                                 device=device)
        for frame in replay.KittiStream(args.root, args.sequence,
                                        max_scans=args.max_scans):
            if frame.time_ns in traj:
                t_ins = time.perf_counter()
                grid.insert_scan(frame.points[::4], traj[frame.time_ns])
                sync()
                out['insert_s'].append(time.perf_counter() - t_ins)
        grid.save(args.map_out)
        out['occupied'] = len(grid.occupied_points())
        print('map ->', args.map_out)
    out.update(traj=traj, n=n)
    return out


if __name__ == '__main__':
    main()
