"""Full-stack bag-to-trajectory pipeline: one command from a .bag of RAW
Velodyne packets to an ATE/RPE report and a saved occupancy map.

Counterpart of ``examples/bag_replay.py`` (the same flags, config and
printed lines), run on the card (``--cpu`` runs it on the CPU):

    bag (velodyne_msgs/VelodyneScan + /tf odometry)
      -> VelodyneBagStream (native packet decode + de-skewed revolution
         assembly)
      -> OnlineRunner (device-resident SLAM; optional scan-context
         place recognition)
      -> core.evaluation ATE/RPE vs ground truth
      -> occupancy grid export (npz/pcd/ply)

This is the reference's end-to-end validation flow
(velodyne_assembler/launch/test/test.launch:4-21 plays a recorded bag
into the assembler; the worker consumes the assembled clouds,
laser_slam_worker.cpp:96-253; laser_to_octomap.cpp:86-113 exports the
map afterwards), ROS-free.

Usage:
    # synthesize a demo bag (moving VLP-16 over a box world) + GT file
    python -m laser_slam_tpu_torch.examples.bag_replay --make-demo-bag demo.bag

    # replay it end to end
    python -m laser_slam_tpu_torch.examples.bag_replay demo.bag --cpu \
        --gt demo.bag.gt.tum --map demo_map.npz

    # or both in one go (files in the temporary directory)
    python -m laser_slam_tpu_torch.examples.bag_replay --demo --cpu
"""

import argparse
import os
import tempfile
import time

import numpy as np


def make_demo_bag(path: str, n_scans: int = 24, packets_per_rev: int = 15,
                  radius_m: float = 12.0, odom_noise: float = 0.008,
                  range_noise_m: float = 0.01, laps: int = 1,
                  seed: int = 3) -> str:
    """Synthesize a VLP-16 drive: raw packets from a MOVING sensor (the
    pose advances packet by packet, so the assembler's de-skew chain does
    real work) + noisy /tf odometry.  Ground truth (pose at each
    revolution end) is written to ``<path>.gt.tum``.  Returns the GT path.
    The same seed writes the same bytes as the JAX package's example.
    """
    from laser_slam_tpu_torch.core import csvio
    from laser_slam_tpu_torch.pipeline import velodyne_sim as vs
    from laser_slam_tpu_torch.pipeline.bag_writer import BagWriter

    rng = np.random.default_rng(seed)
    scene = vs.make_beam_scene(seed=seed, world_size_m=60.0)
    blocks_per_rev = packets_per_rev * 12
    period_ns = int(1e8)
    dt_pkt = period_ns // packets_per_rev

    def pose_at(s: float) -> np.ndarray:
        """Continuous circle trajectory, s in revolutions (floats ok)."""
        ang = 2 * np.pi * s * laps / n_scans
        yaw = ang + np.pi / 2
        q = np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)])
        t = np.array([6.0 + radius_m * np.cos(ang),
                      4.0 + radius_m * np.sin(ang), 1.5])
        return np.concatenate([q, t])

    gt_rows = []
    odom = pose_at(0.0)
    prev_gt = odom
    with BagWriter(path) as w:
        for k in range(n_scans * packets_per_rev):
            t_ns = 10_000_000_000 + k * dt_pkt
            gt = pose_at(k / packets_per_rev)
            # Integrated noisy odometry (what a wheel/IMU filter gives).
            rel = vs._np_compose(vs._np_inverse(prev_gt), gt)
            rel = vs._np_compose(rel, vs._np_se3_exp(
                rng.normal(size=6) * odom_noise / packets_per_rev))
            odom = vs._np_compose(odom, rel)
            prev_gt = gt
            w.write_tf(t_ns, 'odom', 'base_link', odom)
            pkts = vs.velodyne_packets_for_pose(
                scene, gt, n_blocks=12, blocks_per_rev=blocks_per_rev,
                az_start_deg=(k % packets_per_rev) * 12 * 360.0
                / blocks_per_rev,
                range_noise_m=range_noise_m, rng=rng)
            w.write_velodyne_scan('/velodyne_packets', t_ns, pkts)
            if k % packets_per_rev == packets_per_rev - 1:
                gt_rows.append((t_ns, gt.astype(np.float32)))
    gt_path = path + '.gt.tum'
    csvio.write_trajectory_tum(gt_rows, gt_path)
    print(f'wrote {path} ({n_scans} revolutions x {packets_per_rev} '
          f'packets) + {gt_path}')
    return gt_path


def estimator_config():
    """The example's configuration (``examples/bag_replay.py``)."""
    from laser_slam_tpu_torch.config import (EstimatorConfig, IcpConfig,
                                             InputFilterConfig,
                                             LaserTrackConfig, SolverConfig)
    return EstimatorConfig(
        laser_track=LaserTrackConfig(
            nscan_in_sub_map=3,
            odometry_noise_model=(0.02,) * 3 + (0.05,) * 3,
            icp_noise_model=(0.005,) * 6,
            input_filters=InputFilterConfig(scan_capacity=8192),
            icp=IcpConfig(matcher='brute', reading_capacity=4096,
                          reading_sampling_ratio=0.7)),
        loop_closure_noise_model=(0.005,) * 6,
        solver=SolverConfig(gn_iterations=3, pcg_iterations=40, window=64))


def replay(bag_path: str, gt_path=None, map_path=None,
           place_recognition=False, cpu=False):
    """Replay a raw-packet bag end to end; returns the trajectory
    {time_ns: pose7}."""
    import torch
    from laser_slam_tpu_torch.config import (AssemblerConfig,
                                             PlaceRecognitionConfig)
    from laser_slam_tpu_torch.core import evaluation as ev
    from laser_slam_tpu_torch.pipeline import occupancy, online
    from laser_slam_tpu_torch.pipeline.rosbag import VelodyneBagStream

    device = online.resolve_device('cpu' if cpu else 'cuda')
    print('device:', device, torch.cuda.get_device_name(device)
          if device.type == 'cuda' else '')
    pr_cfg = (PlaceRecognitionConfig(detect_every=1, exclude_recent_keys=10,
                                     distance_threshold=0.06)
              if place_recognition else None)
    runner = online.OnlineRunner(estimator_config(), pose_capacity=256,
                                 factor_capacity=1024,
                                 archive_points=2048 if pr_cfg else 0,
                                 place_recognition=pr_cfg, device=device)

    stream = VelodyneBagStream(bag_path, scan_topic='/velodyne_packets',
                               tf_child_frame='base_link',
                               assembler_config=AssemblerConfig())
    kept = []                             # (time_ns, points) for the map
    t0 = time.perf_counter()
    n = 0
    for f in stream:
        runner.process_scan(f.time_ns, f.points, f.odom_pose7)
        kept.append((f.time_ns, f.points))
        n += 1
    traj = runner.trajectory()
    wall = time.perf_counter() - t0
    print(f'{n} revolutions in {wall:.1f}s ({n / wall:.1f} scans/s, '
          f'warm-up included)')
    if runner.detector is not None:
        print(f'loop closures: {len(runner.detections)} accepted, '
              f'{len(runner.rejected_detections)} rejected')

    if gt_path:
        gt = ev.load_trajectory_tum(gt_path)
        a = ev.ate(traj, gt, align='origin')
        print(f'ATE  translation: {a.translation}')
        print(f'ATE  rotation(deg): {a.rotation_deg}')
        r = ev.rpe(traj, gt, delta=1, delta_unit='frames')
        print(f'RPE/frame translation: {r.translation}')

    if map_path:
        grid = occupancy.OccupancyGrid(resolution=0.2, max_range=40.0,
                                       device=device)
        for t_ns, pts in kept:
            if t_ns in traj:
                grid.insert_scan(pts, traj[t_ns])
        grid.save(map_path)
        print(f'occupancy map: {len(grid.occupied_points())} occupied '
              f'cells -> {map_path}')
    return traj


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('bag', nargs='?', help='input .bag path')
    p.add_argument('--make-demo-bag', metavar='PATH',
                   help='synthesize a demo bag at PATH and exit')
    p.add_argument('--demo', action='store_true',
                   help='synthesize a demo bag in the temporary directory '
                        'and replay it')
    p.add_argument('--cpu', action='store_true')
    p.add_argument('--gt', help='ground-truth TUM file for ATE/RPE')
    p.add_argument('--map', help='save the occupancy map here (npz/pcd/ply)')
    p.add_argument('--place-recognition', action='store_true',
                   help='attach the scan-context loop-closure detector')
    p.add_argument('--scans', type=int, default=24)
    args = p.parse_args(argv)

    if args.make_demo_bag:
        make_demo_bag(args.make_demo_bag, n_scans=args.scans)
        return None
    bag, gt = args.bag, args.gt
    tmp = tempfile.gettempdir()
    if args.demo:
        bag = os.path.join(tmp, 'laser_slam_demo.bag')
        gt = make_demo_bag(bag, n_scans=args.scans)
    if not bag:
        p.error('give a bag path, --demo, or --make-demo-bag PATH')
    return replay(bag, gt_path=gt,
                  map_path=args.map or os.path.join(tmp,
                                                    'laser_slam_map.npz'),
                  place_recognition=args.place_recognition, cpu=args.cpu)


if __name__ == '__main__':
    main()
