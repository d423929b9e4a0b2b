"""Rebuild an occupancy map from a SLAM checkpoint and save it.

The laser_to_octomap workflow (laser_slam_tools/src/laser_to_octomap.cpp:
7-115) decoupled from ROS: load a checkpoint (the port's
``core/checkpoint``, which also reads the JAX package's files), replay
every (scan, optimized pose) pair into the occupancy grid on the card
(``--cpu`` builds it on the CPU), and save as .npz / .xyz / .pcd / .ply
(octomap_to_point_cloud equivalent).  Counterpart of
``tools/laser_to_map.py``.

Usage:
    python -m laser_slam_tpu_torch.tools.laser_to_map state.npz out.ply \
        [resolution 0.075] [probability_hit 0.9] [probability_miss 0.4] \
        [sensor_max_range 20.0] [--cpu]

Argument style mirrors the reference tool (key value pairs,
laser_to_octomap.cpp:25-42).
"""

import sys


def main(argv):
    argv = list(argv)
    device = 'cpu' if '--cpu' in argv else 'cuda'
    argv = [a for a in argv if a != '--cpu']
    if len(argv) < 3:
        print(__doc__)
        return 1
    ckpt_path, out_path = argv[1], argv[2]

    # Defaults mirror laser_to_octomap.cpp:18-22.
    opts = {'resolution': 0.075, 'probability_hit': 0.9,
            'probability_miss': 0.4, 'sensor_max_range': 20.0}
    args = argv[3:]
    if len(args) % 2:
        print('Invalid number of command line arguments')
        return 1
    for key, value in zip(args[::2], args[1::2]):
        if key not in opts:
            print(f'Invalid command line argument "{key}"')
            return 1
        opts[key] = float(value)

    from laser_slam_tpu_torch.config import Config
    from laser_slam_tpu_torch.core import checkpoint as ckpt
    from laser_slam_tpu_torch.pipeline import occupancy as occ

    estimator, workers = ckpt.load_checkpoint(ckpt_path, Config(),
                                              device=device)
    data = []
    for track in estimator.get_all_laser_tracks():
        traj = track.get_trajectory()
        for scan in track.scans:
            pts = scan.cloud.points[scan.cloud.mask].cpu().numpy()
            data.append((scan.time_ns, pts, traj[scan.time_ns]))
    data.sort(key=lambda x: x[0])
    print(f'Rebuilding map from {len(data)} scans...')
    grid = occ.build_occupancy_from_track_data(
        data, resolution=opts['resolution'],
        prob_hit=opts['probability_hit'],
        prob_miss=opts['probability_miss'],
        max_range=opts['sensor_max_range'], device=device)
    grid.save(out_path)
    print(f'Saved map ({len(grid.occupied_points())} occupied cells) '
          f'to {out_path}')
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
