"""Evaluate an estimated trajectory against ground truth (ATE + RPE).

Usage:
    python -m laser_slam_tpu_torch.tools.evaluate_trajectory EST REF
        [--format tum|kitti|csv] [--align se3|sim3|origin|none]
        [--rpe-delta 1] [--rpe-unit frames|m] [--max-dt-ms 20]

EST/REF file formats:
    tum    t tx ty tz qx qy qz qw        (seconds; evo-compatible)
    kitti  12 floats, row-major 3x4 [R|t] (no timestamps: row index used)
    csv    time_ns,tx,ty,tz               (position-only: rotation ATE
                                           reported as NaN)

Counterpart of ``tools/evaluate_trajectory.py`` on the port's
``core/evaluation``; the reference has no evaluation tooling, and this
is the in-tree equivalent of the external evo/kitti-devkit step.
"""
import argparse
import sys

import numpy as np

from laser_slam_tpu_torch.core import evaluation as ev


def load(path: str, fmt: str):
    if fmt == 'tum':
        return ev.load_trajectory_tum(path)
    if fmt == 'kitti':
        return ev.load_trajectory_kitti(path)
    if fmt == 'csv':
        data = np.atleast_2d(np.loadtxt(path, delimiter=',',
                                        dtype=np.float64))
        times = data[:, 0].astype(np.int64)
        poses = np.zeros((data.shape[0], 7))
        poses[:, 0] = 1.0
        poses[:, 4:] = data[:, 1:4]
        return times, poses
    raise SystemExit(f'unknown format {fmt!r}')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('estimate')
    ap.add_argument('reference')
    ap.add_argument('--format', default='tum',
                    choices=('tum', 'kitti', 'csv'))
    ap.add_argument('--align', default='se3',
                    choices=('se3', 'sim3', 'origin', 'none'))
    ap.add_argument('--rpe-delta', type=float, default=1.0)
    ap.add_argument('--rpe-unit', default='frames', choices=('frames', 'm'))
    ap.add_argument('--max-dt-ms', type=float, default=20.0)
    args = ap.parse_args(argv)

    est = load(args.estimate, args.format)
    ref = load(args.reference, args.format)
    max_dt = int(args.max_dt_ms * 1e6)

    a = ev.ate(est, ref, align=args.align, max_dt_ns=max_dt)
    print(f'ATE translation [m]  : {a.translation}')
    print(f'ATE rotation    [deg]: {a.rotation_deg}')
    r = ev.rpe(est, ref, delta=args.rpe_delta, delta_unit=args.rpe_unit,
               max_dt_ns=max_dt)
    unit = 'm/m' if args.rpe_unit == 'm' else 'm'
    print(f'RPE translation [{unit}]: {r.translation} '
          f'(delta {r.delta:g} {r.delta_unit})')
    print(f'RPE rotation    [deg]: {r.rotation_deg}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
