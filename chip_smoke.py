#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (laser_slam_tpu_torch) once on one GPU.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each must pass, or the script exits non-zero and prints no
result line):

1. Device: the card's name, and its name and power limit as nvidia-smi
   reports them.
2. Build: compile the CUDA kernels of ``laser_slam_tpu_torch/csrc/nn.cu``
   with nvcc (seconds printed).
3. K1 (``nn_indices``) against its plain torch version at the main path's
   ICP shape (8192 queries x 81920 reference points), an awkward shape
   and a SENTINEL-parked reference: equal indices (a mismatch must be an
   exact f32 tie, checked in float64) and d2 within 1e-6 relative.
   Both times by CUDA events.
4. K2 (``nn_indices_pruned``) against its plain version and K1 within the
   3 m cutoff, on the synthetic room and on a clustered scene.
5. The slice: ``OnlineRunner(slice1_config(), device='cuda')`` over 64
   synthetic scans of 16384 points (2 laps of a 15 m circle, seed 7, the
   stream's default noise) with a loop closure every 10 scans of lap 2.
   K2 must have launched, the trajectory must be finite and within the
   ground-truth bounds of tests/test_parity.py (max < 0.35 m, final
   < 0.15 m).
6. K1 inside ICP: one ``icp_point_to_plane`` at the slice's shapes with
   ``pallas_prune=False`` (the flat-kernel matcher); K1 must have launched
   and the pose must agree with the K2 run within 1e-4.

The kernel counters are reset right before phase 5 (K2) and phase 6 (K1),
the two main-path runs, and read right after; launches made to compare a
kernel with its plain version are not counted.  The second-to-last line
is the kernels' JSON record; the last line is the result record.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

N_SCANS = 64
N_POINTS = 16384
READING = 8192
SUBMAP_SCANS = 5
CUTOFF = 3.0
D2_RTOL = 1e-6
POSE_ATOL = 1e-4


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds per call on the card (CUDA events, warmed up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_nn(name, q, ref, d2_k, idx_k, d2_p, idx_p, rows=None):
    """Kernel vs plain: idx equal except exact f32 ties (checked in float64
    against the plain winner), d2 within D2_RTOL.  Returns max |d2 diff|."""
    d2_k, idx_k = d2_k.cpu().numpy(), idx_k.cpu().numpy().astype(np.int64)
    d2_p, idx_p = d2_p.cpu().numpy(), idx_p.cpu().numpy().astype(np.int64)
    if rows is not None:
        d2_k, idx_k, d2_p, idx_p = d2_k[rows], idx_k[rows], d2_p[rows], \
            idx_p[rows]
    if not (np.all(np.isfinite(d2_k)) and np.all(np.isfinite(d2_p))):
        raise AssertionError(f'{name}: non-finite distances')
    err = np.abs(d2_k.astype(np.float64) - d2_p)
    bad = err > D2_RTOL * np.maximum(np.abs(d2_p), 1e-30)
    if bad.any():
        raise AssertionError(f'{name}: {int(bad.sum())} d2 beyond '
                             f'{D2_RTOL} relative, max abs {err.max()}')
    diff = np.flatnonzero(idx_k != idx_p)
    if diff.size:
        qn = q.cpu().numpy().astype(np.float64)
        rn = ref.cpu().numpy().astype(np.float64)
        qi = diff if rows is None else np.flatnonzero(rows)[diff]
        dk = ((qn[qi] - rn[idx_k[diff]]) ** 2).sum(1)
        dp = ((qn[qi] - rn[idx_p[diff]]) ** 2).sum(1)
        if not np.allclose(dk, dp, rtol=1e-6, atol=0.0):
            raise AssertionError(f'{name}: {diff.size} index mismatches '
                                 'that are not ties')
    log(f'  {name}: ok (d2 within {D2_RTOL} relative, max |d2 err| '
        f'{float(err.max()) if err.size else 0.0}; {diff.size} index '
        'choices differ, all exact ties)')
    return float(err.max()) if err.size else 0.0


def measured_closure(frames, traj, i, j, se3, torch):
    """World-frame alignment of scans i and j from their TRUE relative
    pose and the runner's live estimates (tests/test_parity.py)."""
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    rel = se3.compose(se3.inverse(t(frames[i].gt_pose7)),
                      t(frames[j].gt_pose7))
    T_a = t(traj[frames[i].time_ns])
    T_b = t(traj[frames[j].time_ns])
    return se3.compose(T_a, se3.compose(rel, se3.inverse(T_b))).numpy()


def main():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: chip_smoke.py runs on a GPU')
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from laser_slam_tpu_torch.config import slice1_config
    from laser_slam_tpu_torch.ops import cloud as pc
    from laser_slam_tpu_torch.ops import cuda_build, icp as icp_mod, se3
    from laser_slam_tpu_torch.ops import nn_kernels as nk
    from laser_slam_tpu_torch.pipeline import online, replay
    dev = torch.device('cuda')

    # 1. Device --------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f'device: {name} ({torch.cuda.device_count()} visible), torch '
        f'{torch.__version__}, CUDA {torch.version.cuda}')
    log(f'nvidia-smi: {smi}')

    # 2. Build ---------------------------------------------------------
    t0 = time.perf_counter()
    nk._kernels()
    log(f'build: nn.cu in {cuda_build.build_seconds["nn.cu"]:.2f} s nvcc, '
        f'{time.perf_counter() - t0:.2f} s with loading')

    # Scenes at the main path's shapes: a submap of 5 scans and a reading.
    t0 = time.perf_counter()
    stream = replay.SyntheticStream(
        n_scans=N_SCANS, points_per_scan=N_POINTS, trajectory='circle',
        radius_m=15.0, seed=7, laps=2)
    frames = list(stream)
    log(f'stream: {len(frames)} scans of {N_POINTS} points made in '
        f'{time.perf_counter() - t0:.1f} s')
    T = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    frame_inv = se3.inverse(T(frames[SUBMAP_SCANS - 1].gt_pose7))
    submap = torch.cat([se3.apply(se3.compose(frame_inv, T(f.gt_pose7)),
                                  T(f.points))
                        for f in frames[:SUBMAP_SCANS]]).to(dev)
    reading_np = frames[SUBMAP_SCANS].points[:READING]
    rel_guess = se3.compose(frame_inv, T(frames[SUBMAP_SCANS].gt_pose7))
    queries = se3.apply(rel_guess, T(reading_np)).to(dev).contiguous()
    kernels = {}

    # 3. K1 vs plain ---------------------------------------------------
    log('K1 nn_indices vs plain:')
    d2_k, idx_k = nk.nn_indices(queries, submap)
    d2_p, idx_p = nk.nn_indices_plain(queries, submap)
    torch.cuda.synchronize()
    err1 = check_nn(f'{READING} x {SUBMAP_SCANS * N_POINTS}', queries,
                    submap, d2_k, idx_k, d2_p, idx_p)
    g = torch.Generator(device='cpu').manual_seed(1)
    q_odd = (torch.randn(1000, 3, generator=g) * 5).to(dev)
    r_odd = (torch.randn(3001, 3, generator=g) * 5).to(dev)
    check_nn('1000 x 3001', q_odd, r_odd, *nk.nn_indices(q_odd, r_odd),
             *nk.nn_indices_plain(q_odd, r_odd))
    parked = r_odd.clone()
    parked[::3] = pc.SENTINEL
    d2_k, idx_k = nk.nn_indices(q_odd, parked)
    if bool(torch.any(idx_k % 3 == 0)):
        raise AssertionError('K1: a SENTINEL-parked row won')
    check_nn('parked reference', q_odd, parked, d2_k, idx_k,
             *nk.nn_indices_plain(q_odd, parked))
    k1_ms = cuda_ms(lambda: nk.nn_indices(queries, submap), 20)
    k1_plain_ms = cuda_ms(lambda: nk.nn_indices_plain(queries, submap), 5)
    log(f'  time at {READING} x {SUBMAP_SCANS * N_POINTS}: kernel '
        f'{k1_ms:.4f} ms, plain '
        f'{k1_plain_ms:.4f} ms')
    kernels['K1'] = dict(max_abs_err=err1, ms=k1_ms, plain_ms=k1_plain_ms)

    # 4. K2 vs plain and K1 --------------------------------------------
    log(f'K2 nn_indices_pruned vs plain and K1 (cutoff {CUTOFF} m):')
    rng = np.random.default_rng(3)
    clusters = rng.uniform(-40, 40, size=(16, 3))
    n_ref = SUBMAP_SCANS * N_POINTS
    c_ref = torch.tensor((clusters[:, None] + rng.normal(
        size=(16, n_ref // 16, 3))).reshape(-1, 3), dtype=torch.float32,
        device=dev)
    c_q = torch.tensor((clusters[:4, None] + rng.normal(
        size=(4, READING // 4, 3))).reshape(-1, 3), dtype=torch.float32,
        device=dev)
    err2 = 0.0
    for label, q, ref in (('room', queries, submap),
                          ('clusters', c_q, c_ref)):
        pref = nk.build_pruned_ref(ref)
        d2_k, idx_k = nk.nn_indices_pruned(q, pref, cutoff=CUTOFF)
        d2_p, idx_p = nk.nn_indices_pruned_plain(q, pref, cutoff=CUTOFF)
        d2_1, idx_1 = nk.nn_indices(q, ref)
        torch.cuda.synchronize()
        inside = (d2_p <= CUTOFF ** 2).cpu().numpy()
        if inside.sum() < 0.5 * inside.size:
            raise AssertionError(f'{label}: scene has too few matches')
        if bool(torch.any(d2_k[torch.from_numpy(~inside).to(dev)]
                          <= CUTOFF ** 2)):
            raise AssertionError(f'{label}: beyond-cutoff query reported '
                                 'within the cutoff')
        err2 = max(err2, check_nn(label, q, pref.points, d2_k, idx_k, d2_p,
                                  idx_p, rows=inside))
        orig = pref.perm.long()[idx_k.long()]
        check_nn(f'{label} vs K1', q, ref, d2_k, orig, d2_1, idx_1,
                 rows=inside)
    pref = nk.build_pruned_ref(submap)
    k2_ms = cuda_ms(lambda: nk.nn_indices_pruned(queries, pref, CUTOFF), 20)
    k2_plain_ms = cuda_ms(
        lambda: nk.nn_indices_pruned_plain(queries, pref, CUTOFF), 5)
    log(f'  time at {READING} x {SUBMAP_SCANS * N_POINTS} (room, with its '
        'tables): kernel '
        f'{k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms')
    kernels['K2'] = dict(max_abs_err=err2, ms=k2_ms, plain_ms=k2_plain_ms)

    # 5. The slice -----------------------------------------------------
    cfg = slice1_config(scan_capacity=N_POINTS, reading_capacity=READING)
    log(f'slice: OnlineRunner(slice1_config()) on cuda, {N_SCANS} scans')
    runner = online.OnlineRunner(cfg, pose_capacity=128,
                                 factor_capacity=512, device='cuda')
    half = N_SCANS // 2
    closure_at = {i: (i - half, i) for i in range(half + 10, N_SCANS, 10)}
    torch.cuda.synchronize()
    nk.nn_indices.launches = 0
    nk.nn_indices_pruned.launches = 0
    scan_s = []
    t_all = time.perf_counter()
    for idx, f in enumerate(frames):
        t0 = time.perf_counter()
        runner.process_scan(f.time_ns, f.points, f.odom_pose7)
        torch.cuda.synchronize()
        scan_s.append(time.perf_counter() - t0)
        if idx in closure_at:
            a, b = closure_at[idx]
            runner.add_loop_closure(a, b, measured_closure(
                frames, runner.trajectory(), a, b, se3, torch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    k2_launches = nk.nn_indices_pruned.launches
    k1_slice = nk.nn_indices.launches
    traj = runner.trajectory()
    est = np.stack([traj[f.time_ns] for f in frames])
    gt = np.stack([f.gt_pose7 for f in frames])
    if not np.all(np.isfinite(est)):
        raise AssertionError('slice: non-finite trajectory')
    ate = np.linalg.norm(est[:, 4:] - gt[:, 4:], axis=1)
    warm = scan_s[8:]
    log(f'  {len(traj)} poses, {len(closure_at)} closures, K2 launches '
        f'{k2_launches}, K1 launches {k1_slice}, wall {wall:.2f} s')
    log(f'  ATE vs ground truth: mean {ate.mean():.6f} m, max '
        f'{ate.max():.6f} m, final {ate[-1]:.6f} m')
    log(f'  scans/s after 8 warm-up scans: {len(warm) / sum(warm):.4f} '
        f'({1000 * np.mean(warm):.3f} ms/scan mean, '
        f'{1000 * np.max(warm):.3f} ms max)')
    if k2_launches <= 0:
        raise AssertionError('slice: K2 never launched')
    if not (ate.max() < 0.35 and ate[-1] < 0.15):
        raise AssertionError(f'slice: ATE out of bounds (max {ate.max()}, '
                             f'final {ate[-1]})')
    kernels['K2']['launches'] = k2_launches

    # 6. K1 inside ICP -------------------------------------------------
    log('K1 inside ICP (pallas_prune=False) vs the K2 matcher:')
    ref_parts, nrm_parts = [], []
    for f in frames[:SUBMAP_SCANS]:
        c = pc.make_cloud(f.points, capacity=N_POINTS, device=dev)
        pose = se3.compose(frame_inv, T(f.gt_pose7)).to(dev)
        ref_parts.append(pc.transform(pose, c))
        nrm_parts.append(se3.quat_rotate(pose[:4],
                                         pc.estimate_normals(c, knn=10)))
    reference = pc.Cloud(torch.cat([c.points for c in ref_parts]),
                         torch.cat([c.mask for c in ref_parts]))
    normals = torch.cat(nrm_parts)
    reading = pc.compact_decimate(
        pc.make_cloud(frames[SUBMAP_SCANS].points, capacity=N_POINTS,
                      device=dev), READING)
    guess = rel_guess.to(dev)
    icp_cfg = cfg.laser_track.icp
    flat_cfg = dataclasses.replace(icp_cfg, pallas_prune=False)
    torch.cuda.synchronize()
    nk.nn_indices.launches = 0
    nk.nn_indices_pruned.launches = 0
    res_flat = icp_mod.icp(reading, reference, normals, guess, flat_cfg)
    torch.cuda.synchronize()
    k1_launches = nk.nn_indices.launches
    res_pruned = icp_mod.icp(reading, reference, normals, guess, icp_cfg)
    dT = float(torch.max(torch.abs(res_flat.T - res_pruned.T)))
    log(f'  K1 launches {k1_launches}, valid {bool(res_flat.valid)}, '
        f'max |T_K1 - T_K2| {dT:.3e} (tolerance {POSE_ATOL})')
    if k1_launches <= 0:
        raise AssertionError('ICP: K1 never launched')
    if not (bool(res_flat.valid) and dT <= POSE_ATOL):
        raise AssertionError('ICP: flat and pruned matchers disagree')
    kernels['K1']['launches'] = k1_launches

    # 7. Records -------------------------------------------------------
    source = 'laser_slam_tpu_torch/csrc/nn.cu'
    record = {'kernels': [
        dict(name='K1 nn_indices', route='cuda', source=source,
             replaces='laser_slam_tpu/ops/pallas_nn.py:68',
             **kernels['K1']),
        dict(name='K2 nn_indices_pruned', route='cuda', source=source,
             replaces='laser_slam_tpu/ops/pallas_nn.py:262',
             **kernels['K2']),
    ]}
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)
