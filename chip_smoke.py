#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (laser_slam_tpu_torch) once on one GPU.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each must pass, or the script exits non-zero and prints no
result line):

1. Device: the card's name, and its name and power limit as nvidia-smi
   reports them.
2. Build: compile ``laser_slam_tpu_torch/csrc/nn.cu`` and
   ``csrc/nn_variants.cu`` with nvcc, one process each, started together
   (seconds printed).
3. K1 (``nn_indices``) against its plain torch version at the main path's
   ICP shape (8192 queries x 81920 reference points), with exact copies
   of 64 reference points in another reference tile, at an awkward shape
   (1000 x 3001) and on a SENTINEL-parked reference: d2 bit-equal and
   indices equal (ties to the lowest index, the copies included).  Both
   times by CUDA events.
4. K2 (``nn_indices_pruned``) against its plain version and K1 within the
   3 m cutoff, on the synthetic room and on a clustered scene: d2
   bit-equal, an index that differs only at an exact f32 tie, and d2 >
   cutoff^2 beyond it.  Timed with its torch tables, and alone
   (``nn_kernels._launch_pruned`` on tables built once); the share of
   pairs it scans, counted by the kernel, beside the share of the
   Pallas walk that its bound counts.
5. The slice: ``OnlineRunner(slice1_config(), device='cuda')`` over 64
   synthetic scans of 16384 points (2 laps of a 15 m circle, seed 7, the
   stream's default noise) with a loop closure every 10 scans of lap 2.
   K2 must have launched, the trajectory must be finite and within the
   ground-truth bounds of tests/test_parity.py (max < 0.35 m, final
   < 0.15 m).  ``torch.profiler`` records scans 12-15: kernel launches,
   device time, the device's busy share and K2's share of its time.
6. K1 inside ICP: one ``icp_point_to_plane`` at the slice's shapes with
   ``pallas_prune=False`` (the flat-kernel matcher); K1 must have launched
   and the pose must agree with the K2 run within 1e-4.  ICP ms a call
   (one a scan) with either matcher, host clock around synchronized
   calls.
7. The shootout's kernels (E1-E6, ``ops/nn_variants.py``): each held to
   its plain version at the shootout's shape (8192 x 65536, seed 3), on
   the same scene with 64 reference points copied inside their tile
   (tied rows whose payloads are averaged), and at an awkward shape
   (1000 x 3001, every third reference row at the SENTINEL) by the
   float64 checks of ``laser_slam_tpu_torch/ops/nn_variants.py`` (a d2
   planted a tenth too large must fail them); then the shootout itself
   (``experiments/nn_shootout.run``), timed by CUDA events beside the
   library calls, where each new kernel must have launched.

The kernel counters are reset right before phase 5 (K2), phase 6 (K1)
and the shootout run of phase 7, the main-path runs, and read right
after; launches made to compare a kernel with its plain version are not
counted.  Each kernel's bound is the larger of its bytes (inputs read
once, outputs written once) over 3.35 TB/s and its operations over the
card's rate for their type: f32 lane instructions over SMs x 128 lanes x
the card's max SM clock (67 TFLOP/s counts an FMA as 2), bf16 tensor-core
FLOPs over 989 TFLOP/s.  The pruned kernels count the pairs of the tiles
scanned in this run: E6 counts its own; K2's bound counts those of the
Pallas walk, replayed in plain torch (``nn_kernels.pruned_visits``),
since the tiles K2 itself scans depend on block timing (its own share,
counted by the kernel, stands beside it as ``scanned_share``).  The
second-to-last line is the kernels' JSON record; the last line is the
result record.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

N_SCANS = 64
N_POINTS = 16384
READING = 8192
SUBMAP_SCANS = 5
CUTOFF = 3.0
POSE_ATOL = 1e-4
PROFILE_SCANS = range(12, 16)
SHOOT_Q, SHOOT_R = 8192, 65536
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
# f32 lane instructions per (query, reference) pair: the arithmetic, the
# compare, and the selects that keep the running minimum (value and index,
# or the tile minimum alone for the payload kernels, whose rare payload
# updates are not counted).
INSTR_EXACT = 11        # 3 sub, 3 mul, 2 add, compare, 2 selects (K1, K2)
INSTR_MM = 6            # 3 FMA, compare, 2 selects (E5)
INSTR_ARGMIN = 3        # compare, 2 selects (E1 bf16, product on tensor cores)
INSTR_PAYLOAD = 5       # 3 FMA, compare, 1 select (E4, E6)


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


def pair_d2(q, ref, idx):
    """f32 d2 of each query to ref[idx], rounded as neighbors.sqdist."""
    d = q - ref[idx.long()]
    return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]


def host_ms(fn, reps):
    """Mean host milliseconds to issue one call (no synchronize between
    calls): a call whose card time is no more than this is host-bound."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * issued / reps


def check_nn(name, q, ref, d2_k, idx_k, d2_p, idx_p, rows=None,
             ties=False):
    """Kernel vs plain: d2 bit-equal; indices equal or, with ``ties``,
    differing only where the kernel's index is at the same f32 d2 (an
    exact tie).  ``rows``: a bool mask of the queries to compare.  Returns
    max |d2 diff|."""
    if rows is not None:
        q, d2_k, idx_k, d2_p, idx_p = (a[rows] for a in (q, d2_k, idx_k,
                                                          d2_p, idx_p))
    if not (bool(torch.all(torch.isfinite(d2_k)))
            and bool(torch.all(torch.isfinite(d2_p)))):
        raise AssertionError(f'{name}: non-finite distances')
    err = float(torch.max(torch.abs(d2_k.double() - d2_p.double()))) \
        if d2_k.numel() else 0.0
    if not torch.equal(d2_k, d2_p):
        raise AssertionError(f'{name}: {int(torch.sum(d2_k != d2_p))} d2 '
                             f'not bit-equal, max abs {err}')
    diff = idx_k != idx_p
    n_diff = int(torch.sum(diff))
    if n_diff and not ties:
        raise AssertionError(f'{name}: {n_diff} indices differ')
    if n_diff and not torch.equal(pair_d2(q[diff], ref, idx_k[diff]),
                                  d2_k[diff]):
        raise AssertionError(f'{name}: {n_diff} index mismatches that are '
                             'not exact ties')
    log(f'  {name}: ok (d2 bit-equal; {n_diff} index choices differ'
        + (', all exact f32 ties)' if ties else ')'))
    return err


def measured_closure(frames, traj, i, j, se3, torch):
    """World-frame alignment of scans i and j from their TRUE relative
    pose and the runner's live estimates (tests/test_parity.py)."""
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    rel = se3.compose(se3.inverse(t(frames[i].gt_pose7)),
                      t(frames[j].gt_pose7))
    T_a = t(traj[frames[i].time_ns])
    T_b = t(traj[frames[j].time_ns])
    return se3.compose(T_a, se3.compose(rel, se3.inverse(T_b))).numpy()


def device_rows(prof):
    """The profiler's averages of work that ran on the card."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def device_launches(prof):
    return sum(e.count for e in device_rows(prof))


def profile_summary(prof, wall_s):
    """Kernel launches, device time, busy share and the NN kernels' share
    of the device time in a profiled window of ``wall_s`` seconds."""
    rows = device_rows(prof)
    t = {e.key: getattr(e, 'self_device_time_total',
                        getattr(e, 'self_cuda_time_total', 0)) / 1e3
         for e in rows}
    total = sum(t.values())
    if total <= 0:
        log('  profiler: no device time recorded (not measured)')
        return
    launches = device_launches(prof)
    k2 = sum(v for k, v in t.items() if 'nn_items_kernel<true' in k)
    unpack = sum(v for k, v in t.items() if 'nn_unpack_kernel' in k)
    n = len(PROFILE_SCANS)
    log(f'  profiler over scans {PROFILE_SCANS.start}-'
        f'{PROFILE_SCANS.stop - 1}: {launches} device launches '
        f'({launches / n:.0f} a scan), {total:.3f} ms of device time in '
        f'{1000 * wall_s:.3f} ms of wall time (profiler on): busy '
        f'{100 * total / (1000 * wall_s):.2f}%; K2 items '
        f'{100 * k2 / total:.2f}% of device time ({k2 / n:.3f} ms a scan), '
        f'with its unpack {100 * (k2 + unpack) / total:.2f}%')
    for key, v in sorted(t.items(), key=lambda kv: -kv[1])[:5]:
        log(f'    {v:9.3f} ms  {key[:90]}')


def main():
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: chip_smoke.py runs on a GPU')
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from laser_slam_tpu_torch.config import slice1_config
    from laser_slam_tpu_torch.ops import cloud as pc
    from laser_slam_tpu_torch.ops import cuda_build, icp as icp_mod, se3
    from laser_slam_tpu_torch.experiments import nn_shootout as sh
    from laser_slam_tpu_torch.ops import nn_kernels as nk
    from laser_slam_tpu_torch.ops import nn_variants as nv
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
    sm_clock = float(subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm',
         '--format=csv,noheader,nounits'], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0]) * 1e6
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    f32_issue = n_sm * 128 * sm_clock
    log(f'f32 issue rate: {n_sm} SMs x 128 lanes x {sm_clock / 1e9:.3f} '
        f'GHz = {f32_issue / 1e12:.2f} T instructions/s')

    def bound(pairs, instr, nbytes, tensor_flops=0.0):
        """(bound_ms, bound_by): the larger of bytes over HBM and
        operations over their unit's peak."""
        t_ops = max(pairs * instr / f32_issue,
                    tensor_flops / BF16_TENSOR_FLOPS)
        t_bytes = nbytes / HBM_BYTES_PER_S
        return (1e3 * max(t_ops, t_bytes),
                'operations' if t_ops >= t_bytes else 'bytes')

    def nn_bytes(nq, nr, payload=0):
        return 4 * (3 * nq + 3 * nr + 2 * nq + payload * (nr + nq))

    # 2. Build ---------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.build(['nn.cu', 'nn_variants.cu'])
    nk._kernels()
    nv._kernels()
    log(f'build: nn.cu {cuda_build.build_seconds["nn.cu"]:.2f} s, '
        f'nn_variants.cu {cuda_build.build_seconds["nn_variants.cu"]:.2f} '
        f's of nvcc in parallel, {time.perf_counter() - t0:.2f} s with '
        'loading')

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
    # Exact copies of 64 points in reference tile 12 (another work item),
    # queried at the points themselves (d2 = 0 at both copies): the first
    # copy must win, whichever item merges first.
    copies = submap.clone()
    copies[50000:50064] = copies[100:164]
    c_queries = queries.clone()
    c_queries[:64] = copies[100:164]
    d2_k, idx_k = nk.nn_indices(c_queries, copies)
    check_nn('copies across reference tiles', c_queries, copies, d2_k,
             idx_k, *nk.nn_indices_plain(c_queries, copies))
    if not torch.equal(idx_k[:64].cpu(),
                       torch.arange(100, 164, dtype=torch.int32)):
        raise AssertionError('K1: a later copy won')
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
    n_sub = SUBMAP_SCANS * N_POINTS
    lib_exact = sh.EXACT_LIBRARY_CALL
    k1_lib_ms = cuda_ms(lambda: sh.exact_library_call(queries, submap), 2)
    log(f'  library call ({lib_exact}): {k1_lib_ms:.4f} ms')
    k1_bound = bound(READING * n_sub, INSTR_EXACT, nn_bytes(READING, n_sub))
    kernels['K1'] = dict(max_abs_err=err1, ms=k1_ms, plain_ms=k1_plain_ms,
                         bound_ms=k1_bound[0], bound_by=k1_bound[1],
                         library_ms=k1_lib_ms, library=lib_exact)

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
        rows = torch.from_numpy(inside).to(dev)
        err2 = max(err2, check_nn(label, q, pref.points, d2_k, idx_k, d2_p,
                                  idx_p, rows=rows, ties=True))
        orig = pref.perm[idx_k.long()]
        check_nn(f'{label} vs K1', q, ref, d2_k, orig, d2_1, idx_1,
                 rows=rows, ties=True)
    pref = nk.build_pruned_ref(submap)
    k2_ms = cuda_ms(lambda: nk.nn_indices_pruned(queries, pref, CUTOFF), 20)
    k2_plain_ms = cuda_ms(
        lambda: nk.nn_indices_pruned_plain(queries, pref, CUTOFF), 5)
    tables = nk.pruned_tables(queries, pref, CUTOFF)
    k2_kernel_ms = cuda_ms(lambda: nk._launch_pruned(tables, pref, CUTOFF),
                           20)
    k2_host = host_ms(lambda: nk.nn_indices_pruned(queries, pref, CUTOFF),
                      20)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as one:
        nk.nn_indices_pruned(queries, pref, CUTOFF)
        torch.cuda.synchronize()
    log(f'  time at {READING} x {SUBMAP_SCANS * N_POINTS} (room): with its '
        f'tables {k2_ms:.4f} ms ({device_launches(one)} device launches a '
        f'call, which the host issues in {k2_host:.4f} ms), kernel alone '
        f'(tables built once) {k2_kernel_ms:.4f} ms, plain '
        f'{k2_plain_ms:.4f} ms')
    # K2's work depends on the data: its bound counts the pairs of the
    # tiles the Pallas walk scans (replayed in torch), and the walk must
    # reach the kernel's distances.  The kernel itself scans the tiles
    # that the bests merged so far do not prune, which varies with block
    # timing: it counts them.
    qb, rb = tables[4], tables[5]
    shares = []
    for _ in range(5):
        scanned = torch.zeros(READING // qb, dtype=torch.int32, device=dev)
        nk._launch_pruned(tables, pref, CUTOFF, scanned=scanned)
        shares.append(int(scanned.sum()) * qb / (READING * n_sub))
    visits, walk_d2 = nk.pruned_visits(queries, pref, CUTOFF)
    room_d2 = nk.nn_indices_pruned(queries, pref, CUTOFF)[0]
    inside = room_d2 <= CUTOFF ** 2
    if not torch.equal(walk_d2[inside], room_d2[inside]):
        raise AssertionError('K2: the replayed walk misses the kernel\'s '
                             'distances')
    k2_pairs = int(visits.sum()) * qb * rb
    walk_share = k2_pairs / (READING * n_sub)
    k2_bound = bound(k2_pairs, INSTR_EXACT, nn_bytes(READING, n_sub))
    log(f'  the Pallas walk scans {int(visits.sum())} of {visits.numel()} x '
        f'{pref.tile_lo.shape[0]} tile pairs: {walk_share:.4f} of all pairs '
        '(the bound counts these)')
    log(f'  K2 scanned (counted by the kernel, 5 calls): '
        f'{", ".join(f"{x:.4f}" for x in shares)} of all pairs')
    kernels['K2'] = dict(max_abs_err=err2, ms=k2_ms, kernel_ms=k2_kernel_ms,
                         scanned_share=float(np.mean(shares)),
                         walk_share=walk_share, plain_ms=k2_plain_ms,
                         bound_ms=k2_bound[0], bound_by=k2_bound[1],
                         library_ms=k1_lib_ms,
                         library=lib_exact + ' (the cutoff is a where)')

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
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    t_all = time.perf_counter()
    for idx, f in enumerate(frames):
        if idx == PROFILE_SCANS.start:
            prof.__enter__()
        t0 = time.perf_counter()
        runner.process_scan(f.time_ns, f.points, f.odom_pose7)
        torch.cuda.synchronize()
        scan_s.append(time.perf_counter() - t0)
        if idx == PROFILE_SCANS.stop - 1:
            prof.__exit__(None, None, None)
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
    warm = [t for k, t in enumerate(scan_s) if k >= 8
            and k not in PROFILE_SCANS]
    log(f'  {len(traj)} poses, {len(closure_at)} closures, K2 launches '
        f'{k2_launches}, K1 launches {k1_slice}, wall {wall:.2f} s')
    log(f'  ATE vs ground truth: mean {ate.mean():.6f} m, max '
        f'{ate.max():.6f} m, final {ate[-1]:.6f} m')
    log(f'  scans/s after 8 warm-up scans (the profiled ones left out): '
        f'{len(warm) / sum(warm):.4f} ({1000 * np.mean(warm):.3f} ms/scan '
        f'mean, {1000 * np.max(warm):.3f} ms max)')
    profile_summary(prof, sum(scan_s[k] for k in PROFILE_SCANS))
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
    for label, c in (('K2 matcher', icp_cfg), ('K1 matcher', flat_cfg)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            icp_mod.icp(reading, reference, normals, guess, c)
        torch.cuda.synchronize()
        log(f'  ICP at the slice\'s shapes, {label}: '
            f'{1000 * (time.perf_counter() - t0) / 3:.3f} ms a call')
    log(f'  K1 launches {k1_launches}, valid {bool(res_flat.valid)}, '
        f'max |T_K1 - T_K2| {dT:.3e} (tolerance {POSE_ATOL})')
    if k1_launches <= 0:
        raise AssertionError('ICP: K1 never launched')
    if not (bool(res_flat.valid) and dT <= POSE_ATOL):
        raise AssertionError('ICP: flat and pruned matchers disagree')
    kernels['K1']['launches'] = k1_launches

    # 7. The shootout's kernels (E1-E6) --------------------------------
    log(f'shootout kernels vs plain at {SHOOT_Q} x {SHOOT_R} and 1000 x '
        '3001 (parked reference):')
    full = tuple(torch.tensor(a, device=dev)
                 for a in sh.make_scene(SHOOT_Q, SHOOT_R, seed=3))
    odd = [torch.tensor(a, device=dev) for a in sh.make_scene(1000, 3001,
                                                              seed=4)]
    odd[1][::3] = pc.SENTINEL
    odd[2][:, :3] = odd[1]
    # Exact copies of 64 reference points inside their 2048-wide tile,
    # with their own normals, and the first 64 queries next to them: the
    # payload kernels must average the tied rows.
    dup = [a.clone() for a in full]
    dup[1][1000:1064] = dup[1][:64]
    dup[2][1000:1064, :3] = dup[1][:64]
    dup[2][1000:1064, 3:] = -dup[2][:64, 3:]
    dup[0][:64] = dup[1][:64] + 0.01
    errs = {k: 0.0 for k in ('E1', 'E2', 'E3', 'E4', 'E5', 'E6')}
    tol_share = {k: 0.0 for k in ('E1', 'E4', 'E5', 'E6')}
    for label, (q, r, pay) in ((f'{SHOOT_Q} x {SHOOT_R}', full),
                               ('duplicates', tuple(dup)),
                               ('1000 x 3001 parked', tuple(odd))):
        for key, prec in (('E5', 'highest'), ('E1', 'bf16')):
            c = nv.check_mm_indices(q, r, *nv.nn_indices_mm(q, r, prec),
                                    *nv.nn_indices_mm_plain(q, r, prec),
                                    precision=prec)
            errs[key] = max(errs[key], c['max_abs_err'])
            tol_share[key] = max(tol_share[key], c['err_over_tol'])
            log(f'  {key} {prec} {label}: ok {c}')
        for key, fn, plain in (
                ('E4', nv.nn_payload, nv.nn_payload_plain),
                ('E6', nv.nn_payload_pruned, nv.nn_payload_pruned_plain)):
            c = nv.check_payload(q, r, pay, *fn(q, r, pay),
                                 *plain(q, r, pay))
            if label == 'duplicates' and c['duplicates'] < 64:
                raise AssertionError(f'{key}: the duplicate groups were '
                                     'not found')
            errs[key] = max(errs[key], c['max_abs_err'])
            tol_share[key] = max(tol_share[key], c['err_over_tol'])
            log(f'  {key} {label}: ok {c}')
        want = nk.nn_indices_plain(q, r)
        c = nv.check_exact_indices(q, r, *nv.nn_vpu(q, r), *want)
        errs['E2'] = max(errs['E2'], c['max_abs_err'])
        log(f'  E2 {label}: ok {c}')
        for qb, rb in sh.SWEEP[:-1]:
            c = nv.check_exact_indices(q, r, *nv.nn_indices_tiled(
                q, r, qb, rb), *want)
            errs['E3'] = max(errs['E3'], c['max_abs_err'])
        log(f'  E3 {label}: ok at {len(sh.SWEEP) - 1} tile shapes')
    log(f'  largest d2 error as a share of its limit: {tol_share}')
    # A kernel whose d2 were a tenth too large must fail the checks.
    q, r, pay = full
    d2_i, idx_i = nv.nn_indices_mm(q, r)
    d2_p, pay_p = nv.nn_payload(q, r, pay)
    for key, check in (
            ('E5', lambda: nv.check_mm_indices(
                q, r, 1.1 * d2_i, idx_i, *nv.nn_indices_mm_plain(q, r))),
            ('E4', lambda: nv.check_payload(
                q, r, pay, 1.1 * d2_p, pay_p,
                *nv.nn_payload_plain(q, r, pay)))):
        try:
            check()
        except AssertionError as exc:
            log(f'  {key} with d2 x 1.1 planted: rejected ({exc})')
        else:
            raise AssertionError(f'{key}: the check passed d2 x 1.1')
    try:
        nv.nn_indices_tiled(*full[:2], *sh.SWEEP[-1])
        raise AssertionError('E3: the single 65536-point tile was not '
                             'refused')
    except nv.TileTooLarge as exc:
        log(f'  E3 {sh.SWEEP[-1]}: refused as expected ({exc})')

    log(f'the shootout at {SHOOT_Q} x {SHOOT_R} (nn_shootout.run):')
    torch.cuda.synchronize()
    nv.reset_launches()
    rows = {r['name']: r for r in sh.run(*full, reps=10, log=log)}
    torch.cuda.synchronize()
    launches = dict(E1=nv.nn_indices_mm.launches_bf16,
                    E5=nv.nn_indices_mm.launches,
                    E4=nv.nn_payload.launches,
                    E6=nv.nn_payload_pruned.launches,
                    E2=nv.nn_vpu.launches, E3=nv.nn_indices_tiled.launches)
    log(f'  launches in the shootout: {launches}')
    for key, n in launches.items():
        if n <= 0:
            raise AssertionError(f'shootout: {key} never launched')
    sweep = [r for r in rows.values()
             if r['kernel'] == 'E3' and r['ms'] is not None]
    best3 = min(sweep, key=lambda r: r['ms'])
    q, r, pay = full
    plain = dict(
        E1=lambda: nv.nn_indices_mm_plain(q, r, 'bf16'),
        E5=lambda: nv.nn_indices_mm_plain(q, r),
        E4=lambda: nv.nn_payload_plain(q, r, pay),
        E6=lambda: nv.nn_payload_pruned_plain(q, r, pay),
        E2=lambda: nk.nn_indices_plain(q, r))
    plain_ms = {k: cuda_ms(fn, 3) for k, fn in plain.items()}
    plain_ms['E3'] = plain_ms['E2']
    pairs = SHOOT_Q * SHOOT_R
    exact_b = nn_bytes(SHOOT_Q, SHOOT_R)
    pay_b = nn_bytes(SHOOT_Q, SHOOT_R, payload=pay.shape[1])
    share = rows['pruned']['visited_share']
    bounds = dict(
        E1=bound(pairs, INSTR_ARGMIN, exact_b, tensor_flops=8.0 * pairs),
        E5=bound(pairs, INSTR_MM, exact_b),
        E4=bound(pairs, INSTR_PAYLOAD, pay_b),
        E6=bound(share * pairs, INSTR_PAYLOAD, pay_b),
        E2=bound(pairs, INSTR_EXACT, exact_b),
        E3=bound(pairs, INSTR_EXACT, exact_b))
    shoot_row = dict(E1=rows['indices-bf16'], E5=rows['indices-hi'],
                     E4=rows['payload'], E6=rows['pruned'], E2=rows['vpu'],
                     E3=best3)
    variants = 'laser_slam_tpu_torch/csrc/nn_variants.cu'
    names = dict(
        E1=('E1 nn_indices_mm bf16',
            'experiments/pallas_nn_variants.py:75'),
        E2=('E2 nn_vpu', 'experiments/pallas_nn_variants.py:144'),
        E3=(f'E3 nn_indices_tiled (fastest of the sweep: {best3["qb"]}x'
            f'{best3["rb"]})', 'experiments/pallas_tile_sweep.py:51'),
        E4=('E4 nn_payload', 'experiments/pallas_payload_variants.py:64'),
        E5=('E5 nn_indices_mm highest',
            'experiments/pallas_payload_variants.py:167'),
        E6=('E6 nn_payload_pruned',
            'experiments/pallas_payload_variants.py:322'))
    for key in ('E1', 'E2', 'E3', 'E4', 'E5', 'E6'):
        row = shoot_row[key]
        log(f'  {key}: {row["ms"]:.4f} ms, plain {plain_ms[key]:.4f} ms, '
            f'bound {bounds[key][0]:.4f} ms ({bounds[key][1]}), library '
            f'{row["library_ms"]} ms, launches {launches[key]}')
    log(f'  E6 visited {share:.4f} of its reference tiles')

    # 8. Records -------------------------------------------------------
    source = 'laser_slam_tpu_torch/csrc/nn.cu'
    record = {'kernels': [
        dict(name='K1 nn_indices', route='cuda', source=source,
             replaces='laser_slam_tpu/ops/pallas_nn.py:68',
             **kernels['K1']),
        dict(name='K2 nn_indices_pruned', route='cuda', source=source,
             replaces='laser_slam_tpu/ops/pallas_nn.py:262',
             **kernels['K2']),
    ] + [
        dict(name=names[key][0], route='cuda', source=variants,
             replaces=names[key][1], launches=launches[key],
             max_abs_err=errs[key], ms=shoot_row[key]['ms'],
             plain_ms=plain_ms[key], bound_ms=bounds[key][0],
             bound_by=bounds[key][1],
             library_ms=shoot_row[key]['library_ms'],
             library=shoot_row[key]['library'])
        for key in ('E1', 'E2', 'E3', 'E4', 'E5', 'E6')]}
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
