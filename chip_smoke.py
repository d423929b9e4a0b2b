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
   cutoff^2 beyond it.  Its set-up on the card (``nn_kernels.
   pruned_setup``: ``k2_sort_kernel`` or the codes and a ``torch.sort``,
   then ``k2_tables_kernel``) against its plain version
   (``pruned_tables``), qperm, q_sorted, order and lb torch.equal with
   empty merge keys, and K2 against its plain version again, on 14 scenes
   (``k2_setup_scenes``: the room, clusters, SENTINEL-parked rows, an
   all-parked reference, Q = 1000 and the prime 8191, duplicate points,
   overlapping tiles, 16384 queries and 20000 (the torch.sort route), the
   room on the torch.sort route, 4099 one-point tiles whose bounds
   torch.sort sorts, and two lane sets).  Timed with its set-up on the
   card (at most K2_MAX_LAUNCHES device launches a call, counted by
   ``torch.profiler``, with the device ms of each kernel and the host's
   time to issue a call), on the torch.sort route, with the torch tables
   it ran on before, and alone (``nn_kernels._launch_pruned`` on tables
   built once); the share of pairs it scans, counted by the kernel,
   beside the share of the Pallas walk that its bound counts.
5. The slice: ``OnlineRunner(slice1_config(), device='cuda')`` over 64
   synthetic scans of 16384 points (2 laps of a 15 m circle, seed 7, the
   stream's default noise) with a loop closure every 10 scans of lap 2.
   K2 must have launched, the trajectory must be finite and within the
   ground-truth bounds of tests/test_parity.py (max < 0.35 m, final
   < 0.15 m).  ``torch.profiler`` records scans 12-15: kernel launches,
   device time, the device's busy share and K2's share of its time.
   Its trajectory after scan 32 is kept for phase 11.
6. K1 inside ICP: one ``icp_point_to_plane`` at the slice's shapes with
   ``pallas_prune=False`` (the flat-kernel matcher); K1 must have launched
   and the pose must agree with the K2 run within 1e-4.  ICP ms a call
   (one a scan) with either matcher, host clock around synchronized
   calls, and each call's device launches and device ms by kernel
   (``torch.profiler``; not measured when it loses records).
7. The shootout's kernels (E1-E6, ``ops/nn_variants.py``): each held to
   its plain version at the shootout's shape (8192 x 65536, seed 3), on
   the same scene with 64 reference points copied inside their tile
   (tied rows whose payloads are averaged), on the same scene with 64
   reference points copied into the next 2048-wide tile (E5 must return
   the first copy's index, E1 never the next tile's copy, E4 the first
   tile's payload alone), and at an awkward shape (1000 x 3001, every
   third reference row at the SENTINEL; E4's tiles are one row wide
   there) by the float64 checks of
   ``laser_slam_tpu_torch/ops/nn_variants.py`` (a d2 planted a tenth too
   large must fail them; E1's epilogue, which scores the winning key tile
   again, must find the key's score on every query of the four scenes),
   E2 and every E3 sweep shape with d2 bit-equal to K1's plain version;
   E1's set-up (``nn_variants.mm_bf16_setup``) bit-equal to its plain
   version (``mm_bf16_rows_plain``) and two calls on one table equal;
   then the shootout itself (``experiments/nn_shootout.run``), timed by
   CUDA events beside the library calls, where each new kernel must have
   launched and E1, E4, E5, E2 and every E3 shape launch at least 256
   work items.  Each kernel alone beside its call: E1 on tables built
   once (``nn_variants.mm_bf16_setup``), E4/E5 on tables built once
   (``nn_variants.mm_setup``), E6 on tables built once
   (``nn_variants.pruned_setup``); E1's, E4's, E5's and E6's device
   launches a call, set-up included, and their device time by kernel,
   counted by ``torch.profiler`` right after phase 4 (later short
   sessions lose kernel records), and the host's time to issue a call;
   the share of tiles E6 scans (counted by the kernel, 5 calls) beside
   the share the Pallas walk visits (``nn_variants.pruned_walk``, whose
   result must pass the payload check against the kernel's).  Every E3
   shape's time is printed on a line before the kernels' record.
8. The production path (slice 2: projective range-image ICP, image-PCA
   normals, the dense window solve, packed uint16 ingest) through
   ``OnlineRunner(production_config(...), device='cuda')``; it has no
   hand-written kernel (the JAX package computes it outside Pallas).
   (a) Accuracy at 16k density: the first 44 of 64 beam scans of 64 x
   256 (2 laps of a 20 m circle, seed 11 as bench.py) with closures (i -
   32, i) every 10 scans of lap 2, in ``production_config(16384, 16384, 512, 256)``, fed
   packed words; the same frames through the slice-1 exact path (K2,
   kNN normals, full-graph PCG) with the production noise models as the
   witness, as test_parity's oracle.  Production's mean error to ground
   truth must be at most max(2.5 x the witness's, 5 cm) and its poses
   within 10 cm and 1 deg of the witness (tests/test_parity.py's rules);
   xyz ingest within 3 cm a pose of packed ingest; process_scans in
   chunks of 8 within 1 cm and 0.1 deg of per-scan calls (not bit-equal
   on the card: the solver's float ``index_add_`` is atomic there, and
   two per-scan runs differ as much).  K1 and K2 must not launch in the
   production runs.
   (b) Speed at KITTI density: the first 37 scans of bench.py's 116-scan
   64 x 2048 stream (131072 beams a scan, seed 12) in
   ``production_config(131072, 32768, 1024, 1024)``, packed: scans/s over
   24 scans after 8 warm-up scans (host clock, ended by a synchronize),
   ``torch.profiler`` over 4 more (launches a scan, busy share, top
   device ops), and the stage split of the next scan on the runner left
   behind: ``profiling.step_breakdown`` (full_step, device-busy ms of one
   step on a clone of the state; decode_packed, ingest_filters,
   store_decimate, normals, submap_assembly, reading_prep, icp with its
   range-image build, window_solve, pr_query: synchronized ms a call)
   beside the upload of the packed words, and the synchronized wall ms
   of one step.  ATE max < 0.35 m and final < 0.15 m.
9. The flagship path (slice 3: SLAM with loop-closure detection) through
   ``OnlineRunner(flagship_config(...), **FLAGSHIP_RUNNER,
   place_recognition=flagship_place_recognition(), device='cuda')``: the
   scan archive, the scan-context detector on its detect/fetch cadence,
   ICP-verified and refined closures solved through the persisted
   Woodbury cache.  No hand-written kernel (the JAX package computes it
   outside Pallas).  (a) bench.py's 16k place-recognition stream (2 laps
   of an off-centre 20 m circle, seed 21) cut to 64 scans, xyz, in
   ``flagship_config(16384, 16384, 512, 256)``: per scan and in chunks
   of 8 with the detector, and per scan without it.  At least one
   detection; every accepted pair 32 +- 3 keys apart with |yaw| < 0.5
   rad; error max < 0.35 m, final < 0.15 m; mean error at most 1 cm
   above the run without the detector; the chunked detection count
   within 2 of the per-scan one; on one closure, ``solve_cached`` after
   ``extend_cache`` within 1 cm / 0.1 deg of a cold tridiagonal solve.
   (b) Its 116-scan KITTI-density stream (64 x 2048 beams, seed 22) in
   ``flagship_config()``, as bench.py's ``run_e2e_pr``: 10 warm-up
   scans, a chunk of 8, ``warmup_closure_path``, scans/s over timed
   chunks of 8, the benchmarker's four closure topics, the last chunk
   under ``torch.profiler`` (a closure in it, detected or else added and
   verified by hand), one synchronized verification and closure solve,
   cached and cold.  K1/K2 must not launch in phase 9.
10. Multi-robot SLAM (slice 4: forced-prior tracks, cross-track linking
   with group alignment, per-track device maps, marginal covariances)
   through ``OnlineRunner(multirobot_config(), **MULTIROBOT_RUNNER,
   map_config=WorkerConfig(), device='cuda')``.  No hand-written kernel
   (the JAX package computes it outside Pallas).  (a) bench.py's
   two-robot leg (bench.py:1112-1207): two 64-scan streams of 64 x 256
   beams, one lap each of a 20 m circle centred at (6t, 4t), seeds 31 +
   t, in one scene, interleaved.  Per scan, cut to 48 scans a track
   (scans/s after 8 warm-up pairs), and, cut to 32 scans a track, in
   chunks of 8 a track (the last
   chunk pair under ``torch.profiler``), within 1 cm / 0.1 deg of
   per-scan calls in the chunks' key order (the interleaved run gives
   the scans other keys, and with them other window solves).  Then the
   rendezvous link at the closest ground-truth co-location after
   ``warmup_closure_path(use_association=True)`` (synchronized ms) and
   ``refine(2, gn_iterations=6, pcg_iterations=128, pcg_tolerance=1e-8)``
   (ms).  The absorbed prior's weight must be 0; the linked-map ATE
   (track 1 against its expected places, anchored at track 0's closure
   key) mean < 0.10 m and max < 0.35 m; each track's error to its own
   ground truth (anchored at its first pose) max < 0.35 m and final <
   0.15 m; each track's map after the link its map before moved by
   that track's own correction (1 mm), the absorbed one by ~100 m.  (b)
   Four robots, 16 scans each (seeds 31-34): links A-B, C-D, then B-C
   at each pair's closest co-location; one group and only track 0's
   prior remain, and after a refine every pose lies within 0.5 m of its
   place in track 0's frame.  (c) On (a)'s linked graph,
   ``marginal_covariances`` for 8 and 64 keys in one call each, probes
   (at the config's 32 PCG iterations) and exact, synchronized ms a call
   and a key; finite, the exact ones symmetric and positive
   semi-definite; probes at 4096 PCG iterations (no factor of the
   interleaved tracks lies on the preconditioner's chain) symmetric and
   within rtol 2e-3 / atol 1e-5 of the exact ones on the keys within 8
   scans of track 0's anchor or of a link key on its track (the
   32-iteration probes' gap and the largest gap elsewhere reported).
   K1/K2 must not launch in phase 10.
11. The host API and checkpoints (slice 5) at ``slice1_config()``'s full
   width: ``LaserSlamWorker(WorkerConfig(minimum_distance_to_add_pose=
   0.0), IncrementalEstimator(slice1_config(), 1))`` over the first lap
   (32 scans) of phase 5's stream through ``replay.run_worker_on_stream``
   (scans/s after 8 warm-up scans, ms a scan, K2's launches a scan),
   within 2 cm of phase 5's OnlineRunner after the same scans (JAX's
   tests/test_online.py:77-105 bound); ``save_checkpoint`` after scan 24
   and ``load_checkpoint`` (ms each; every array read back bit-equal),
   the resumed run within 1 cm / 0.1 deg of the uninterrupted one after
   scan 31 (float ``index_add_`` is atomic on the card); then
   ``process_loop_closure`` of scans 0 and 31 from the ground truth's
   world-frame alignment, whose refinement ICP runs K2 (ms), and the
   trajectory within test_parity's bounds.  K2 must launch in the lap and
   in the closure, K1 never.  K2 is also held to its plain version at the
   refinement's largest submaps (7 x 16384 points a side), and timed
   there with its set-up on the card (the torch.sort route) in turns with
   the torch tables.  Last, phase
   9a's flagship runner through ``save_online_checkpoint`` /
   ``load_online_checkpoint`` at scan 32 (ms each): the resumed runner
   must find the uninterrupted one's detections, its poses within 1 cm /
   0.1 deg.  Each number is logged beside the card's name and power
   limit.
12. Fleet mode and batched serving (slice 6, ``parallel/fleet.py``) at
   bench.py's widths, data from the port's copies of bench.py's
   ``make_scene`` / ``sample_scan`` (seed 0).  (a) A 65,536-point
   reference with kNN(10) normals and 16 readings of 8192 points from
   poses ~0.5 m away (bench.py:350-361, 406-411): single-stream ICP
   pairs/s with 'projective', 'pallas' (K2) and 'brute'; ``batched_icp``
   at B = 32 with ``serving_icp_config()`` over 4 reps of distinct
   inputs: pairs/s, the mean translation and its mean error to the true
   offsets (< 10 cm), two lanes against the same readings registered
   alone and a 64-lane call against two 32-lane halves (within 1e-5).
   (b) The fleet of bench.py:1212-1231 (256 lanes x 3 scans of 4096
   points, random unit normals, +0.3 m odometry guesses): pairs/s of
   ``fleet_icp_odometry`` with ``fleet_icp_config()``'s 'brute' and with
   'pallas' (K1L, K2L) and 'projective', each run's largest pose gap to
   the K1L run (1e-5 m / 1e-3 deg for the exact matchers, 10 cm / 1 deg
   for 'projective'), a profile of one K1L call, two lanes of it again on
   the CPU (1e-4), and ``fleet_solve`` of ``build_fleet_chain_graphs``
   of the K1L run (ms; one lane against its own solve).  (c) 256 maps of
   16,384 points, 3 scans accumulated, 3 reps of 4096 queries a lane
   (bench.py:1278-1294): queries/s through K1L and the plain path's ms
   on the same maps; an overflow with ``voxel_size_m`` = 1 compacts
   every lane.  Then K1L and K2L against their plain versions at (b)'s
   and (c)'s shapes and at 5 ragged lanes of 1000 x 9001 with copies
   across tiles and parked rows (K2L also on 4 clustered lanes of 2048 x
   16384, four tiles a lane, where it must scan fewer than all pairs:
   ``clustered_scanned_share``), and their times at (b)'s shape; K2L's
   set-up on the card torch.equal to ``pruned_tables_lanes`` at (b)'s
   shape and on the clustered lanes; K2L at 4096- and 1024-point
   reference tiles on both (ms in turns, share of pairs scanned, the
   results of one held to the other's).
13. The data path in and out (slice 7).  (a) The first 48 frames of phase
   9b's KITTI-density stream (64 x 2048 beams, seed 22) written as a
   KITTI sequence (velodyne .bin with reflectance 0, times.txt, calib.txt
   with a fixed Tr, camera-frame poses); read back through
   ``replay.KittiStream`` (points byte-equal, poses within 1e-5 m / 1e-4
   rad of the ground truth) and through the native ``PrefetchLoader``
   (the library must be built and loaded); then
   ``examples/kitti_replay.main`` at its defaults but
   ``--scan-capacity 131072``, with a trajectory CSV and an occupancy map:
   scans/s after 8 warm-up scans, ATE (mean < 0.10 m, max < 0.35 m),
   RPE per 10 m, occupied cells (> 0), insert and read ms a scan, and the
   points a scan beyond the default 32768; the same entry with
   ``--matcher pallas`` over 16 scans (K2 at least 40 launches a scan, K1
   none, the same ATE limits) and K2 held to its plain version at the
   leg's submap (5 x 131072 points).  (b) The bag example's demo bag at
   its defaults (24 revolutions x 15 VLP-16 packets) replayed on the card
   through ``examples/bag_replay.replay``: at least 23 revolutions, ATE
   rmse < 0.5 m, more than 100 occupied cells, one revolution's packets
   decoded by the native library bit-equal to the numpy version, and
   both decoders' ms a packet.  Its numbers go on a ``data_path`` line.
14. The demos and the profiling functions (slice 8).  (a) The port's
   three demos at their defaults on the card through their ``main()``
   (``laser_slam_tpu_torch/examples/``), each passing its own checks:
   ``synthetic_slam_demo`` (20 scans of 8192 points on a 12 m circle,
   the host API, a ground-truth closure; error max < 0.5 m) as is and
   with ``--matcher pallas``, where K2 must launch at least 40 times a
   scan after the first and K1 never, and K2 is held to its plain
   version at the demo's submap (4096 x 24576);
   ``auto_loop_closure_demo`` (48 scans, 2 laps, brute ICP, with and
   without the detector; detections a lap apart, ATE max < 0.5 m);
   ``multi_robot_demo`` (2 x 12 scans, the cross-track link and a
   strong refine; combined-map error max < 0.10 m).  Their numbers go
   on a ``demos`` line.  (b) ``profiling``: phase 8b's step_breakdown
   must hold every key, finite and > 0, with full_step at most the
   synchronized wall ms of a step; ``nn_kernel_utilization`` at phase
   3's scene must give K1 within 25% of phase 3's time and a fraction of
   its bound in (0, 1.05]; ``core/benchmarker.device_trace`` around 4
   scans of a slice-1 runner must leave one trace that names
   ``nn_items_kernel``.  Its numbers go on a ``profiling`` line.
15. Sharding over a mesh (slice 9, ``parallel/sharding.py``), eight
   shards on cuda:0 (a mesh may repeat a device; the shards then share
   one stream, so its times are no scaling result).  (a)
   ``fleet_slam_step`` on a (dp 4, sp 2) mesh at phase 12b's widths (256
   lanes x 3 scans of 4096 points, ``fleet_icp_config()``,
   ``SolverConfig()``, data made as bench.py makes it, seed 15) with
   'pallas' through K1L, through K2L, and 'brute': each within
   FLEET_EXACT_GAP (1e-5 m / 1e-3 deg) of the unsharded fleet
   (``fleet_icp_odometry`` + ``build_fleet_chain_graphs`` +
   ``fleet_solve``) on the card; K1L (K2L) must launch inside the K1L
   (K2L) step and not in the other ones.  (b) ``sharded_solve`` on an
   8-way gp mesh over the dry run's 10,000-pose graph
   (``__graft_entry__.py:140-192``: capacity 1 << 14, 'scatter', 2 GN x
   12 PCG, tolerance 0): error_final < error_initial, and its poses
   within 2e-5 of the single-device solve, or within twice the gap
   between two single-device solves whose sums run in other orders (the
   card's again, its atomic ``index_add_``; the CPU's), whichever is
   larger.  (c) With more than one card visible, (a) and (b) again with
   the shards on distinct cards.  Synchronized ms a call beside the
   card's name and power limit; the numbers go on a ``sharding`` line.

The kernel counters are reset right before phase 5 (K2), phase 6 (K1),
the shootout run of phase 7, the production, flagship and multi-robot
runs of phases 8-10, the host-API lap and closure of phase 11, the
fleet and map runs of phase 12 (K1L, K2L), the KITTI example's K2
leg of phase 13, the synthetic demo's K2 run and the K1 roofline of
phase 14, each sharded fleet step of phase 15 (K1L, K2L), the
main-path runs, and read right after; launches
made to compare a kernel with its plain version are not counted.  Each
kernel's bound is the larger of its bytes (inputs read once, outputs
written once) over 3.35 TB/s and its operations over the
card's rate for their type: f32 lane instructions over SMs x 128 lanes x
the card's max SM clock (67 TFLOP/s counts an FMA as 2), bf16 tensor-core
FLOPs over 989 TFLOP/s (``profiling.CardPeaks.bound``, the port's one
definition of a kernel's bound).  The pruned kernels' work depends on
the data, so their bounds count the pairs that this run's data needs:
the fewer of the pairs their Pallas walks scan, replayed in plain torch
(``nn_kernels.pruned_visits`` for K2, ``nn_variants.pruned_walk`` for
E6, ``walk_share``), and the pairs the kernel itself scanned in the
least of 5 counted calls (``scanned_share`` is their mean), since both
compute the function; the share counted is ``bound_share``.  The matmul-form
kernels (E4, E5, E6) count 4 instructions a pair (3 FMAs and a min), the
function's own work, and E1 one (the min; its product, 8 FLOPs a pair,
counts on the tensor cores; its earlier 3-a-pair bound is logged beside
it as ``bound_ms_3_a_pair``); their epilogues' second scoring of one
tile a query is left out.  Device launches a call, set-up included, are
counted by ``torch.profiler`` and must be at most 12 for E6 and 6 for
E1, E4 and E5.  The second-to-last line is the kernels' JSON
record (K2's ``launches`` from phase 5, ``launches_host_api`` from phase
11, ``launches_kitti`` from phase 13, ``launches_demo`` from phase 14;
K1's ``launches_profiling`` from phase 14; K1L's and K2L's from phase 12, with
the map query's ms through K1L and through the plain path, and their
``launches_sharded`` from phase 15's one-card step); the last line
is the result record.
"""

import collections
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from laser_slam_tpu_torch.pipeline.online import clone_state
# The card's peaks, the instructions a pair of each 1-NN form, the bytes
# of a 1-NN call and the timers: one definition, the port's.
from laser_slam_tpu_torch.pipeline.profiling import (
    INSTR_ARGMIN, INSTR_EXACT, INSTR_MIN, INSTR_MIN_SCORE, card_peaks,
    device_events, event_ms, nn_bytes, sync_ms)

N_SCANS = 64
N_POINTS = 16384
READING = 8192
SUBMAP_SCANS = 5
CUTOFF = 3.0
POSE_ATOL = 1e-4
PROFILE_SCANS = range(12, 16)
SHOOT_Q, SHOOT_R = 8192, 65536
LAUNCH_PROFILED = 5     # calls whose device launches are counted (K2, E1, E4-E6)
K2_MAX_LAUNCHES = 5     # device launches a K2 call may make (shared-memory sort)
E6_MAX_LAUNCHES = 12    # device launches an E6 call may make, set-up included
MM_MAX_LAUNCHES = 6     # the same for E1, E4 and E5
# Phase 8, the production path.  (a) the first 44 of 64 scans over 2
# laps (3.9 m a step; all 64 before phase 13 came, whose time this and
# (b)'s 16 fewer timed scans make up); (b) the first 37 scans of
# bench.py's 116-scan KITTI-density stream: 8 warm-up, 24 timed, 4
# profiled and one for the stage split.
PROD_SCANS, PROD_TAKE = 64, 44
CHUNK_ATOL_M, CHUNK_ATOL_DEG = 0.01, 0.1
KITTI_STREAM, KITTI_WARM, KITTI_TIMED, KITTI_PROFILE = 116, 8, 24, 4
# Phase 9, the flagship (SLAM with loop-closure detection).  (a) bench.py's
# 16k place-recognition stream cut from 128 to 64 scans over its 2 laps;
# (b) its 116-scan KITTI-density stream: 10 warm-up scans, a chunk of 8,
# timed chunks of 8 and the last chunk profiled.
FLAG_SCANS, FLAG_CHUNK, FLAG_KITTI_WARM = 64, 8, 10
FLAG_CIRCLE = dict(n_beams=64, trajectory='circle', radius_m=20.0,
                   center_m=(8.0, 5.0), laps=2, world_size_m=80.0,
                   range_noise_m=0.01, odom_noise=0.005)
# The KITTI-density beam streams take tens of seconds each to ray-cast on
# the host: helper processes make them while the earlier phases run.
PREFETCH = {
    'production_kitti': dict(
        n_take=KITTI_WARM + KITTI_TIMED + KITTI_PROFILE + 1,
        n_scans=KITTI_STREAM, n_beams=64, n_azimuth=2048,
        trajectory='circle', radius_m=20.0, world_size_m=80.0,
        range_noise_m=0.01, odom_noise=0.005, seed=12, packed=True),
    'flagship_kitti': dict(n_scans=KITTI_STREAM, n_azimuth=2048, seed=22,
                           **FLAG_CIRCLE),
}
# Phase 10, multi-robot SLAM (bench.py:1112-1207).  (a) two 64-scan
# tracks: 8 warm-up scan pairs, then per scan; the chunked run cut to 32
# scans a track (8 warm-up pairs, 2 timed chunk pairs, 1 profiled) to
# keep the script inside 750 s.  (b) four 16-scan tracks.
MR_SCANS, MR_WARM, MR_CHUNK, MR4_SCANS = 64, 8, 8, 16
MR_CHUNKED = 32
# The per-scan run, cut to 48 scans a track (three quarters of the lap;
# the circles' first crossing, where the rendezvous links, lies inside
# it) when phase 11 came, to keep the script near 800 s on a slow host.
MR_PER_SCAN = 48
# (c) the probes' PCG budget for the gate (the config runs 32).
MR_COV_PCG = 4096
MR_CIRCLE = dict(n_beams=64, n_azimuth=256, trajectory='circle',
                 radius_m=20.0, laps=1, world_size_m=80.0,
                 range_noise_m=0.01, odom_noise=0.005)
MR_PREFETCH = {'multirobot': dict(n_tracks=2, n_scans=MR_SCANS),
               'multirobot4': dict(n_tracks=4, n_scans=MR4_SCANS)}
# Phase 11, the host API: the first lap (32 scans) of phase 5's stream, a
# checkpoint after scan 24; the flagship runner's checkpoint at scan 32 of
# phase 9a's stream.
HOST_SCANS, HOST_SAVE_AT, HOST_WARM = 32, 24, 8
HOST_ONLINE_ATOL_M = 0.02
RESUME_ATOL_M, RESUME_ATOL_DEG = 0.01, 0.1
FLAG_SAVE_AT = 32
# Phase 12, fleet mode and batched serving, at bench.py's widths: the
# serving reference and readings (bench.py:350-361, 410-411), the fleet
# (bench.py:1212-1231) and its maps (bench.py:1278-1294).
SERVE_REF, SERVE_READ, SERVE_N = 65536, 8192, 16
SERVE_B, SERVE_REPS = 32, 4
FLEET_B, FLEET_T, FLEET_N = 256, 3, 4096
FLEET_MAP_CAP, FLEET_MAP_REPS = 16384, 3
FLEET_VOXEL_M = 1.0
# The fleet's runs against its K1L run, largest pose gap over every lane
# and step.  'brute' and K2L find the same exact nearest neighbours as
# K1L (bit-equal d2; K2L's index differs only at an exact f32 tie), so
# their poses may differ only by such ties: 1e-5 m / 1e-3 deg.
# 'projective' is another matcher; it is held to tests/test_parity.py's
# rule for the production path's projective ICP against the exact path:
# 10 cm / 1 deg.
FLEET_EXACT_GAP = (1e-5, 1e-3)
FLEET_PROJ_GAP = (0.10, 1.0)
# The serving path: a 64-lane call against two 32-lane halves (lanes are
# independent; batched 6x6 products may round otherwise) and a lane
# against the same reading registered alone.
SERVE_LANE_ATOL = 1e-5
# Readings drawn ~0.5 m from the reference pose (bench.py:406-408): the
# mean error of the batched solutions to the true offset, against
# tests/test_parity.py's 10 cm for the projective production path.
SERVE_TRUTH_M = 0.10
# Phase 15, sharding: the fleet step on a (dp 4, sp 2) mesh at phase
# 12b's widths, held to the unsharded fleet by FLEET_EXACT_GAP; the
# factor-sharded solve on an 8-way gp mesh over the dry run's graph
# (__graft_entry__.py:140-192), held to the single-device solve by
# SOLVE_ATOL (JAX's tolerance there) or twice the gap between two
# single-device solves that sum in other orders, whichever is larger.
SHARD_DP, SHARD_SP = 4, 2
SOLVE_POSES, SOLVE_ATOL = 10_000, 2e-5
# Phase 13, the data path: the first 48 frames of phase 9b's stream as a
# KITTI sequence through the KITTI example at the full width of an HDL-64
# scan (8 warm-up scans), 16 of them with K2; the bag example's defaults.
DATA_SCANS, DATA_WARM, DATA_K2_SCANS = 48, 8, 16
DATA_SCAN_CAP, DATA_DEFAULT_CAP = 131072, 32768
DATA_ATE_MEAN_M, DATA_ATE_MAX_M = 0.10, 0.35
DATA_POSE_ATOL = (1e-5, 1e-4)      # m, rad: the written poses read back
BAG_REVOLUTIONS, BAG_RMSE_M, BAG_OCCUPIED = 23, 0.5, 100
# A KITTI-like Tr (camera from velodyne): camera axes (right, down,
# forward) = velodyne (-y, -z, +x), plus a lever arm.
KITTI_TR = np.array([[0.0, -1.0, 0.0, -0.01],
                     [0.0, 0.0, -1.0, -0.07],
                     [1.0, 0.0, 0.0, -0.27],
                     [0.0, 0.0, 0.0, 1.0]])
_POOL = []


def log(msg):
    print(msg, flush=True)


def beam_frames(n_take=None, **stream):
    """The first ``n_take`` frames (all by default) of a BeamStream."""
    from laser_slam_tpu_torch.pipeline import velodyne_sim as vs
    return list(itertools.islice(vs.BeamStream(**stream), n_take))


def multirobot_frames(n_tracks, n_scans):
    """bench.py's multi-robot streams: one lap each of a 20 m circle
    centred at (6t, 4t), seed 31 + t, all in the scene of seed 31."""
    from laser_slam_tpu_torch.pipeline import velodyne_sim as vs
    scene = vs.make_beam_scene(seed=31, world_size_m=80.0)
    return [list(vs.BeamStream(n_scans=n_scans, center_m=(6.0 * t, 4.0 * t),
                               seed=31 + t, scene=scene, **MR_CIRCLE))
            for t in range(n_tracks)]


def start_prefetch():
    """Start making the PREFETCH and MR_PREFETCH streams in spawned
    helper processes (the script's exit terminates them); returns {name:
    async result}."""
    import multiprocessing
    pool = multiprocessing.get_context('spawn').Pool(
        len(PREFETCH) + len(MR_PREFETCH))
    _POOL.append(pool)
    out = {name: pool.apply_async(beam_frames, kwds=kw)
           for name, kw in PREFETCH.items()}
    out.update({name: pool.apply_async(multirobot_frames, kwds=kw)
                for name, kw in MR_PREFETCH.items()})
    return out


def fetched(streams, name):
    """A prefetched stream's frames, and the seconds spent waiting."""
    t0 = time.perf_counter()
    frames = streams[name].get(timeout=600)
    return frames, time.perf_counter() - t0


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


def exact_tiled(name, q, ref, got, want):
    """E2/E3 against K1's plain version: d2 bit-equal, indices equal
    except at an exact f32 tie (nn_variants.check_exact_indices)."""
    from laser_slam_tpu_torch.ops import nn_variants as nv
    if not torch.equal(got[0], want[0]):
        n = int(torch.sum(got[0] != want[0]))
        raise AssertionError(f'{name}: {n} d2 differ from the plain version')
    return nv.check_exact_indices(q, ref, *got, *want)


def k2_setup_scenes(nk, pc, dev, queries, submap, c_q, c_ref):
    """Phase 4's scenes for K2's set-up: (label, queries, reference, the
    lane axis or not, the most queries a lane sorted in shared memory)."""
    g = torch.Generator(device='cpu').manual_seed(16)

    def randn(*shape, scale=5.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    sort_keys = nk._SORT_KEYS
    parked_q = queries.clone()
    parked_q[::5] = pc.SENTINEL
    parked_r = submap.clone()
    parked_r[::3] = pc.SENTINEL
    dup = queries[:64].repeat(128, 1)           # codes tie 128 times each
    cube = (torch.rand(16384, 3, generator=g) * 2.0).to(dev)
    inner = (0.5 + torch.rand(8192, 3, generator=g)).to(dev)
    spread = submap[::4][:16384] + 0.01
    big = torch.cat([spread, submap[1::4][:3616] + 0.01])   # 20000 rows
    lanes_q = randn(3, 2000, 3)
    lanes_r = randn(3, 5000, 3)
    lanes_r[1, ::3] = pc.SENTINEL
    lanes_r[2] = pc.SENTINEL
    return [
        ('room 8192 x 81920', queries, submap, None, sort_keys),
        ('clusters', c_q, c_ref, None, sort_keys),
        ('SENTINEL-parked rows, both clouds', parked_q, parked_r, None,
         sort_keys),
        ('an all-parked reference, 1000 x 3001', randn(1000, 3),
         torch.full((3001, 3), pc.SENTINEL, device=dev), None, sort_keys),
        ('Q 1000 (qb 250) x 3001', randn(1000, 3), randn(3001, 3), None,
         sort_keys),
        ('prime Q 8191 (qb 1) x 81920', queries[:8191].contiguous(), submap,
         None, sort_keys),
        ('duplicate points (codes tie)', dup, submap, None, sort_keys),
        ('overlapping tiles (lb 0 ties), 8192 x 16384 at rb 512', inner,
         cube, 512, sort_keys),
        ('Q 16384, the largest shared-memory sort', spread, submap, None,
         sort_keys),
        ('Q 20000, the torch.sort route', big, submap, None, sort_keys),
        ('room 8192 x 81920 on the torch.sort route', queries, submap, None,
         0),
        ('prime R 4099 (4099 tiles of 1), bounds sorted by torch.sort',
         randn(1000, 3), randn(4099, 3), None, sort_keys),
        ('3 lanes of 2000 x 5000, one parked, one all parked', lanes_q,
         lanes_r, None, sort_keys),
        ('2 lanes of 20000 x 4099, both torch.sort routes',
         randn(2, 20000, 3), randn(2, 4099, 3), None, sort_keys),
    ]


def check_k2_setup(nk, scenes):
    """K2's set-up on the card (``nk.pruned_setup``) against its plain
    version (``nk.pruned_tables``) on each scene of
    :func:`k2_setup_scenes`: qperm, q_sorted, order and lb torch.equal,
    the same tiles, every merge key and the item counter empty, over lanes
    the flat rows of the unpack; then K2 (K2L) through its wrapper
    against its plain version within the cutoff (d2 bit-equal, an index
    that differs only at an exact f32 tie) and beyond it (d2 > cutoff^2).
    Returns the largest d2 error."""
    err = 0.0
    for label, q, ref, rb, sort_keys in scenes:
        lanes = q.dim() == 3
        pref = (nk.build_pruned_ref_lanes if lanes else nk.build_pruned_ref)(
            ref, rb)
        old = nk._SORT_KEYS
        nk._SORT_KEYS = sort_keys
        try:
            tables, keys, rows = nk.pruned_setup(q, pref, CUTOFF)
            d2_k, idx_k = (nk.nn_indices_pruned_lanes if lanes
                           else nk.nn_indices_pruned)(q, pref, CUTOFF)
        finally:
            nk._SORT_KEYS = old
        want = nk.pruned_tables(q, pref, CUTOFF)
        for name, a, b in zip(('qperm', 'q_sorted', 'order', 'lb'),
                              tables[:4], want[:4]):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f'K2 set-up, {label}: {name} differs '
                                     'from pruned_tables')
        if tables[4:] != want[4:]:
            raise AssertionError(f'K2 set-up, {label}: tiles {tables[4:]} '
                                 f'where pruned_tables has {want[4:]}')
        if not bool(torch.all(keys == nk._INIT_KEY)):
            raise AssertionError(f'K2 set-up, {label}: merge keys not empty')
        B, Q = (q.shape[0], q.shape[1]) if lanes else (1, q.shape[0])
        if lanes and not torch.equal(rows, (want[0] + Q * torch.arange(
                B, device=q.device)[:, None]).reshape(-1)):
            raise AssertionError(f'K2 set-up, {label}: flat rows differ')
        d2_p, idx_p = (nk.nn_indices_pruned_lanes_plain if lanes
                       else nk.nn_indices_pruned_plain)(q, pref, CUTOFF)
        R = pref.points.shape[-2]
        shift = (R * torch.arange(B, device=q.device)[:, None] if lanes
                 else 0)
        inside = d2_p <= CUTOFF ** 2
        if bool(torch.any(d2_k[~inside] <= CUTOFF ** 2)):
            raise AssertionError(f'K2, {label}: a query beyond the cutoff '
                                 'reported within it')
        err = max(err, check_nn(
            f'{label}: tables torch.equal to pruned_tables '
            f'(qb {tables[4]}, rb {tables[5]}); K2', q.reshape(-1, 3)[
                inside.reshape(-1)], pref.points.reshape(-1, 3),
            d2_k[inside], (idx_k + shift)[inside], d2_p[inside],
            (idx_p + shift)[inside], ties=True))
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


DeviceRow = collections.namedtuple('DeviceRow',
                                   'key count self_device_time_total')


def device_rows(prof):
    """The work that ran on the card summed by name, as the device rows of
    the profiler's ``key_averages()`` (launches, self time in us), from
    ``profiling.device_events`` (phase 4 checks that the two agree)."""
    rows = {}
    for name, _, dur in device_events(prof):
        count, total = rows.get(name, (0, 0))
        rows[name] = (count + 1, total + dur)
    return [DeviceRow(k, c, t / 1e3) for k, (c, t) in rows.items()]


def device_launches(prof):
    return sum(e.count for e in device_rows(prof))


def launches_a_call(name, call, items_kernel, most, items_per_call=1):
    """Device launches a call of ``call`` and their device ms a call by
    kernel, counted by ``torch.profiler`` over LAUNCH_PROFILED calls.  A
    session whose ``items_kernel`` shows fewer records than the calls
    launch (``items_per_call`` each) lost some and is taken again; a
    count still short after 3 sessions, or above ``most``, fails the
    run."""
    call()
    torch.cuda.synchronize()
    for attempt in range(3):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(LAUNCH_PROFILED):
                call()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        items = sum(e.count for e in rows if e.key.startswith(items_kernel))
        if items == LAUNCH_PROFILED * items_per_call:
            break
        log(f'  {name} profile {attempt + 1}: {items} records of its items '
            f'kernel in {LAUNCH_PROFILED} calls of {items_per_call}, taken '
            'again')
    else:
        raise AssertionError(f'{name}: the profiler lost kernel records in 3 '
                             'sessions, launches a call not measured')
    launches = sum(e.count for e in rows) / LAUNCH_PROFILED
    if launches > most:
        raise AssertionError(f'{name}: {launches} device launches a call, '
                             f'above {most}')
    split = {e.key.split('(')[0]: e.self_device_time_total / 1e3
             / LAUNCH_PROFILED for e in rows}
    return launches, split


def profile_summary(prof, wall_s, scans, focus=(), top=5):
    """Kernel launches, device time and the device's busy share in a
    profiled window of ``wall_s`` seconds over the scans ``scans`` (a
    range), the share of device time of each ``focus`` entry (a label and
    the kernel-name substrings it sums) and the ``top`` device ops.
    Returns the numbers, or None when the profiler saw no device time."""
    t0 = time.perf_counter()
    rows = device_rows(prof)
    t = {e.key: e.self_device_time_total / 1e3 for e in rows}
    total = sum(t.values())
    if total <= 0:
        log('  profiler: no device time recorded (not measured)')
        return None
    launches = sum(e.count for e in rows)
    n = len(scans)
    busy = 100 * total / (1000 * wall_s)
    log(f'  profiler over scans {scans.start}-{scans.stop - 1}: {launches} '
        f'device launches ({launches / n:.0f} a scan), {total:.3f} ms of '
        f'device time in {1000 * wall_s:.3f} ms of wall time (profiler '
        f'on): busy {busy:.2f}% (summed in '
        f'{time.perf_counter() - t0:.1f} s)')
    for label, keys in focus:
        v = sum(x for k, x in t.items() if any(s in k for s in keys))
        log(f'  {label}: {100 * v / total:.2f}% of device time '
            f'({v / n:.3f} ms a scan)')
    for key, v in sorted(t.items(), key=lambda kv: -kv[1])[:top]:
        log(f'    {v:9.3f} ms  {100 * v / total:5.2f}%  {key[:90]}')
    return dict(launches_per_scan=launches / n, busy_pct=busy,
                device_ms_per_scan=total / n)


def pose_gaps(a, b):
    """(max translation gap m, max rotation gap deg) between two [n,7]
    trajectories, in float64 (tests/test_torch_production.py)."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    dt = np.linalg.norm(a[:, 4:] - b[:, 4:], axis=1).max()
    wa, va, wb, vb = a[:, 0], a[:, 1:4], b[:, 0], b[:, 1:4]
    w = wa * wb + np.sum(va * vb, axis=1)
    v = wa[:, None] * vb - wb[:, None] * va - np.cross(va, vb)
    dr = np.degrees(2 * np.arctan2(np.linalg.norm(v, axis=1), np.abs(w)))
    return float(dt), float(dr.max())


def run_stream(cfg, frames, closures, packed_az=None, chunk=None,
               witness=False):
    """One fresh runner on the card over ``frames`` with the loop closures
    ``closures`` ({scan index: (a, b)}); xyz points, or the uint16 range
    words with ``packed_az`` azimuth columns; per scan, or with
    ``chunk``, through process_scans in runs that end at the closures.
    Returns the trajectory [n,7] in frame order and the wall seconds."""
    from laser_slam_tpu_torch.ops import se3
    from laser_slam_tpu_torch.pipeline import online, velodyne_sim as vs
    runner = online.OnlineRunner(cfg, pose_capacity=128, factor_capacity=512,
                                 device='cuda')
    if packed_az is not None:
        runner.enable_packed_ingest(vs.HDL64_ELEV_DEG, packed_az)

    def item(f):
        return (f.time_ns, f.range_words if packed_az is not None
                else f.points, f.odom_pose7)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start = 0
    for end in sorted(closures) + [len(frames) - 1]:
        if chunk is None:
            for f in frames[start:end + 1]:
                runner.process_scan(*item(f))
        else:
            runner.process_scans([item(f) for f in frames[start:end + 1]],
                                 chunk_size=chunk)
        if end in closures:
            a, b = closures[end]
            runner.add_loop_closure(a, b, measured_closure(
                frames, runner.trajectory(), a, b, se3, torch))
        start = end + 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    traj = runner.trajectory()
    est = np.stack([traj[f.time_ns] for f in frames])
    if not np.all(np.isfinite(est)):
        raise AssertionError('non-finite trajectory')
    return est, wall


def production_phase(nk, streams):
    """Phase 8: the production online path (slice 2) through OnlineRunner:
    (a) accuracy at 16k density against the exact slice-1 path and
    ground truth, (b) speed and the stage split at KITTI density."""
    from laser_slam_tpu_torch.config import production_config, slice1_config
    from laser_slam_tpu_torch.ops import spherical
    from laser_slam_tpu_torch.pipeline import online, profiling
    from laser_slam_tpu_torch.pipeline import velodyne_sim as vs
    dev = torch.device('cuda')
    out = {}

    # (a) Accuracy at 16k density.
    t0 = time.perf_counter()
    frames = list(itertools.islice(vs.BeamStream(
        n_scans=PROD_SCANS, n_beams=64, n_azimuth=256, trajectory='circle',
        radius_m=20.0, world_size_m=80.0, range_noise_m=0.01,
        odom_noise=0.005, seed=11, laps=2, packed=True), PROD_TAKE))
    half = PROD_SCANS // 2
    closures = {i: (i - half, i) for i in range(half + 10, PROD_TAKE, 10)}
    gt = np.stack([f.gt_pose7 for f in frames])
    log(f'production (a): the first {PROD_TAKE} of {PROD_SCANS} beam scans '
        f'of 64 x 256 (2 laps of a 20 m circle, seed 11) made in '
        f'{time.perf_counter() - t0:.1f} s, closures at {sorted(closures)}')
    cfg16 = production_config(16384, 16384, 512, 256)
    nk.nn_indices.launches = 0
    nk.nn_indices_pruned.launches = 0
    packed, wall = run_stream(cfg16, frames, closures, packed_az=256)
    nn_in_production = (nk.nn_indices.launches
                        + nk.nn_indices_pruned.launches)
    xyz, wall_xyz = run_stream(cfg16, frames, closures)
    chunked, wall_chunk = run_stream(cfg16, frames, closures, packed_az=256,
                                     chunk=8)
    # The witness weighs its factors with the production noise models, as
    # test_parity's oracle does: the slice-1 defaults trust odometry as
    # much as ICP, which this stream's odometry noise does not bear.
    exact = slice1_config(scan_capacity=16384, reading_capacity=READING)
    exact = dataclasses.replace(exact, laser_track=dataclasses.replace(
        exact.laser_track,
        odometry_noise_model=cfg16.laser_track.odometry_noise_model,
        icp_noise_model=cfg16.laser_track.icp_noise_model))
    nk.nn_indices_pruned.launches = 0
    witness, wall_w = run_stream(exact, frames, closures)
    k2_witness = nk.nn_indices_pruned.launches
    ate = {k: np.linalg.norm(v[:, 4:] - gt[:, 4:], axis=1)
           for k, v in (('packed', packed), ('xyz', xyz),
                        ('witness', witness))}
    for k, v in ate.items():
        log(f'  ATE {k}: mean {v.mean():.6f} m, max {v.max():.6f} m, final '
            f'{v[-1]:.6f} m')
    log(f'  wall: packed {wall:.2f} s, xyz {wall_xyz:.2f} s, packed in '
        f'chunks of 8 {wall_chunk:.2f} s, exact witness {wall_w:.2f} s '
        f'(K2 launches {k2_witness}); K1/K2 launches in the production '
        f'run {nn_in_production}')
    dt_w, dr_w = pose_gaps(packed, witness)
    dt_x = float(np.linalg.norm(packed[:, 4:] - xyz[:, 4:], axis=1).max())
    dt_c, dr_c = pose_gaps(packed, chunked)
    log(f'  production vs the exact witness: {dt_w:.6f} m, {dr_w:.4f} deg '
        '(limits 0.10 m, 1 deg)')
    log(f'  packed vs xyz ingest: {dt_x:.6f} m a pose at most (limit 0.03 m)')
    log(f'  process_scans(chunk_size=8) vs per scan: {dt_c:.3e} m, '
        f'{dr_c:.3e} deg (bit-equal: {bool(np.array_equal(packed, chunked))}'
        f'; limits {CHUNK_ATOL_M} m, {CHUNK_ATOL_DEG} deg)')
    limit = max(2.5 * ate['witness'].mean(), 0.05)
    if not ate['packed'].mean() <= limit:
        raise AssertionError(f'production (a): mean ATE {ate["packed"].mean()}'
                             f' above {limit}')
    if not (dt_w <= 0.10 and dr_w <= 1.0):
        raise AssertionError('production (a): too far from the witness')
    if not dt_x <= 0.03:
        raise AssertionError('production (a): packed and xyz ingest differ')
    if not (dt_c <= CHUNK_ATOL_M and dr_c <= CHUNK_ATOL_DEG):
        raise AssertionError('production (a): chunked ingest differs')
    if nn_in_production or not k2_witness:
        raise AssertionError('production (a): the matchers ran where they '
                             'should not, or not where they should')
    out.update(ate_16k_mean_m=float(ate['packed'].mean()),
               ate_16k_witness_mean_m=float(ate['witness'].mean()),
               witness_gap_m=dt_w, witness_gap_deg=dr_w)

    # (b) Speed at KITTI density.
    frames, waited = fetched(streams, 'production_kitti')
    n_frames = len(frames)
    log(f'production (b): the first {n_frames} of {KITTI_STREAM} beam scans '
        f'of 64 x 2048 = 131072 beams (a 20 m circle, seed 12), made by a '
        f'helper process ({waited:.1f} s waited for them)')
    cfg = production_config(131072, 32768, 1024, 1024)
    runner = online.OnlineRunner(cfg, pose_capacity=128, factor_capacity=512,
                                 device='cuda')
    runner.enable_packed_ingest(vs.HDL64_ELEV_DEG, 2048)
    feed = frames[:-1]
    for f in feed[:KITTI_WARM]:
        runner.process_scan(f.time_ns, f.range_words, f.odom_pose7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in feed[KITTI_WARM:KITTI_WARM + KITTI_TIMED]:
        runner.process_scan(f.time_ns, f.range_words, f.odom_pose7)
    torch.cuda.synchronize()
    rate = KITTI_TIMED / (time.perf_counter() - t0)
    # Device activity only: every number read is a device row, and host
    # op events would multiply the post-processing time.
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        t0 = time.perf_counter()
        for f in feed[KITTI_WARM + KITTI_TIMED:]:
            runner.process_scan(f.time_ns, f.range_words, f.odom_pose7)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    traj = runner.trajectory()
    est = np.stack([traj[f.time_ns] for f in feed])
    gt = np.stack([f.gt_pose7 for f in feed])
    if not np.all(np.isfinite(est)):
        raise AssertionError('production (b): non-finite trajectory')
    ate = np.linalg.norm(est[:, 4:] - gt[:, 4:], axis=1)
    log(f'  scans/s over {KITTI_TIMED} scans after {KITTI_WARM} warm-up '
        f'scans: {rate:.4f} ({1000 / rate:.3f} ms a scan)')
    log(f'  ATE vs ground truth over {len(feed)} scans: mean '
        f'{ate.mean():.6f} m, max {ate.max():.6f} m, final {ate[-1]:.6f} m')
    scans = range(KITTI_WARM + KITTI_TIMED, len(feed))
    prof_out = profile_summary(prof, prof_wall, scans, top=12)

    # The stage split: profiling.step_breakdown on the runner the run
    # left, fed the next scan (each stage synchronized wall ms of one call,
    # mean of 5; full_step the device-busy ms of one step on a clone of
    # the state, median of 5), beside the upload of its packed words,
    # which the JAX package has no stage for.  full_step_wall_ms is the
    # synchronized wall ms of the same step, for phase 14.
    nxt = frames[-1]
    t0 = time.perf_counter()
    stage = {'upload': sync_ms(
        lambda: spherical.words_to_device(nxt.range_words, dev), 5)}
    stage.update(profiling.step_breakdown(
        runner, nxt.points, nxt.odom_pose7, ranges_u16=nxt.range_words,
        reps=5))
    step_wall = profiling.full_step_wall_ms(runner, nxt.points,
                                            nxt.odom_pose7, reps=5)
    log(f'  stage split (profiling.step_breakdown; ms a call, synchronized, '
        f'mean of 5; full_step device-busy, median of 5; the ICP includes '
        f'the range-image build): '
        + ', '.join(f'{k} {v:.3f}' for k, v in stage.items())
        + f'; one step {step_wall:.3f} ms synchronized wall (median of 5); '
        f'taken in {time.perf_counter() - t0:.1f} s')
    if not (ate.max() < 0.35 and ate[-1] < 0.15):
        raise AssertionError(f'production (b): ATE out of bounds (max '
                             f'{ate.max()}, final {ate[-1]})')
    out.update(kitti_scans_per_s=rate, kitti_ate_max_m=float(ate.max()),
               kitti_ate_final_m=float(ate[-1]), stage_ms=stage,
               full_step_wall_ms=step_wall)
    if prof_out is not None:
        out.update(prof_out)
    log('  production: ' + json.dumps(out))
    return out


def detection_alignment(state, key_a, key_b, yaw):
    """The detector's alignment guess T_w_a Rz(yaw) T_w_b^-1, on the host
    (OnlineRunner._inject_detection)."""
    from laser_slam_tpu_torch.ops import se3
    pair = state.traj_poses[[key_a, key_b]].cpu()
    rz = torch.tensor([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2), 0, 0, 0],
                      dtype=torch.float32)
    return se3.compose(pair[0], se3.compose(rz, se3.inverse(pair[1])))


def flagship_run(cfg, frames, pr, chunk=None):
    """A fresh flagship runner on the card over ``frames`` (xyz), per
    scan or in chunks, flushed at the end.  Returns (runner, [n,7]
    trajectory in frame order, wall seconds)."""
    from laser_slam_tpu_torch.config import FLAGSHIP_RUNNER
    from laser_slam_tpu_torch.pipeline import online
    kw = dict(FLAGSHIP_RUNNER)
    runner = online.OnlineRunner(cfg, place_recognition=pr, device='cuda',
                                 **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if chunk:
        runner.process_scans([(f.time_ns, f.points, f.odom_pose7)
                              for f in frames], chunk_size=chunk)
    else:
        for f in frames:
            runner.process_scan(f.time_ns, f.points, f.odom_pose7)
    traj = runner.trajectory()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    est = np.stack([traj[f.time_ns] for f in frames])
    if not np.all(np.isfinite(est)):
        raise AssertionError('flagship: non-finite trajectory')
    return runner, est, wall


def flagship_phase(nk, streams):
    """Phase 9: the flagship path (slice 3: SLAM with loop-closure
    detection) through OnlineRunner: (a) the flow and its accuracy at 16k
    density, (b) speed at KITTI density.  Returns (a)'s frames."""
    from laser_slam_tpu_torch.config import (flagship_config,
                                             flagship_place_recognition)
    from laser_slam_tpu_torch.core import benchmarker as bench
    from laser_slam_tpu_torch.graph import solver as sv
    from laser_slam_tpu_torch.pipeline import online
    pr = flagship_place_recognition()
    out = {}
    t_phase = time.perf_counter()

    # (a) 16k density: the flow, its accuracy, cached against cold.
    t0 = time.perf_counter()
    frames = frames16 = beam_frames(n_scans=FLAG_SCANS, n_azimuth=256,
                                    seed=21, **FLAG_CIRCLE)
    lap = FLAG_SCANS // 2
    gt = np.stack([f.gt_pose7 for f in frames])
    log(f'flagship (a): {FLAG_SCANS} beam scans of 64 x 256 (2 laps of an '
        f'off-centre 20 m circle, seed 21) made in '
        f'{time.perf_counter() - t0:.1f} s')
    cfg16 = flagship_config(16384, 16384, 512, 256)
    nk.nn_indices.launches = 0
    nk.nn_indices_pruned.launches = 0
    runs = {}
    for label, pr_cfg, chunk in (('per-scan', pr, None),
                                 ('chunked', pr, FLAG_CHUNK),
                                 ('no detector', None, None)):
        runner, est, wall = flagship_run(cfg16, frames, pr_cfg, chunk)
        err = np.linalg.norm(est[:, 4:] - gt[:, 4:], axis=1)
        runs[label] = (runner, err)
        log(f'  {label}: {wall:.2f} s, detections '
            f'{[d[:2] for d in runner.detections]}, rejected '
            f'{[d[:2] for d in runner.rejected_detections]}; error mean '
            f'{err.mean():.6f} m, max {err.max():.6f} m, final '
            f'{err[-1]:.6f} m')
    nn_launches = nk.nn_indices.launches + nk.nn_indices_pruned.launches
    runner, err = runs['per-scan']
    chunked, err_c = runs['chunked']
    base = runs['no detector'][1]
    if not runner.detections:
        raise AssertionError('flagship (a): no accepted detection')
    for r in (runner, chunked):
        for key_a, key_b, _, yaw in r.detections:
            if abs((key_b - key_a) - lap) > 3 or abs(yaw) >= 0.5:
                raise AssertionError(f'flagship (a): detection {key_a}, '
                                     f'{key_b}, yaw {yaw}')
    for label, e in (('per-scan', err), ('chunked', err_c)):
        if not (e.max() < 0.35 and e[-1] < 0.15):
            raise AssertionError(f'flagship (a) {label}: error out of '
                                 f'bounds (max {e.max()}, final {e[-1]})')
    if not err.mean() <= base.mean() + 0.01:
        raise AssertionError('flagship (a): the detector raised the mean '
                             f'error from {base.mean()} to {err.mean()}')
    if abs(len(chunked.detections) - len(runner.detections)) > 2:
        raise AssertionError('flagship (a): chunked and per-scan detection '
                             'counts differ by more than 2')
    if nn_launches:
        raise AssertionError(f'flagship (a): K1/K2 launched {nn_launches} '
                             'times')
    # One closure, on clones of the final state: the refined measurement
    # once, then solve_cached after extend_cache of a cache built on this
    # state against a cold tridiagonal solve (and a converged one).  The
    # runner's own cache was built at its first closure; the poses added
    # since ride identity rows in it, so its solve is logged beside.
    key_a, key_b, _, yaw = runner.detections[-1]
    w_T = detection_alignment(runner.state, key_a, key_b, yaw).cuda()
    meas, _ = online._refine_lc_meas(runner.state, runner.archive, key_a,
                                     key_b, w_T, cfg16)

    def cached_solve(cache):
        return online._append_lc_and_solve_cached(
            clone_state(runner.state), cache, key_a, key_b, meas, cfg16, -1,
            False)[0]

    def cold_solve(**solver):
        cfg = dataclasses.replace(cfg16, solver=dataclasses.replace(
            cfg16.solver, **solver))
        return online._append_lc_and_solve(clone_state(runner.state), key_a,
                                           key_b, meas, cfg, -1, False)[0]

    fresh = sv.build_cache(online._graph_view(runner.state),
                           runner.state.traj_poses,
                           online._pose_mask(runner.state), cfg16.solver)
    n = len(frames)
    solved = {k: s.traj_poses[:n].cpu().numpy() for k, s in (
        ('cached', cached_solve(fresh)),
        ('stale', cached_solve(sv.clone_cache(runner._solver_cache))),
        ('cold', cold_solve(preconditioner='tridiagonal')),
        ('converged', cold_solve(preconditioner='tridiagonal',
                                 gn_iterations=4, gn_tolerance=0.0,
                                 pcg_iterations=400, pcg_tolerance=1e-12)))}
    dt, dr = pose_gaps(solved['cached'], solved['cold'])
    to_converged = {k: pose_gaps(v, solved['converged'])[0]
                    for k, v in solved.items() if k != 'converged'}
    stale_by = runner._n_rel_host - runner._cache_rel_count
    log(f'  closure ({key_a}, {key_b}) on clones: solve_cached after '
        f'extend_cache vs a cold tridiagonal solve: {dt:.3e} m, {dr:.3e} '
        'deg (limits 0.01 m, 0.1 deg); m from a converged solve (4 GN x '
        f'400 PCG): {to_converged}, "stale" with the runner\'s cache, '
        f'built {stale_by} factors before')
    if not (dt <= 0.01 and dr <= 0.1):
        raise AssertionError('flagship (a): cached and cold solves differ')
    out.update(err16_mean_m=float(err.mean()), err16_max_m=float(err.max()),
               err16_final_m=float(err[-1]),
               err16_no_detector_mean_m=float(base.mean()),
               detections16=len(runner.detections),
               detections16_chunked=len(chunked.detections),
               rejected16=len(runner.rejected_detections),
               cached_vs_cold_m=dt, cached_vs_cold_deg=dr)

    log(f'  phase 9 (a) took {time.perf_counter() - t_phase:.1f} s')

    # (b) KITTI density, as bench.py's run_e2e_pr: warm-up scans, one
    # chunk, warmup_closure_path, timed chunks (the last one profiled).
    t_b = time.perf_counter()
    frames, waited = fetched(streams, 'flagship_kitti')
    log(f'flagship (b): {KITTI_STREAM} beam scans of 64 x 2048 = 131072 '
        f'beams (seed 22), made by a helper process ({waited:.1f} s waited '
        'for them)')
    cfg = flagship_config(131072, 32768, 1024, 1024)
    runner, _, _ = flagship_run(cfg, frames[:FLAG_KITTI_WARM], pr)
    rest = frames[FLAG_KITTI_WARM:]
    rest = rest[:(len(rest) // FLAG_CHUNK) * FLAG_CHUNK]
    runner.process_scans([(f.time_ns, f.points, f.odom_pose7)
                          for f in rest[:FLAG_CHUNK]], chunk_size=FLAG_CHUNK)
    runner.warmup_closure_path()
    log(f'  warm-up scans, a chunk and warmup_closure_path: '
        f'{time.perf_counter() - t_b:.1f} s')
    timed, profiled = rest[FLAG_CHUNK:-FLAG_CHUNK], rest[-FLAG_CHUNK:]
    bench.enable()
    bench.reset_topic()
    nk.nn_indices.launches = 0
    nk.nn_indices_pruned.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(0, len(timed), FLAG_CHUNK):
        runner.process_scans([(f.time_ns, f.points, f.odom_pose7)
                              for f in timed[k:k + FLAG_CHUNK]],
                             chunk_size=FLAG_CHUNK)
    runner.flush_detections()
    torch.cuda.synchronize()
    rate = len(timed) / (time.perf_counter() - t0)
    stats = bench.statistics()
    bench.disable()
    # The profiled chunk must hold a closure: when the detector lands
    # none in it, a verified closure of the chunk's last key with its
    # previous-lap twin is added inside the window.
    n_det = len(runner.detections)
    # Device activity only: every number read is a device row, and host
    # op events would multiply the post-processing time.
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        t0 = time.perf_counter()
        runner.process_scans([(f.time_ns, f.points, f.odom_pose7)
                              for f in profiled], chunk_size=FLAG_CHUNK)
        runner.flush_detections()
        manual = len(runner.detections) == n_det
        if manual:
            kb = len(runner.key_info) - 1
            ka = kb - len(frames) // 2
            runner.add_loop_closure(ka, kb, detection_alignment(
                runner.state, ka, kb, 0.0).numpy(), verify_with_icp=True)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    nn_launches = nk.nn_indices.launches + nk.nn_indices_pruned.launches
    traj = online.extract_trajectory(runner.state)
    gt = np.stack([f.gt_pose7 for f in frames[:len(traj)]])
    err = np.linalg.norm(traj[:, 4:] - gt[:, 4:], axis=1)
    log(f'  scans/s over {len(timed)} scans in chunks of {FLAG_CHUNK} '
        f'after {FLAG_KITTI_WARM} warm-up scans, a chunk and '
        f'warmup_closure_path: {rate:.4f} ({1000 / rate:.3f} ms a scan)')
    log(f'  detections {[d[:2] for d in runner.detections]}, rejected '
        f'{[d[:2] for d in runner.rejected_detections]}; error over '
        f'{len(traj)} scans: mean {err.mean():.6f} m, max {err.max():.6f} '
        f'm, final {err[-1]:.6f} m; K1/K2 launches {nn_launches}')
    totals = {}
    for topic in ('online.flush_detections', 'online.verify_closure',
                  'online.lc_cache_build', 'online.lc_solve_dispatch'):
        mean, _, count = stats.get(topic, (0.0, 0.0, 0))
        totals[topic] = (round(mean * count, 3), count)
    log('  benchmarker totals in the timed window (host ms, calls): '
        + json.dumps(totals))
    prof_out = profile_summary(prof, prof_wall, range(
        len(traj) - FLAG_CHUNK, len(traj)), top=12)
    log(f'  (the profiled chunk held '
        f'{"a manual verified closure" if manual else "a detection"})')
    if not runner.detections:
        raise AssertionError('flagship (b): no accepted detection')
    # One synchronized verification and closure solve, cached and cold
    # (a Woodbury build in the solve), each on its own clones of the
    # final state and cache, made before the clock starts.
    key_a, key_b, _, yaw = runner.detections[-1]
    w_T = detection_alignment(runner.state, key_a, key_b, yaw).cuda()
    verify_ms = sync_ms(lambda: online.verify_closure(
        runner.state, runner.archive, key_a, key_b, w_T, cfg).cpu(), 3)
    cache = runner._lc_solver_cache()
    clones = [(clone_state(runner.state), sv.clone_cache(cache))
              for _ in range(8)]

    def cached_closure():
        state, c = clones.pop()
        return online.online_loop_closure_refined_cached(
            state, runner.archive, c, key_a, key_b, w_T, cfg)

    def cold_closure():
        return online.online_loop_closure_refined(
            clones.pop()[0], runner.archive, key_a, key_b, w_T, cfg)

    cached_ms = sync_ms(cached_closure, 3)
    cold_ms = sync_ms(cold_closure, 3)
    log(f'  one closure (ms, synchronized, mean of 3): verify_closure '
        f'{verify_ms:.3f}, refined + cached solve {cached_ms:.3f}, refined '
        f'+ cold solve {cold_ms:.3f}')
    if not (err.max() < 0.35 and err[-1] < 0.15):
        raise AssertionError(f'flagship (b): error out of bounds (max '
                             f'{err.max()}, final {err[-1]})')
    if nn_launches:
        raise AssertionError(f'flagship (b): K1/K2 launched {nn_launches} '
                             'times')
    out.update(kitti_pr_scans_per_s=rate,
               kitti_pr_detections=len(runner.detections),
               kitti_pr_rejected=len(runner.rejected_detections),
               kitti_pr_err_mean_m=float(err.mean()),
               kitti_pr_err_max_m=float(err.max()),
               kitti_pr_err_final_m=float(err[-1]),
               verify_ms=verify_ms, closure_cached_ms=cached_ms,
               closure_cold_ms=cold_ms)
    if prof_out is not None:
        out.update(prof_out)
    log(f'  phase 9 (b) took {time.perf_counter() - t_b:.1f} s')
    log('  flagship: ' + json.dumps(out))
    return frames16


def in_frame(anchor_est, anchor_gt, gts):
    """Where the poses of ground truth ``gts`` [n,7] belong in the frame
    in which the pose of ground truth ``anchor_gt`` is estimated at
    ``anchor_est``: anchor_est anchor_gt^-1 gts (bench.py:1196-1205)."""
    from laser_slam_tpu_torch.ops import se3
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    C = se3.compose(t(anchor_est), se3.inverse(t(anchor_gt)))
    return se3.compose(C[None], t(gts).reshape(-1, 7)).numpy()


def rendezvous(runner, gts, ta, tb):
    """The link of bench.py:1166-1181 between tracks ta and tb: their
    closest ground-truth co-location and its world-frame alignment from
    the true relative pose and the estimates.  Returns (key_a, key_b,
    index of key_a in track ta, w_T_a_b)."""
    from laser_slam_tpu_torch.ops import se3
    from laser_slam_tpu_torch.pipeline import online
    keys = [[k for k, (t, _) in enumerate(runner.key_info) if t == tid]
            for tid in range(runner.n_tracks)]
    d = np.linalg.norm(gts[ta][:, None, 4:] - gts[tb][None, :, 4:], axis=-1)
    ia, ib = np.unravel_index(np.argmin(d), d.shape)
    ka, kb = keys[ta][ia], keys[tb][ib]
    poses = online.extract_trajectory(runner.state)
    target = in_frame(poses[ka], gts[ta][ia], gts[tb][ib])[0]
    w_T = se3.compose(torch.tensor(target),
                      se3.inverse(torch.tensor(poses[kb]))).numpy()
    return ka, kb, ia, w_T


def mr_feed(runner, streams, lo, hi, chunk=None, per_scan=False):
    """Scans lo..hi-1 of every track, interleaved per scan, or in chunks
    of ``chunk`` a track (bench.py:1128-1155); ``per_scan`` feeds the
    chunks' scans one call each, in the chunks' key order."""
    step = chunk or 1
    for k in range(lo, hi, step):
        for t, s in enumerate(streams):
            frames = [(f.time_ns + t, f.points, f.odom_pose7)
                      for f in s[k:k + step]]
            if chunk and not per_scan:
                runner.process_scans(frames, track_id=t, chunk_size=chunk)
            else:
                for frame in frames:
                    runner.process_scan(*frame, track_id=t)


def multirobot_phase(nk, streams, dev='cuda'):
    """Phase 10: multi-robot SLAM (slice 4) through OnlineRunner: (a)
    bench.py's two-robot leg with a map per track, its rendezvous link
    and refine, (b) four robots with chained links, (c) marginal
    covariances on (a)'s linked graph."""
    from laser_slam_tpu_torch.config import (MULTIROBOT_RUNNER, WorkerConfig,
                                             multirobot_config)
    from laser_slam_tpu_torch.ops import se3
    from laser_slam_tpu_torch.pipeline import online
    cfg = multirobot_config()
    map_cfg = WorkerConfig()
    out = {}
    t_phase = time.perf_counter()

    def new_runner(n_tracks=2, maps=True):
        return online.OnlineRunner(
            cfg, **dict(MULTIROBOT_RUNNER, n_tracks=n_tracks),
            map_config=map_cfg if maps else None, device=dev)

    def track_poses(runner, tid):
        return np.stack(list(runner.trajectory(tid).values()))

    # (a) Two robots at 16k density: per scan, then in chunks.
    st, waited = fetched(streams, 'multirobot')
    gts = [np.stack([f.gt_pose7 for f in s[:MR_PER_SCAN]]) for s in st]
    log(f'multirobot (a): 2 x {MR_SCANS} beam scans of 64 x 256 (one lap '
        'of a 20 m circle centred at (6t, 4t), seeds 31-32, one scene), '
        f'made by a helper process ({waited:.1f} s waited for them); the '
        f'per-scan run takes the first {MR_PER_SCAN} a track')
    nk.nn_indices.launches = 0
    nk.nn_indices_pruned.launches = 0
    runner = new_runner()
    mr_feed(runner, st, 0, MR_WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mr_feed(runner, st, MR_WARM, MR_PER_SCAN)
    torch.cuda.synchronize()
    rate = 2 * (MR_PER_SCAN - MR_WARM) / (time.perf_counter() - t0)
    chunked = new_runner()
    mr_feed(chunked, st, 0, MR_WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mr_feed(chunked, st, MR_WARM, MR_CHUNKED - MR_CHUNK, MR_CHUNK)
    torch.cuda.synchronize()
    n_chunked = 2 * (MR_CHUNKED - MR_CHUNK - MR_WARM)
    rate_c = n_chunked / (time.perf_counter() - t0)
    # Device activity only, as in phases 8 and 9.
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        t0 = time.perf_counter()
        mr_feed(chunked, st, MR_CHUNKED - MR_CHUNK, MR_CHUNKED, MR_CHUNK)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    log(f'  scans/s over {2 * (MR_PER_SCAN - MR_WARM)} scans per scan after '
        f'{MR_WARM} warm-up scan pairs: {rate:.4f} ({1000 / rate:.3f} ms a '
        f'scan); in chunks of {MR_CHUNK} a track, over {n_chunked} scans '
        f'after the same warm-up: {rate_c:.4f}')
    prof_out = profile_summary(prof, prof_wall,
                               range(2 * MR_CHUNKED - 2 * MR_CHUNK,
                                     2 * MR_CHUNKED), top=8)
    # The chunks give their scans other keys than the interleaved run
    # (8 a track at a time), so the window solves see other poses: the
    # chunked run is held to per-scan calls in its own key order.
    ordered = new_runner(maps=False)
    mr_feed(ordered, st, 0, MR_WARM)
    mr_feed(ordered, st, MR_WARM, MR_CHUNKED, MR_CHUNK, per_scan=True)
    gap = [pose_gaps(track_poses(ordered, t), track_poses(chunked, t))
           for t in range(2)]
    log(f'  chunked vs per scan in the same key order (m, deg) by track: '
        f'{gap}')
    if max(g[0] for g in gap) > CHUNK_ATOL_M or \
            max(g[1] for g in gap) > CHUNK_ATOL_DEG:
        raise AssertionError('multirobot (a): chunked and per-scan runs '
                             'differ')

    # The rendezvous link on the per-scan run, then the refine.
    ka, kb, ia, w_T = rendezvous(runner, gts, 0, 1)
    runner.warmup_closure_path(use_association=True)
    lasts = runner.state.track_last_key.long()
    old_lasts = runner.state.traj_poses[lasts].cpu()
    maps = [runner.mapper.full_map(t) for t in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if not runner.add_loop_closure(ka, kb, w_T):
        raise AssertionError('multirobot (a): the link was not injected')
    torch.cuda.synchronize()
    link_ms = 1e3 * (time.perf_counter() - t0)
    new_lasts = runner.state.traj_poses[lasts].cpu()
    absorbed_w = float(runner.state.prior_weight[1])
    moved, map_err = [], []
    for t in range(2):
        C = se3.compose(new_lasts[t], se3.inverse(old_lasts[t]))
        want = se3.apply(C, torch.tensor(maps[t])).numpy()
        got = runner.mapper.full_map(t)
        map_err.append(float(np.abs(got - want).max()))
        moved.append(float(np.linalg.norm(want - maps[t], axis=1).mean()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.refine(2, gn_iterations=6, pcg_iterations=128, pcg_tolerance=1e-8)
    torch.cuda.synchronize()
    refine_ms = 1e3 * (time.perf_counter() - t0)
    # The link's cold solve alone (3 GN x 32 PCG, the scatter matvec:
    # no factor of interleaved tracks lies on the chain) as refine(1) on
    # a clone of the linked state, under the profiler.
    linked_state = runner.state
    runner.state = clone_state(linked_state)
    prof_s = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CUDA])
    with prof_s:
        t0 = time.perf_counter()
        runner.refine(1)
        torch.cuda.synchronize()
        solve_wall = time.perf_counter() - t0
    runner.state = linked_state
    log(f'  one cold solve of the linked graph (refine(1) on a clone, '
        f'{1e3 * solve_wall:.3f} ms with the profiler on):')
    solve_prof = profile_summary(
        prof_s, solve_wall, range(1), top=8,
        focus=(('index_add_ (the scatter matvec, gradient, blocks)',
                ('indexFunc',)),
               ('gathers', ('index_elementwise', 'gather'))))
    poses = online.extract_trajectory(runner.state)
    keys = [[k for k, (t, _) in enumerate(runner.key_info) if t == tid]
            for tid in range(2)]
    linked = np.linalg.norm(in_frame(poses[ka], gts[0][ia], gts[1])[:, 4:]
                            - poses[keys[1]][:, 4:], axis=1)
    own = []
    for t in range(2):
        est = poses[keys[t]]
        own.append(np.linalg.norm(in_frame(est[0], gts[t][0], gts[t])[:, 4:]
                                  - est[:, 4:], axis=1))
    log(f'  link ({ka}, {kb}) at the closest co-location: {link_ms:.3f} ms '
        f'(synchronized, after warmup_closure_path); refine {refine_ms:.3f} '
        f'ms; absorbed prior weight {absorbed_w}')
    log(f'  linked-map ATE: mean {linked.mean():.6f} m, max '
        f'{linked.max():.6f} m; own error by track (mean, max, final): '
        + str([(float(e.mean()), float(e.max()), float(e[-1])) for e in own]))
    log(f'  maps after the link against their own correction: max '
        f'{map_err} m over {[len(m) for m in maps]} points; mean move '
        f'{moved} m')
    if absorbed_w != 0.0:
        raise AssertionError('multirobot (a): the absorbed prior is active')
    if not (linked.mean() < 0.10 and linked.max() < 0.35):
        raise AssertionError('multirobot (a): linked-map ATE out of bounds')
    for e in own:
        if not (e.max() < 0.35 and e[-1] < 0.15):
            raise AssertionError('multirobot (a): a track\'s error is out '
                                 'of bounds')
    if max(map_err) > 1e-3 or not (moved[0] < 1.0
                                   and 50.0 < moved[1] < 150.0):
        raise AssertionError('multirobot (a): a map did not follow its '
                             'own track')
    out.update(scans_per_s=rate, chunked_scans_per_s=rate_c,
               link_ms=link_ms, refine_ms=refine_ms,
               linked_ate_mean_m=float(linked.mean()),
               linked_ate_max_m=float(linked.max()),
               own_err_max_m=[float(e.max()) for e in own],
               own_err_final_m=[float(e[-1]) for e in own],
               map_err_m=max(map_err), chunked_gap_m=max(g[0] for g in gap))
    if prof_out is not None:
        out.update(prof_out)
    if solve_prof is not None:
        out['solve_profile'] = solve_prof
    log(f'  phase 10 (a) took {time.perf_counter() - t_phase:.1f} s')

    # (b) Four robots, chained links A-B, C-D, B-C.
    t_b = time.perf_counter()
    st4, _ = fetched(streams, 'multirobot4')
    gts4 = [np.stack([f.gt_pose7 for f in s]) for s in st4]
    r4 = new_runner(4, maps=False)
    mr_feed(r4, st4, 0, MR4_SCANS)
    for ta, tb in ((0, 1), (2, 3), (1, 2)):
        a, b, _, w = rendezvous(r4, gts4, ta, tb)
        if not r4.add_loop_closure(a, b, w):
            raise AssertionError(f'multirobot (b): link {ta}-{tb} refused')
        log(f'  link {ta}-{tb} at keys ({a}, {b}): groups '
            f'{r4._linked_groups}')
    r4.refine(2, gn_iterations=6, pcg_iterations=128, pcg_tolerance=1e-8)
    weights = r4.state.prior_weight[:4].cpu().numpy()
    p4 = online.extract_trajectory(r4.state)
    keys4 = [[k for k, (t, _) in enumerate(r4.key_info) if t == tid]
             for tid in range(4)]
    err4 = [float(np.linalg.norm(
        in_frame(p4[keys4[0][0]], gts4[0][0], gts4[t])[:, 4:]
        - p4[keys4[t]][:, 4:], axis=1).max()) for t in range(4)]
    log(f'  four robots: prior weights {weights.tolist()}, max error by '
        f'track in track 0\'s frame {err4} m ({time.perf_counter() - t_b:.1f}'
        ' s)')
    if len(r4._linked_groups) != 1 or weights.tolist() != [1, 0, 0, 0]:
        raise AssertionError('multirobot (b): the links did not merge all '
                             'tracks under track 0\'s prior')
    if max(err4) >= 0.5:
        raise AssertionError('multirobot (b): a track is off its place')
    out.update(four_robot_err_max_m=max(err4))

    # (c) Marginal covariances on (a)'s linked graph.  The well-observed
    # keys: track 0's first 9 scans and the scans within 8 of a link key
    # on its own track.  The probes at the config's 32 PCG iterations
    # are timed and their gap reported; no factor of interleaved tracks
    # lies on the preconditioner's chain, so the gate holds the probes
    # at MR_COV_PCG iterations, enough to converge them on this graph,
    # to the exact path.
    n = len(runner.key_info)
    pos = {k: i for t in range(2) for i, k in enumerate(keys[t])}
    track = {k: t for t in range(2) for k in keys[t]}
    near = [k for k in range(n)
            if (track[k] == 0 and pos[k] <= 8)
            or any(track[k] == track[c] and abs(pos[k] - pos[c]) <= 8
                   for c in (ka, kb))]
    keys8 = np.array(sorted({keys[0][1], keys[0][4], keys[0][8], ka,
                             keys[0][pos[ka] - 4], kb, keys[1][pos[kb] - 1],
                             keys[1][min(pos[kb] + 4, len(keys[1]) - 1)]}))
    keys64 = np.unique(np.linspace(1, n - 1, 64).round().astype(int))
    cov_out = {}
    for keys_c in (keys8, keys64):
        K = len(keys_c)
        probe = runner.marginal_covariances(keys_c)
        exact = runner.marginal_covariances(keys_c, exact=True)
        p_ms = sync_ms(lambda: runner.marginal_covariances(keys_c), 3)
        e_ms = sync_ms(lambda: runner.marginal_covariances(keys_c,
                                                           exact=True), 3)
        runner.config = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, pcg_iterations=MR_COV_PCG))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        conv = runner.marginal_covariances(keys_c)
        c_ms = 1e3 * (time.perf_counter() - t0)
        runner.config = cfg
        if not all(np.all(np.isfinite(c)) for c in (probe, exact, conv)):
            raise AssertionError('multirobot (c): non-finite covariance')
        scale = np.abs(exact).max(axis=(1, 2), keepdims=True)
        asym = {label: float((np.abs(c - np.swapaxes(c, -1, -2))
                              / scale).max())
                for label, c in (('probes', probe), ('converged', conv),
                                 ('exact', exact))}
        min_eig = float(min(np.linalg.eigvalsh(c).min() / np.abs(c).max()
                            for c in exact))
        good = np.isin(keys_c, near)

        def excess(c):
            return float((np.abs(c[good] - exact[good])
                          - 2e-3 * np.abs(exact[good])).max())

        gap_out = (float((np.abs(conv[~good] - exact[~good])
                          / scale[~good]).max()) if (~good).any() else 0.0)
        log(f'  K = {K} ({int(good.sum())} well-observed): probes '
            f'{p_ms:.3f} ms a call ({p_ms / K:.4f} ms a key), exact '
            f'{e_ms:.3f} ms ({e_ms / K:.4f} ms a key), probes at '
            f'{MR_COV_PCG} PCG iterations {c_ms:.3f} ms (one call); '
            f'excess over rtol 2e-3 on the well-observed keys: probes '
            f'{excess(probe):.3e}, at {MR_COV_PCG} iterations '
            f'{excess(conv):.3e} (limit atol 1e-5); largest gap elsewhere '
            f'at {MR_COV_PCG} iterations {gap_out:.3e} of the key\'s '
            f'largest entry; asymmetry {asym}; exact min eigenvalue '
            f'{min_eig:.3e} of the largest entry')
        if (max(asym['converged'], asym['exact']) > 1e-3 or min_eig < -1e-9
                or excess(conv) > 1e-5):
            raise AssertionError(f'multirobot (c): covariances at K = {K} '
                                 'out of bounds')
        cov_out[K] = dict(probe_ms=p_ms, exact_ms=e_ms, converged_ms=c_ms,
                          probe_ms_per_key=p_ms / K,
                          exact_ms_per_key=e_ms / K,
                          probe_excess=excess(probe),
                          converged_excess=excess(conv),
                          gap_elsewhere=gap_out)
    out['covariances'] = cov_out
    nn_launches = nk.nn_indices.launches + nk.nn_indices_pruned.launches
    if nn_launches:
        raise AssertionError(f'multirobot: K1/K2 launched {nn_launches} '
                             'times')
    log(f'  phase 10 took {time.perf_counter() - t_phase:.1f} s')
    log('  multirobot: ' + json.dumps(out))


def host_api_phase(nk, frames, smi, online_lap=None, flag_frames=None):
    """Phase 11: the host API (slice 5) at slice1_config()'s full width:
    ``LaserSlamWorker`` + ``IncrementalEstimator`` over the first lap of
    phase 5's stream through ``replay.run_worker_on_stream``, a refined
    closure of its first and last scans, the checkpoint round trip of the
    estimator and its worker at scan 24, and the flagship runner's
    online checkpoint at scan 32 of phase 9a's stream.  ``online_lap`` is
    phase 5's OnlineRunner trajectory after the same scans (a fresh runner
    makes it when None); ``flag_frames`` phase 9a's frames (made again when
    None).  Returns the numbers it logged."""
    import tempfile
    from laser_slam_tpu_torch.config import (FLAGSHIP_RUNNER, Config,
                                             WorkerConfig, flagship_config,
                                             flagship_place_recognition,
                                             slice1_config)
    from laser_slam_tpu_torch.core import checkpoint as ck
    from laser_slam_tpu_torch.core.estimator import IncrementalEstimator
    from laser_slam_tpu_torch.core.types import RelativePose
    from laser_slam_tpu_torch.ops import cloud as pc, se3
    from laser_slam_tpu_torch.pipeline import online, replay
    from laser_slam_tpu_torch.pipeline.worker import LaserSlamWorker
    t_phase = time.perf_counter()
    out = {}
    lap = frames[:HOST_SCANS]
    gt = np.stack([f.gt_pose7 for f in lap])
    cfg = Config(estimator=slice1_config(),
                 worker=WorkerConfig(minimum_distance_to_add_pose=0.0))
    if online_lap is None:
        runner = online.OnlineRunner(cfg.estimator, pose_capacity=128,
                                     factor_capacity=512, device='cuda')
        for f in lap:
            runner.process_scan(f.time_ns, f.points, f.odom_pose7)
        online_lap = runner.trajectory()
    tmp = tempfile.TemporaryDirectory()
    est_path = os.path.join(tmp.name, 'host_api.npz')
    flag_path = os.path.join(tmp.name, 'flagship.npz')

    # (1) The lap through the host API, a checkpoint after scan 24.
    log(f'host API: LaserSlamWorker(IncrementalEstimator(slice1_config())) '
        f'on cuda, {HOST_SCANS} scans of phase 5\'s stream')
    est = IncrementalEstimator(cfg.estimator, 1, device='cuda')
    worker = LaserSlamWorker(cfg.worker, est)
    torch.cuda.synchronize()
    nk.nn_indices.launches = 0
    nk.nn_indices_pruned.launches = 0
    scan_s = []

    def timed_scans(w, fs):
        for f in fs:
            t0 = time.perf_counter()
            replay.run_worker_on_stream(w, [f])
            torch.cuda.synchronize()
            scan_s.append(time.perf_counter() - t0)

    timed_scans(worker, lap[:HOST_SAVE_AT])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save_checkpoint(est_path, est, [worker])
    save_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    est2, (worker2,) = ck.load_checkpoint(est_path, cfg, device='cuda')
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t0)
    # Arrays read back after the round trip: bit-equal.
    t_a, t_b = est.laser_tracks[0], est2.laser_tracks[0]
    same = (np.array_equal(est.pose_values(), est2.pose_values())
            and all(np.array_equal(getattr(est.graph, n),
                                   getattr(est2.graph, n))
                    for n in ('rel_meas', 'rel_keys', 'rel_sqrt_info',
                              'rel_weight', 'prior_meas', 'prior_weight'))
            and all(torch.equal(a.cloud.points, b.cloud.points)
                    and torch.equal(a.cloud.mask, b.cloud.mask)
                    and torch.equal(a.normals, b.normals)
                    for a, b in zip(t_a.scans, t_b.scans))
            and all(torch.equal(getattr(t_a, n), getattr(t_b, n))
                    for n in ('_ring_points', '_ring_mask', '_ring_normals'))
            and np.array_equal(worker._map_points[:worker._map_count],
                               worker2._map_points[:worker2._map_count]))
    if not same:
        raise AssertionError('host API: the checkpoint did not read back '
                             'bit-equal')
    timed_scans(worker, lap[HOST_SAVE_AT:])
    k2_lap = nk.nn_indices_pruned.launches
    traj = worker.get_trajectory()
    est_lap = np.stack([traj[f.time_ns] for f in lap])
    warm = scan_s[HOST_WARM:]
    rate = len(warm) / sum(warm)
    err = np.linalg.norm(est_lap[:, 4:] - gt[:, 4:], axis=1)
    on = np.stack([online_lap[f.time_ns] for f in lap])
    on_dt, on_dr = pose_gaps(est_lap, on)
    log(f'  {smi}: {rate:.4f} scans/s after {HOST_WARM} warm-up scans '
        f'({1e3 * np.mean(warm):.3f} ms a scan mean, {1e3 * max(warm):.3f} '
        f'max), K2 {k2_lap} launches ({k2_lap / (HOST_SCANS - 1):.1f} a '
        f'scan), K1 {nk.nn_indices.launches}; error to ground truth mean '
        f'{err.mean():.6f} m, max {err.max():.6f} m, final {err[-1]:.6f} m; '
        f'against the OnlineRunner on the same scans {on_dt:.3e} m, '
        f'{on_dr:.3e} deg (limit {HOST_ONLINE_ATOL_M} m)')
    log(f'  {smi}: save_checkpoint {save_ms:.3f} ms, load_checkpoint '
        f'{load_ms:.3f} ms ({HOST_SAVE_AT} scans, '
        f'{os.path.getsize(est_path) / 2 ** 20:.1f} MiB); read back '
        'bit-equal')
    if k2_lap <= 0 or nk.nn_indices.launches:
        raise AssertionError('host API: K2 must launch in every scan\'s ICP '
                             f'and K1 never (K2 {k2_lap}, K1 '
                             f'{nk.nn_indices.launches})')
    if on_dt > HOST_ONLINE_ATOL_M:
        raise AssertionError('host API: more than 2 cm from the '
                             'OnlineRunner on the same scans')

    # The resumed run against the uninterrupted one, before the closure.
    replay.run_worker_on_stream(worker2, lap[HOST_SAVE_AT:])
    traj2 = worker2.get_trajectory()
    res_dt, res_dr = pose_gaps(
        est_lap, np.stack([traj2[f.time_ns] for f in lap]))
    log(f'  resumed at scan {HOST_SAVE_AT} vs uninterrupted: {res_dt:.3e} m, '
        f'{res_dr:.3e} deg (limits {RESUME_ATOL_M} m, {RESUME_ATOL_DEG} deg)')
    if not (res_dt <= RESUME_ATOL_M and res_dr <= RESUME_ATOL_DEG):
        raise AssertionError('host API: the resumed run left the '
                             'uninterrupted one')

    # (2) Close scan 0 to the lap's last scan: a refined closure.
    w_T = measured_closure(lap, traj, 0, HOST_SCANS - 1, se3, torch)
    k2_before = nk.nn_indices_pruned.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.process_loop_closure(RelativePose(
        T_a_b=w_T, time_a_ns=lap[0].time_ns, time_b_ns=lap[-1].time_ns))
    torch.cuda.synchronize()
    closure_ms = 1e3 * (time.perf_counter() - t0)
    k2_closure = nk.nn_indices_pruned.launches - k2_before
    traj = worker.get_trajectory()
    closed = np.stack([traj[f.time_ns] for f in lap])
    err_c = np.linalg.norm(closed[:, 4:] - gt[:, 4:], axis=1)
    log(f'  {smi}: refined closure (0, {HOST_SCANS - 1}) {closure_ms:.3f} ms '
        f'({k2_closure} K2 launches, submaps of '
        f'{2 * cfg.estimator.loop_closures_sub_maps_radius + 1} x '
        f'{cfg.estimator.laser_track.input_filters.scan_capacity} points at '
        f'most); error after it mean {err_c.mean():.6f} m, max '
        f'{err_c.max():.6f} m, final {err_c[-1]:.6f} m')
    if k2_closure <= 0 or nk.nn_indices.launches:
        raise AssertionError('host API: the refined closure did not run K2')
    if not (np.all(np.isfinite(closed)) and err_c.max() < 0.35
            and err_c[-1] < 0.15):
        raise AssertionError(f'host API: error out of bounds (max '
                             f'{err_c.max()}, final {err_c[-1]})')
    # K2 at the refinement's largest submaps (2 x radius + 1 scans a side,
    # which closures away from a track's ends reach), against its plain
    # version; launched after the counts were read.
    radius = cfg.estimator.loop_closures_sub_maps_radius
    mid = HOST_SCANS // 2
    sub_a, _ = t_a.build_submap_around_time(lap[mid - 1].time_ns, radius)
    sub_b, _ = t_a.build_submap_around_time(lap[mid].time_ns, radius)
    q_dev = sub_b.points.device
    rel = se3.compose(se3.inverse(torch.tensor(traj[lap[mid - 1].time_ns])),
                      torch.tensor(traj[lap[mid].time_ns])).to(q_dev)
    q = pc.transform(rel, sub_b).points
    pref = nk.build_pruned_ref(sub_a.points)
    d2_k, idx_k = nk.nn_indices_pruned(q, pref, CUTOFF)
    d2_p, idx_p = nk.nn_indices_pruned_plain(q, pref, CUTOFF)
    inside = d2_p <= CUTOFF ** 2
    n_sub = sub_a.points.shape[0]
    check_nn(f'K2 at the refinement\'s capacity, {q.shape[0]} x {n_sub}',
             q, pref.points, d2_k, idx_k, d2_p, idx_p, rows=inside,
             ties=True)
    if bool(torch.any(d2_k[~inside] <= CUTOFF ** 2)) or n_sub != (
            (2 * radius + 1) * cfg.estimator.laser_track.input_filters
            .scan_capacity):
        raise AssertionError('host API: K2 at the refinement\'s capacity')
    # Its time there (the torch.sort route of the set-up, by size) in
    # turns with the torch tables it ran on before.
    k2_refine = {'setup on the card': [], 'torch tables': []}
    for key in ('setup on the card', 'torch tables', 'torch tables',
                'setup on the card'):
        k2_refine[key].append(event_ms(
            (lambda: nk.nn_indices_pruned(q, pref, CUTOFF))
            if key == 'setup on the card' else
            (lambda: nk._launch_pruned(nk.pruned_tables(q, pref, CUTOFF),
                                       pref, CUTOFF)), 5))
    k2_refine = {k: float(np.mean(v)) for k, v in k2_refine.items()}
    log(f'  {smi}: K2 at {q.shape[0]} x {n_sub}, ms a call (two turns '
        'each): ' + ', '.join(f'{k} {v:.4f}' for k, v in k2_refine.items()))
    out.update(scans_per_s=rate, ms_per_scan=1e3 * float(np.mean(warm)),
               k2_launches=k2_lap + k2_closure,
               k2_launches_per_scan=k2_lap / (HOST_SCANS - 1),
               closure_ms=closure_ms, closure_k2_launches=k2_closure,
               k2_refine_ms=k2_refine,
               save_ms=save_ms, load_ms=load_ms, err_max_m=float(err_c.max()),
               err_final_m=float(err_c[-1]), vs_online_m=on_dt,
               resume_m=res_dt, resume_deg=res_dr)

    # (3) The flagship runner through its online checkpoint at scan 32.
    if flag_frames is None:
        flag_frames = beam_frames(n_scans=FLAG_SCANS, n_azimuth=256,
                                  seed=21, **FLAG_CIRCLE)
    fcfg = flagship_config(16384, 16384, 512, 256)
    pr = flagship_place_recognition()
    run_a = online.OnlineRunner(fcfg, place_recognition=pr, device='cuda',
                                **FLAGSHIP_RUNNER)
    for f in flag_frames[:FLAG_SAVE_AT]:
        run_a.process_scan(f.time_ns, f.points, f.odom_pose7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save_online_checkpoint(flag_path, run_a)
    fsave_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    run_c = ck.load_online_checkpoint(flag_path, fcfg,
                                      place_recognition=pr, device='cuda')
    torch.cuda.synchronize()
    fload_ms = 1e3 * (time.perf_counter() - t0)
    for r in (run_a, run_c):
        for f in flag_frames[FLAG_SAVE_AT:]:
            r.process_scan(f.time_ns, f.points, f.odom_pose7)
    ta, tc = run_a.trajectory(), run_c.trajectory()
    f_dt, f_dr = pose_gaps(np.stack([ta[f.time_ns] for f in flag_frames]),
                           np.stack([tc[f.time_ns] for f in flag_frames]))
    pairs = [[d[:2] for d in r.detections] for r in (run_a, run_c)]
    log(f'  {smi}: flagship save_online_checkpoint {fsave_ms:.3f} ms, load '
        f'{fload_ms:.3f} ms ({os.path.getsize(flag_path) / 2 ** 20:.1f} MiB);'
        f' detections {pairs[0]} uninterrupted, {pairs[1]} resumed; poses '
        f'{f_dt:.3e} m, {f_dr:.3e} deg apart')
    if pairs[0] != pairs[1] or not pairs[0]:
        raise AssertionError('host API: the resumed flagship runner found '
                             'other detections')
    if not (f_dt <= RESUME_ATOL_M and f_dr <= RESUME_ATOL_DEG):
        raise AssertionError('host API: the resumed flagship runner left '
                             'the uninterrupted one')
    tmp.cleanup()
    out.update(flagship_save_ms=fsave_ms, flagship_load_ms=fload_ms,
               flagship_detections=len(pairs[0]), flagship_resume_m=f_dt,
               flagship_resume_deg=f_dr)
    log(f'  phase 11 took {time.perf_counter() - t_phase:.1f} s')
    log('  host API: ' + json.dumps(out))
    return out


def fleet_phase(nk, smi, bound):
    """Phase 12: fleet mode and the batched serving path
    (``parallel/fleet.py``) at bench.py's full width, and the kernel
    checks of K1L/K2L.  Returns the kernels' record entries."""
    import dataclasses as dc
    from laser_slam_tpu_torch.config import (SolverConfig, IcpConfig,
                                             fleet_icp_config,
                                             serving_icp_config)
    from laser_slam_tpu_torch.graph import factors as fg
    from laser_slam_tpu_torch.graph import solver as sv
    from laser_slam_tpu_torch.ops import cloud as pc, icp as icp_mod, se3
    from laser_slam_tpu_torch.parallel import fleet
    from laser_slam_tpu_torch.pipeline import replay
    t_phase = time.perf_counter()
    dev = torch.device('cuda')

    # Data as bench.py makes it (seed 0; bench.py draws other data from
    # the same generator between the serving and the fleet inputs).
    rng = np.random.default_rng(0)
    world = replay.make_scene(rng)
    pose0 = np.array([0.0, 0.0, 1.8])
    ref_np = replay.sample_scan(rng, world, pose0, SERVE_REF)
    offsets, readings_np = [], []
    for _ in range(SERVE_N):
        dp = pose0 + rng.normal(size=3) * np.array([0.5, 0.5, 0.02])
        offsets.append(dp - pose0)
        readings_np.append(replay.sample_scan(rng, world, dp, SERVE_READ))
    ref = pc.make_cloud(ref_np, capacity=SERVE_REF, device=dev)
    t0 = time.perf_counter()
    normals = pc.estimate_normals(ref, knn=10)
    torch.cuda.synchronize()
    log(f'phase 12 (a) serving: reference {SERVE_REF} points, kNN(10) '
        f'normals in {time.perf_counter() - t0:.2f} s, {SERVE_N} readings '
        f'of {SERVE_READ} points ({smi})')
    readings = [pc.make_cloud(r, capacity=SERVE_READ, device=dev)
                for r in readings_np]
    ident = se3.identity(device=dev)

    # Single-stream witnesses (bench.py:418-435): one reading a call.
    for matcher in ('projective', 'pallas', 'brute'):
        cfg = IcpConfig(matcher=matcher, reading_capacity=SERVE_READ,
                        reading_sampling_ratio=1.0,
                        max_correspondence_dist_m=3.0)
        icp_mod.icp(readings[0], ref, normals, ident, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [icp_mod.icp(rd, ref, normals, ident, cfg).T
                for rd in readings]
        torch.cuda.synchronize()
        rate = SERVE_N / (time.perf_counter() - t0)
        if not bool(torch.all(torch.isfinite(torch.stack(outs)))):
            raise AssertionError(f'serving {matcher}: non-finite poses')
        log(f'  single-stream icp {matcher}: {rate:.4f} pairs/s '
            f'({SERVE_N} readings, 40 fixed iterations a call)')

    # batched_icp at B = 32 with serving_icp_config(), 4 reps of distinct
    # inputs (bench.py:445-468).
    cfg_b = serving_icp_config(SERVE_READ)
    batches, picks = [], []
    for rep in range(SERVE_REPS):
        sel = [(i + rep * 3) % SERVE_N for i in range(SERVE_B)]
        picks.append(sel)
        batches.append((torch.stack([readings[i].points for i in sel]),
                        torch.stack([readings[i].mask for i in sel])))

    def serve(p, m):
        return fleet.batched_icp(p, m, ref, normals,
                                 ident.expand(p.shape[0], 7), cfg_b)

    serve(*batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [serve(*b) for b in batches[::-1]]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    out = outs[-1]
    rate_b = SERVE_B * SERVE_REPS / serve_s
    t_norm = torch.linalg.norm(out.T[:, 4:], dim=1)
    truth = torch.tensor(np.stack([offsets[i] for i in picks[0]]),
                         dtype=torch.float32, device=dev)
    err = torch.linalg.norm(out.T[:, 4:] - truth, dim=1)
    log(f'  batched_icp B={SERVE_B}: {rate_b:.4f} pairs/s '
        f'({1e3 * serve_s / SERVE_REPS:.3f} ms a call), mean translation '
        f'{float(t_norm.mean()):.4f} m, mean error to the true offset '
        f'{float(err.mean()):.4f} m (max {float(err.max()):.4f}), '
        f'{int(out.valid.sum())}/{SERVE_B} valid ({smi})')
    if not (bool(torch.all(torch.isfinite(out.T)))
            and float(err.mean()) < SERVE_TRUTH_M):
        raise AssertionError('batched_icp: solutions off the true offsets')
    for i in (0, SERVE_B - 1):
        one = icp_mod.icp_point_to_plane(readings[picks[0][i]], ref, normals,
                                         ident, cfg_b)
        gap = float(torch.max(torch.abs(one.T - out.T[i])))
        if gap > SERVE_LANE_ATOL or bool(one.valid) != bool(out.valid[i]):
            raise AssertionError(f'batched_icp lane {i}: {gap} from the '
                                 'same reading registered alone')
    p64 = torch.cat([batches[0][0], batches[1][0]])
    m64 = torch.cat([batches[0][1], batches[1][1]])
    ms64 = sync_ms(lambda: serve(p64, m64), 1)
    whole = serve(p64, m64)
    halves = [serve(p64[s], m64[s]) for s in (slice(0, 32), slice(32, 64))]
    gap = float(torch.max(torch.abs(
        whole.T - torch.cat([h.T for h in halves]))))
    if gap > SERVE_LANE_ATOL or not torch.equal(
            whole.valid, torch.cat([h.valid for h in halves])):
        raise AssertionError(f'batched_icp B=64: {gap} from two halves')
    log(f'  B=64 in one call: {ms64:.3f} ms ({64e3 / ms64:.4f} pairs/s), '
        f'poses within {gap:.3g} of two 32-lane halves')

    # (b) The fleet (bench.py:1212-1231).
    B, T, N = FLEET_B, FLEET_T, FLEET_N
    base_scan = replay.sample_scan(rng, world, pose0, N)
    fl_pts = np.zeros((B, T, N, 3), np.float32)
    for b in range(B):
        for t in range(T):
            jitter = rng.normal(size=(N, 3)).astype(np.float32) * 0.02
            fl_pts[b, t] = base_scan + jitter + np.array(
                [0.3 * t, 0.1 * b % 2.0, 0], np.float32)
    fl_norm = rng.normal(size=(B, T, N, 3)).astype(np.float32)
    fl_norm /= np.linalg.norm(fl_norm, axis=-1, keepdims=True)
    init_pose = np.zeros((B, 7), np.float32)
    init_pose[:, 0] = 1.0
    odom_rel = np.zeros((B, T, 7), np.float32)
    odom_rel[:, :, 0] = 1.0
    odom_rel[:, 1:, 4] = 0.3
    card = [torch.tensor(a, device=dev) for a in (
        fl_pts, np.ones((B, T, N), bool), fl_norm, init_pose, odom_rel)]
    card2 = [card[0] + 0.001] + card[1:]          # distinct timed input
    cfg_f = fleet_icp_config(N)
    runs = {'brute': cfg_f,
            'pallas K1L': dc.replace(cfg_f, matcher='pallas',
                                     pallas_prune=False),
            'pallas K2L': dc.replace(cfg_f, matcher='pallas',
                                     pallas_prune=True),
            'projective': dc.replace(cfg_f, matcher='projective')}
    log(f'phase 12 (b) fleet: B={B}, T={T}, N={N}, fleet_icp_config() '
        f'and its matchers ({smi})')
    nk.nn_indices_lanes.launches = 0
    nk.nn_indices_pruned_lanes.launches = 0
    single = (nk.nn_indices.launches, nk.nn_indices_pruned.launches)
    res, rates = {}, {}
    for label, cfg in runs.items():
        fleet.fleet_icp_odometry(*card, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[label] = fleet.fleet_icp_odometry(*card2, cfg)
        torch.cuda.synchronize()
        rates[label] = B * (T - 1) / (time.perf_counter() - t0)
    k1 = res['pallas K1L'].poses.reshape(-1, 7).cpu().numpy()
    for label, r in res.items():
        if not bool(torch.all(torch.isfinite(r.poses))):
            raise AssertionError(f'fleet {label}: non-finite poses')
        dt, dr = pose_gaps(r.poses.reshape(-1, 7).cpu().numpy(), k1)
        limit = FLEET_PROJ_GAP if label == 'projective' else FLEET_EXACT_GAP
        log(f'  fleet_icp_odometry {label}: {rates[label]:.4f} pairs/s, '
            f'{int(r.valid.sum())}/{B * T} valid, largest gap to the K1L '
            f'run {dt:.3g} m / {dr:.3g} deg (bound {limit[0]} m / '
            f'{limit[1]} deg)')
        if dt > limit[0] or dr > limit[1]:
            raise AssertionError(f'fleet {label}: pose gap {dt} m / {dr} '
                                 'deg passes its bound')
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fleet.fleet_icp_odometry(*card2, runs['pallas K1L'])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    dev_ms = {e.key: e.self_device_time_total / 1e3 for e in rows}
    total = sum(dev_ms.values())
    k1l_dev = sum(v for k, v in dev_ms.items() if 'nn_items_kernel' in k)
    log(f'  profiler over one K1L fleet call: {device_launches(prof)} '
        f'device launches, {total:.3f} ms of device time in '
        f'{1e3 * wall:.3f} ms (busy {100 * total / (1e3 * wall):.2f}%), '
        f'K1L {k1l_dev:.3f} ms'
        + ('' if total > 0 else ' (no device time recorded: not measured)'))
    # Two lanes of the K1L run again on the CPU (plain versions).
    lanes = [0, B - 1]
    cpu = fleet.fleet_icp_odometry(*(a[lanes].cpu() for a in card2),
                                   runs['pallas K1L'])
    cpu_gap = float(np.max(np.abs(cpu.poses.numpy() - res[
        'pallas K1L'].poses[lanes].cpu().numpy())))
    log(f'  lanes {lanes} of the K1L run on the CPU: poses within '
        f'{cpu_gap:.3g}')
    if cpu_gap > POSE_ATOL:
        raise AssertionError('fleet K1L: card and CPU runs disagree')
    graphs, pose_mask = fleet.build_fleet_chain_graphs(
        res['pallas K1L'].rel_icp, res['pallas K1L'].valid, card[3],
        torch.full((6,), 0.01, device=dev))
    scfg = SolverConfig()
    solve_ms = sync_ms(lambda: fleet.fleet_solve(
        graphs, res['pallas K1L'].poses, pose_mask, scfg, offchain=1), 3)
    sol = fleet.fleet_solve(graphs, res['pallas K1L'].poses, pose_mask,
                            scfg, offchain=1)
    mid = B // 2
    one = sv.solve(fg.lane_graph(graphs, mid), res['pallas K1L'].poses[mid],
                   pose_mask[mid], scfg, offchain=1)
    lane_gap = float(torch.max(torch.abs(one.poses - sol.poses[mid])))
    log(f'  fleet_solve of build_fleet_chain_graphs(K1L run), {B} lanes x '
        f'{T} poses, SolverConfig(): {solve_ms:.3f} ms, error '
        f'{float(sol.error_initial.sum()):.4g} -> '
        f'{float(sol.error_final.sum()):.4g}, lane {mid} within '
        f'{lane_gap:.3g} '
        f'of its own solve ({smi})')
    if not (bool(torch.all(torch.isfinite(sol.poses)))
            and bool(torch.all(sol.error_final
                               <= sol.error_initial * 1.001 + 1e-6))
            and lane_gap < POSE_ATOL):
        raise AssertionError('fleet_solve: bad lanes')

    # (c) The maps (bench.py:1278-1294).
    jp = card[3]
    maps = fleet.init_fleet_maps(B, FLEET_MAP_CAP)
    for t in range(T):
        maps = fleet.fleet_accumulate(maps, card[0][:, t], card[1][:, t], jp)
    q0 = card[0][:, 0] + 0.01
    fleet.fleet_map_query(maps, q0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rep in range(1, FLEET_MAP_REPS + 1):
        idx_q, d2_q = fleet.fleet_map_query(maps, q0 + 0.001 * rep)
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    k1l_launches = nk.nn_indices_lanes.launches
    k2l_launches = nk.nn_indices_pruned_lanes.launches
    if (k1l_launches <= 0 or k2l_launches <= 0 or single != (
            nk.nn_indices.launches, nk.nn_indices_pruned.launches)):
        raise AssertionError(f'phase 12: K1L {k1l_launches}, K2L '
                             f'{k2l_launches} launches; K1/K2 launched')
    qps = B * N * FLEET_MAP_REPS / map_s
    map_plain_ms = event_ms(lambda: nk.nn_indices_lanes_plain(q0, maps.points),
                           1)
    map_ms = event_ms(lambda: fleet.fleet_map_query(maps, q0), 5)
    log(f'phase 12 (c) maps: {B} lanes of {FLEET_MAP_CAP}, {T} scans: '
        f'fleet_map_query {qps:.1f} queries/s through K1L ({map_ms:.4f} '
        f'ms a call by CUDA events), the plain path on the same maps '
        f'{map_plain_ms:.4f} ms a call ({B * N * 1e3 / map_plain_ms:.1f} '
        f'queries/s) ({smi})')
    maps2 = fleet.fleet_accumulate(maps, card[0][:, 1] + 0.05,
                                   card[1][:, 1], jp,
                                   voxel_size_m=FLEET_VOXEL_M)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    maps2 = fleet.fleet_accumulate(maps2, card[0][:, 2] + 0.05,
                                   card[1][:, 2], jp,
                                   voxel_size_m=FLEET_VOXEL_M)
    torch.cuda.synchronize()
    over_ms = 1e3 * (time.perf_counter() - t0)
    cur = maps2.cursor.cpu().numpy()
    if not (np.array_equal(cur, maps2.mask.sum(-1).cpu().numpy())
            and np.array_equal(cur, maps2.cursor_bound)
            and np.all(cur < FLEET_MAP_CAP)):
        raise AssertionError('fleet_accumulate: overflow not compacted')
    log(f'  overflow with voxel_size_m={FLEET_VOXEL_M}: {over_ms:.3f} ms '
        f'(one cursor read, {B} lanes compacted), cursors '
        f'{cur.min()}-{cur.max()} of {FLEET_MAP_CAP}')

    # Kernel checks of K1L/K2L against their plain versions (not counted).
    log('K1L nn_indices_lanes and K2L nn_indices_pruned_lanes vs plain:')
    q_b = se3.apply(card[4][:, 1, None, :], card[0][:, 1]).contiguous()
    r_b = card[0][:, 0].contiguous()
    shapes = [('fleet ICP', q_b, r_b), ('map query', q0, maps.points)]
    g = np.random.default_rng(12)
    odd_q = torch.tensor((g.normal(size=(5, 1000, 3)) * 5).astype(
        np.float32), device=dev)
    odd_r = torch.tensor((g.normal(size=(5, 9001, 3)) * 5).astype(
        np.float32), device=dev)
    odd_r[0, 5000:5040] = odd_r[0, 10:50]         # copies, later tile
    odd_q[0, :40] = odd_r[0, 10:50]
    odd_r[1, ::3] = pc.SENTINEL                   # parked rows
    shapes.append(('5 x 1000 x 9001, copies and parked rows', odd_q, odd_r))
    err1 = 0.0
    for label, q, r in shapes:
        d2_k, idx_k = nk.nn_indices_lanes(q, r)
        d2_p, idx_p = nk.nn_indices_lanes_plain(q, r)
        err1 = max(err1, check_nn(f'K1L {label}', q.reshape(-1, 3),
                                  r.reshape(-1, 3), d2_k.reshape(-1),
                                  idx_k.reshape(-1), d2_p.reshape(-1),
                                  idx_p.reshape(-1)))
    if not torch.equal(idx_k[0, :40].cpu(),
                       torch.arange(10, 50, dtype=torch.int32)):
        raise AssertionError('K1L: a later copy won')
    if bool(torch.any(idx_k[1] % 3 == 0)):
        raise AssertionError('K1L: a parked row won')
    clusters = g.uniform(-40, 40, size=(4, 16, 3))
    cl_r = torch.tensor((clusters[:, :, None] + g.normal(
        size=(4, 16, 1024, 3))).reshape(4, -1, 3), dtype=torch.float32,
        device=dev)
    cl_q = torch.tensor((clusters[:, :4, None] + g.normal(
        size=(4, 4, 512, 3))).reshape(4, -1, 3), dtype=torch.float32,
        device=dev)
    err2 = 0.0
    for label, q, r in [shapes[0], shapes[2],
                        ('4 clustered lanes, 2048 x 16384', cl_q, cl_r)]:
        pref = nk.build_pruned_ref_lanes(r)
        d2_k, idx_k = nk.nn_indices_pruned_lanes(q, pref, CUTOFF)
        d2_p, idx_p = nk.nn_indices_pruned_lanes_plain(q, pref, CUTOFF)
        torch.cuda.synchronize()
        inside = d2_p <= CUTOFF ** 2
        if bool(torch.any(d2_k[~inside] <= CUTOFF ** 2)):
            raise AssertionError(f'K2L {label}: beyond-cutoff query within')
        err2 = max(err2, check_nn(
            f'K2L {label}', q[inside], torch.cat(list(pref.points)),
            d2_k[inside], (idx_k + pref.points.shape[1] * torch.arange(
                q.shape[0], device=dev)[:, None])[inside], d2_p[inside],
            (idx_p + pref.points.shape[1] * torch.arange(
                q.shape[0], device=dev)[:, None])[inside], ties=True))
    # The clustered lanes are where K2L must skip tiles: at the fleet's
    # shape one reference tile holds a lane's 4096 points, so a K2L that
    # scans every pair would pass every other check.
    pref = nk.build_pruned_ref_lanes(cl_r)
    tables = nk.pruned_tables_lanes(cl_q, pref, CUTOFF)
    scanned = torch.zeros(tables[2].shape[:-1], dtype=torch.int32,
                          device=dev)
    nk._launch_pruned(tables, pref, CUTOFF, scanned=scanned)
    cl_share = int(scanned.sum()) * tables[4] / (
        cl_q.shape[0] * cl_q.shape[1] * cl_r.shape[1])
    log(f'  K2L on the 4 clustered lanes scanned {cl_share:.4f} of the '
        f'pairs')
    if not cl_share < 1.0:
        raise AssertionError(f'K2L skipped nothing on clustered lanes '
                             f'(scanned share {cl_share})')
    # K2L's set-up on the card against pruned_tables_lanes, lane by lane.
    err2 = max(err2, check_k2_setup(nk, [
        (f'K2L set-up, fleet ICP {B} lanes x {N} x {N}', q_b, r_b, None,
         nk._SORT_KEYS),
        ('K2L set-up, 4 clustered lanes', cl_q, cl_r, None,
         nk._SORT_KEYS)]))
    # K2L's reference tile: a lane of at most 4096 points is a single tile
    # at 4096 points, so nothing prunes.  The tile changes neither d2 nor
    # idx (the sorted reference does not depend on it): both times, and
    # the results of one held to the other's.
    rb_ms, rb_share = {}, {}
    for label, q, r in (('fleet', q_b, r_b), ('clustered', cl_q, cl_r)):
        prefs = {rb: nk.build_pruned_ref_lanes(r, rb) for rb in (nk._RB,
                                                                 1024)}
        got = {rb: nk.nn_indices_pruned_lanes(q, p, CUTOFF)
               for rb, p in prefs.items()}
        times = {rb: [] for rb in prefs}
        for rb in (nk._RB, 1024, 1024, nk._RB):
            times[rb].append(event_ms(lambda: nk.nn_indices_pruned_lanes(
                q, prefs[rb], CUTOFF), 20))
        for rb, p in prefs.items():
            rb_ms[f'{label}_rb{rb}'] = float(np.mean(times[rb]))
            tables = nk.pruned_setup(q, p, CUTOFF)[0]
            scanned = torch.zeros(tables[2].shape[:-1], dtype=torch.int32,
                                  device=dev)
            nk._launch_pruned(tables, p, CUTOFF, scanned=scanned)
            rb_share[f'{label}_rb{rb}'] = int(scanned.sum()) * tables[4] / (
                q.shape[0] * q.shape[1] * r.shape[1])
        inside = got[nk._RB][0] <= CUTOFF ** 2
        shift = r.shape[1] * torch.arange(q.shape[0], device=dev)[:, None]
        check_nn(f'K2L {label} at rb 1024 vs {nk._RB}', q[inside],
                 torch.cat(list(prefs[1024].points)), got[1024][0][inside],
                 (got[1024][1] + shift)[inside], got[nk._RB][0][inside],
                 (got[nk._RB][1] + shift)[inside], ties=True)
    log(f'  K2L by reference tile ({smi}; ms a call with its set-up, the '
        f'mean of two turns in {nk._RB}, 1024, 1024, {nk._RB}; share of '
        'pairs scanned): ' + ', '.join(
            f'{k} {v:.4f} ms, {rb_share[k]:.4f}' for k, v in rb_ms.items()))

    # Times at the fleet ICP's shape.
    pairs = B * N * N
    k1l_ms = event_ms(lambda: nk.nn_indices_lanes(q_b, r_b), 20)
    k1l_plain = event_ms(lambda: nk.nn_indices_lanes_plain(q_b, r_b), 2)
    # cdist's exact direct path (the single-lane yardstick) refuses a
    # batch of 256 lanes (cudaErrorInvalidConfiguration); its matmul path
    # computes the same function up to the expansion's rounding.
    lib_call = ('torch.cdist(compute_mode=use_mm_for_euclid_dist)'
                '.min(-1) over the lane batch')
    lib_ms = event_ms(lambda: torch.cdist(
        q_b, r_b, compute_mode='use_mm_for_euclid_dist').min(-1), 2)
    k1l_bound = bound(pairs, INSTR_EXACT, nn_bytes(B * N, B * N))
    pref = nk.build_pruned_ref_lanes(r_b)
    k2l_ms = event_ms(lambda: nk.nn_indices_pruned_lanes(q_b, pref, CUTOFF),
                     20)
    tables = nk.pruned_tables_lanes(q_b, pref, CUTOFF)
    k2l_kernel = event_ms(lambda: nk._launch_pruned(tables, pref, CUTOFF), 20)
    k2l_plain = event_ms(lambda: nk.nn_indices_pruned_lanes_plain(
        q_b, pref, CUTOFF), 1)
    qb = tables[4]
    shares = []
    for _ in range(5):
        scanned = torch.zeros(tables[2].shape[:-1], dtype=torch.int32,
                              device=dev)
        nk._launch_pruned(tables, pref, CUTOFF, scanned=scanned)
        shares.append(int(scanned.sum()) * qb / pairs)
    k2l_bound = bound(min(shares) * pairs, INSTR_EXACT,
                      nn_bytes(B * N, B * N))
    log(f'  times at {B} lanes x {N} x {N} ({smi}): K1L {k1l_ms:.4f} ms '
        f'(bound {k1l_bound[0]:.4f}, by {k1l_bound[1]}), plain '
        f'{k1l_plain:.4f} ms, library ({lib_call}) {lib_ms:.4f} ms; K2L '
        f'with its tables {k2l_ms:.4f} ms, alone {k2l_kernel:.4f} ms, '
        f'scanning {", ".join(f"{x:.4f}" for x in shares)} of the pairs '
        f'(bound {k2l_bound[0]:.4f}), plain {k2l_plain:.4f} ms')
    log(f'phase 12 took {time.perf_counter() - t_phase:.1f} s')
    src = 'laser_slam_tpu_torch/csrc/nn.cu'
    return [
        dict(name='K1L nn_indices_lanes', route='cuda', source=src,
             replaces='laser_slam_tpu/ops/pallas_nn.py:68',
             launches=k1l_launches, max_abs_err=err1, ms=k1l_ms,
             plain_ms=k1l_plain, bound_ms=k1l_bound[0],
             bound_by=k1l_bound[1], library_ms=lib_ms, library=lib_call,
             map_query_ms=map_ms, map_query_plain_ms=map_plain_ms),
        dict(name='K2L nn_indices_pruned_lanes', route='cuda', source=src,
             replaces='laser_slam_tpu/ops/pallas_nn.py:262',
             launches=k2l_launches, max_abs_err=err2, ms=k2l_ms,
             kernel_ms=k2l_kernel, scanned_share=float(np.mean(shares)),
             bound_share=min(shares), clustered_scanned_share=cl_share,
             ms_by_reference_tile=rb_ms,
             scanned_share_by_reference_tile=rb_share, plain_ms=k2l_plain,
             bound_ms=k2l_bound[0], bound_by=k2l_bound[1],
             library_ms=lib_ms, library=lib_call + ' (the cutoff is a '
             'where)')]


def sharding_phase(nk, smi):
    """Phase 15: the fleet step and the pose-graph solve split over a mesh
    (``parallel/sharding.py``).  Returns K1L's and K2L's launches inside
    the sharded steps and the phase's numbers."""
    import dataclasses as dc
    from laser_slam_tpu_torch.config import SolverConfig, fleet_icp_config
    from laser_slam_tpu_torch.graph import factors as fg
    from laser_slam_tpu_torch.graph import solver as sv
    from laser_slam_tpu_torch.parallel import fleet, sharding
    from laser_slam_tpu_torch.pipeline import replay
    t_phase = time.perf_counter()
    dev = torch.device('cuda', 0)
    n_cards = torch.cuda.device_count()

    # (a) Phase 12b's fleet, made as bench.py makes it (seed 15).
    rng = np.random.default_rng(15)
    world = replay.make_scene(rng)
    pose0 = np.array([0.0, 0.0, 1.8])
    B, T, N = FLEET_B, FLEET_T, FLEET_N
    base_scan = replay.sample_scan(rng, world, pose0, N)
    pts = np.zeros((B, T, N, 3), np.float32)
    for b in range(B):
        for t in range(T):
            jitter = rng.normal(size=(N, 3)).astype(np.float32) * 0.02
            pts[b, t] = base_scan + jitter + np.array(
                [0.3 * t, 0.1 * b % 2.0, 0], np.float32)
    nrm = rng.normal(size=(B, T, N, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    init_pose = np.zeros((B, 7), np.float32)
    init_pose[:, 0] = 1.0
    odom_rel = np.zeros((B, T, 7), np.float32)
    odom_rel[:, :, 0] = 1.0
    odom_rel[:, 1:, 4] = 0.3
    arrays = (pts, np.ones((B, T, N), bool), nrm, init_pose, odom_rel)
    card = [torch.tensor(a, device=dev) for a in arrays]
    sigmas = torch.full((6,), 0.01, device=dev)
    scfg = SolverConfig()
    cfg_f = fleet_icp_config(N)
    runs = {'pallas K1L': dc.replace(cfg_f, matcher='pallas',
                                     pallas_prune=False),
            'pallas K2L': dc.replace(cfg_f, matcher='pallas',
                                     pallas_prune=True),
            'brute': cfg_f}

    def unsharded(cfg, inputs=card):
        odo = fleet.fleet_icp_odometry(*inputs, cfg)
        graphs, pose_mask = fleet.build_fleet_chain_graphs(
            odo.rel_icp, odo.valid, inputs[3], sigmas)
        return fleet.fleet_solve(graphs, odo.poses, pose_mask, scfg,
                                 offchain=1)

    # The same scans with their points stored in another order: the same
    # function, its sums (the 6x6 normal equations) in another order,
    # as the sp split's are.
    perm = torch.tensor(rng.permutation(N), device=dev)
    shuffled = [card[0][:, :, perm], card[1][:, :, perm],
                card[2][:, :, perm]] + card[3:]

    def lane_gaps(a, b):
        a = a.double().cpu().numpy()
        b = b.double().cpu().numpy()
        return np.linalg.norm(a[..., 4:] - b[..., 4:], axis=-1).max(-1)

    layouts = [('one card', [dev] * SHARD_DP * SHARD_SP)]
    if n_cards > 1:
        layouts.append((f'{n_cards} cards', [
            torch.device('cuda', i % n_cards)
            for i in range(SHARD_DP * SHARD_SP)]))
    else:
        log('phase 15: one card seen; the meshes repeat cuda:0 (shards '
            'share its stream: no scaling result)')
    out = {'fleet': {}, 'solve': {}}
    launches = {}
    for where, devices in layouts:
        mesh = sharding.make_mesh(devices=devices)
        log(f'phase 15 (a) fleet_slam_step on a {mesh.shape} mesh over '
            f'{where}: B={B}, T={T}, N={N}, fleet_icp_config() and '
            f'SolverConfig() ({smi})')
        sharded_in = sharding.shard_fleet_inputs(mesh, *card)
        for label, cfg in runs.items():
            step = sharding.fleet_slam_step(mesh, cfg, scfg)
            want = unsharded(cfg)
            floor = pose_gaps(
                unsharded(cfg, shuffled).poses.reshape(-1, 7).cpu().numpy(),
                want.poses.reshape(-1, 7).cpu().numpy())
            limit = (max(FLEET_EXACT_GAP[0], 2.0 * floor[0]),
                     max(FLEET_EXACT_GAP[1], 2.0 * floor[1]))
            step(*sharded_in, sigmas)
            torch.cuda.synchronize()
            nk.nn_indices_lanes.launches = 0
            nk.nn_indices_pruned_lanes.launches = 0
            poses, _ = step(*sharded_in, sigmas)
            torch.cuda.synchronize()
            counts = (nk.nn_indices_lanes.launches,
                      nk.nn_indices_pruned_lanes.launches)
            got = poses.gather(dev)
            dt, dr = pose_gaps(got.reshape(-1, 7).cpu().numpy(),
                               want.poses.reshape(-1, 7).cpu().numpy())
            per_lane = lane_gaps(got, want.poses)
            ms = sync_ms(lambda: step(*sharded_in, sigmas), 2)
            ms_one = sync_ms(lambda: unsharded(cfg), 2)
            log(f'  {label}: sharded step {ms:.3f} ms, unsharded '
                f'{ms_one:.3f} ms (synchronized, one call; {smi}); largest '
                f'gap {dt:.3g} m / {dr:.3g} deg, {int(np.sum(per_lane > 1e-5))}'
                f' of {B} lanes above 1e-5 m, median {np.median(per_lane):.3g}'
                f' (limit {limit[0]:.3g} m / {limit[1]:.3g} deg: the larger '
                f'of {FLEET_EXACT_GAP[0]} m / {FLEET_EXACT_GAP[1]} deg and '
                f'twice the unsharded fleet\'s gap to itself on scans stored '
                f'in another order, {floor[0]:.3g} m / {floor[1]:.3g} deg); '
                f'K1L {counts[0]}, K2L {counts[1]} launches in the step')
            if not bool(torch.all(torch.isfinite(got))):
                raise AssertionError(f'phase 15 {label}: non-finite poses')
            if dt > limit[0] or dr > limit[1]:
                raise AssertionError(f'phase 15 {label}: sharded step {dt} '
                                     f'm / {dr} deg from the unsharded')
            need = {'pallas K1L': (counts[0] > 0 and counts[1] == 0),
                    'pallas K2L': (counts[1] > 0 and counts[0] == 0),
                    'brute': counts == (0, 0)}[label]
            if not need:
                raise AssertionError(f'phase 15 {label}: K1L/K2L launches '
                                     f'{counts}')
            if where == 'one card':
                launches[label] = counts
            out['fleet'][f'{label} ({where})'] = dict(
                ms=ms, unsharded_ms=ms_one, gap_m=dt, gap_deg=dr,
                floor_m=floor[0], floor_deg=floor[1],
                lanes_above_1e5=int(np.sum(per_lane > 1e-5)),
                k1l_launches=counts[0], k2l_launches=counts[1])

    # (b) The dry run's 10,000-pose graph (__graft_entry__.py:140-192).
    n_poses, cap = SOLVE_POSES, 1 << 14
    g = fg.HostGraph(rel_capacity=cap, prior_capacity=16)
    poses_np = np.zeros((cap, 7), np.float32)
    poses_np[:, 0] = 1.0
    poses_np[:n_poses, 4] = np.arange(n_poses)
    g.add_prior(0, poses_np[0], np.full(6, 1e-7, np.float32))
    sig = np.full(6, 0.01, np.float32)
    step7 = np.array([1, 0, 0, 0, 1, 0, 0], np.float32)
    for i in range(n_poses - 1):
        g.add_relative(i, i + 1, step7, sig)
    for i in range(0, n_poses - 100, 500):
        g.add_relative(i, i + 100,
                       np.array([1, 0, 0, 0, 100, 0, 0], np.float32), sig)
    poses_np[:n_poses, 4:] += np.random.default_rng(1).normal(
        size=(n_poses, 3)).astype(np.float32) * 0.05
    mask_np = np.zeros((cap,), bool)
    mask_np[:n_poses] = True
    graph = g.to_device(device=dev)
    P, M = torch.tensor(poses_np, device=dev), torch.tensor(mask_np,
                                                            device=dev)
    gcfg = SolverConfig(gn_iterations=2, pcg_iterations=12,
                        pcg_tolerance=0.0, preconditioner='tridiagonal',
                        matvec='scatter')
    single = sv.solve(graph, P, M, gcfg)
    again = sv.solve(graph, P, M, gcfg)
    cpu = sv.solve(g.to_device(device='cpu'), P.cpu(), M.cpu(), gcfg)

    def gap(a, b):
        return float((a.double().cpu() - b.double().cpu()).abs().max())

    # Two single-device solves that differ only in the order of their
    # sums (the card's atomic index_add_ from run to run, the CPU's
    # sequential one) bound what a third order, the shards', may move.
    floor = max(gap(again.poses, single.poses), gap(cpu.poses, single.poses))
    limit = max(SOLVE_ATOL, 2.0 * floor)
    single_ms = sync_ms(lambda: sv.solve(graph, P, M, gcfg), 2)
    for where, devices in layouts:
        gmesh = sharding.make_graph_mesh(devices=devices)
        solve = sharding.sharded_solve(gmesh, gcfg)
        sharded_in = sharding.shard_graph_inputs(gmesh, graph, P, M)
        res = solve(*sharded_in)
        got = res.poses.gather(dev)
        e0 = float(res.error_initial.gather(dev))
        e1 = float(res.error_final.gather(dev))
        d = gap(got, single.poses)
        d_q = gap(got[:, :4], single.poses[:, :4])
        d_yz = gap(got[:, 5:], single.poses[:, 5:])
        ms = sync_ms(lambda: solve(*sharded_in), 2)
        log(f'phase 15 (b) sharded_solve on a {gmesh.shape} mesh over '
            f'{where}, {n_poses} poses (capacity {cap}), 2 GN x 12 PCG, '
            f"'scatter': {ms:.3f} ms, the single-device solve "
            f'{single_ms:.3f} ms (synchronized; {smi}); error {e0:.6g} -> '
            f'{e1:.6g}; largest pose gap to the single-device solve {d:.3g}'
            f' (quaternions {d_q:.3g}, y and z {d_yz:.3g})'
            f' (limit {limit:.3g}: the larger of {SOLVE_ATOL} and twice '
            f'{floor:.3g}, the gap between two single-device solves, '
            f'card run to run {gap(again.poses, single.poses):.3g}, card '
            f'to CPU {gap(cpu.poses, single.poses):.3g})')
        if not (np.isfinite(e1) and e1 < e0 and d <= limit):
            raise AssertionError(f'phase 15 sharded_solve over {where}: gap '
                                 f'{d}, error {e0} -> {e1}')
        out['solve'][where] = dict(ms=ms, single_ms=single_ms, gap=d,
                                   gap_quaternion=d_q, gap_yz=d_yz,
                                   floor=floor, limit=limit, error_initial=e0,
                                   error_final=e1)
    out['seconds'] = time.perf_counter() - t_phase
    log(f'phase 15 took {out["seconds"]:.1f} s')
    return launches, out


def write_kitti_sequence(root, frames):
    """``frames`` as KITTI sequence 00 under ``root``: velodyne .bin (x,
    y, z, reflectance 0 in f32), times.txt, calib.txt with KITTI_TR, and
    poses/00.txt holding Tr @ T_velodyne @ inv(Tr) (camera frame)."""
    from laser_slam_tpu_torch.ops import se3
    seq = os.path.join(root, 'sequences', '00')
    os.makedirs(os.path.join(seq, 'velodyne'))
    os.makedirs(os.path.join(root, 'poses'))
    for i, f in enumerate(frames):
        pts = np.zeros((len(f.points), 4), np.float32)
        pts[:, :3] = f.points
        pts.tofile(os.path.join(seq, 'velodyne', f'{i:06d}.bin'))
    T = se3.to_matrix(torch.tensor(np.stack([f.gt_pose7 for f in frames]),
                                   dtype=torch.float64)).numpy()
    cam = KITTI_TR @ T @ np.linalg.inv(KITTI_TR)
    np.savetxt(os.path.join(root, 'poses', '00.txt'),
               cam[:, :3].reshape(len(frames), 12), fmt='%.9f')
    np.savetxt(os.path.join(seq, 'times.txt'),
               [f.time_ns * 1e-9 for f in frames], fmt='%.6f')
    with open(os.path.join(seq, 'calib.txt'), 'w') as fh:
        fh.write('Tr: ' + ' '.join(f'{v:.9f}' for v in KITTI_TR[:3].ravel())
                 + '\n')


def data_path_phase(nk, streams, smi):
    """Phase 13: the data path in and out (slice 7) through the KITTI and
    bag examples' entry points on the card.  Returns its numbers."""
    import tempfile
    from laser_slam_tpu_torch import native
    from laser_slam_tpu_torch.examples import bag_replay, kitti_replay
    from laser_slam_tpu_torch.ops import se3
    from laser_slam_tpu_torch.pipeline import occupancy, online, replay
    from laser_slam_tpu_torch.pipeline.rosbag import RosbagReader
    from laser_slam_tpu_torch.core import evaluation as ev
    t_phase = time.perf_counter()
    out = {'card': smi}
    lib = native.require_native()       # no numpy fallback on this host
    out['native_library'] = os.path.basename(native.loaded_path())
    log(f'data path: native IO library {native.loaded_path()} loaded '
        f'({lib})')
    tmp = tempfile.TemporaryDirectory()
    root = os.path.join(tmp.name, 'kitti')

    # (a) KITTI at full width: the fixture, read back two ways.
    frames, waited = fetched(streams, 'flagship_kitti')
    frames = frames[:DATA_SCANS]
    t0 = time.perf_counter()
    write_kitti_sequence(root, frames)
    n_pts = np.array([len(f.points) for f in frames])
    beyond = np.maximum(n_pts - DATA_DEFAULT_CAP, 0)
    log(f'data path (a): {DATA_SCANS} frames of phase 9b\'s stream '
        f'({n_pts.mean():.0f} points a scan mean, {n_pts.max()} max) '
        f'written as a KITTI sequence in {time.perf_counter() - t0:.1f} s '
        f'({waited:.1f} s waited for the stream); at the default '
        f'--scan-capacity {DATA_DEFAULT_CAP} a scan loses {beyond.mean():.0f}'
        f' points mean ({beyond.mean() / n_pts.mean():.1%}), {beyond.max()} '
        'max')
    stream = replay.KittiStream(root, '00')
    gt = np.stack([f.gt_pose7 for f in frames]).astype(np.float32)
    read = list(stream)
    if len(read) != DATA_SCANS or any(
            r.points.tobytes() != np.asarray(f.points, np.float32).tobytes()
            for r, f in zip(read, frames)):
        raise AssertionError('data path: KittiStream did not read back the '
                             'written points byte for byte')
    got = torch.tensor(np.stack([r.odom_pose7 for r in read]))
    dt = float(se3.translation_distance(got, torch.tensor(gt)).max())
    dr = float(se3.rotation_angle(got, torch.tensor(gt)).max())
    log(f'  KittiStream: points byte-equal, poses {dt:.3e} m / {dr:.3e} rad '
        f'from the ground truth (limits {DATA_POSE_ATOL})')
    if not (dt <= DATA_POSE_ATOL[0] and dr <= DATA_POSE_ATOL[1]):
        raise AssertionError('data path: KittiStream poses off')
    paths = [os.path.join(stream.velo_dir, f) for f in stream.files]
    with native.PrefetchLoader(paths, max_points=DATA_SCAN_CAP + 1,
                               depth=4) as loader:
        if not loader.native:
            raise AssertionError('data path: PrefetchLoader on numpy')
        loaded = list(loader)
    if [i for i, _ in loaded] != list(range(DATA_SCANS)) or any(
            p.tobytes() != r.points.tobytes()
            for (_, p), r in zip(loaded, read)):
        raise AssertionError('data path: PrefetchLoader scans differ')
    log('  PrefetchLoader (native thread): the same scans in order')

    # The example at --scan-capacity 131072.
    flags = ['--root', root, '--sequence', '00', '--scan-capacity',
             str(DATA_SCAN_CAP)]
    csv = os.path.join(tmp.name, 'traj.csv')
    map_path = os.path.join(tmp.name, 'map.npz')
    t0 = time.perf_counter()
    res = kitti_replay.main(flags + ['--traj-out', csv, '--map-out',
                                     map_path])
    wall = time.perf_counter() - t0
    warm = res['scan_s'][DATA_WARM:]
    ate = res['ate']
    rows = np.loadtxt(csv, delimiter=',')
    out.update(
        kitti_scans=res['n'], kitti_scans_per_s=len(warm) / sum(warm),
        kitti_ms_per_scan=1e3 * float(np.mean(warm)),
        kitti_wall_s=wall, ate_mean_m=ate.translation.mean,
        ate_max_m=ate.translation.max, ate_rmse_m=ate.translation.rmse,
        ate_rot_mean_deg=ate.rotation_deg.mean,
        rpe_10m_trans_pct=(100 * res['rpe'].translation.mean
                           if res['rpe'] else None),
        rpe_10m_rot_deg=(res['rpe'].rotation_deg.mean if res['rpe']
                         else None),
        occupied_cells=res['occupied'],
        insert_ms_per_scan=1e3 * float(np.mean(res['insert_s'])),
        read_ms_per_scan=1e3 * float(np.mean(res['read_s'])),
        points_per_scan=float(n_pts.mean()),
        points_beyond_default_cap=float(beyond.mean()))
    log(f'  {smi}: kitti_replay --scan-capacity {DATA_SCAN_CAP} '
        f'(projective): {res["n"]} scans, {out["kitti_scans_per_s"]:.4f} '
        f'scans/s after {DATA_WARM} warm-up scans '
        f'({out["kitti_ms_per_scan"]:.3f} ms a scan), {wall:.1f} s in all; '
        f'ATE mean {ate.translation.mean:.6f} m, max {ate.translation.max:.6f}'
        f' m (limits {DATA_ATE_MEAN_M}, {DATA_ATE_MAX_M}); RPE per 10 m '
        f'{out["rpe_10m_trans_pct"]} %, {out["rpe_10m_rot_deg"]} deg; '
        f'{res["occupied"]} occupied cells, insert '
        f'{out["insert_ms_per_scan"]:.3f} ms a scan (synchronized), '
        f'KittiStream read {out["read_ms_per_scan"]:.3f} ms a scan')
    if not (res['n'] == DATA_SCANS and rows.shape == (DATA_SCANS, 4)
            and np.all(np.isfinite(rows))):
        raise AssertionError('data path: trajectory CSV or scan count')
    if not (ate.translation.mean < DATA_ATE_MEAN_M
            and ate.translation.max < DATA_ATE_MAX_M):
        raise AssertionError('data path: ATE out of bounds')
    if not res['occupied']:
        raise AssertionError('data path: empty occupancy map')
    if res['runner'].device.type != 'cuda':
        raise AssertionError('data path: the example did not run on cuda')

    # The same entry with K2 over the first 16 scans.
    nk.nn_indices.launches = 0
    nk.nn_indices_pruned.launches = 0
    t0 = time.perf_counter()
    k2 = kitti_replay.main(flags + ['--matcher', 'pallas', '--max-scans',
                                    str(DATA_K2_SCANS)])
    k2_wall = time.perf_counter() - t0
    k2_launches, k1_launches = (nk.nn_indices_pruned.launches,
                                nk.nn_indices.launches)
    per_scan = k2_launches / max(k2['n'] - 1, 1)
    k2_ate = k2['ate']
    k2_warm = k2['scan_s'][DATA_WARM:]
    out.update(k2_scans=k2['n'], k2_launches=k2_launches,
               k2_launches_per_scan=per_scan,
               k2_scans_per_s=len(k2_warm) / sum(k2_warm),
               k2_ate_mean_m=k2_ate.translation.mean,
               k2_ate_max_m=k2_ate.translation.max)
    log(f'  {smi}: kitti_replay --matcher pallas, {k2["n"]} scans: K2 '
        f'{k2_launches} launches ({per_scan:.1f} a scan), K1 {k1_launches};'
        f' {out["k2_scans_per_s"]:.4f} scans/s after {DATA_WARM} warm-up '
        f'scans, {k2_wall:.1f} s in all; ATE mean '
        f'{k2_ate.translation.mean:.6f} m, max {k2_ate.translation.max:.6f} m')
    if per_scan < 40 or k1_launches or k2['n'] != DATA_K2_SCANS:
        raise AssertionError('data path: K2 must launch at least 40 times '
                             'a scan and K1 never')
    if not (k2_ate.translation.mean < DATA_ATE_MEAN_M
            and k2_ate.translation.max < DATA_ATE_MAX_M):
        raise AssertionError('data path: K2 leg ATE out of bounds')
    # K2 at the leg's submap against its plain version (launched after
    # the counts were read): the next frame's reading in the newest
    # scan's frame.
    state = k2['runner'].state
    ref, _ = online.submap(state)
    last = k2['traj'][max(k2['traj'])]
    rel = se3.compose(se3.inverse(torch.tensor(last)),
                      torch.tensor(gt[DATA_K2_SCANS]))
    step = max(len(frames[DATA_K2_SCANS].points) // READING, 1)
    q = se3.apply(rel, torch.tensor(
        frames[DATA_K2_SCANS].points[::step][:READING])).to('cuda')
    pref = nk.build_pruned_ref(ref.points)
    d2_k, idx_k = nk.nn_indices_pruned(q, pref, CUTOFF)
    d2_p, idx_p = nk.nn_indices_pruned_plain(q, pref, CUTOFF)
    inside = d2_p <= CUTOFF ** 2
    check_nn(f'K2 at the KITTI leg\'s submap, {q.shape[0]} x '
             f'{ref.points.shape[0]}', q, pref.points, d2_k, idx_k, d2_p,
             idx_p, rows=inside, ties=True)
    if bool(torch.any(d2_k[~inside] <= CUTOFF ** 2)) or (
            ref.points.shape[0] != 5 * DATA_SCAN_CAP):
        raise AssertionError('data path: K2 at the leg\'s submap')
    out['k2_check_shape'] = [q.shape[0], ref.points.shape[0]]

    # (b) The raw-packet bag at the example's defaults.
    t0 = time.perf_counter()
    bag = os.path.join(tmp.name, 'demo.bag')
    gt_path = bag_replay.make_demo_bag(bag)
    made = time.perf_counter() - t0
    bag_map = os.path.join(tmp.name, 'bag_map.npz')
    t0 = time.perf_counter()
    traj = bag_replay.replay(bag, gt_path=gt_path, map_path=bag_map)
    bag_wall = time.perf_counter() - t0
    a = ev.ate(traj, ev.load_trajectory_tum(gt_path), align='origin')
    occupied = len(occupancy.OccupancyGrid.load(bag_map).occupied_points())
    packets = [bytes(p) for m in itertools.islice(
        RosbagReader(bag, topics={'/velodyne_packets'}), 15)
        for p in m.data[1]]
    decoded = [native.decode_velodyne_packets(p) for p in packets]
    plain = [native.decode_velodyne_packets_plain(p) for p in packets]
    same = all(x.tobytes() == y.tobytes() for x, y in zip(decoded, plain))
    native_ms = host_ms(
        lambda: [native.decode_velodyne_packets(p) for p in packets], 20)
    numpy_ms = host_ms(
        lambda: [native.decode_velodyne_packets_plain(p) for p in packets],
        20)
    out.update(bag_revolutions=len(traj), bag_make_s=made,
               bag_replay_s=bag_wall, bag_ate_rmse_m=a.translation.rmse,
               bag_ate_max_m=a.translation.max, bag_occupied_cells=occupied,
               decode_native_ms_per_packet=native_ms / len(packets),
               decode_numpy_ms_per_packet=numpy_ms / len(packets),
               decode_points_per_revolution=int(sum(map(len, decoded))))
    log(f'data path (b): demo bag (24 revolutions x 15 VLP-16 packets) made '
        f'in {made:.1f} s; bag_replay on cuda {bag_wall:.1f} s: '
        f'{len(traj)} revolutions, ATE rmse {a.translation.rmse:.6f} m '
        f'(limit {BAG_RMSE_M}), {occupied} occupied cells; one revolution '
        f'({len(packets)} packets, {out["decode_points_per_revolution"]} '
        f'points) decoded {"bit-equal" if same else "NOT bit-equal"} by the '
        f'library and numpy; {smi}: decode '
        f'{out["decode_native_ms_per_packet"]:.4f} ms a packet native, '
        f'{out["decode_numpy_ms_per_packet"]:.4f} numpy')
    if not same:
        raise AssertionError('data path: native and numpy decodes differ')
    if len(traj) < BAG_REVOLUTIONS or not a.translation.rmse < BAG_RMSE_M:
        raise AssertionError('data path: bag replay out of bounds')
    if occupied <= BAG_OCCUPIED:
        raise AssertionError('data path: near-empty bag occupancy map')
    tmp.cleanup()
    out['phase_s'] = time.perf_counter() - t_phase
    log(f'  phase 13 took {out["phase_s"]:.1f} s')
    return out


def demo_phase(nk, smi):
    """Phase 14 (a): the three demos at their defaults on the card through
    their ``main()``; the synthetic one also with ``--matcher pallas``,
    whose K2 is held to its plain version at the demo's submap.  Returns
    their numbers."""
    from laser_slam_tpu_torch.examples import (auto_loop_closure_demo,
                                               multi_robot_demo,
                                               synthetic_slam_demo)
    from laser_slam_tpu_torch.ops import se3
    from laser_slam_tpu_torch.pipeline.online import assemble_submap
    t_phase = time.perf_counter()
    out = {'card': smi}

    def on_card(obj, label):
        if obj.device.type != 'cuda':
            raise AssertionError(f'demos: {label} did not run on cuda')

    res = synthetic_slam_demo.main([])
    on_card(res['estimator'], 'synthetic_slam_demo')
    out['synthetic'] = dict(n=res['n'], error_mean_m=res['error_mean_m'],
                            error_max_m=res['error_max_m'],
                            scans_per_s=res['scans_per_s'],
                            wall_s=res['wall_s'])
    nk.nn_indices.launches = 0
    nk.nn_indices_pruned.launches = 0
    pal = synthetic_slam_demo.main(['--matcher', 'pallas'])
    k2, k1 = nk.nn_indices_pruned.launches, nk.nn_indices.launches
    on_card(pal['estimator'], 'synthetic_slam_demo --matcher pallas')
    out['synthetic_pallas'] = dict(
        n=pal['n'], error_mean_m=pal['error_mean_m'],
        error_max_m=pal['error_max_m'], scans_per_s=pal['scans_per_s'],
        wall_s=pal['wall_s'], k2_launches=k2,
        k2_launches_per_scan=k2 / max(pal['n'] - 1, 1), k1_launches=k1)
    log(f'demos: {smi}: synthetic_slam_demo {res["n"]} scans, '
        f'{res["scans_per_s"]:.4f} scans/s (warm-up included), error mean '
        f'{res["error_mean_m"]:.6f} m, max {res["error_max_m"]:.6f} m; with '
        f'--matcher pallas {pal["scans_per_s"]:.4f} scans/s, error max '
        f'{pal["error_max_m"]:.6f} m, K2 {k2} launches, K1 {k1}')
    if k2 < 40 * (pal['n'] - 1) or k1:
        raise AssertionError('demos: K2 must launch at least 40 times a scan '
                             'after the first and K1 never')
    # K2 at the demo's submap against its plain version (launched after the
    # counts were read): the ring of the last 3 scans in the newest one's
    # frame, queried by the first frame's points (the revisit) moved there
    # by ground truth, 4096 of them as the reading.
    args = synthetic_slam_demo.parse_args([])
    fs = synthetic_slam_demo.frames(args)
    track = pal['worker'].laser_track
    traj = pal['traj']
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    T_a_w = se3.inverse(t(traj[int(track._ring_times[-1])]))
    rels = torch.stack([se3.compose(T_a_w, t(traj[int(k)]))
                        for k in track._ring_times]).to('cuda')
    submap, _ = assemble_submap(track._ring_points, track._ring_mask,
                                track._ring_normals, rels)
    rel = se3.compose(se3.inverse(t(fs[-1].gt_pose7)), t(fs[0].gt_pose7))
    reading = args.points // 2
    q = se3.apply(rel, t(fs[0].points[::2][:reading])).to('cuda')
    pref = nk.build_pruned_ref(submap.points)
    d2_k, idx_k = nk.nn_indices_pruned(q, pref, CUTOFF)
    d2_p, idx_p = nk.nn_indices_pruned_plain(q, pref, CUTOFF)
    inside = d2_p <= CUTOFF ** 2
    n_ref = submap.points.shape[0]
    out['synthetic_pallas']['k2_max_abs_err'] = check_nn(
        f'K2 at the demo\'s submap, {q.shape[0]} x {n_ref}', q, pref.points,
        d2_k, idx_k, d2_p, idx_p, rows=inside, ties=True)
    if bool(torch.any(d2_k[~inside] <= CUTOFF ** 2)) or (
            n_ref != 3 * args.points or q.shape[0] != reading
            or int(inside.sum()) < reading // 2):
        raise AssertionError('demos: K2 at the demo\'s submap')

    auto = auto_loop_closure_demo.main([])
    on_card(auto['runner'], 'auto_loop_closure_demo')
    out['auto_closure'] = dict(
        detections=len(auto['detections']),
        lap_distances=[b - a for a, b, _, _ in auto['detections']],
        ate_with_mean_m=auto['ate_with'].translation.mean,
        ate_with_max_m=auto['ate_with'].translation.max,
        ate_without_mean_m=auto['ate_without'].translation.mean,
        ate_without_max_m=auto['ate_without'].translation.max,
        scans_per_s=auto['scans_per_s'], wall_s=auto['wall_s'])
    multi = multi_robot_demo.main([])
    on_card(multi['runner'], 'multi_robot_demo')
    out['multi_robot'] = dict(
        error_mean_m=multi['error_mean_m'], error_max_m=multi['error_max_m'],
        scans_per_s=multi['scans_per_s'], integrate_s=multi['integrate_s'],
        refine_s=multi['refine_s'])
    out['phase_s'] = time.perf_counter() - t_phase
    log('demos: ' + json.dumps(out))
    return out


def profiling_phase(nk, smi, production, k1_ms, queries, submap, frames):
    """Phase 14 (b): the port's profiling functions on the card: phase
    8b's step_breakdown (``production``) checked, nn_kernel_utilization at
    phase 3's scene (K1 within 25% of phase 3's ``k1_ms``) and
    device_trace around 4 scans of a slice-1 runner.  Returns the
    numbers."""
    import tempfile
    from laser_slam_tpu_torch.config import slice1_config
    from laser_slam_tpu_torch.core import benchmarker as bench
    from laser_slam_tpu_torch.pipeline import online, profiling
    t_phase = time.perf_counter()
    out = {'card': smi}
    stage = production['stage_ms']
    want = ['upload', 'full_step', 'decode_packed', 'ingest_filters',
            'store_decimate', 'normals', 'submap_assembly', 'reading_prep',
            'icp', 'window_solve', 'pr_query']
    wall = production['full_step_wall_ms']
    out['step_breakdown_ms'] = stage
    out['full_step_wall_ms'] = wall
    log(f'profiling: {smi}: step_breakdown at KITTI density (phase 8b): '
        f'full_step {stage["full_step"]:.3f} ms of device work against '
        f'{wall:.3f} ms of synchronized wall time a step')
    if list(stage) != want or not all(
            np.isfinite(v) and v > 0 for v in stage.values()):
        raise AssertionError(f'profiling: step_breakdown keys or values '
                             f'{stage}')
    if not stage['full_step'] <= wall:
        raise AssertionError('profiling: full_step above the wall time of '
                             'a step')

    nk.nn_indices.launches = 0
    util = profiling.nn_kernel_utilization(queries, submap, reps=20)
    out['k1_launches'] = nk.nn_indices.launches
    out['nn_kernel_utilization'] = util
    out['k1_ms_phase3'] = k1_ms
    log(f'  nn_kernel_utilization at {queries.shape[0]} x '
        f'{submap.shape[0]}: ' + json.dumps(util))
    if not (abs(util['k1_ms'] - k1_ms) <= 0.25 * k1_ms
            and 0 < util['k1_fraction_of_bound'] <= 1.05
            and out['k1_launches'] > 0):
        raise AssertionError(f'profiling: K1 at {util["k1_ms"]} ms against '
                             f'phase 3\'s {k1_ms} ms, fraction '
                             f'{util["k1_fraction_of_bound"]}')

    runner = online.OnlineRunner(
        slice1_config(scan_capacity=N_POINTS, reading_capacity=READING),
        pose_capacity=128, factor_capacity=512, device='cuda')
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with bench.device_trace(tmp):
            for f in frames[:4]:
                runner.process_scan(f.time_ns, f.points, f.odom_pose7)
        traced_s = time.perf_counter() - t0
        files = [os.path.join(tmp, n) for n in os.listdir(tmp)
                 if n.endswith('.pt.trace.json')]
        found = False
        for path in files:
            with open(path, 'rb') as fh:
                found = found or b'nn_items_kernel' in fh.read()
        out['trace'] = dict(files=len(files), seconds=traced_s,
                            mib=sum(os.path.getsize(p) for p in files) / 2**20,
                            names_nn_items_kernel=found)
    log(f'  device_trace over 4 slice-1 scans: {out["trace"]}')
    if len(files) != 1 or not found:
        raise AssertionError('profiling: no trace naming nn_items_kernel')
    out['phase_s'] = time.perf_counter() - t_phase
    log('profiling: ' + json.dumps(out))
    return out


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
    streams = start_prefetch()
    dev = torch.device('cuda')

    # 1. Device --------------------------------------------------------
    t_main = time.perf_counter()
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
    peaks = card_peaks(sm_clock_hz=sm_clock)
    bound = peaks.bound
    log(f'f32 issue rate: {peaks.sm_count} SMs x {peaks.lanes_per_sm} lanes'
        f' x {sm_clock / 1e9:.3f} GHz = {peaks.f32_issue_per_s / 1e12:.2f} T '
        f'instructions/s; HBM {peaks.hbm_bytes_per_s / 1e12:.2f} TB/s, bf16 '
        f'tensor {peaks.bf16_tensor_flops / 1e12:.0f} TFLOP/s')

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

    def elapsed(phase):
        log(f'[{time.perf_counter() - t_main:.1f} s] phase {phase}')

    # 3. K1 vs plain ---------------------------------------------------
    elapsed(3)
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
    k1_ms = event_ms(lambda: nk.nn_indices(queries, submap), 20)
    k1_plain_ms = event_ms(lambda: nk.nn_indices_plain(queries, submap), 5)
    log(f'  time at {READING} x {SUBMAP_SCANS * N_POINTS}: kernel '
        f'{k1_ms:.4f} ms, plain '
        f'{k1_plain_ms:.4f} ms')
    n_sub = SUBMAP_SCANS * N_POINTS
    lib_exact = sh.EXACT_LIBRARY_CALL
    k1_lib_ms = event_ms(lambda: sh.exact_library_call(queries, submap), 2)
    log(f'  library call ({lib_exact}): {k1_lib_ms:.4f} ms')
    k1_bound = bound(READING * n_sub, INSTR_EXACT, nn_bytes(READING, n_sub))
    kernels['K1'] = dict(max_abs_err=err1, ms=k1_ms, plain_ms=k1_plain_ms,
                         bound_ms=k1_bound[0], bound_by=k1_bound[1],
                         library_ms=k1_lib_ms, library=lib_exact)

    # 4. K2 vs plain and K1 --------------------------------------------
    elapsed(4)
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
    # The set-up on the card against pruned_tables, scene by scene.
    t_setup = time.perf_counter()
    err2 = max(err2, check_k2_setup(nk, k2_setup_scenes(
        nk, pc, dev, queries, submap, c_q, c_ref)))
    log(f'  K2 set-up checks took {time.perf_counter() - t_setup:.1f} s')
    pref = nk.build_pruned_ref(submap)
    k2_ms = event_ms(lambda: nk.nn_indices_pruned(queries, pref, CUTOFF), 20)
    k2_plain_ms = event_ms(
        lambda: nk.nn_indices_pruned_plain(queries, pref, CUTOFF), 5)
    tables = nk.pruned_tables(queries, pref, CUTOFF)
    k2_kernel_ms = event_ms(lambda: nk._launch_pruned(tables, pref, CUTOFF),
                           20)
    k2_host = host_ms(lambda: nk.nn_indices_pruned(queries, pref, CUTOFF),
                      20)
    # The plain set-up (pruned_tables, about 110 torch launches) before the
    # same kernel, as the wrapper ran until the set-up went onto the card.
    k2_torch_tables_ms = event_ms(lambda: nk._launch_pruned(
        nk.pruned_tables(queries, pref, CUTOFF), pref, CUTOFF), 20)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as one:
        nk.nn_indices_pruned(queries, pref, CUTOFF)
        torch.cuda.synchronize()
    # device_rows reads the profiler's events directly: it must sum them
    # as key_averages() does.
    from torch.autograd import DeviceType
    averaged = sorted((e.key, e.count, e.self_device_time_total)
                      for e in one.key_averages()
                      if e.device_type == DeviceType.CUDA)
    direct = sorted(device_rows(one))
    if [r[:2] for r in averaged] != [r[:2] for r in direct] or not np.allclose(
            [r[2] for r in averaged], [r[2] for r in direct], rtol=1e-6,
            atol=1e-3):
        raise AssertionError(f'device_rows {direct} differ from '
                             f'key_averages {averaged}')
    k2_launches_one = device_launches(one)
    log(f'  time at {READING} x {SUBMAP_SCANS * N_POINTS} (room): with its '
        f'set-up on the card {k2_ms:.4f} ms ({k2_launches_one} device '
        f'launches a call, which the host issues in {k2_host:.4f} ms), '
        f'kernel alone (tables built once) {k2_kernel_ms:.4f} ms, with the '
        f'torch tables (pruned_tables) {k2_torch_tables_ms:.4f} ms, plain '
        f'{k2_plain_ms:.4f} ms')
    if k2_launches_one > K2_MAX_LAUNCHES:
        raise AssertionError(f'K2: {k2_launches_one} device launches a call, '
                             f'above {K2_MAX_LAUNCHES}')
    # K2's work depends on the data: the Pallas walk (replayed in torch)
    # must reach the kernel's distances, and the kernel scans the tiles
    # that the bests merged so far do not prune, which varies with block
    # timing (it counts them).  The bound counts the fewer pairs.
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
    walk_share = int(visits.sum()) * qb * rb / (READING * n_sub)
    k2_share = min(walk_share, min(shares))
    k2_bound = bound(k2_share * READING * n_sub, INSTR_EXACT,
                     nn_bytes(READING, n_sub))
    log(f'  the Pallas walk scans {int(visits.sum())} of {visits.numel()} x '
        f'{pref.tile_lo.shape[0]} tile pairs: {walk_share:.4f} of all pairs')
    log(f'  K2 scanned (counted by the kernel, 5 calls): '
        f'{", ".join(f"{x:.4f}" for x in shares)} of all pairs; the bound '
        f'counts {k2_share:.4f}')
    kernels['K2'] = dict(max_abs_err=err2, ms=k2_ms, kernel_ms=k2_kernel_ms,
                         host_ms=k2_host,
                         torch_tables_ms=k2_torch_tables_ms,
                         scanned_share=float(np.mean(shares)),
                         walk_share=walk_share, bound_share=k2_share,
                         plain_ms=k2_plain_ms,
                         bound_ms=k2_bound[0], bound_by=k2_bound[1],
                         library_ms=k1_lib_ms,
                         library=lib_exact + ' (the cutoff is a where)')

    # E1's, E4's, E5's and E6's device launches a call, set-up included, and
    # their device time by kernel, counted on the shootout's scene (phase
    # 7) before phase 5: after its long profile, short profiler sessions
    # lose kernel records.
    t_prof = time.perf_counter()
    full = tuple(torch.tensor(a, device=dev)
                 for a in sh.make_scene(SHOOT_Q, SHOOT_R, seed=3))
    k2_items = 'void nn_items_kernel<true'

    def sort_route():
        old = nk._SORT_KEYS
        nk._SORT_KEYS = 0
        try:
            return nk.nn_indices_pruned(queries, pref, CUTOFF)
        finally:
            nk._SORT_KEYS = old

    k2_profiled = dict(
        shared=launches_a_call(
            'K2', lambda: nk.nn_indices_pruned(queries, pref, CUTOFF),
            k2_items, K2_MAX_LAUNCHES),
        sort=launches_a_call('K2 on the torch.sort route', sort_route,
                             k2_items, 1000),
        torch_tables=launches_a_call(
            'K2 with the torch tables', lambda: nk._launch_pruned(
                nk.pruned_tables(queries, pref, CUTOFF), pref, CUTOFF),
            k2_items, 1000))
    k2_sort_ms = event_ms(sort_route, 20)
    for key, label in (('shared', 'with its set-up (shared-memory sort)'),
                       ('sort', 'on the torch.sort route'),
                       ('torch_tables', 'with the torch tables')):
        n, split = k2_profiled[key]
        log(f'  K2 {label}: {n} device launches a call; device ms a call: '
            + (json.dumps(split) if n <= K2_MAX_LAUNCHES else
               f'{sum(split.values()):.4f} in all'))
    log(f'  K2 on the torch.sort route at {READING} x {n_sub}: '
        f'{k2_sort_ms:.4f} ms a call')
    kernels['K2'].update(
        launches_a_call=k2_profiled['shared'][0],
        device_ms_by_kernel=k2_profiled['shared'][1],
        sort_route_ms=k2_sort_ms,
        sort_route_launches_a_call=k2_profiled['sort'][0],
        torch_tables_launches_a_call=k2_profiled['torch_tables'][0])
    profiled = dict(
        E6=launches_a_call('E6', lambda: nv.nn_payload_pruned(*full),
                           'e6_items_kernel', E6_MAX_LAUNCHES),
        E4=launches_a_call('E4', lambda: nv.nn_payload(*full),
                           'mm_items_kernel', MM_MAX_LAUNCHES),
        E5=launches_a_call('E5', lambda: nv.nn_indices_mm(*full[:2]),
                           'mm_items_kernel', MM_MAX_LAUNCHES),
        E1=launches_a_call('E1', lambda: nv.nn_indices_mm(*full[:2], 'bf16'),
                           'e1_items_kernel', MM_MAX_LAUNCHES))
    profile_s = time.perf_counter() - t_prof

    # 5. The slice -----------------------------------------------------
    elapsed(5)
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
    # Device activity only: every number read is a device row, and host
    # op events would multiply the post-processing time.
    prof = torch.profiler.profile(activities=[
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
        if idx == HOST_SCANS - 1:
            # Phase 11 compares the host API with this lap.
            online_lap = runner.trajectory()
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
    lap1 = [t for k, t in enumerate(scan_s[:HOST_SCANS]) if k >= HOST_WARM
            and k not in PROFILE_SCANS]
    log(f'  the same over scans {HOST_WARM}-{HOST_SCANS - 1} (phase 11\'s '
        f'lap): {len(lap1) / sum(lap1):.4f} scans/s '
        f'({1000 * np.mean(lap1):.3f} ms/scan mean)')
    profile_summary(prof, sum(scan_s[k] for k in PROFILE_SCANS),
                    PROFILE_SCANS, focus=(
                        ('K2 items', ('nn_items_kernel<true',)),
                        ('K2 items with its unpack',
                         ('nn_items_kernel<true', 'nn_unpack_kernel')),
                        ('K2 set-up', ('k2_sort_kernel', 'k2_codes_kernel',
                                       'k2_tables_kernel'))))
    if k2_launches <= 0:
        raise AssertionError('slice: K2 never launched')
    if not (ate.max() < 0.35 and ate[-1] < 0.15):
        raise AssertionError(f'slice: ATE out of bounds (max {ate.max()}, '
                             f'final {ate[-1]})')
    kernels['K2']['launches'] = k2_launches

    # 6. K1 inside ICP -------------------------------------------------
    elapsed(6)
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
    icp_ms = {}
    for label, c in (('K2 matcher', icp_cfg), ('K1 matcher', flat_cfg)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            icp_mod.icp(reading, reference, normals, guess, c)
        torch.cuda.synchronize()
        icp_ms[label] = 1000 * (time.perf_counter() - t0) / 3
        log(f'  ICP at the slice\'s shapes, {label}: {icp_ms[label]:.3f} ms '
            'a call')
    # Where an ICP call's time goes with either matcher: device launches
    # and device ms a call by kernel (one search an iteration, as many as
    # K1 launched in one call).
    # Records lost in 3 profiler sessions (they follow phase 5's long
    # profile) leave it not measured.
    for label, c, items in (
            ('K2 matcher', icp_cfg, 'void nn_items_kernel<true'),
            ('K1 matcher', flat_cfg, 'void nn_items_kernel<false')):
        try:
            n, split = launches_a_call(
                f'ICP, {label}', lambda: icp_mod.icp(reading, reference,
                                                     normals, guess, c),
                items, 100000, items_per_call=k1_launches)
        except AssertionError as e:
            log(f'  ICP {label}: profile not measured ({e})')
            continue
        device = sum(split.values())
        top = sorted(split.items(), key=lambda kv: -kv[1])[:6]
        log(f'  ICP {label} ({smi}): {n:.0f} device launches a call, '
            f'{device:.3f} ms of device time in {icp_ms[label]:.3f} ms '
            f'(busy {100 * device / icp_ms[label]:.1f}%); by kernel: '
            + '; '.join(f'{k[:60]} {v:.3f} ms' for k, v in top))
    log(f'  K1 launches {k1_launches}, valid {bool(res_flat.valid)}, '
        f'max |T_K1 - T_K2| {dT:.3e} (tolerance {POSE_ATOL})')
    if k1_launches <= 0:
        raise AssertionError('ICP: K1 never launched')
    if not (bool(res_flat.valid) and dT <= POSE_ATOL):
        raise AssertionError('ICP: flat and pruned matchers disagree')
    kernels['K1']['launches'] = k1_launches

    # 7. The shootout's kernels (E1-E6) --------------------------------
    elapsed(7)
    t7 = time.perf_counter()
    log(f'shootout kernels vs plain at {SHOOT_Q} x {SHOOT_R} and 1000 x '
        '3001 (parked reference):')
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
    # Exact copies of 64 reference points in the next 2048-wide tile, with
    # other normals, and the first 64 queries next to them: E5 must return
    # the first copy, E4 the first tile's payload without the copy's.
    ties = [a.clone() for a in full]
    ties[1][2048:2112] = ties[1][:64]
    ties[2][2048:2112, :3] = ties[1][:64]
    ties[2][2048:2112, 3:] = -ties[2][:64, 3:]
    ties[0][:64] = ties[1][:64] + 0.01
    errs = {k: 0.0 for k in ('E1', 'E2', 'E3', 'E4', 'E5', 'E6')}
    tol_share = {k: 0.0 for k in ('E1', 'E4', 'E5', 'E6')}
    for label, (q, r, pay) in ((f'{SHOOT_Q} x {SHOOT_R}', full),
                               ('duplicates', tuple(dup)),
                               ('ties across tiles', tuple(ties)),
                               ('1000 x 3001 parked', tuple(odd))):
        for key, prec in (('E5', 'highest'), ('E1', 'bf16')):
            got = nv.nn_indices_mm(q, r, prec)
            # E1's epilogue self-check: index -1 where the winning key
            # tile, scored again, held no row with the key's score.
            misses = int(torch.sum(got[1] < 0))
            if misses:
                raise AssertionError(f'{key} {label}: {misses} queries whose '
                                     'tile did not score again to its key')
            c = nv.check_mm_indices(q, r, *got,
                                    *nv.nn_indices_mm_plain(q, r, prec),
                                    precision=prec)
            c['rescore_misses'] = misses
            if label == 'ties across tiles':
                # Exact copies score the same bits in any tile: the copy in
                # the next tile never wins.  E5 is rank-safe here, so each
                # of the 64 queries takes its first copy; bf16's rank errors
                # send some of E1's (and the plain E1's) to other rows.
                first = int(torch.sum(got[1][:64].cpu() == torch.arange(64)))
                copy = int(torch.sum((got[1] >= 2048) & (got[1] < 2112)))
                c['first_copies'] = first
                if copy or first < (64 if key == 'E5' else 1):
                    raise AssertionError(f'{key}: a copy in the next tile '
                                         f'won ({copy}), {first} of 64 took '
                                         'the first')
            errs[key] = max(errs[key], c['max_abs_err'])
            tol_share[key] = max(tol_share[key], c['err_over_tol'])
            log(f'  {key} {prec} {label}: ok {c}')
        for key, fn, plain in (
                ('E4', nv.nn_payload, nv.nn_payload_plain),
                ('E6', nv.nn_payload_pruned, nv.nn_payload_pruned_plain)):
            got = fn(q, r, pay)
            c = nv.check_payload(q, r, pay, *got, *plain(q, r, pay))
            if label in ('duplicates', 'ties across tiles') \
                    and c['duplicates'] < 64:
                raise AssertionError(f'{key}: the duplicate groups were '
                                     'not found')
            if (key == 'E4' and label == 'ties across tiles'
                    and not torch.equal(got[1][:64], pay[:64])):
                raise AssertionError('E4: the copy in the next tile was '
                                     'averaged in')
            errs[key] = max(errs[key], c['max_abs_err'])
            tol_share[key] = max(tol_share[key], c['err_over_tol'])
            log(f'  {key} {label}: ok {c}')
        want = nk.nn_indices_plain(q, r)
        c = exact_tiled('E2', q, r, nv.nn_vpu(q, r), want)
        errs['E2'] = max(errs['E2'], c['max_abs_err'])
        log(f'  E2 {label}: ok, d2 bit-equal {c}')
        for qb, rb in sh.SWEEP[:-1]:
            c = exact_tiled(f'E3 {qb}x{rb}', q, r,
                            nv.nn_indices_tiled(q, r, qb, rb), want)
            errs['E3'] = max(errs['E3'], c['max_abs_err'])
        log(f'  E3 {label}: ok, d2 bit-equal at {len(sh.SWEEP) - 1} tile '
            'shapes')
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
    for row in sweep + [rows['vpu'], rows['payload'], rows['indices-hi'],
                        rows['indices-bf16']]:
        if row['items'] < 256:
            raise AssertionError(f'{row["name"]}: {row["items"]} work items '
                                 'do not fill the card')
    sweep_line = [dict(qb=r['qb'], rb=r['rb'], items=r['items'], ms=r['ms'])
                  for r in sweep]
    shoot_row = dict(E1=rows['indices-bf16'], E5=rows['indices-hi'],
                     E4=rows['payload'], E6=rows['pruned'], E2=rows['vpu'],
                     E3=best3)
    q, r, pay = full
    # E1's set-up bit-equal to its plain version (the bf16 rows the plain
    # E1 multiplies, packed), on the shootout's scene and at 1000 x 3001
    # parked (SENTINEL rows, zero pad rows up to 3008); two calls of its
    # passes on one table give equal results.
    for label, (qq, rr) in ((f'{SHOOT_Q} x {SHOOT_R}', (q, r)),
                            ('1000 x 3001 parked', odd[:2])):
        if not torch.equal(nv.mm_bf16_setup(qq, rr).rows,
                           nv.mm_bf16_rows_plain(rr)):
            raise AssertionError(f'E1 set-up {label}: its bf16 rows differ '
                                 'from the plain set-up')
    sum_order = torch.equal(
        nv.bf16_row_values(nv.mm_bf16_rows_plain(r))[:SHOOT_R],
        nv.round_bf16(nv.extend_reference(r)))
    tab_e1 = nv.mm_bf16_setup(q, r)
    once = nv._launch_mm_indices_bf16(q, tab_e1)
    again = nv._launch_mm_indices_bf16(q, tab_e1)
    if not (torch.equal(once[0], again[0]) and torch.equal(once[1], again[1])):
        raise AssertionError('E1: two calls on one table differ')
    log(f'  E1 set-up: rows bit-equal to mm_bf16_rows_plain on both scenes; '
        f'torch.sum\'s |r|^2 on the card rounds to the same bf16: '
        f'{sum_order}; two calls on one table equal')
    # Each kernel alone: E1 on tables built once (mm_bf16_setup: bf16 rows,
    # empty keys), E4/E5 on tables built once (mm_setup: extended rows,
    # empty keys), E6 on tables built once (pruned_setup); E2/E3 have no
    # set-up beyond their key fill.
    tab_mm = nv.mm_setup(q, r)
    tab6 = nv.pruned_setup(q, r)
    kernel_ms = dict(
        E1=event_ms(lambda: nv._launch_mm_indices_bf16(q, tab_e1), 20),
        E5=event_ms(lambda: nv._launch_mm_indices(q, tab_mm), 20),
        E4=event_ms(lambda: nv._launch_payload(q, tab_mm, pay), 20),
        E6=event_ms(lambda: nv._launch_pruned(tab6, pay), 20),
        E2=rows['vpu']['ms'], E3=best3['ms'])
    issue_ms = dict(
        E1=host_ms(lambda: nv.nn_indices_mm(q, r, 'bf16'), 20),
        E4=host_ms(lambda: nv.nn_payload(q, r, pay), 20),
        E5=host_ms(lambda: nv.nn_indices_mm(q, r), 20),
        E6=host_ms(lambda: nv.nn_payload_pruned(q, r, pay), 20))
    for key, table in (('E1', 'mm_bf16_setup'), ('E4', 'mm_setup'),
                       ('E5', 'mm_setup'), ('E6', 'pruned_setup')):
        log(f'  {key} with its set-up: {shoot_row[key]["ms"]:.4f} ms in '
            f'{profiled[key][0]} device launches a call ({LAUNCH_PROFILED} '
            f'calls profiled after phase 4; device ms a call: '
            f'{profiled[key][1]}), which the host issues in '
            f'{issue_ms[key]:.4f} ms; alone (tables built once by '
            f'{table}) {kernel_ms[key]:.4f} ms')
    # E6's work depends on the data: the Pallas walk (replayed in torch)
    # must pass the payload check against the kernel's result, and the
    # kernel scans the tiles that the bests merged so far do not prune,
    # which varies with block timing (it counts them).  The bound counts
    # the fewer tile pairs.
    walk_visits, walk_d2, walk_pay = nv.pruned_walk(q, r, pay)
    nv.check_payload(q, r, pay, walk_d2, walk_pay,
                     *nv.nn_payload_pruned(q, r, pay))
    e6_tiles = walk_visits.numel() * (SHOOT_R // tab6.rb)
    walk_share = int(walk_visits.sum()) / e6_tiles
    scanned6 = [int(nv.nn_payload_pruned(q, r, pay, return_visits=True)[2]
                    .sum()) / e6_tiles for _ in range(5)]
    e6_share = min(walk_share, min(scanned6))
    log(f'  E6: the Pallas walk visits {int(walk_visits.sum())} of '
        f'{e6_tiles} tile pairs, {walk_share:.4f}; the kernel scanned '
        f'{", ".join(f"{x:.4f}" for x in scanned6)} (5 calls); the bound '
        f'counts {e6_share:.4f}')
    plain = dict(
        E1=lambda: nv.nn_indices_mm_plain(q, r, 'bf16'),
        E5=lambda: nv.nn_indices_mm_plain(q, r),
        E4=lambda: nv.nn_payload_plain(q, r, pay),
        E6=lambda: nv.nn_payload_pruned_plain(q, r, pay),
        E2=lambda: nk.nn_indices_plain(q, r))
    plain_ms = {k: event_ms(fn, 3) for k, fn in plain.items()}
    plain_ms['E3'] = plain_ms['E2']
    pairs = SHOOT_Q * SHOOT_R
    exact_b = nn_bytes(SHOOT_Q, SHOOT_R)
    pay_b = nn_bytes(SHOOT_Q, SHOOT_R, payload=pay.shape[1])
    bounds = dict(
        E1=bound(pairs, INSTR_MIN, exact_b, tensor_flops=8.0 * pairs),
        E5=bound(pairs, INSTR_MIN_SCORE, exact_b),
        E4=bound(pairs, INSTR_MIN_SCORE, pay_b),
        E6=bound(e6_share * pairs, INSTR_MIN_SCORE, pay_b),
        E2=bound(pairs, INSTR_EXACT, exact_b),
        E3=bound(pairs, INSTR_EXACT, exact_b))
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
        log(f'  {key}: {row["ms"]:.4f} ms, alone {kernel_ms[key]:.4f} ms, '
            f'plain {plain_ms[key]:.4f} ms, bound {bounds[key][0]:.4f} ms '
            f'({bounds[key][1]}), library {row["library_ms"]} ms, launches '
            f'{launches[key]}')
    # E1's bound before its redesign: the argmin pass at 3 a pair.
    e1_old = bound(pairs, INSTR_ARGMIN, exact_b, tensor_flops=8.0 * pairs)
    log(f'  E1 bound: {bounds["E1"][0]:.4f} ms at {INSTR_MIN} instruction a '
        f'pair ({bounds["E1"][1]}); {e1_old[0]:.4f} ms at {INSTR_ARGMIN}')
    extra = {key: dict(launches_a_call=profiled[key][0],
                       host_ms=issue_ms[key],
                       device_ms_by_kernel=profiled[key][1])
             for key in ('E1', 'E4', 'E5', 'E6')}
    extra['E1'].update(items=rows['indices-bf16']['items'],
                       bound_ms_3_a_pair=e1_old[0],
                       library_max_d2_gap=rows['indices-bf16'][
                           'library_max_d2_gap'])
    extra['E4']['items'] = rows['payload']['items']
    extra['E5']['items'] = rows['indices-hi']['items']
    extra['E6'].update(walk_share=walk_share,
                       scanned_share=float(np.mean(scanned6)),
                       bound_share=e6_share)
    extra['E3'] = dict(sweep=sweep_line)
    log(f'phase 7 took {time.perf_counter() - t7:.1f} s (and the E1, E4-E6 '
        f'launch profiles after phase 4 {profile_s:.1f} s)')

    # 8. The production path (slice 2) ---------------------------------
    t0 = time.perf_counter()
    production = production_phase(nk, streams)
    log(f'phase 8 took {time.perf_counter() - t0:.1f} s')

    # 9. The flagship path (slice 3) ------------------------------------
    t0 = time.perf_counter()
    flag_frames = flagship_phase(nk, streams)
    log(f'phase 9 took {time.perf_counter() - t0:.1f} s')

    # 10. Multi-robot SLAM (slice 4) ------------------------------------
    t0 = time.perf_counter()
    multirobot_phase(nk, streams)
    log(f'phase 10 took {time.perf_counter() - t0:.1f} s')

    # 11. The host API and checkpoints (slice 5) --------------------------
    t0 = time.perf_counter()
    host = host_api_phase(nk, frames, smi, online_lap, flag_frames)
    kernels['K2']['launches_host_api'] = host['k2_launches']
    log(f'phase 11 took {time.perf_counter() - t0:.1f} s')

    # 12. Fleet mode and batched serving (slice 6) ------------------------
    elapsed(12)
    lane_records = fleet_phase(nk, smi, bound)

    # 13. The data path in and out (slice 7) ------------------------------
    elapsed(13)
    data_path = data_path_phase(nk, streams, smi)
    kernels['K2']['launches_kitti'] = data_path['k2_launches']

    # 14. The demos and the profiling functions (slice 8) ----------------
    elapsed(14)
    t0 = time.perf_counter()
    demos = demo_phase(nk, smi)
    kernels['K2']['launches_demo'] = demos['synthetic_pallas']['k2_launches']
    prof14 = profiling_phase(nk, smi, production, kernels['K1']['ms'],
                             queries, submap, frames)
    kernels['K1']['launches_profiling'] = prof14['k1_launches']
    log(f'phase 14 took {time.perf_counter() - t0:.1f} s')

    # 15. Sharding over a mesh (slice 9) ------------------------------------
    elapsed(15)
    shard_launches, sharding_out = sharding_phase(nk, smi)
    lane_records[0]['launches_sharded'] = shard_launches['pallas K1L'][0]
    lane_records[1]['launches_sharded'] = shard_launches['pallas K2L'][1]

    # Records ----------------------------------------------------------
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
             kernel_ms=kernel_ms[key], plain_ms=plain_ms[key],
             bound_ms=bounds[key][0], bound_by=bounds[key][1],
             library_ms=shoot_row[key]['library_ms'],
             library=shoot_row[key]['library'], **extra.get(key, {}))
        for key in ('E1', 'E2', 'E3', 'E4', 'E5', 'E6')] + lane_records}
    print(f'E3 sweep at {SHOOT_Q} x {SHOOT_R}: {json.dumps(sweep_line)}',
          flush=True)
    print('data_path: ' + json.dumps(data_path), flush=True)
    print('sharding: ' + json.dumps(sharding_out), flush=True)
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    code = 0
    try:
        main()
    except Exception:
        traceback.print_exc()
        code = 1
    finally:
        for pool in _POOL:
            pool.terminate()
            pool.join()
    sys.exit(code)
