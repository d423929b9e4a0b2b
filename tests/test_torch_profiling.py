"""The port's profiling support (``pipeline/profiling.py`` and
``core/benchmarker.device_trace``) against the JAX package's.

``step_breakdown`` must return the key set of the JAX package's
``step_breakdown`` (taken from a JAX run at reps=1 on a tiny packed
runner), time the real path (its stages, chained, give the scan, the
normals, the reading, the submap and the ICP pose that ``online_step``
gives, bit for bit on the CPU) and leave the runner bit-identical, as
``full_step_device_ms`` must.  ``nn_kernel_utilization`` gives only the
brute keys on the CPU.  The bound of ``CardPeaks`` is checked against a
hand computation at 1000 x 3001.  ``device_trace`` must write a Chrome
trace that ``json`` reads.
"""

import dataclasses
import glob
import json
import math
import os

import numpy as np
import pytest
import torch

from laser_slam_tpu import config as jcfg
from laser_slam_tpu.pipeline import online as jonline
from laser_slam_tpu.pipeline import profiling as jprofiling
from laser_slam_tpu_torch.config import (PlaceRecognitionConfig,
                                         production_config, slice1_config)
from laser_slam_tpu_torch.core import benchmarker as bench
from laser_slam_tpu_torch.pipeline import online, profiling, replay
from laser_slam_tpu_torch.pipeline import velodyne_sim as vs

torch.set_num_threads(2)
N_AZ, N_SCANS = 128, 6
N_POINTS = 2048


def small_production():
    """production_config at 64 x 128 beams, with random sampling in the
    input filters and the reading, so the generators are exercised."""
    cfg = production_config(scan_capacity=64 * N_AZ, store_capacity=4096,
                            range_image_cols=N_AZ, normal_image_cols=N_AZ,
                            reading_capacity=1024,
                            reading_sampling_ratio=0.5, window=8)
    lt = cfg.laser_track
    return dataclasses.replace(cfg, laser_track=dataclasses.replace(
        lt, input_filters=dataclasses.replace(lt.input_filters,
                                              random_sampling_ratio=0.9)))


def beam_frames():
    return list(vs.BeamStream(n_scans=N_SCANS, n_beams=64, n_azimuth=N_AZ,
                              trajectory='line', step_m=0.5,
                              range_noise_m=0.01, odom_noise=0.002, seed=5,
                              packed=True))


def synthetic_frames():
    return list(replay.SyntheticStream(
        n_scans=N_SCANS, points_per_scan=N_POINTS, trajectory='line',
        step_m=0.5, noise_m=0.005, odom_noise=0.002, seed=7))


def make_runner(kind):
    """A warmed runner of one kind and the next frame:
    'production' (packed words, window solve, projective ICP, image-PCA
    normals, random sampling), 'slice1' (xyz, full-graph solve, K2's plain
    version), 'detector' (slice 1 with a scan archive and the
    scan-context detector)."""
    if kind == 'production':
        frames = beam_frames()
        runner = online.OnlineRunner(small_production(), pose_capacity=16,
                                     factor_capacity=64, device='cpu')
        runner.enable_packed_ingest(vs.HDL64_ELEV_DEG, N_AZ)
        for f in frames[:-1]:
            runner.process_scan(f.time_ns, f.range_words, f.odom_pose7)
        return runner, frames[-1]
    frames = synthetic_frames()
    cfg = slice1_config(scan_capacity=N_POINTS, reading_capacity=512,
                        nscan_in_sub_map=3)
    kw = {}
    if kind == 'detector':
        kw = dict(archive_points=512, place_recognition=PlaceRecognitionConfig(
            detect_every=1, exclude_recent_keys=2))
    runner = online.OnlineRunner(cfg, pose_capacity=16, factor_capacity=64,
                                 device='cpu', **kw)
    for f in frames[:-1]:
        runner.process_scan(f.time_ns, f.points, f.odom_pose7)
    return runner, frames[-1]


@pytest.fixture(scope='module')
def jax_keys():
    """The key set of the JAX package's step_breakdown (profiling.py:
    169-324) on a tiny packed runner, reps=1."""
    cfg = small_production()
    jc = jcfg._from_dict(jcfg.EstimatorConfig, dataclasses.asdict(cfg))
    frames = beam_frames()
    runner = jonline.OnlineRunner(jc, pose_capacity=16, factor_capacity=64)
    runner.enable_packed_ingest(vs.HDL64_ELEV_DEG, N_AZ)
    for f in frames[:3]:
        runner.process_scan(f.time_ns, f.range_words, f.odom_pose7)
    out = jprofiling.step_breakdown(runner, frames[3].points,
                                    frames[3].odom_pose7,
                                    ranges_u16=frames[3].range_words, reps=1)
    return list(out)


def snapshot(runner):
    """Everything of the runner that profiling must leave as it was."""
    d = dict(state=[t.clone() for t in runner.state],
             gen=runner.generator.get_state().clone(),
             counters=(len(runner.key_info), runner._n_rel_host,
                       runner._n_offchain_host, dict(runner._last_key),
                       set(runner._tracks_seen), runner._n_priors_seen,
                       len(runner._pr_pending)))
    if runner.detector is not None:
        d['db'] = (runner.detector.db.clone(),
                   runner.detector.db_keys.clone(), runner.detector.n)
    return d


def assert_unchanged(runner, before):
    after = snapshot(runner)
    assert len(after['state']) == len(before['state'])
    for a, b in zip(after['state'], before['state']):
        assert torch.equal(a, b)
    assert torch.equal(after['gen'], before['gen'])
    assert after['counters'] == before['counters']
    if 'db' in before:
        assert all(torch.equal(a, b) for a, b in zip(after['db'][:2],
                                                     before['db'][:2]))
        assert after['db'][2] == before['db'][2]


def test_device_trace_writes_a_readable_trace(tmp_path):
    """A small online step under device_trace leaves one Chrome trace
    that json reads, naming the step's torch ops."""
    runner, nxt = make_runner('slice1')
    trace_dir = str(tmp_path / 'trace')
    with bench.device_trace(trace_dir):
        runner.process_scan(nxt.time_ns, nxt.points, nxt.odom_pose7)
    files = glob.glob(os.path.join(trace_dir, '*.pt.trace.json'))
    assert len(files) == 1
    with open(files[0]) as fh:
        trace = json.load(fh)
    names = {e.get('name', '') for e in trace['traceEvents']}
    assert any(n.startswith('aten::') for n in names)
    assert len(runner.key_info) == N_SCANS


@pytest.mark.parametrize('kind', ['production', 'slice1', 'detector'])
def test_step_breakdown_gives_the_jax_key_set(jax_keys, kind):
    """The JAX key set, every value finite and > 0; 'decode_packed' only
    with the range words of a packed runner."""
    runner, nxt = make_runner(kind)
    words = nxt.range_words if kind == 'production' else None
    out = profiling.step_breakdown(runner, nxt.points, nxt.odom_pose7,
                                   ranges_u16=words, reps=1)
    want = (jax_keys if kind == 'production'
            else [k for k in jax_keys if k != 'decode_packed'])
    assert list(out) == want
    assert all(math.isfinite(v) and v > 0 for v in out.values())


@pytest.mark.parametrize('kind', ['production', 'slice1', 'detector'])
def test_profiling_leaves_the_runner_bit_identical(kind):
    """step_breakdown and full_step_device_ms leave the runner's state
    tensors, generator, counters and detector database as they were,
    and the runner then integrates the scan as one never profiled."""
    runner, nxt = make_runner(kind)
    twin, _ = make_runner(kind)
    before = snapshot(runner)
    scan = nxt.range_words if kind == 'production' else nxt.points
    profiling.step_breakdown(runner, nxt.points, nxt.odom_pose7,
                             ranges_u16=nxt.range_words, reps=1)
    assert_unchanged(runner, before)
    assert profiling.full_step_device_ms(runner, nxt.points,
                                         nxt.odom_pose7, reps=1) > 0
    assert_unchanged(runner, before)
    for r in (runner, twin):
        r.process_scan(nxt.time_ns, scan, nxt.odom_pose7)
    for a, b in zip(runner.state, twin.state):
        assert torch.equal(a, b)


@pytest.mark.parametrize('kind', ['production', 'slice1'])
def test_stages_chain_to_the_online_step(kind):
    """The stages step_breakdown times, chained on the same inputs, give
    what online_step gives for the scan with a generator seeded 0: the
    stored scan and its normals, the reading's draw and the ICP pose (the
    step's ICP factor), bit for bit."""
    runner, nxt = make_runner(kind)
    stages = profiling.step_stages(runner, nxt.points, nxt.odom_pose7)
    assert list(stages) == ['ingest_filters', 'store_decimate', 'normals',
                            'submap_assembly', 'reading_prep', 'icp',
                            'window_solve']
    pts, n, od = profiling._scan_inputs(runner, nxt.points, nxt.odom_pose7)
    state = online.clone_state(runner.state)
    n_rel = int(state.n_rel)
    gen = torch.Generator()
    gen.manual_seed(0)
    st, _ = online.online_step(state, pts, n, od, runner.config,
                               first_scan=False, generator=gen,
                               odometry_free=not runner.use_odometry)
    scan = stages['store_decimate'][1]
    assert torch.equal(st.ring_points[0, -1], scan.points)
    assert torch.equal(st.ring_mask[0, -1], scan.mask)
    assert torch.equal(st.ring_normals[0, -1], stages['normals'][1])
    reference, _ = stages['submap_assembly'][1]
    assert reference.points.shape[0] == (
        runner.config.laser_track.nscan_in_sub_map * scan.points.shape[0])
    assert torch.equal(st.rel_meas[n_rel + 1], stages['icp'][1].T)
    # Each stage's call recomputes its output.
    for name in ('ingest_filters', 'store_decimate', 'normals', 'icp'):
        call, out = stages[name]
        again = call()
        a = out.points if hasattr(out, 'points') else (
            out.T if hasattr(out, 'T') else out)
        b = again.points if hasattr(again, 'points') else (
            again.T if hasattr(again, 'T') else again)
        assert torch.equal(a, b), name


def test_full_step_on_the_cpu_is_its_wall_time():
    """On a CPU runner the CPU is the device: full_step_device_ms is the
    synchronized wall ms of one step, positive and of the same order as
    full_step_wall_ms."""
    runner, nxt = make_runner('slice1')
    dev_ms = profiling.full_step_device_ms(runner, nxt.points,
                                           nxt.odom_pose7, reps=3)
    wall_ms = profiling.full_step_wall_ms(runner, nxt.points,
                                          nxt.odom_pose7, reps=3)
    assert 0 < dev_ms and 0 < wall_ms
    assert 0.2 < dev_ms / wall_ms < 5


def test_nn_kernel_utilization_on_the_cpu_gives_only_the_brute_keys():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(500, 3)).astype(np.float32)
    r = rng.normal(size=(3001, 3)).astype(np.float32)
    out = profiling.nn_kernel_utilization(q, r, reps=2, device='cpu')
    assert sorted(out) == ['nn_brute_fraction_of_bound', 'nn_brute_ms',
                           'nn_brute_point_comparisons_per_sec']
    assert all(math.isfinite(v) and v > 0 for v in out.values())
    bound_ms = profiling.CardPeaks().bound(500 * 3001,
                                           profiling.INSTR_EXACT,
                                           profiling.nn_bytes(500, 3001))[0]
    assert out['nn_brute_fraction_of_bound'] == pytest.approx(
        bound_ms / out['nn_brute_ms'])
    assert out['nn_brute_point_comparisons_per_sec'] == pytest.approx(
        500 * 3001 / (out['nn_brute_ms'] * 1e-3))


def test_nn_kernel_utilization_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        profiling.nn_kernel_utilization(np.zeros((8, 3), np.float32),
                                        np.ones((8, 3), np.float32))


def test_card_peaks_bound_matches_a_hand_computation():
    """1000 queries x 3001 references: 3,001,000 pairs at 11 f32
    instructions over 132 SMs x 128 lanes x 1.98 GHz, against 4 x (3000 +
    9003 + 2000) bytes over 3.35 TB/s."""
    peaks = profiling.CardPeaks()
    assert peaks.f32_issue_per_s == 132 * 128 * 1.98e9
    nbytes = profiling.nn_bytes(1000, 3001)
    assert nbytes == 4 * (3 * 1000 + 3 * 3001 + 2 * 1000) == 56012
    ms, by = peaks.bound(1000 * 3001, profiling.INSTR_EXACT, nbytes)
    assert by == 'operations'
    assert ms == pytest.approx(1e3 * 3001000 * 11 / 33454080000000.0,
                               rel=1e-12)
    # The bytes bound a function of few operations a byte.
    ms, by = peaks.bound(1000 * 3001, 0.001, nbytes)
    assert by == 'bytes'
    assert ms == pytest.approx(1e3 * 56012 / 3.35e12, rel=1e-12)
    # Tensor-core FLOPs count against the bf16 rate.
    ms, by = peaks.bound(1000, 1, 0, tensor_flops=8.0 * 1000 * 3001)
    assert ms == pytest.approx(1e3 * 8.0 * 3001000 / 989e12, rel=1e-12)
    # A payload of P columns: read a row a reference, written a row a
    # query.
    assert profiling.nn_bytes(1000, 3001, payload=3) == 56012 + 4 * 3 * 4001
    # Another clock scales the instruction rate only.
    slow = dataclasses.replace(peaks, sm_clock_hz=0.99e9)
    assert slow.bound(1000 * 3001, 11, nbytes)[0] == pytest.approx(
        2 * peaks.bound(1000 * 3001, 11, nbytes)[0])


def test_sync_ms_times_one_call():
    calls = []
    ms = profiling.sync_ms(lambda: calls.append(1), reps=4)
    assert len(calls) == 5 and 0 <= ms < 1e3


def test_device_events_of_a_cpu_profile_are_none():
    """device_events reads only the card's activity: a CPU-only profile
    of a step holds none, and its merged busy time is 0."""
    from torch.profiler import ProfilerActivity, profile
    runner, nxt = make_runner('slice1')
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner.process_scan(nxt.time_ns, nxt.points, nxt.odom_pose7)
    assert profiling.device_events(prof) == []
    assert profiling._busy_ms(prof) == 0
