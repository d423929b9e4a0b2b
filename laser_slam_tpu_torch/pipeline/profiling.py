"""Per-stage timing of the online step and kernel roofline accounting.

Counterpart of ``laser_slam_tpu/pipeline/profiling.py``.  The JAX module
times every stage as one device program and relates the two exact-NN
kernels to the chip's peaks.  Here:

- a stage is timed by :func:`sync_ms`: synchronized wall ms of one call
  after a warm call (the host's issue and the card's work together);
- the card's work is :func:`device_busy_ms`: the summed time of the
  device activity ``torch.profiler`` records for one call, overlapping
  intervals merged;
- a kernel's bound comes from :class:`CardPeaks`: the larger of its
  bytes over the card's memory rate and its operations over the card's
  rate for their type.  ``chip_smoke.py`` takes its bounds from here too.

The JAX module's chained-marginal timing (a fori_loop of perturbed stage
calls at two chain lengths) is a workaround for a TPU dispatch floor and
has no counterpart.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

# f32 lane instructions per (query, reference) pair that a 1-NN function
# needs: the arithmetic and what keeps the running minimum (value and
# index for the exact kernels; the score's minimum alone for the matmul
# form, whose index, ties and payloads are an epilogue's second scoring
# of one tile a query, not counted).
INSTR_EXACT = 11        # 3 sub, 3 mul, 2 add, compare, 2 selects (K1, K2)
INSTR_ARGMIN = 3        # compare, 2 selects (E1 bf16's earlier argmin pass)
INSTR_MIN = 1           # min (E1 bf16: the product on the tensor cores)
INSTR_MIN_SCORE = 4     # 3 FMA, min (E4, E5, E6)


@dataclasses.dataclass(frozen=True)
class CardPeaks:
    """A card's peak rates.  The defaults are those of the card they were
    taken for, the NVIDIA H100 80GB HBM3: 132 SMs of 128 f32 lanes at a
    1.98 GHz max SM clock, 3.35 TB/s of HBM, 989 TFLOP/s of dense bf16
    tensor-core work."""
    name: str = 'NVIDIA H100 80GB HBM3'
    sm_count: int = 132
    lanes_per_sm: int = 128
    sm_clock_hz: float = 1.98e9
    hbm_bytes_per_s: float = 3.35e12
    bf16_tensor_flops: float = 989e12

    @property
    def f32_issue_per_s(self) -> float:
        """f32 lane instructions a second over the whole card."""
        return self.sm_count * self.lanes_per_sm * self.sm_clock_hz

    def bound(self, pairs: float, instr: float, nbytes: float,
              tensor_flops: float = 0.0) -> Tuple[float, str]:
        """(bound_ms, bound_by) of a function that does ``instr`` f32 lane
        instructions for each of ``pairs`` pairs (and ``tensor_flops`` bf16
        tensor-core FLOPs) and must move ``nbytes``: the larger of bytes
        over HBM and operations over their unit's peak."""
        t_ops = max(pairs * instr / self.f32_issue_per_s,
                    tensor_flops / self.bf16_tensor_flops)
        t_bytes = nbytes / self.hbm_bytes_per_s
        return (1e3 * max(t_ops, t_bytes),
                'operations' if t_ops >= t_bytes else 'bytes')


def card_peaks(device=None, sm_clock_hz: Optional[float] = None
               ) -> CardPeaks:
    """The peaks of a CUDA card: its name and SM count from
    ``torch.cuda.get_device_properties``; the max SM clock from the
    caller (``nvidia-smi --query-gpu=clocks.max.sm``), else the
    default's.  Memory and tensor rates are the defaults'."""
    props = torch.cuda.get_device_properties(
        torch.device('cuda') if device is None else device)
    kw = dict(name=props.name, sm_count=props.multi_processor_count)
    if sm_clock_hz is not None:
        kw['sm_clock_hz'] = float(sm_clock_hz)
    return CardPeaks(**kw)


def nn_bytes(nq: int, nr: int, payload: int = 0) -> int:
    """Bytes a 1-NN function must move: queries and references [.,3] f32
    read once, d2 and idx written once, and ``payload`` f32 columns of the
    references read and of the queries written."""
    return 4 * (3 * nq + 3 * nr + 2 * nq + payload * (nr + nq))


def _synchronize() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def sync_ms(fn: Callable[[], object], reps: int = 5) -> float:
    """Mean wall ms of one call of ``fn``, synchronized before and after
    (after one warm call): the host's issue and the card's work
    together.  On the CPU, plain wall ms."""
    fn()
    _synchronize()
    spent = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _synchronize()
        spent.append(time.perf_counter() - t0)
    return 1e3 * float(np.mean(spent))


def event_ms(fn: Callable[[], object], reps: int = 5) -> float:
    """Mean ms of one call on the card by CUDA events around ``reps``
    calls issued back to back (after one warm call)."""
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


def device_events(prof) -> List[Tuple[str, int, int]]:
    """The device activity (kernels, copies, fills) of a finished
    ``torch.profiler`` profile as (name, start ns, duration ns) records,
    read from the profiler's own events: building its ``key_averages()``
    takes many times longer on a profile of many launches."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def _busy_ms(prof) -> float:
    """Summed ms of the device activity in a finished profile, overlapping
    intervals merged."""
    spans = sorted((start, start + dur)
                   for _, start, dur in device_events(prof))
    busy, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e6


def _profiled_busy_ms(fn: Callable[[], object]) -> float:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _busy_ms(prof)


def device_busy_ms(fn: Callable[[], object]) -> float:
    """Device ms of one call of ``fn`` on the card (after one warm call):
    the summed time of the kernels, copies and fills that
    ``torch.profiler`` records, overlapping intervals merged.  This is
    what "device ms" means on the card; the host's launch gaps are not
    in it."""
    fn()
    return _profiled_busy_ms(fn)


def _scan_inputs(runner, points, odom_pose7):
    """The scan padded to the runner's capacity on its device, its valid
    count, and the odometry pose."""
    pts, n = runner._pad_xyz(points)
    return (torch.from_numpy(pts).to(runner.device), n,
            torch.tensor(np.asarray(odom_pose7, np.float32),
                         device=runner.device))


def _next_step(runner, points, odom_pose7, seed: int = 0):
    """(make, step): ``make()`` returns a fresh clone of the runner's state
    (grown by one key and two factors where it is full), ``step(state)``
    runs one ``online_step`` of the scan on it, as the runner would for
    track 0's next scan, with a generator of its own seeded ``seed``.
    Neither touches the runner."""
    from laser_slam_tpu_torch.pipeline import online
    pts, n, od = _scan_inputs(runner, points, odom_pose7)
    first = 0 not in runner._tracks_seen
    prev = runner._last_key.get(0)
    key = len(runner.key_info)
    offchain = runner._n_offchain_host + (
        2 if prev is not None and runner._may_be_offchain(prev, key) else 0)

    def make():
        st = online.clone_state(runner.state)
        grow = {}
        if key + 1 > st.traj_poses.shape[0]:
            grow['pose_capacity'] = 2 * st.traj_poses.shape[0]
        if runner._n_rel_host + 2 > st.rel_meas.shape[0]:
            grow['factor_capacity'] = 2 * st.rel_meas.shape[0]
        return online.grow_state(st, **grow) if grow else st

    def step(st):
        gen = torch.Generator(device=runner.device)
        gen.manual_seed(seed)
        return online.online_step(
            st, pts, n, od, runner.config, first_scan=first, track_id=0,
            generator=gen, odometry_free=not runner.use_odometry,
            offchain=offchain)

    return make, step


def full_step_wall_ms(runner, points: np.ndarray, odom_pose7: np.ndarray,
                      reps: int = 5) -> float:
    """Synchronized wall ms of one ``online_step`` of the scan on a clone
    of the warmed runner's state (median of ``reps``, after a warm
    step); the runner is left as it was."""
    make, step = _next_step(runner, points, odom_pose7)
    step(make())
    spent = []
    for _ in range(reps):
        st = make()
        _synchronize()
        t0 = time.perf_counter()
        step(st)
        _synchronize()
        spent.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(spent))


def full_step_device_ms(runner, points: np.ndarray, odom_pose7: np.ndarray,
                        reps: int = 5) -> float:
    """Device ms of ONE online step on a WARMED runner: the median over
    ``reps`` of :func:`device_busy_ms`-style profiles of one
    ``online_step`` of the scan on a fresh clone of the runner's state
    (the clone is made outside the profile).  ``1e3 / result`` is the
    device-bound scans/s ceiling of the per-scan path at this density.
    On a CPU runner the CPU is the device, and the number is
    :func:`full_step_wall_ms`.  The runner's state, generator and
    counters are left as they were."""
    if runner.device.type != 'cuda':
        return full_step_wall_ms(runner, points, odom_pose7, reps)
    make, step = _next_step(runner, points, odom_pose7)
    step(make())
    spent = []
    for _ in range(reps):
        st = make()
        spent.append(_profiled_busy_ms(lambda: step(st)))
    return float(np.median(spent))


def step_stages(runner, points: np.ndarray, odom_pose7: np.ndarray,
                seed: int = 0) -> Dict[str, Tuple[Callable[[], object],
                                                   object]]:
    """The stages of one online step of the scan on the runner, in order:
    {name: (call, output)}, each call fed the outputs of the stages
    before it and ``output`` its result.  Chained, they compute what
    ``online_step`` computes for the scan with a generator seeded
    ``seed`` (the samples are drawn in the step's order from a generator
    of their own): the filters, the store decimation, the normals, the
    submap, the reading, the ICP from the step's guess and the solve the
    step runs (the window solve, or the full-graph solve of a window-0
    config) on the runner's graph.  Every call runs on copies where the
    function writes into its inputs; nothing touches the runner."""
    from laser_slam_tpu_torch.graph import solver as sv
    from laser_slam_tpu_torch.ops import icp as icp_mod, se3
    from laser_slam_tpu_torch.ops.range_image import compute_normals
    from laser_slam_tpu_torch.pipeline import online
    cfg = runner.config
    lt = cfg.laser_track
    f = lt.input_filters
    state = runner.state
    pts, n, od = _scan_inputs(runner, points, odom_pose7)
    gen = torch.Generator(device=runner.device)
    gen.manual_seed(seed)
    timing_gen = torch.Generator(device=runner.device)
    timing_gen.manual_seed(seed)
    stages = {}

    def stage(name, call, chained):
        stages[name] = (call, chained())

    stage('ingest_filters',
          lambda: online.input_filters(pts, n, f, timing_gen),
          lambda: online.input_filters(pts, n, f, gen))
    filtered = stages['ingest_filters'][1]
    stage('store_decimate', lambda: online.store_decimate(filtered, f),
          lambda: online.store_decimate(filtered, f))
    scan = stages['store_decimate'][1]
    stage('normals', lambda: compute_normals(scan, lt.icp),
          lambda: compute_normals(scan, lt.icp))
    stage('submap_assembly', lambda: online.submap(state, 0),
          lambda: online.submap(state, 0))
    reference, ref_normals = stages['submap_assembly'][1]
    stage('reading_prep',
          lambda: online.sample_reading(scan, lt.icp, timing_gen),
          lambda: online.sample_reading(scan, lt.icp, gen))
    reading = stages['reading_prep'][1]
    guess, _ = online.step_guess(state, se3.normalize(od), 0,
                                 not runner.use_odometry)
    icp = lambda: icp_mod.icp_point_to_plane(  # noqa: E731
        reading, reference, ref_normals, guess, lt.icp)
    stage('icp', icp, icp)
    i = state.n_poses - 1
    if cfg.solver.window > 0:
        solve = lambda: online._window_solve(  # noqa: E731
            state._replace(traj_poses=state.traj_poses.clone()), i, cfg)
    else:
        mask = (torch.arange(state.traj_poses.shape[0],
                             device=runner.device) <= i)
        solve = lambda: sv.solve(  # noqa: E731
            online._graph_view(state), state.traj_poses.clone(), mask,
            cfg.solver, runner._n_offchain_host)
    stage('window_solve', solve, solve)
    return stages


def _pr_stage(runner):
    """The place-recognition query (descriptor of the newest stored scan
    and the query einsum) at the runner's own detector database, or at a
    4096-entry zero database without one."""
    from laser_slam_tpu_torch.config import PlaceRecognitionConfig
    from laser_slam_tpu_torch.ops import scan_context as sc
    det = runner.detector
    pr_cfg = det.config if det is not None else PlaceRecognitionConfig()
    dev = runner.device
    if det is not None and det.db.shape[0] > 1:
        db, dbk = det.db, det.db_keys
    else:
        db = torch.zeros((4096, pr_cfg.n_rings, pr_cfg.n_sectors),
                         dtype=torch.float32, device=dev)
        dbk = torch.arange(4096, dtype=torch.int32, device=dev)
    sp = runner.state.ring_points[0, -1]
    sm = runner.state.ring_mask[0, -1]
    return lambda: sc.descriptor_and_query(
        db, dbk, sp, sm, db.shape[0], n_rings=pr_cfg.n_rings,
        n_sectors=pr_cfg.n_sectors, max_radius_m=pr_cfg.max_radius_m,
        z_offset_m=pr_cfg.z_offset_m)[1]


def step_breakdown(runner, points: np.ndarray, odom_pose7: np.ndarray,
                   ranges_u16: Optional[np.ndarray] = None,
                   reps: int = 5) -> Dict[str, float]:
    """Stage-level ms of one online step on a WARMED runner, the keys of
    the JAX package's ``step_breakdown``.

    ``full_step`` is :func:`full_step_device_ms`, the only device-busy
    figure.  Every other value is :func:`sync_ms` of one call of a stage
    of :func:`step_stages` (``ingest_filters``, ``store_decimate``,
    ``normals``, ``submap_assembly``, ``reading_prep``, ``icp``,
    ``window_solve``), of the packed uint16 -> xyz decode
    (``decode_packed``, when ``ranges_u16`` is given and the runner has a
    beam table) and of the place-recognition query (``pr_query``).  On
    the card a host-bound stage's ms includes its launch gaps, so it is
    not the device ms that the JAX module reports.  The runner is left as
    it was."""
    from laser_slam_tpu_torch.ops import spherical
    out = {'full_step': full_step_device_ms(runner, points, odom_pose7,
                                            reps=reps)}
    if ranges_u16 is not None and runner._beam_table is not None:
        table = runner._beam_table
        unit = runner._range_unit_m or spherical.RANGE_UNIT_M
        words = spherical.words_to_device(np.asarray(ranges_u16, np.uint16),
                                          runner.device)
        out['decode_packed'] = sync_ms(
            lambda: spherical.decode_and_pack(words, table, unit), reps)
    for name, (call, _) in step_stages(runner, points, odom_pose7).items():
        out[name] = sync_ms(call, reps)
    out['pr_query'] = sync_ms(_pr_stage(runner), reps)
    return out


def nn_kernel_utilization(reading, reference, reps: int = 5,
                          peaks: Optional[CardPeaks] = None,
                          device='cuda') -> Dict[str, float]:
    """Roofline numbers of the exact 1-NN at Q readings x R reference
    points (arrays or tensors, moved to ``device``: the card unless the
    caller asks for the CPU).

    Brute (``neighbors.nn_brute``, coordinate-wise (q-r)^2 in torch):
    ``nn_brute_ms`` (CUDA events on the card, synchronized wall ms on the
    CPU), its point comparisons a second, and its fraction of the exact
    1-NN bound: 11 f32 instructions a pair (``INSTR_EXACT``) and the
    bytes of :func:`nn_bytes`, against ``peaks`` (:func:`card_peaks` on
    the card; on the CPU the H100 defaults, so the fraction is the CPU's
    share of that card's bound).  On the card K1 (``nn_kernels.
    nn_indices``) too: ``k1_ms`` by CUDA events, its bound and what bounds
    it, its fraction of the bound, its achieved HBM GB/s over the bytes
    of :func:`nn_bytes` and its point comparisons a second.  On the CPU
    the K1 keys are absent."""
    from laser_slam_tpu_torch.ops import neighbors
    from laser_slam_tpu_torch.ops import nn_kernels as nk
    from laser_slam_tpu_torch.pipeline.online import resolve_device
    dev = resolve_device(device)
    q = torch.as_tensor(reading, dtype=torch.float32).to(dev).contiguous()
    r = torch.as_tensor(reference, dtype=torch.float32).to(dev).contiguous()
    on_card = dev.type == 'cuda'
    if peaks is None:
        peaks = card_peaks(dev) if on_card else CardPeaks()
    Q, R = q.shape[0], r.shape[0]
    bound_ms, bound_by = peaks.bound(Q * R, INSTR_EXACT, nn_bytes(Q, R))
    timer = event_ms if on_card else sync_ms
    ms = timer(lambda: neighbors.nn_brute(q, r), reps)
    out = dict(nn_brute_ms=ms,
               nn_brute_point_comparisons_per_sec=Q * R / (ms * 1e-3),
               nn_brute_fraction_of_bound=bound_ms / ms)
    if on_card:
        k1 = event_ms(lambda: nk.nn_indices(q, r), reps)
        out.update(k1_ms=k1, k1_bound_ms=bound_ms, k1_bound_by=bound_by,
                   k1_fraction_of_bound=bound_ms / k1,
                   k1_achieved_hbm_gbps=nn_bytes(Q, R) / (k1 * 1e-3) / 1e9,
                   k1_point_comparisons_per_sec=Q * R / (k1 * 1e-3))
    return out
