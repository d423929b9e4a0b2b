"""The port's spans and counters (``core/benchmarker.py``) and the spans of
its ICP loop, on the CPU, without JAX.

* Spans nest: a span's parent is the span open on its thread, a root opens
  a new trace id that its descendants share, and one thread's open spans
  are no parent of another's.
* With recording off nothing is kept, and the topic registry times its
  topics as it did.  ``record_spans`` restores the state before it, on an
  exception too.
* ``icp_point_to_plane`` records one ``icp.match``, ``icp.trim`` and
  ``icp.gn`` an executed iteration, in that order, under the root around
  it; ``fleet_icp_odometry`` and ``batched_icp`` are roots and return
  bit-identical results with recording on and off.  On the CPU the
  pruned 1-NN runs its plain version, which counts nothing, and the GN
  stage its plain twin, whose steps count as steps, none of them fused.
"""

import math
import threading

import pytest
import torch

from laser_slam_tpu_torch.config import IcpConfig
from laser_slam_tpu_torch.core import benchmarker as bench
from laser_slam_tpu_torch.ops import cloud as pc
from laser_slam_tpu_torch.ops import icp as icp_mod
from laser_slam_tpu_torch.ops import se3
from laser_slam_tpu_torch.parallel import fleet

torch.set_num_threads(2)
STAGES = ('icp.match', 'icp.trim', 'icp.gn')


@pytest.fixture(autouse=True)
def clean_state():
    """Each test starts and ends with nothing kept and the registry off."""
    bench.disable()
    bench.take_spans()
    bench.take_counters()
    yield
    bench.disable()
    bench.reset_topic()
    bench.take_spans()
    bench.take_counters()
    assert not bench.recording()


def test_spans_nest_under_one_trace_a_root():
    with bench.record_spans():
        with bench.span('a'):
            with bench.span('b'):
                with bench.span('c'):
                    pass
            with bench.span('d'):
                pass
        with bench.span('e'):
            pass
    spans = bench.take_spans()
    assert [s.name for s in spans] == ['a', 'b', 'c', 'd', 'e']
    assert [s.parent for s in spans] == [-1, 0, 1, 0, -1]
    assert len({s.trace for s in spans[:4]}) == 1
    assert spans[4].trace != spans[0].trace
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert bench.take_spans() == []


def test_one_threads_open_spans_are_no_parent_of_anothers():
    opened, release = threading.Event(), threading.Event()

    def other():
        opened.wait()
        with bench.span('other'):
            with bench.span('other.child'):
                pass
        release.set()

    with bench.record_spans():
        worker = threading.Thread(target=other)
        worker.start()
        with bench.span('main'):
            opened.set()
            release.wait()
        worker.join()
    spans = bench.take_spans()
    names = [s.name for s in spans]
    assert sorted(names) == ['main', 'other', 'other.child']
    main, other = spans[names.index('main')], spans[names.index('other')]
    child = spans[names.index('other.child')]
    assert main.parent == -1 and other.parent == -1
    assert other.trace != main.trace
    assert child.parent == names.index('other')
    assert child.trace == other.trace


def test_many_threads_lose_no_span_parent_or_count():
    """16 threads switching every microsecond: every span is kept, every child points at its own
    thread's parent, every root opens its own trace, no count is lost."""
    import sys
    threads, rounds = 16, 200

    def work(j):
        for _ in range(rounds):
            with bench.span(f't{j}'):
                with bench.span(f't{j}.child'):
                    bench.add_count('n', 1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with bench.record_spans():
            pool = [threading.Thread(target=work, args=(j,))
                    for j in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    spans = bench.take_spans()
    assert len(spans) == 2 * threads * rounds
    roots = [s for s in spans if s.parent == -1]
    assert len(roots) == threads * rounds
    assert len({s.trace for s in roots}) == threads * rounds
    for s in spans:
        if s.parent >= 0:
            p = spans[s.parent]
            assert s.name == p.name + '.child' and s.trace == p.trace
    assert bench.take_counters() == {'n': threads * rounds}


def test_spans_share_the_profilers_clock():
    """A span's stamps and torch.profiler's records read one clock."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with bench.record_spans(), bench.span('mul'):
            x * 2
    (s,) = bench.take_spans()
    muls = [e for e in prof.profiler.kineto_results.events()
            if e.name() == 'aten::mul']
    assert muls
    for e in muls:
        assert s.start_ns <= e.start_ns() <= s.end_ns


def test_recording_off_keeps_nothing_and_the_registry_times_as_before():
    assert bench.span('x') is bench.span('y')     # one shared no-op
    with bench.span('off'):
        pass
    assert bench.take_spans() == [] and bench.statistics() == {}
    bench.enable()
    with bench.scoped_timer('timed'):
        pass
    assert bench.take_spans() == []
    mean, std, count = bench.statistics()['timed']
    assert count == 1 and 0.0 <= mean < 1e3 and std == 0.0
    with bench.record_spans():
        with bench.scoped_timer('timed'):
            pass
    assert bench.statistics()['timed'][2] == 2
    assert [s.name for s in bench.take_spans()] == ['timed']
    bench.disable()
    with bench.scoped_timer('timed'):
        pass
    assert bench.statistics()['timed'][2] == 2


def test_record_spans_restores_the_state_on_an_exception():
    with pytest.raises(RuntimeError):
        with bench.record_spans():
            with bench.span('outer'):
                raise RuntimeError('inside')
    assert not bench.recording()
    assert bench.span('after') is bench.span('again')
    (s,) = bench.take_spans()
    assert s.name == 'outer' and s.end_ns >= s.start_ns
    with bench.record_spans():
        with pytest.raises(ValueError):
            with bench.record_spans():
                raise ValueError('nested')
        assert bench.recording()
        with bench.span('still'):
            pass
    assert not bench.recording()
    assert [s.parent for s in bench.take_spans()] == [-1]


def test_counters_are_kept_only_while_recording():
    bench.add_count('n', 3)
    with bench.record_spans():
        bench.add_count('n', 4)
        bench.counter('d', 'cpu').add_(torch.tensor(5), alpha=2)
        bench.counter('d', 'cpu').add_(1)
    assert bench.take_counters() == {'n': 7, 'd': 11}
    assert bench.take_counters() == {}


def box_scene(n_ref=1536, n_read=512, seed=0):
    """Points on the five faces of a 10 x 8 x 4 m room (no ceiling), the
    reading a noisy subset turned by 0.02 rad and moved by ~12 cm."""
    g = torch.Generator().manual_seed(seed)
    pts = (torch.rand((n_ref, 3), generator=g, dtype=torch.float64)
           * torch.tensor([10.0, 8.0, 4.0], dtype=torch.float64)
           - torch.tensor([5.0, 4.0, 0.0], dtype=torch.float64))
    walls = torch.tensor([[0, -5.0], [0, 5.0], [1, -4.0], [1, 4.0],
                          [2, 0.0]], dtype=torch.float64)
    face = torch.randint(0, 5, (n_ref,), generator=g)
    pts[torch.arange(n_ref), walls[face, 0].long()] = walls[face, 1]
    rows = torch.randperm(n_ref, generator=g)[:n_read]
    reading = pts[rows] + 0.005 * torch.randn((n_read, 3), generator=g,
                                              dtype=torch.float64)
    c, s = math.cos(0.02), math.sin(0.02)
    R = torch.tensor([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=torch.float64)
    reading = reading @ R.T + torch.tensor([0.1, -0.05, 0.02],
                                           dtype=torch.float64)
    cloud = pc.Cloud(pts.float(), torch.ones(n_ref, dtype=torch.bool))
    return reading.float(), cloud, pc.estimate_normals(cloud, 10)


def stage_names(spans):
    return [s.name for s in spans if s.name in STAGES]


@pytest.mark.parametrize('early_break', [True, False])
def test_icp_records_each_stage_once_an_iteration(early_break):
    reading, ref, normals = box_scene()
    cfg = IcpConfig(matcher='brute', reading_capacity=512,
                    reading_sampling_ratio=1.0, max_iterations=12)
    with bench.record_spans():
        with bench.span('unit'):
            res = icp_mod.icp_point_to_plane(
                pc.Cloud(reading, torch.ones(512, dtype=torch.bool)), ref,
                normals, se3.identity(), cfg, early_break=early_break)
    spans = bench.take_spans()
    passes = int(res.iterations) if early_break else cfg.max_iterations
    assert bool(res.valid) and 1 <= int(res.iterations) < 12
    assert stage_names(spans) == list(STAGES) * passes
    assert spans[0].name == 'unit' and len(spans) == 1 + 3 * passes
    assert all(s.parent == 0 and s.trace == spans[0].trace
               for s in spans[1:])
    for a, b in zip(spans[1:], spans[2:]):
        assert a.end_ns <= b.start_ns


def fleet_inputs(B=3, T=3, N=512):
    """B lanes, each T scans of its own room, scan t the room moved by a
    few cm from scan t-1."""
    rooms = [box_scene(n_ref=N, n_read=N, seed=s) for s in range(B)]
    g = torch.Generator().manual_seed(7)
    shift = torch.cumsum(0.05 * torch.randn((B, T, 1, 3), generator=g), 1)
    points = (torch.stack([r[1].points for r in rooms])[:, None]
              + shift).contiguous()
    normals = torch.stack([r[2] for r in rooms])[:, None].expand(
        B, T, N, 3).contiguous()
    masks = torch.ones((B, T, N), dtype=torch.bool)
    init = se3.identity().expand(B, 7).contiguous()
    odom = se3.identity().expand(B, T, 7).contiguous()
    return points, masks, normals, init, odom


def assert_same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize('matcher,prune', [('pallas', True),
                                           ('pallas', False),
                                           ('brute', True)])
def test_fleet_odometry_is_one_root_and_unchanged_by_recording(matcher,
                                                              prune):
    inputs = fleet_inputs()
    cfg = IcpConfig(matcher=matcher, pallas_prune=prune,
                    reading_capacity=512, reading_sampling_ratio=1.0,
                    max_iterations=6)
    off = fleet.fleet_icp_odometry(*inputs, cfg)
    assert bench.take_spans() == []
    with bench.record_spans():
        on = fleet.fleet_icp_odometry(*inputs, cfg)
    assert_same(off, on)
    spans = bench.take_spans()
    assert spans[0].name == 'fleet.icp_odometry' and spans[0].parent == -1
    assert all(s.parent == 0 and s.trace == spans[0].trace
               for s in spans[1:])
    names = stage_names(spans)
    assert len(names) == len(spans) - 1 and len(names) % 3 == 0
    assert names == list(STAGES) * (len(names) // 3)
    assert 2 <= len(names) // 3 <= 2 * cfg.max_iterations
    # The plain 1-NN counts nothing; the GN stage counts its steps, none
    # of them taken by the kernels on the CPU.
    assert bench.take_counters() == {'icp.gn.steps': len(names) // 3,
                                     'icp.gn.steps_fused': 0}


def test_batched_icp_is_one_root_and_unchanged_by_recording():
    reading, ref, normals = box_scene(n_ref=2048, n_read=256, seed=3)
    B = 4
    g = torch.Generator().manual_seed(4)
    points = (reading[None] + 0.03 * torch.randn((B, 1, 3), generator=g)
              ).contiguous()
    masks = torch.ones((B, 256), dtype=torch.bool)
    masks[1, ::5] = False
    guesses = se3.identity().expand(B, 7).contiguous()
    cfg = IcpConfig(matcher='pallas', reading_capacity=256,
                    reading_sampling_ratio=1.0, max_iterations=10)
    off = fleet.batched_icp(points, masks, ref, normals, guesses, cfg)
    with bench.record_spans():
        on = fleet.batched_icp(points, masks, ref, normals, guesses, cfg)
    assert_same(off, on)
    spans = bench.take_spans()
    assert spans[0].name == 'fleet.batched_icp' and spans[0].parent == -1
    assert stage_names(spans) == list(STAGES) * ((len(spans) - 1) // 3)
    assert (len(spans) - 1) // 3 == int(on.iterations.max())
