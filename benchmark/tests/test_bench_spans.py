"""The stage passes (``benchmark/stages.py``): the attribution of device
records and idle gaps to ICP's stages on hand-made records, launches and
spans; the stage numbers of an empty pass; and, on the CPU at small
sizes, pass (a) over the program's own spans beside a traced run whose
existing metrics are as before."""

import pytest
import torch

from benchmark import generator, run, stages
from benchmark.registry import ROOT, Registry
from benchmark.tests.sizes import small
from laser_slam_tpu_torch.core import benchmarker as bench
from laser_slam_tpu_torch.core.benchmarker import Span

CELLS = ('fleet-odom-outdoor', 'register-b32')


@pytest.fixture(autouse=True)
def nothing_kept():
    bench.take_spans()
    bench.take_counters()

# One root [0, 100]: match [10, 30], trim [30, 40], gn [40, 90] with a
# span of its own [50, 60] inside; a second root [200, 300], no stage.
SPANS = [Span('fleet.icp_odometry', 0, -1, 0, 100),
         Span('icp.match', 0, 0, 10, 30),
         Span('icp.trim', 0, 0, 30, 40),
         Span('icp.gn', 0, 0, 40, 90),
         Span('inner', 0, 3, 50, 60),
         Span('fleet.batched_icp', 1, -1, 200, 300)]


@pytest.mark.parametrize('t,label', [
    (10, 'match'), (29, 'match'), (35, 'trim'), (55, 'gn'), (70, 'gn'),
    (5, 'other'), (95, 'other'), (250, 'other'), (150, 'outside'),
    (-1, 'outside'), (400, 'outside'), (None, 'outside')])
def test_a_launch_goes_to_the_innermost_stage_that_holds_it(t, label):
    assert stages.SpanIndex(SPANS).label(t) == label


def test_a_gap_goes_to_the_stage_of_the_record_that_ends_it():
    # (name, device start, ns, correlation id); launches by id.
    records = [('a', 1000, 100, 1),     # match; no gap before the first
               ('b', 1150, 50, 2),      # trim, after a 50 ns gap
               ('c', 1180, 40, 3),      # gn, overlaps b: no gap
               ('d', 1300, 10, 4),      # gn, after 80 ns
               ('e', 1400, 10, 5),      # other, after 90 ns
               ('f', 1500, 10, 6),      # launched outside every root
               ('g', 1520, 10, 99)]     # no launch record: outside
    launches = {1: 12, 2: 33, 3: 45, 4: 55, 5: 95, 6: 150}
    table = stages.attribute(records, launches, SPANS)
    assert {k: (v['launches'], v['idle_ns']) for k, v in table.items()} == {
        'match': (1, 0), 'trim': (1, 50), 'gn': (2, 80), 'other': (1, 90),
        'outside': (2, 100)}
    assert table['outside']['unmatched'] == 1
    assert sum(v['launches'] for v in table.values()) == len(records)


def test_issue_splits_the_wall_time_by_label():
    issue = stages.issue_ns(SPANS, 1000)
    assert issue == {'match': 20, 'trim': 10, 'gn': 50,
                     'other': 100 + 100 - 80, 'outside': 1000 - 200}


def test_an_empty_pass_gives_no_number():
    assert stages.metrics(None) == {}
    assert stages.scanned_pct({}, 'k2') is None
    assert stages.scanned_pct({'nn.k2l.pairs': 0}, 'k2l') is None
    assert stages.scanned_pct({'nn.k2.pairs': 400,
                               'nn.k2.pairs_scanned': 300}, 'k2') == 75.0
    empty = {'units': 1, 'spans': 0, 'counters': {}, 'records': None,
             'labels': {label: {'issue_ms': 0.0}
                        for label in stages.LABELS}}
    assert set(stages.metrics(empty)) == {'match_issue_ms',
                                          'trim_issue_ms', 'gn_issue_ms'}
    assert 'match - launches, issue 0.000 ms' in stages.stage_line('w',
                                                                 empty)


@pytest.mark.parametrize('workload', CELLS)
def test_pass_a_reads_the_programs_spans_on_the_cpu(workload):
    reg = Registry(ROOT)
    over = small(reg, workload)
    cell = reg.workload(workload)
    config = dict(reg.config(cell['config']), **over['config'])
    traffic = dict(reg.traffic(cell['traffic']), **over['traffic'])
    gen = generator.make(reg, config, traffic, 2 ** 31 + 11,
                         torch.device('cpu'))
    gen.setup_program()
    out = stages.span_passes(gen, [0, 1])
    labels = out['labels']
    assert out['units'] == 2 and out['records'] is None
    assert out['counters'] == {}          # the plain 1-NN counts nothing
    assert all(labels[s]['issue_ms'] > 0 for s in ('match', 'trim', 'gn'))
    assert labels['other']['issue_ms'] >= 0
    assert set(stages.metrics(out)) == {'match_issue_ms', 'trim_issue_ms',
                                        'gn_issue_ms'}
    assert not bench.recording() and bench.take_spans() == []
    assert 'gn' in stages.stage_line(workload, out)


@pytest.mark.parametrize('workload', CELLS)
def test_a_traced_cpu_run_prints_the_existing_metrics_as_before(workload):
    reg = Registry(ROOT)
    result = run.run_cell(reg, workload, 33, 0.3, True, device='cpu',
                          overrides=small(reg, workload))
    assert result['correct'], result['checks']
    assert set(result['metrics']) == {'host_issue_ms'}
    assert result['device']['busy_s'] == 0.0
    assert bench.take_spans() == [] and bench.take_counters() == {}


def test_the_stage_tool_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip('runs where there is no card')
    assert stages.main(['--workload', 'register-b32', '--seed', '1']) == 2
