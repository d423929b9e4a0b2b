"""The span passes (``benchmark/stages.py``): the charge of device records
and idle gaps by span name, and ICP's view of it, on hand-made records,
launches and spans, against the charge by stage that ``stages.py`` made
before it charged by name; the numbers of an empty pass; and, on the
CPU at small sizes, pass (a) over the program's own spans beside a
traced run whose existing metrics are as before."""

import bisect
import random

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
    assert stages.by_stage(stages.SpanIndex(SPANS).chain(t)) == label


@pytest.mark.parametrize('t,name', [
    (10, 'icp.match'), (35, 'icp.trim'), (45, 'icp.gn'), (55, 'inner'),
    (70, 'icp.gn'), (5, 'other'), (95, 'other'), (250, 'other'),
    (150, 'outside'), (-1, 'outside'), (None, 'outside')])
def test_a_launch_goes_to_the_innermost_span_by_name(t, name):
    assert stages.by_name(stages.SpanIndex(SPANS).chain(t)) == name


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


RECORDS = [('a', 1000, 100, 1), ('b', 1150, 50, 2), ('c', 1180, 40, 3),
           ('d', 1300, 10, 4), ('e', 1400, 10, 5), ('f', 1500, 10, 6),
           ('g', 1520, 10, 99)]
LAUNCHES = {1: 12, 2: 33, 3: 45, 4: 55, 5: 95, 6: 150}


def test_the_charge_by_name_goes_innermost_and_sums_to_the_records():
    """The records of the test above, by name: d, launched inside
    ``inner``, goes to it and not to ``icp.gn``; e, in a root's own time,
    to ``other``; f, outside every root, and g, whose launch is missing,
    to ``outside``."""
    rows, unmatched = stages.charge(RECORDS, LAUNCHES, SPANS)
    assert {k: (v['launches'], v['idle_ns'], v['device_ns'])
            for k, v in rows.items()} == {
        'icp.match': (1, 0, 100), 'icp.trim': (1, 50, 50),
        'icp.gn': (1, 0, 40), 'inner': (1, 80, 10), 'other': (1, 90, 10),
        'outside': (2, 100, 20)}
    assert unmatched == 1
    assert sum(v['launches'] for v in rows.values()) == len(RECORDS)


def test_issue_by_name_sums_each_names_spans():
    assert stages.issue_by_name(SPANS, 1000) == {
        'fleet.icp_odometry': 100, 'icp.match': 20, 'icp.trim': 10,
        'icp.gn': 50, 'inner': 10, 'fleet.batched_icp': 100,
        'other': 100 + 100 - 80, 'outside': 1000 - 200}


# What stages.py charged before it charged by name (to ICP's stages only),
# kept as the yardstick of ICP's view.

def _old_label(spans, t):
    order = sorted(range(len(spans)), key=lambda i: spans[i].start_ns)
    starts = [spans[i].start_ns for i in order]
    if t is None:
        return 'outside'
    k = bisect.bisect_right(starts, t) - 1
    i = order[k] if k >= 0 else -1
    held = False
    while i >= 0:
        s = spans[i]
        if s.start_ns <= t <= s.end_ns:
            if s.name in stages.STAGES:
                return stages.STAGES[s.name]
            held = True
        i = s.parent
    return 'other' if held else 'outside'


def _old_attribute(records, launches, spans):
    table = {label: {'launches': 0, 'idle_ns': 0}
             for label in stages.LABELS}
    unmatched = 0
    end = None
    for _, start, dur, corr in sorted(records, key=lambda r: r[1]):
        t = launches.get(corr)
        unmatched += t is None
        row = table[_old_label(spans, t)]
        row['launches'] += 1
        if end is not None and start > end:
            row['idle_ns'] += start - end
        end = start + dur if end is None else max(end, start + dur)
    table['outside']['unmatched'] = unmatched
    return table


def _old_issue_ns(spans, wall_ns):
    out = dict.fromkeys(stages.LABELS, 0)
    for s in spans:
        if s.name in stages.STAGES:
            out[stages.STAGES[s.name]] += s.end_ns - s.start_ns
    roots = sum(s.end_ns - s.start_ns for s in spans if s.parent < 0)
    out['other'] = roots - sum(out[stages.STAGES[n]] for n in stages.STAGES)
    out['outside'] = wall_ns - roots
    return out


def _random_trace(seed):
    """Roots a few units long, each with ICP's three stages an iteration,
    spans of other names around and inside them; records launched at
    random times, some outside every root, some with no launch."""
    rng = random.Random(seed)
    spans, t = [], 0

    def add(name, parent, start, end):
        trace = spans[parent].trace if parent >= 0 else len(spans)
        spans.append(Span(name, trace, parent, start, end))
        return len(spans) - 1

    for _ in range(rng.randint(1, 3)):
        t += rng.randint(1, 50)
        root = add(rng.choice(['fleet.icp_odometry', 'fleet.batched_icp']),
                   -1, t, 0)
        for _ in range(rng.randint(1, 4)):
            for name in ('icp.match', 'icp.trim', 'icp.gn'):
                t += rng.randint(0, 5)
                start = t
                stage = add(name, root, start, 0)
                if rng.random() < 0.5:
                    t += rng.randint(1, 5)
                    a = t
                    t += rng.randint(0, 10)
                    add(rng.choice(['inner', 'nn.k2l']), stage, a, t)
                t += rng.randint(1, 20)
                spans[stage] = spans[stage]._replace(end_ns=t)
        t += rng.randint(0, 10)
        spans[root] = spans[root]._replace(end_ns=t)
    wall = t + rng.randint(0, 50)
    records, launches, dev = [], {}, 0
    for corr in range(rng.randint(1, 200)):
        dev += rng.randint(0, 30)
        records.append((f'k{corr}', dev, rng.randint(1, 20), corr))
        if rng.random() < 0.95:
            launches[corr] = rng.randint(-5, wall + 5)
    return spans, records, launches, wall


@pytest.mark.parametrize('seed', [None] + list(range(8)))
def test_icps_view_equals_the_charge_by_stage_of_before(seed):
    """On the hand-made trace (``seed`` None) and on random ones."""
    spans, records, launches, wall = (
        (SPANS, RECORDS, LAUNCHES, 1000) if seed is None
        else _random_trace(seed))
    new = stages.attribute(records, launches, spans)
    old = _old_attribute(records, launches, spans)
    assert {k: (v['launches'], v['idle_ns']) for k, v in new.items()} == \
        {k: (v['launches'], v['idle_ns']) for k, v in old.items()}
    assert new['outside']['unmatched'] == old['outside']['unmatched']
    assert stages.issue_ns(spans, wall) == _old_issue_ns(spans, wall)
    rows, _ = stages.charge(records, launches, spans)
    assert sum(v['launches'] for v in rows.values()) == len(records)


@pytest.mark.parametrize('workload', CELLS)
def test_an_empty_pass_gives_no_number(workload):
    reg = Registry(ROOT)
    assert stages.metrics(reg, workload, None) == {}
    assert stages.scanned_pct({}, 'k2') is None
    assert stages.scanned_pct({'nn.k2l.pairs': 0}, 'k2l') is None
    assert stages.scanned_pct({'nn.k2.pairs': 400,
                               'nn.k2.pairs_scanned': 300}, 'k2') == 75.0
    empty = {'units': 1, 'spans': 0, 'counters': {}, 'records': None,
             'names': {'other': {'issue_ms': 0.0},
                       'outside': {'issue_ms': 0.0}},
             'labels': {label: {'issue_ms': 0.0}
                        for label in stages.LABELS}}
    assert stages.metrics(reg, workload, empty) == {}
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
    labels, names = out['labels'], out['names']
    assert out['units'] == 2 and out['records'] is None
    # The plain 1-NN counts nothing; the GN stage counts its steps, none
    # of them fused off the card.
    assert set(out['counters']) == {'icp.gn.steps', 'icp.gn.steps_fused'}
    assert out['counters']['icp.gn.steps'] > 0
    assert out['counters']['icp.gn.steps_fused'] == 0
    assert all(labels[s]['issue_ms'] > 0 for s in ('match', 'trim', 'gn'))
    assert labels['other']['issue_ms'] >= 0
    for name, label in stages.STAGES.items():
        assert names[name] == labels[label]     # issue_ms alone
    assert set(stages.metrics(reg, workload, out)) == {
        'match_issue_ms', 'trim_issue_ms', 'gn_issue_ms'}
    assert not bench.recording() and bench.take_spans() == []
    assert 'gn' in stages.stage_line(workload, out)


@pytest.mark.parametrize('workload', CELLS)
def test_a_traced_cpu_run_prints_the_existing_metrics_as_before(workload):
    reg = Registry(ROOT)
    result = run.run_cell(reg, workload, 33, 0.3, True, device='cpu',
                          overrides=small(reg, workload))
    assert result['correct'], result['checks']
    # The card's metrics stay out; the stages' host time comes from the
    # span pass that the CPU runs.
    assert set(result['metrics']) == {'host_issue_ms', 'match_issue_ms',
                                      'trim_issue_ms', 'gn_issue_ms'}
    assert result['device']['busy_s'] == 0.0
    assert bench.take_spans() == [] and bench.take_counters() == {}


def test_the_stage_tool_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip('runs where there is no card')
    assert stages.main(['--workload', 'register-b32', '--seed', '1']) == 2
