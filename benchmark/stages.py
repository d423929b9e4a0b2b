"""Where a unit's host issue and device idle time go, span by span of the
program, from the program's own spans and counters
(``laser_slam_tpu_torch/core/benchmarker.py``: ``record_spans``,
``take_spans``, ``take_counters``).

    python3 -m benchmark.stages --workload <name> --seed <n>

on a machine with the card the cell asks for.  After the cell's set-up
and one warm-up unit it runs the two span passes of :func:`span_passes`
over the units that a run of the cell checks (units 1 .. ``check_units``),
the passes that ``run.py`` runs after a ``--trace 1`` run's window over
its checked units for the per-layer readers (``TraceContext.spans`` and
``.counters``):

(a) span recording on, no profiler: each span name's host time a unit
    (the summed durations of its spans) and each counter a unit, such as
    the pairs the pruned 1-NN's kernel scanned
    (``nn.<kind>.pairs_scanned``) against the pairs of its calls
    (``nn.<kind>.pairs``);
(b) span recording on, under the device-only profile of
    ``tracing.profile_units`` (on the card only): each device record is
    matched by its correlation id to the runtime's launch call on the
    host, and charged to the name of the innermost span that holds the
    launch's time, to ``other`` where that span is a root (a root's self
    time), else to ``outside`` (the benchmark's own gathers and copies).
    Each device idle gap between merged busy intervals goes to the name
    of the record that ends it; each name's device time is its records'
    merged busy time.

The tool also measures, before them, the cost of recording; after them,
the device records of the same units with recording off, in the profile
that ``launches_per_scan`` reads.  It prints ICP's view of the passes,
the same charge with each span labelled by the ICP stage it lies in
(``match``, ``trim``, ``gn``, else ``other`` or ``outside``): the last
line of standard output is a JSON object; standard error has one line a
label (launches, issue ms and idle ms a unit).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import statistics
import sys
import time
import timeit
from typing import Callable, Dict, List, Optional, Tuple

from benchmark import yardstick as ys

# The stage spans of ops/icp.py's loop, by the label they are charged to.
STAGES = {'icp.match': 'match', 'icp.trim': 'trim', 'icp.gn': 'gn'}
OTHER, OUTSIDE = 'other', 'outside'
LABELS = ('match', 'trim', 'gn', OTHER, OUTSIDE)
COST_ROUNDS = 20      # pairs of runs a unit, recording off and on


def program_spans():
    """The program's span module, or None where it keeps no spans."""
    from laser_slam_tpu_torch.core import benchmarker
    if not hasattr(benchmarker, 'record_spans'):
        return None
    return benchmarker


class SpanIndex:
    """Finds the spans that hold a host time among ``spans`` (the
    program's ``Span`` records of one thread, parents as list indices)."""

    def __init__(self, spans):
        self.spans = list(spans)
        self.order = sorted(range(len(self.spans)),
                            key=lambda i: self.spans[i].start_ns)
        self.starts = [self.spans[i].start_ns for i in self.order]

    def chain(self, t: Optional[int]) -> list:
        """The spans that hold ``t``, innermost first, a root last; empty
        where none does.  The span opened last before ``t`` lies inside
        every span that holds ``t``, so its chain of parents meets them
        all."""
        if t is None:
            return []
        k = bisect.bisect_right(self.starts, t) - 1
        i = self.order[k] if k >= 0 else -1
        out = []
        while i >= 0:
            s = self.spans[i]
            if s.start_ns <= t <= s.end_ns:
                out.append(s)
            i = s.parent
        return out


def by_name(chain) -> str:
    """The innermost span's name; ``other`` for a root's self time;
    ``outside`` where no span holds the time."""
    if not chain:
        return OUTSIDE
    return OTHER if chain[0].parent < 0 else chain[0].name


def by_stage(chain) -> str:
    """The ICP stage of the innermost stage span, else ``other`` inside a
    root, else ``outside``."""
    for s in chain:
        if s.name in STAGES:
            return STAGES[s.name]
    return OTHER if chain else OUTSIDE


def charge(records, launches: Dict[int, int], spans,
           label: Callable[[list], str] = by_name
           ) -> Tuple[Dict[str, dict], int]:
    """Device records ``(name, start ns, ns, correlation id)`` charged by
    the host time of their launch (``launches``: correlation id -> ns) to
    ``label`` of the spans holding it: by label, the records
    (``launches``), the idle ns that its records end (``idle_ns``) and
    their merged busy ns (``device_ns``); and the number of records whose
    launch is not found, which count under ``outside``."""
    index = SpanIndex(spans)
    rows: Dict[str, dict] = {}
    busy: Dict[str, list] = {}
    unmatched = 0
    end = None
    for _, start, dur, corr in sorted(records, key=lambda r: r[1]):
        t = launches.get(corr)
        unmatched += t is None
        key = label(index.chain(t))
        row = rows.setdefault(key, {'launches': 0, 'idle_ns': 0})
        row['launches'] += 1
        if end is not None and start > end:
            row['idle_ns'] += start - end
        end = start + dur if end is None else max(end, start + dur)
        busy.setdefault(key, []).append((start, start + dur))
    for key, row in rows.items():
        row['device_ns'] = ys.busy_ns(busy[key])
    return rows, unmatched


def attribute(records, launches: Dict[int, int], spans) -> Dict[str, dict]:
    """ICP's view of :func:`charge`: every label of :data:`LABELS` with
    its records, idle ns and busy ns; ``outside`` also holds
    ``unmatched``."""
    rows, unmatched = charge(records, launches, spans, by_stage)
    table = {label: rows.get(label, {'launches': 0, 'idle_ns': 0,
                                     'device_ns': 0})
             for label in LABELS}
    table[OUTSIDE]['unmatched'] = unmatched
    return table


def issue_by_name(spans, wall_ns: int) -> Dict[str, int]:
    """Host ns by span name, each the summed durations of its spans (the
    spans nested in them included); ``other``, the roots' self time (their
    durations less their children's); ``outside``, the rest of
    ``wall_ns``."""
    out: Dict[str, int] = {}
    roots = children = 0
    for s in spans:
        ns = s.end_ns - s.start_ns
        out[s.name] = out.get(s.name, 0) + ns
        if s.parent < 0:
            roots += ns
        elif spans[s.parent].parent < 0:
            children += ns
    out[OTHER] = roots - children
    out[OUTSIDE] = wall_ns - roots
    return out


def issue_ns(spans, wall_ns: int) -> Dict[str, int]:
    """ICP's view of :func:`issue_by_name`: each stage's summed span
    durations; ``other``, the roots' time outside stages; ``outside``, the
    rest of ``wall_ns``.  Stage spans do not nest in one another."""
    names = issue_by_name(spans, wall_ns)
    out = {label: names.get(name, 0) for name, label in STAGES.items()}
    out[OTHER] = wall_ns - names[OUTSIDE] - sum(out.values())
    out[OUTSIDE] = names[OUTSIDE]
    return out


def device_records(prof) -> list:
    """(name, start ns, ns, correlation id) of each device record; the id
    is the runtime's, which its launch call carries too."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns(), e.duration_ns(), e.correlation_id())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def launch_times(prof) -> Dict[int, int]:
    """Host start ns of the runtime's launch calls (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``, ...) by correlation id."""
    from torch.autograd import DeviceType
    out: Dict[int, int] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name().startswith('cu'):
            corr = e.correlation_id()
            out[corr] = min(out.get(corr, e.start_ns()), e.start_ns())
    return out


def _run_units(gen, units) -> int:
    """Runs ``units`` as the window does; returns their host ns."""
    import torch
    t0 = time.perf_counter_ns()
    for k in units:
        gen.run(gen.unit(k)).cpu()
    if torch.device(gen.device).type == 'cuda':
        torch.cuda.synchronize()
    return time.perf_counter_ns() - t0


def span_passes(gen, units: List[int]) -> Optional[dict]:
    """Passes (a) and (b) over ``units`` (pass (b) on the card only), or
    None where the program keeps no spans:

    * ``names``: by span name (and ``other``, ``outside``), a unit: the
      host ``issue_ms`` of pass (a); on the card also the ``launches``,
      ``idle_ms`` and ``device_ms`` that pass (b) charges to it;
    * ``counters``: by name, pass (a)'s count a unit;
    * ``labels``: ICP's view, by label: ``issue_ms`` a unit and, on the
      card, pass (b)'s ``launches`` over all the units and ``idle_ms`` a
      unit;
    * ``records``, ``unmatched``: pass (b)'s device records and those
      whose launch was not found (None and absent off the card)."""
    bench = program_spans()
    if bench is None or not units:
        return None
    bench.take_spans()
    bench.take_counters()
    with bench.record_spans():
        wall = _run_units(gen, units)
    spans = bench.take_spans()
    counters = bench.take_counters()
    n = len(units)
    names = {name: {'issue_ms': ns / 1e6 / n}
             for name, ns in issue_by_name(spans, wall).items()}
    labels = {label: {'issue_ms': ns / 1e6 / n}
              for label, ns in issue_ns(spans, wall).items()}
    out = {'units': n, 'spans': len(spans),
           'counters': {k: v / n for k, v in counters.items()},
           'names': names, 'labels': labels, 'records': None}
    import torch
    if torch.device(gen.device).type != 'cuda':
        return out
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with bench.record_spans():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _run_units(gen, units)
    spans = bench.take_spans()
    bench.take_counters()
    records = device_records(prof)
    launches = launch_times(prof)
    rows, unmatched = charge(records, launches, spans)
    zero = {'launches': 0, 'idle_ns': 0, 'device_ns': 0}
    for name in {s.name for s in spans} | {OTHER, OUTSIDE}:
        row = rows.get(name, zero)
        names.setdefault(name, {}).update(
            launches=row['launches'] / n, idle_ms=row['idle_ns'] / 1e6 / n,
            device_ms=row['device_ns'] / 1e6 / n)
    for label, row in attribute(records, launches, spans).items():
        labels[label]['launches'] = row['launches']
        labels[label]['idle_ms'] = row['idle_ns'] / 1e6 / n
    out['records'] = len(records)
    out['unmatched'] = unmatched
    return out


def scanned_pct(counters: dict, kind: str) -> Optional[float]:
    """The share (%) of its calls' pairs that the pruned 1-NN of ``kind``
    scanned, from ``counters``; None where it made no call."""
    pairs = counters.get(f'nn.{kind}.pairs')
    if not pairs:
        return None
    return 100.0 * counters.get(f'nn.{kind}.pairs_scanned', 0) / pairs


def metrics(reg, workload: str, passes: Optional[dict]) -> Dict[str, float]:
    """The numbers that ``workload``'s per-layer readers find in a context
    that holds the passes alone: those that read spans and counters."""
    from benchmark import tracing
    ctx = tracing.context([], 0, 0, 0, [], 0.0)
    if passes is not None:
        ctx.spans, ctx.counters = passes['names'], passes['counters']
    out = {}
    for m in reg.per_layer(workload):
        value = reg.reader(m['name'])(ctx)
        if value is not None:
            out[m['name']] = value
    return out


def stage_line(workload: str, passes: dict) -> str:
    parts = []
    for label in LABELS:
        row = passes['labels'][label]
        parts.append(f"{label} {row.get('launches', '-')} launches, issue "
                     f"{row['issue_ms']:.3f} ms, idle "
                     f"{row.get('idle_ms', float('nan')):.3f} ms")
    return (f'{workload}: stages a unit over {passes["units"]} units '
            f'({passes["records"]} device records): ' + '; '.join(parts))


def recording_cost(gen, units: List[int], reps: int) -> dict:
    """What recording costs: each unit run with recording off and on, one
    after the other (the order alternating), ``reps`` times; the medians
    of the host ms a unit, call to return (the window's issue span) and
    call to poses on the host, off and on, and the quartiles of the
    on-minus-off difference of each pair.  Also one empty span's ns, off
    and on."""
    bench = program_spans()
    ms = {key: [] for key in ('issue_off', 'issue_on', 'latency_off',
                              'latency_on')}
    for r in range(reps):
        for k in units:
            for mode in (('off', 'on') if (r + k) % 2 == 0 else
                         ('on', 'off')):
                inputs = gen.unit(k)
                with (bench.record_spans() if mode == 'on'
                      else contextlib.nullcontext()):
                    t0 = time.perf_counter()
                    poses = gen.run(inputs)
                    t1 = time.perf_counter()
                poses.cpu()
                t2 = time.perf_counter()
                ms['issue_' + mode].append(1e3 * (t1 - t0))
                ms['latency_' + mode].append(1e3 * (t2 - t0))
            bench.take_spans()
            bench.take_counters()

    def span_ns():
        n = 100000
        return 1e9 * timeit.timeit(
            "with span('x'):\n    pass", number=n,
            globals={'span': bench.span}) / n

    off_ns = span_ns()
    with bench.record_spans():
        on_ns = span_ns()
    bench.take_spans()
    out = {key: statistics.median(v) for key, v in ms.items()}
    for key in ('issue', 'latency'):
        diff = [b - a for a, b in zip(ms[key + '_off'], ms[key + '_on'])]
        out[key + '_on_minus_off_q'] = statistics.quantiles(diff, n=4)
    out['pairs'] = len(ms['issue_off'])
    out['span_ns'] = {'off': off_ns, 'on': on_ns}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    args = ap.parse_args(argv)
    import torch
    from benchmark import generator, run, tracing
    from benchmark.registry import ROOT, Registry
    run.cache_env(ROOT)
    reg = Registry(ROOT)
    cell = reg.workload(args.workload)
    config = reg.config(cell['config'])
    traffic = reg.traffic(cell['traffic'])
    if program_spans() is None or not torch.cuda.is_available():
        run.log(f'{args.workload}: needs a CUDA card and a program that '
                'keeps spans')
        return 2
    device = torch.device('cuda')
    gen = generator.make(reg, config, traffic, args.seed, device)
    gen.setup_program()
    gen.run(gen.unit(0)).cpu()
    units = list(range(1, 1 + int(traffic['check_units'])))
    out = {'workload': args.workload, 'seed': args.seed, 'units': units,
           'device': torch.cuda.get_device_name(device)}
    out['cost'] = recording_cost(gen, units, COST_ROUNDS)
    passes = span_passes(gen, units)
    out['passes'] = passes
    out['metrics'] = metrics(reg, args.workload, passes)
    records, _ = tracing.profile_units(gen, units)
    out['records_off'] = len(records)
    out['scans_per_unit'] = gen.scans_per_unit
    run.log(stage_line(args.workload, passes))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
