"""Traced units: ``torch.profiler`` around the units of work that a run
checks, run again after the measured window, and what the per-layer
readers get from it.

Two profiles.  The first records the device alone (kernels, copies and
fills, with the runtime's launch records) over those units: its
records give the device's busy time, the launches and the kernels'
device time.  The profiler slows the host's launches (by about 10 us
each on an H100's host), so the traced units take longer than the
window's; the idle share is therefore taken against the window's own
median unit time (``device_idle_pct``).  The second adds the host's
operators over one more unit, so that each idle gap of the device can
be named by the host operator that issued the work ending it; it feeds
the breakdown only, since the host's records slow the host.  Then the
program's own spans and counters over the same units
(``stages.span_passes``), for the readers that read a span or a counter
by name.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from benchmark import yardstick as ys


@dataclasses.dataclass
class TraceContext:
    """What a per-layer reader (``metrics/<name>.py``) reads."""
    records: List[Tuple[str, int, int]]    # device (name, start ns, ns)
    window_ns: int                         # host time of the traced units
    busy_ns: int                           # device busy time, merged
    scans: int                             # scans registered in them
    units: int                             # units of work traced
    host_issue_ms: List[float]             # the window's issue spans
    unit_ms: float                         # the window's median unit time
    # Summed bound and number of calls of the pruned 1-NN in the traced
    # units, by kind ('k2': one shared reference, 'k2l': per lane).
    nn_bound_ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    nn_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    # The program's spans and counters over the traced units, a unit
    # (``stages.span_passes``): by span name (and ``other``, ``outside``),
    # ``issue_ms``, and on the card also ``launches``, ``idle_ms`` and
    # ``device_ms``; by counter name, its count.
    spans: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)


def _device_records(prof) -> List[Tuple[str, int, int, int]]:
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns(), e.duration_ns(),
             e.linked_correlation_id())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def _run_units(gen, units) -> None:
    for k in units:
        gen.run(gen.unit(k)).cpu()
    torch.cuda.synchronize()


def profile_units(gen, units):
    """(records, window ns) of ``units``, the device alone."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _run_units(gen, units)
        t1 = time.perf_counter()
    recs = [(n, s, d) for n, s, d, _ in _device_records(prof)]
    return recs, int((t1 - t0) * 1e9)


def short_name(name: str) -> str:
    """A kernel's name without its return type, arguments and template
    arguments, at most 96 characters."""
    name = name.split('(')[0]
    if name.startswith('void '):
        name = name[5:]
    return name.split('<')[0][:96]


def device_ops(records) -> List[list]:
    """The 10 device operations that took most time: [name, seconds]."""
    total = defaultdict(int)
    for name, _, dur in records:
        total[short_name(name)] += dur
    top = sorted(total.items(), key=lambda kv: -kv[1])[:10]
    return [[n, ns / 1e9] for n, ns in top]


def idle_gaps(gen, unit: int) -> List[list]:
    """The device's idle time between its operations over ``unit``,
    summed by the host operator that issued the operation ending each gap
    (the kernel's own name where no operator issued it): the 10 largest,
    [label, seconds]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run_units(gen, [unit])
    events = list(prof.profiler.kineto_results.events())
    ops = {e.correlation_id(): e.name() for e in events
           if e.device_type() == DeviceType.CPU and e.name().startswith(
               'aten::')}
    recs = sorted(_device_records(prof), key=lambda r: r[1])
    gaps = defaultdict(int)
    end = None
    for name, start, dur, corr in recs:
        if end is not None and start > end:
            gaps[ops.get(corr, short_name(name))] += start - end
        end = start + dur if end is None else max(end, start + dur)
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return [[n, ns / 1e9] for n, ns in top]


def context(records, window_ns: int, units: int, scans: int,
            host_issue_ms: List[float], unit_ms: float) -> TraceContext:
    return TraceContext(records=records, window_ns=window_ns,
                        busy_ns=ys.busy_ns([(s, s + d)
                                            for _, s, d in records]),
                        scans=scans, units=units,
                        host_issue_ms=host_issue_ms, unit_ms=unit_ms)


def group_ms(group) -> float:
    return ys.busy_ns([(s, s + d) for _, s, d in group]) / 1e6


def nn_roofline_pct(ctx: TraceContext, kind: str) -> Optional[float]:
    """Share of its bound that the pruned 1-NN of ``kind`` reached over the
    traced units: the summed walk bound over the summed device time of
    its calls, set-up included.  None where the traced units ran no such
    call or where the calls found in the trace are not the calls
    counted."""
    bound = ctx.nn_bound_ms.get(kind)
    groups = ys.k2_groups(ctx.records)
    if bound is None or not groups or len(groups) != ctx.nn_calls[kind]:
        return None
    return 100.0 * bound / sum(group_ms(g) for g in groups)
