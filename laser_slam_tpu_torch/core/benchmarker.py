"""Benchmarker: a host-side metrics/timing registry.

Counterpart of ``laser_slam_tpu/core/benchmarker.py``, which mirrors the
reference's static ``Benchmarker`` (laser_slam/include/laser_slam/
benchmarker.hpp:62-205, src/benchmarker.cpp:92-165): named value topics
with streaming mean/SD, per-step ids, scoped timers, optional live
logging, and a dump of per-topic series plus a ``statistics.txt`` summary
into a timestamped results directory.  The compile-time
``BENCHMARK_ENABLE`` gate is a runtime ``enable()`` switch.

Timers read the host clock: CUDA work is asynchronous, so a timer around
a call measures the host's issue of it unless the call reads a result
back (or the caller synchronizes).  :func:`device_trace` records the
card's timeline beside them.

Spans.  :func:`scoped_timer` (alias :func:`span`) is also the port's
span primitive: inside :func:`record_spans` every span is kept in memory
as a :class:`Span` (name, trace id, parent, start and end ns) until
:func:`take_spans`.  A span opened with no span open on its thread is a
root and opens a new trace id, which the spans under it share: one unit
of work, one id.  Spans are stamped with :data:`span_clock`, the clock of
``torch.profiler``'s records, so that a launch's host record falls inside
the span that issued it.  Counters (:func:`counter`, :func:`add_count`,
:func:`take_counters`) are kept only while spans are recorded; a device
counter stays on its device until it is taken.  With the registry and
span recording both off, a span costs one flag check.
"""

from __future__ import annotations

import contextlib
import datetime
import itertools
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

from laser_slam_tpu_torch.config import BenchmarkerConfig

logger = logging.getLogger('laser_slam_tpu_torch.benchmarker')


class Clock:
    """Wall + CPU time helper (the reference ``Clock``, common.hpp:23-63)."""

    def __init__(self):
        self.start()

    def start(self):
        self._real0 = time.perf_counter()
        self._cpu0 = time.process_time()
        self._real_ms = 0.0
        self._cpu_ms = 0.0

    def take_time(self):
        self._real_ms = (time.perf_counter() - self._real0) * 1e3
        self._cpu_ms = (time.process_time() - self._cpu0) * 1e3

    def get_real_time(self) -> float:
        return self._real_ms

    def get_cpu_time(self) -> float:
        return self._cpu_ms

    def take_real_time(self) -> float:
        self.take_time()
        return self._real_ms


@dataclass
class _ValueTopic:
    """Streaming statistics for one topic (benchmarker.hpp:130-157)."""
    sum: float = 0.0
    sum_sq: float = 0.0
    count: int = 0
    values: List[Tuple[int, float, float]] = field(default_factory=list)
    # (step_id, timestamp_s, value)

    def add(self, step_id: int, timestamp: float, value: float,
            keep_series: bool):
        self.sum += value
        self.sum_sq += value * value
        self.count += 1
        if keep_series:
            self.values.append((step_id, timestamp, value))

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def std(self) -> float:
        if self.count < 2:
            return 0.0
        m = self.mean
        var = max(self.sum_sq / self.count - m * m, 0.0)
        return var ** 0.5


class Benchmarker:
    """Thread-safe topic registry (module-level singleton below)."""

    def __init__(self, params: Optional[BenchmarkerConfig] = None):
        self._params = params or BenchmarkerConfig()
        self._enabled = False
        self._lock = threading.Lock()
        self._topics: Dict[str, _ValueTopic] = {}
        self._open_measurements: Dict[str, float] = {}
        self._step_id = 0
        self._step_timestamp = time.time()

    # -- control ------------------------------------------------------------
    def enable(self, params: Optional[BenchmarkerConfig] = None):
        if params is not None:
            self._params = params
        self._enabled = True
        _refresh_active()

    def disable(self):
        self._enabled = False
        _refresh_active()

    @property
    def enabled(self) -> bool:
        return self._enabled

    # -- recording (benchmarker.hpp:15-45 macro surface) --------------------
    def notify_new_step(self):
        with self._lock:
            self._step_id += 1
            self._step_timestamp = time.time()

    def start_measurement(self, topic: str):
        if not self._enabled:
            return
        with self._lock:
            self._open_measurements[topic] = time.perf_counter()

    def stop_measurement(self, topic: str, ignore: bool = False):
        if not self._enabled:
            return
        now = time.perf_counter()
        with self._lock:
            start = self._open_measurements.pop(topic, None)
        if start is not None and not ignore:
            self.add_value(topic, (now - start) * 1e3)

    def add_value(self, topic: str, value: float):
        if not self._enabled:
            return
        with self._lock:
            t = self._topics.setdefault(topic, _ValueTopic())
            t.add(self._step_id, self._step_timestamp, float(value),
                  not self._params.save_statistics_only)
        if self._params.enable_live_output:
            logger.info('%s: %.3f', topic, value)

    def reset_topic(self, prefix: str = ''):
        """Drop the topics that start with ``prefix`` (all for '')."""
        with self._lock:
            self._topics = {k: v for k, v in self._topics.items()
                            if prefix and not k.startswith(prefix)}

    # -- output (benchmarker.cpp:92-165) ------------------------------------
    def statistics(self) -> Dict[str, Tuple[float, float, int]]:
        with self._lock:
            return {k: (v.mean, v.std, v.count)
                    for k, v in sorted(self._topics.items())}

    def log_statistics(self):
        for k, (mean, std, count) in self.statistics().items():
            logger.info('%s: %.3f (+-%.3f) n=%d', k, mean, std, count)

    def save_data(self, directory: Optional[str] = None) -> str:
        """Dump per-topic series + statistics.txt into a timestamped dir."""
        stamp = datetime.datetime.now().strftime('%Y-%m-%d_%H-%M-%S')
        root = os.path.join(directory or self._params.results_directory,
                            stamp)
        os.makedirs(root, exist_ok=True)
        with self._lock:
            topics = dict(self._topics)
        with open(os.path.join(root, 'statistics.txt'), 'w') as f:
            for k in sorted(topics):
                t = topics[k]
                f.write(f'{k}: {t.mean:.6f} ({t.std:.6f}) n={t.count}\n')
        if not self._params.save_statistics_only:
            for k, t in topics.items():
                safe = k.replace('/', '_').replace(' ', '_')
                with open(os.path.join(root, safe + '.txt'), 'w') as f:
                    for step, ts, v in t.values:
                        f.write(f'{step} {ts:.6f} {v:.6f}\n')
        return root


# Module-level singleton, as the reference's static class.
_instance = Benchmarker()

enable = _instance.enable
disable = _instance.disable
notify_new_step = _instance.notify_new_step
start_measurement = _instance.start_measurement
stop_measurement = _instance.stop_measurement
record_value = _instance.add_value
reset_topic = _instance.reset_topic
statistics = _instance.statistics
log_statistics = _instance.log_statistics
save_data = _instance.save_data


# -- spans and counters -----------------------------------------------------

class Span(NamedTuple):
    """One recorded span.  ``parent`` is the index of the enclosing span
    in the list :func:`take_spans` returns, -1 for a root; ``trace`` is
    the id its root opened.  Times are :data:`span_clock` ns."""
    name: str
    trace: int
    parent: int
    start_ns: int
    end_ns: int


# The clock of torch.profiler's records (Unix-epoch ns, on the CPU and
# on the card), so that spans and launch records share one time line.
span_clock = time.time_ns

_active = False        # the registry is on or spans are recorded
_recording = False     # spans and counters are kept
_lock = threading.Lock()
_spans: List[list] = []             # [name, trace, parent, start, end]
_open = threading.local()           # .stack: this thread's open spans
_trace_ids = itertools.count()
_device_counts: Dict[tuple, object] = {}   # (name, device) -> int64 0-d
_host_counts: Dict[str, int] = {}


def _refresh_active() -> None:
    global _active
    _active = _instance.enabled or _recording


class _Span:
    """What :func:`scoped_timer` returns while the registry or span
    recording is on."""
    __slots__ = ('topic', 'start', 'rec')

    def __init__(self, topic: str):
        self.topic = topic
        self.rec = None

    def __enter__(self):
        if _recording:
            stack = getattr(_open, 'stack', None)
            if stack is None:
                stack = _open.stack = []
            with _lock:
                parent = stack[-1][0] if stack else -1
                trace = (stack[-1][1][1] if stack else next(_trace_ids))
                self.rec = [self.topic, trace, parent, 0, 0]
                stack.append((len(_spans), self.rec))
                _spans.append(self.rec)
        self.start = span_clock()
        if self.rec is not None:
            self.rec[3] = self.start
        return self

    def __exit__(self, *exc):
        end = span_clock()
        if self.rec is not None:
            self.rec[4] = end
            _open.stack.pop()
        if _instance.enabled:
            record_value(self.topic, (end - self.start) / 1e6)
        return False


_NO_SPAN = contextlib.nullcontext()


def scoped_timer(topic: str):
    """ScopedTimer equivalent (benchmarker.hpp:187-205), and the port's
    span: with the registry on, the block's host ms go to ``topic``;
    inside :func:`record_spans` the block is also kept as a :class:`Span`
    named ``topic``.  With both off it returns at once."""
    if not _active:
        return _NO_SPAN
    return _Span(topic)


span = scoped_timer


@contextlib.contextmanager
def record_spans():
    """Keep spans and counters inside the block; the state before it
    comes back on exit, on an exception too.  What was kept stays in
    memory until :func:`take_spans` and :func:`take_counters`."""
    global _recording
    before = _recording
    _recording = True
    _refresh_active()
    try:
        yield
    finally:
        _recording = before
        _refresh_active()


def recording() -> bool:
    """Whether spans and counters are being kept."""
    return _recording


def take_spans() -> List[Span]:
    """The spans kept so far, in the order they opened, and clears them.
    Take them when no span is open: a parent index counts from the start
    of the list."""
    with _lock:
        out = [Span(*rec) for rec in _spans]
        _spans.clear()
    return out


def counter(name: str, device):
    """The int64 0-d tensor on ``device`` that counts ``name``: add to it
    on the device (one accumulator a name and device, made zero at first
    use), so that counting reads nothing back."""
    import torch
    key = (name, torch.device(device))
    with _lock:
        acc = _device_counts.get(key)
        if acc is None:
            acc = _device_counts[key] = torch.zeros(
                (), dtype=torch.int64, device=key[1])
    return acc


def add_count(name: str, n: int) -> None:
    """Add the host count ``n`` to the counter ``name``."""
    with _lock:
        _host_counts[name] = _host_counts.get(name, 0) + int(n)


def take_counters() -> Dict[str, int]:
    """Every counter's total, host and device counts summed by name (one
    read a device), and clears them."""
    import torch
    with _lock:
        device_counts = dict(_device_counts)
        out = dict(_host_counts)
        _device_counts.clear()
        _host_counts.clear()
    by_device: Dict[object, list] = {}
    for (name, dev), acc in device_counts.items():
        by_device.setdefault(dev, []).append((name, acc))
    for items in by_device.values():
        values = torch.stack([acc for _, acc in items]).tolist()
        for (name, _), v in zip(items, values):
            out[name] = out.get(name, 0) + int(v)
    return out


@contextlib.contextmanager
def device_trace(trace_dir: str):
    """Device profiling: ``torch.profiler`` over the block, recording the
    CPU activity, and the card's when CUDA is available, so device
    timelines land next to the Benchmarker's host metrics.  On exit a
    Chrome trace (``<host>_<pid>.<stamp>.pt.trace.json``) is written under
    ``trace_dir``; TensorBoard's profiler plugin and Perfetto open it.
    The counterpart of the JAX package's ``jax.profiler.trace`` wrapper."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
