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
back (or the caller synchronizes).
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

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

    def disable(self):
        self._enabled = False

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


@contextlib.contextmanager
def scoped_timer(topic: str):
    """ScopedTimer equivalent (benchmarker.hpp:187-205)."""
    start = time.perf_counter()
    try:
        yield
    finally:
        if _instance.enabled:
            record_value(topic, (time.perf_counter() - start) * 1e3)
