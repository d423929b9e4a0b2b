"""device_idle_pct: 100 minus the device's busy share of a unit of work:
the device time of the traced units (their records' intervals merged)
a unit, over the median time of a unit in the run's untraced window.
The traced units themselves run slower under the profiler, whose
launch records hold the host back, so their own length would count the
profiler's cost as idle time."""


def read(ctx):
    if not ctx.records or not ctx.units or ctx.unit_ms <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_ns / 1e6 / ctx.units / ctx.unit_ms)
