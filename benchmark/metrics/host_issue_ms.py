"""host_issue_ms: the host's time from the call of the program's entry to
its return, before the poses are read back, a unit of work; the median
over the window's units.  A span in the benchmark's own code."""

import statistics


def read(ctx):
    if not ctx.host_issue_ms:
        return None
    return statistics.median(ctx.host_issue_ms)
