"""match_idle_ms: the device's idle time a unit of work that ends at a
record launched inside ICP's ``icp.match`` spans, with the spans recorded
under the device-only profile (``stages.span_passes``, pass (b))."""


def read(ctx):
    return ctx.spans.get('icp.match', {}).get('idle_ms')
