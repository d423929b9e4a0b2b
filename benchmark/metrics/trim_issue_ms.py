"""trim_issue_ms: the host's time a unit of work inside ICP's ``icp.trim``
spans (the trim, the inlier count), every iteration summed
(``ops/icp.run_loop``), with the spans recorded (``stages.span_passes``,
pass (a))."""


def read(ctx):
    return ctx.spans.get('icp.trim', {}).get('issue_ms')
