"""match_issue_ms: the host's time a unit of work inside ICP's ``icp.match``
spans (points transform, matcher set-up and launch, payload gathers, radius
test), every iteration summed (``ops/icp.run_loop``), with the spans
recorded (``stages.span_passes``, pass (a))."""


def read(ctx):
    return ctx.spans.get('icp.match', {}).get('issue_ms')
