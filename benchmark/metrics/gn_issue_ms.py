"""gn_issue_ms: the host's time a unit of work inside ICP's ``icp.gn`` spans
(GN steps, differential checker, the loop state's freeze), every iteration
summed (``ops/icp.run_loop``), with the spans recorded
(``stages.span_passes``, pass (a))."""


def read(ctx):
    return ctx.spans.get('icp.gn', {}).get('issue_ms')
