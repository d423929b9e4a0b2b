"""k2_roofline: the pruned 1-NN against one shared reference (K2) against
its bound, its set-up included (``tracing.nn_roofline_pct``)."""

from benchmark import tracing


def read(ctx):
    return tracing.nn_roofline_pct(ctx, 'k2')
