"""k2l_roofline: the pruned 1-NN over per-lane references (K2L) against
its bound, its set-up included (``tracing.nn_roofline_pct``)."""

from benchmark import tracing


def read(ctx):
    return tracing.nn_roofline_pct(ctx, 'k2l')
