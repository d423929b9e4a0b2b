"""k2l_scanned_pct: the share of its calls' query-reference pairs that the
pruned 1-NN over per-lane references (K2L) scanned: the program's counters
``nn.k2l.pairs_scanned`` over ``nn.k2l.pairs`` (``stages.span_passes``, pass
(a))."""

from benchmark import stages


def read(ctx):
    return stages.scanned_pct(ctx.counters, 'k2l')
