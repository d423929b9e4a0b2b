"""k2_scanned_pct: the share of its calls' query-reference pairs that the
pruned 1-NN against one shared reference (K2) scanned: the program's
counters ``nn.k2.pairs_scanned`` over ``nn.k2.pairs``
(``stages.span_passes``, pass (a))."""

from benchmark import stages


def read(ctx):
    return stages.scanned_pct(ctx.counters, 'k2')
