"""train.idle_share: the share of the traced training window in which no
kernel, copy or fill ran on the card (device layer)."""
from benchmark.metrics.counts import idle_share


def read(rec):
    return idle_share(rec)
