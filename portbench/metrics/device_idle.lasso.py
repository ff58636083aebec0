"""device_idle.lasso: 1 - busy / window in the traced window, the busy
time the union of the card's kernel and copy intervals; on several cards
the mean of theirs."""

from portbench.core.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
