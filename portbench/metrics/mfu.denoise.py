"""mfu.denoise: the whole call's counted work (Gram form, inputs read
and outputs written once; yardstick/work.py) as a share of the peaks of
the cell's cards over the time a request took in the untraced window."""

from portbench.core.readers import call_share


def read(ctx):
    return call_share(ctx)
