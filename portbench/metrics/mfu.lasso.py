"""mfu.lasso: the lasso encode's counted work (yardstick/
lasso_encode_work.call at the reference's nonzeros: A0, the feature-sign
steps to each lane's optimum, X and D read and Gamma written once) as a
share of the peaks of the cell's cards over the time a task took in the
untraced window."""

from portbench.core.readers import call_share


def read(ctx):
    return call_share(ctx)
