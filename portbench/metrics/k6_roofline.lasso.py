"""k6_roofline.lasso: the roofline bound of the encode's K6 launches (the
fused feature-sign cold start, one a block of 2,048; its work counted by
yardstick/lasso_encode_work.cold_starts from the reference's optima) over
their device time in the trace."""

from portbench.core.readers import kernel_share


def read(ctx):
    return kernel_share(ctx, "k6")
