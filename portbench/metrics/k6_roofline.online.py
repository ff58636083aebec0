"""k6_roofline.online: the roofline bound of the K6 launches (the fused
feature-sign cold start; its work counted by
yardstick/lasso_work.fs_cold_kernel from the reference's optima) over
their device time in the trace."""

from portbench.core.readers import kernel_share


def read(ctx):
    return kernel_share(ctx, "k6")
