"""k1_roofline.coding: the roofline bound of the K1 launches (the fused
fixed-T OMP kernel; its work counted by yardstick/work.omp_kernel) over
their device time in the trace."""

from portbench.core.readers import kernel_share


def read(ctx):
    return kernel_share(ctx, "k1")
