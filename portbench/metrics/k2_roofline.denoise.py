"""k2_roofline.denoise: the roofline bound of the K2 launch of each image
(the fused error-stopped OMP kernel, capped at 10 atoms; its work counted
by yardstick/work.omp_kernel at the reference's nsel) over its device time
in the trace."""

from portbench.core.readers import kernel_share


def read(ctx):
    return kernel_share(ctx, "k2")
