"""k1_roofline.learning: the roofline bound of the K1 launches of a K-SVD
fit's coding (the fused fixed-T OMP kernel, 4 a 50,000-lane iteration at
the encoder's 16,384-lane blocks; its work counted by
yardstick/work.omp_kernel at the reference's nsel) over their device time
in the trace."""

from portbench.core.readers import kernel_share


def read(ctx):
    return kernel_share(ctx, "k1")
