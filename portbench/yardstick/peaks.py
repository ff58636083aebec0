"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit) and the roofline bound.

The port computes in float32 with TF32 off, so its operations are held to
the float32 rate outside the tensor cores."""

PEAK_F32_FLOPS = 67e12      # float32, outside the tensor cores
PEAK_BYTES = 3.35e12        # HBM3


def bound_ms(nbytes, flops, peak_flops=PEAK_F32_FLOPS):
    """The least time one card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate for their type.
    Returns (ms, "bytes" or "operations").  (Frozen copy of
    ``chip_smoke.bound_ms``.)"""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_s(flops, nbytes, chips=1):
    """The least time ``chips`` cards could take for work split evenly
    over them."""
    return bound_ms(nbytes, flops)[0] / 1e3 / chips


def share_pct(flops, nbytes, seconds, chips=1):
    """The roofline bound of the work as a share of ``seconds``, in %;
    None where there is no time to divide by."""
    if seconds <= 0 or (flops <= 0 and nbytes <= 0):
        return None
    return 100.0 * bound_s(flops, nbytes, chips) / seconds
