"""phase2_ms.denoise: the time in the program's span
``lyssa.denoise.phase2`` (the two-phase coder's re-solve loop, opened after
its first count of the lanes left, so that the wait for phase 1's K2 stays
outside it), in ms an image of the traced window."""

from portbench.core.spans import per_request, total_ns


def read(ctx):
    return per_request(ctx, lambda w: total_ns(w, "lyssa.denoise.phase2"),
                       1e-6)
