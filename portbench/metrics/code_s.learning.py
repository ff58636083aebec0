"""code_s.learning: the time in the program's spans ``lyssa.encode``
opened directly inside a ``lyssa.ksvd.iteration`` (K-SVD's coding step),
in seconds a task of the traced window.

Host enqueue time: the span closes once the coding's kernels are queued,
and K2 and the G product run on the device behind it.  A change that
speeds the coding's kernels does not move it; one that takes host work
out of the coding's dispatch does."""

from portbench.core.spans import per_request, total_ns


def read(ctx):
    return per_request(
        ctx, lambda w: total_ns(w, "lyssa.encode", "lyssa.ksvd.iteration"),
        1e-9)
