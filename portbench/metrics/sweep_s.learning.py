"""sweep_s.learning: the time in the program's spans ``lyssa.ksvd.sweep``
(K-SVD's atom sweep, enqueued), in seconds a task of the traced window."""

from portbench.core.spans import per_request, total_ns


def read(ctx):
    return per_request(ctx, lambda w: total_ns(w, "lyssa.ksvd.sweep"), 1e-9)
