"""polish_s.lasso: the time in the program's spans ``lyssa.fs.polish``
(feature_sign's polish: the gate's host read and, where it runs,
FISTA-500's enqueue), in seconds a task of the traced window."""

from portbench.core.spans import per_request, total_ns


def read(ctx):
    return per_request(ctx, lambda w: total_ns(w, "lyssa.fs.polish"), 1e-9)
