"""sweep_s.online: the time in the program's spans ``lyssa.online.sweep``
(the online learner's atom sweep, enqueued), in seconds a task of the
traced window."""

from portbench.core.spans import per_request, total_ns


def read(ctx):
    return per_request(ctx, lambda w: total_ns(w, "lyssa.online.sweep"),
                       1e-9)
