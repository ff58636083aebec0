"""code_s.online: the time in the program's spans ``lyssa.online.code``
(the coding of each minibatch in ``minibatch_update``), in seconds a task
of the traced window.  The coders read their loop exits on the host, so
the span holds most of the coding's device time too."""

from portbench.core.spans import per_request, total_ns


def read(ctx):
    return per_request(ctx, lambda w: total_ns(w, "lyssa.online.code"),
                       1e-9)
