"""loop_s.lasso: the time in the program's spans ``lyssa.fs.loop``
(feature_sign's segmented loop after the cold start), in seconds a task of
the traced window.  The loop reads its exits on the host, so the span
holds its device time too."""

from portbench.core.spans import per_request, total_ns


def read(ctx):
    return per_request(ctx, lambda w: total_ns(w, "lyssa.fs.loop"), 1e-9)
