"""prep_s.learning: the self time of the program's span
``lyssa.denoise_adaptive`` (the task less its K-SVD fit and its denoise:
the image copied to the host, the training patches sampled, the encoder
and learner built), in seconds a task of the traced window."""

from portbench.core.spans import per_request, self_ns


def read(ctx):
    return per_request(ctx, lambda w: self_ns(w, "lyssa.denoise_adaptive"),
                       1e-9)
