"""phase2_lanes.denoise: the lanes the second phase re-solves (the
``lanes`` attribute of the program's span ``lyssa.denoise.phase2``,
summed), an image of the traced window; an image has 255,025 patches."""

from portbench.core.spans import attr_sum, per_request


def read(ctx):
    return per_request(
        ctx, lambda w: attr_sum(w, "lyssa.denoise.phase2", "lanes"))
