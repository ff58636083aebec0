"""fs_syncs.online: the lasso solvers' host reads during the coding of a
task's minibatches (attribute ``syncs`` of the spans ``lyssa.online.code``,
summed), a task of the traced window."""

from portbench.core.spans import attr_sum, per_request


def read(ctx):
    return per_request(ctx,
                       lambda w: attr_sum(w, "lyssa.online.code", "syncs"))
