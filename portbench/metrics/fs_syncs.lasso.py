"""fs_syncs.lasso: the lasso solvers' host reads
(``lyssandra_tpu_torch.solvers.lasso.host_syncs()``) over the untraced
window, a task."""


def read(ctx):
    return ctx.entry.counters.get("fs_syncs")
