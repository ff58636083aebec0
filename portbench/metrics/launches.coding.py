"""launches.coding: the program's kernel launches an encode over the
untraced window (lyssandra_tpu_torch.ops.launch_counts, every kernel)."""


def read(ctx):
    return ctx.entry.counters.get("launches_per_request")
