"""host_syncs.denoise: synchronizing CUDA calls an image, counted by
torch's sync debug mode over one pass of the pool after the window."""


def read(ctx):
    return ctx.entry.counters.get("syncs_per_request")
