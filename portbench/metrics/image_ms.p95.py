"""image_ms.p95: the 95th percentile of the wait for one image over every
image restored in the untraced window, timed on the device (CUDA events
on the stream at hand-in and after the restored image; nearest rank)."""

from portbench.core.readers import percentile


def read(ctx):
    ms = ctx.entry.counters.get("device_ms")
    return percentile(ms, 95) if ms else None
