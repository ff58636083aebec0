"""launches.learning: device kernel launches a task in the trace, the
program's kernels and torch's ops alike."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.requests or not tr.launches:
        return None
    return tr.launches / tr.requests
