"""patches_per_s: every patch coded in the window over the window's
seconds (closed loop, host clock)."""


def read(ctx):
    w = ctx.window
    if ctx.entry.unit != "patches" or w.seconds <= 0:
        return None
    return w.units / w.seconds
