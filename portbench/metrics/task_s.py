"""task_s: the window's seconds over the learning tasks completed in
it (closed loop, host clock)."""


def read(ctx):
    w = ctx.window
    if ctx.entry.unit != "tasks" or w.units <= 0:
        return None
    return w.seconds / w.units
