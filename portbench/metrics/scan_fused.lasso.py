"""scan_fused.lasso: feature_sign's loops after the cold start that ran as
one launch of the program's search kernel from the cold start's handoff
(the ``fused`` attribute of the program's span ``lyssa.fs.loop``, summed),
a task of the traced window: 49 where the kernel runs the loop, one a
block, 0 where the plain loop runs.  None where no loop span carries the
attribute (a program whose loop has no kernel)."""

from portbench.core.spans import per_request

SPAN, KEY = "lyssa.fs.loop", "fused"


def fused(win):
    """The summed ``fused`` of the window's loop spans; None where none
    carries it."""
    found = [r.attrs[KEY] for r in win.values()
             if r.name == SPAN and KEY in r.attrs]
    return sum(found) if found else None


def read(ctx):
    return per_request(ctx, fused)
