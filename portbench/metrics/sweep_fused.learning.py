"""sweep_fused.learning: the K-SVD atom sweeps that ran as one launch of
the program's sweep kernel (the ``fused`` attribute of the program's span
``lyssa.ksvd.sweep``, summed), a task of the traced window; an adaptive
task sweeps 12 times, a ksvd-c2 task 20.  None where no sweep span carries
the attribute (a program whose K-SVD sweep has no kernel)."""

from portbench.core.spans import per_request

SPAN, KEY = "lyssa.ksvd.sweep", "fused"


def fused(win):
    """The summed ``fused`` of the window's sweep spans; None where none
    carries it."""
    found = [r.attrs[KEY] for r in win.values()
             if r.name == SPAN and KEY in r.attrs]
    return sum(found) if found else None


def read(ctx):
    return per_request(ctx, fused)
