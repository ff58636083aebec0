"""frontend_ms.coding: the self time of the program's span
``lyssa.encode`` (``SparseEncoder.encode`` less its blocks: ``check_atoms``
and its sync, the padding, the final join), in ms a request of the traced
window."""

from portbench.core.spans import per_request, self_ns


def read(ctx):
    return per_request(ctx, lambda w: self_ns(w, "lyssa.encode"), 1e-6)
