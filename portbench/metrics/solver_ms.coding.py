"""solver_ms.coding: the time in the program's spans
``lyssa.encode.block`` (per block the route, G and K1 enqueued through the
wrappers), in ms a request of the traced window.

Host enqueue time: each block's span closes once its kernels are queued,
and the request waits for K1 after the call returns.  It moves
``patches_per_s`` only where the host's dispatch holds the device back,
as it does when a block's launches fall behind the kernels."""

from portbench.core.spans import per_request, total_ns


def read(ctx):
    return per_request(ctx, lambda w: total_ns(w, "lyssa.encode.block"),
                       1e-6)
