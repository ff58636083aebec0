"""What the entries read from the program besides its answers: its kernel
launch counters, and a synchronise over the cards a run uses."""

import torch


def sync(devices):
    """Wait for every GPU among ``devices``."""
    for d in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def launches():
    """The program's kernel launches so far, all kernels
    (``lyssandra_tpu_torch.ops.launch_counts``)."""
    from lyssandra_tpu_torch.ops import launch_counts

    return sum(launch_counts().values())
