"""Cross-slot operations of the single-controller mesh.

Each takes one tensor per slot (the slots of one mesh row, or the data
rows) and leaves its result on one device.  Data moves with
``tensor.to(device)``: between two GPUs a peer copy, which torch orders
against both devices' current streams, so nothing here waits on the host;
between two slots on one device a no-op.  The reductions run in slot
order, so their results do not depend on where the slots lie.
"""

from __future__ import annotations

import torch


def _moved(out, device):
    """A tensor, or a (named) tuple of tensors, moved to ``device``."""
    if isinstance(out, torch.Tensor):
        return out.to(device)
    moved = (_moved(t, device) for t in out)
    return type(out)(*moved) if hasattr(out, "_fields") else tuple(moved)


def gather_to(parts, device) -> list:
    """The slots' outputs (tensors, or tuples of them), each moved to
    ``device``, in slot order."""
    return [_moved(t, device) for t in parts]


def slot_max(parts, device) -> torch.Tensor:
    """Elementwise max over the slots' tensors, on ``device``."""
    out, *rest = gather_to(parts, device)
    for t in rest:
        out = torch.maximum(out, t)
    return out


def slot_min(parts, device) -> torch.Tensor:
    """Elementwise min over the slots' tensors, on ``device``."""
    out, *rest = gather_to(parts, device)
    for t in rest:
        out = torch.minimum(out, t)
    return out


def slot_sum(parts, device) -> torch.Tensor:
    """Sum of the slots' tensors in slot order, on ``device``."""
    out, *rest = gather_to(parts, device)
    for t in rest:
        out = out + t
    return out


def broadcast(t: torch.Tensor, devices) -> list[torch.Tensor]:
    """``t`` on each of ``devices`` (one copy per distinct device)."""
    copies: dict[torch.device, torch.Tensor] = {}
    for d in devices:
        if d not in copies:
            copies[d] = t.to(d)
    return [copies[d] for d in devices]
