"""Experiment workspace: checkpoint/resume and result persistence
(``lyssandra_tpu.utils.workspace`` counterpart).

Arrays are ``.npz`` files, metrics a JSON-lines log and results JSON files,
laid out as the reference lays them out, so the ``.npz`` arrays of one
package load in the other.  Checkpoints are ``torch.save`` files, one per
step under ``checkpoints/``, where the reference writes Orbax checkpoints:
a checkpoint of the port cannot be read by the reference, nor the other
way round.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch

_KEEP = 3                                   # newest checkpoints kept
_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _like(state, template):
    """state with each tensor moved to the device and dtype of the tensor
    at the same key in ``template`` (dicts nest)."""
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(state).to(device=template.device,
                                         dtype=template.dtype)
    if isinstance(template, dict):
        return {k: _like(v, template[k]) if k in template else v
                for k, v in state.items()}
    return state


class Workspace:
    """Directory-backed experiment store.

    ws = Workspace('runs/exp1')
    ws.save_array('D', D); D = ws.load_array('D')
    ws.save_state(step, {'D': D, 'iter': it})      # torch.save checkpoint
    step, state = ws.load_latest_state(template)
    ws.log_metrics({'objective': ..., 'iter': 3})
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._ckpt_dir = os.path.join(self.root, "checkpoints")
        self._metrics_path = os.path.join(self.root, "metrics.jsonl")

    # ---- arrays (.npz, readable by either package) -----------------------

    def save_array(self, name: str, *arrays, **named) -> str:
        path = os.path.join(self.root, f"{name}.npz")
        if arrays and not named:
            named = {f"arr_{i}": a for i, a in enumerate(arrays)}
        np.savez(path, **{k: _numpy(v) for k, v in named.items()})
        return path

    def load_array(self, name: str):
        with np.load(os.path.join(self.root, f"{name}.npz")) as z:
            keys = list(z.keys())
            if keys == ["arr_0"]:
                return z["arr_0"]
            return {k: z[k] for k in keys}

    # ---- checkpoints (resumable state) -----------------------------------

    def _steps(self) -> list[int]:
        if not os.path.isdir(self._ckpt_dir):
            return []
        return sorted(int(m.group(1)) for m in map(
            _STEP_FILE.match, os.listdir(self._ckpt_dir)) if m)

    def _path(self, step: int) -> str:
        return os.path.join(self._ckpt_dir, f"step_{step:08d}.pt")

    def save_state(self, step: int, state: Any) -> None:
        """Write ``state`` (tensors, numbers, and dicts/lists of them) as
        the checkpoint of ``step``; the 3 newest checkpoints are kept."""
        os.makedirs(self._ckpt_dir, exist_ok=True)
        tmp = self._path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        for old in self._steps()[:-_KEEP]:
            os.remove(self._path(old))

    def load_latest_state(self, template: Any = None):
        """Returns (step, state) of the newest checkpoint, or (None, None)
        if there is none.  Tensors load on the CPU; with a ``template``,
        each goes to the device and dtype of its counterpart there."""
        steps = self._steps()
        if not steps:
            return None, None
        state = torch.load(self._path(steps[-1]), map_location="cpu",
                           weights_only=True)
        if template is not None:
            state = _like(state, template)
        return steps[-1], state

    # ---- metrics log -----------------------------------------------------

    def log_metrics(self, metrics: dict) -> None:
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(metrics) + "\n")

    def read_metrics(self) -> list[dict]:
        if not os.path.exists(self._metrics_path):
            return []
        with open(self._metrics_path) as f:
            return [json.loads(line) for line in f if line.strip()]

    # ---- results ---------------------------------------------------------

    def save_json(self, name: str, obj: Any) -> str:
        path = os.path.join(self.root, f"{name}.json")
        with open(path, "w") as f:
            json.dump(obj, f, indent=2, default=str)
        return path

    def load_json(self, name: str) -> Any:
        with open(os.path.join(self.root, f"{name}.json")) as f:
            return json.load(f)
