"""Checkpoint/resume of the simulator (port of
``fedml_tpu/utils/checkpoint.py``: ``CheckpointManager``:18,
``save_simulator_state``:197, ``restore_simulator_state``:221).

The JAX package writes orbax checkpoints; the port writes its own format
with ``torch.save``: one file ``step_<n>.pt`` per saved round in the
checkpoint directory, written under a temporary name and renamed, so a
crash leaves the previous file or the new one, never a torn one. A file
holds ``{"params": {path: CPU tensor}, "round": n, "server_state": {},
"client_states": {}}``; the two empty dicts keep the place of the state
that stateful algorithms and the client-state arena will save. The port
does not read orbax checkpoints, nor the JAX package this format.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    """``save(step, state)`` / ``restore(step=None)`` / ``latest_step()``
    over one directory, keeping the ``max_to_keep`` latest steps."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def steps(self) -> list:
        """Saved steps, ascending."""
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory))
                      if m)

    def save(self, step: int, state: Dict[str, Any]) -> None:
        path = self._path(step)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        step = self.latest_step() if step is None else step
        if step is None or not os.path.exists(self._path(step)):
            raise FileNotFoundError(f"no checkpoint{'' if step is None else f' {step}'} "
                                    f"in {self.directory}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)


def save_simulator_state(manager: CheckpointManager, sim, round_idx: int) -> None:
    """Persist a FedSimulator's resumable state after round ``round_idx``."""
    manager.save(round_idx, {
        "params": {k: v.detach().cpu() for k, v in sim.params.items()},
        "round": int(round_idx),
        "server_state": {},
        "client_states": {},
    })


def restore_simulator_state(manager: CheckpointManager, sim) -> int:
    """Restore the latest checkpoint into ``sim``; returns the next round
    to run."""
    state = manager.restore()
    sim.params = {k: v.to(sim.device) for k, v in state["params"].items()}
    return int(state["round"]) + 1
