"""Checkpoint/resume of the simulator (port of
``fedml_tpu/utils/checkpoint.py``: ``CheckpointManager``:18,
``save_simulator_state``:197, ``restore_simulator_state``:221).

The JAX package writes orbax checkpoints; the port writes its own format
with ``torch.save``: one file ``step_<n>.pt`` per saved round in the
checkpoint directory, written under a temporary name and renamed, so a
crash leaves the previous file or the new one, never a torn one. A file
holds ``{"params": {path: CPU tensor}, "round": n, "server_state": ...,
"client_states": {str(client id): state}}`` and, for an arena-backed run,
``"client_arena"`` (``ClientStateArena.export_state``: the device slots,
the slot map, the LRU clock and the host tier). ``"params"`` holds every
variable of the global model: a BatchNorm model's ``batch_stats/...``
running statistics beside its ``params/...`` leaves. The server state is
the algorithm's own structure of CPU tensors: FedOpt's optimizer moments
(over the ``params/...`` leaves only for a BatchNorm model),
SCAFFOLD's control variate, weak DP's generator state (a byte tensor).
The port does not read orbax checkpoints, nor the JAX package this format.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch
from torch.utils import _pytree as pytree

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


def _cpu(tree):
    return pytree.tree_map(lambda v: v.detach().cpu().clone(), tree)


def _to(tree, device):
    # byte tensors are generator states, which torch keeps on the CPU
    return pytree.tree_map(lambda v: v if v.dtype == torch.uint8 else v.to(device), tree)


def save_simulator_state(manager: CheckpointManager, sim, round_idx: int) -> None:
    """Persist a FedSimulator's resumable state after round ``round_idx``
    (``checkpoint.py:197``): arena-backed runs save the whole arena,
    dict-backed ones the per-client mapping."""
    state = {
        "params": _cpu(sim.params),
        "round": int(round_idx),
        "server_state": _cpu(sim.server_state),
        "client_states": {str(k): _cpu(v) for k, v in sim.client_states.items()},
    }
    if sim._arena is not None:
        state["client_arena"] = sim._arena.export_state()
    manager.save(round_idx, state)


def restore_simulator_state(manager: CheckpointManager, sim) -> int:
    """Restore the latest checkpoint into ``sim`` (``checkpoint.py:221``);
    returns the next round to run. A dict-backend checkpoint feeding an
    arena-backed run seeds the arena's host tier."""
    state = manager.restore()
    sim.params = {k: v.to(sim.device) for k, v in state["params"].items()}
    sim.server_state = _to(state["server_state"], sim.device)
    arena = sim._arena
    if arena is not None and state.get("client_arena") is not None:
        arena.import_state(state["client_arena"])
    elif arena is not None:
        for k, v in (state.get("client_states") or {}).items():
            arena.preload(int(k), v)
    else:
        sim.client_states = {int(k): _to(v, sim.device)
                             for k, v in (state.get("client_states") or {}).items()}
    return int(state["round"]) + 1
