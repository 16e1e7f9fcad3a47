"""fedml_tpu_torch — the PyTorch/CUDA port of ``fedml_tpu``.

A second package beside the JAX one, with the same module names and the
same entry points: ``init()`` and ``run_simulation()``. It imports torch
and numpy, never JAX, and nothing from ``fedml_tpu``. Entry points run on
the CUDA device unless the config asks for ``device: cpu``. The kernels the
JAX package wrote in Pallas are hand-written CUDA here (``csrc/``), built
with ``nvcc`` for Hopper at first use.
"""

from __future__ import annotations

__version__ = "0.1.0"

from typing import Any, Dict, Optional

from . import constants
from .arguments import Arguments, load_arguments
from .constants import FEDML_SIMULATION_TYPE_SP
from .utils import set_seeds

__all__ = ["init", "run_simulation", "Arguments", "load_arguments", "constants"]

_global_args: Optional[Arguments] = None


def init(args: Optional[Arguments] = None, config: Optional[Dict[str, Any]] = None) -> Arguments:
    """Load args (``config`` overrides, or a ``--cf`` YAML) and seed the
    process-global streams (``fedml_tpu.init``)."""
    global _global_args
    if args is None:
        args = load_arguments(override=config)
    set_seeds(int(getattr(args, "random_seed", 0)))
    _global_args = args
    return args


def run_simulation(backend: str = FEDML_SIMULATION_TYPE_SP, args: Optional[Arguments] = None):
    """Run the single-process simulator and return its round history."""
    from .simulation import SimulatorSingleProcess

    args = args or _global_args or init()
    backend = getattr(args, "backend", None) or backend
    if backend != FEDML_SIMULATION_TYPE_SP:
        raise NotImplementedError(
            f"simulation backend '{backend}' (a device mesh) is not ported yet "
            "(ROADMAP.md Queue 1, item 10); use backend 'sp'")
    return SimulatorSingleProcess(args).run()
