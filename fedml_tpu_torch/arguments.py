"""Config/flag system: argparse + YAML section families -> one flat ``Arguments``.

The port's own copy of ``fedml_tpu/arguments.py`` (the port imports nothing
from the JAX package). Parity: reference ``python/fedml/arguments.py`` (``add_args():32``, ``Arguments:54``,
``load_arguments():158``). Same surface — ``--cf`` YAML file with section families
(``common_args``, ``data_args``, ``model_args``, ``train_args``, ``validation_args``,
``device_args``, ``comm_args``, ``tracking_args``) flattened onto one namespace —
but unlike the reference, cross-section key collisions raise instead of silently
clobbering (SURVEY.md §5.6 notes the reference collides silently).
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional

from .constants import FEDML_TRAINING_PLATFORM_SIMULATION

# Section families recognised in config YAML; any other top-level key is also
# flattened (so user extensions work), but these are the documented ones.
SECTION_FAMILIES = (
    "common_args",
    "data_args",
    "model_args",
    "train_args",
    "validation_args",
    "device_args",
    "comm_args",
    "tracking_args",
    "security_args",
    "attack_args",
    "defense_args",
    # fault injection / retry / recovery (fault_*, send_retry*,
    # handshake_timeout, round_ckpt_path, ... — see docs/robustness.md)
    "robustness_args",
)


def add_args(parser: Optional[argparse.ArgumentParser] = None) -> argparse.ArgumentParser:
    """CLI surface, mirrors reference ``add_args()`` (arguments.py:32)."""
    parser = parser or argparse.ArgumentParser(description="fedml_tpu_torch")
    parser.add_argument(
        "--yaml_config_file", "--cf", dest="yaml_config_file",
        help="yaml configuration file", type=str, default="",
    )
    parser.add_argument("--run_id", type=str, default="0")
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--local_rank", type=int, default=0)
    parser.add_argument("--role", type=str, default="client")
    return parser


class Arguments:
    """Flat attribute bag built from YAML sections + CLI overrides.

    Parity: reference ``Arguments`` (arguments.py:54). Attribute access for
    missing keys raises AttributeError, same as the reference; use
    ``getattr(args, k, default)`` for optional keys.
    """

    def __init__(
        self,
        cmd_args: Optional[argparse.Namespace] = None,
        training_type: Optional[str] = None,
        comm_backend: Optional[str] = None,
        override: Optional[Dict[str, Any]] = None,
    ):
        # 1. CLI args
        if cmd_args is not None:
            for k, v in vars(cmd_args).items():
                setattr(self, k, v)
        # 2. YAML config
        config_path = getattr(self, "yaml_config_file", "") or ""
        if config_path:
            config = load_yaml_config(config_path)
            self.set_attr_from_config(config)
        # 3. defaults that upper layers rely on (only fill what config left
        # unset, so an explicit run_simulation(backend=...) can still win)
        if getattr(self, "training_type", None) is None:
            self.training_type = training_type or FEDML_TRAINING_PLATFORM_SIMULATION
        if getattr(self, "backend", None) is None and comm_backend is not None:
            self.backend = comm_backend
        # 4. programmatic overrides win over everything
        if override:
            for k, v in override.items():
                setattr(self, k, v)

    def set_attr_from_config(self, configuration: Dict[str, Any]) -> None:
        """Flatten section families; collisions across sections raise."""
        seen: Dict[str, str] = {}
        for section, content in configuration.items():
            if isinstance(content, dict) and (
                section in SECTION_FAMILIES or section.endswith("_args")
            ):
                for k, v in content.items():
                    if k in seen and getattr(self, k, None) != v:
                        raise ValueError(
                            f"config key '{k}' set by both [{seen[k]}] and [{section}] "
                            f"with different values"
                        )
                    seen[k] = section
                    setattr(self, k, v)
            else:
                setattr(self, section, content)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items() if not k.startswith("_")}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Arguments({self.to_dict()!r})"


def load_yaml_config(yaml_path: str) -> Dict[str, Any]:
    # imported here: only a YAML config file needs PyYAML
    import yaml

    with open(yaml_path, "r") as f:
        return yaml.safe_load(f) or {}


def load_arguments(
    training_type: Optional[str] = None,
    comm_backend: Optional[str] = None,
    args_list: Optional[list] = None,
    override: Optional[Dict[str, Any]] = None,
) -> Arguments:
    """Parity: reference ``load_arguments()`` (arguments.py:158).

    ``args_list`` lets tests inject argv; ``override`` lets the programmatic API
    (``fedml_tpu.init(config=...)``) skip YAML entirely.
    """
    parser = add_args()
    cmd_args, _ = parser.parse_known_args(args=args_list)
    args = Arguments(cmd_args, training_type, comm_backend, override=override)

    # torchrun/jax-distributed style env overrides (reference __init__.py:152-174)
    for env_key, attr in (("RANK", "rank"), ("WORLD_SIZE", "worker_num"),
                          ("LOCAL_RANK", "local_rank")):
        if env_key in os.environ:
            setattr(args, attr, int(os.environ[env_key]))

    # engine-selection knobs are validated at config load so a YAML typo
    # fails naming the key, not as a TypeError deep in SimConfig
    rpd = getattr(args, "rounds_per_dispatch", None)
    if rpd is not None:
        try:
            args.rounds_per_dispatch = int(rpd)
        except (TypeError, ValueError):
            raise ValueError(
                f"rounds_per_dispatch must be a positive integer, got {rpd!r}"
            ) from None
        if args.rounds_per_dispatch < 1:
            raise ValueError(
                "rounds_per_dispatch must be >= 1 "
                f"(got {args.rounds_per_dispatch}); 1 is the classic "
                "per-round engine")
    return args
