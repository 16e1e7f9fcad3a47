"""Data layer: ``fedml_tpu_torch.data.load(args)``, the port of
``fedml_tpu/data/__init__.py:28``. Returns ``(FederatedData, class_num)``."""

from __future__ import annotations

from .federated import ArrayPair, FederatedData, build_federated_data
from .loaders import load_partition_data
from .synthetic import make_classification_like

__all__ = [
    "load",
    "ArrayPair",
    "FederatedData",
    "build_federated_data",
    "load_partition_data",
    "make_classification_like",
]


def load(args):
    """Load + federate the dataset named by args (``partition_method``
    "hetero" = Dirichlet with ``partition_alpha``, else IID). The
    ``centralized`` and ``poison_ratio`` modes of the JAX loader are not
    ported yet."""
    for knob in ("centralized", "poison_ratio"):
        if getattr(args, knob, None):
            raise NotImplementedError(
                f"{knob} is not ported yet (ROADMAP.md Queue 1, item 2)")
    fed = load_partition_data(
        dataset=getattr(args, "dataset", "mnist"),
        data_cache_dir=getattr(args, "data_cache_dir", None),
        partition_method=getattr(args, "partition_method", "hetero"),
        partition_alpha=float(getattr(args, "partition_alpha", 0.5)),
        client_num=int(getattr(args, "client_num_in_total", 10)),
        small=bool(getattr(args, "debug_small_data", False)),
    )
    return fed, fed.class_num
