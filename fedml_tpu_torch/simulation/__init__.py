"""Simulator facade (port of ``fedml_tpu/simulation/__init__.py``:
``build_simulator``:43 and ``SimulatorSingleProcess``:289).

Configuration knobs of the JAX package that this slice does not port raise
``NotImplementedError`` naming the ROADMAP.md item, rather than being
silently ignored.
"""

from __future__ import annotations

import functools

import torch

from .. import data as data_mod
from .. import models as models_mod
from ..algorithms import LocalTrainConfig, get_algorithm
from ..utils import resolve_device
from .fed_sim import FedSimulator, SimConfig

__all__ = ["FedSimulator", "SimConfig", "SimulatorSingleProcess", "build_simulator"]

# (config key, its default, ROADMAP.md Queue 1 item): a value other than the
# default selects a path of the JAX package that is not ported yet
_UNPORTED = (
    ("rounds_per_dispatch", 1, "9"), ("watchdog_factor", 0, "8"),
    ("async_mode", False, "11"), ("client_state_spill_dir", None, "8"),
    ("client_state_capacity", None, "8"), ("attack_type", None, "5"),
    ("checkpoint_dir", None, "8"), ("local_test_on_all_clients", False, "4"),
    ("fedprox_mu", None, "3"), ("dp_l2_clip", None, "3"),
    ("dp_noise_multiplier", 0, "3"), ("model_axis_size", 1, "10"),
    ("packed_lanes", None, "4"), ("server_tester", None, "4"),
    ("client_dropout_rate", 0, "4"),
)


def _check_unported(args) -> None:
    for key, default, item in _UNPORTED:
        val = getattr(args, key, None)
        if val is not None and val != default:
            raise NotImplementedError(
                f"{key}={val!r} selects a feature that is not ported yet "
                f"(ROADMAP.md Queue 1, item {item})")


def build_simulator(args, fed_data=None, model=None, variables=None) -> tuple:
    """Data + model + algorithm + FedSimulator on ``args.device`` (default
    cuda). ``variables`` (a path-keyed parameter dict) replaces the fresh
    initialisation, e.g. to start from the JAX package's weights. Returns
    ``(simulator, apply_fn)``."""
    _check_unported(args)
    device = resolve_device(getattr(args, "device", None))
    if fed_data is None:
        fed_data, output_dim = data_mod.load(args)
    else:
        output_dim = fed_data.class_num
    in_shape = tuple(fed_data.train_data_global.x.shape[1:])
    if model is None:
        model = models_mod.create(args, output_dim, in_shape)
    model = model.to(device)
    if variables is None:
        gen = torch.Generator().manual_seed(int(getattr(args, "random_seed", 0)))
        variables = models_mod.init_params(model, gen)
    apply_fn = functools.partial(models_mod.apply, model)
    cfg = LocalTrainConfig(
        lr=float(getattr(args, "learning_rate", 0.03)),
        epochs=int(getattr(args, "epochs", 1)),
        client_optimizer=str(getattr(args, "client_optimizer", "sgd")),
        momentum=float(getattr(args, "momentum", 0.0) or 0.0),
        weight_decay=float(getattr(args, "weight_decay", 0.0) or 0.0),
        loss_kind=str(getattr(args, "loss_kind", None) or "ce"),
    )
    comm_codec = str(getattr(args, "comm_codec", "") or "")
    sim_cfg = SimConfig(
        comm_round=int(getattr(args, "comm_round", 10)),
        client_num_in_total=int(getattr(args, "client_num_in_total", 10)),
        client_num_per_round=int(getattr(args, "client_num_per_round", 10)),
        batch_size=int(getattr(args, "batch_size", 32)),
        frequency_of_the_test=int(getattr(args, "frequency_of_the_test", 5)),
        seed=int(getattr(args, "random_seed", 0)),
        cohort_schedule=str(getattr(args, "cohort_schedule", "auto")),
        agg_kernels=bool(getattr(args, "agg_kernels", False)),
        sanitize_updates=bool(getattr(args, "sanitize_updates", False)),
        sanitize_z_thresh=float(getattr(args, "sanitize_z_thresh", 6.0)),
        # only an explicit spec engages the in-sim codec, as in the JAX package
        comm_codec=(None if comm_codec.lower() in ("", "none", "off", "auto")
                    else comm_codec),
    )
    alg = get_algorithm(
        str(getattr(args, "federated_optimizer", "FedAvg")), apply_fn, cfg,
        defense_type=getattr(args, "defense_type", None),
        byzantine_n=int(getattr(args, "byzantine_n", 0)),
        multi_krum_m=(None if getattr(args, "multi_krum_m", None) is None
                      else int(args.multi_krum_m)),
    )
    return FedSimulator(fed_data, alg, variables, sim_cfg, device), apply_fn


class SimulatorSingleProcess:
    """Reference ``SimulatorSingleProcess`` (simulator.py:23)."""

    def __init__(self, args, dataset=None, model=None):
        self.sim, self.apply_fn = build_simulator(args, dataset, model)

    def run(self):
        return self.sim.run(self.apply_fn)
