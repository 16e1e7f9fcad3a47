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
    ("attack_type", None, "5"), ("model_axis_size", 1, "10"),
)


def _opt_float(args, key):
    val = getattr(args, key, None)
    return None if val is None else float(val)


# federated optimizers that the JAX package runs on engines of their own
# (its simulation/__init__.py:162-210), matched case-insensitively as there
_UNPORTED_ENGINES = ("hierarchicalfl", "tieredfl", "decentralized")


def _check_unported(args) -> None:
    for key, default, item in _UNPORTED:
        val = getattr(args, key, None)
        if val is not None and val != default:
            raise NotImplementedError(
                f"{key}={val!r} selects a feature that is not ported yet "
                f"(ROADMAP.md Queue 1, item {item})")
    name = str(getattr(args, "federated_optimizer", "FedAvg"))
    if name.lower() in _UNPORTED_ENGINES:
        raise NotImplementedError(
            f"federated optimizer {name!r} runs on an engine of its own that is not ported "
            "yet (ROADMAP.md Queue 1, item 11)")


def build_simulator(args, fed_data=None, model=None, variables=None) -> tuple:
    """Data + model + algorithm + FedSimulator on ``args.device`` (default
    cuda). ``variables`` (a path-keyed variables dict: params and, for
    BatchNorm models, batch_stats) replaces the fresh initialisation, e.g.
    to start from the JAX package's weights. Returns ``(simulator,
    apply_fn)``."""
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
    has_batch_stats = models_mod.has_batch_stats(variables)
    # models with live Dropout layers train on keep masks drawn per step
    # (JAX simulation/__init__.py:84: cnn = CNN_DropOut)
    dropout_layers = models_mod.dropout_layers(model)
    cfg = LocalTrainConfig(
        lr=float(getattr(args, "learning_rate", 0.03)),
        epochs=int(getattr(args, "epochs", 1)),
        client_optimizer=str(getattr(args, "client_optimizer", "sgd")),
        momentum=float(getattr(args, "momentum", 0.0) or 0.0),
        weight_decay=float(getattr(args, "weight_decay", 0.0) or 0.0),
        prox_mu=_opt_float(args, "fedprox_mu"),
        dp_l2_clip=_opt_float(args, "dp_l2_clip"),
        dp_noise_multiplier=float(getattr(args, "dp_noise_multiplier", None) or 0.0),
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
        checkpoint_dir=getattr(args, "checkpoint_dir", None),
        checkpoint_frequency=int(getattr(args, "checkpoint_frequency", 10)),
        resume=bool(getattr(args, "resume", True)),
        client_dropout_rate=float(getattr(args, "client_dropout_rate", 0.0) or 0.0),
        cohort_schedule=str(getattr(args, "cohort_schedule", "auto")),
        packed_lanes=(None if getattr(args, "packed_lanes", None) is None
                      else int(args.packed_lanes)),
        packed_flat_carry=bool(getattr(args, "packed_flat_carry", False)),
        max_width_buckets=int(getattr(args, "max_width_buckets", 4)),
        local_test_on_all_clients=bool(getattr(args, "local_test_on_all_clients", False)),
        agg_kernels=bool(getattr(args, "agg_kernels", False)),
        sanitize_updates=bool(getattr(args, "sanitize_updates", False)),
        sanitize_z_thresh=float(getattr(args, "sanitize_z_thresh", 6.0)),
        # only an explicit spec engages the in-sim codec, as in the JAX package
        comm_codec=(None if comm_codec.lower() in ("", "none", "off", "auto")
                    else comm_codec),
        client_state_backend=str(getattr(args, "client_state_backend", "arena")),
        client_state_capacity=(None if getattr(args, "client_state_capacity", None) is None
                               else int(args.client_state_capacity)),
    )
    alg = get_algorithm(
        str(getattr(args, "federated_optimizer", "FedAvg")), apply_fn, cfg,
        needs_dropout=bool(dropout_layers), has_batch_stats=has_batch_stats,
        server_lr=float(getattr(args, "server_lr", 1.0)),
        server_optimizer_name=str(getattr(args, "server_optimizer", "sgd")),
        server_momentum=float(getattr(args, "server_momentum", 0.9)),
        client_fraction=float(getattr(args, "client_num_per_round", 10))
        / max(float(getattr(args, "client_num_in_total", 10)), 1.0),
        defense_type=getattr(args, "defense_type", None),
        norm_bound=float(getattr(args, "norm_bound", 5.0)),
        stddev=float(getattr(args, "stddev", 0.0)),
        trim_ratio=float(getattr(args, "trim_ratio", 0.1)),
        byzantine_n=int(getattr(args, "byzantine_n", 0)),
        multi_krum_m=(None if getattr(args, "multi_krum_m", None) is None
                      else int(args.multi_krum_m)),
        dp_seed=int(getattr(args, "random_seed", 0)),
    )
    sim = FedSimulator(fed_data, alg, variables, sim_cfg, device,
                       # the raw pieces of the packed schedule's per-slot step
                       packed_ctx=(apply_fn, cfg),
                       # the reference's test_on_the_server hook object
                       server_tester=getattr(args, "server_tester", None),
                       hook_args=args, dropout_layers=dropout_layers)
    return sim, apply_fn


class SimulatorSingleProcess:
    """Reference ``SimulatorSingleProcess`` (simulator.py:23)."""

    def __init__(self, args, dataset=None, model=None):
        self.sim, self.apply_fn = build_simulator(args, dataset, model)

    def run(self):
        return self.sim.run(self.apply_fn)
