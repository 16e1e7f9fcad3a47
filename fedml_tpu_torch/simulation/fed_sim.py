"""The federated simulator, single device (port of
``fedml_tpu/simulation/fed_sim.py`` on its one-round-per-dispatch path
without a mesh), with the JAX package's three cohort schedules:

- **even** (``_round_step``, the counterpart of ``_make_round_body``:702):
  every client padded to the largest client's batch count; gather the
  cohort's batches by index from the device-resident training set, train
  the whole cohort at once (``torch.func.vmap`` of the algorithm's
  ``local_update``, each client's state gathered from the client-state
  arena and scattered back after), codec roundtrip (q8/q4 through the
  fused CUDA kernel), sanitizer + defense (with ``agg_kernels`` and a
  Krum-family defense, one pass through ``core.robust.fused_sanitize_krum``
  and the Gram kernel), aggregate, server update (carrying the server state: FedOpt's optimizer
  moments, SCAFFOLD's control variate, weak DP's generator);
- **packed** (``_dispatch_packed``, the counterpart of
  ``_build_packed_step``:1121): clients back to back in G lanes
  (``core.scheduler.lane_schedule``); one slot trains every lane one batch
  under ``vmap(grad_and_value)`` over the lanes' own parameters and
  optimizer states, and at a client's last batch the lane flushes its
  weighted delta and resets to the global parameters and a fresh
  optimizer state;
- **bucketed** (``_dispatch_bucketed``): width classes of the cohort
  (``core.scheduler.bucket_schedule``), one vmapped partial sum per class
  and one finalize.

``auto`` picks packed (or bucketed) for a skewed population and even
otherwise, by the JAX package's rule (``fed_sim.py:530-579``): packed
needs a mean-aggregating algorithm without client state, DP-SGD or
BatchNorm, bucketed a mean-aggregating one; FedNova, SCAFFOLD and the
defenses run even. BatchNorm models carry their ``batch_stats`` leaves in
the global variables beside the params: the even and bucketed rounds
train and average both, evaluation and the local tests run on the running
averages. Dropout models get their keep masks drawn per client step on the
host's schedule (:func:`dropout_masks`). Host-side packing (sampling, the drop mask, shuffles, index
rectangles, lane and bucket plans) is a pure function of (seed, round),
bit-identical to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.func import grad_and_value, vmap
from torch.utils import _pytree as pytree

from ..algorithms.local_sgd import make_eval_fn, make_loss_fn
from ..core.algframe import FedAlgorithm, has_leaves, weighted_mean
from ..data.federated import FederatedData
from ..models import draw_dropout_masks, has_batch_stats
from ..ops.losses import per_sample_metrics
from .client_store import ClientStateArena, cohort_local_update
from .sampling import client_permutation_list, sample_clients


EVAL_BATCH_SIZE = 256  # the JAX SimConfig's eval_batch_size


@dataclasses.dataclass
class SimConfig:
    comm_round: int = 10
    client_num_in_total: int = 10
    client_num_per_round: int = 10
    batch_size: int = 32
    frequency_of_the_test: int = 5
    seed: int = 0
    # packed schedule: force the lane count (None = the G*L search of
    # core.scheduler.lane_schedule)
    packed_lanes: Optional[int] = None
    # the JAX package's ravelled-carry packed executor (a v5e speed knob,
    # same numerics): not ported, raises when set
    packed_flat_carry: bool = False
    # checkpoint/resume (utils/checkpoint.py, torch.save files)
    checkpoint_dir: Optional[str] = None
    checkpoint_frequency: int = 10
    resume: bool = True
    # each round, each sampled client drops with this probability (weight
    # and mask zeroed); at least one client always survives
    client_dropout_rate: float = 0.0
    # "even" | "packed" | "bucketed" | "auto" (fed_sim.py:95-121)
    cohort_schedule: str = "auto"
    max_width_buckets: int = 4
    # per-client local tests on every client's train and test split at
    # eval rounds (the reference's _local_test_on_all_clients)
    local_test_on_all_clients: bool = False
    # fuse sanitize + Krum into one pass (core.robust.fused_sanitize_krum)
    agg_kernels: bool = False
    sanitize_updates: bool = False
    sanitize_z_thresh: float = 6.0
    # codec spec (comm/codec.py grammar) applied to every client's update
    comm_codec: Optional[str] = None
    # per-client algorithm state (SCAFFOLD): "arena" (simulation/
    # client_store.py, device slots with an LRU host tier) or "dict" (one
    # entry per client, the oracle the arena is held to); the arena's
    # capacity defaults to client_num_in_total
    client_state_backend: str = "arena"
    client_state_capacity: Optional[int] = None


@dataclasses.dataclass
class RoundInputs:
    """One round's host-built cohort tensors (numpy)."""

    round_idx: int
    client_ids: np.ndarray
    drop: Optional[np.ndarray]
    kind: str  # "even" | "bucketed" | "packed"
    payload: Any


def _gather_from_device(data: Dict[str, Any], x_all, y_all) -> Dict[str, Any]:
    """Replace the cohort's index rectangle with x/y gathered from the
    device-resident global arrays; padded rows (index 0) are zeroed."""
    idx = data.pop("idx").long()
    m = data["mask"]

    def _masked(gathered):
        mb = m.reshape(m.shape + (1,) * (gathered.dim() - m.dim()))
        return gathered * mb.to(gathered.dtype)

    data["x"] = _masked(x_all[idx])
    data["y"] = _masked(y_all[idx])
    return data


def _cohort_outputs(alg: FedAlgorithm, params, cohort, client_states=(), rngs=None):
    """The cohort's local updates, stacked along a leading client axis."""
    return cohort_local_update(alg.local_update, params, client_states, cohort, rngs)


def _noise_seed(seed: int, round_idx: int, pos: int, step: int, *stream: int) -> int:
    """The 64-bit seed of one DP-SGD noise draw (or, with ``stream`` 1, of
    one step's dropout masks), keyed as the JAX package keys its step rng
    (``fed_sim.py:323-331``, ``local_sgd.py:262``): by the run's seed, the
    round, the client's cohort position and the batch step, so a client's
    draws do not depend on the schedule."""
    state = np.random.SeedSequence([seed, round_idx, pos, step, *stream]).generate_state(
        2, np.uint32)
    return int(state[0]) | (int(state[1]) << 32)


DROPOUT_STREAM = 1  # _noise_seed's stream of the dropout masks


def _draw_step_masks(out, index, gen, seed, round_idx, pos, step, layers, batch, device):
    """One client step's keep masks, into ``out[l][index]`` per layer, from
    ``gen`` seeded by :func:`_noise_seed` (seed, round, pos, step,
    DROPOUT_STREAM)."""
    gen.manual_seed(_noise_seed(seed, round_idx, int(pos), int(step), DROPOUT_STREAM))
    for o, m in zip(out, draw_dropout_masks(layers, batch, gen, device)):
        o[index] = m


def dropout_masks(seed: int, round_idx: int, pos: np.ndarray, mask: np.ndarray, epochs: int,
                  layers, device) -> tuple:
    """A cohort rectangle's dropout keep masks: per layer of ``layers``
    (``models.dropout_layers``) a (C, epochs * NB, BS, *shape) bool tensor,
    step (c, s) drawn by :func:`models.draw_dropout_masks` from a generator
    keyed by (seed, round, pos[c], s); steps whose batch holds no real row
    keep nothing (such a step is a no-op)."""
    C, NB, BS = mask.shape[:3]
    real = mask.reshape(C, NB, -1).sum(-1) > 0
    out = [torch.zeros((C, epochs * NB, BS) + tuple(shape), dtype=torch.bool, device=device)
           for shape, _ in layers]
    gen = torch.Generator(device=device)
    for c in range(C):
        for e in range(epochs):
            for b in np.nonzero(real[c])[0]:
                s = e * NB + int(b)
                _draw_step_masks(out, (c, s), gen, seed, round_idx, pos[c], s, layers, BS,
                                 device)
    return tuple(out)


def dp_noise(seed: int, round_idx: int, pos: np.ndarray, mask: np.ndarray, epochs: int,
             n_params: int, device) -> torch.Tensor:
    """DP-SGD's standard normals for a cohort rectangle: (C, epochs * NB,
    n_params) float32, row (c, s) drawn from a generator seeded by
    :func:`_noise_seed` (seed, round, pos[c], s); steps whose batch holds no
    real row stay zero (such a step is a no-op)."""
    C, NB = mask.shape[:2]
    real = mask.reshape(C, NB, -1).sum(-1) > 0
    out = torch.zeros((C, epochs * NB, n_params), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    for c in range(C):
        for e in range(epochs):
            for b in np.nonzero(real[c])[0]:
                s = e * NB + int(b)
                gen.manual_seed(_noise_seed(seed, round_idx, int(pos[c]), s))
                out[c, s].normal_(generator=gen)
    return out


def pack_lane_rows(rows: np.ndarray, srcmap: np.ndarray) -> np.ndarray:
    """Gather (n_rows, bs) int32 batch rows into the packed schedule's lane
    tensor through a slot -> row map (the numpy branch of
    ``fedml_tpu/native/__init__.py:208``); the output has srcmap's shape
    plus a trailing bs axis."""
    rows = np.ascontiguousarray(rows, np.int32)
    sm = np.ascontiguousarray(srcmap, np.int64)
    return rows[sm.ravel()].reshape(sm.shape + (rows.shape[-1],))


def _per_lane(v: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A (G,) lane vector shaped to broadcast against a (G, ...) leaf."""
    return v.reshape(v.shape + (1,) * (t.dim() - 1))


class FedSimulator:
    """Round loop over a FedAlgorithm on one device.

    ``packed_ctx`` = (apply_fn, LocalTrainConfig), the raw pieces the packed
    schedule's per-slot step needs (None: packed is ineligible).
    ``dropout_layers`` (``models.dropout_layers``) are the model's Dropouts,
    whose keep masks each round draws.
    ``server_tester`` is an object with the reference's
    ``test_on_the_server(train_local, test_local, device, args)``: at eval
    rounds a truthy return replaces the default evaluation, and a dict
    return is merged into the round record; ``hook_args`` is the args
    object it receives."""

    def __init__(self, fed_data: FederatedData, algorithm: FedAlgorithm,
                 init_variables: Dict[str, torch.Tensor], cfg: SimConfig,
                 device: torch.device, packed_ctx: Optional[tuple] = None,
                 server_tester=None, hook_args=None, dropout_layers=()):
        if cfg.packed_flat_carry:
            raise NotImplementedError(
                "packed_flat_carry (the ravelled-carry packed executor) is not ported yet "
                "(ROADMAP.md Queue 1, item 4); the packed schedule runs per leaf")
        self.fed = fed_data
        self.alg = algorithm
        self.cfg = cfg
        self.device = device
        self.params = {k: v.to(device) for k, v in init_variables.items()}
        self._has_bn = has_batch_stats(self.params)
        self._dropout_layers = list(dropout_layers or ())
        self.server_state = algorithm.init_server_state(self.params)
        self._client_state_proto = algorithm.init_client_state(self.params)
        self._stateful = has_leaves(self._client_state_proto)
        # the dict backend's per-client states (the arena's oracle)
        self.client_states: Dict[int, Any] = {}
        self.history: List[Dict[str, Any]] = []
        self._eval_fn = None
        self._packed_ctx = packed_ctx
        self._lane_grad = None
        self._lane_opt = None
        self._server_tester = server_tester
        self._hook_args = hook_args
        self._local_eval_cache: Dict[str, Any] = {}
        # packed schedule: round-independent lane structure per (cohort,
        # drop) pattern, FIFO-bounded (fed_sim.py:2390)
        self._lane_plan_cache: Dict[Any, Dict[str, Any]] = {}
        self._last_packed_shape = None

        sizes = [len(v) for v in fed_data._global_index.values()]
        # every client padded to the largest client's batch count
        self.num_local_batches = max(1, -(-max(sizes) // cfg.batch_size))
        self._batch_counts = {c: max(1, -(-len(v) // cfg.batch_size))
                              for c, v in fed_data._global_index.items()}
        train, test = fed_data.train_data_global, fed_data.test_data_global
        self._x_dev = torch.from_numpy(np.ascontiguousarray(train.x)).to(device)
        self._y_dev = torch.from_numpy(np.ascontiguousarray(train.y)).to(device)
        self._x_test = torch.from_numpy(np.ascontiguousarray(test.x)).to(device)
        self._y_test = torch.from_numpy(np.ascontiguousarray(test.y)).to(device)

        self._detect = bool(cfg.sanitize_updates)
        if self._detect and not algorithm.update_is_params:
            raise NotImplementedError(
                "sanitize_updates over an update that is not params-shaped (FedNova, "
                "SCAFFOLD) is not ported yet (ROADMAP.md Queue 1, item 5)")
        self._codec_rt = None
        if cfg.comm_codec:
            from ..comm import codec as wire_codec

            if not algorithm.update_is_params:
                raise ValueError(
                    "comm_codec compresses params-shaped client updates; algorithm "
                    f"{algorithm.name} produces a custom update structure")
            self._codec_rt = wire_codec.build_stacked_roundtrip(cfg.comm_codec, cfg.seed)
        # schedule resolution, as fed_sim.py:530-579: the sanitizer and the
        # codec need the full stacked cohort and pin the even schedule; a
        # custom aggregate or an update that is not params-shaped is not
        # mean-aggregating; packed also needs no client state, no DP-SGD and
        # no BatchNorm (fed_sim.py:547)
        force_even = self._detect or self._codec_rt is not None
        mean_agg = (algorithm.aggregate is None and algorithm.update_is_params
                    and not force_even)
        packed_ok = (packed_ctx is not None and mean_agg and not self._stateful
                     and algorithm.prepare_client_state is None
                     and not packed_ctx[1].use_scaffold and packed_ctx[1].dp_l2_clip is None
                     and not self._has_bn)
        schedule = cfg.cohort_schedule
        if force_even and schedule in ("packed", "bucketed"):
            raise ValueError(
                f"cohort_schedule='{schedule}' is incompatible with the update sanitizer / "
                "comm_codec, which need the full stacked cohort (use 'even' or 'auto')")
        if force_even:
            schedule = "even"
        if schedule == "auto":
            counts = np.asarray(list(self._batch_counts.values()))
            skewed = counts.max() >= 2 * max(np.median(counts), 1)
            if skewed:
                schedule = "packed" if packed_ok else "bucketed"
            else:
                schedule = "even"
        if schedule == "packed" and not packed_ok:
            raise ValueError(
                "cohort_schedule='packed' requires a stateless mean-aggregating algorithm "
                "and no SCAFFOLD/DP-SGD/BatchNorm (use 'bucketed' or 'auto')")
        self._packed = schedule == "packed"
        self._bucketed = schedule == "bucketed" and mean_agg
        self.schedule = ("packed" if self._packed else "bucketed" if self._bucketed
                         else "even")
        robust = algorithm.robust
        self._fuse_robust = bool(
            cfg.agg_kernels and self._detect and robust is not None
            and robust.defense_type in type(robust).KRUM_FAMILY)
        if cfg.client_state_backend not in ("arena", "dict"):
            raise ValueError(f"client_state_backend={cfg.client_state_backend!r} "
                             "(expected 'arena' or 'dict')")
        self._arena: Optional[ClientStateArena] = None
        self._prepare_fn = None
        if algorithm.prepare_client_state is not None:
            self._prepare_fn = vmap(algorithm.prepare_client_state, in_dims=(None, 0))
        if self._stateful and cfg.client_state_backend == "arena":
            capacity = cfg.client_state_capacity or cfg.client_num_in_total
            if capacity < cfg.client_num_per_round:
                raise ValueError(
                    f"client_state_capacity={capacity} < client_num_per_round="
                    f"{cfg.client_num_per_round}: the whole sampled cohort must fit in the arena")
            self._arena = ClientStateArena(self._client_state_proto, capacity, device=device)
        # DP-SGD noise, from the packed_ctx config (the algorithm's own copy
        # differs from it only in prox_mu and use_scaffold)
        lcfg = packed_ctx[1] if packed_ctx is not None else None
        self._dp_sigma = lcfg.dp_noise_sigma if lcfg is not None else 0.0
        self._epochs = int(lcfg.epochs) if lcfg is not None else 1
        self._n_params = sum(v.numel() for v in self.params.values())

    # --- client state and DP noise ------------------------------------------

    def _gather_states(self, client_ids: np.ndarray):
        """Stacked, prepared cohort states (fed_sim.py:1393): the arena's one
        index op per leaf (and the vmapped prepare), or the dict backend's
        per-client loop; () for stateless algorithms."""
        if not self._stateful:
            return ()
        if self._arena is not None:
            stacked = self._arena.gather(client_ids)
            if self._prepare_fn is not None:
                stacked = self._prepare_fn(self.server_state, stacked)
            return stacked
        rows = []
        for c in client_ids:
            s = self.client_states.get(int(c), self._client_state_proto)
            if self.alg.prepare_client_state is not None:
                s = self.alg.prepare_client_state(self.server_state, s)
            rows.append(s)
        return pytree.tree_map(lambda *xs: torch.stack(xs), rows[0], *rows[1:])

    def _scatter_states(self, client_ids: np.ndarray, stacked) -> None:
        """Write the real clients' new states back (fed_sim.py:1406)."""
        if not self._stateful:
            return
        if self._arena is not None:
            self._arena.scatter(client_ids, stacked)
            return
        for i, c in enumerate(client_ids):
            self.client_states[int(c)] = pytree.tree_map(lambda x: x[i].clone(), stacked)

    def _noise(self, payload: Dict[str, np.ndarray], round_idx: int):
        """The cohort's DP-SGD normals (:func:`dp_noise`), None without noise."""
        if self._dp_sigma <= 0.0:
            return None
        return dp_noise(self.cfg.seed, round_idx, payload["pos"], payload["mask"],
                        self._epochs, self._n_params, self.device)

    def _cohort_data(self, payload: Dict[str, np.ndarray], round_idx: int):
        """A cohort rectangle on the device: x and y gathered from the
        device-resident arrays, mask, num_samples and, for a dropout model,
        the keep masks (:func:`dropout_masks`)."""
        dev = self.device
        cohort = {k: torch.from_numpy(v).to(dev) for k, v in payload.items() if k != "pos"}
        data = _gather_from_device(cohort, self._x_dev, self._y_dev)
        if self._dropout_layers:
            data["dropout"] = dropout_masks(self.cfg.seed, round_idx, payload["pos"],
                                            payload["mask"], self._epochs,
                                            self._dropout_layers, dev)
        return data

    # --- the even round ----------------------------------------------------

    def _round_step(self, payload: Dict[str, np.ndarray], client_ids: np.ndarray,
                    round_idx: int):
        dev = self.device
        data = self._cohort_data(payload, round_idx)
        outs = _cohort_outputs(self.alg, self.params, data, self._gather_states(client_ids),
                               self._noise(payload, round_idx))
        update, w = outs.update, outs.weight.float()
        if self._codec_rt is not None:
            cids = torch.from_numpy(client_ids.astype(np.int32)).to(dev)
            update = self._codec_rt(update, cids, round_idx)
        quar = None
        if self._fuse_robust:
            from ..core.robust import fused_sanitize_krum

            ra = self.alg.robust
            f_byz, m_krum = ra._krum_fm(len(client_ids))
            agg, w, quar, _z, _sel = fused_sanitize_krum(
                update, w, z_thresh=float(self.cfg.sanitize_z_thresh), n_byz=f_byz,
                m=m_krum, sample_weighted=ra.defense_type == "krum_fedavg")
        else:
            if self._detect:
                from ..core.robust import sanitize_stacked

                update, w, quar, _z = sanitize_stacked(
                    update, w, float(self.cfg.sanitize_z_thresh))
            agg = (self.alg.aggregate(update, w) if self.alg.aggregate is not None
                   else weighted_mean(update, w))
        self.params, self.server_state = self.alg.server_update(self.params, agg,
                                                                self.server_state)
        self._scatter_states(client_ids, outs.state)
        m = outs.metrics
        metrics_vec = torch.stack([
            m["train_loss"].mean(),
            m["train_correct"].sum() / torch.clamp(m["train_valid"].sum(), min=1.0),
        ])
        return metrics_vec, quar

    # --- the packed round --------------------------------------------------

    def _dispatch_packed(self, inputs: RoundInputs) -> torch.Tensor:
        """One packed round (fed_sim.py:1121-1262, 2564). A Python loop over
        the plan's L_pad slots, padded ones included, as the JAX lane scan
        runs them: each slot gathers every lane's batch from the device
        arrays, takes ``vmap(grad_and_value)`` over the lanes' own
        parameters, adds FedProx's ``mu (p - global)``, scales the gradient
        by the batch weight ``bw = (mask.sum() > 0)`` and takes one step of
        the local optimizer, vmapped over the lanes' own optimizer states
        (plain SGD, without state, as ``torch._foreach_*`` over the leaves);
        at a client's last batch the lane flushes ``bweight * (p - global)``
        into a float32 sum and resets to the global parameters and a fresh
        optimizer state. The plan (mask, boundaries, weights) is numpy on
        the host, so the scale by ``bw`` runs only at slots where some lane
        has an empty batch, and the flush and the reset only at slots where
        some lane ends a client: elsewhere the JAX scan multiplies by one,
        adds zero and keeps the state, the same arithmetic for finite
        values. Nothing is read back inside the loop.
        Returns ``[sum of client losses / cohort_n, correct / valid]``."""
        p = inputs.payload
        G, L_pad = p["shape"]
        self._last_packed_shape = (G, L_pad)
        dev = self.device
        apply_fn, lcfg = self._packed_ctx
        if self._lane_grad is None:
            self._lane_grad = vmap(grad_and_value(make_loss_fn(apply_fn), has_aux=True))
            opt = lcfg.make_optimizer()
            self._lane_opt = (vmap(opt.init), vmap(opt.update))
        # plain SGD carries no optimizer state: its step is one foreach pass
        plain = (lcfg.client_optimizer != "adam" and not lcfg.momentum
                 and not lcfg.weight_decay and not lcfg.max_grad_norm)
        # the facade's config, as the JAX packed step reads it: FedProx's
        # default mu of 0.1 lives in the algorithm's copy, so an unset mu
        # is 0 here (ROADMAP.md Queue 3)
        prox_mu = 0.0 if lcfg.prox_mu is None else lcfg.prox_mu
        neg_lr = -float(lcfg.lr)
        mask_np, bnd_np, bwt_np = p["mask"], p["boundary"], p["bweight"]
        bw_np = (mask_np.sum(-1) > 0).astype(np.float32)  # (G, L_pad)
        idx = torch.from_numpy(p["idx"]).to(dev)
        mask = torch.from_numpy(mask_np).to(dev)
        bnd = torch.from_numpy(bnd_np).to(dev)
        bw = torch.from_numpy(bw_np).to(dev)
        w_flush = bwt_np * bnd_np  # (G, L_pad) host weights of the flushes
        x_all, y_all = self._x_dev, self._y_dev
        keys = list(self.params)
        gstack = [self.params[k].expand(G, *self.params[k].shape).contiguous() for k in keys]
        lp = [g.clone() for g in gstack]
        opt_init, opt_update = self._lane_opt
        opt0 = None if plain else opt_init(dict(zip(keys, gstack)))
        lopt = opt0
        dsum = [torch.zeros_like(g, dtype=torch.float32) for g in gstack]
        w_dev = torch.from_numpy(w_flush.astype(np.float32)).to(dev)
        zero = torch.zeros(G, dtype=torch.float32, device=dev)
        closs, csteps, lsum, corr, val = (zero.clone() for _ in range(5))
        for t in range(L_pad):
            batch = _gather_from_device({"idx": idx[:, t], "mask": mask[:, t]}, x_all, y_all)
            drop = self._slot_dropout(p, t, inputs.round_idx)
            grads, (loss, (correct, valid)) = self._lane_grad(
                dict(zip(keys, lp)), batch["x"], batch["y"], batch["mask"], *drop)
            g = [grads[k] for k in keys]
            if prox_mu > 0.0:
                g = [gi + prox_mu * (q - gq) for gi, q, gq in zip(g, lp, gstack)]
            bw_t = bw[:, t]
            if not bw_np[:, t].all():
                g = [gi * _per_lane(bw_t, gi) for gi in g]
            if plain:
                # optax.sgd: p + g * (-lr)
                torch._foreach_add_(lp, torch._foreach_mul(g, neg_lr))
            else:
                upd, lopt = opt_update(dict(zip(keys, g)), lopt, dict(zip(keys, lp)))
                lp = [q + upd[k] for k, q in zip(keys, lp)]
            closs = closs + loss * bw_t
            csteps = csteps + bw_t
            corr = corr + correct
            val = val + valid
            if not bnd_np[:, t].any():
                continue
            # client boundary: flush the weighted delta, reset the lane
            diff = torch._foreach_sub(lp, gstack)
            if G == 1:
                torch._foreach_mul_(diff, float(w_flush[0, t]))
            else:
                wt = w_dev[:, t]
                diff = [q * _per_lane(wt, q) for q in diff]
            torch._foreach_add_(dsum, diff)
            b_t = bnd[:, t]
            lsum = lsum + b_t * closs / torch.clamp(csteps, min=1.0)
            if bnd_np[:, t].all():
                lp = [gq.clone() for gq in gstack]
                lopt = opt0
            else:
                lp = [torch.where(_per_lane(b_t, q) > 0, gq, q) for q, gq in zip(lp, gstack)]
                if not plain:
                    lopt = pytree.tree_map(
                        lambda s, s0: torch.where(_per_lane(b_t, s) > 0, s0, s), lopt, opt0)
            closs = closs * (1.0 - b_t)
            csteps = csteps * (1.0 - b_t)
        # the weights are integers below 2^24: their float32 sum is exact
        total_w = max(float(w_flush.sum(dtype=np.float32)), 1.0)
        agg = {k: (d.sum(dim=0) / total_w).to(self.params[k].dtype)
               for k, d in zip(keys, dsum)}
        self.params, self.server_state = self.alg.server_update(self.params, agg,
                                                                self.server_state)
        # divisor: the FULL cohort (dropped clients are zero-loss rows)
        return torch.stack([lsum.sum() / max(float(p["cohort_n"]), 1.0),
                            corr.sum() / torch.clamp(val.sum(), min=1.0)])

    def _slot_dropout(self, p: Dict[str, Any], t: int, round_idx: int) -> tuple:
        """A packed slot's dropout keep masks, ``()`` without dropout: per
        lane with a real batch, drawn from the generator keyed by (seed,
        round, the lane's cohort position, its step in the client), as
        ``fed_sim.py:1193`` folds (pos, step-in-client) into the round key."""
        if not self._dropout_layers:
            return ()
        G, BS = p["mask"].shape[0], p["mask"].shape[2]
        layers, dev = self._dropout_layers, self.device
        out = [torch.zeros((G, BS) + tuple(shape), dtype=torch.bool, device=dev)
               for shape, _ in layers]
        gen = torch.Generator(device=dev)
        for g in np.nonzero(p["mask"][:, t].sum(-1) > 0)[0]:
            _draw_step_masks(out, g, gen, self.cfg.seed, round_idx, p["pos"][g, t],
                             p["sic"][g, t], layers, BS, dev)
        return (tuple(out),)

    # --- the bucketed round ------------------------------------------------

    def _dispatch_bucketed(self, inputs: RoundInputs) -> torch.Tensor:
        """One partial sum per width class (fed_sim.py:1272, :2640): the
        class's vmapped local updates, ``tensordot(w, u)`` in float32; then
        one finalize (the weighted mean and the server update, :1305).
        Metrics count each class's ``n_real`` rows only."""
        sum_wu, total_w = None, None
        loss_sum = correct_sum = valid_sum = None
        n_clients = 0
        for bucket in inputs.payload:
            n_real = bucket["n_real"]
            ids = bucket["ids"]
            data = self._cohort_data(bucket["payload"], inputs.round_idx)
            # padded slots re-gather the last client's state; only the real
            # rows scatter back
            outs = _cohort_outputs(self.alg, self.params, data, self._gather_states(ids),
                                   self._noise(bucket["payload"], inputs.round_idx))
            if self._stateful:
                self._scatter_states(ids[:n_real], pytree.tree_map(lambda x: x[:n_real],
                                                                    outs.state))
            w = outs.weight.float()
            swu = {k: torch.tensordot(w, u.float(), dims=([0], [0]))
                   for k, u in outs.update.items()}
            sum_wu = swu if sum_wu is None else {k: sum_wu[k] + swu[k] for k in swu}
            total_w = w.sum() if total_w is None else total_w + w.sum()
            m = outs.metrics
            ls, cs, vs = (m[k][:n_real].sum() for k in
                          ("train_loss", "train_correct", "train_valid"))
            if loss_sum is None:
                loss_sum, correct_sum, valid_sum = ls, cs, vs
            else:
                loss_sum, correct_sum, valid_sum = (
                    loss_sum + ls, correct_sum + cs, valid_sum + vs)
            n_clients += n_real
        total = torch.clamp(total_w, min=1.0)
        agg = {k: (s / total).to(self.params[k].dtype) for k, s in sum_wu.items()}
        self.params, self.server_state = self.alg.server_update(self.params, agg,
                                                                self.server_state)
        return torch.stack([loss_sum / max(n_clients, 1),
                            correct_sum / torch.clamp(valid_sum, min=1.0)])

    # --- the round loop ----------------------------------------------------

    def _should_eval(self, round_idx: int) -> bool:
        cfg = self.cfg
        return round_idx % cfg.frequency_of_the_test == 0 or round_idx == cfg.comm_round - 1

    def _should_checkpoint(self, round_idx: int) -> bool:
        cfg = self.cfg
        return ((round_idx + 1) % cfg.checkpoint_frequency == 0
                or round_idx == cfg.comm_round - 1)

    def run(self, apply_fn=None, log_fn=print) -> List[Dict[str, Any]]:
        """Run rounds up to ``comm_round`` (from the checkpoint after the
        latest saved round when ``checkpoint_dir`` holds one and ``resume``
        is set). Each record holds ``train_loss``, ``train_acc``,
        ``quarantined`` (with the sanitizer), ``round_time`` (wall seconds
        between successive round completions, a completion being the
        metrics' host readback) and at eval rounds ``test_loss`` /
        ``test_acc`` (or what the server tester returns) and, with
        ``local_test_on_all_clients``, the local-test aggregates and
        ``per_client`` vectors."""
        cfg = self.cfg
        start_round, ckpt = 0, None
        if cfg.checkpoint_dir:
            from ..utils.checkpoint import CheckpointManager, restore_simulator_state

            ckpt = CheckpointManager(cfg.checkpoint_dir)
            if cfg.resume and ckpt.latest_step() is not None:
                start_round = restore_simulator_state(ckpt, self)
                if log_fn:
                    log_fn(f"[resume] from round {start_round} @ {cfg.checkpoint_dir}")
        last_end = time.perf_counter()
        for round_idx in range(start_round, cfg.comm_round):
            inputs = self.build_round_inputs(round_idx)
            quar = None
            if inputs.kind == "packed":
                metrics_vec = self._dispatch_packed(inputs)
            elif inputs.kind == "bucketed":
                metrics_vec = self._dispatch_bucketed(inputs)
            else:
                metrics_vec, quar = self._round_step(inputs.payload, inputs.client_ids,
                                                     round_idx)
            mvec = metrics_vec.tolist()
            rec: Dict[str, Any] = {"round": round_idx, "train_loss": mvec[0],
                                   "train_acc": mvec[1]}
            if quar is not None:
                q = quar.cpu().numpy()
                rec["quarantined"] = sorted(int(inputs.client_ids[i]) for i in np.nonzero(q)[0])
            now = time.perf_counter()
            rec["round_time"] = now - last_end
            last_end = now
            self._post_round_body(rec, round_idx, apply_fn, ckpt, log_fn)
        return self.history

    def _post_round_body(self, rec, round_idx, apply_fn, ckpt, log_fn) -> None:
        """Eval (or the server tester) and the local tests, then the record,
        the checkpoint and the log line (fed_sim.py:1808)."""
        if apply_fn is not None and self._should_eval(round_idx):
            handled = False
            if self._server_tester is not None:
                res = self._server_tester.test_on_the_server(
                    self.fed.train_data_local_dict, self.fed.test_data_local_dict,
                    self.device, self._hook_args)
                if res:  # a truthy return replaces the default evaluation
                    handled = True
                    if isinstance(res, dict):
                        rec.update(res)
            if not handled:
                rec.update(self.evaluate(apply_fn))
                if self.cfg.local_test_on_all_clients:
                    rec.update(self.local_test_on_all_clients(apply_fn))
        self.history.append(rec)
        if ckpt is not None and self._should_checkpoint(round_idx):
            from ..utils.checkpoint import save_simulator_state

            save_simulator_state(ckpt, self, round_idx)
        if log_fn:
            log_fn(f"[round {round_idx}] " + " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items() if k not in ("round", "per_client")))

    # --- host-side round inputs --------------------------------------------

    def _client_perms(self, client_ids, round_idx: int):
        """Per-client local-epoch shuffles keyed by (seed, round, client id)."""
        sizes = [len(self.fed._global_index[int(c)]) for c in client_ids]
        return client_permutation_list(self.cfg.seed, round_idx, np.asarray(client_ids), sizes)

    def build_round_inputs(self, round_idx: int) -> RoundInputs:
        """Client sampling, the drop mask, per-client shuffles and the
        schedule's cohort tensors of one round, pure in (seed, round_idx)
        (fed_sim.py:1872). The drop mask is drawn first, from
        ``default_rng([seed, round])``; a round where every client drops
        keeps client 0."""
        cfg = self.cfg
        client_ids = np.asarray(sample_clients(
            cfg.seed, round_idx, cfg.client_num_in_total, cfg.client_num_per_round))
        pack_rng = np.random.default_rng([cfg.seed, round_idx])
        drop = None
        if cfg.client_dropout_rate > 0.0:
            drop = pack_rng.random(len(client_ids)) < cfg.client_dropout_rate
            if drop.all():
                drop[0] = False  # a round needs at least one survivor
        if self._packed:
            kind, payload = "packed", self._build_packed_inputs(client_ids, round_idx, drop)
        elif self._bucketed:
            kind, payload = "bucketed", self._build_bucketed_inputs(client_ids, round_idx, drop)
        else:
            kind, payload = "even", self._build_even_inputs(client_ids, round_idx, drop)
        return RoundInputs(round_idx, client_ids, drop, kind, payload)

    def _build_even_inputs(self, client_ids, round_idx: int, drop):
        """The index rectangle of the whole cohort (fed_sim.py:1920); a
        dropped client's rows get mask 0 and num_samples 0."""
        cfg = self.cfg
        perms = self._client_perms(client_ids, round_idx)
        packed = self.fed.pack_client_index(
            client_ids, cfg.batch_size, self.num_local_batches, perms)
        mask_np, samples_np = packed.mask, packed.num_samples
        if drop is not None:
            mask_np = mask_np * (~drop)[:, None, None]
            samples_np = samples_np * (~drop)
        return {"idx": packed.idx, "mask": mask_np, "num_samples": samples_np,
                "pos": np.arange(len(client_ids), dtype=np.uint32)}

    def _packed_lane_plan(self, client_ids: np.ndarray, drop):
        """Round-independent structure of a packed round (fed_sim.py:2390):
        lane assignment, the mask/boundary/bweight/pos/sic lane tensors and
        the slot -> (client, batch row) map; cached per (cohort, drop)
        pattern, at most 32 patterns (FIFO). Dropped clients are excluded
        before lane assignment; ``cohort_n`` stays the full cohort."""
        key = (client_ids.tobytes(), None if drop is None else drop.tobytes())
        plan = self._lane_plan_cache.get(key)
        if plan is not None:
            return plan
        from ..core.scheduler import lane_schedule

        cfg = self.cfg
        bs = cfg.batch_size
        epochs = int(self._packed_ctx[1].epochs)
        cohort_n = len(client_ids)
        positions = np.arange(cohort_n)
        if drop is not None:
            positions = positions[~drop]
        counts = np.asarray([
            min(self._batch_counts[int(client_ids[p])], self.num_local_batches)
            for p in positions
        ], dtype=np.int64)
        lanes, L = lane_schedule(list(counts * epochs), 1, max_lanes=len(positions),
                                 force_lanes=cfg.packed_lanes)
        L_pad = -(-L // 4) * 4  # quantized, as the JAX package's compiled shapes
        G = len(lanes)
        NB = int(counts.max()) if len(counts) else 1
        P = len(positions)
        n_samples = np.asarray([
            min(len(self.fed._global_index[int(client_ids[p])]), c * bs)
            for p, c in zip(positions, counts)
        ], dtype=np.int64)
        # row P*NB is a dedicated all-zero pad row for the padded slots
        pad_row = P * NB
        srcmap = np.full((G, L_pad), pad_row, np.int64)
        slot_m = np.zeros((G, L_pad), np.int64)  # valid samples per slot row
        boundary = np.zeros((G, L_pad), np.float32)
        bweight = np.zeros((G, L_pad), np.float32)
        pos_arr = np.zeros((G, L_pad), np.uint32)
        sic = np.zeros((G, L_pad), np.int32)
        for g, lane in enumerate(lanes):
            if not lane:
                continue
            li = np.asarray(lane, dtype=np.int64)
            cs = counts[li]
            steps = cs * epochs
            total = int(steps.sum())
            cli = np.repeat(li, steps)
            row_b = np.concatenate([np.tile(np.arange(c), epochs) for c in cs])
            srcmap[g, :total] = cli * NB + row_b
            slot_m[g, :total] = n_samples[cli]
            pos_arr[g, :total] = positions[cli].astype(np.uint32)
            sic[g, :total] = np.concatenate([np.arange(s, dtype=np.int64) for s in steps])
            ends = np.cumsum(steps) - 1
            boundary[g, ends] = 1.0
            bweight[g, ends] = n_samples[li].astype(np.float32)
        # slot row (i, b) holds min(n_i, c_i bs) - b bs valid samples, in [0, bs]
        row_start = np.where(srcmap < pad_row, srcmap % NB, 0) * bs
        mask = ((np.arange(bs, dtype=np.int64)[None, None, :] + row_start[..., None]
                 < slot_m[..., None])).astype(np.float32)
        plan = {
            "G": G, "L_pad": L_pad, "NB": NB, "cohort_n": cohort_n,
            "positions": positions, "srcmap": srcmap, "mask": mask,
            "boundary": boundary, "bweight": bweight, "pos": pos_arr, "sic": sic,
        }
        if len(self._lane_plan_cache) >= 32:
            self._lane_plan_cache.pop(next(iter(self._lane_plan_cache)))
        self._lane_plan_cache[key] = plan
        return plan

    def _build_packed_inputs(self, client_ids: np.ndarray, round_idx: int, drop):
        """Host side of the packed schedule (fed_sim.py:2478): the cached
        lane plan, one cohort-level index rectangle and one bulk row gather
        into the (G, L_pad, bs) lane index tensor."""
        bs = self.cfg.batch_size
        plan = self._packed_lane_plan(client_ids, drop)
        positions = plan["positions"]
        sel_ids = client_ids[positions]
        if len(positions):
            perms = self._client_perms(sel_ids, round_idx)
            packed = self.fed.pack_client_index(sel_ids, bs, plan["NB"], perms)
            rows = packed.idx.reshape(len(positions) * plan["NB"], bs)
        else:
            rows = np.zeros((0, bs), np.int32)
        rows = np.concatenate([rows, np.zeros((1, bs), np.int32)])  # the pad row
        return {
            "idx": pack_lane_rows(rows, plan["srcmap"]), "mask": plan["mask"],
            "boundary": plan["boundary"], "bweight": plan["bweight"], "pos": plan["pos"],
            "sic": plan["sic"], "shape": (plan["G"], plan["L_pad"]),
            "cohort_n": plan["cohort_n"],
        }

    def _build_bucketed_inputs(self, client_ids: np.ndarray, round_idx: int, drop):
        """Host side of the bucketed schedule (fed_sim.py:2580): the exact-DP
        width classes, each padded to a power-of-two slot count by
        repeating its last client with mask 0 and num_samples 0."""
        from ..core.scheduler import bucket_schedule

        cfg = self.cfg
        counts = [min(self._batch_counts[int(c)], self.num_local_batches) for c in client_ids]
        buckets = bucket_schedule(counts, 1, cfg.max_width_buckets,
                                  max_width=self.num_local_batches)
        out = []
        for positions, width in buckets:
            ids = client_ids[positions]
            n_real = len(ids)
            slots = 1 << (n_real - 1).bit_length()
            pad = slots - n_real
            if pad:
                ids = np.concatenate([ids, np.repeat(ids[-1], pad)])
                positions = np.concatenate([positions, np.repeat(positions[-1], pad)])
            perms = self._client_perms(ids, round_idx)
            packed = self.fed.pack_client_index(ids, cfg.batch_size, width, perms)
            mask_np, samples_np = packed.mask, packed.num_samples
            if pad:
                mask_np = mask_np.copy()
                samples_np = samples_np.copy()
                mask_np[n_real:] = 0
                samples_np[n_real:] = 0
            if drop is not None:
                d = drop[positions[:n_real]]
                mask_np = mask_np.copy()
                samples_np = samples_np.copy()
                mask_np[:n_real] *= (~d)[:, None, None]
                samples_np[:n_real] *= ~d
            payload = {"idx": packed.idx, "mask": mask_np, "num_samples": samples_np,
                       "pos": positions.astype(np.uint32)}
            out.append({"ids": ids, "n_real": n_real, "payload": payload})
        return out

    # --- evaluation --------------------------------------------------------

    def evaluate(self, apply_fn) -> Dict[str, float]:
        """Global test loss/accuracy over every test sample, in batches of
        EVAL_BATCH_SIZE (fed_sim.py:2708)."""
        if self._eval_fn is None:
            self._eval_fn = make_eval_fn(apply_fn)
        n = self._x_test.shape[0]
        if n == 0:
            return {}
        bs = min(EVAL_BATCH_SIZE, n)
        tot = torch.zeros(3, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            for s in range(0, n, bs):
                x, y = self._x_test[s:s + bs], self._y_test[s:s + bs]
                mask = torch.ones(x.shape[0], dtype=torch.float32, device=self.device)
                tot += torch.stack(self._eval_fn(self.params, x, y, mask))
        loss_sum, correct, count = tot.tolist()
        return {"test_loss": loss_sum / max(count, 1.0),
                "test_acc": correct / max(count, 1.0)}

    def _pad_and_batch(self, x, y, bs, sid=None):
        """Pad the tail batch with masked-out rows and reshape to
        (num_batches, bs, ...) tensors on the device (fed_sim.py:2724)."""
        n = len(x)
        n_pad = (-n) % bs
        m = np.ones(n + n_pad, np.float32)
        if n_pad:
            x = np.concatenate([x, np.zeros((n_pad,) + x.shape[1:], x.dtype)])
            y = np.concatenate([y, np.zeros((n_pad,) + y.shape[1:], y.dtype)])
            if sid is not None:
                sid = np.concatenate([sid, np.zeros(n_pad, sid.dtype)])
            m[n:] = 0.0
        dev = self.device
        out = (torch.from_numpy(x).to(dev).reshape((-1, bs) + x.shape[1:]),
               torch.from_numpy(y).to(dev).reshape((-1, bs) + y.shape[1:]),
               torch.from_numpy(m).to(dev).reshape(-1, bs))
        if sid is not None:
            out += (torch.from_numpy(sid).to(dev).reshape(-1, bs),)
        return out

    def _local_eval_batches(self, split: str):
        """Batched tensors of one split ("train" | "test") and the map
        ``rep[i]`` = the client position whose accumulator holds client i's
        stats (-1: no data), cached (fed_sim.py:2804). The train split
        batches indices into the device-resident train arrays; clients that
        share one test pair object are evaluated once, under the first
        such client's position. None when the split has no samples."""
        if split in self._local_eval_cache:
            return self._local_eval_cache[split]
        keys = sorted(self.fed._global_index)
        rep = np.full(len(keys), -1, np.int64)
        if split == "train":
            idx_l, sid_l = [], []
            for i, k in enumerate(keys):
                ix = self.fed._global_index[k]
                if len(ix) == 0:
                    continue
                rep[i] = i
                idx_l.append(np.asarray(ix, np.int32))
                sid_l.append(np.full(len(ix), i, np.int32))
            if not idx_l:
                self._local_eval_cache[split] = None
                return None
            idx, sid = np.concatenate(idx_l), np.concatenate(sid_l)
            idx_b, sid_b, m_b = self._pad_and_batch(idx, sid, min(EVAL_BATCH_SIZE, len(idx)))
            self._local_eval_cache[split] = ("gather", (idx_b, m_b, sid_b), rep)
            return self._local_eval_cache[split]
        d = self.fed.test_data_local_dict
        first_pos: Dict[int, int] = {}  # id(pair) -> representative position
        xs_l, ys_l, sid_l = [], [], []
        for i, k in enumerate(keys):
            pair = d.get(k)
            if pair is None or len(pair) == 0:
                continue
            if id(pair) in first_pos:
                rep[i] = first_pos[id(pair)]
                continue
            first_pos[id(pair)] = rep[i] = i
            xs_l.append(pair.x)
            ys_l.append(pair.y)
            sid_l.append(np.full(len(pair), i, np.int32))
        if not xs_l:
            self._local_eval_cache[split] = None
            return None
        x, y, sid = (np.concatenate(v) for v in (xs_l, ys_l, sid_l))
        xs, ys, ms, sids = self._pad_and_batch(x, y, min(EVAL_BATCH_SIZE, len(x)), sid=sid)
        self._local_eval_cache[split] = ("direct", (xs, ys, ms, sids), rep)
        return self._local_eval_cache[split]

    def _segmented_eval(self, apply_fn, kind: str, batched) -> tuple:
        """Per-client (loss, correct, valid, samples) sums over one split:
        per-sample metrics of mixed-client batches added into (C,)
        accumulators at each sample's client position with ``index_add_``
        (fed_sim.py:2755)."""
        C = self.fed.client_num
        acc = [torch.zeros(C, dtype=torch.float32, device=self.device) for _ in range(4)]
        with torch.no_grad():
            if kind == "gather":
                idxs, ms, cids = batched
                for idx, m, cid in zip(idxs, ms, cids):
                    batch = _gather_from_device({"idx": idx, "mask": m}, self._x_dev,
                                                self._y_dev)
                    self._accumulate(apply_fn, acc, batch["x"], batch["y"], m, cid)
            else:
                for x, y, m, cid in zip(*batched):
                    self._accumulate(apply_fn, acc, x, y, m, cid)
        return tuple(a.cpu().numpy() for a in acc)

    def _accumulate(self, apply_fn, acc, x, y, m, cid) -> None:
        lv, cv, vv = per_sample_metrics(apply_fn(self.params, x), y, m)
        cid = cid.long()
        for a, v in zip(acc, (lv, cv.float(), vv, m)):
            a.index_add_(0, cid, v)

    def local_test_on_all_clients(self, apply_fn) -> Dict[str, Any]:
        """The reference's ``_local_test_on_all_clients``
        (fed_sim.py:2865): the current global parameters on every client's
        local train and test split; the aggregates over clients that have
        test data, and ``per_client`` vectors."""
        keys = sorted(self.fed._global_index)
        test_local = self.fed.test_data_local_dict
        include = np.array([test_local.get(k) is not None and len(test_local[k]) > 0
                            for k in keys])
        out: Dict[str, Any] = {}
        per_client: Dict[str, List[float]] = {}
        for split, agg_prefix in (("train", "local_train"), ("test", "local_test")):
            cached = self._local_eval_batches(split)
            if cached is None:
                continue
            kind, batched, rep = cached
            L, K, N, S = self._segmented_eval(apply_fn, kind, batched)
            # fan the representatives' sums out to their group
            has = rep >= 0
            r = np.where(has, rep, 0)
            L, K, N, S = (np.where(has, v[r], 0.0) for v in (L, K, N, S))
            n_safe = np.maximum(N, 1.0)
            per_client[f"{split}_loss"] = (L / n_safe).tolist()
            per_client[f"{split}_acc"] = (K / n_safe).tolist()
            per_client[f"{split}_samples"] = S.tolist()
            inc = include & (N > 0)
            denom = max(float(N[inc].sum()), 1.0)
            out[f"{agg_prefix}_loss"] = float(L[inc].sum()) / denom
            out[f"{agg_prefix}_acc"] = float(K[inc].sum()) / denom
        out["per_client"] = per_client
        return out
