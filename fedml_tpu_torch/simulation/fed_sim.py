"""The federated simulator, single device (port of
``fedml_tpu/simulation/fed_sim.py`` on its even-schedule, one-round-per-
dispatch path without a mesh).

One round (``_round_step``, the counterpart of ``_make_round_body``:702):

1. gather the cohort's batches by index from the training set, which lives
   on the device (``_gather_from_device``);
2. local training of the whole cohort at once: ``torch.func.vmap`` of the
   algorithm's ``local_update`` gives the updates stacked ``(C, *leaf)``;
3. codec roundtrip (q8/q4 through the fused CUDA kernel);
4. sanitizer + defense: with ``agg_kernels`` and a Krum-family defense the
   two collapse into ``core.robust.fused_sanitize_krum`` (Gram kernel);
5. aggregate and server update.

Host-side packing (sampling, shuffles, index rectangles) is a pure function
of (seed, round), bit-identical to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.func import vmap

from ..algorithms.local_sgd import make_eval_fn
from ..core.algframe import FedAlgorithm, weighted_mean
from ..data.federated import FederatedData
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
    # "even" | "auto"; packed/bucketed schedules are not ported
    cohort_schedule: str = "auto"
    # fuse sanitize + Krum into one pass (core.robust.fused_sanitize_krum)
    agg_kernels: bool = False
    sanitize_updates: bool = False
    sanitize_z_thresh: float = 6.0
    # codec spec (comm/codec.py grammar) applied to every client's update
    comm_codec: Optional[str] = None


@dataclasses.dataclass
class RoundInputs:
    """One round's host-built cohort tensors (numpy)."""

    round_idx: int
    client_ids: np.ndarray
    payload: Dict[str, np.ndarray]


def _gather_from_device(data: Dict[str, Any], x_all, y_all) -> Dict[str, Any]:
    """Replace the cohort's index rectangle with x/y gathered from the
    device-resident global arrays; padded rows (index 0) are zeroed."""
    idx = data.pop("idx")
    m = data["mask"]

    def _masked(gathered):
        mb = m.reshape(m.shape + (1,) * (gathered.dim() - m.dim()))
        return gathered * mb.to(gathered.dtype)

    data["x"] = _masked(x_all[idx])
    data["y"] = _masked(y_all[idx])
    return data


def _cohort_outputs(alg: FedAlgorithm, params, cohort):
    """The cohort's local updates, stacked along a leading client axis."""
    return vmap(alg.local_update, in_dims=(None, 0))(params, cohort)


class FedSimulator:
    """Round loop over a FedAlgorithm on one device."""

    def __init__(self, fed_data: FederatedData, algorithm: FedAlgorithm,
                 init_variables: Dict[str, torch.Tensor], cfg: SimConfig,
                 device: torch.device):
        self.fed = fed_data
        self.alg = algorithm
        self.cfg = cfg
        self.device = device
        self.params = {k: v.to(device) for k, v in init_variables.items()}
        self.history: List[Dict[str, Any]] = []
        self._eval_fn = None

        sizes = [len(v) for v in fed_data._global_index.values()]
        # every client padded to the largest client's batch count
        self.num_local_batches = max(1, -(-max(sizes) // cfg.batch_size))
        train, test = fed_data.train_data_global, fed_data.test_data_global
        self._x_dev = torch.from_numpy(np.ascontiguousarray(train.x)).to(device)
        self._y_dev = torch.from_numpy(np.ascontiguousarray(train.y)).to(device)
        self._x_test = torch.from_numpy(np.ascontiguousarray(test.x)).to(device)
        self._y_test = torch.from_numpy(np.ascontiguousarray(test.y)).to(device)

        self._detect = bool(cfg.sanitize_updates)
        self._codec_rt = None
        if cfg.comm_codec:
            from ..comm import codec as wire_codec

            self._codec_rt = wire_codec.build_stacked_roundtrip(cfg.comm_codec, cfg.seed)
        schedule = cfg.cohort_schedule
        if schedule == "auto":
            # as fed_sim.py: the sanitizer and the codec need the full
            # stacked cohort and force the even schedule; otherwise a skewed
            # population would pick packed/bucketed
            counts = np.asarray([max(1, -(-n // cfg.batch_size)) for n in sizes])
            skewed = counts.max() >= 2 * max(np.median(counts), 1)
            force_even = self._detect or self._codec_rt is not None
            schedule = "even" if force_even or not skewed else "packed/bucketed"
        if schedule != "even":
            raise NotImplementedError(
                f"cohort_schedule '{schedule}' is not ported yet (ROADMAP.md Queue 1, "
                "item 4); use 'even', or 'auto' with the sanitizer or a codec on")
        robust = algorithm.robust
        self._fuse_robust = bool(
            cfg.agg_kernels and self._detect and robust is not None
            and robust.defense_type in type(robust).KRUM_FAMILY)

    # --- the round ---------------------------------------------------------

    def _round_step(self, payload: Dict[str, np.ndarray], client_ids: np.ndarray,
                    round_idx: int):
        dev = self.device
        cohort = {k: torch.from_numpy(v).to(dev) for k, v in payload.items()}
        data = _gather_from_device(cohort, self._x_dev, self._y_dev)
        outs = _cohort_outputs(self.alg, self.params, data)
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
        self.params = self.alg.server_update(self.params, agg)
        m = outs.metrics
        metrics_vec = torch.stack([
            m["train_loss"].mean(),
            m["train_correct"].sum() / torch.clamp(m["train_valid"].sum(), min=1.0),
        ])
        return metrics_vec, quar

    def run(self, apply_fn=None, log_fn=print) -> List[Dict[str, Any]]:
        """Run ``comm_round`` rounds; evaluate every ``frequency_of_the_test``
        rounds and at the last. Each record holds ``train_loss``,
        ``train_acc``, ``quarantined`` (with the sanitizer), ``test_loss`` /
        ``test_acc`` (eval rounds) and ``round_time``: wall seconds between
        successive round completions, a completion being the metrics' host
        readback."""
        cfg = self.cfg
        last_end = time.perf_counter()
        for round_idx in range(cfg.comm_round):
            inputs = self.build_round_inputs(round_idx)
            metrics_vec, quar = self._round_step(inputs.payload, inputs.client_ids, round_idx)
            mvec = metrics_vec.tolist()
            rec: Dict[str, Any] = {"round": round_idx, "train_loss": mvec[0],
                                   "train_acc": mvec[1]}
            if quar is not None:
                q = quar.cpu().numpy()
                rec["quarantined"] = sorted(int(inputs.client_ids[i]) for i in np.nonzero(q)[0])
            now = time.perf_counter()
            rec["round_time"] = now - last_end
            if apply_fn is not None and (round_idx % cfg.frequency_of_the_test == 0
                                         or round_idx == cfg.comm_round - 1):
                rec.update(self.evaluate(apply_fn))
            last_end = now
            self.history.append(rec)
            if log_fn:
                log_fn(f"[round {round_idx}] " + " ".join(
                    f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in rec.items() if k != "round"))
        return self.history

    # --- host-side round inputs --------------------------------------------

    def build_round_inputs(self, round_idx: int) -> RoundInputs:
        """Client sampling, per-client shuffles and the index rectangle of
        one round, pure in (seed, round_idx) (fed_sim.py:1872, :1920)."""
        cfg = self.cfg
        client_ids = np.asarray(sample_clients(
            cfg.seed, round_idx, cfg.client_num_in_total, cfg.client_num_per_round))
        sizes = [len(self.fed._global_index[int(c)]) for c in client_ids]
        perms = client_permutation_list(cfg.seed, round_idx, client_ids, sizes)
        packed = self.fed.pack_client_index(
            client_ids, cfg.batch_size, self.num_local_batches, perms)
        payload = {"idx": packed.idx.astype(np.int64), "mask": packed.mask,
                   "num_samples": packed.num_samples}
        return RoundInputs(round_idx, client_ids, payload)

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
