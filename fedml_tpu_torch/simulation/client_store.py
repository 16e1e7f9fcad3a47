"""Per-client state storage and the shared cohort vmap (port of
``fedml_tpu/simulation/client_store.py``).

:func:`cohort_local_update`
    The one ``torch.func.vmap`` that runs ``local_update`` across a stacked
    cohort: params shared, client state and randomness stacked.

:class:`ClientStateArena`
    Per-client algorithm state as stacked tensors in a fixed-capacity
    device arena: one ``(capacity, ...)`` tensor per state leaf and a host
    ``client_id -> slot`` map, so a cohort gather is one index op per leaf
    (``leaf[slots]``) and a scatter one ``index_copy_`` per leaf; no
    per-client Python loop touches a device tensor. When more clients are
    registered than ``capacity`` slots, the least recently used rows spill
    to host RAM (CPU tensors) and come back on their next gather. A client
    never scattered reads back the prototype state (what
    ``init_client_state`` produced), as the dict path's absent key does.

The JAX arena's disk tier (``spill_dir``) and the watchdog's
``snapshot`` / ``restore`` are not ported (ROADMAP.md Queue 1, item 8).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.func import vmap
from torch.utils import _pytree as pytree

from ..core.algframe import has_leaves


def cohort_local_update(local_update, params, client_states, cohort, rngs,
                        *, params_axis=None, state_axis=0):
    """``local_update`` vmapped over the cohort's leading axis. ``cohort``
    carries the axis; ``client_states`` and ``rngs`` carry it when they
    hold tensors (a stateless algorithm's ``()``, no noise's None do not);
    ``params_axis`` / ``state_axis`` say whether params and state are
    shared (None) or stacked (0)."""
    in_dims = (params_axis, state_axis if has_leaves(client_states) else None, 0,
               0 if rngs is not None else None)
    return vmap(local_update, in_dims=in_dims)(params, client_states, cohort, rngs)


class ClientStateArena:
    """Fixed-capacity stacked client-state store with an LRU host spill
    tier. ``proto`` is one client's state (any nesting of dicts and tuples
    of tensors); the arena lives on ``device`` (default: the proto's)."""

    def __init__(self, proto: Any, capacity: int, *, spill_dir: Optional[str] = None,
                 device=None):
        leaves, spec = pytree.tree_flatten(proto)
        if not leaves:
            raise ValueError("client-state proto has no leaves; the arena "
                             "is only built for stateful algorithms")
        if capacity <= 0:
            raise ValueError(f"client_state_capacity must be > 0, got {capacity}")
        if spill_dir is not None:
            raise NotImplementedError(
                "the arena's disk spill tier (client_state_spill_dir) is not ported yet "
                "(ROADMAP.md Queue 1, item 8); rows beyond capacity spill to host RAM")
        self._spec = spec
        self._proto_rows: List[torch.Tensor] = [l.detach().cpu() for l in leaves]
        self.device = torch.device(device) if device is not None else leaves[0].device
        self.capacity = int(capacity)
        self._slot_of: Dict[int, int] = {}
        self._slot_client = np.full(self.capacity, -1, dtype=np.int64)
        self._last_used = np.zeros(self.capacity, dtype=np.int64)
        self._clock = 0
        self._spilled: "OrderedDict[int, List[torch.Tensor]]" = OrderedDict()
        self._leaves = [torch.zeros((self.capacity,) + tuple(p.shape), dtype=p.dtype,
                                    device=self.device) for p in self._proto_rows]

    # ------------------------------------------------------------- public

    @property
    def nbytes(self) -> int:
        """Bytes of the device tier."""
        return sum(l.numel() * l.element_size() for l in self._leaves)

    def gather(self, client_ids: Sequence[int]) -> Any:
        """Stacked states for ``client_ids`` (duplicates allowed): one
        index op per leaf, loading and evicting around it as needed."""
        slots = self._ensure(np.asarray(client_ids, dtype=np.int64))
        return self._take(slots)

    def scatter(self, client_ids: Sequence[int], stacked: Any) -> None:
        """Write stacked rows back for ``client_ids`` (unique and resident,
        i.e. gathered this round): one ``index_copy_`` per leaf."""
        slots = self._put_slots(client_ids, stacked, "scatter")
        self._put(slots, stacked)
        self._clock += 1
        self._last_used[slots] = self._clock

    def put_take(self, put_ids: Sequence[int], stacked: Any,
                 take_ids: Sequence[int]) -> Optional[Any]:
        """``scatter(put_ids, stacked)`` then ``gather(take_ids)``, the
        gather reading the scattered rows. Returns None, with the arena
        untouched, when ``take_ids`` cannot be made resident without
        evicting a ``put_ids`` client."""
        put_slots = self._put_slots(put_ids, stacked, "put_take")
        take_slots = self._ensure(np.asarray(take_ids, dtype=np.int64),
                                  protect=frozenset(int(c) for c in np.asarray(put_ids)))
        if take_slots is None:
            return None
        self._put(put_slots, stacked)
        out = self._take(take_slots)
        self._clock += 1
        self._last_used[put_slots] = self._clock
        return out

    def state_of(self, client_id: int) -> Any:
        """One client's current state as CPU tensors (a test and debug
        helper: the slow per-client path the arena exists to avoid)."""
        cid = int(client_id)
        if cid in self._slot_of:
            s = self._slot_of[cid]
            row = [l[s].detach().cpu() for l in self._leaves]
        elif cid in self._spilled:
            row = self._spilled[cid]
        else:
            row = self._proto_rows
        return pytree.tree_unflatten([r.clone() for r in row], self._spec)

    @property
    def resident_count(self) -> int:
        return len(self._slot_of)

    @property
    def spilled_count(self) -> int:
        return len(self._spilled)

    def discard(self, client_ids: Sequence[int]) -> int:
        """Forget clients in every tier. Returns the number of spill files
        deleted (always 0: the disk tier is not ported)."""
        for cid in sorted({int(c) for c in client_ids}):
            slot = self._slot_of.pop(cid, None)
            if slot is not None:
                self._slot_client[slot] = -1
            self._spilled.pop(cid, None)
        return 0

    def snapshot(self):
        raise NotImplementedError(
            "the divergence watchdog's arena snapshot is not ported yet (ROADMAP.md Queue 1, "
            "item 8)")

    def restore(self, snap) -> None:
        raise NotImplementedError(
            "the divergence watchdog's arena restore is not ported yet (ROADMAP.md Queue 1, "
            "item 8)")

    # ------------------------------------------------- checkpoint support

    def export_state(self) -> dict:
        """The arena as CPU tensors, leaves keyed by flat index (the JAX
        arena's export layout): device leaves, slot map, LRU clock, and the
        host tier under ``spilled``."""
        state = {
            "leaves": {str(i): l.detach().cpu() for i, l in enumerate(self._leaves)},
            "slot_client": torch.from_numpy(self._slot_client.copy()),
            "last_used": torch.from_numpy(self._last_used.copy()),
            "clock": torch.tensor(self._clock, dtype=torch.int64),
        }
        if self._spilled:
            state["spilled"] = {str(cid): {str(i): r for i, r in enumerate(rows)}
                                for cid, rows in self._spilled.items()}
        return state

    def import_state(self, state: dict) -> None:
        n = len(self._proto_rows)
        leaves = [torch.as_tensor(state["leaves"][str(i)]) for i in range(n)]
        if leaves[0].shape[0] != self.capacity:
            raise ValueError(
                f"checkpointed arena capacity {leaves[0].shape[0]} != configured "
                f"{self.capacity}; restore with the client_state_capacity it was saved with")
        self._leaves = [l.to(self.device, dtype=p.dtype).clone()
                        for l, p in zip(leaves, self._proto_rows)]
        self._slot_client = np.asarray(state["slot_client"], np.int64).copy()
        self._last_used = np.asarray(state["last_used"], np.int64).copy()
        self._clock = int(np.asarray(state["clock"]))
        self._slot_of = {int(c): int(s) for s, c in enumerate(self._slot_client) if c >= 0}
        self._spilled = OrderedDict()
        for cid in sorted(state.get("spilled") or {}, key=int):
            entry = state["spilled"][cid]
            self._spilled[int(cid)] = [torch.as_tensor(entry[str(i)]).clone() for i in range(n)]

    def preload(self, client_id: int, state_tree: Any) -> None:
        """Seed one client's state into the host tier (a dict-backend
        checkpoint feeding an arena-backed run)."""
        rows = [torch.as_tensor(l).detach().cpu() for l in pytree.tree_leaves(state_tree)]
        if len(rows) != len(self._proto_rows):
            raise ValueError("preloaded state leaf count != arena proto")
        self._spilled[int(client_id)] = rows
        self._spilled.move_to_end(int(client_id))

    # ------------------------------------------------------------ internal

    def _slots_tensor(self, slots: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(slots, np.int64)).to(self.device)

    def _take(self, slots: np.ndarray) -> Any:
        idx = self._slots_tensor(slots)
        return pytree.tree_unflatten([l[idx] for l in self._leaves], self._spec)

    def _put_slots(self, client_ids, stacked, what: str) -> np.ndarray:
        ids = np.asarray(client_ids, dtype=np.int64)
        if len(np.unique(ids)) != len(ids):
            raise ValueError(f"{what} ids must be unique (slice padding duplicates off "
                             "before scattering)")
        if pytree.tree_structure(stacked) != self._spec:
            raise ValueError(f"{what} structure {pytree.tree_structure(stacked)} != arena "
                             f"proto {self._spec}")
        try:
            return np.asarray([self._slot_of[int(c)] for c in ids], np.int64)
        except KeyError as e:
            raise KeyError(f"{what} of non-resident client {e}; gather the cohort before "
                           "scattering it") from e

    def _put(self, slots: np.ndarray, stacked: Any) -> None:
        idx = self._slots_tensor(slots)
        for leaf, rows in zip(self._leaves, pytree.tree_leaves(stacked)):
            leaf.index_copy_(0, idx, rows.to(leaf.device, leaf.dtype))

    def _ensure(self, ids: np.ndarray, protect: Optional[frozenset] = None
                ) -> Optional[np.ndarray]:
        """Make every id resident; return their slots (aligned to ids). With
        ``protect``, return None without touching the arena when residency
        would evict a protected client (``client_store.py:414``)."""
        uniq, first = np.unique(ids, return_index=True)
        uniq = uniq[np.argsort(first)]
        if len(uniq) > self.capacity:
            raise ValueError(
                f"cohort has {len(uniq)} unique clients but the arena holds "
                f"{self.capacity} slots; raise client_state_capacity")
        missing = [int(c) for c in uniq if int(c) not in self._slot_of]
        if missing:
            free = np.nonzero(self._slot_client < 0)[0]
            need = len(missing) - len(free)
            if need > 0:
                in_cohort = {int(c) for c in uniq}
                if protect:
                    in_cohort = in_cohort | set(protect)
                cand = [int(s) for s in np.nonzero(self._slot_client >= 0)[0]
                        if int(self._slot_client[s]) not in in_cohort]
                if protect is not None and len(cand) < need:
                    return None
                cand.sort(key=lambda s: (self._last_used[s], s))
                self._evict(np.asarray(cand[:need], np.int64))
                free = np.nonzero(self._slot_client < 0)[0]
            self._load(missing, free[:len(missing)])
        self._clock += 1
        slots_uniq = np.asarray([self._slot_of[int(c)] for c in uniq], np.int64)
        self._last_used[slots_uniq] = self._clock
        return np.asarray([self._slot_of[int(c)] for c in ids], np.int64)

    def _evict(self, victim_slots: np.ndarray) -> None:
        """Spill LRU victims to the host tier with one index op per leaf."""
        idx = self._slots_tensor(victim_slots)
        host = [l[idx].cpu() for l in self._leaves]
        for j, s in enumerate(victim_slots):
            cid = int(self._slot_client[s])
            self._spilled[cid] = [h[j].clone() for h in host]
            self._spilled.move_to_end(cid)
            del self._slot_of[cid]
            self._slot_client[s] = -1

    def _load(self, client_ids: List[int], slots: np.ndarray) -> None:
        """Fill ``slots`` with spilled or prototype rows, one
        ``index_copy_`` per leaf."""
        rows = []
        for cid in client_ids:
            r = self._spilled.pop(cid, None)
            rows.append(self._proto_rows if r is None else r)
        stacked = [torch.stack([r[i] for r in rows]) for i in range(len(self._proto_rows))]
        idx = self._slots_tensor(slots[:len(client_ids)])
        for leaf, st in zip(self._leaves, stacked):
            leaf.index_copy_(0, idx, st.to(leaf.device, leaf.dtype))
        for cid, s in zip(client_ids, slots):
            self._slot_of[cid] = int(s)
            self._slot_client[s] = cid
