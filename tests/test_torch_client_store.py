"""The port's client-state arena (``fedml_tpu_torch/simulation/
client_store.py``) against the JAX package's and against the port's own
``dict`` backend.

- the same seeded sequence of gathers, scatters, fused put_takes, discards
  and LRU spills (capacity below the population) through both arenas:
  every gathered stack, every client's row, the slot map, the LRU clock
  and the tier counts equal after every operation (exact: the arenas only
  move values);
- a SCAFFOLD run with the arena (capacity below the population, so rows
  spill and come back) bit-equal to the same run with the dict backend;
- an export of the JAX arena imported into the port's;
- the refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu_torch
from fedml_tpu.simulation.client_store import ClientStateArena as JArena
from fedml_tpu_torch.simulation import build_simulator
from fedml_tpu_torch.simulation.client_store import ClientStateArena, cohort_local_update
from fedml_tpu_torch.utils.convert import arena_state_from_jax, state_from_jax

SHAPES = {"a": (3, 2), "b": (4,)}


def _protos():
    jproto = ({"params": {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}},
              {"params": {k: np.full(s, 0.5, np.float32) for k, s in SHAPES.items()}})
    return jax.tree_util.tree_map(jnp.asarray, jproto), state_from_jax(jproto)


def _rows(rng, n):
    r = ({"params": {k: rng.standard_normal((n,) + s).astype(np.float32)
                     for k, s in SHAPES.items()}},
         {"params": {k: rng.standard_normal((n,) + s).astype(np.float32)
                     for k, s in SHAPES.items()}})
    return jax.tree_util.tree_map(jnp.asarray, r), state_from_jax(r)


def _same(tstack, jstack, what):
    jt = state_from_jax(jax.tree_util.tree_map(np.asarray, jstack))
    ta, tb = torch.utils._pytree.tree_flatten(tstack), torch.utils._pytree.tree_flatten(jt)
    assert ta[1] == tb[1], what
    for a, b in zip(ta[0], tb[0]):
        assert torch.equal(a, b), what


def _check(ta, ja, population, what):
    assert ta.resident_count == ja.resident_count, what
    assert ta.spilled_count == ja.spilled_count, what
    te, je = ta.export_state(), ja.export_state()
    for k in ("slot_client", "last_used"):
        np.testing.assert_array_equal(te[k].numpy(), je[k], err_msg=f"{what} {k}")
    assert int(te["clock"]) == int(je["clock"]), what
    for cid in range(population):
        _same(ta.state_of(cid), ja.state_of(cid), (what, cid))


@pytest.mark.parametrize("seed", range(3))
def test_arena_matches_jax_arena_op_by_op(seed):
    rng = np.random.default_rng(seed)
    population, capacity = 10, 4
    jproto, tproto = _protos()
    ja, ta = JArena(jproto, capacity), ClientStateArena(tproto, capacity)
    cohort = None
    for op in range(40):
        kind = rng.choice(["gather", "scatter", "put_take", "discard"], p=[.4, .3, .2, .1])
        if kind == "gather" or cohort is None:
            cohort = rng.choice(population, size=3, replace=False)
            ids = np.concatenate([cohort, cohort[-1:]])  # a padded slot re-gathers
            _same(ta.gather(ids), ja.gather(ids), (op, "gather"))
        elif kind == "scatter":
            jr, tr = _rows(rng, len(cohort))
            ja.scatter(cohort, jr)
            ta.scatter(cohort, tr)
        elif kind == "put_take":
            jr, tr = _rows(rng, len(cohort))
            nxt = rng.choice(population, size=3, replace=False)
            jout, tout = ja.put_take(cohort, jr, nxt), ta.put_take(cohort, tr, nxt)
            assert (jout is None) == (tout is None), op
            if tout is not None:
                _same(tout, jout, (op, "put_take"))
                cohort = nxt
            else:  # the fallback: scatter now, gather later
                ja.scatter(cohort, jr)
                ta.scatter(cohort, tr)
        else:
            gone = rng.choice(population, size=2, replace=False)
            assert ta.discard(gone) == ja.discard(gone) == 0
            cohort = None
        _check(ta, ja, population, (op, kind))
    assert ta.spilled_count > 0 or ta.resident_count == capacity


def test_never_scattered_client_reads_the_proto():
    jproto, tproto = _protos()
    ta = ClientStateArena(tproto, 2)
    _same(ta.state_of(7), jproto, "proto")
    stacked = ta.gather([7, 8])
    assert torch.equal(stacked[1]["params/a"][0], torch.full((3, 2), 0.5))
    assert ta.nbytes == 2 * 2 * (6 + 4) * 4


def test_import_of_a_jax_export_equals_the_jax_arena():
    """Spilled rows included: capacity 3, eight clients written."""
    rng = np.random.default_rng(4)
    jproto, tproto = _protos()
    ja = JArena(jproto, 3)
    for _ in range(4):
        ids = rng.choice(8, size=2, replace=False)
        ja.gather(ids)
        ja.scatter(ids, _rows(rng, 2)[0])
    assert ja.spilled_count > 0
    ta = ClientStateArena(tproto, 3)
    ta.import_state(arena_state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                ja.export_state())))
    _check(ta, ja, 8, "import")
    with pytest.raises(ValueError, match="capacity"):
        ClientStateArena(tproto, 4).import_state(ta.export_state())


SCAFFOLD = dict(dataset="cifar10", model="lr", partition_method="hetero", partition_alpha=0.3,
                debug_small_data=True, client_num_in_total=12, client_num_per_round=6,
                comm_round=4, learning_rate=0.05, epochs=1, batch_size=16,
                frequency_of_the_test=4, random_seed=0, federated_optimizer="SCAFFOLD",
                device="cpu")


def test_scaffold_arena_equals_dict_backend():
    """Capacity 7 of 12 clients: rows spill to the host and come back, and
    the run is bit-equal to the dict backend's (parameters, server control
    variate, every client's (c, c_i))."""
    runs = {}
    for backend, cap in (("arena", 7), ("dict", None)):
        sim, apply_fn = build_simulator(fedml_tpu_torch.init(config=dict(
            SCAFFOLD, client_state_backend=backend, client_state_capacity=cap)))
        hist = sim.run(apply_fn, log_fn=None)
        runs[backend] = (sim, hist)
    (asim, ah), (dsim, dh) = runs["arena"], runs["dict"]
    assert asim._arena is not None and dsim._arena is None
    assert asim._arena.spilled_count > 0 and asim._arena.resident_count == 7
    assert [r["train_loss"] for r in ah] == [r["train_loss"] for r in dh]
    for k, v in dsim.params.items():
        assert torch.equal(asim.params[k], v), k
    for k, v in dsim.server_state["c"].items():
        assert torch.equal(asim.server_state["c"][k], v), k
    for cid in range(12):
        want = dsim.client_states.get(cid, dsim._client_state_proto)
        got = asim._arena.state_of(cid)
        for a, b in zip(torch.utils._pytree.tree_leaves(got),
                        torch.utils._pytree.tree_leaves(want)):
            assert torch.equal(a, b), cid


def test_cohort_local_update_maps_state_and_rng_only_when_present():
    def lu(params, state, data, rng):
        out = params["w"] * data["x"]
        if state != ():
            out = out + state["s"]
        if rng is not None:
            out = out + rng
        return out

    p, x = {"w": torch.tensor(2.0)}, {"x": torch.arange(3.0)}
    assert torch.equal(cohort_local_update(lu, p, (), x, None), torch.arange(3.0) * 2)
    got = cohort_local_update(lu, p, {"s": torch.ones(3)}, x, torch.full((3,), 10.0))
    assert torch.equal(got, torch.arange(3.0) * 2 + 11)


def test_arena_refusals():
    _, tproto = _protos()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ClientStateArena(tproto, 2, spill_dir="spill")
    ta = ClientStateArena(tproto, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ta.snapshot()
    with pytest.raises(ValueError, match="raise client_state_capacity"):
        ta.gather([0, 1, 2])
    ta.gather([0, 1])
    with pytest.raises(ValueError, match="unique"):
        ta.scatter([0, 0], ta.gather([0, 0]))
    with pytest.raises(KeyError, match="non-resident"):
        ta.scatter([5], ta.gather([0]))
    with pytest.raises(ValueError, match="client_state_capacity"):
        build_simulator(fedml_tpu_torch.init(config=dict(SCAFFOLD, client_state_capacity=3)))
    with pytest.raises(ValueError, match="no leaves"):
        ClientStateArena((), 2)
