"""The port's checkpoint/resume (``fedml_tpu_torch/utils/checkpoint.py``):
the manager's file discipline, and a run interrupted and resumed from its
checkpoint equal, bit for bit, to the uninterrupted run: FedAvg under
packed and even, SCAFFOLD with the client-state arena (spilled rows
included) and with the dict backend, FedOpt with a server adam and weak
DP with its generator."""

import os

import numpy as np
import pytest
import torch

import fedml_tpu_torch
from fedml_tpu_torch.simulation import build_simulator
from fedml_tpu_torch.utils.checkpoint import CheckpointManager

CFG = dict(dataset="cifar10", model="lr", partition_method="hetero", partition_alpha=0.3,
           debug_small_data=True, client_num_in_total=12, client_num_per_round=6,
           comm_round=4, learning_rate=0.05, epochs=1, batch_size=16,
           frequency_of_the_test=2, random_seed=0, device="cpu")


def test_manager_keeps_the_latest_steps(tmp_path):
    ck = CheckpointManager(str(tmp_path / "ck"), max_to_keep=3)
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore()
    for step in range(5):
        ck.save(step, {"params": {"w": torch.full((2,), float(step))}, "round": step})
    assert ck.steps() == [2, 3, 4] and ck.latest_step() == 4
    assert sorted(os.listdir(ck.directory)) == ["step_2.pt", "step_3.pt", "step_4.pt"]
    state = ck.restore()
    assert state["round"] == 4 and torch.equal(state["params"]["w"], torch.full((2,), 4.0))
    assert ck.restore(2)["round"] == 2
    with pytest.raises(FileNotFoundError):
        ck.restore(0)


def _run(tmp_path=None, **kw):
    cfg = dict(CFG, **kw)
    if tmp_path is not None:
        cfg["checkpoint_dir"] = str(tmp_path)
    sim, apply_fn = build_simulator(fedml_tpu_torch.init(config=cfg))
    hist = sim.run(apply_fn, log_fn=None)
    return sim, hist


_KEYS = ("round", "train_loss", "train_acc", "test_loss", "test_acc")


@pytest.mark.parametrize("schedule", ["packed", "even"])
def test_interrupted_then_resumed_equals_uninterrupted(tmp_path, schedule):
    """Two rounds with a checkpoint after each, then a fresh simulator that
    resumes to round 4: every round's metrics and the final parameters are
    bit-equal to four uninterrupted rounds (sampling, shuffles and plans
    are pure in (seed, round), and the checkpoint holds the exact
    parameters)."""
    full_sim, full = _run(cohort_schedule=schedule)
    _, first = _run(tmp_path, cohort_schedule=schedule, comm_round=2, checkpoint_frequency=1)
    assert CheckpointManager(str(tmp_path)).steps() == [0, 1]
    sim, second = _run(tmp_path, cohort_schedule=schedule, checkpoint_frequency=1)
    assert sim.schedule == schedule
    assert [r["round"] for r in second] == [2, 3]
    resumed = first + second
    assert len(resumed) == len(full)
    for a, b in zip(resumed, full):
        # the 2-round run also evaluates its last round, round 1
        keys = [k for k in _KEYS if k in a and k in b]
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
        assert "train_loss" in keys and ("test_loss" in keys) == (a["round"] != 1)
    for k, v in full_sim.params.items():
        assert torch.equal(sim.params[k], v), k
    assert CheckpointManager(str(tmp_path)).steps() == [1, 2, 3]


def test_resume_false_starts_over_and_the_last_round_is_saved(tmp_path):
    """``resume: false`` ignores the directory's checkpoints; the last
    round is saved whatever the frequency."""
    _run(tmp_path, comm_round=2, checkpoint_frequency=10)
    assert CheckpointManager(str(tmp_path)).steps() == [1]
    sim, hist = _run(tmp_path, comm_round=3, checkpoint_frequency=10, resume=False)
    assert [r["round"] for r in hist] == [0, 1, 2]
    ck = CheckpointManager(str(tmp_path))
    assert ck.steps() == [1, 2]
    saved = ck.restore()
    # FedAvg keeps no server or client state
    assert saved["round"] == 2 and saved["server_state"] == () and saved["client_states"] == {}
    assert "client_arena" not in saved
    for k, v in sim.params.items():
        assert saved["params"][k].device.type == "cpu" and torch.equal(saved["params"][k], v)
    assert np.isfinite(hist[-1]["test_loss"])


@pytest.mark.parametrize("kw", [
    dict(federated_optimizer="SCAFFOLD", client_state_capacity=7),
    dict(federated_optimizer="SCAFFOLD", client_state_backend="dict"),
    dict(federated_optimizer="FedOpt", server_optimizer="adam", server_lr=0.05,
         cohort_schedule="packed", client_optimizer="adam"),
    dict(federated_optimizer="FedAvg_robust", defense_type="weak_dp", stddev=0.01)],
    ids=["scaffold_arena", "scaffold_dict", "fedopt_adam", "weak_dp"])
def test_stateful_resume_equals_uninterrupted(tmp_path, kw):
    """The server state (the control variate, adam's moments and count,
    the weak-DP generator) and the client states (the arena's device
    slots, slot map, LRU clock and spilled host rows; or the dict) come
    back from the file: rounds 2-3 and the final state are bit-equal."""
    full_sim, full = _run(**kw)
    _run(tmp_path, comm_round=2, checkpoint_frequency=1, **kw)
    saved = CheckpointManager(str(tmp_path)).restore()
    if full_sim._arena is not None:
        assert "spilled" in saved["client_arena"]  # 7 slots for 12 clients
    sim, second = _run(tmp_path, checkpoint_frequency=1, **kw)
    assert [r["round"] for r in second] == [2, 3]
    for a, b in zip(second, full[2:]):
        assert {k: a[k] for k in _KEYS if k in a} == {k: b[k] for k in _KEYS if k in b}
    for k, v in full_sim.params.items():
        assert torch.equal(sim.params[k], v), k
    sa, sb = (torch.utils._pytree.tree_leaves(s.server_state) for s in (sim, full_sim))
    assert len(sa) == len(sb) and all(torch.equal(a, b) for a, b in zip(sa, sb))
    if full_sim._arena is not None:
        for cid in range(CFG["client_num_in_total"]):
            for a, b in zip(torch.utils._pytree.tree_leaves(sim._arena.state_of(cid)),
                            torch.utils._pytree.tree_leaves(full_sim._arena.state_of(cid))):
                assert torch.equal(a, b), cid
    else:
        assert sim.client_states.keys() == full_sim.client_states.keys()
