"""The port's checkpoint/resume (``fedml_tpu_torch/utils/checkpoint.py``):
the manager's file discipline, and a run interrupted and resumed from its
checkpoint equal, bit for bit, to the uninterrupted run."""

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
    assert saved["round"] == 2 and saved["server_state"] == {} and saved["client_states"] == {}
    for k, v in sim.params.items():
        assert saved["params"][k].device.type == "cpu" and torch.equal(saved["params"][k], v)
    assert np.isfinite(hist[-1]["test_loss"])
