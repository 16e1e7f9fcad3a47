"""An interrupted BatchNorm FedOpt run of the port resumes bit-equal (a
simulator-scale case of ``test_torch_batchnorm.py``, in a file of its own
so that ``--dist loadfile`` puts it on a worker of its own)."""

import torch

import fedml_tpu_torch
from fedml_tpu_torch.simulation import build_simulator as tbuild
from test_torch_batchnorm import SLICE


def test_bn_checkpoint_resume_bit_equal(tmp_path):
    """An interrupted BatchNorm FedOpt run resumes bit-equal: the checkpoint
    holds the batch_stats beside the params and FedOpt's split adam state."""
    cfg = dict(SLICE, comm_round=4, frequency_of_the_test=10, federated_optimizer="FedOpt",
               server_optimizer="adam", server_lr=0.01, device="cpu")
    full, apply_fn = tbuild(fedml_tpu_torch.init(config=cfg))
    want = full.run(apply_fn, log_fn=None)
    ckpt = str(tmp_path / "ckpt")
    part, apply_fn = tbuild(fedml_tpu_torch.init(config=dict(
        cfg, comm_round=2, checkpoint_dir=ckpt, checkpoint_frequency=1)))
    part.run(apply_fn, log_fn=None)
    from fedml_tpu_torch.utils.checkpoint import CheckpointManager

    saved = CheckpointManager(ckpt).restore()
    assert {k for k in saved["params"] if k.startswith("batch_stats/")} == \
        {k for k in full.params if k.startswith("batch_stats/")}
    assert set(saved["server_state"][0]["mu"]) == \
        {k for k in full.params if k.startswith("params/")}
    resumed, apply_fn = tbuild(fedml_tpu_torch.init(config=dict(
        cfg, checkpoint_dir=ckpt, checkpoint_frequency=1)))
    got = resumed.run(apply_fn, log_fn=None)
    assert [r["train_loss"] for r in got] == [r["train_loss"] for r in want][2:]
    for k, v in full.params.items():
        assert torch.equal(resumed.params[k], v), k
