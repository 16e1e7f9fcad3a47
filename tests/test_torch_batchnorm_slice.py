"""Port vs JAX package: a whole 2-round resnet8 BatchNorm FedAvg history
under the even and bucketed schedules (a simulator-scale case of
``test_torch_batchnorm.py``, in a file of its own so that ``--dist
loadfile`` puts it on a worker of its own)."""

import jax
import numpy as np
import pytest

jax.config.update("jax_default_matmul_precision", "highest")

import fedml_tpu  # noqa: E402
import fedml_tpu_torch  # noqa: E402
from fedml_tpu.simulation import build_simulator as jbuild  # noqa: E402
from fedml_tpu_torch.simulation import build_simulator as tbuild  # noqa: E402
from fedml_tpu_torch.utils.convert import flatten_paths, variables_from_jax  # noqa: E402
from test_torch_batchnorm import SLICE, _np, jsim_schedule  # noqa: E402


@pytest.mark.parametrize("cohort_schedule", ["even", "bucketed"])
def test_bn_slice_matches_jax(cohort_schedule):
    """A 2-round resnet8 BatchNorm FedAvg run through both packages'
    build_simulator from the same variables: train and test metrics per
    round, and the final running statistics."""
    cfg = dict(SLICE, cohort_schedule=cohort_schedule)
    jsim, japply = jbuild(fedml_tpu.init(config=dict(cfg, prefetch=False)))
    init = _np(jsim.params)
    jhist = jsim.run(japply, log_fn=None)
    tsim, tapply = tbuild(fedml_tpu_torch.init(config=dict(cfg, device="cpu")),
                          variables=variables_from_jax(init))
    assert tsim.schedule == jsim_schedule(jsim) == cohort_schedule
    thist = tsim.run(tapply, log_fn=None)
    assert len(thist) == len(jhist) == SLICE["comm_round"]
    for jr, tr in zip(jhist, thist):
        # as the GroupNorm slice: f32 sums in another order, grown through
        # SGD; eval on the running averages
        for k in ("train_loss", "test_loss"):
            assert tr[k] == pytest.approx(jr[k], rel=5e-4), (k, jr, tr)
        assert abs(tr["train_acc"] - jr["train_acc"]) <= 1e-6
        assert abs(tr["test_acc"] - jr["test_acc"]) <= 1.0 / 200
    # the running statistics are averages of activations of parameters that
    # differ as above: measured up to 3.6e-4 of each leaf's largest value
    jfinal = flatten_paths(_np(jsim.params))
    for p, v in jfinal.items():
        if p.startswith("batch_stats/"):
            np.testing.assert_allclose(tsim.params[p].numpy(), v, rtol=0,
                                       atol=2e-3 * np.abs(v).max(), err_msg=p)
