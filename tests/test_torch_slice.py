"""The whole slice: the robust q8 FedAvg round through both packages.

The same config runs through the JAX package's ``build_simulator`` /
``FedSimulator`` and through the port's on the CPU, from the same initial
weights. Per-round ``train_loss`` / ``test_acc`` / ``test_loss`` and the
quarantine sets are compared. Also: the port runs with JAX unimportable,
its sources import neither JAX nor ``fedml_tpu``, and asking for the card
without one raises.
"""

import ast
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_default_matmul_precision", "highest")

import fedml_tpu  # noqa: E402
import fedml_tpu_torch  # noqa: E402
from fedml_tpu.simulation import build_simulator as jbuild  # noqa: E402
from fedml_tpu_torch.simulation import build_simulator as tbuild  # noqa: E402
from fedml_tpu_torch.utils.convert import variables_from_jax  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE = dict(dataset="mnist", model="lr", debug_small_data=True, client_num_in_total=10,
             client_num_per_round=10, comm_round=3, learning_rate=0.1, batch_size=10,
             frequency_of_the_test=1, federated_optimizer="FedAvg_robust",
             defense_type="multi_krum", sanitize_updates=True, comm_codec="q8",
             agg_kernels=True, random_seed=0)


def test_robust_q8_slice_matches_jax():
    jargs = fedml_tpu.init(config=dict(SLICE, prefetch=False))
    jsim, japply = jbuild(jargs)
    init = jax.tree_util.tree_map(np.asarray, jsim.params)
    jhist = jsim.run(japply, log_fn=None)
    targs = fedml_tpu_torch.init(config=dict(SLICE, device="cpu"))
    tsim, tapply = tbuild(targs, variables=variables_from_jax(init))
    thist = tsim.run(tapply, log_fn=None)
    assert len(jhist) == len(thist) == SLICE["comm_round"]
    for jr, tr in zip(jhist, thist):
        assert tr["quarantined"] == jr["quarantined"]
        # Measured here: losses agree to ~1e-6 relative. After local SGD the
        # params differ by ~1e-7 (f32 reduction order), which can flip a
        # stochastic floor and move one element by one quant step; 1e-4
        # relative leaves room for a few such flips over 3 rounds.
        for k in ("train_loss", "test_loss"):
            assert tr[k] == pytest.approx(jr[k], rel=1e-4), (k, jr, tr)
        assert abs(tr["test_acc"] - jr["test_acc"]) <= 1.0 / 200  # one of 200 test samples
        assert tr["round_time"] > 0
    assert thist[-1]["test_acc"] > thist[0]["test_acc"]


def test_cnn_slice_config_round_runs_on_cpu():
    """The main path's model and defense at a small size: the round history
    has every key, finite values, and both data paths agree on shapes."""
    cfg = dict(SLICE, model="cnn_fedavg", client_num_in_total=20, client_num_per_round=5,
               comm_round=1, learning_rate=0.03, device="cpu")
    hist = fedml_tpu_torch.run_simulation(args=fedml_tpu_torch.init(config=cfg))
    rec = hist[0]
    for k in ("train_loss", "train_acc", "test_loss", "test_acc", "quarantined", "round_time"):
        assert k in rec
    assert np.isfinite(rec["train_loss"]) and np.isfinite(rec["test_loss"])


def test_port_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'fedml_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import fedml_tpu_torch as ft\n"
        f"cfg = {dict(SLICE, comm_round=1, device='cpu')!r}\n"
        "h = ft.run_simulation(args=ft.init(config=cfg))\n"
        "assert len(h) == 1 and h[0]['train_loss'] > 0\n"
        "print('OK')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), r.stderr[-2000:]


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_sources_import_no_jax_and_no_fedml_tpu():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "fedml_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "fedml_tpu"), (f, mod)


def test_asking_for_the_card_without_one_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = fedml_tpu_torch.init(config=dict(SLICE, comm_round=1))  # device defaults to cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        fedml_tpu_torch.run_simulation(args=args)


def test_cuda_wrappers_refuse_non_cuda_devices():
    from fedml_tpu_torch.ops import agg_quant, agg_robust

    with pytest.raises(ValueError):
        agg_robust.gram(torch.ones(2, 3, device="meta"))
    with pytest.raises(ValueError):
        agg_quant.quantize_pack(torch.ones(2, 64, device="meta"), 8, 0, 0,
                                torch.zeros(2, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("knob", [dict(rounds_per_dispatch=2), dict(watchdog_factor=3.0),
                                  dict(cohort_schedule="packed"), dict(backend="TPU"),
                                  dict(federated_optimizer="FedOpt"),
                                  dict(comm_codec="topk:0.1|q8")])
def test_unported_features_raise(knob):
    args = fedml_tpu_torch.init(config=dict(SLICE, comm_round=1, device="cpu", **knob))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fedml_tpu_torch.run_simulation(args=args)
