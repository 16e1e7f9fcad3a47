"""Port vs JAX package: the federated optimizers, the local optimizer and
DP-SGD.

- every optimizer transform of ``fedml_tpu_torch/utils/optim.py`` against
  optax over 20 steps, states converted with ``utils/convert.py``
  (tolerance 1e-6 relative; measured up to 2.4e-7, the float32 power of
  the bias correction rounding differently);
- FedProx (mu unset, 0.0, 0.1), FedOpt (sgd-momentum, adam, yogi,
  adagrad), FedNova and SCAFFOLD through both packages' build_simulator;
- client momentum, weight decay and adam on ``lr`` and ``cnn_fedavg``
  under even, packed and bucketed;
- DP-SGD: clip-only against JAX; with noise, the noise's statistics and
  its independence of the schedule;
- the refusals, and the North star's example config under FedOpt.

Tolerances: the SGD family within 1e-5 of the largest parameter magnitude
(elementwise), losses within 1e-5 relative; the adaptive optimizers within
1e-4 relative in the L2 norm of each leaf and in the losses (float32 sums in another order, divided by Adam's small
second moments: a coordinate whose gradient is ~0 amplifies a rounding
difference to a fraction of a step, measured up to 1.2e-4 of the largest
magnitude on one element of 30,720, and 3.8e-5 in a cnn_fedavg loss).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

jax.config.update("jax_default_matmul_precision", "highest")

import fedml_tpu  # noqa: E402
import fedml_tpu_torch  # noqa: E402
from fedml_tpu.algorithms.local_sgd import LocalTrainConfig as JCfg  # noqa: E402
from fedml_tpu.algorithms.local_sgd import make_local_update as jmake  # noqa: E402
from fedml_tpu.simulation import build_simulator as jbuild  # noqa: E402
from fedml_tpu_torch.algorithms.local_sgd import LocalTrainConfig, make_local_update  # noqa: E402
from fedml_tpu_torch.simulation import build_simulator as tbuild  # noqa: E402
from fedml_tpu_torch.simulation.fed_sim import dp_noise  # noqa: E402
from fedml_tpu_torch.utils import optim  # noqa: E402
from fedml_tpu_torch.utils.convert import (  # noqa: E402
    flatten_paths, state_from_jax, variables_from_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST_LR_YAML = os.path.join(REPO, "examples/sp_fedavg_mnist_lr/fedml_config.yaml")

BASE = dict(dataset="cifar10", model="lr", partition_method="hetero", partition_alpha=0.3,
            debug_small_data=True, client_num_in_total=12, client_num_per_round=6,
            comm_round=3, learning_rate=0.05, epochs=1, batch_size=16,
            frequency_of_the_test=3, random_seed=0)
# lr 0.01: at 0.03, momentum 0.9 diverges (loss 3.6 after a round) and the
# float32 rounding differences grow to 6e-3 of the weights in both packages
CNN = dict(BASE, dataset="mnist", model="cnn_fedavg", client_num_in_total=4,
           client_num_per_round=2, comm_round=2, batch_size=20, learning_rate=0.01)
# a small skewed population: auto takes its packed / bucketed branch
SKEWED = dict(dataset="mnist", model="lr", partition_method="hetero", partition_alpha=0.1,
              debug_small_data=True, client_num_in_total=20, client_num_per_round=6,
              comm_round=1, batch_size=10, random_seed=0)


# --- the optimizer transforms against optax -----------------------------------

TRANSFORMS = {
    "sgd": (lambda: optax.sgd(0.1), lambda: optim.sgd(0.1)),
    "sgd_momentum": (lambda: optax.sgd(0.1, momentum=0.9), lambda: optim.sgd(0.1, 0.9)),
    "adam": (lambda: optax.adam(0.01), lambda: optim.adam(0.01)),
    "yogi": (lambda: optax.yogi(0.01), lambda: optim.yogi(0.01)),
    "adagrad": (lambda: optax.adagrad(0.1), lambda: optim.adagrad(0.1)),
    "decay_clip_momentum": (
        lambda: optax.chain(optax.clip_by_global_norm(1.5), optax.add_decayed_weights(5e-4),
                            optax.sgd(0.1, momentum=0.9)),
        lambda: optim.chain(optim.clip_by_global_norm(1.5), optim.add_decayed_weights(5e-4),
                            optim.sgd(0.1, 0.9))),
    "decay_adam": (lambda: optax.chain(optax.add_decayed_weights(1e-2), optax.adam(0.01)),
                   lambda: optim.chain(optim.add_decayed_weights(1e-2), optim.adam(0.01))),
}


def _close(got, want, rel, what):
    """Elementwise within ``rel`` of the largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale, err_msg=what)


def _close_l2(got, want, rel, what):
    """Within ``rel`` relative in the L2 norm."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, ref = np.linalg.norm(got - want), max(np.linalg.norm(want), 1e-30)
    assert err <= rel * ref, (what, err / ref)


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_optimizer_transform_matches_optax(name):
    """20 steps of seeded gradients (every fourth a large one, so the clip
    triggers) from the same parameters: updates, parameters and every
    state leaf within 1e-6 relative, the adam count equal."""
    jopt, topt = TRANSFORMS[name][0](), TRANSFORMS[name][1]()
    rng = np.random.default_rng(3)
    params = {"params": {"a": rng.standard_normal((4, 3)).astype(np.float32),
                         "b": rng.standard_normal(5).astype(np.float32)}}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = variables_from_jax(params)
    js, ts = jopt.init(jp), topt.init(tp)
    assert jax.tree_util.tree_structure(state_from_jax(jax.tree_util.tree_map(np.asarray, js))) \
        is not None
    for step in range(20):
        g = {"params": {k: (rng.standard_normal(v.shape) * (5.0 if step % 4 == 3 else 0.3)
                            ).astype(np.float32) for k, v in params["params"].items()}}
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update(variables_from_jax(g), ts, tp)
        tp = optim.apply_updates(tp, tu)
        for k, v in flatten_paths(jax.tree_util.tree_map(np.asarray, ju)).items():
            _close(tu[k].numpy(), v, 1e-6, (name, step, "update", k))
        for k, v in flatten_paths(jax.tree_util.tree_map(np.asarray, jp)).items():
            _close(tp[k].numpy(), v, 1e-6, (name, step, "param", k))
        want = state_from_jax(jax.tree_util.tree_map(np.asarray, js))
        flat_w, spec_w = torch.utils._pytree.tree_flatten(want)
        flat_t, spec_t = torch.utils._pytree.tree_flatten(ts)
        assert spec_w == spec_t, (name, spec_w, spec_t)
        for a, b in zip(flat_t, flat_w):
            if b.dtype == torch.int32:
                assert a.dtype == torch.int32 and torch.equal(a, b), (name, step)
            else:
                _close(a.numpy(), b.numpy(), 1e-6, (name, step, "state"))


class _Args:
    dataset = "mnist"

    def __init__(self, model):
        self.model = model


def _lr_pair(seed=1):
    from fedml_tpu import models as jmodels
    from fedml_tpu_torch import models as tmodels

    jm = jmodels.create(_Args("lr"), 10)
    jv = jmodels.init_params(jm, jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28, 1)))
    tm = tmodels.create(_Args("lr"), 10, (28, 28, 1))
    return (lambda v, xx, train=False, rngs=None, mutable=False: jm.apply(v, xx),
            jax.tree_util.tree_map(np.asarray, jv),
            lambda p, xx: tmodels.apply(tm, p, xx))


def _local_pair(kw, x, y, mask, n):
    japply, jv, tapply = _lr_pair()
    jout = jmake(japply, JCfg(**kw))(jax.tree_util.tree_map(jnp.asarray, jv), (),
                                     {"x": x, "y": y, "mask": mask,
                                      "num_samples": jnp.int32(n)}, jax.random.PRNGKey(0))
    tout = make_local_update(tapply, LocalTrainConfig(**kw))(
        variables_from_jax(jv), (), {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
                                     "mask": torch.from_numpy(mask),
                                     "num_samples": torch.tensor(n)}, None)
    return jout, tout, jv, tapply


def test_all_padding_batch_leaves_adam_state_unchanged():
    """Adam over three batches, the middle one all padding, equals Adam over
    the two real batches bit for bit (its count and moments did not
    advance on the padding) and JAX's padded run within 1e-4."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, (3, 4)).astype(np.int32)
    mask = np.ones((3, 4), np.float32)
    mask[1] = 0.0
    kw = dict(lr=0.01, client_optimizer="adam", epochs=2)
    jout, tout, jv, tapply = _local_pair(kw, x, y, mask, 8)
    ref = make_local_update(tapply, LocalTrainConfig(**kw))(
        variables_from_jax(jv), (), {"x": torch.from_numpy(x[[0, 2]]),
                                     "y": torch.from_numpy(y[[0, 2]]),
                                     "mask": torch.from_numpy(mask[[0, 2]]),
                                     "num_samples": torch.tensor(8)}, None)
    for k in ref.update:
        assert torch.equal(tout.update[k], ref.update[k]), k
    assert float(tout.metrics["local_steps"]) == 4.0 == float(jout.metrics["local_steps"])
    for k, v in flatten_paths(jax.tree_util.tree_map(np.asarray, jout.update)).items():
        _close_l2(tout.update[k].numpy(), v, 1e-4, k)


def test_max_grad_norm_local_update_matches_jax():
    """The clip in the local chain, with momentum, over two epochs (no
    config key sets max_grad_norm; the local update is called directly)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 4, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, (3, 4)).astype(np.int32)
    mask = np.ones((3, 4), np.float32)
    jout, tout, _, _ = _local_pair(dict(lr=0.1, epochs=2, momentum=0.9, max_grad_norm=0.05),
                                   x, y, mask, 12)
    for k, v in flatten_paths(jax.tree_util.tree_map(np.asarray, jout.update)).items():
        _close(tout.update[k].numpy(), v, 1e-5, k)


# --- whole runs against JAX ------------------------------------------------------


def _jax_sim(base, **kw):
    return jbuild(fedml_tpu.init(config=dict(base, prefetch=False, **kw)))


def _pair(base=BASE, **kw):
    jsim, japply = _jax_sim(base, **kw)
    init = variables_from_jax(jax.tree_util.tree_map(np.asarray, jsim.params))
    tsim, tapply = tbuild(fedml_tpu_torch.init(config=dict(base, device="cpu", **kw)),
                          variables=init)
    return jsim, japply, tsim, tapply


def _jkind(jsim):
    return "packed" if jsim._packed else "bucketed" if jsim._bucketed else "even"


def _run_pair(base=BASE, rel=1e-5, adaptive=False, **kw):
    jsim, japply, tsim, tapply = _pair(base, **kw)
    assert tsim.schedule == _jkind(jsim)
    jh = jsim.run(japply, log_fn=None)
    th = tsim.run(tapply, log_fn=None)
    assert len(th) == len(jh)
    for jr, tr in zip(jh, th):
        for k in ("train_loss", "test_loss"):
            if k in jr:
                assert tr[k] == pytest.approx(jr[k], rel=1e-4 if adaptive else 1e-5,
                                              abs=1e-6), (k, jr, tr)
        for k in ("train_acc", "test_acc"):
            if k in jr:
                assert abs(tr[k] - jr[k]) <= 1e-6 + 1e-9, (k, jr, tr)
    jp = flatten_paths(jax.tree_util.tree_map(np.asarray, jsim.params))
    for k, v in jp.items():
        (_close_l2 if adaptive else _close)(tsim.params[k].detach().numpy(), v, rel, k)
    return jsim, tsim


@pytest.mark.parametrize("mu,schedule", [(None, "even"), (0.0, "even"), (0.1, "even"),
                                         (None, "packed"), (0.1, "packed")])
def test_fedprox_matches_jax(mu, schedule):
    """mu unset defaults to 0.1 in the local update, an explicit 0.0 is
    honoured. The packed step reads mu from the facade's config, as the
    JAX package's does, so an unset mu trains without the term there."""
    kw = dict(federated_optimizer="FedProx", cohort_schedule=schedule)
    if mu is not None:
        kw["fedprox_mu"] = mu
    _run_pair(**kw)


@pytest.mark.parametrize("sopt,schedule", [("sgd", "even"), ("adam", "packed"),
                                           ("yogi", "even"), ("adagrad", "bucketed"),
                                           ("None", "even")])
def test_fedopt_matches_jax(sopt, schedule):
    adaptive = sopt not in ("sgd", "None")
    _, tsim = _run_pair(rel=1e-4 if adaptive else 1e-5, adaptive=adaptive,
                        federated_optimizer="FedOpt", server_optimizer=sopt,
                        server_lr=0.05, server_momentum=0.9, cohort_schedule=schedule)
    if sopt == "adam":
        assert int(tsim.server_state[0]["count"]) == BASE["comm_round"]


def test_fedopt_resumes_from_a_converted_jax_state():
    """Two JAX rounds of FedOpt(adam); the port takes the JAX parameters and
    optimizer state (``state_from_jax``) and runs round 2; it meets a JAX
    run of three rounds."""
    kw = dict(federated_optimizer="FedOpt", server_optimizer="adam", server_lr=0.05,
              cohort_schedule="even")
    j2, japply = _jax_sim(BASE, comm_round=2, **kw)
    j2.run(japply, log_fn=None)
    j3, japply3 = _jax_sim(BASE, **kw)
    j3.run(japply3, log_fn=None)
    tsim, _ = tbuild(fedml_tpu_torch.init(config=dict(BASE, device="cpu", **kw)),
                     variables=variables_from_jax(jax.tree_util.tree_map(np.asarray, j2.params)))
    tsim.server_state = state_from_jax(jax.tree_util.tree_map(np.asarray, j2.server_state))
    assert int(tsim.server_state[0]["count"]) == 2
    inputs = tsim.build_round_inputs(2)
    tsim._round_step(inputs.payload, inputs.client_ids, 2)
    for k, v in flatten_paths(jax.tree_util.tree_map(np.asarray, j3.params)).items():
        _close_l2(tsim.params[k].numpy(), v, 1e-4, k)


@pytest.mark.parametrize("name", ["FedNova", "SCAFFOLD"])
def test_fednova_and_scaffold_match_jax(name):
    """Both run even under auto (not mean-aggregating). SCAFFOLD's control
    variates divide by K lr, which magnifies rounding: they are held with a
    relative tolerance."""
    jsim, tsim = _run_pair(federated_optimizer=name, cohort_schedule="auto", server_lr=1.0)
    assert tsim.schedule == "even"
    if name == "SCAFFOLD":
        jc = state_from_jax(jax.tree_util.tree_map(np.asarray, jsim.server_state))["c"]
        for k, v in jc.items():
            _close(tsim.server_state["c"][k].numpy(), v.numpy(), 1e-4, k)
        for cid in range(BASE["client_num_in_total"]):
            jrow = state_from_jax(jax.tree_util.tree_map(np.asarray, jsim._arena.state_of(cid)))
            trow = tsim._arena.state_of(cid)
            for a, b in zip(torch.utils._pytree.tree_leaves(trow),
                            torch.utils._pytree.tree_leaves(jrow)):
                _close(a.numpy(), b.numpy(), 1e-4, cid)


@pytest.mark.parametrize("base,opt,schedule", [
    (BASE, "sgd", "even"), (BASE, "sgd", "packed"), (BASE, "sgd", "bucketed"),
    (BASE, "adam", "even"), (BASE, "adam", "packed"), (BASE, "adam", "bucketed"),
    (CNN, "sgd", "packed"), (CNN, "adam", "even")], ids=lambda v: v if isinstance(v, str)
    else v["model"])
def test_client_optimizers_match_jax(base, opt, schedule):
    """Client momentum 0.9 with weight decay 5e-4 (the SGD family) and adam
    with weight decay, for the config's rounds; packed carries each lane's
    optimizer state and resets it at client boundaries."""
    kw = dict(client_optimizer=opt, weight_decay=5e-4, cohort_schedule=schedule)
    if opt == "sgd":
        kw["momentum"] = 0.9
    else:  # adam's steps are lr-sized whatever the gradient: smaller rates
        kw["learning_rate"] = 0.003 if base is BASE else 0.001
    _run_pair(base, rel=1e-5 if opt == "sgd" else 1e-4, adaptive=opt == "adam", **kw)


# --- DP-SGD ------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["even", "bucketed"])
def test_dp_sgd_clip_only_matches_jax(schedule):
    """Per-example clipping without noise: the same arithmetic as JAX
    within 1e-5 of the parameters' magnitude. auto resolves DP-SGD on this
    population to even; bucketed is forced."""
    _run_pair(dp_l2_clip=0.5, cohort_schedule=schedule)


def test_dp_noise_statistics_and_schedule_independence():
    """One local DP step with noise minus the same step clip-only is
    ``-lr sigma n / denom``: its mean and standard deviation meet 0 and
    ``sigma / denom`` within three standard errors. The noise rows a
    client receives are the same under even and bucketed (keyed by
    seed, round, cohort position and step), and so are whole runs."""
    cfg = dict(BASE, device="cpu", dp_l2_clip=0.5, dp_noise_multiplier=1.3)
    sims = {s: tbuild(fedml_tpu_torch.init(config=dict(cfg, cohort_schedule=s)))[0]
            for s in ("even", "bucketed")}
    even, buck = (sims[s].build_round_inputs(1) for s in ("even", "bucketed"))
    n_params = sims["even"]._n_params
    ev = dp_noise(0, 1, even.payload["pos"], even.payload["mask"], 1, n_params, "cpu")
    checked = 0
    for b in buck.payload:
        pl = b["payload"]
        bn = dp_noise(0, 1, pl["pos"], pl["mask"], 1, n_params, "cpu")
        for r in range(b["n_real"]):
            pos = int(pl["pos"][r])
            width = pl["mask"].shape[1]
            assert torch.equal(bn[r, :width], ev[pos, :width]), pos
            checked += int((pl["mask"][r].sum(-1) > 0).sum())
    assert checked > 0
    # the injected noise through the local update
    from fedml_tpu_torch.models import apply as tapply

    sim = sims["even"]
    lcfg = sim._packed_ctx[1]
    apply_fn = sim._packed_ctx[0]
    payload = even.payload
    c = int(np.argmax(payload["mask"][:, 0].sum(-1)))
    data = {"x": sim._x_dev[torch.from_numpy(payload["idx"][c, :1]).long()],
            "y": sim._y_dev[torch.from_numpy(payload["idx"][c, :1]).long()],
            "mask": torch.from_numpy(payload["mask"][c, :1]),
            "num_samples": torch.tensor(int(payload["num_samples"][c]))}
    noisy = make_local_update(apply_fn, lcfg)(sim.params, (), data, ev[c, :1])
    quiet = make_local_update(apply_fn, LocalTrainConfig(lr=lcfg.lr, dp_l2_clip=0.5))(
        sim.params, (), data, None)
    inj = torch.cat([(noisy.update[k] - quiet.update[k]).flatten() for k in sim.params])
    inj = inj / -lcfg.lr
    denom = float(payload["mask"][c, 0].sum())
    want_std = 1.3 * 0.5 / denom
    n = inj.numel()
    assert abs(inj.mean().item()) <= 3 * want_std / np.sqrt(n)
    assert abs(inj.std().item() - want_std) <= 3 * want_std / np.sqrt(2 * n)
    hist = {s: sims[s].run(None, log_fn=None) for s in sims}
    for k in sims["even"].params:
        np.testing.assert_allclose(sims["bucketed"].params[k].numpy(),
                                   sims["even"].params[k].numpy(), rtol=0, atol=2e-6)
    assert all(np.isfinite(r["train_loss"]) for r in hist["even"])


# --- schedule resolution and refusals ------------------------------------------------


@pytest.mark.parametrize("kw", [dict(federated_optimizer="SCAFFOLD"),
                                dict(dp_l2_clip=1.0), dict(federated_optimizer="FedNova"),
                                dict(federated_optimizer="FedOpt"),
                                dict(federated_optimizer="FedProx"),
                                dict(federated_optimizer="FedAvg_robust")])
def test_schedule_resolution_matches_jax(kw):
    """The JAX eligibility rule, on a skewed population (auto's packed or
    bucketed branch): SCAFFOLD and DP-SGD are never packed; FedNova,
    SCAFFOLD and the defenses are not mean-aggregating and run even;
    FedProx and FedOpt are packed-eligible."""
    cfg = dict(SKEWED, **kw)
    jsim, _ = _jax_sim(cfg)
    tsim, _ = tbuild(fedml_tpu_torch.init(config=dict(cfg, device="cpu")))
    assert tsim.schedule == _jkind(jsim)


@pytest.mark.parametrize("kw,err", [
    (dict(federated_optimizer="SCAFFOLD", cohort_schedule="packed"), "packed"),
    (dict(dp_l2_clip=1.0, cohort_schedule="packed"), "packed"),
    (dict(federated_optimizer="FedNova", comm_codec="q8"), "comm_codec"),
    (dict(dp_noise_multiplier=1.0), "dp_l2_clip"),
    (dict(federated_optimizer="FedOpt", server_optimizer="lamb"), "server_optimizer"),
    (dict(client_state_backend="disk", federated_optimizer="SCAFFOLD"), "backend")])
def test_refusals_match_jax(kw, err):
    with pytest.raises(ValueError, match=err):
        _jax_sim(BASE, **kw)
    with pytest.raises(ValueError, match=err):
        tbuild(fedml_tpu_torch.init(config=dict(BASE, device="cpu", **kw)))


def test_sp_fedavg_mnist_lr_example_with_fedopt_matches_jax():
    """examples/sp_fedavg_mnist_lr/fedml_config.yaml under FedOpt (server
    adam, lr 0.01) through load_arguments(--cf) in both packages, cut to 2
    rounds: both resolve auto to packed."""
    over = dict(comm_round=2, federated_optimizer="FedOpt", server_optimizer="adam",
                server_lr=0.01)
    jargs = fedml_tpu.init(fedml_tpu.load_arguments(args_list=["--cf", MNIST_LR_YAML],
                                                    override=over))
    jsim, japply = jbuild(jargs)
    init = variables_from_jax(jax.tree_util.tree_map(np.asarray, jsim.params))
    targs = fedml_tpu_torch.init(fedml_tpu_torch.load_arguments(
        args_list=["--cf", MNIST_LR_YAML], override=dict(over, device="cpu")))
    tsim, tapply = tbuild(targs, variables=init)
    assert jsim._packed and tsim.schedule == "packed"
    jh = jsim.run(japply, log_fn=None)
    th = tsim.run(tapply, log_fn=None)
    for jr, tr in zip(jh, th):
        assert tr["train_loss"] == pytest.approx(jr["train_loss"], rel=1e-5)
    for k, v in flatten_paths(jax.tree_util.tree_map(np.asarray, jsim.params)).items():
        _close_l2(tsim.params[k].numpy(), v, 1e-4, k)
