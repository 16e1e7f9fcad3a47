"""Port vs JAX package: FedAvg_robust's non-Krum defenses and the DP
accountant.

- ``norm_diff_clipping`` (which clients are clipped, and the aggregate),
  ``coordinate_median`` over an even cohort (the mean of the two middle
  values, as ``jnp.median``) and the weighted ``trimmed_mean`` (beta 0.1
  over a cohort of 3 and of 10, ties included) against the JAX functions
  on the same stacked updates: within 1e-6 of the magnitudes (float32
  norms and weighted sums in another order);
- ``weak_dp``'s noise: mean and standard deviation within three standard
  errors, fresh every round, repeatable from the seed;
- ``rdp_epsilon`` / ``epsilon_for_training`` equal to JAX's;
- FedAvg_robust runs through both packages' build_simulator with every
  defense (weak DP at stddev 0, where it is deterministic), within the
  schedule tests' tolerances, and with no ``defense_type`` runs
  ``norm_diff_clipping``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_default_matmul_precision", "highest")

import fedml_tpu  # noqa: E402
import fedml_tpu_torch  # noqa: E402
from fedml_tpu.core import dp as jdp  # noqa: E402
from fedml_tpu.core import robust as jrobust  # noqa: E402
from fedml_tpu.simulation import build_simulator as jbuild  # noqa: E402
from fedml_tpu_torch.core import dp as tdp  # noqa: E402
from fedml_tpu_torch.core import robust as trobust  # noqa: E402
from fedml_tpu_torch.simulation import build_simulator as tbuild  # noqa: E402
from fedml_tpu_torch.utils.convert import flatten_paths, variables_from_jax  # noqa: E402

SHAPES = {"Dense_0": {"kernel": (6, 4), "bias": (4,)}, "BatchNorm_0": {"batch_stats": (4,)}}


def _stack(C, seed, ties=False):
    rng = np.random.default_rng(seed)
    tree = {"params": {m: {k: (rng.standard_normal((C,) + s) * rng.uniform(0.2, 3.0, (C,) +
                                                                          (1,) * len(s)))
                           .astype(np.float32) for k, s in leaves.items()}
                       for m, leaves in SHAPES.items()}}
    if ties:  # equal coordinates across clients: the sort's tie order matters
        tree["params"]["Dense_0"]["bias"][:, 0] = 1.0
    return tree


def _agree(tagg, jagg, what):
    for k, v in flatten_paths(jax.tree_util.tree_map(np.asarray, jagg)).items():
        np.testing.assert_allclose(tagg[k].numpy(), v, rtol=0,
                                   atol=1e-6 * max(np.abs(v).max(), 1.0), err_msg=(what, k))


@pytest.mark.parametrize("C", [3, 10])
def test_norm_diff_clipping_matches_jax(C):
    """The clipped clients (norm above the bound) and the aggregate; the
    running statistics pass unscaled."""
    tree = _stack(C, 0)
    w = np.arange(1, C + 1, dtype=np.float32)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = variables_from_jax(tree)
    jn = np.asarray(jax.vmap(lambda u: jrobust.global_norm(u, weights_only=True))(jt))
    tn = torch.stack([trobust.global_norm({k: v[i] for k, v in tt.items()}, weights_only=True)
                      for i in range(C)]).numpy()
    np.testing.assert_allclose(tn, jn, rtol=1e-6)
    bound = float(np.median(jn))  # about half the cohort is clipped
    jra = jrobust.RobustAggregator("norm_diff_clipping", norm_bound=bound)
    tra = trobust.RobustAggregator("norm_diff_clipping", norm_bound=bound)
    _agree(tra.aggregate(tt, torch.from_numpy(w)), jra.aggregate(jt, jnp.asarray(w)), "agg")
    clipped = tn > bound
    assert list(clipped) == list(jn > bound) and 0 < clipped.sum() < C
    jc = jrobust.norm_clip_stacked(jt, bound)
    tc = trobust.norm_clip_stacked(tt, bound)
    _agree(tc, jc, "clipped")
    stats = "params/BatchNorm_0/batch_stats"
    assert torch.equal(tc[stats], tt[stats])


@pytest.mark.parametrize("C,nan", [(10, False), (4, False), (10, True), (7, False)])
def test_coordinate_median_matches_jnp(C, nan):
    tree = _stack(C, 1)
    if nan:
        tree["params"]["Dense_0"]["kernel"][3, 0, 0] = np.nan
    jm = jrobust.coordinate_median(jax.tree_util.tree_map(jnp.asarray, tree))
    tm = trobust.coordinate_median(variables_from_jax(tree))
    for k, v in flatten_paths(jax.tree_util.tree_map(np.asarray, jm)).items():
        np.testing.assert_array_equal(tm[k].numpy(), v, err_msg=k)
    if nan:
        assert torch.isnan(tm["params/Dense_0/kernel"][0, 0])


@pytest.mark.parametrize("C,weighted", [(3, True), (10, True), (10, False), (3, False)])
def test_trimmed_mean_matches_jax(C, weighted):
    """beta 0.1: k = min(int(n beta), (n - 1) // 2) = 0 for 3 clients, 1
    for 10; with weights (one zero) the survivors are weight-averaged."""
    tree = _stack(C, 2, ties=True)
    w = np.arange(C, dtype=np.float32)  # client 0 weighs nothing
    jm = jrobust.trimmed_mean(jax.tree_util.tree_map(jnp.asarray, tree), 0.1,
                              weights=jnp.asarray(w) if weighted else None)
    tm = trobust.trimmed_mean(variables_from_jax(tree), 0.1,
                              weights=torch.from_numpy(w) if weighted else None)
    _agree(tm, jm, (C, weighted))


def test_weak_dp_noise_statistics_and_freshness():
    """stddev 0.05 on a zero aggregate: the noise's mean and standard
    deviation within three standard errors; two rounds draw different
    noise; two runs from one seed draw the same."""
    from fedml_tpu_torch.algorithms import get_algorithm

    alg = get_algorithm("FedAvg_robust", lambda p, x: x, fedml_tpu_torch.algorithms.
                        LocalTrainConfig(), defense_type="weak_dp", stddev=0.05, dp_seed=3)
    params = {"params/w": torch.zeros(20000), "params/b": torch.zeros(100)}
    zero = {k: torch.zeros_like(v) for k, v in params.items()}
    s0 = alg.init_server_state(params)
    p1, s1 = alg.server_update(params, zero, s0)
    p2, _ = alg.server_update(params, zero, s1)
    again, _ = alg.server_update(params, zero, alg.init_server_state(params))
    noise = torch.cat([p1[k] for k in params])
    n = noise.numel()
    assert abs(noise.mean().item()) <= 3 * 0.05 / np.sqrt(n)
    assert abs(noise.std().item() - 0.05) <= 3 * 0.05 / np.sqrt(2 * n)
    assert not torch.equal(p1["params/w"], p2["params/w"])
    assert torch.equal(p1["params/w"], again["params/w"])
    assert alg.robust.defense_type == "norm_diff_clipping"
    with pytest.raises(ValueError, match="fresh"):
        trobust.RobustAggregator("weak_dp").aggregate(zero, torch.ones(1))


@pytest.mark.parametrize("mult,steps,delta", [(0.1, 3, 1e-5), (1.1, 1000, 1e-5),
                                              (0.0, 5, 1e-5), (2.0, 60, 1e-6)])
def test_rdp_epsilon_equals_jax(mult, steps, delta):
    assert tdp.rdp_epsilon(mult, steps, delta) == jdp.rdp_epsilon(mult, steps, delta)
    assert tdp.epsilon_for_training(mult, 7, steps, delta) == \
        jdp.epsilon_for_training(mult, 7, steps, delta)


BASE = dict(dataset="cifar10", model="lr", partition_method="hetero", partition_alpha=0.3,
            debug_small_data=True, client_num_in_total=12, client_num_per_round=6,
            comm_round=3, learning_rate=0.05, epochs=1, batch_size=16,
            frequency_of_the_test=3, random_seed=0, federated_optimizer="FedAvg_robust",
            norm_bound=0.3)


@pytest.mark.parametrize("defense", [None, "norm_diff_clipping", "weak_dp",
                                     "coordinate_median", "trimmed_mean"])
def test_fedavg_robust_runs_match_jax(defense):
    kw = {} if defense is None else dict(defense_type=defense)
    jsim, japply = jbuild(fedml_tpu.init(config=dict(BASE, prefetch=False, **kw)))
    init = variables_from_jax(jax.tree_util.tree_map(np.asarray, jsim.params))
    tsim, tapply = tbuild(fedml_tpu_torch.init(config=dict(BASE, device="cpu", **kw)),
                          variables=init)
    assert tsim.alg.robust.defense_type == jsim.alg.robust.defense_type == \
        ("norm_diff_clipping" if defense in (None, "weak_dp") else defense)
    assert tsim.schedule == "even"
    jh = jsim.run(japply, log_fn=None)
    th = tsim.run(tapply, log_fn=None)
    for jr, tr in zip(jh, th):
        for k in ("train_loss", "test_loss"):
            if k in jr:
                assert tr[k] == pytest.approx(jr[k], rel=1e-5, abs=1e-6), (k, jr, tr)
    for k, v in flatten_paths(jax.tree_util.tree_map(np.asarray, jsim.params)).items():
        np.testing.assert_allclose(tsim.params[k].numpy(), v, rtol=0,
                                   atol=1e-5 * np.abs(v).max(), err_msg=k)


def test_unknown_defense_raises_as_jax():
    with pytest.raises(ValueError, match="defense_type"):
        trobust.RobustAggregator("bulyan")
    with pytest.raises(ValueError, match="defense_type"):
        jrobust.RobustAggregator("bulyan").aggregate({"w": jnp.ones((2, 1))}, jnp.ones(2))
