"""Port vs JAX package: the cohort schedules, client dropout, per-client
local tests, the server-tester hook and the North star's example config.

- the schedulers (``core/scheduler.py``) return what the JAX package's do;
- the host plans of every schedule (packed lane tensors, bucketed width
  classes, the even rectangle, the drop mask) are bit-equal to the JAX
  package's, packed also to its per-client loop packer;
- the packed, bucketed and even rounds, with and without dropout, match
  JAX from the same initial weights, and the port's packed and bucketed
  rounds match its even round;
- ``examples/sp_fedavg_mnist_lr/fedml_config.yaml`` runs through both
  packages under its own ``cohort_schedule: auto``.
"""

import os

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_default_matmul_precision", "highest")

import fedml_tpu  # noqa: E402
import fedml_tpu_torch  # noqa: E402
from fedml_tpu.core import scheduler as jsched  # noqa: E402
from fedml_tpu.simulation import build_simulator as jbuild  # noqa: E402
from fedml_tpu_torch.core import scheduler as tsched  # noqa: E402
from fedml_tpu_torch.simulation import build_simulator as tbuild  # noqa: E402
from fedml_tpu_torch.utils.convert import flatten_paths, variables_from_jax  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST_LR_YAML = os.path.join(REPO, "examples/sp_fedavg_mnist_lr/fedml_config.yaml")

# the JAX package's own packed-schedule test config (test_packed_schedule.py)
BASE = dict(dataset="cifar10", model="lr", partition_method="hetero", partition_alpha=0.3,
            debug_small_data=True, client_num_in_total=12, client_num_per_round=6,
            comm_round=3, learning_rate=0.05, epochs=1, batch_size=16,
            frequency_of_the_test=3, random_seed=0)


def _jax_sim(**kw):
    return jbuild(fedml_tpu.init(config=dict(BASE, prefetch=False, **kw)))


def _port_sim(variables=None, **kw):
    return tbuild(fedml_tpu_torch.init(config=dict(BASE, device="cpu", **kw)),
                  variables=variables)


def _pair(**kw):
    """Both packages' simulators of one config, the port's from the JAX
    package's initial weights."""
    jsim, japply = _jax_sim(**kw)
    init = variables_from_jax(jax.tree_util.tree_map(np.asarray, jsim.params))
    tsim, tapply = _port_sim(init, **kw)
    return jsim, japply, tsim, tapply


def _flat_port(sim):
    return {k: v.detach().numpy() for k, v in sim.params.items()}


def _flat_jax(sim):
    return {k: np.asarray(v) for k, v in flatten_paths(
        jax.tree_util.tree_map(np.asarray, sim.params)).items()}


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


# --- the schedulers ----------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_schedulers_match_jax(seed):
    """Seeded count vectors (with ties), axis 1..64 (64 > n: the pad
    fallback), forced lane counts, lane caps and bucket width caps."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 25))
    counts = rng.integers(1, 30, n).tolist()
    for c in (counts, [4] * n):
        for axis in (1, 2, 4, 64):
            for force in (None, 1, 3, 64):
                for cap in (None, 5):
                    assert tsched.lane_schedule(c, axis, cap, force) == \
                        jsched.lane_schedule(c, axis, cap, force), (c, axis, cap, force)
            for mb in (1, 2, 4):
                for mw in (None, 4, 64):
                    tb = tsched.bucket_schedule(c, axis, mb, mw)
                    jb = jsched.bucket_schedule(c, axis, mb, mw)
                    assert len(tb) == len(jb)
                    for (tp, tw), (jp, jw) in zip(tb, jb):
                        _eq(tp, jp, "bucket positions")
                        assert tw == jw
    work = rng.random(n) * 10
    cons, mem = 1 + rng.random(3), np.full(3, work.sum() * 3)
    (ta, tc), (ja, jc) = tsched.dp_schedule(work, cons, mem), jsched.dp_schedule(work, cons, mem)
    assert ta == ja
    _eq(tc, jc, "device costs")
    for mod in (tsched, jsched):
        with pytest.raises(ValueError, match="fits no device"):
            mod.dp_schedule(work, cons, np.zeros(3))


def test_scheduler_cache_hands_out_copies():
    counts = [9, 3, 7, 1, 5]
    lanes, _ = tsched.lane_schedule(counts, 1)
    lanes[0].append(99)
    buckets = tsched.bucket_schedule(counts, 1)
    buckets[0][0][0] = 99
    assert 99 not in sum(tsched.lane_schedule(counts, 1)[0], [])
    assert tsched.bucket_schedule(counts, 1)[0][0][0] != 99


# --- host plans, bit for bit ---------------------------------------------------


@pytest.mark.parametrize("epochs,dropout", [(1, 0.0), (1, 0.3), (2, 0.0), (2, 0.3)])
def test_packed_inputs_bit_equal_to_jax(epochs, dropout):
    """The packed payload (lane index tensor, mask, boundary, bweight, pos,
    sic, shape, cohort_n) equals the JAX package's vectorized packer and its
    per-client loop packer, byte for byte, over four rounds."""
    kw = dict(cohort_schedule="packed", epochs=epochs, client_dropout_rate=dropout)
    jsim, _ = _jax_sim(**kw)
    tsim, _ = _port_sim(**kw)
    dropped = 0
    for r in range(4):
        ji, ti = jsim.build_round_inputs(r), tsim.build_round_inputs(r)
        assert ti.kind == ji.kind == "packed"
        _eq(ti.client_ids, ji.client_ids, "cohort")
        assert (ti.drop is None) == (ji.drop is None) == (dropout == 0.0)
        if ti.drop is not None:
            _eq(ti.drop, ji.drop, "drop mask")
            dropped += int(ti.drop.sum())
        loop = jsim._build_packed_inputs_loop(ji.client_ids, r, ji.drop)
        for k in ("idx", "mask", "boundary", "bweight", "pos", "sic"):
            _eq(ti.payload[k], ji.payload[k], (r, k))
            _eq(ti.payload[k], loop[k], (r, k, "loop"))
        assert ti.payload["shape"] == ji.payload["shape"] == loop["shape"]
        assert ti.payload["cohort_n"] == ji.payload["cohort_n"] == 6
    if dropout:
        assert dropped > 0  # the drop mask excluded clients from the lanes


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_bucketed_and_even_inputs_bit_equal_to_jax(dropout):
    kw = dict(client_dropout_rate=dropout)
    for schedule in ("bucketed", "even"):
        jsim, _ = _jax_sim(cohort_schedule=schedule, **kw)
        tsim, _ = _port_sim(cohort_schedule=schedule, **kw)
        for r in range(3):
            ji, ti = jsim.build_round_inputs(r), tsim.build_round_inputs(r)
            assert ti.kind == ji.kind == schedule
            if schedule == "even":
                for k in ("idx", "mask", "num_samples", "pos"):
                    _eq(ti.payload[k], ji.payload[k], (r, k))
                continue
            assert len(ti.payload) == len(ji.payload) > 1
            for tb, jb in zip(ti.payload, ji.payload):
                _eq(tb["ids"], jb["ids"], "bucket ids")
                assert tb["n_real"] == jb["n_real"]
                for k in ("idx", "mask", "num_samples", "pos"):
                    _eq(tb["payload"][k], jb["payload"][k], (r, k))


# --- whole rounds against JAX ---------------------------------------------------


def _assert_runs_match(jsim, jh, tsim, th, param_atol):
    assert len(th) == len(jh)
    for jr, tr in zip(jh, th):
        for k in ("train_loss", "test_loss"):
            if k in jr:
                assert tr[k] == pytest.approx(jr[k], rel=1e-5, abs=1e-6), (k, jr, tr)
        for k in ("train_acc", "test_acc"):
            if k in jr:
                assert abs(tr[k] - jr[k]) <= 1e-6, (k, jr, tr)
    tp, jp = _flat_port(tsim), _flat_jax(jsim)
    assert tp.keys() == jp.keys()
    for k in tp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=param_atol, err_msg=k)


@pytest.mark.parametrize("schedule,dropout", [("packed", 0.0), ("packed", 0.3),
                                              ("bucketed", 0.0), ("bucketed", 0.3),
                                              ("even", 0.3)])
def test_schedule_slice_matches_jax(schedule, dropout):
    """Three rounds of the LR slice through both packages' build_simulator
    from the same initial weights. float32 SGD sums in another order:
    measured here, losses agree to 1.9e-7 relative and parameters to
    1.9e-8; 1e-5 and 1e-6 leave a margin of 50x."""
    jsim, japply, tsim, tapply = _pair(cohort_schedule=schedule, client_dropout_rate=dropout)
    assert tsim.schedule == schedule
    jh = jsim.run(japply, log_fn=None)
    th = tsim.run(tapply, log_fn=None)
    _assert_runs_match(jsim, jh, tsim, th, param_atol=1e-6)
    if schedule == "packed":
        assert tsim._last_packed_shape == jsim._last_packed_shape


def test_port_packed_and_bucketed_match_port_even():
    """As the JAX package's test_packed_matches_even_sp: the same clients,
    batches and order under every schedule, so the final parameters agree
    to float32 summation order (measured 1.1e-8; the JAX test allows 2e-6)."""
    init = _port_sim(cohort_schedule="even")[0].params
    params = {}
    for schedule in ("even", "packed", "bucketed"):
        sim, apply_fn = _port_sim({k: v.clone() for k, v in init.items()},
                                  cohort_schedule=schedule, epochs=2)
        assert sim.schedule == schedule
        sim.run(apply_fn, log_fn=None)
        params[schedule] = _flat_port(sim)
    for schedule in ("packed", "bucketed"):
        for k, v in params["even"].items():
            np.testing.assert_allclose(params[schedule][k], v, rtol=0, atol=2e-6)


def test_auto_resolves_as_jax():
    """auto on this small population (its batch counts are not skewed: the
    partition keeps every client at ten samples or more) resolves to even,
    with or without the sanitizer or a codec, as in the JAX package; the
    skewed case is the MNIST example below."""
    for kw in (dict(), dict(sanitize_updates=True), dict(comm_codec="q8")):
        jsim, _ = _jax_sim(cohort_schedule="auto", **kw)
        tsim, _ = _port_sim(cohort_schedule="auto", **kw)
        jkind = "packed" if jsim._packed else "bucketed" if jsim._bucketed else "even"
        assert tsim.schedule == jkind == "even"


# --- the North star's example config -------------------------------------------


def test_sp_fedavg_mnist_lr_example_matches_jax():
    """examples/sp_fedavg_mnist_lr/fedml_config.yaml (plain FedAvg, 1000
    clients, alpha 0.5, eval every 5 rounds) through load_arguments(--cf)
    in both packages, with comm_round cut to 3 (evals at rounds 0 and 2).
    Both resolve cohort_schedule auto to packed. The full-size synthetic
    MNIST stand-in: at debug_small_data the 1000 clients hold 1-2 samples
    each, which is not skewed, and auto would resolve to even. Measured:
    losses 7.0e-8 relative, parameters 1.5e-8 (tolerances as above)."""
    over = dict(comm_round=3)
    jargs = fedml_tpu.init(fedml_tpu.load_arguments(args_list=["--cf", MNIST_LR_YAML],
                                                    override=over))
    jsim, japply = jbuild(jargs)
    init = variables_from_jax(jax.tree_util.tree_map(np.asarray, jsim.params))
    targs = fedml_tpu_torch.init(fedml_tpu_torch.load_arguments(
        args_list=["--cf", MNIST_LR_YAML], override=dict(over, device="cpu")))
    tsim, tapply = tbuild(targs, variables=init)
    assert jsim._packed and tsim.schedule == "packed"
    assert tsim.build_round_inputs(1).payload["shape"][0] == 2  # a two-lane round
    jh = jsim.run(japply, log_fn=None)
    th = tsim.run(tapply, log_fn=None)
    assert [("test_acc" in r) for r in th] == [("test_acc" in r) for r in jh] == \
        [True, False, True]
    _assert_runs_match(jsim, jh, tsim, th, param_atol=1e-6)


# --- local tests and the server tester -----------------------------------------

LOCAL = dict(dataset="mnist", model="lr", debug_small_data=True, client_num_in_total=8,
             client_num_per_round=4, comm_round=3, learning_rate=0.1, epochs=1,
             batch_size=10, frequency_of_the_test=2, random_seed=0)


def test_local_test_on_all_clients_matches_jax():
    """The aggregates and per-client vectors at each eval round (the JAX
    package's test_local_eval.py config): float32 sums of per-sample
    losses in another order, measured up to 2.6e-7 relative; 1e-5 leaves a
    margin of 38x."""
    cfg = dict(LOCAL, local_test_on_all_clients=True)
    jsim, japply = jbuild(fedml_tpu.init(config=dict(cfg, prefetch=False)))
    init = variables_from_jax(jax.tree_util.tree_map(np.asarray, jsim.params))
    tsim, tapply = tbuild(fedml_tpu_torch.init(config=dict(cfg, device="cpu")), variables=init)
    jh = jsim.run(japply, log_fn=None)
    th = tsim.run(tapply, log_fn=None)
    evals = [i for i, r in enumerate(jh) if "per_client" in r]
    assert evals == [i for i, r in enumerate(th) if "per_client" in r] == [0, 2]
    for i in evals:
        jr, tr = jh[i], th[i]
        for k in ("local_train_loss", "local_train_acc", "local_test_loss", "local_test_acc"):
            assert tr[k] == pytest.approx(jr[k], rel=1e-5), (k, jr[k], tr[k])
        assert tr["per_client"].keys() == jr["per_client"].keys()
        for k, v in jr["per_client"].items():
            assert len(tr["per_client"][k]) == len(v) == 8
            np.testing.assert_allclose(tr["per_client"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)


class _Tester:
    """A reference-style ServerAggregator: records each call's arguments."""

    def __init__(self, result):
        self.result, self.calls = result, []

    def test_on_the_server(self, train_data_local_dict, test_data_local_dict, device, args):
        self.calls.append((train_data_local_dict, test_data_local_dict, device, args))
        return self.result


def test_server_tester_gets_the_reference_signature():
    """A truthy dict return replaces the default eval and is merged into
    the record; a falsy return keeps it. The hook receives the per-client
    dicts (the same arrays as the JAX package's), the real device and the
    original args, at the JAX package's eval rounds."""
    jt, tt = _Tester({"server_acc": 0.5}), _Tester({"server_acc": 0.5})
    jh = fedml_tpu.run_simulation(args=fedml_tpu.init(config=dict(LOCAL, server_tester=jt)))
    targs = fedml_tpu_torch.init(config=dict(LOCAL, server_tester=tt, device="cpu"))
    th = fedml_tpu_torch.run_simulation(args=targs)
    assert len(tt.calls) == len(jt.calls) == 2
    for tr, jr in zip(th, jh):
        assert ("server_acc" in tr) == ("server_acc" in jr)
        assert "test_acc" not in tr
    train, test, device, args = tt.calls[0]
    jtrain, jtest = jt.calls[0][:2]
    assert device == torch.device("cpu") and args is targs
    assert sorted(train) == sorted(jtrain) and len(train) == len(jtrain) == 8
    for c in jtrain:
        _eq(train[c].x, jtrain[c].x, "train x")
        _eq(train[c].y, jtrain[c].y, "train y")
        assert len(train[c]) == len(jtrain[c])
    # without per-client test indices every client shares the one test pair
    assert len({id(p) for p in test.values()}) == 1 and len(test) == 8
    _eq(test[0].x, jtest[0].x, "test x")
    falsy = _Tester(None)
    th = fedml_tpu_torch.run_simulation(args=fedml_tpu_torch.init(
        config=dict(LOCAL, server_tester=falsy, device="cpu")))
    assert len(falsy.calls) == 2 and all("test_acc" in th[i] for i in (0, 2))


# --- refusals -----------------------------------------------------------------


def test_packed_with_the_sanitizer_or_a_codec_raises_as_jax():
    for kw in (dict(sanitize_updates=True), dict(comm_codec="q8")):
        for schedule in ("packed", "bucketed"):
            with pytest.raises(ValueError, match="incompatible"):
                _jax_sim(cohort_schedule=schedule, **kw)
            with pytest.raises(ValueError, match="incompatible"):
                _port_sim(cohort_schedule=schedule, **kw)


def test_packed_with_a_custom_aggregate_raises_as_jax():
    kw = dict(cohort_schedule="packed", federated_optimizer="FedAvg_robust",
              defense_type="multi_krum")
    with pytest.raises(ValueError, match="packed"):
        _jax_sim(**kw)
    with pytest.raises(ValueError, match="packed"):
        _port_sim(**kw)


@pytest.mark.parametrize("knob", [dict(packed_flat_carry=True),
                                  dict(packed_flat_carry=True, cohort_schedule="packed"),
                                  dict(client_state_spill_dir="spill"),
                                  dict(attack_type="scale")])
def test_unported_schedule_knobs_raise(knob):
    args = fedml_tpu_torch.init(config=dict(BASE, device="cpu", **knob))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fedml_tpu_torch.run_simulation(args=args)
