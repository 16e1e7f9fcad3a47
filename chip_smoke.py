"""Chip smoke test of the PyTorch/CUDA port (fedml_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure ends the run with a
non-zero exit code and no result line:

1. device — the card's name and power limit (nvidia-smi);
2. build — nvcc builds every kernel of the main path from csrc/, in parallel;
3. kernels — each kernel against its plain PyTorch version on the card, at
   the main path's shapes and a few ragged ones, with timings of the
   kernel, the plain version and (where one exists) a library call;
4. small — the main path at a small size on the card against the same run
   on the CPU (plain versions), as a reference check;
5. main — the main path through fedml_tpu_torch.init + run_simulation:
   robust FedAvg (q8 codec, sanitizer, multi-Krum, agg_kernels) on
   cnn_fedavg at full width, MNIST shapes, 1000 clients, 10 per round,
   5 rounds, with every kernel's launch count read around the run;
6. profile — torch.profiler over three warm rounds of the main config:
   device busy and idle share per round, top kernels.

Then a ``kernels`` JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX or fedml_tpu.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
QUANT_OPS_PER_ELEM = 25     # hash, divide, add, floor, clip, multiply per element
# cnn_fedavg's compressible leaves (>= 64 elements), in leaf order
MAIN_LEAF_M = (800, 51200, 64, 1605632, 512, 5120)
MAIN_C = 10
# Gram: |G_kernel - G_plain|_ij / sqrt(G_ii G_jj). fp32 sums of up to ~8e3
# terms in another order differ by ~eps * sqrt(n) ~ 5e-6 of the row norms;
# 4x margin.
GRAM_TOL = 2e-5


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def time_ms(fn, reps=20, rounds=5):
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def phase_build():
    from fedml_tpu_torch.ops import KERNELS, _build

    t = time.perf_counter()
    report = _build.build(KERNELS)
    ptxas = {k: [ln for ln in v["ptxas"].splitlines() if "registers" in ln or "spill" in ln]
             for k, v in report.items()}
    emit("build", seconds=time.perf_counter() - t, ptxas=ptxas)


def check_quant(dev):
    """Kernel 1 == plain version: packed bytes and scales equal, dec
    bit-equal. Returns the kernel's entry for the kernels line."""
    from fedml_tpu_torch.comm.codec import _leaf_hash
    from fedml_tpu_torch.ops import agg_quant as aq

    gen = torch.Generator().manual_seed(0)
    shapes = [(MAIN_C, m) for m in MAIN_LEAF_M] + [(13, 1000)]
    for bits in (8, 4):
        for i, (C, m) in enumerate(shapes):
            vals = torch.randn(C, m, generator=gen).to(dev) * 0.01
            vals[0, :300] = 0.0  # an all-zero chunk takes scale 1.0
            cids = torch.arange(7, 7 + C, dtype=torch.int32, device=dev) * 37
            lh = _leaf_hash(f"params/leaf_{i}/kernel")
            pk, sk, dk = aq.quantize_pack(vals, bits, 3, 4, cids, lh)
            pp, sp, dp = aq.quantize_pack_plain(vals, bits, 3, 4, cids, lh)
            torch.cuda.synchronize()
            if not (torch.equal(pk, pp) and torch.equal(sk, sp)
                    and torch.equal(dk.view(torch.int32), dp.view(torch.int32))):
                raise AssertionError(
                    f"quantize_pack q{bits} at {(C, m)} differs from its plain version: "
                    f"{(pk != pp).sum().item()} bytes, {(dk != dp).sum().item()} dec values")
    # one round's codec work on the main path: q8 over the six leaves, C=10
    stacks = [torch.randn(MAIN_C, m, generator=gen).to(dev) * 0.01 for m in MAIN_LEAF_M]
    cids = torch.arange(MAIN_C, dtype=torch.int32, device=dev)

    def run(f):
        return lambda: [f(v, 8, 3, 4, cids, 99) for v in stacks]

    elems = MAIN_C * sum(MAIN_LEAF_M)
    nbytes = elems * 4 + MAIN_C * 4 + elems * (1 + 4) + \
        MAIN_C * sum(-(-m // 256) for m in MAIN_LEAF_M) * 4
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = elems * QUANT_OPS_PER_ELEM / FP32_OPS_PER_S * 1e3
    kernel_ms, plain_ms = time_ms(run(aq.quantize_pack)), time_ms(run(aq.quantize_pack_plain))
    entry = {"name": "quantize_pack", "route": "cuda", "source": "fedml_tpu_torch/csrc/agg_quant.cu",
             "replaces": "fedml_tpu/ops/pallas/agg_quant.py:174",
             "max_abs_err": 0.0, "ms": kernel_ms, "plain_ms": plain_ms,
             "bound_ms": max(bound_bytes, bound_ops),
             "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
             "library_ms": None, "bytes": nbytes}
    emit("kernel_quantize_pack", shapes=shapes, bits=[8, 4], equal=True,
         timed="q8, six cnn_fedavg leaves, C=10", **entry)
    return entry


def check_gram(dev):
    """Kernel 2 within GRAM_TOL of the plain version (normalised by the
    row norms); timings at the main path's shape."""
    from fedml_tpu_torch.ops import agg_robust as ar

    gen = torch.Generator().manual_seed(1)
    entry = None
    for C, D in ((MAIN_C, 1663370), (100, 65536), (1000, 7850), (13, 1000)):
        flat = (torch.randn(C, D, generator=gen) * 0.01).to(dev)
        gk = ar.gram(flat)
        gp = ar.gram_plain(flat)
        torch.cuda.synchronize()
        d = torch.sqrt(torch.diagonal(gp))
        rel = ((gk - gp).abs() / (d[:, None] * d[None, :])).max().item()
        abs_err = (gk - gp).abs().max().item()
        if not rel <= GRAM_TOL:
            raise AssertionError(f"gram at {(C, D)}: normalised error {rel} > {GRAM_TOL}")
        if not torch.equal(gk, ar.gram(flat)):
            raise AssertionError(f"gram at {(C, D)} is not repeatable")
        bound_bytes = (C * D + C * C) * 4 / HBM_BYTES_PER_S * 1e3
        bound_ops = 2 * C * C * D / FP32_OPS_PER_S * 1e3
        row = {"ms": time_ms(lambda: ar.gram(flat)),
               "plain_ms": time_ms(lambda: ar.gram_plain(flat)),
               "library_ms": time_ms(lambda: torch.matmul(flat, flat.t())),
               "bound_ms": max(bound_bytes, bound_ops),
               "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
               "max_abs_err": abs_err}
        emit("kernel_gram", shape=[C, D], splits=ar.split_plan(C, D)[1],
             normalised_err=rel, tol=GRAM_TOL, **row)
        if entry is None:
            entry = {"name": "gram", "route": "cuda",
                     "source": "fedml_tpu_torch/csrc/agg_robust.cu",
                     "replaces": "fedml_tpu/ops/pallas/agg_robust.py:71", **row}
    return entry


def check_fused_krum(dev):
    """fused_sanitize_krum on the card (Gram kernel) vs on the CPU (plain
    Gram) with one NaN row and one x10-boosted row."""
    from fedml_tpu_torch.core.robust import RobustAggregator, fused_sanitize_krum

    rng = np.random.default_rng(2)
    C = MAIN_C
    shapes = {"params/a/kernel": (C, 3136, 512), "params/b/bias": (C, 512),
              "params/c/kernel": (C, 512, 10)}
    tree = {k: rng.standard_normal(s).astype(np.float32) * 0.01 for k, s in shapes.items()}
    tree["params/b/bias"][2, 5] = np.nan
    for v in tree.values():
        v[6] *= 10.0
    w = rng.integers(20, 80, C).astype(np.float32)
    f, m = RobustAggregator("multi_krum")._krum_fm(C)
    out = {}
    for d in (dev, torch.device("cpu")):
        t = {k: torch.from_numpy(v).to(d) for k, v in tree.items()}
        agg, cw, q, z, sel = fused_sanitize_krum(t, torch.from_numpy(w).to(d), 6.0, f, m)
        out[d.type] = (q.cpu(), sel.cpu(), {k: a.cpu() for k, a in agg.items()})
    (qg, sg, ag), (qc, sc, ac) = out["cuda"], out["cpu"]
    if not (torch.equal(qg, qc) and torch.equal(sg, sc)):
        raise AssertionError(f"fused_sanitize_krum: quarantine {qg} vs {qc}, selected {sg} vs {sc}")
    if not (bool(qg[2]) and bool(qg[6])):
        raise AssertionError(f"NaN row 2 and boosted row 6 must be quarantined: {qg}")
    err = max((ag[k] - ac[k]).abs().max().item() for k in ag)
    if not err <= 1e-6:
        raise AssertionError(f"fused_sanitize_krum aggregate differs by {err}")
    emit("fused_sanitize_krum", quarantine=qg.nonzero().flatten().tolist(),
         selected=sg.nonzero().flatten().tolist(), agg_max_abs_err=err)


def small_config(device):
    return dict(dataset="mnist", model="lr", debug_small_data=True, client_num_in_total=10,
                client_num_per_round=10, comm_round=3, learning_rate=0.1, batch_size=10,
                frequency_of_the_test=1, federated_optimizer="FedAvg_robust",
                defense_type="multi_krum", sanitize_updates=True, comm_codec="q8",
                agg_kernels=True, random_seed=0, device=device)


def phase_small():
    """The whole slice at a small size on the card vs on the CPU."""
    import fedml_tpu_torch as ft

    hist = {}
    for device in ("cuda", "cpu"):
        hist[device] = ft.run_simulation(args=ft.init(config=small_config(device)))
    for rg, rc in zip(hist["cuda"], hist["cpu"]):
        if rg["quarantined"] != rc["quarantined"]:
            raise AssertionError(f"quarantine differs: {rg} vs {rc}")
        # ~1e-6 loss drift from reduction order moves few stochastic floors
        for k in ("train_loss", "test_loss"):
            if not abs(rg[k] - rc[k]) <= 1e-3 * max(1.0, abs(rc[k])):
                raise AssertionError(f"{k} differs: {rg[k]} vs {rc[k]}")
    emit("small", cuda=[(r["train_loss"], r["test_acc"]) for r in hist["cuda"]],
         cpu=[(r["train_loss"], r["test_acc"]) for r in hist["cpu"]])


MAIN_CONFIG = dict(
    dataset="mnist", model="cnn_fedavg", client_num_in_total=1000, client_num_per_round=10,
    batch_size=10, learning_rate=0.03, epochs=1, partition_method="hetero",
    partition_alpha=0.5, federated_optimizer="FedAvg_robust", defense_type="multi_krum",
    sanitize_updates=True, comm_codec="q8", agg_kernels=True, comm_round=5,
    frequency_of_the_test=5, random_seed=0, device="cuda")


def phase_main():
    import fedml_tpu_torch as ft
    from fedml_tpu_torch.ops import agg_quant, agg_robust

    args = ft.init(config=dict(MAIN_CONFIG))
    agg_quant.quantize_pack.launches = 0
    agg_robust.gram.launches = 0
    t = time.perf_counter()
    hist = ft.run_simulation(args=args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {"quantize_pack": agg_quant.quantize_pack.launches,
                "gram": agg_robust.gram.launches}
    rounds = MAIN_CONFIG["comm_round"]
    if launches != {"quantize_pack": 6 * rounds, "gram": rounds}:
        raise AssertionError(f"main path launches {launches}, expected 6 and 1 per round")
    losses = [r["train_loss"] for r in hist]
    if len(hist) != rounds or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"main path history not finite: {losses}")
    last = hist[-1]
    if not (math.isfinite(last["test_loss"]) and 0.0 <= last["test_acc"] <= 1.0):
        raise AssertionError(f"bad eval record {last}")
    emit("main", config=MAIN_CONFIG, wall_s=wall, train_loss=losses,
         test_acc=last["test_acc"], test_loss=last["test_loss"],
         quarantined=[r["quarantined"] for r in hist],
         round_time_after_first_s=[r["round_time"] for r in hist[1:]],
         launches=launches, peak_mem_bytes=torch.cuda.max_memory_allocated())
    return launches


def phase_profile(rounds=3):
    """Where a main-path round's time goes: torch.profiler over ``rounds``
    warm rounds of the main config (no eval). Device busy time is the sum
    of the kernels' self device time (one stream, so they do not overlap);
    the idle share is 1 - busy / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import fedml_tpu_torch as ft
    from fedml_tpu_torch.simulation import build_simulator

    sim, _ = build_simulator(ft.init(config=dict(MAIN_CONFIG, comm_round=rounds)))
    sim.run(None, log_fn=None)  # warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        sim.run(None, log_fn=None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only: a CPU op's row repeats its kernels' time
    rows = sorted(((e.key, dev_us(e), e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    ours = {k: sum(r[1] for r in rows if k in r[0]) / 1e3 / rounds
            for k in ("quantize_pack_kernel", "gram_partial_kernel", "gram_reduce_kernel")}
    emit("profile", rounds=rounds, wall_ms_per_round=wall * 1e3 / rounds,
         device_busy_ms_per_round=busy_ms / rounds, idle_share=1.0 - busy_ms / (wall * 1e3),
         our_kernels_ms_per_round=ours,
         top=[{"kernel": k[:90], "ms_per_round": us / 1e3 / rounds, "calls_per_round": n / rounds}
              for k, us, n in rows[:10]])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()
    entries = [check_quant(dev), check_gram(dev)]
    check_fused_krum(dev)
    phase_small()
    launches = phase_main()
    phase_profile()
    for e in entries:
        e["launches"] = launches[e["name"]]
        e.pop("bytes", None)
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
