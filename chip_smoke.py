"""Chip smoke test of the PyTorch/CUDA port (fedml_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase below
    python3 chip_smoke.py kernels    # phases 1-3 only (no result line)

Phases, each printing one JSON line; any failure ends the run with a
non-zero exit code and no result line:

1. device — the card's name and power limit (nvidia-smi);
2. build — nvcc builds every kernel of the port from csrc/, in parallel;
3. kernels — each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and a few ragged ones, with timings of the
   kernel, the plain version and (where one exists) a library call: the
   codec's quantize_pack, the Gram plane, the 3x3 multi-weight conv
   forward (conv3x3, also dx) and its weight gradient (conv3x3_dw);
4. small — the robust FedAvg path at a small size on the card against the
   same run on the CPU (plain versions), as a reference check;
5. main — the robust FedAvg path through fedml_tpu_torch.init +
   run_simulation: q8 codec, sanitizer, multi-Krum, agg_kernels on
   cnn_fedavg at full width, MNIST shapes, 1000 clients, 10 per round,
   5 rounds, with every kernel's launch count read around the run;
6. profile — torch.profiler over three warm rounds of the main config:
   device busy and idle share per round, top kernels;
7. small_resnet — resnet8 FedAvg on small cifar10 (conv_impl pallas) on the
   card against the same run on the CPU;
8. resnet_main — the CIFAR-10 ResNet-56 FedAvg example config
   (examples/tpu_fedavg_cifar10_resnet56) through load_arguments + init +
   run_simulation with conv_impl pallas, full width and depth, 3 rounds of
   one epoch; the conv kernels' launch counts must equal those derived
   from the config;
9. resnet_profile — torch.profiler over two warm ResNet-56 rounds.

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
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

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
# conv: |y_kernel - y_plain| / (the same product on |x|, |w|), elementwise.
# Each output sums at most 9*Ci (forward) or B*H*W (dw) fp32 products in
# another order than the plain version's; each partial sum rounds by at most
# 6e-8 of the magnitudes, and an H100 measured <= 3.1e-7. 1e-5
# leaves margin yet catches a wrong tap or channel (an error of O(1)).
CONV_TOL = 1e-5
# (L, B, H, W, Ci, Co) of the stride-1 3x3 convs of ResNet-56's local step
# (10 clients x batch 64): the stem, then one shape per stage
CONV_MAIN = ((10, 64, 32, 32, 3, 16), (10, 64, 32, 32, 16, 16),
             (10, 64, 16, 16, 32, 32), (10, 64, 8, 8, 64, 64))
CONV_EXTRA = ((1, 256, 32, 32, 16, 16),   # eval: no lanes, batch 256
              (3, 5, 7, 9, 5, 7))         # ragged channels, odd sizes
CONV_REPORTED = CONV_MAIN[1]  # the kernels line's shape: 18 of the 53 per step


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


def profile_rounds(sim, rounds, ours):
    """torch.profiler over ``sim.run`` of ``rounds`` rounds (no eval).
    Device busy time is the sum of the kernels' self device time (one
    stream, so they do not overlap); the idle share is 1 - busy / wall.
    ``ours`` names kernels whose ms per round are reported."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    return dict(rounds=rounds, wall_ms_per_round=wall * 1e3 / rounds,
                device_busy_ms_per_round=busy_ms / rounds,
                idle_share=1.0 - busy_ms / (wall * 1e3),
                our_kernels_ms_per_round={
                    k: sum(r[1] for r in rows if k in r[0]) / 1e3 / rounds for k in ours},
                top=[{"kernel": k[:90], "ms_per_round": us / 1e3 / rounds,
                      "calls_per_round": n / rounds} for k, us, n in rows[:10]])


def phase_profile(rounds=3):
    """Where a main-path round's time goes: three warm rounds of the main
    config after a warm-up run."""
    import fedml_tpu_torch as ft
    from fedml_tpu_torch.simulation import build_simulator

    sim, _ = build_simulator(ft.init(config=dict(MAIN_CONFIG, comm_round=rounds)))
    sim.run(None, log_fn=None)  # warm-up
    emit("profile", **profile_rounds(sim, rounds, (
        "quantize_pack_kernel", "gram_partial_kernel", "gram_reduce_kernel")))


def _conv_case(shape, gen, dev):
    L, B, H, W, ci, co = shape
    x = torch.randn(L, B, H, W, ci, generator=gen).to(dev)
    w = (torch.randn(L, 3, 3, ci, co, generator=gen) * 0.3).to(dev)
    dy = torch.randn(L, B, H, W, co, generator=gen).to(dev)
    # the same tensors as the grouped NCHW conv that vmap hands cuDNN
    xn = x.permute(1, 0, 4, 2, 3).reshape(B, L * ci, H, W).contiguous()
    wn = w.permute(0, 4, 3, 1, 2).reshape(L * co, ci, 3, 3).contiguous()
    dyn = dy.permute(1, 0, 4, 2, 3).reshape(B, L * co, H, W).contiguous()
    return x, w, dy, xn, wn, dyn


def _normalised_err(got, want, mag):
    return ((got - want).abs() / mag.clamp_min(1e-30)).max().item()


def _conv_ops(shape):
    """Operations (2 per multiply-add) of a 3x3 SAME conv, or of its weight
    gradient, counting only the taps that read the image: along an axis of
    n pixels, 3n - 2 of the 3n (pixel, tap) pairs fall inside it and the
    other two read the zero padding, which the function does not need."""
    L, B, H, W, ci, co = shape
    return 2 * L * B * ci * co * (3 * H - 2) * (3 * W - 2)


def _bound(ops, nbytes):
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(b, o), "bound_by": "bytes" if b >= o else "operations"}


def check_conv(dev):
    """Kernel 3a (forward, also dx) within CONV_TOL of the plain version at
    the main path's four shapes, the eval shape, a ragged one and a
    lane-broadcast w; timings beside cuDNN's grouped conv."""
    from fedml_tpu_torch.ops import conv as C

    gen = torch.Generator().manual_seed(3)
    entry = None
    for shape in CONV_MAIN + CONV_EXTRA:
        L, B, H, W, ci, co = shape
        x, w, _, xn, wn, _ = _conv_case(shape, gen, dev)
        y = C.conv3x3_lanes(x, w)
        yp = C.conv3x3_plain(x, w)
        err = _normalised_err(y, yp, C.conv3x3_plain(x.abs(), w.abs()))
        lib = F.conv2d(xn, wn, padding=1, groups=L)
        lib_err = _normalised_err(lib.reshape(B, L, co, H, W).permute(1, 0, 3, 4, 2), yp,
                                  C.conv3x3_plain(x.abs(), w.abs()))
        if not (err <= CONV_TOL and lib_err <= CONV_TOL):
            raise AssertionError(f"conv3x3 at {shape}: normalised error {err} "
                                 f"(cuDNN {lib_err}) > {CONV_TOL}")
        ops = _conv_ops(shape)
        nbytes = (L * B * H * W * (ci + co) + L * 9 * ci * co) * 4
        row = {"ms": time_ms(lambda: C.conv3x3_lanes(x, w)),
               "plain_ms": time_ms(lambda: C.conv3x3_plain(x, w)),
               "library_ms": time_ms(lambda: F.conv2d(xn, wn, padding=1, groups=L)),
               "max_abs_err": (y - yp).abs().max().item(), **_bound(ops, nbytes)}
        emit("kernel_conv3x3", shape=list(shape), normalised_err=err, tol=CONV_TOL,
             library_normalised_err=lib_err, gflop=ops / 1e9, **row)
        if shape == CONV_REPORTED:
            entry = {"name": "conv3x3", "route": "cuda",
                     "source": "fedml_tpu_torch/csrc/conv3x3.cu",
                     "replaces": "fedml_tpu/ops/conv.py:181", **row}
            # the first local step: every lane shares the global weights
            wb = w[:1].expand_as(w)
            err_b = _normalised_err(C.conv3x3_lanes(x, wb), C.conv3x3_plain(x, wb),
                                    C.conv3x3_plain(x.abs(), wb.abs()))
            if not err_b <= CONV_TOL:
                raise AssertionError(f"conv3x3 with a broadcast w: {err_b} > {CONV_TOL}")
            emit("kernel_conv3x3", shape=list(shape), w_lanes=1, normalised_err=err_b)
    return entry


def check_conv_dw(dev):
    """Kernel 3b (weight gradient) within CONV_TOL of the plain version and
    bit-equal across two calls, at the same shapes; cuDNN's grouped
    weight-gradient call beside it."""
    from fedml_tpu_torch.ops import conv as C

    gen = torch.Generator().manual_seed(4)
    entry = None
    for shape in CONV_MAIN + CONV_EXTRA:
        L, B, H, W, ci, co = shape
        x, w, dy, xn, wn, dyn = _conv_case(shape, gen, dev)
        dw = C.conv3x3_dw_lanes(x, dy)
        dwp = C.conv3x3_dw_plain(x, dy)
        mag = C.conv3x3_dw_plain(x.abs(), dy.abs())
        err = _normalised_err(dw, dwp, mag)

        def lib_call():
            return torch.nn.grad.conv2d_weight(xn, wn.shape, dyn, padding=1, groups=L)

        lib_err = _normalised_err(lib_call().reshape(L, co, ci, 3, 3).permute(0, 3, 4, 2, 1),
                                  dwp, mag)
        if not (err <= CONV_TOL and lib_err <= CONV_TOL):
            raise AssertionError(f"conv3x3_dw at {shape}: normalised error {err} "
                                 f"(cuDNN {lib_err}) > {CONV_TOL}")
        if not torch.equal(dw, C.conv3x3_dw_lanes(x, dy)):
            raise AssertionError(f"conv3x3_dw at {shape} is not repeatable")
        ops = _conv_ops(shape)
        nbytes = (L * B * H * W * (ci + co) + L * 9 * ci * co) * 4
        row = {"ms": time_ms(lambda: C.conv3x3_dw_lanes(x, dy)),
               "plain_ms": time_ms(lambda: C.conv3x3_dw_plain(x, dy)),
               "library_ms": time_ms(lib_call),
               "max_abs_err": (dw - dwp).abs().max().item(), **_bound(ops, nbytes)}
        emit("kernel_conv3x3_dw", shape=list(shape),
             splits=C.dw_split_plan(L, B * H * W, ci, co)[1], normalised_err=err,
             tol=CONV_TOL, library_normalised_err=lib_err, repeatable=True,
             gflop=ops / 1e9, **row)
        if shape == CONV_REPORTED:
            entry = {"name": "conv3x3_dw", "route": "cuda",
                     "source": "fedml_tpu_torch/csrc/conv3x3.cu",
                     "replaces": "fedml_tpu/ops/conv.py:226", **row}
    return entry


def small_resnet_config(device):
    return dict(dataset="cifar10", model="resnet8", conv_impl="pallas",
                cohort_schedule="even", debug_small_data=True, client_num_in_total=8,
                client_num_per_round=4, comm_round=2, learning_rate=0.05, batch_size=32,
                frequency_of_the_test=1, random_seed=0, device=device)


def phase_small_resnet():
    """resnet8 FedAvg with conv_impl pallas on the card (the conv kernels)
    vs on the CPU (their plain versions)."""
    import fedml_tpu_torch as ft

    hist = {}
    for device in ("cuda", "cpu"):
        hist[device] = ft.run_simulation(args=ft.init(config=small_resnet_config(device)))
    for rg, rc in zip(hist["cuda"], hist["cpu"]):
        # fp32 conv and GroupNorm sums in another order: ~1e-6 per SGD step,
        # grown through 2 rounds of 5 steps; measured 1.4e-4 between an H100
        # and the CPU (the CPU tests measure ~5e-5 between the port and
        # JAX), so 5e-4 relative leaves a 3x margin
        for k in ("train_loss", "test_loss"):
            if not abs(rg[k] - rc[k]) <= 5e-4 * max(1.0, abs(rc[k])):
                raise AssertionError(f"small_resnet {k} differs: {rg[k]} vs {rc[k]}")
        if not abs(rg["test_acc"] - rc["test_acc"]) <= 1.0 / 200 + 1e-9:  # one of 200
            raise AssertionError(f"small_resnet test_acc differs: {rg} vs {rc}")
    emit("small_resnet", cuda=[(r["train_loss"], r["test_loss"], r["test_acc"]) for r in hist["cuda"]],
         cpu=[(r["train_loss"], r["test_loss"], r["test_acc"]) for r in hist["cpu"]])


RESNET_YAML = Path(__file__).resolve().parent / \
    "examples/tpu_fedavg_cifar10_resnet56/fedml_config.yaml"
# cut: 1 epoch instead of 20, 3 rounds instead of 100. The port runs one
# card with the sp engine (the YAML's backend: TPU mesh is not ported),
# only the even cohort schedule, and no checkpointing yet.
RESNET_OVERRIDES = dict(conv_impl="pallas", cohort_schedule="even", checkpoint_dir=None,
                        epochs=1, comm_round=3, frequency_of_the_test=3, backend="sp",
                        device="cuda")


def resnet_args(**extra):
    from fedml_tpu_torch import load_arguments

    return load_arguments(args_list=["--cf", str(RESNET_YAML)],
                          override=dict(RESNET_OVERRIDES, **extra))


def phase_resnet_main():
    """ResNet-56 FedAvg through load_arguments + init + run_simulation. The
    conv kernels' launches must equal what the config implies: per local
    step, one forward per stride-1 3x3 conv, one dx per such conv but the
    stem (its input, the data, needs no gradient) and one dw per conv; per
    eval, one forward per conv and test batch of 256."""
    import fedml_tpu_torch as ft
    from fedml_tpu_torch import data as data_mod
    from fedml_tpu_torch import models as models_mod
    from fedml_tpu_torch.ops import conv as C
    from fedml_tpu_torch.simulation.fed_sim import EVAL_BATCH_SIZE

    args = ft.init(resnet_args())
    fed, classes = data_mod.load(args)  # the partition, to derive the counts
    sizes = [len(v) for v in fed._global_index.values()]
    steps_per_round = int(args.epochs) * -(-max(sizes) // int(args.batch_size))
    model = models_mod.create(args, classes, tuple(fed.train_data_global.x.shape[1:]))
    convs = sum(1 for m in model.modules() if isinstance(m, C.Conv)
                and m.impl == "pallas" and m.stride == 1 and tuple(m.kernel.shape[:2]) == (3, 3))
    rounds, freq = int(args.comm_round), int(args.frequency_of_the_test)
    evals = sum(1 for r in range(rounds) if r % freq == 0 or r == rounds - 1)
    eval_batches = -(-len(fed.test_data_global.y) // EVAL_BATCH_SIZE)
    steps = rounds * steps_per_round
    want = {"conv3x3": steps * (convs + convs - 1) + evals * eval_batches * convs,
            "conv3x3_dw": steps * convs}
    del fed, model

    args = ft.init(resnet_args())  # re-seed: the partition above drew from numpy
    torch.cuda.reset_peak_memory_stats()
    C.conv3x3_lanes.launches = 0
    C.conv3x3_dw_lanes.launches = 0
    t = time.perf_counter()
    hist = ft.run_simulation(args=args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {"conv3x3": C.conv3x3_lanes.launches, "conv3x3_dw": C.conv3x3_dw_lanes.launches}
    if launches != want:
        raise AssertionError(f"resnet main path launches {launches}, expected {want} "
                             f"({convs} convs, {steps} steps, {evals} evals)")
    losses = [r["train_loss"] for r in hist]
    if len(hist) != rounds or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"resnet main path history not finite: {losses}")
    evals_seen = [r for r in hist if "test_acc" in r]
    if len(evals_seen) != evals or not all(
            math.isfinite(r["test_loss"]) and 0.0 <= r["test_acc"] <= 1.0 for r in evals_seen):
        raise AssertionError(f"bad eval records {evals_seen}")
    emit("resnet_main", config=str(RESNET_YAML.relative_to(RESNET_YAML.parents[2])),
         overrides=RESNET_OVERRIDES, convs_3x3_s1=convs, steps_per_round=steps_per_round,
         evals=evals, eval_batches=eval_batches, wall_s=wall, train_loss=losses,
         train_acc=[r["train_acc"] for r in hist],
         test=[(r["round"], r["test_loss"], r["test_acc"]) for r in evals_seen],
         round_time_s=[r["round_time"] for r in hist], launches=launches,
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    return launches


def phase_resnet_profile(rounds=2):
    """Where a ResNet-56 round's time goes: two warm rounds after a warm-up
    run of the same simulator."""
    import fedml_tpu_torch as ft
    from fedml_tpu_torch.simulation import build_simulator

    sim, _ = build_simulator(ft.init(resnet_args(comm_round=rounds)))
    sim.run(None, log_fn=None)  # warm-up
    emit("resnet_profile", **profile_rounds(sim, rounds, (
        "conv3x3_fwd_kernel", "conv3x3_dw_partial_kernel", "conv3x3_dw_reduce_kernel")))


def main(argv):
    if argv not in ([], ["kernels"]):
        print("usage: python3 chip_smoke.py [kernels]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()
    entries = [check_quant(dev), check_gram(dev), check_conv(dev), check_conv_dw(dev)]
    if argv == ["kernels"]:
        return 0
    check_fused_krum(dev)
    phase_small()
    launches = phase_main()
    phase_profile()
    phase_small_resnet()
    launches.update(phase_resnet_main())
    phase_resnet_profile()
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
    sys.exit(main(sys.argv[1:]))
