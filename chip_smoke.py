"""Chip smoke test of the PyTorch/CUDA port (fedml_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase below
    python3 chip_smoke.py kernels    # phases 1-3 only (no result line)
    python3 chip_smoke.py agg [DIR]  # the robust path's aggregation half only,
                                     # of the package in checkout DIR (no result line)
    python3 chip_smoke.py flash [DIR]  # flash's kernel times, bf16 at Dh 512,
                                       # 384, 256, 64 and 128 and float32 at
                                       # Dh 512, 384, 256 and 128, of the package
                                       # in checkout DIR (no result line)
    python3 chip_smoke.py conv [DIR]   # the bf16 conv forward's times (beside
                                       # cuDNN's) and weight gradient's at the
                                       # ResNet-56 shapes, of the package in
                                       # checkout DIR (no result line)
    python3 chip_smoke.py resnet_bf16 [DIR]  # resnet_bf16 (launches by route and
                                             # shape, a profiled round) alone,
                                             # likewise
    python3 chip_smoke.py lm_f32 [DIR] # lm_wide_f32 and its profile on the
                                       # package in checkout DIR (no result
                                       # line)
    python3 chip_smoke.py lm_mid [DIR] # lm_mid_f32 and its profile, likewise
    python3 chip_smoke.py lm_xl [DIR]  # lm_xl and its profile, likewise
    python3 chip_smoke.py lm_xl_f32 [DIR]  # lm_xl_f32 and its profile, likewise
    python3 chip_smoke.py lm_xxl [DIR]  # lm_xxl and its profile, likewise
    python3 chip_smoke.py lm_xxl_f32 [DIR]  # lm_xxl_f32 and its profile, likewise

Phases, each printing one JSON line; any failure ends the run with a
non-zero exit code and no result line:

1. device — the card's name and power limit (nvidia-smi);
2. build — nvcc builds every kernel of the port from csrc/, in parallel,
   and csrc/tc_rate.cu; tc_rate — the TF32 and bf16 rates mma.sync
   reaches on this card (the float32 and bf16 conv forwards'
   instructions), against the dense peaks the bounds count, the TF32
   rate of wgmma.m64nNk8 at N 16, 32 and 64 with A from shared memory or
   from registers (the float32 Dh-128 backward's instruction), and the
   cluster probe (cluster_exchange: the exchange of the float32 Dh-512
   clusters alone, in the pull form and in the kernels' own,
   beside the clusters the card holds at once);
3. kernels — each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and a few ragged ones, with timings of the
   kernel, the plain version and (where one exists) a library call: the
   codec's quantize_pack (also on stacks of special values; its time is
   device time per round of six calls, with the host-paced CUDA-event time
   and the host time per call beside), the Gram plane (both routes, small
   C <= 16 and tiled; device time), the 3x3 multi-weight conv
   forward (conv3x3, also dx: ResNet's block convs on the tensor cores in
   three TF32 products, the others on the FMA kernel, whose time at the
   block shapes is reported beside as was_ms) and its weight gradient
   (conv3x3_dw), both at L = 1, 2 (the packed schedule's lanes) and 10
   (the even schedule's clients), the stem (conv3x3_stem: its float32
   forward on a tensor-core kernel of its own, three TF32 products, with
   the FMA kernel's time beside as was_ms and its launch plan read back
   from the card), the same in bf16 (use_bf16:
   conv3x3_bf16 and conv3x3_dw_bf16, the block convs' forward and weight
   gradient on bf16 tensor-core kernels, the latter with the FMA kernel's
   time beside as was_ms, and conv3x3_stem_bf16, the stem's forward on a
   tensor-core kernel of its own, with the FMA kernel's time beside as
   was_ms; the tensor-core forwards' launch plans read back from the card
   and held to their Python mirror; within one bf16 step of the rounded
   plain value, with cuDNN's bf16 calls as the library yardstick), both
   again under two
   vmap levels (DP-SGD's per-example gradients), and
   flash attention's forward, dq and dk/dv (flash_fwd, flash_dq,
   flash_dkv; SDPA as the library call, with the backend it ran; bf16
   inputs on the tensor cores, float32 on flash_f32_sm90.cu's three TF32
   products at Dh 256, for dk/dv at Dh 384 and for the forward at Dh 128
   and 384, on flash_f32_wgmma_sm90.cu's for dq and dk/dv at Dh 128 and, as
   clusters of four blocks, for all three at Dh 512, and for dq, as clusters of three
   blocks, at Dh 384 (the resident clusters of both printed), on the FMA
   kernels at Dh 64), at Dh 64 (the _f32 entries at small_lm's shape), at
   Dh 128 (the _dh128_f32 entries at small_lm_128's shape and the
   _dh128_f32_mid ones at lm_mid_f32's: the forward on flash_f32_sm90.cu,
   dq and dk/dv on flash_f32_wgmma_sm90.cu, each with the FMA kernels' time
   beside as was_ms) and at Dh 256 (the _dh256 entries at the wide LM's bf16
   shape, on flash_dh256_sm90.cu; the _dh256_f32 ones at lm_wide_f32's
   shape and the _dh256_f32_small ones at small_lm_256's, all three on
   flash_f32_sm90.cu; the _dh384 entries at lm_xl's bf16 shape, on
   flash_dh384_sm90.cu; the _dh384_f32 ones at lm_xl_f32's shape and the
   _dh384_f32_small ones at small_lm_384_f32's, dq on the three-block
   clusters with flash_f32_sm90.cu's mma.sync kernel timed beside as
   was_ms, the forward and dk/dv on flash_f32_sm90.cu; their column parts
   at Dh 384 are also held bit-equal on inputs with repeated column
   parts; the _dh512 entries at lm_xxl's bf16 shape and the
   _dh1536_small ones at small_lm_1536's, on flash_wide_sm90.cu, checked at
   all nine of its head dims (512 ... 1536), each timed at one causal head
   of T 4224, its column slices held bit-equal on inputs whose slices
   repeat; the _dh512_f32 entries at lm_xxl_f32's shape (all three on
   flash_f32_wgmma_sm90.cu's clusters, with the mma.sync kernels' time
   beside as was_ms: the forward's, flash_wide_f32_sm90.cu's, timed in
   this run through its C entry) and the
   _dh896_f32_small ones at small_lm_896_f32's, on flash_wide_f32_sm90.cu,
   checked at its four head dims (512 ... 896), timed at one head of T
   4224, causal and full, its warps' (and clusters') column parts held
   bit-equal; each
   swept head dim with its bound and SDPA's times); each redesigned kernel
   with the earlier design's time as was_ms;
4. small — the robust FedAvg path at a small size on the card against the
   same run on the CPU (plain versions), as a reference check;
4b. repeat — the small robust path on cnn_fedavg, the small resnet8 path,
   DP-SGD with noise, weak DP and the dropout CNN each run twice on the
   card: every round's train_loss and the final global parameters must be
   bit-equal;
5. main — the robust FedAvg path through fedml_tpu_torch.init +
   run_simulation: q8 codec, sanitizer, multi-Krum, agg_kernels on
   cnn_fedavg at full width, MNIST shapes, 1000 clients, 10 per round,
   5 rounds, with every kernel's launch count read around the run;
6. profile — torch.profiler over three warm rounds of the main config:
   device busy and idle share per round, top kernels; then the same with
   cuDNN's nondeterministic algorithms allowed, for what determinism costs;
7. mnist_lr_main — the North star's example config
   (examples/sp_fedavg_mnist_lr, plain FedAvg on lr, 1000 clients) through
   load_arguments(--cf) with only device and comm_round (10) set: its
   cohort schedule resolves to packed; no kernel of the port runs; the same
   run on the CPU agrees;
8. small_resnet — resnet8 FedAvg on small cifar10 (conv_impl pallas) under
   the even, packed and bucketed schedules on the card against the same
   runs on the CPU;
8b. small_bn — resnet8 with BatchNorm under even and bucketed, and with
   BatchNorm in bf16, on the card against the CPU; the dropout CNN's final
   card model evaluated on the CPU as on the card;
8c. resume — resnet8 (FedAvg packed, SCAFFOLD, FedOpt adam, BatchNorm) on
   the card, interrupted after two rounds and resumed from its checkpoint
   to four: bit-equal to four rounds uninterrupted;
9. resnet_main — the CIFAR-10 ResNet-56 FedAvg example config
   (examples/tpu_fedavg_cifar10_resnet56) through load_arguments + init +
   the single-process simulator with conv_impl pallas, full width and
   depth, 1 round of one epoch, under its own cohort schedule (auto ->
   packed, one lane on one card) and checkpointing (to a temporary
   directory); the conv kernels' launch counts, per forward route too, must
   equal those derived from the simulator's round plans, and the last
   round's checkpoint must exist;
9b. resnet_profile — torch.profiler over one warm ResNet-56 round under
   packed and one under even; then resnet_scaffold and resnet_fedopt, the
   example under SCAFFOLD and FedOpt;
9c. resnet_bn — the example with norm: batch (auto: bucketed, as JAX's
   rule gives BatchNorm), the checkpoint's batch_stats, evaluation on the
   running statistics; resnet_bf16 — the same with use_bf16: true, on the
   bf16 kernels (the forward's launches also by route and shape), its
   round and device times beside resnet_bn's;
10. small_lm — the Cheetah LM trainer at f32, T 4096 (auto dispatch picks
    flash) on the card against the same run on the CPU (plain versions);
    small_lm_128 the same with one head of Dh 128 at T 4608 (the forward
    on flash_f32_sm90.cu, dq and dk/dv on flash_f32_wgmma_sm90.cu);
11. lm_main — the Cheetah trainer at the LM slice's configuration (vocab
    32000, dim 1024, 16 heads, 12 layers, bf16, full remat, chunked CE,
    B 2, T 8192) for 5 steps; causal flash on every layer, with 24
    forward, 12 dq and 12 dk/dv launches per step;
12. lm_profile — torch.profiler over two warm steps of that trainer;
13. small_lm_256 — small_lm with one head of Dh 256 at T 4352 (float32:
    the forward, dq and dk/dv on flash_f32_sm90.cu), card against CPU;
14. lm_wide — the Cheetah example at --dim 2048 (vocab 32000, 8 heads, so
    Dh 256, 8 layers, bf16, full remat, chunked CE, B 8, T 4608) for 5
    steps: auto dispatch picks flash, 16 forward, 8 dq and 8 dk/dv
    launches per step on the bf16 Dh-256 kernels; lm_wide_profile, two
    warm steps of it under torch.profiler;
15. lm_wide_dots — the same from the same seed for 2 steps under remat
    "dots" (matrix products saved, flash recomputed): the same launches
    per step and full remat's losses;
16. lm_wide_f32 — the wide LM's widths trained in float32
    (DistributedLMTrainer's dtype) at B 8, T 4352 (auto dispatch picks
    flash), 2 of its 8 layers, for 3 steps: 4 forward, 2 dq and 2 dk/dv
    launches per step, all on flash_f32_sm90.cu; lm_wide_f32_profile, one
    warm step under torch.profiler;
17. lm_mid_f32 — the Cheetah example at --dim 1024 (vocab 32000, 8 heads
    of 128, 8 layers) trained in float32 at B 8, T 4608 (auto dispatch
    picks flash) for 3 steps: 16 forward launches per step on
    flash_f32_sm90.cu, 8 dq and 8 dk/dv on flash_f32_wgmma_sm90.cu;
    lm_mid_f32_profile, one warm step under torch.profiler;
18. lm_xl — the Cheetah example at --dim 3072 --seq_len 4352 (vocab
    32000, 8 heads of 384, 8 layers, 1,116.2 M parameters, bf16, full
    remat, B 8) for 3 steps: 16 forward, 8 dq and 8 dk/dv launches a step
    on flash_dh384_sm90.cu; lm_xl_profile, one warm step under
    torch.profiler;
19. lm_xl_f32 — the same widths trained in float32 at B 8, T 4352 (auto
    dispatch picks flash), 2 of the 8 layers, for 3 steps: 4 forward and 2
    dk/dv launches a step on flash_f32_sm90.cu's Dh-384 kernels, 2 dq on
    flash_f32_wgmma_sm90.cu's three-block clusters (the routes are
    checked); lm_xl_f32_profile, one warm step under torch.profiler;
20. small_lm_384 — one bf16 head of Dh 384 at T 4352 (auto picks flash),
    card against CPU, within SMALL_LM_384_FACTOR of the same comparison
    with dense attention; small_lm_384_f32 the same head in float32, under
    small_lm's float32 gates (its dq on the clusters, the routes checked);
21. lm_xxl — the Cheetah example at --dim 4096 --seq_len 4352 (vocab
    32000, 8 heads of 512, 8 layers, 1,890.9 M parameters, bf16, full
    remat, B 8) for 3 steps: 16 forward, 8 dq and 8 dk/dv launches a step
    on flash_wide_sm90.cu; lm_xxl_profile, one warm step under
    torch.profiler;
22. small_lm_512 and small_lm_1536 — one bf16 head of Dh 512 at T 4352 and
    one of Dh 1536 at T 4224 in one layer (auto picks flash), card against
    CPU under small_lm_384's gate;
23. lm_xxl_f32 — the Cheetah example at --dim 4096 --seq_len 4224
    --ce_chunk 128 (vocab 32000, 8 heads of 512, 8 layers, 1,890.4 M
    parameters) trained in float32 at B 8 (auto dispatch picks flash) for 3
    steps: 16 forward, 8 dq and 8 dk/dv launches a step on
    flash_f32_wgmma_sm90.cu's four-block clusters (the routes are
    checked); lm_xxl_f32_profile, one warm step under torch.profiler;
24. small_lm_512_f32 and small_lm_896_f32 — one float32 head of Dh 512
    (all three on the clusters, the routes checked) and one of Dh 896
    at T 4224 in one layer (auto picks flash), card against CPU under
    small_lm's float32 gates.

Every LM profile must show as many flash kernels a step as the wrappers
count (profile_run's ``calls``), and every device_ms profile as many events
as the calls launch, or it is taken again and then fails.

Then a ``kernels`` JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX or fedml_tpu.
"""

from __future__ import annotations

import hashlib
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
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 on the tensor cores
TF32_OPS_PER_S = 495e12     # H100 SXM dense TF32 on the tensor cores
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
# 6e-8 of the magnitudes, and an H100 measured <= 3.1e-7. The tensor-core
# forward's three TF32 products drop ~3 * 2^-22 ~ 7e-7 of each product's
# magnitude (emulated on the CPU: <= 3.4e-7). 1e-5 leaves margin yet
# catches a wrong tap or channel (an error of O(1)) or one unsplit TF32
# product (~1e-4).
CONV_TOL = 1e-5
# bf16 conv (use_bf16): each output is the float32 sum rounded once to bf16,
# so it may sit one bf16 step from the rounded plain value; the gate allows
# that step (at the larger of the two values) plus CONV_TOL of the
# magnitudes, the float32 sums' own difference, which near cancellation is
# more than a step of a small result. Outputs differing at all from the
# rounded plain value: two float32 sums ~1e-7 apart straddle a bf16 rounding
# boundary ~1e-5 of the time; at most this share, as the flash bf16 gate
CONV_MISMATCH_SHARE = 0.0025
# ... but never fewer than this many outputs: at that share a call with few
# outputs (the stem's weight gradient has 432) expects about one, and the
# weight gradient's sums of B*H*W = 65,536 products (the forward's at most
# 576) straddle a boundary more often (0.02-0.23% of the outputs on an
# H100); the one-step gate still holds every output
CONV_MISMATCH_FLOOR = 8
# (B, H, W, Ci, Co) of the stride-1 3x3 convs of ResNet-56's local step
# (batch 64): the stem, then one shape per stage
CONV_LAYERS = ((64, 32, 32, 3, 16), (64, 32, 32, 16, 16), (64, 16, 16, 32, 32),
               (64, 8, 8, 64, 64))
# at each lane count L the example's schedules give them: the packed
# schedule's G = 1 and 2 lanes (its auto choice on one card), and the even
# schedule's 10 clients
CONV_MAIN = tuple((L,) + s for L in (1, 2, 10) for s in CONV_LAYERS)
CONV_EXTRA = ((1, 256, 32, 32, 16, 16),   # eval: no lanes, batch 256
              (1, 256, 32, 32, 3, 16),    # the stem at the eval
              (3, 5, 7, 9, 5, 7))         # ragged channels, odd sizes
# the eval's forwards: one lane, batch 256, at each layer shape
CONV_EVAL = tuple((1, 256) + s[1:] for s in CONV_LAYERS)
# the kernels line's shape: the packed main path's one lane, 18 of the 53
# convs per step
CONV_REPORTED = (1, 64, 32, 32, 16, 16)
# the stem's shape in the kernels line: the packed main path's one lane
CONV_STEM_REPORTED = (1, 64, 32, 32, 3, 16)
# the stem under resnet8's DP-SGD (phase_algorithms' resnet8_dp_clip): a
# lane per example, the cohort of 4 times the batch of 32, one image each
CONV_DP_STEM = (128, 1, 32, 32, 3, 16)
# the float32 stem's shapes: the packed and even lanes, the eval, DP-SGD
CONV_STEM_F32 = tuple(s for s in CONV_MAIN if s[4:] == (3, 16)) + \
    ((1, 256, 32, 32, 3, 16), CONV_DP_STEM)
CONV_FWD_KERNELS = ("conv3x3_tf32_kernel", "conv3x3_fwd_kernel", "conv3x3_bf16_kernel",
                    "conv3x3_bf16_cut_kernel", "conv3x3_stem_bf16_kernel",
                    "conv3x3_stem_tf32_kernel")
CONV_DW_KERNELS = ("conv3x3_dw_partial_kernel", "conv3x3_dw_reduce_kernel",
                   "conv3x3_dw_bf16_kernel")


_T0 = time.perf_counter()


def emit(phase, **kw):
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **kw,
                      "elapsed_s": round(time.perf_counter() - _T0, 1)}), flush=True)


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


# spin kernels (torch.cuda._sleep) launched at both ends of every profile
# window. torch.profiler loses a window's first device records, a few or
# all of a short window's, at times its last ones, more later in a process:
# on an H100, 40 windows of two kernels lost one window whole, and an LM
# profile late in a run its first two copies, in another run one flash
# forward; between bursts of 64 or 256 spin kernels nothing was lost (the
# bursts lost one spin kernel in 40). The bursts take the loss; their
# events are left out of every count and sum.
PROFILE_PAD = 128
PAD_KERNEL = "spin_kernel"


def _pad_burst():
    for _ in range(PROFILE_PAD):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def _profiled(run):
    """(profile, wall seconds) of ``run()`` under torch.profiler, the window
    padded by PROFILE_PAD spin kernels at each end; the wall is run's own,
    to its synchronize."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _pad_burst()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        _pad_burst()
    return prof, wall


def _device_events(prof):
    """{name: (device us, count)} of a profile's device-side events but the
    window's spin kernels, read from the raw trace: the profiler's per-op
    tables (``key_averages``) take minutes to build over the million events
    of a packed ResNet-56 round. CPU ops are left out: their rows repeat
    their kernels' time."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and PAD_KERNEL not in e.name():
            us, count = out.get(e.name(), (0.0, 0))
            out[e.name()] = (us + e.duration_ns() / 1e3, count + 1)
    return out


def _wrapper_launches():
    """The sum of every kernel wrapper's launch counter (``.launches``)."""
    from fedml_tpu_torch.ops import agg_quant, agg_robust, conv
    from fedml_tpu_torch.ops import flash_attention as fa

    return sum(f.launches for f in (agg_quant.quantize_pack, agg_robust.gram, conv.conv3x3_lanes,
                                    conv.conv3x3_dw_lanes, fa.flash_forward, fa.flash_dq,
                                    fa.flash_dkv))


def device_ms(fn, names, reps=20, attempts=3):
    """Device ms per call of ``fn``: the device time of the kernels whose
    names contain one of ``names``, summed over ``reps`` calls under
    torch.profiler after a warm-up call, divided by the calls whose events
    the profile holds. Unlike time_ms it leaves out the host's time between
    launches, which paces back-to-back calls of a wrapper whose kernels are
    shorter than its Python. The profiler drops device events (PROFILE_PAD),
    which would read as a faster kernel, so a profile counts only when it
    holds exactly ``reps`` times the events of one call. One call's events
    come from a profile of one call, which must hold at least one event for
    each launch that the wrappers' counters count over it (a round of the
    codec makes six; a call of a library or of a route that counts no
    launch, at least one event). Both profiles are taken again on a
    mismatch, up to ``attempts`` times in all, then it raises."""

    def profiled(n):
        prof, _ = _profiled(lambda: [fn() for _ in range(n)])
        hits = [v for k, v in _device_events(prof).items() if any(x in k for x in names)]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(attempts):
        before = _wrapper_launches()
        _, per_call = profiled(1)
        launches = _wrapper_launches() - before
        us, events = profiled(reps)
        if per_call >= max(launches, 1) and events == reps * per_call:
            return us / 1e3 / (events / per_call)
        seen.append({"launches": launches, "events_of_one_call": per_call,
                     f"events_of_{reps}": events})
    raise AssertionError(f"device_ms of {names}: every profile dropped events: {seen}")


def host_us(fn, n=200, rounds=5):
    """Host microseconds per call of ``fn`` (median over ``rounds`` of ``n``
    calls), at a size whose kernels take less than the call's Python: the
    device queue absorbs the launches, and the synchronize is outside the
    timing."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t) / n * 1e6)
        torch.cuda.synchronize()
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
    report = _build.build(KERNELS + ("tc_rate",))
    ptxas = {k: [ln.strip() for ln in v["ptxas"].splitlines()
                 if "registers" in ln or "spill" in ln or "entry function" in ln]
             for k, v in report.items()}
    emit("build", seconds=time.perf_counter() - t, ptxas=ptxas)


def phase_tc_rate(dev):
    """TFLOP/s of independent mma.sync chains over the whole card
    (csrc/tc_rate.cu): m16n8k8 TF32 (the float32 conv forward's
    instruction) beside TF32_OPS_PER_S, and m16n8k16 bf16 (the bf16 conv
    forward's) beside BF16_OPS_PER_S; then TF32 wgmma.m64nNk8 chains beside
    TF32_OPS_PER_S. Returns the two mma.sync rates in operations per
    second."""
    import ctypes

    from fedml_tpu_torch.ops import _build

    lib = _build.load("tc_rate")
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count * 8
    threads, iters = 128, 500
    out = torch.empty(blocks * threads, device=dev)
    rates = []
    for entry, instruction, peak in (("fedml_tc_rate", "mma.sync.m16n8k8 tf32, f32 sums",
                                      TF32_OPS_PER_S),
                                     ("fedml_tc_rate_bf16", "mma.sync.m16n8k16 bf16, f32 sums",
                                      BF16_OPS_PER_S)):
        fn = _build.function("tc_rate", entry, [ctypes.c_void_p] + [ctypes.c_int] * 3 +
                             [ctypes.c_void_p])
        ops = _build.function("tc_rate", entry + "_ops", [ctypes.c_int] * 3, ctypes.c_longlong)

        def run():
            _build.check(fn(out.data_ptr(), blocks, threads, iters,
                            torch.cuda.current_stream(dev).cuda_stream), entry)

        ms = time_ms(run, reps=3, rounds=3)
        rate = ops(blocks, threads, iters) / (ms * 1e-3)
        emit("tc_rate", instruction=instruction, blocks=blocks, threads=threads, ms=ms,
             tflops=rate / 1e12, share_of_peak=rate / peak)
        rates.append(rate)
    # TF32 wgmma.m64nNk8 (csrc/flash_f32_wgmma_sm90.cu's instruction): one
    # warpgroup a block, one and two blocks an SM
    fn = _build.function("tc_rate", "fedml_wgmma_tf32_rate",
                         [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    ops = _build.function("tc_rate", "fedml_wgmma_tf32_rate_ops", [ctypes.c_int] * 3,
                          ctypes.c_longlong)
    sms = blocks // 8
    for per_sm in (1, 2):
        out = torch.empty(sms * per_sm * 128, device=dev)
        for n in (16, 32, 64):
            for rs in (0, 1):
                def run():
                    _build.check(fn(out.data_ptr(), sms * per_sm, n, rs, 200,
                                    torch.cuda.current_stream(dev).cuda_stream), "wgmma rate")

                ms = time_ms(run, reps=3, rounds=3)
                rate = ops(sms * per_sm, n, 200) / (ms * 1e-3)
                emit("tc_rate", instruction=f"wgmma.m64n{n}k8 tf32, A from " +
                     ("registers" if rs else "shared memory"), blocks_per_sm=per_sm, ms=ms,
                     tflops=rate / 1e12, share_of_peak=rate / TF32_OPS_PER_S)
    phase_cluster_probe(dev)
    return tuple(rates)


# the forms of csrc/tc_rate.cu's cluster probe, by its mode
CLUSTER_FORMS = ("pull: 16 KB stored, the peers' 48 KB read, two cluster barriers",
                 "reduce-scatter and gather of one tile on mbarriers (dq's exchange)",
                 "reduce-scatter and gather of two tiles on mbarriers (dk/dv's exchange)")
CLUSTER_PROBE_ITERS = 2000


def phase_cluster_probe(dev):
    """Microseconds per exchange of flash_f32_wgmma_sm90.cu's Dh-512
    clusters alone (csrc/tc_rate.cu's cluster probe): as many clusters of
    four 256-thread blocks of 226 KB as the card holds at once
    (cudaOccupancyMaxActiveClusters, printed; it raises if none fits), each
    exchanging two 64 x 32 float32 tiles a block CLUSTER_PROBE_ITERS times in
    each of CLUSTER_FORMS."""
    import ctypes

    from fedml_tpu_torch.ops import _build

    clusters = _build.function("tc_rate", "fedml_cluster_exchange_clusters", [])()
    if clusters <= 0:
        raise AssertionError(f"no cluster of four 226-KB blocks fits the card ({clusters})")
    fn = _build.function("tc_rate", "fedml_cluster_exchange",
                         [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    out = torch.empty(clusters * 4 * 256, device=dev)
    for mode, form in enumerate(CLUSTER_FORMS):
        def run():
            _build.check(fn(out.data_ptr(), clusters, CLUSTER_PROBE_ITERS, mode,
                            torch.cuda.current_stream(dev).cuda_stream), "cluster probe")

        ms = time_ms(run, reps=1, rounds=3)
        emit("cluster_exchange", form=form, clusters=clusters, blocks_per_cluster=4,
             smem_bytes_per_block=226 * 1024, us_per_exchange=ms * 1e3 / CLUSTER_PROBE_ITERS)


def special_values(C, m, seed):
    """A (C, m) float32 stack whose 256-chunks walk every exponent: chunk k
    of row r draws random signs and mantissas with biased exponents in a
    window of four starting at 7 (r nchunk + k) mod 256, up to inf and NaN.
    Row 0's first five chunks are set (where m holds them): all zeros
    (scale 1.0); finite values and one +inf (an inf absmax); subnormals only
    and exponent fields 0 or 1 (both flush the scale to 0); NaN and -inf
    among finite values."""
    rng = np.random.default_rng(seed)
    nck = -(-m // 256)
    window = (np.arange(C)[:, None] * nck + np.arange(m)[None, :] // 256) * 7 % 256
    exp = np.minimum(window + rng.integers(0, 4, (C, m)), 255).astype(np.uint32)
    mant = rng.integers(0, 2 ** 32, (C, m), dtype=np.uint64).astype(np.uint32) & 0x807FFFFF
    v = (mant | (exp << 23)).view(np.float32)
    row = v[0, :min(m, 5 * 256)]
    n = row.size
    row[:256] = 0.0
    row[256:512] = rng.standard_normal(max(0, min(n, 512) - 256))
    row[512:768] = mant[0, 512:768].view(np.float32)
    row[768:1024] = (mant[0, 768:1024] | (exp[0, 768:1024] % 2 << 23)).view(np.float32)
    row[1024:] = rng.standard_normal(max(0, n - 1024))
    if n > 300:
        row[300] = np.inf
    if n > 1100:
        row[1030], row[1100] = np.nan, -np.inf
    return v


# (C, m) beyond the main path's leaves: odd m, m < 256, m % 8 == 4 (the
# kernel's one-element loads), a ragged cohort
QUANT_EDGE = ((13, 1000), (1, 257), (4, 257), (3, 100), (2, 1004))


def check_quant(dev):
    """Kernel 1 == plain version: packed bytes and scales equal, dec
    bit-equal, at the main path's six leaves, QUANT_EDGE and two stacks of
    special values. Times one round's six q8 calls by device time (the
    profiler) and by CUDA events around the wrapper calls (which the host
    paces), each leaf's device time, and the host time per wrapper call.
    Returns the kernel's entry for the kernels line."""
    from fedml_tpu_torch.comm.codec import _leaf_hash
    from fedml_tpu_torch.ops import agg_quant as aq

    gen = torch.Generator().manual_seed(0)
    shapes = [(MAIN_C, m) for m in MAIN_LEAF_M] + list(QUANT_EDGE)
    cases = []
    for i, (C, m) in enumerate(shapes):
        vals = torch.randn(C, m, generator=gen) * 0.01
        vals[0, :300] = 0.0  # an all-zero chunk takes scale 1.0
        cases.append(((C, m), vals))
    for C, m in ((3, 256 * 40 + 8), (2, 256 * 40 + 3)):
        cases.append(((C, m, "special"), torch.from_numpy(special_values(C, m, m))))
    for bits in (8, 4):
        for i, (label, vals) in enumerate(cases):
            vals = vals.to(dev)
            C = vals.shape[0]
            cids = torch.arange(7, 7 + C, dtype=torch.int32, device=dev) * 37
            lh = _leaf_hash(f"params/leaf_{i}/kernel")
            pk, sk, dk = aq.quantize_pack(vals, bits, 3, 4, cids, lh)
            pp, sp, dp = aq.quantize_pack_plain(vals, bits, 3, 4, cids, lh)
            torch.cuda.synchronize()
            if not (torch.equal(pk, pp) and torch.equal(sk.view(torch.int32), sp.view(torch.int32))
                    and torch.equal(dk.view(torch.int32), dp.view(torch.int32))):
                raise AssertionError(
                    f"quantize_pack q{bits} at {label} differs from its plain version: "
                    f"{(pk != pp).sum().item()} bytes, "
                    f"{(dk.view(torch.int32) != dp.view(torch.int32)).sum().item()} dec values")
    # one round's codec work on the main path: q8 over the six leaves, C=10
    stacks = [torch.randn(MAIN_C, m, generator=gen).to(dev) * 0.01 for m in MAIN_LEAF_M]
    cids = torch.arange(MAIN_C, dtype=torch.int32, device=dev)

    def run(f):
        return lambda: [f(v, 8, 3, 4, cids, 99) for v in stacks]

    def leaf_bytes(m):
        elems = MAIN_C * m
        return elems * 4 + MAIN_C * 4 + elems * (1 + 4) + MAIN_C * -(-m // 256) * 4

    nbytes = sum(leaf_bytes(m) for m in MAIN_LEAF_M)
    elems = MAIN_C * sum(MAIN_LEAF_M)
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = elems * QUANT_OPS_PER_ELEM / FP32_OPS_PER_S * 1e3
    names = ("quantize_pack_kernel",)
    leaf_ms = [device_ms(lambda v=v: aq.quantize_pack(v, 8, 3, 4, cids, 99), names)
               for v in stacks]
    entry = {"name": "quantize_pack", "route": "cuda", "source": "fedml_tpu_torch/csrc/agg_quant.cu",
             "replaces": "fedml_tpu/ops/pallas/agg_quant.py:174", "max_abs_err": 0.0,
             "ms": device_ms(run(aq.quantize_pack), names), "launches_per_round": 6,
             "plain_ms": time_ms(run(aq.quantize_pack_plain)),
             "bound_ms": max(bound_bytes, bound_ops),
             "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
             "library_ms": None, "bytes": nbytes}
    emit("kernel_quantize_pack", shapes=[c[0] for c in cases], bits=[8, 4], equal=True,
         timed="q8, six cnn_fedavg leaves, C=10; ms and plain_ms per round of six calls",
         unit="device ms per round (profiler)",
         event_ms_per_round=time_ms(run(aq.quantize_pack)),
         device_ms_per_leaf=dict(zip(MAIN_LEAF_M, leaf_ms)),
         bound_ms_per_leaf={m: leaf_bytes(m) / HBM_BYTES_PER_S * 1e3 for m in MAIN_LEAF_M},
         host_us_per_call=host_us(lambda: aq.quantize_pack(stacks[2], 8, 3, 4, cids, 99)),
         host_us_leaf=[MAIN_C, MAIN_LEAF_M[2]], **entry)
    return entry


# (C, D): the main path's cohort first, then C = 16 (the largest of the
# small route) at the same D, ragged D (D % 4 = 1, 2, 3; D < 8) and the
# tiled route
GRAM_CASES = ((MAIN_C, 1663370), (16, 1663370), (1, 1663371), (13, 1000), (16, 1001),
              (5, 4099), (3, 7), (17, 65537), (100, 65536), (1000, 7850))
GRAM_KERNELS = ("gram_small_partial_kernel", "gram_small_reduce_kernel", "gram_partial_kernel",
                "gram_tiled_reduce_kernel")


def check_gram(dev):
    """Kernel 2 within GRAM_TOL of the plain version (normalised by the
    row norms), bit-repeatable and exactly symmetric at GRAM_CASES; device
    time (profiler) beside torch.matmul's, and the host time per call."""
    from fedml_tpu_torch.ops import agg_robust as ar

    gen = torch.Generator().manual_seed(1)
    entry = None
    for C, D in GRAM_CASES:
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
        if not torch.equal(gk, gk.T):
            raise AssertionError(f"gram at {(C, D)} is not exactly symmetric")
        bound_bytes = (C * D + C * C) * 4 / HBM_BYTES_PER_S * 1e3
        bound_ops = 2 * C * C * D / FP32_OPS_PER_S * 1e3
        row = {"ms": device_ms(lambda: ar.gram(flat), GRAM_KERNELS), "launches_per_round": 1,
               "plain_ms": time_ms(lambda: ar.gram_plain(flat)),
               "library_ms": time_ms(lambda: torch.matmul(flat, flat.t())),
               "bound_ms": max(bound_bytes, bound_ops),
               "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
               "max_abs_err": abs_err}
        plan = ar.small_plan(D) if ar.route(C) == "small" else ar.split_plan(C, D)
        emit("kernel_gram", shape=[C, D], gram_route=ar.route(C), plan=plan,
             normalised_err=rel, tol=GRAM_TOL, repeatable=True, symmetric=True,
             unit="device ms (profiler)", event_ms=time_ms(lambda: ar.gram(flat)),
             library_device_ms=device_ms(lambda: torch.matmul(flat, flat.t()), ("",)),
             share_of_bound=row["bound_ms"] / row["ms"], **row)
        if entry is None:
            entry = {"name": "gram", "route": "cuda",
                     "source": "fedml_tpu_torch/csrc/agg_robust.cu",
                     "replaces": "fedml_tpu/ops/pallas/agg_robust.py:71", **row}
    flat = (torch.randn(MAIN_C, 4096, generator=gen) * 0.01).to(dev)
    emit("gram_host", shape=[MAIN_C, 4096], host_us_per_call=host_us(lambda: ar.gram(flat)))
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


def _run_twice(config):
    """(train losses, final global parameters on the CPU) of two runs of
    ``config`` through init + build_simulator + run."""
    import fedml_tpu_torch as ft
    from fedml_tpu_torch.simulation import build_simulator

    runs = []
    for _ in range(2):
        sim, _ = build_simulator(ft.init(config=dict(config)))
        hist = sim.run(None, log_fn=None)
        runs.append(([r["train_loss"] for r in hist],
                     {k: v.detach().cpu() for k, v in sim.params.items()}))
    return runs


def phase_repeat():
    """Two runs of one config on the card give bit-identical histories and
    final parameters, as the reference's do: the small robust path on
    cnn_fedavg (cuDNN's conv and its backward, pinned deterministic by
    resolve_device), the small resnet8 path (the conv kernels), DP-SGD with
    noise (per-(client, step) generators keyed by seed, round, cohort
    position and step) and weak DP (the generator in the server state)."""
    for name, config in (
            ("small_cnn", dict(small_config("cuda"), model="cnn_fedavg")),
            ("small_resnet", small_resnet_config("cuda")),
            ("dp_sgd_noise", dict(algorithm_base("cuda"), dp_l2_clip=1.0,
                                  dp_noise_multiplier=0.5)),
            ("weak_dp", dict(algorithm_base("cuda"), federated_optimizer="FedAvg_robust",
                             defense_type="weak_dp", norm_bound=1.0, stddev=0.01)),
            ("cnn_dropout", dict(algorithm_base("cuda"), model="cnn", comm_round=2))):
        (la, pa), (lb, pb) = _run_twice(config)
        if not (torch.equal(torch.tensor(la), torch.tensor(lb))
                and pa.keys() == pb.keys() and all(torch.equal(pa[k], pb[k]) for k in pa)):
            diff = max((pa[k] - pb[k]).abs().max().item() for k in pa)
            raise AssertionError(f"{name} is not repeatable: losses {la} vs {lb}, "
                                 f"parameters differ by up to {diff}")
        emit("repeat", slice=name, model=config["model"], rounds=len(la), train_loss=la,
             params=len(pa), repeatable=True)


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
    torch.cuda.reset_peak_memory_stats()  # the kernel checks before ran larger
    agg_quant.quantize_pack.launches = 0
    agg_robust.gram.launches = 0
    agg_robust.gram.route_launches = dict.fromkeys(agg_robust.gram.route_launches, 0)
    t = time.perf_counter()
    hist = ft.run_simulation(args=args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {"quantize_pack": agg_quant.quantize_pack.launches,
                "gram": agg_robust.gram.launches}
    rounds = MAIN_CONFIG["comm_round"]
    gram_routes = dict(agg_robust.gram.route_launches)
    if launches != {"quantize_pack": 6 * rounds, "gram": rounds} or gram_routes["small"] != rounds:
        raise AssertionError(f"main path launches {launches} (gram by route {gram_routes}), "
                             f"expected 6 and 1 per round, the Gram on the small route")
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
         launches=launches, gram_route_launches=gram_routes,
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    return launches


def profile_run(run, n, ours, unit="round", groups=None, calls=None, attempts=3):
    """torch.profiler over ``run()``, which does ``n`` rounds or steps.
    Device busy time is the sum of the kernels' self device time (one
    stream, so they do not overlap); the idle share is 1 - busy / wall.
    ``ours`` names kernels whose ms per ``unit`` are reported; ``groups``
    maps a group to name parts, and each group's ms per ``unit`` (a kernel
    in the first group it matches; "other" for the rest) is reported.
    ``calls`` maps name parts to the device events per ``unit`` that the
    run must show (the launches its wrappers count): the profiler drops
    events (PROFILE_PAD), which would shrink the groups' times and raise the
    idle share, so a profile that shows other counts is taken again,
    ``run`` and all, up to ``attempts`` times in all, then it raises. The
    counts are reported beside the groups."""
    seen = []
    for _ in range(attempts):
        prof, wall = _profiled(run)
        events = _device_events(prof)
        counted = {part: sum(c for k, (_, c) in events.items() if part in k) / n
                   for part in calls or ()}
        if counted == (calls or {}):
            break
        seen.append(counted)
    else:
        raise AssertionError(f"every profile's device events per {unit} were {seen}, "
                             f"expected {calls}")

    rows = sorted(((k, us, c) for k, (us, c) in events.items() if us > 0), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    split = {}
    for k, us, _ in rows if groups else ():
        g = next((g for g, parts in groups.items() if any(x in k for x in parts)), "other")
        split[g] = split.get(g, 0.0) + us / 1e3 / n
    return {f"{unit}s": n, **({f"groups_ms_per_{unit}": split} if groups else {}),
            **({f"calls_per_{unit}": counted, "profiles_taken": len(seen) + 1} if calls else {}),
            f"wall_ms_per_{unit}": wall * 1e3 / n,
            f"device_busy_ms_per_{unit}": busy_ms / n,
            "idle_share": 1.0 - busy_ms / (wall * 1e3),
            f"our_kernels_ms_per_{unit}": {
                k: sum(r[1] for r in rows if k in r[0]) / 1e3 / n for k in ours},
            "top": [{"kernel": k[:90], f"ms_per_{unit}": us / 1e3 / n,
                     f"calls_per_{unit}": c / n} for k, us, c in rows[:10]]}


def phase_profile(rounds=3):
    """Where a main-path round's time goes: three warm rounds of the main
    config after a warm-up run; then the same rounds with cuDNN free to pick
    nondeterministic algorithms, for what the determinism pin costs."""
    import fedml_tpu_torch as ft
    from fedml_tpu_torch.simulation import build_simulator

    sim, _ = build_simulator(ft.init(config=dict(MAIN_CONFIG, comm_round=rounds)))
    ours = ("quantize_pack_kernel",) + GRAM_KERNELS
    sim.run(None, log_fn=None)  # warm-up
    det = profile_run(lambda: sim.run(None, log_fn=None), rounds, ours)
    torch.backends.cudnn.deterministic = False
    try:
        sim.run(None, log_fn=None)
        nondet = profile_run(lambda: sim.run(None, log_fn=None), rounds, ours)
    finally:
        torch.backends.cudnn.deterministic = True
    emit("profile", cudnn_deterministic=True, **det,
         cudnn_nondeterministic={k: nondet[k] for k in (
             "wall_ms_per_round", "device_busy_ms_per_round", "idle_share", "top")})


def phase_agg():
    """The robust path's aggregation half alone, so that two checkouts (say
    a parent commit unpacked with git archive, and this one) can be measured
    in turns in one call: host microseconds per wrapper call, device and
    CUDA-event ms per round of the six quantize_pack calls and of the Gram at
    the main path's shape, and the profile of three warm rounds of the main
    config. Kernels are matched by name prefix, so older kernel names count."""
    import fedml_tpu_torch as ft
    from fedml_tpu_torch.ops import agg_quant as aq
    from fedml_tpu_torch.ops import agg_robust as ar
    from fedml_tpu_torch.simulation import build_simulator

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    stacks = [torch.randn(MAIN_C, m, generator=gen).to(dev) * 0.01 for m in MAIN_LEAF_M]
    cids = torch.arange(MAIN_C, dtype=torch.int32, device=dev)

    def round_q8():
        return [aq.quantize_pack(v, 8, 3, 4, cids, 99) for v in stacks]

    flat = (torch.randn(MAIN_C, 1663370, generator=gen) * 0.01).to(dev)
    small = (torch.randn(MAIN_C, 4096, generator=gen) * 0.01).to(dev)
    row = {"package": str(Path(ft.__file__).resolve().parent),
           "quant_host_us_per_call": host_us(lambda: aq.quantize_pack(stacks[2], 8, 3, 4, cids, 99)),
           "quant_device_ms_per_round": device_ms(round_q8, ("quantize_pack_kernel",)),
           "quant_event_ms_per_round": time_ms(round_q8),
           "gram_host_us_per_call": host_us(lambda: ar.gram(small)),
           "gram_device_ms": device_ms(lambda: ar.gram(flat), ("gram_",)),
           "gram_event_ms": time_ms(lambda: ar.gram(flat))}
    del flat, small, stacks
    sim, _ = build_simulator(ft.init(config=dict(MAIN_CONFIG, comm_round=3)))
    sim.run(None, log_fn=None)  # warm-up
    emit("agg", **row, profile=profile_run(lambda: sim.run(None, log_fn=None), 3,
                                           ("quantize_pack_kernel", "gram_")))


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


def _bound(ops, nbytes, bf16_ops=0, tf32_ops=0):
    """ops run at the float32 rate; bf16_ops on the bf16 tensor cores, which
    multiply two bf16 operands exactly with float32 sums; tf32_ops on the
    TF32 tensor cores (a float32 product exact to float32 counts as three
    TF32 products, hi hi + hi lo + lo hi)."""
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = (ops / FP32_OPS_PER_S + bf16_ops / BF16_OPS_PER_S + tf32_ops / TF32_OPS_PER_S) * 1e3
    return {"bound_ms": max(b, o), "bound_by": "bytes" if b >= o else "operations"}


def check_conv(dev, tc_rate):
    """Kernel 3a (forward, also dx) within CONV_TOL of the plain version and
    bit-equal across two calls at the four layer shapes at L = 1, 2 and 10
    lanes (CONV_MAIN), the eval shape, a ragged one and the stem under
    DP-SGD (CONV_DP_STEM), and with a lane-broadcast w (the even schedule's
    first step). Times are device
    time (the profiler), the kernel's and cuDNN's alike: at one or two lanes
    a kernel takes less than its wrapper's host time, so CUDA events around
    back-to-back calls (event_ms, beside) measure the host. Timings beside
    cuDNN's grouped conv and, where the shape runs on the tensor cores
    (the block convs on tf32x3, the stem on stem_tf32x3), the FMA kernel's
    time on it (was_ms). The bound counts the route's work: three TF32
    tensor-core products per multiply-add on the tensor-core routes, one
    float32 FMA on the fma route (fma_bound_ms: the latter at every
    shape); mma_sync_ms: a tensor-core route's operations at ``tc_rate``,
    the rate its instruction reached in phase tc_rate. On stem_tf32x3 the
    launch plan the card reports equals ops/conv.py::fwd_tc_plan's. Returns
    the kernels line's entries of the block convs and of the stem."""
    from fedml_tpu_torch.ops import conv as C

    gen = torch.Generator().manual_seed(3)
    entries = []
    for shape in CONV_MAIN + CONV_EXTRA + (CONV_DP_STEM,):
        L, B, H, W, ci, co = shape
        route = C.fwd_route(ci, co)
        x, w, _, xn, wn, _ = _conv_case(shape, gen, dev)
        y = C.conv3x3_lanes(x, w)
        yp = C.conv3x3_plain(x, w)
        mag = C.conv3x3_plain(x.abs(), w.abs())
        err = _normalised_err(y, yp, mag)
        lib = F.conv2d(xn, wn, padding=1, groups=L)
        lib_err = _normalised_err(lib.reshape(B, L, co, H, W).permute(1, 0, 3, 4, 2), yp, mag)
        if not (err <= CONV_TOL and lib_err <= CONV_TOL):
            raise AssertionError(f"conv3x3 at {shape} ({route}): normalised error {err} "
                                 f"(cuDNN {lib_err}) > {CONV_TOL}")
        if not torch.equal(y, C.conv3x3_lanes(x, w)):
            raise AssertionError(f"conv3x3 at {shape} ({route}) is not repeatable")
        ops = _conv_ops(shape)
        nbytes = (L * B * H * W * (ci + co) + L * 9 * ci * co) * 4
        fma_bound = _bound(ops, nbytes)
        row = {"ms": device_ms(lambda: C.conv3x3_lanes(x, w), CONV_FWD_KERNELS),
               "event_ms": time_ms(lambda: C.conv3x3_lanes(x, w)),
               "plain_ms": time_ms(lambda: C.conv3x3_plain(x, w)),
               "library_ms": device_ms(lambda: F.conv2d(xn, wn, padding=1, groups=L), ("",)),
               "library_event_ms": time_ms(lambda: F.conv2d(xn, wn, padding=1, groups=L)),
               "max_abs_err": (y - yp).abs().max().item(),
               **(fma_bound if route == "fma" else _bound(0, nbytes, tf32_ops=3 * ops)),
               "fma_bound_ms": fma_bound["bound_ms"]}
        plan = None
        if route != "fma":
            row["mma_sync_ms"] = 3 * ops / tc_rate * 1e3
            fma_err = _normalised_err(C.conv3x3_fwd_route(x, w, "fma"), yp, mag)
            if not fma_err <= CONV_TOL:
                raise AssertionError(f"conv3x3 fma kernel at {shape}: {fma_err} > {CONV_TOL}")
            row["was_ms"] = device_ms(lambda: C.conv3x3_fwd_route(x, w, "fma"),
                                      ("conv3x3_fwd_kernel",))
        if route == "stem_tf32x3":
            plan = C.fwd_tc_plan_on_card(L, B, H, W, ci, co, dev, torch.float32)
            mirror = C.fwd_tc_plan(L, B, H, W, ci, co, *plan[3:], torch.float32)
            if plan[:3] != mirror:
                raise AssertionError(f"conv3x3 stem at {shape}: the card's plan {plan} is not "
                                     f"fwd_tc_plan's {mirror}")
        emit("kernel_conv3x3", shape=list(shape), conv_route=route, normalised_err=err,
             tol=CONV_TOL, library_normalised_err=lib_err, repeatable=True,
             gflop=ops / 1e9, **({"plan": plan} if plan else {}), **row)
        if shape in (CONV_REPORTED, CONV_STEM_REPORTED):
            entries.append({"name": "conv3x3" if shape == CONV_REPORTED else "conv3x3_stem",
                            "route": "cuda",
                            "source": "fedml_tpu_torch/csrc/" + C.FWD_ROUTES[route][0] + ".cu",
                            "replaces": "fedml_tpu/ops/conv.py:181", **row})
        if shape == (10,) + CONV_REPORTED[1:]:
            # the even schedule's first local step: every lane shares the
            # global weights (the packed schedule stacks them per lane)
            wb = w[:1].expand_as(w)
            err_b = _normalised_err(C.conv3x3_lanes(x, wb), C.conv3x3_plain(x, wb),
                                    C.conv3x3_plain(x.abs(), wb.abs()))
            if not err_b <= CONV_TOL:
                raise AssertionError(f"conv3x3 with a broadcast w: {err_b} > {CONV_TOL}")
            emit("kernel_conv3x3", shape=list(shape), conv_route=route, w_lanes=1,
                 normalised_err=err_b)
    return entries


def _bf16_step(v):
    """The spacing of bf16 values at each element of bf16 ``v`` (0 at 0)."""
    _, e = torch.frexp(v.float())
    return torch.where(v == 0, 0.0, torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8))


def _bf16_gate(got, want32, mag, what):
    """(normalised error against the float32 plain value, share of elements
    that differ from the rounded plain value, steps): raises unless every
    element is within one bf16 step (plus CONV_TOL of its magnitude) of the
    rounded plain value and at most CONV_MISMATCH_SHARE of them (or
    CONV_MISMATCH_FLOOR, whichever is more) differ."""
    want = want32.to(torch.bfloat16)
    step = torch.maximum(_bf16_step(got), _bf16_step(want))
    diff = (got.float() - want.float()).abs()
    over = (diff - step - CONV_TOL * mag).max().item()
    off = (got != want).sum().item()
    share = off / got.numel()
    allowed = max(CONV_MISMATCH_SHARE * got.numel(), CONV_MISMATCH_FLOOR)
    steps = (diff / step.clamp_min(1e-30)).masked_fill(diff == 0, 0).max().item()
    if not (over <= 0 and off <= allowed):
        raise AssertionError(f"{what}: {off} of {got.numel()} bf16 outputs differ from the "
                             f"rounded plain value (at most {allowed}), largest difference "
                             f"{steps} bf16 steps, {over} past the step")
    return _normalised_err(got.float(), want32, mag), share, steps


def check_conv_bf16(dev, bf16_rate):
    """Kernel 3a in bf16 (use_bf16: forward and dx) against its plain
    version (float32 products and sums of the same bf16 operands, rounded
    once) at CONV_MAIN and CONV_EXTRA, with the bf16 gate (_bf16_gate) and
    bit-equal across two calls; a lane-broadcast w at the even schedule's
    block shape. ResNet's block convs run the bf16 tensor-core kernels
    (bf16_tc), the stem its own (stem_bf16, whose line also gives the FMA
    kernel's time on the shape as was_ms), ragged shapes the FMA kernel
    (fma_bf16). On the two tensor-core routes the launch plan the card
    reports equals ops/conv.py::fwd_tc_plan's. Device time beside cuDNN's
    grouped bf16 conv; the bound counts bf16 bytes and the function's
    operations at the bf16 tensor-core rate, whichever route runs them;
    mma_sync_ms: a tensor-core route's operations at ``bf16_rate``, the
    rate its instruction reached in phase tc_rate. Returns the kernels
    line's entries of the block convs and of the stem."""
    from fedml_tpu_torch.ops import conv as C

    gen = torch.Generator().manual_seed(13)
    entries = []
    bf = torch.bfloat16
    for shape in CONV_MAIN + CONV_EXTRA:
        L, B, H, W, ci, co = shape
        route = C.fwd_route(ci, co, bf)
        x, w, _, xn, wn, _ = (t.to(bf) for t in _conv_case(shape, gen, dev))
        y = C.conv3x3_lanes(x, w)
        yp = C.conv3x3_plain(x, w)
        want32 = C.conv3x3_plain(x.float(), w.float())
        mag = C.conv3x3_plain(x.float().abs(), w.float().abs())
        err, share, steps = _bf16_gate(y, want32, mag, f"conv3x3 bf16 at {shape} ({route})")
        if y.dtype != bf or not torch.equal(y, C.conv3x3_lanes(x, w)):
            raise AssertionError(f"conv3x3 bf16 at {shape} ({route}) is not repeatable")
        lib = F.conv2d(xn, wn, padding=1, groups=L)
        lib_err = _normalised_err(lib.reshape(B, L, co, H, W).permute(1, 0, 3, 4, 2).float(),
                                  want32, mag)
        ops = _conv_ops(shape)
        nbytes = (L * B * H * W * (ci + co) + L * 9 * ci * co) * 2
        row = {"ms": device_ms(lambda: C.conv3x3_lanes(x, w), CONV_FWD_KERNELS),
               "event_ms": time_ms(lambda: C.conv3x3_lanes(x, w)),
               "plain_ms": time_ms(lambda: C.conv3x3_plain(x, w)),
               "library_ms": device_ms(lambda: F.conv2d(xn, wn, padding=1, groups=L), ("",)),
               "max_abs_err": (y.float() - yp.float()).abs().max().item(),
               **_bound(0, nbytes, bf16_ops=ops)}
        plan = None
        if route in ("bf16_tc", "stem_bf16"):
            row["mma_sync_ms"] = ops / bf16_rate * 1e3
            plan = C.fwd_tc_plan_on_card(L, B, H, W, ci, co, dev)
            if plan[:3] != C.fwd_tc_plan(L, B, H, W, ci, co, *plan[3:]):
                raise AssertionError(f"conv3x3 bf16 at {shape}: the card's plan {plan} is not "
                                     f"fwd_tc_plan's {C.fwd_tc_plan(L, B, H, W, ci, co, *plan[3:])}")
        if route == "stem_bf16":
            _bf16_gate(C.conv3x3_fwd_route(x, w, "fma_bf16"), want32, mag,
                       f"conv3x3 fma_bf16 at {shape}")
            row["was_ms"] = device_ms(lambda: C.conv3x3_fwd_route(x, w, "fma_bf16"),
                                      CONV_FWD_KERNELS)
        emit("kernel_conv3x3_bf16", shape=list(shape), conv_route=route, normalised_err=err,
             mismatch_share=share, max_bf16_steps=steps, library_normalised_err=lib_err,
             repeatable=True, gflop=ops / 1e9, plan=plan, **row)
        if shape in (CONV_REPORTED, CONV_STEM_REPORTED):
            entries.append({"name": "conv3x3_bf16" if shape == CONV_REPORTED else
                            "conv3x3_stem_bf16", "route": "cuda",
                            "source": "fedml_tpu_torch/csrc/" + C.FWD_ROUTES[route][0] + ".cu",
                            "replaces": "fedml_tpu/ops/conv.py:181", **row})
        if shape == (10,) + CONV_REPORTED[1:]:
            wb = w[:1].expand_as(w)
            _bf16_gate(C.conv3x3_lanes(x, wb), C.conv3x3_plain(x.float(), wb.float()),
                       C.conv3x3_plain(x.float().abs(), wb.float().abs()),
                       "conv3x3 bf16 with a broadcast w")
            emit("kernel_conv3x3_bf16", shape=list(shape), conv_route=route, w_lanes=1)
    return entries


def check_conv_dw_bf16(dev):
    """Kernel 3b in bf16 (use_bf16's weight gradient: float32 partial sums,
    rounded once to bf16) against its plain version at the same shapes, with
    the bf16 gate and bit-equal across two calls, on the route dw_route
    picks: ResNet's block convs on the tensor cores (bf16_tc, whose line
    also gives the FMA kernel's time on the shape as was_ms), the stem and
    ragged shapes on the FMA kernel (fma_bf16); cuDNN's grouped bf16
    weight-gradient call beside it. The bound counts bf16 bytes and the
    bf16 products at the tensor-core rate, as the forward's."""
    from fedml_tpu_torch.ops import conv as C

    gen = torch.Generator().manual_seed(14)
    entry = None
    bf = torch.bfloat16
    for shape in CONV_MAIN + CONV_EXTRA:
        L, B, H, W, ci, co = shape
        route = C.dw_route(ci, co, bf)
        x, w, dy, xn, wn, dyn = (t.to(bf) for t in _conv_case(shape, gen, dev))
        dw = C.conv3x3_dw_lanes(x, dy)
        dwp = C.conv3x3_dw_plain(x, dy)
        want32 = C.conv3x3_dw_plain(x.float(), dy.float())
        mag = C.conv3x3_dw_plain(x.float().abs(), dy.float().abs())
        err, share, steps = _bf16_gate(dw, want32, mag, f"conv3x3_dw bf16 at {shape} ({route})")
        if dw.dtype != bf or not torch.equal(dw, C.conv3x3_dw_lanes(x, dy)):
            raise AssertionError(f"conv3x3_dw bf16 at {shape} ({route}) is not repeatable")

        def lib_call():
            return torch.nn.grad.conv2d_weight(xn, wn.shape, dyn, padding=1, groups=L)

        lib_err = _normalised_err(
            lib_call().reshape(L, co, ci, 3, 3).permute(0, 3, 4, 2, 1).float(), want32, mag)
        ops = _conv_ops(shape)
        nbytes = (L * B * H * W * (ci + co) + L * 9 * ci * co) * 2
        units = C.dw_tc_geometry(B, H, W)[2] if route == "bf16_tc" else B * H * W
        row = {"ms": device_ms(lambda: C.conv3x3_dw_lanes(x, dy), CONV_DW_KERNELS),
               "event_ms": time_ms(lambda: C.conv3x3_dw_lanes(x, dy)),
               "plain_ms": time_ms(lambda: C.conv3x3_dw_plain(x, dy)),
               "library_ms": device_ms(lib_call, ("",)),
               "max_abs_err": (dw.float() - dwp.float()).abs().max().item(),
               **_bound(0, nbytes, bf16_ops=ops)}
        if route == "bf16_tc":
            _bf16_gate(C.conv3x3_dw_route(x, dy, "fma_bf16"), want32, mag,
                       f"conv3x3_dw fma_bf16 at {shape}")
            row["was_ms"] = device_ms(lambda: C.conv3x3_dw_route(x, dy, "fma_bf16"),
                                      CONV_DW_KERNELS)
        emit("kernel_conv3x3_dw_bf16", shape=list(shape), dw_route=route,
             tile=C.dw_tile(ci, co, route), splits=C.dw_split_plan(L, units, ci, co, route)[1],
             normalised_err=err, mismatch_share=share, max_bf16_steps=steps,
             library_normalised_err=lib_err, repeatable=True, gflop=ops / 1e9, **row)
        if shape == CONV_REPORTED:
            entry = {"name": "conv3x3_dw_bf16", "route": "cuda",
                     "source": "fedml_tpu_torch/csrc/" + C.DW_ROUTES[route][0] + ".cu",
                     "replaces": "fedml_tpu/ops/conv.py:226", **row}
    return entry


def check_conv_dw(dev):
    """Kernel 3b (weight gradient) within CONV_TOL of the plain version and
    bit-equal across two calls, at the same shapes (at L = 1 the split plan
    cuts each lane's pixels into the most spans); cuDNN's grouped
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
        row = {"ms": device_ms(lambda: C.conv3x3_dw_lanes(x, dy), CONV_DW_KERNELS),
               "event_ms": time_ms(lambda: C.conv3x3_dw_lanes(x, dy)),
               "plain_ms": time_ms(lambda: C.conv3x3_dw_plain(x, dy)),
               "library_ms": device_ms(lib_call, ("",)),
               "library_event_ms": time_ms(lib_call),
               "max_abs_err": (dw - dwp).abs().max().item(), **_bound(ops, nbytes)}
        emit("kernel_conv3x3_dw", shape=list(shape), tile=C.dw_tile(ci, co),
             splits=C.dw_split_plan(L, B * H * W, ci, co)[1], normalised_err=err,
             tol=CONV_TOL, library_normalised_err=lib_err, repeatable=True,
             gflop=ops / 1e9, **row)
        if shape == CONV_REPORTED:
            entry = {"name": "conv3x3_dw", "route": "cuda",
                     "source": "fedml_tpu_torch/csrc/conv3x3.cu",
                     "replaces": "fedml_tpu/ops/conv.py:226", **row}
    return entry


# (clients, examples, H, W, Ci, Co): DP-SGD's per-example gradients inside the
# cohort vmap at resnet8's block shapes and its stem, cohort 4 of batch 8
CONV_NESTED = ((4, 8, 32, 32, 16, 16), (4, 8, 16, 16, 32, 32), (4, 8, 8, 8, 64, 64),
               (4, 8, 32, 32, 3, 16))
# bf16 under the nesting: the kernel's and the plain version's bf16 results
# may differ by one bf16 step (2^-8 to 2^-7 of a value) at each op, and those
# steps reach the gradients through tanh and the second conv: two steps of
# the largest magnitude leave margin, while a wrong tap, lane or route errs
# by O(1) of it (on an H100: 0.0030-0.0056 at these shapes; 0.16-1.0 with a
# tile or a k-step of the tensor-core dw dropped)
CONV_NESTED_TOL_BF16 = 2.0 ** -6


def check_conv_nested(dev):
    """Kernels 3a/3b under two vmap levels, as DP-SGD runs them: the
    gradient of a conv -> tanh -> conv loss per example (vmap over the
    batch of grad) per client (vmap over the cohort), in float32 and in
    bf16 (use_bf16: the block convs' dw on the tensor cores). The conv's
    vmap rule re-enters through the lane-level functions, so every launch
    sees the two levels folded into one lane axis (clients x examples). The
    result is held against the same nesting with the wrappers swapped for
    their plain versions, on the same inputs, within CONV_TOL (bf16:
    CONV_NESTED_TOL_BF16) of each gradient's largest magnitude; the weight
    gradients' launches by route must be the second conv's dw_route and the
    first's."""
    from collections import Counter

    from torch.func import grad, vmap

    from fedml_tpu_torch.ops import conv as C

    gen = torch.Generator().manual_seed(5)
    for shape, dtype in [(s, d) for d in (torch.float32, torch.bfloat16) for s in CONV_NESTED]:
        Cl, B, H, W, ci, co = shape
        x = torch.randn(Cl, B, H, W, ci, generator=gen).to(dev, dtype)
        w1 = (torch.randn(Cl, 3, 3, ci, co, generator=gen) * 0.3).to(dev, dtype)
        w2 = (torch.randn(Cl, 3, 3, co, co, generator=gen) * 0.3).to(dev, dtype)

        def loss(w, x1):
            h = torch.tanh(C.conv3x3(x1[None], w[0]))
            return (C.conv3x3(h, w[1]) ** 2).sum()

        run = vmap(vmap(grad(loss), in_dims=(None, 0)), in_dims=(0, 0))
        before = (C.conv3x3_lanes.launches, C.conv3x3_dw_lanes.launches)
        dw_before = dict(C.conv3x3_dw_lanes.route_launches)
        got = run((w1, w2), x)
        launches = (C.conv3x3_lanes.launches - before[0], C.conv3x3_dw_lanes.launches - before[1])
        dw_routes = {r: n - dw_before[r] for r, n in C.conv3x3_dw_lanes.route_launches.items()
                     if n != dw_before[r]}
        want_routes = Counter((C.dw_route(ci, co, dtype), C.dw_route(co, co, dtype)))
        kernels = (C._Conv3x3Lanes.kernel, C._Conv3x3DwLanes.kernel)
        C._Conv3x3Lanes.kernel = staticmethod(C.conv3x3_plain)
        C._Conv3x3DwLanes.kernel = staticmethod(C.conv3x3_dw_plain)
        try:
            want = run((w1, w2), x)
        finally:
            C._Conv3x3Lanes.kernel, C._Conv3x3DwLanes.kernel = map(staticmethod, kernels)
        # each gradient's error against its largest magnitude
        errs = [((g.float() - wt.float()).abs().max() / wt.float().abs().max()).item()
                for g, wt in zip(got, want)]
        tol = CONV_NESTED_TOL_BF16 if dtype == torch.bfloat16 else CONV_TOL
        # two forwards, one dx (the first conv's input needs none), two dw
        if launches != (3, 2) or dw_routes != want_routes or not max(errs) <= tol:
            raise AssertionError(f"nested-vmap conv at {shape} {dtype}: launches {launches} "
                                 f"(want (3, 2)), dw routes {dw_routes} (want {want_routes}), "
                                 f"normalised errors {errs} (tol {tol})")
        emit("kernel_conv3x3_nested", shape=list(shape), dtype=str(dtype), lanes=Cl * B,
             launches=list(launches), dw_route_launches=dw_routes, normalised_err=max(errs),
             tol=tol, max_abs_err=max((g.float() - wt.float()).abs().max().item()
                                      for g, wt in zip(got, want)))


def small_resnet_config(device, cohort_schedule="even"):
    return dict(dataset="cifar10", model="resnet8", conv_impl="pallas",
                cohort_schedule=cohort_schedule, debug_small_data=True, client_num_in_total=8,
                client_num_per_round=4, comm_round=2, learning_rate=0.05, batch_size=32,
                frequency_of_the_test=1, random_seed=0, device=device)


def _conv_launches():
    from fedml_tpu_torch.ops import conv as C

    return C.conv3x3_lanes.launches + C.conv3x3_dw_lanes.launches


def phase_small_resnet():
    """resnet8 FedAvg with conv_impl pallas under the even, packed and
    bucketed schedules, on the card (the conv kernels, at the schedules'
    lane counts) vs on the CPU (their plain versions)."""
    import fedml_tpu_torch as ft
    from fedml_tpu_torch.simulation import SimulatorSingleProcess

    for schedule in ("even", "packed", "bucketed"):
        hist, lanes = {}, None
        for device in ("cuda", "cpu"):
            before = _conv_launches()
            runner = SimulatorSingleProcess(ft.init(config=small_resnet_config(device, schedule)))
            if runner.sim.schedule != schedule:
                raise AssertionError(f"small_resnet resolved {runner.sim.schedule}, not {schedule}")
            hist[device] = runner.run()
            if device == "cuda":
                if _conv_launches() == before:
                    raise AssertionError(f"small_resnet {schedule} launched no conv kernel")
                sim = runner.sim
                lanes = [_lanes(sim.build_round_inputs(r)) for r in range(len(hist[device]))]
        for rg, rc in zip(hist["cuda"], hist["cpu"]):
            # fp32 conv and GroupNorm sums in another order: ~1e-6 per SGD
            # step, grown through 2 rounds of 5 steps; measured 1.4e-4
            # between an H100 and the CPU (the CPU tests measure ~5e-5
            # between the port and JAX), so 5e-4 relative leaves a 3x margin
            for k in ("train_loss", "test_loss"):
                if not abs(rg[k] - rc[k]) <= 5e-4 * max(1.0, abs(rc[k])):
                    raise AssertionError(f"small_resnet {schedule} {k} differs: "
                                         f"{rg[k]} vs {rc[k]}")
            if not abs(rg["test_acc"] - rc["test_acc"]) <= 1.0 / 200 + 1e-9:  # one of 200
                raise AssertionError(f"small_resnet {schedule} test_acc differs: {rg} vs {rc}")
        emit("small_resnet", cohort_schedule=schedule, lanes_per_round=lanes,
             cuda=[(r["train_loss"], r["test_loss"], r["test_acc"]) for r in hist["cuda"]],
             cpu=[(r["train_loss"], r["test_loss"], r["test_acc"]) for r in hist["cpu"]])


# resnet8 bf16, card against CPU: the card's bf16 kernels and the CPU's plain
# versions round the same float32 sums to bf16, but every other op of the
# model rounds to bf16 too, and a differing bit moves the trajectory:
# measured 6e-5 relative in loss after 2 rounds on an H100; 2e-3 leaves 30x
BF16_SLICE_TOL = 2e-3


def phase_small_bn():
    """resnet8 with BatchNorm on the card against the CPU: float32 under
    the even and bucketed schedules within small_resnet's 5e-4, and under
    use_bf16 (even) within BF16_SLICE_TOL; then the dropout CNN (model:
    cnn, its keep masks drawn per client step from generators keyed by
    seed, round, position and step): the card's final model evaluates on
    the CPU as it did on the card."""
    import fedml_tpu_torch as ft
    from fedml_tpu_torch.simulation import build_simulator

    for name, extra, tol in (("bn_even", dict(norm="batch"), 5e-4),
                             ("bn_bucketed", dict(norm="batch", cohort_schedule="bucketed"),
                              5e-4),
                             ("bn_bf16_even", dict(norm="batch", use_bf16=True), BF16_SLICE_TOL)):
        hist, sims = {}, {}
        for device in ("cuda", "cpu"):
            before = _conv_launches()
            sims[device], apply_fn = build_simulator(ft.init(config=dict(
                small_resnet_config(device, extra.get("cohort_schedule", "even")), **extra)))
            hist[device] = sims[device].run(apply_fn, log_fn=None)
            if device == "cuda" and _conv_launches() == before:
                raise AssertionError(f"small {name} launched no conv kernel")
        for rg, rc in zip(hist["cuda"], hist["cpu"]):
            for k in ("train_loss", "test_loss"):
                if not (math.isfinite(rg[k]) and abs(rg[k] - rc[k]) <= tol * max(1.0, abs(rc[k]))):
                    raise AssertionError(f"small {name} {k} differs: {rg[k]} vs {rc[k]} "
                                         f"(tol {tol})")
        gs, cs = sims["cuda"].params, sims["cpu"].params
        stats_err = max(((gs[k].cpu() - v).abs().max() / v.abs().max().clamp_min(1e-6)).item()
                        for k, v in cs.items() if k.startswith("batch_stats/"))
        emit("small_bn", case=name, schedule=sims["cuda"].schedule, tol=tol,
             batch_stats_rel_err=stats_err,
             cuda=[(r["train_loss"], r["test_loss"], r["test_acc"]) for r in hist["cuda"]],
             cpu=[(r["train_loss"], r["test_loss"], r["test_acc"]) for r in hist["cpu"]])

    cfg = dict(algorithm_base("cuda"), model="cnn", comm_round=2)
    sim, apply_fn = build_simulator(ft.init(config=cfg))
    hist = sim.run(apply_fn, log_fn=None)
    cpu, cpu_apply = build_simulator(ft.init(config=dict(cfg, device="cpu")),
                                     variables={k: v.cpu() for k, v in sim.params.items()})
    on_cpu = cpu.evaluate(cpu_apply)
    # the same weights: float32 convs on cuDNN and on the CPU, ~1e-7 apart
    if not (abs(on_cpu["test_loss"] - hist[-1]["test_loss"]) <= 1e-5 * hist[-1]["test_loss"]
            and abs(on_cpu["test_acc"] - hist[-1]["test_acc"]) <= 1.0 / 1000 + 1e-9):
        raise AssertionError(f"cnn dropout: the card's model evaluates to {hist[-1]} on the "
                             f"card, {on_cpu} on the CPU")
    emit("small_dropout", model="cnn", rounds=len(hist),
         train_loss=[r["train_loss"] for r in hist], card_eval=hist[-1]["test_loss"],
         cpu_eval=on_cpu["test_loss"], card_acc=hist[-1]["test_acc"],
         cpu_acc=on_cpu["test_acc"])


def algorithm_base(device):
    """The small lr config the algorithms phase varies."""
    return dict(dataset="mnist", model="lr", debug_small_data=True, client_num_in_total=10,
                client_num_per_round=10, comm_round=3, learning_rate=0.1, batch_size=10,
                frequency_of_the_test=1, random_seed=0, device=device)


# (name, overrides of algorithm_base or of small_resnet_config): every
# federated optimizer, client optimizer and defense of the port
ALGORITHM_CASES = (
    ("fedprox", dict(federated_optimizer="FedProx")),
    ("fedopt_sgd", dict(federated_optimizer="FedOpt", server_lr=0.5, server_momentum=0.9)),
    ("fedopt_adam", dict(federated_optimizer="FedOpt", server_optimizer="adam",
                         server_lr=0.01, cohort_schedule="packed")),
    ("fedopt_yogi", dict(federated_optimizer="FedOpt", server_optimizer="yogi",
                         server_lr=0.01)),
    ("fedopt_adagrad", dict(federated_optimizer="FedOpt", server_optimizer="adagrad",
                            server_lr=0.05, cohort_schedule="bucketed")),
    ("fednova", dict(federated_optimizer="FedNova")),
    ("scaffold", dict(federated_optimizer="SCAFFOLD", client_state_capacity=10)),
    ("momentum_decay_packed", dict(momentum=0.9, weight_decay=5e-4, cohort_schedule="packed")),
    ("adam_bucketed", dict(client_optimizer="adam", learning_rate=0.003,
                           cohort_schedule="bucketed")),
    ("dp_clip", dict(dp_l2_clip=1.0)),
    # one round: cnn_fedavg on this small split is sensitive to float
    # rounding (on the CPU, parameters perturbed by 1e-7 move the test loss
    # 4.7e-5 after one round, 1.8e-4 after two, 4.1e-4 after three, with the
    # codec or without), and cuDNN against the CPU's conv drifted 1.4e-3
    # apart over three rounds
    ("norm_diff_clipping_q8", dict(model="cnn_fedavg", learning_rate=0.005, comm_round=1,
                                   federated_optimizer="FedAvg_robust", norm_bound=1.0,
                                   comm_codec="q8", agg_kernels=True, sanitize_updates=True)),
    ("weak_dp", dict(federated_optimizer="FedAvg_robust", defense_type="weak_dp",
                     norm_bound=1.0, sanitize_updates=True)),
    ("coordinate_median", dict(federated_optimizer="FedAvg_robust",
                               defense_type="coordinate_median", sanitize_updates=True)),
    ("trimmed_mean", dict(federated_optimizer="FedAvg_robust", defense_type="trimmed_mean",
                          trim_ratio=0.2, sanitize_updates=True)),
    ("resnet8_scaffold", dict(federated_optimizer="SCAFFOLD")),
    ("resnet8_dp_clip", dict(dp_l2_clip=1.0)),
)


def phase_algorithms():
    """Each case run on the card and on the CPU (the plain kernel versions)
    through init + build_simulator: train and test losses within 1e-3, the
    sanitizer's quarantine sets equal, the schedule the same. The resnet8
    cases run the conv kernels (DP-SGD's under two vmap levels: per-example
    gradients inside the cohort vmap) and hold every parameter within 5e-4
    of the model's largest magnitude. weak_dp runs at stddev 0 here
    (torch's CUDA and CPU generators draw different streams); its noise is
    held by the repeat phase."""
    import fedml_tpu_torch as ft
    from fedml_tpu_torch.ops import agg_quant
    from fedml_tpu_torch.simulation import build_simulator

    def counts():
        return (_conv_launches(), agg_quant.quantize_pack.launches)

    for name, over in ALGORITHM_CASES:
        resnet = name.startswith("resnet8")
        out = {}
        for device in ("cuda", "cpu"):
            base = small_resnet_config(device) if resnet else algorithm_base(device)
            before = counts()
            t = time.perf_counter()
            sim, apply_fn = build_simulator(ft.init(config=dict(base, **over)))
            hist = sim.run(apply_fn, log_fn=None)
            if device == "cuda":
                torch.cuda.synchronize()
            out[device] = (sim.schedule, hist, {k: v.detach().cpu() for k, v in
                                                sim.params.items()},
                           time.perf_counter() - t,
                           [a - b for a, b in zip(counts(), before)])
            del sim
        (sg, hg, pg, wall, (launches, quant)), (sc, hc, pc, _, _) = out["cuda"], out["cpu"]
        if sg != sc:
            raise AssertionError(f"algorithms {name}: schedule {sg} on the card, {sc} on the CPU")
        if (resnet and launches == 0) or ("comm_codec" in over and quant == 0):
            raise AssertionError(f"algorithms {name} launched no conv ({launches}) or "
                                 f"quantize ({quant}) kernel")
        for rg, rc in zip(hg, hc):
            if rg.get("quarantined") != rc.get("quarantined"):
                raise AssertionError(f"algorithms {name}: quarantine differs: {rg} vs {rc}")
            for k in ("train_loss", "test_loss"):
                if k in rc and not abs(rg[k] - rc[k]) <= 1e-3 * max(1.0, abs(rc[k])):
                    raise AssertionError(f"algorithms {name} {k} differs: {rg[k]} vs {rc[k]}")
        # every parameter's error against the model's largest magnitude: a
        # leaf near zero (a GroupNorm bias) moves by ~1% of itself when the
        # initial weights move by 1e-6 (resnet8 FedAvg on the CPU), while
        # the model-wide error stays at 6.8e-5 (SCAFFOLD too; DP-SGD 2.9e-6)
        rel = max((pg[k] - pc[k]).abs().max().item() for k in pc) / \
            max(pc[k].abs().max().item() for k in pc)
        if resnet and not rel <= 5e-4:
            raise AssertionError(f"algorithms {name}: parameters differ by {rel} of the "
                                 f"largest magnitude (5e-4 allowed)")
        emit("algorithms", case=name, overrides=over, cohort_schedule=sg, wall_s=wall,
             conv_launches=launches, quantize_launches=quant,
             train_loss=[r["train_loss"] for r in hg],
             cpu_train_loss=[r["train_loss"] for r in hc],
             quarantined=[r.get("quarantined") for r in hg], param_rel_diff_vs_cpu=rel)


def _lanes(inputs):
    """(lanes, steps) of one round's plan: (G, L_pad) packed, the buckets'
    (slots, width) bucketed, (clients, batches) even."""
    p = inputs.payload
    if inputs.kind == "packed":
        return list(p["shape"])
    if inputs.kind == "bucketed":
        return [list(b["payload"]["mask"].shape[:2]) for b in p]
    return list(p["mask"].shape[:2])


RESNET_YAML = Path(__file__).resolve().parent / \
    "examples/tpu_fedavg_cifar10_resnet56/fedml_config.yaml"
# cut: 1 epoch instead of 20, 1 round instead of 100 (2 until lm_xxl,
# small_lm_512 and small_lm_1536 joined the run; each phase's profiled round
# runs on a fresh simulator after it, warm). The port runs one
# card with the sp engine (the YAML's backend: TPU mesh is not ported), and
# conv_impl pallas engages the conv kernels; the YAML's cohort_schedule
# (auto: packed on this skewed partition) and checkpointing stay, with
# checkpoint_dir pointed at a temporary directory by the phase.
RESNET_OVERRIDES = dict(conv_impl="pallas", epochs=1, comm_round=1, backend="sp",
                        device="cuda")


def resnet_args(**extra):
    from fedml_tpu_torch import load_arguments

    return load_arguments(args_list=["--cf", str(RESNET_YAML)],
                          override=dict(RESNET_OVERRIDES, **extra))


def _resnet_conv_channels(args):
    """(Ci, Co) of each stride-1 3x3 pallas conv of the config's model."""
    from fedml_tpu_torch import models as models_mod
    from fedml_tpu_torch.ops import conv as C

    model = models_mod.create(args, 10, (32, 32, 3))
    return [tuple(m.kernel.shape[2:]) for m in model.modules()
            if isinstance(m, C.Conv) and m.impl == "pallas" and m.stride == 1
            and tuple(m.kernel.shape[:2]) == (3, 3)]


def _resnet_conv_want(args, sim, conv_channels, plans):
    """(evals, eval batches, launches, launches per route) that the
    simulator's round plans imply: per local step (a packed slot, padded
    ones included, an even step of all clients, or a bucket's step of its
    clients), one forward per stride-1 3x3 conv, one dx per such conv but
    the stem (its input, the data, needs no gradient) and one dw per conv;
    per eval, one forward per conv and test batch of 256. Under use_bf16
    the kernels are the bf16 routes (launches keyed ``conv3x3_bf16``,
    ``conv3x3_stem_bf16`` and ``conv3x3_dw_bf16``, _launch_keys). Launches
    per route: {"conv3x3": forward routes, "conv3x3_dw": weight-gradient
    routes}."""
    from fedml_tpu_torch.ops import conv as C
    from fedml_tpu_torch.simulation.fed_sim import EVAL_BATCH_SIZE

    rounds, freq = len(plans), int(args.frequency_of_the_test)
    convs = len(conv_channels)
    evals = sum(1 for r in range(rounds) if r % freq == 0 or r == rounds - 1)
    eval_batches = -(-sim._x_test.shape[0] // EVAL_BATCH_SIZE)
    epochs = int(args.epochs)
    # a packed plan's slots already hold every epoch; an even plan's batches
    # and each bucket's width run once per epoch
    if sim.schedule == "bucketed":
        steps = sum(w for plan in plans for _, w in plan) * epochs
    else:
        steps = sum(n for _, n in plans) * (1 if sim.schedule == "packed" else epochs)
    dtype = torch.bfloat16 if getattr(args, "use_bf16", False) else torch.float32
    # per forward route: each conv's forward at its (Ci, Co), its dx (not
    # the stem's) at (Co, Ci); per weight-gradient route each conv's dw
    fwd, dw = dict.fromkeys(C.FWD_ROUTES, 0), dict.fromkeys(C.DW_ROUTES, 0)
    for i, (ci, co) in enumerate(conv_channels):
        fwd[C.fwd_route(ci, co, dtype)] += steps + evals * eval_batches
        if i:
            fwd[C.fwd_route(co, ci, dtype)] += steps
        dw[C.dw_route(ci, co, dtype)] += steps
    if (sum(fwd.values()), sum(dw.values())) != (
            steps * (convs + convs - 1) + evals * eval_batches * convs, steps * convs):
        raise AssertionError(f"the conv plans by route {fwd}, {dw} miss a launch")
    want = {k: v for k, v in _launch_keys(fwd, dw).items() if v}
    return evals, eval_batches, want, {"conv3x3": fwd, "conv3x3_dw": dw}


def _launch_keys(fwd, dws):
    """Conv launches keyed by the kernels line's names, from launches per
    forward route (``fwd``) and weight-gradient route (``dws``)."""
    return {"conv3x3": fwd["tf32x3"] + fwd["fma"], "conv3x3_dw": dws["fma"],
            "conv3x3_stem": fwd.get("stem_tf32x3", 0),  # a checkout may lack the route
            "conv3x3_bf16": fwd["bf16_tc"] + fwd["fma_bf16"],
            "conv3x3_stem_bf16": fwd.get("stem_bf16", 0),  # a checkout may lack the route
            "conv3x3_dw_bf16": dws["bf16_tc"] + dws["fma_bf16"]}


def _counted(run, shapes=None):
    """``run()`` with the conv kernels' counts set to 0 just before it and
    read just after: (its result, launches by kernel, launches per route:
    {"conv3x3": forward routes, "conv3x3_dw": weight-gradient routes}).
    With a dict ``shapes``, it also receives the forward launches by route
    and (L, B, H, W, Ci, Co), counted around the route call the wrapper
    makes."""
    from collections import Counter

    from fedml_tpu_torch.ops import conv as C

    by_shape = Counter()
    fwd_route_call = C.conv3x3_fwd_route

    def tallied(x, w, route):
        by_shape[(route,) + tuple(x.shape) + (w.shape[-1],)] += 1
        return fwd_route_call(x, w, route)

    C.conv3x3_lanes.launches = 0
    C.conv3x3_lanes.route_launches = dict.fromkeys(C.FWD_ROUTES, 0)
    C.conv3x3_dw_lanes.launches = 0
    C.conv3x3_dw_lanes.route_launches = dict.fromkeys(C.DW_ROUTES, 0)
    if shapes is not None:
        C.conv3x3_fwd_route = tallied
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        C.conv3x3_fwd_route = fwd_route_call
    routes = {"conv3x3": dict(C.conv3x3_lanes.route_launches),
              "conv3x3_dw": dict(C.conv3x3_dw_lanes.route_launches)}
    launches = _launch_keys(routes["conv3x3"], routes["conv3x3_dw"])
    if sum(launches.values()) != C.conv3x3_lanes.launches + C.conv3x3_dw_lanes.launches:
        raise AssertionError(f"conv launches by route {routes} do not add up")
    if shapes is not None:
        if sum(by_shape.values()) != C.conv3x3_lanes.launches:
            raise AssertionError(f"conv forwards by shape {dict(by_shape)} do not add up")
        shapes.update({" ".join(map(str, k)): n for k, n in sorted(by_shape.items())})
    return out, {k: v for k, v in launches.items() if v}, routes


def phase_resnet_main():
    """ResNet-56 FedAvg through load_arguments + init + the single-process
    simulator, under the YAML's own cohort schedule (auto -> packed) and
    checkpointing. The conv kernels' launches must equal what the
    simulator's own round plans imply: per packed slot (L_pad of them per
    round, padded ones included), one forward per stride-1 3x3 conv, one
    dx per such conv but the stem (its input, the data, needs no gradient)
    and one dw per conv; per eval, one forward per conv and test batch of
    256. The last round's checkpoint must exist."""
    import tempfile

    import fedml_tpu_torch as ft
    from fedml_tpu_torch.simulation import SimulatorSingleProcess
    from fedml_tpu_torch.utils.checkpoint import CheckpointManager

    with tempfile.TemporaryDirectory(prefix="resnet56_ckpt_") as ckpt_dir:
        args = ft.init(resnet_args(checkpoint_dir=ckpt_dir))
        conv_channels = _resnet_conv_channels(args)
        convs = len(conv_channels)
        torch.cuda.reset_peak_memory_stats()
        runner = SimulatorSingleProcess(args)
        sim = runner.sim
        if sim.schedule != "packed":
            raise AssertionError(f"the ResNet-56 example resolved {sim.schedule}, not packed")
        rounds = int(args.comm_round)
        plans = [_lanes(sim.build_round_inputs(r)) for r in range(rounds)]
        evals, eval_batches, want, want_routes = _resnet_conv_want(args, sim, conv_channels,
                                                                   plans)
        t = time.perf_counter()
        hist, launches, routes = _counted(runner.run)
        wall = time.perf_counter() - t
        saved = CheckpointManager(ckpt_dir).steps()
        if saved != [rounds - 1]:
            raise AssertionError(f"resnet main path checkpoints {saved}, expected the last "
                                 f"round's, {rounds - 1}")
    if launches != want or routes != want_routes:
        raise AssertionError(f"resnet main path launches {launches}, by forward route {routes}; "
                             f"expected {want}, {want_routes} ({convs} convs, lanes x slots "
                             f"{plans}, {evals} evals)")
    losses = [r["train_loss"] for r in hist]
    if len(hist) != rounds or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"resnet main path history not finite: {losses}")
    evals_seen = [r for r in hist if "test_acc" in r]
    if len(evals_seen) != evals or not all(
            math.isfinite(r["test_loss"]) and 0.0 <= r["test_acc"] <= 1.0 for r in evals_seen):
        raise AssertionError(f"bad eval records {evals_seen}")
    emit("resnet_main", config=str(RESNET_YAML.relative_to(RESNET_YAML.parents[2])),
         overrides=RESNET_OVERRIDES, cohort_schedule=sim.schedule,
         lanes_slots_per_round=plans, convs_3x3_s1=convs, evals=evals,
         eval_batches=eval_batches, checkpoints=saved, wall_s=wall, train_loss=losses,
         train_acc=[r["train_acc"] for r in hist],
         test=[(r["round"], r["test_loss"], r["test_acc"]) for r in evals_seen],
         round_time_s=[r["round_time"] for r in hist], launches=launches,
         conv3x3_route_launches=routes, peak_mem_bytes=torch.cuda.max_memory_allocated())
    return launches


def phase_resnet_profile():
    """Where a ResNet-56 round's time goes, one warm round 0 under packed
    and one under even, each on a fresh simulator without checkpoints. The
    packed round is the program resnet_main just ran (its warm-up, and its
    unprofiled time); the even one runs one round first, timed. Round 0 of
    the even schedule trains the same clients on the same batches as round
    0 of packed."""
    import fedml_tpu_torch as ft
    from fedml_tpu_torch.simulation import build_simulator

    ours = CONV_FWD_KERNELS + CONV_DW_KERNELS
    out = {}
    for schedule in ("packed", "even"):
        sim, _ = build_simulator(ft.init(resnet_args(comm_round=1, checkpoint_dir=None,
                                                     cohort_schedule=schedule)))
        row = {"lanes_slots": _lanes(sim.build_round_inputs(0))}
        if schedule == "even":  # the warm-up, timed as an unprofiled round
            t = time.perf_counter()
            sim.run(None, log_fn=None)
            torch.cuda.synchronize()
            row["unprofiled_round_s"] = time.perf_counter() - t
        out[schedule] = dict(row, **profile_run(lambda: sim.run(None, log_fn=None), 1, ours))
        del sim
    emit("resnet_profile", **out)


def _stateful_resnet_phase(name, extra, want_schedule, check_ckpt, by_shape=False):
    """One algorithm or model variant on the ResNet-56 example at full
    width: the YAML through load_arguments(--cf) with resnet_main's
    overrides and ``extra``, 1 round of one epoch with checkpoints in a
    temporary directory; the schedule ``auto`` must resolve to (a callable:
    of the simulator), conv launches equal to the round plans, the last
    round's checkpoint checked by ``check_ckpt(saved state, runner)``; then
    one more round on a fresh simulator (no checkpoints) under the
    profiler: wall, device busy and idle share; with ``by_shape`` the
    counted run's forward launches by route and shape (_counted). Returns
    (its row, the launches)."""
    import tempfile

    import fedml_tpu_torch as ft
    from fedml_tpu_torch.simulation import SimulatorSingleProcess, build_simulator
    from fedml_tpu_torch.utils.checkpoint import CheckpointManager

    with tempfile.TemporaryDirectory(prefix="resnet56_ckpt_") as ckpt_dir:
        args = ft.init(resnet_args(checkpoint_dir=ckpt_dir, **extra))
        conv_channels = _resnet_conv_channels(args)
        torch.cuda.reset_peak_memory_stats()
        runner = SimulatorSingleProcess(args)
        sim = runner.sim
        if callable(want_schedule):
            want_schedule = want_schedule(sim)
        if sim.schedule != want_schedule:
            raise AssertionError(f"resnet {name} resolved {sim.schedule}, not {want_schedule}")
        rounds = int(args.comm_round)
        plans = [_lanes(sim.build_round_inputs(r)) for r in range(rounds)]
        evals, eval_batches, want, want_routes = _resnet_conv_want(args, sim, conv_channels,
                                                                   plans)
        shapes = {} if by_shape else None
        t = time.perf_counter()
        hist, launches, routes = _counted(runner.run, shapes)
        wall = time.perf_counter() - t
        ckpt = CheckpointManager(ckpt_dir)
        saved = ckpt.steps()
        if saved != [rounds - 1]:
            raise AssertionError(f"resnet {name} checkpoints {saved}, expected [{rounds - 1}]")
        ckpt_info = check_ckpt(ckpt.restore(), runner)
    if launches != want or routes != want_routes:
        raise AssertionError(f"resnet {name} launches {launches}, by forward route {routes}; "
                             f"expected {want}, {want_routes} (plans {plans}, {evals} evals)")
    losses = [r["train_loss"] for r in hist]
    evals_seen = [r for r in hist if "test_acc" in r]
    if len(hist) != rounds or not all(math.isfinite(v) for v in losses) or \
            len(evals_seen) != evals or not all(math.isfinite(r["test_loss"])
                                                for r in evals_seen):
        raise AssertionError(f"resnet {name} history: {hist}")
    row = dict(config=str(RESNET_YAML.relative_to(RESNET_YAML.parents[2])),
               overrides=dict(RESNET_OVERRIDES, **extra), cohort_schedule=sim.schedule,
               lanes_slots_per_round=plans, evals=evals, checkpoint=ckpt_info,
               wall_s=wall, train_loss=losses,
               test=[(r["round"], r["test_loss"], r["test_acc"]) for r in evals_seen],
               round_time_s=[r["round_time"] for r in hist], launches=launches,
               conv3x3_route_launches=routes, peak_mem_bytes=torch.cuda.max_memory_allocated())
    if by_shape:
        row["fwd_launches_by_route_shape"] = shapes
    if sim._arena is not None:
        row["arena_bytes"] = sim._arena.nbytes
        row["arena_capacity"] = sim._arena.capacity
    del runner, sim
    psim, _ = build_simulator(ft.init(resnet_args(comm_round=1, checkpoint_dir=None, **extra)))
    row["profile"] = profile_run(lambda: psim.run(None, log_fn=None), 1,
                                 CONV_FWD_KERNELS + CONV_DW_KERNELS)
    row["profile"]["lanes_slots"] = _lanes(psim.build_round_inputs(0))
    del psim
    emit(f"resnet_{name}", **row)
    return row, launches


def phase_resnet_scaffold():
    """SCAFFOLD on the ResNet-56 example: not mean-aggregating, so auto
    resolves to even (10 clients per step); each client's (c, c_i) is
    gathered from the client-state arena (100 slots x 2 x 855,770 float32)
    before the round and scattered after it."""

    def check(state, runner):
        sim = runner.sim
        c = state["server_state"]["c"]
        arena = state["client_arena"]
        if set(c) != set(sim.params) or len(arena["leaves"]) != 2 * len(sim.params):
            raise AssertionError("the SCAFFOLD checkpoint lacks the control variates")
        return {"server_c_leaves": len(c), "arena_leaves": len(arena["leaves"]),
                "arena_clients": int((arena["slot_client"] >= 0).sum())}

    _stateful_resnet_phase("scaffold", dict(federated_optimizer="SCAFFOLD"), "even", check)


def _bn_auto_rule(sim):
    """The schedule JAX's auto rule (fed_sim.py:547, :566-570) gives a
    BatchNorm model, which is never packed: bucketed where the population
    is skewed (the largest client at least twice the median's batches),
    else even."""
    counts = np.asarray(list(sim._batch_counts.values()))
    return "bucketed" if counts.max() >= 2 * max(np.median(counts), 1) else "even"


def _bn_check(state, runner):
    """The checkpoint holds every running statistic (114 leaves for
    ResNet-56's 57 BatchNorms), finite and moved off its initial value,
    beside the params; and evaluation reads them: the final model
    evaluates as the last round's eval did, and differently with the
    statistics reset to their initial values."""
    sim = runner.sim
    stats = {k: v for k, v in state["params"].items() if k.startswith("batch_stats/")}
    if not stats or set(state["params"]) != set(sim.params) or not all(
            torch.isfinite(v).all() for v in stats.values()) or not any(
            v.any() for k, v in stats.items() if k.endswith("/mean")):
        raise AssertionError(f"the BatchNorm checkpoint's batch_stats are wrong: {len(stats)} "
                             "leaves")
    trained = sim.evaluate(runner.apply_fn)
    if trained != {k: sim.history[-1][k] for k in trained}:
        raise AssertionError(f"re-evaluating the final model gives {trained}, the last round "
                             f"gave {sim.history[-1]}")
    saved = sim.params
    sim.params = {k: (torch.ones_like(v) if k.endswith("/var") else torch.zeros_like(v))
                  if k in stats else v for k, v in saved.items()}
    reset = sim.evaluate(runner.apply_fn)
    sim.params = saved
    if reset["test_loss"] == trained["test_loss"]:
        raise AssertionError("evaluation does not read the running statistics")
    return {"batch_stats_leaves": len(stats), "eval": trained, "eval_initial_stats": reset}


def phase_resnet_bn():
    """ResNet-56 with norm: batch (the reference's flagship) under FedAvg
    on the example YAML: BatchNorm never packs, so auto resolves by the JAX
    rule (bucketed on this skewed partition); every round trains and
    averages the running statistics beside the params; evaluation reads
    them (_bn_check); launches equal the plans."""
    return _stateful_resnet_phase("bn", dict(norm="batch"), _bn_auto_rule, _bn_check)


def phase_resnet_bf16(bn_row):
    """The same with use_bf16: true: bf16 compute over float32 parameters,
    every stride-1 3x3 conv on the bf16 kernels (the block convs' forward,
    dx and dw on the tensor cores, the stem's forward on its own
    tensor-core kernel, its dw on the FMA kernel; dw in float32 sums
    rounded to bf16), launches by route equal the plans (zero on the
    float32 routes), the forward's also by shape; the loss finite. Round
    and device times beside resnet_bn's."""
    row, launches = _stateful_resnet_phase("bf16", dict(norm="batch", use_bf16=True),
                                           _bn_auto_rule, _bn_check, by_shape=True)
    routes = row["conv3x3_route_launches"]
    if not (all(routes["conv3x3"][r] for r in ("bf16_tc", "stem_bf16")) and
            all(routes["conv3x3_dw"][r] for r in ("bf16_tc", "fma_bf16"))):
        raise AssertionError(f"resnet bf16 did not run every bf16 kernel: {routes}, {launches}")
    emit("resnet_bf16_vs_f32", round_time_s={"bn_f32": bn_row["round_time_s"],
                                             "bn_bf16": row["round_time_s"]},
         profiled_round={k: {m: r["profile"][m] for m in (
             "wall_ms_per_round", "device_busy_ms_per_round", "idle_share",
             "our_kernels_ms_per_round")} for k, r in (("bn_f32", bn_row), ("bn_bf16", row))})
    return launches


def phase_resnet_fedopt():
    """FedOpt on the ResNet-56 example with a server adam (lr 0.01) and
    client momentum 0.9 with weight decay 5e-4: mean-aggregating and
    stateless on the clients, so auto resolves to packed with one lane;
    each lane carries its momentum trace, reset at client boundaries. The
    last round's checkpoint holds adam's count, mu and nu."""

    def check(state, runner):
        sim = runner.sim
        adam = state["server_state"][0]
        if int(adam["count"]) != int(sim.cfg.comm_round) or \
                set(adam["mu"]) != set(sim.params) or set(adam["nu"]) != set(sim.params):
            raise AssertionError(f"the FedOpt checkpoint's adam state is wrong: count "
                                 f"{adam.get('count')}")
        return {"adam_count": int(adam["count"]), "adam_leaves": len(adam["mu"])}

    _stateful_resnet_phase("fedopt", dict(federated_optimizer="FedOpt", server_optimizer="adam",
                                          server_lr=0.01, momentum=0.9, weight_decay=5e-4),
                           "packed", check)


def phase_mnist_lr_main():
    """The North star's main path: examples/sp_fedavg_mnist_lr/fedml_config.yaml
    (plain FedAvg on lr, full-size synthetic MNIST, 1000 clients, alpha 0.5,
    eval every 5) through load_arguments(--cf) + init + the single-process
    simulator, with comm_round cut to 10 of 200. Its cohort schedule
    resolves to packed. It runs no kernel of the port (lr's local step is
    dense matmuls, cuBLAS), which the launch counters confirm. The same
    config runs on the CPU: card and CPU agree within the CPU test's
    tolerance (tests/test_torch_schedule.py, where the port meets JAX)."""
    import fedml_tpu_torch as ft
    from fedml_tpu_torch import load_arguments
    from fedml_tpu_torch.ops import agg_quant, agg_robust, flash_attention
    from fedml_tpu_torch.ops import conv as C
    from fedml_tpu_torch.simulation import SimulatorSingleProcess

    yaml = Path(__file__).resolve().parent / "examples/sp_fedavg_mnist_lr/fedml_config.yaml"
    counters = (agg_quant.quantize_pack, agg_robust.gram, C.conv3x3_lanes, C.conv3x3_dw_lanes,
                flash_attention.flash_forward, flash_attention.flash_dq,
                flash_attention.flash_dkv)
    hist, params, lanes = {}, {}, None
    for device in ("cuda", "cpu"):
        before = [c.launches for c in counters]
        runner = SimulatorSingleProcess(ft.init(load_arguments(
            args_list=["--cf", str(yaml)], override=dict(device=device, comm_round=10))))
        if runner.sim.schedule != "packed":
            raise AssertionError(f"sp_fedavg_mnist_lr resolved {runner.sim.schedule}, not packed")
        if device == "cuda":
            lanes = [_lanes(runner.sim.build_round_inputs(r)) for r in range(10)]
            t = time.perf_counter()
        hist[device] = runner.run()
        if device == "cuda":
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            if [c.launches for c in counters] != before:
                raise AssertionError("sp_fedavg_mnist_lr launched a kernel of the port")
        params[device] = {k: v.detach().cpu() for k, v in runner.sim.params.items()}
        del runner
    hc = hist["cuda"]
    if len(hc) != 10 or not all(math.isfinite(r["train_loss"]) for r in hc):
        raise AssertionError(f"sp_fedavg_mnist_lr history not finite: {hc}")
    evals = [r["round"] for r in hc if "test_acc" in r]
    if evals != [0, 5, 9] or not all(math.isfinite(hc[r]["test_loss"]) for r in evals):
        raise AssertionError(f"sp_fedavg_mnist_lr eval records at {evals}")
    # the CPU test's tolerances (port vs JAX: losses 1e-5 relative, parameters
    # 1e-6); accuracy within one test image of 10,000
    for rg, rc in zip(hc, hist["cpu"]):
        for k in ("train_loss", "test_loss"):
            if k in rc and not abs(rg[k] - rc[k]) <= 1e-5 * abs(rc[k]) + 1e-6:
                raise AssertionError(f"sp_fedavg_mnist_lr {k} differs: {rg[k]} vs {rc[k]}")
        if "test_acc" in rc and not abs(rg["test_acc"] - rc["test_acc"]) <= 1e-4 + 1e-9:
            raise AssertionError(f"sp_fedavg_mnist_lr test_acc differs: {rg} vs {rc}")
    diff = max((params["cuda"][k] - params["cpu"][k]).abs().max().item() for k in params["cpu"])
    if not diff <= 1e-6:
        raise AssertionError(f"sp_fedavg_mnist_lr parameters differ by {diff}")
    emit("mnist_lr_main", config=str(yaml.relative_to(yaml.parents[2])),
         overrides={"device": "cuda", "comm_round": 10}, cohort_schedule="packed",
         lanes_slots_per_round=lanes, kernel_launches=0, wall_s=wall,
         train_loss=[r["train_loss"] for r in hc],
         test=[(r, hc[r]["test_loss"], hc[r]["test_acc"]) for r in evals],
         round_time_s=[r["round_time"] for r in hc], param_max_abs_diff_vs_cpu=diff)


def phase_mnist_lr_dp(rounds=3):
    """The North star's YAML with DP-SGD at examples/dp_and_robust/main.py's
    defaults (clip 2.0, noise multiplier 0.1) at full size, 3 rounds: DP-SGD
    is never packed, so auto resolves to bucketed; per-example gradients
    and per-(client, step) noise on the card. Prints the run's conservative
    epsilon (core.dp.epsilon_for_training, delta 1e-5)."""
    import fedml_tpu_torch as ft
    from fedml_tpu_torch import load_arguments
    from fedml_tpu_torch.core import epsilon_for_training
    from fedml_tpu_torch.simulation import SimulatorSingleProcess

    yaml = Path(__file__).resolve().parent / "examples/sp_fedavg_mnist_lr/fedml_config.yaml"
    over = dict(device="cuda", comm_round=rounds, dp_l2_clip=2.0, dp_noise_multiplier=0.1)
    runner = SimulatorSingleProcess(ft.init(load_arguments(args_list=["--cf", str(yaml)],
                                                           override=over)))
    sim = runner.sim
    if sim.schedule != "bucketed":
        raise AssertionError(f"mnist_lr_dp resolved {sim.schedule}, not bucketed")
    lanes = [_lanes(sim.build_round_inputs(r)) for r in range(rounds)]
    t = time.perf_counter()
    hist = runner.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    losses = [r["train_loss"] for r in hist]
    evals = [r for r in hist if "test_acc" in r]
    if len(hist) != rounds or not all(math.isfinite(v) for v in losses) or not evals or \
            not all(math.isfinite(r["test_loss"]) and 0 <= r["test_acc"] <= 1 for r in evals):
        raise AssertionError(f"mnist_lr_dp history: {hist}")
    eps = epsilon_for_training(0.1, rounds, sim.num_local_batches)
    emit("mnist_lr_dp", config=str(yaml.relative_to(yaml.parents[2])), overrides=over,
         cohort_schedule=sim.schedule, buckets_per_round=lanes, wall_s=wall, train_loss=losses,
         test=[(r["round"], r["test_loss"], r["test_acc"]) for r in evals],
         round_time_s=[r["round_time"] for r in hist],
         steps_per_round=sim.num_local_batches, epsilon=eps, delta=1e-5)


RESUME_CASES = (
    ("fedavg", dict(cohort_schedule="packed")),
    # 6 arena slots for 8 clients: rows spill to the host and come back
    ("scaffold", dict(federated_optimizer="SCAFFOLD", client_state_capacity=6)),
    ("fedopt_adam", dict(federated_optimizer="FedOpt", server_optimizer="adam",
                         server_lr=0.01, cohort_schedule="packed")),
    # BatchNorm: the running statistics come from the file with the params
    ("bn_fedavg", dict(norm="batch")),
)


def phase_resume():
    """resnet8 on the card: four rounds uninterrupted, then two rounds with
    a checkpoint after each and a fresh simulator resuming to four, for
    FedAvg under packed, SCAFFOLD (the control variate and the arena's
    slots, map and spilled rows come from the file) and FedOpt with a
    server adam (its moments and count). Every round's metrics, the final
    parameters and the server state are bit-equal."""
    import tempfile

    import fedml_tpu_torch as ft
    from fedml_tpu_torch.simulation import build_simulator

    for name, over in RESUME_CASES:
        cfg = dict(small_resnet_config("cuda"), comm_round=4, frequency_of_the_test=2, **over)

        def run(**kw):
            sim, apply_fn = build_simulator(ft.init(config=dict(cfg, **kw)))
            return sim, sim.run(apply_fn, log_fn=None)

        full_sim, full = run()
        with tempfile.TemporaryDirectory(prefix="resnet8_ckpt_") as ckpt_dir:
            _, first = run(comm_round=2, checkpoint_dir=ckpt_dir, checkpoint_frequency=1)
            sim, second = run(checkpoint_dir=ckpt_dir, checkpoint_frequency=1)
        keys = ("round", "train_loss", "train_acc")
        resumed = first + second
        same_hist = [{k: r[k] for k in keys} for r in resumed] == \
            [{k: r[k] for k in keys} for r in full] and \
            all(second[i][k] == full[2 + i][k] for i in range(2)
                for k in ("test_loss", "test_acc"))
        same_params = all(torch.equal(sim.params[k], v) for k, v in full_sim.params.items())
        sa, sb = (torch.utils._pytree.tree_leaves(x.server_state) for x in (sim, full_sim))
        same_state = len(sa) == len(sb) and all(torch.equal(a, b) for a, b in zip(sa, sb))
        if sim._arena is not None:
            same_state = same_state and sim._arena.spilled_count > 0 and all(
                torch.equal(a, b)
                for cid in range(cfg["client_num_in_total"])
                for a, b in zip(torch.utils._pytree.tree_leaves(sim._arena.state_of(cid)),
                                torch.utils._pytree.tree_leaves(full_sim._arena.state_of(cid))))
        if not (same_hist and same_params and same_state
                and [r["round"] for r in second] == [2, 3]):
            raise AssertionError(f"resumed {name} run differs (history {same_hist}, params "
                                 f"{same_params}, state {same_state}): {resumed} vs {full}")
        emit("resume", case=name, model="resnet8", cohort_schedule=sim.schedule, rounds=4,
             resumed_at=2, train_loss=[r["train_loss"] for r in full], bit_equal=True)


# --- the Cheetah LM slice: flash attention ------------------------------------

# (B, T, H, Dh), dtype, causal: the LM slice's attention first (what the main
# path gives the kernels), then a full f32 shape with Dh 128, a ragged f32
# causal one, a small ragged bf16 one and a ragged full bf16 one (bf16 runs the
# tensor-core kernels, f32 the FMA ones); then Dh 256: the wide LM's attention
# (lm_wide: --dim 2048 over 8 heads), the wide float32 LM's (lm_wide_f32: the
# same widths at T 4352, where auto picks flash in f32), small_lm_256's (one
# head at T 4352), a full f32 one at T 4352 (the float32 kernels' non-causal
# branch), a ragged bf16 causal one, a ragged f32 causal one and a ragged full
# bf16 one (the bf16 kernels' non-causal branch, and TMA's zero fill at a T
# that is not a multiple of 64); last small_lm's attention (f32, one head of
# 64 at T 4096), small_lm_128's (f32, one head of 128 at T 4608), the float32
# LM's at --dim 1024 (lm_mid_f32: 8 heads of 128 at T 4608) and a ragged f32
# causal one at Dh 128
FLASH_SLICE = (2, 8192, 16, 64)
FLASH_WIDE = (8, 4608, 8, 256)
FLASH_WIDE_F32 = (8, 4352, 8, 256)
FLASH_SMALL_LM_256 = (1, 4352, 1, 256)
FLASH_F32_256_FULL = (1, 4352, 2, 256)
FLASH_F32_128 = (1, 2048, 8, 128)
FLASH_SMALL_LM = (1, 4096, 1, 64)
FLASH_SMALL_LM_128 = (1, 4608, 1, 128)
FLASH_MID_F32 = (8, 4608, 8, 128)
# lm_xl's attention: the Cheetah example at --dim 3072, 8 heads of 384, bf16;
# lm_xl_f32's is the same shape in float32, small_lm_384_f32's one head of it
FLASH_XL = (8, 4352, 8, 384)
FLASH_XL_F32 = FLASH_XL
FLASH_SMALL_LM_384 = (1, 4352, 1, 384)
# lm_xxl's attention: the Cheetah example at --dim 4096, 8 heads of 512, bf16;
# then every bf16 head dim of flash_wide_sm90.cu (Dh = 128 n, 512 ... 1536):
# one causal head at small_lm_1536's T 4224 (timed), a ragged full (2, 333,
# 3, Dh) (the non-causal branch, TMA's zero fill)
FLASH_XXL = (8, 4352, 8, 512)
FLASH_WIDE_DIMS = tuple(range(512, 1537, 128))
FLASH_WIDE_SWEEP_T = 4224
FLASH_SMALL_LM_1536 = (1, FLASH_WIDE_SWEEP_T, 1, 1536)
# lm_xxl_f32's attention: the same model trained in float32 at T 4224 (where
# auto picks flash with 4-byte items), 8 heads of 512; then every float32
# head dim of Dh = 128 n, 512 ... 896 (at 512 flash_f32_wgmma_sm90.cu's
# four-block clusters, above it flash_wide_f32_sm90.cu): one head of T
# 4224, causal (small_lm_512_f32's and small_lm_896_f32's) and full, timed,
# and ragged causal and full cases with B, H > 1 through the projection's
# strided views
FLASH_XXL_F32 = (8, FLASH_WIDE_SWEEP_T, 8, 512)
FLASH_F32_WIDE_DIMS = (512, 640, 768, 896)
FLASH_SMALL_LM_896 = (1, FLASH_WIDE_SWEEP_T, 1, 896)
FLASH_CASES = ((FLASH_SLICE, torch.bfloat16, True), (FLASH_F32_128, torch.float32, False),
               ((3, 333, 2, 64), torch.float32, True), ((2, 100, 3, 128), torch.bfloat16, True),
               ((1, 1000, 4, 64), torch.bfloat16, False),
               (FLASH_WIDE, torch.bfloat16, True), (FLASH_WIDE_F32, torch.float32, True),
               (FLASH_SMALL_LM_256, torch.float32, True),
               (FLASH_F32_256_FULL, torch.float32, False),
               ((2, 333, 3, 256), torch.bfloat16, True), ((3, 130, 2, 256), torch.float32, True),
               ((1, 1000, 2, 256), torch.bfloat16, False), (FLASH_SMALL_LM, torch.float32, True),
               (FLASH_SMALL_LM_128, torch.float32, True), (FLASH_MID_F32, torch.float32, True),
               ((3, 130, 2, 128), torch.float32, True), ((2, 333, 3, 128), torch.float32, False),
               (FLASH_XL, torch.bfloat16, True),
               ((2, 333, 3, 384), torch.bfloat16, True), ((1, 1000, 2, 384), torch.bfloat16, False),
               (FLASH_XL_F32, torch.float32, True), (FLASH_SMALL_LM_384, torch.float32, True),
               ((1, 4352, 2, 384), torch.float32, False), ((3, 130, 2, 384), torch.float32, True),
               (FLASH_XXL, torch.bfloat16, True)) + tuple(
    case for Dh in FLASH_WIDE_DIMS
    for case in (((1, FLASH_WIDE_SWEEP_T, 1, Dh), torch.bfloat16, True),
                 ((2, 333, 3, Dh), torch.bfloat16, False))) + (
    (FLASH_XXL_F32, torch.float32, True), ((2, 333, 3, 512), torch.float32, True),
    ((3, 130, 2, 512), torch.float32, False),
    ((3, 130, 2, 640), torch.float32, False), ((2, 333, 3, 768), torch.float32, False),
    ((3, 130, 2, 896), torch.float32, True)) + tuple(
    ((1, FLASH_WIDE_SWEEP_T, 1, Dh), torch.float32, causal)
    for Dh in FLASH_F32_WIDE_DIMS for causal in (True, False))
# the timed (shape, dtype) pairs, causal as the paths run them, and the
# suffix of their kernels line entries (the launch counts of lm_main,
# lm_wide, lm_wide_f32, small_lm_256, small_lm, small_lm_128, lm_mid_f32,
# lm_xl, lm_xl_f32, small_lm_384_f32, lm_xxl, small_lm_1536, lm_xxl_f32 and
# small_lm_896_f32 fill them in, each at the shape its path gives the
# kernels); keyed by dtype too, since lm_xl and lm_xl_f32 give the kernels
# one shape. The other (1, FLASH_WIDE_SWEEP_T, 1, Dh) cases, full ones
# too, are timed on their own lines (sweep_ms, beside their bounds and
# SDPA's times), not in the kernels line: no path runs them
FLASH_TIMED = {(FLASH_SLICE, torch.bfloat16): "", (FLASH_WIDE, torch.bfloat16): "_dh256",
               (FLASH_WIDE_F32, torch.float32): "_dh256_f32",
               (FLASH_SMALL_LM_256, torch.float32): "_dh256_f32_small",
               (FLASH_SMALL_LM, torch.float32): "_f32",
               (FLASH_SMALL_LM_128, torch.float32): "_dh128_f32",
               (FLASH_MID_F32, torch.float32): "_dh128_f32_mid",
               (FLASH_XL, torch.bfloat16): "_dh384", (FLASH_XL_F32, torch.float32): "_dh384_f32",
               (FLASH_SMALL_LM_384, torch.float32): "_dh384_f32_small",
               (FLASH_XXL, torch.bfloat16): "_dh512",
               (FLASH_SMALL_LM_1536, torch.bfloat16): "_dh1536_small",
               (FLASH_XXL_F32, torch.float32): "_dh512_f32",
               (FLASH_SMALL_LM_896, torch.float32): "_dh896_f32_small"}
# the earlier design's time of a kernel redesigned since, and that design,
# printed beside the new time on the kernel's own line: ms at FLASH_WIDE of
# the bf16 Dh-256 forward, dq and dk/dv of flash_attention_sm90.cu, at
# FLASH_WIDE_F32 and FLASH_SMALL_LM_256 of the float32 Dh-256 forward, dq
# and dk/dv, at FLASH_SMALL_LM_128 of the float32 Dh-128 forward, dq and
# dk/dv and at FLASH_MID_F32 of the float32 Dh-128 dq and dk/dv, of
# flash_attention.cu's FMA kernels, and at FLASH_XXL_F32 of the float32
# Dh-512 dq and dk/dv of flash_wide_f32_sm90.cu's mma.sync kernels, each
# measured by this script on an H100 80GB HBM3 at 700 W before its redesign;
# `flash DIR` times both designs in one call
_WAS_BF16 = "flash_attention_sm90.cu's two-warpgroup Dh-256 design"
_WAS_F32 = "flash_attention.cu's float32 FMA kernel"
_WAS_WIDE_F32 = "flash_wide_f32_sm90.cu's mma.sync kernel"
FLASH_WAS_MS = {"flash_fwd_dh256": (5.208, _WAS_BF16), "flash_dkv_dh256": (9.373, _WAS_BF16),
                "flash_dq_dh256": (7.771, _WAS_BF16),
                "flash_fwd_dh256_f32": (20.61, _WAS_F32),
                "flash_dq_dh256_f32": (33.60, _WAS_F32),
                "flash_fwd_dh256_f32_small": (1.223, _WAS_F32),
                "flash_dq_dh256_f32_small": (2.001, _WAS_F32),
                "flash_dkv_dh256_f32": (42.24, _WAS_F32),
                "flash_dkv_dh256_f32_small": (2.434, _WAS_F32),
                "flash_fwd_dh128_f32": (0.7493, _WAS_F32),
                "flash_dq_dh128_f32": (0.9749, _WAS_F32),
                "flash_dkv_dh128_f32": (1.238, _WAS_F32),
                "flash_dq_dh128_f32_mid": (17.09, _WAS_F32),
                "flash_dkv_dh128_f32_mid": (21.51, _WAS_F32),
                "flash_dq_dh512_f32": (53.35, _WAS_WIDE_F32),
                "flash_dkv_dh512_f32": (75.14, _WAS_WIDE_F32)}
# the float32 Dh-384 dq, redesigned as three-block clusters: the earlier
# kernel (flash_f32_sm90.cu's), timed beside it in this run as was_ms
# through its C entry (_dq_f32_sm90); the float32 Dh-512 forward,
# redesigned as four-block clusters: the earlier kernel
# (flash_wide_f32_sm90.cu's <4, 4>) likewise (_fwd_wide_f32)
FLASH_WAS_LIVE = ("flash_dq_dh384_f32", "flash_dq_dh384_f32_small", "flash_fwd_dh512_f32")
# |kernel - plain| / max|plain|, plain in float32. Each output sums up to
# T * Dh = 5e5 float32 products in another order than the plain version's
# cuBLAS calls: a random walk of sqrt(n) * 2^-24 ~ 4e-5 of the terms'
# magnitudes at most, so 1e-4 leaves margin; a wrong mask, tile or column
# errs by O(1). A bf16 output is the float32 value rounded once, so it may
# sit one bf16 step (2^-7 of its magnitude) from the rounded plain value.
FLASH_TOL = 1e-4
FLASH_TOL_BF16 = FLASH_TOL + 2.0 ** -7
# share of bf16 outputs allowed to differ at all from the rounded plain value:
# two float32 values within ~1e-6 straddle a rounding boundary ~1e-3 of the time
# (measured at most 7.6e-4 on an H100); one wrong 64-row tile at T 8192 is
# 7.8e-3 of the outputs
FLASH_MISMATCH_SHARE = 0.0025
# bf16 outputs are also held row by row (the Dh values of one (b, t, h))
# against the row's largest plain value, since late causal rows are ~1/sqrt(T)
# of the largest overall; rows whose values cancel to ~0 (dq's first row) are
# held against this share of the largest overall instead
FLASH_ROW_FLOOR = 1e-3


def _flash_inputs(shape, dtype, gen, dev):
    """q, k, v as views of one (B, T, 3 H Dh) projection, as the model makes
    them, and dO."""
    B, T, H, Dh = shape
    qkv = torch.randn(B, T, 3 * H * Dh, generator=gen).to(dev, dtype)
    q, k, v = (t.reshape(B, T, H, Dh) for t in qkv.split(H * Dh, dim=-1))
    do = torch.randn(B, T, H, Dh, generator=gen).to(dev, dtype)
    return q, k, v, do


def _flash_err(got, want32, dtype):
    """(normalised error, share of elements that differ from the rounded plain
    value — bf16 outputs only, largest per-row error) of a kernel output
    against the float32 plain value; raises past the tolerance."""
    diff, mag = (got.float() - want32).abs(), want32.abs()
    err = (diff.max() / mag.max().clamp_min(1e-30)).item()
    row_err = (diff.amax(-1) / torch.maximum(mag.amax(-1), FLASH_ROW_FLOOR * mag.max())
               ).max().item()
    if dtype != torch.bfloat16:
        if not err <= FLASH_TOL:
            raise AssertionError(f"flash: normalised error {err} > {FLASH_TOL}")
        return err, None, row_err
    share = (got != want32.to(dtype)).float().mean().item()
    if not (err <= FLASH_TOL_BF16 and row_err <= FLASH_TOL_BF16
            and share <= FLASH_MISMATCH_SHARE):
        raise AssertionError(f"flash: normalised error {err}, per row {row_err} (tol "
                             f"{FLASH_TOL_BF16}), {share} of the bf16 elements differ "
                             f"(at most {FLASH_MISMATCH_SHARE})")
    return err, share, row_err


def _flash_pairs(B, T, H, causal):
    """(q, k) pairs that are not masked."""
    return B * H * (T * (T + 1) // 2 if causal else T * T)


def _flash_products(name, dtype, Dh):
    """(bf16 tensor-core, float32, TF32 tensor-core) products per unmasked
    (q, k) pair, each 2 * Dh operations, of kernel ``name`` (flash_fwd,
    flash_dq or flash_dkv) on its route. With bf16 inputs, Q.K^T and dO.V^T
    multiply two bf16 operands, exact on the tensor cores with float32 sums
    (the score is scaled after the product); P.V, dS.K, P^T.dO and dS^T.Q take
    a float32 probability or score, which is exact there only as three bf16
    terms, so each counts as three bf16 products. Float32 inputs: on
    flash_f32_sm90 (every kernel at Dh 256 and 384, the forward at Dh 128),
    flash_f32_wgmma_sm90 (dq and dk/dv at Dh 128, dq at 384, all three at
    512) and flash_wide_f32_sm90 (Dh 640-896) each product is three TF32
    products; elsewhere every
    product runs at the float32 rate."""
    from fedml_tpu_torch.ops import flash_attention as fa

    n = {"flash_fwd": 2, "flash_dq": 3, "flash_dkv": 4}[name]
    if dtype == torch.bfloat16:
        return {"flash_fwd": 1 + 3, "flash_dq": 2 + 3, "flash_dkv": 2 + 2 * 3}[name], 0, 0
    if fa.route("fedml_" + name, dtype, Dh)[0] in ("flash_f32_sm90", "flash_f32_wgmma_sm90",
                                                   "flash_wide_f32_sm90"):
        return 0, 0, 3 * n
    return 0, n, 0


def _flash_ops(name, dtype, Dh, pairs):
    """(bf16 tensor-core, float32, TF32 tensor-core) operations of kernel
    ``name`` on ``pairs`` unmasked (q, k) pairs."""
    return tuple(n * 2 * Dh * pairs for n in _flash_products(name, dtype, Dh))


def _flash_bound(name, dtype, Dh, pairs, nbytes):
    """_bound of kernel ``name`` on ``pairs`` unmasked pairs and ``nbytes``."""
    bf16_ops, f32_ops, tf32_ops = _flash_ops(name, dtype, Dh, pairs)
    return _bound(f32_ops, nbytes, bf16_ops, tf32_ops)


def _sdpa_backend(q, k, v, causal):
    """The backend PyTorch's dispatcher picks for scaled_dot_product_attention
    on these inputs (at Dh 256 it need not be its flash backend)."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=causal)).name


def _sdpa_ms(q, k, v, do, causal):
    """(backend, forward ms, backward ms, error) of
    scaled_dot_product_attention on the kernels' inputs, the library
    yardstick (its backward computes dq, dk and dv together). At a head dim
    its fused backends refuse (Dh 384) it may run only its math backend, or
    fail: then the times are None and the error is returned, to be
    printed; the yardstick is not a gate."""
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    try:
        backend = _sdpa_backend(qt, kt, vt, causal)
        fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal),
                         reps=3, rounds=3)
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        g = do.transpose(1, 2).contiguous()
        bwd_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), g, retain_graph=True),
                         reps=3, rounds=3)
        return backend, fwd_ms, bwd_ms, None
    except RuntimeError as e:  # torch.OutOfMemoryError too
        return None, None, None, f"{type(e).__name__}: {e}"[:400]


def _column_parts_agree(fa, q, k, v, do, causal, n_fq, n_kv, what):
    """Kernels that split each row's output columns into parts, every part
    holding the same softmax, p and ds bits: the float32 Dh-384 kernels
    (three warps of 128 columns in the forward and dq, two of 192 for dk
    and for dv, adding their partial scores in one fixed order), the
    float32 kernels at Dh 512-896 (Dh / 128 warps of 128 columns a row or
    key group, likewise) and the
    bf16 kernels at Dh 512-1536 (a block per slice of 256 columns, 128
    where Dh % 256 != 0, every slice summing its score chunks in one
    order). On inputs whose column parts repeat (v for the forward's out, k
    for dq, q and dO for dk and dv; n_fq parts for the forward and dq, n_kv
    for dk/dv), each output's parts must then be bit-equal; a part that
    read other columns or summed its scores in another order would give
    other low bits."""
    def parts(x, n):
        w = x.shape[-1] // n
        return all(torch.equal(x[..., :w], x[..., i * w:(i + 1) * w]) for i in range(1, n))

    def rep(x, n):
        return x[..., :x.shape[-1] // n].repeat(1, 1, 1, n)

    kr, qr, dor = rep(k, n_fq), rep(q, n_kv), rep(do, n_kv)
    out_k, lse_k = fa.flash_forward(q, kr, v, causal)
    out_q, lse_q = fa.flash_forward(qr, k, v, causal)
    dk, dv = fa.flash_dkv(qr, k, v, dor, lse_q, fa.attention_delta(dor, out_q), causal)
    agree = {"out": parts(fa.flash_forward(q, k, rep(v, n_fq), causal)[0], n_fq),
             "dq": parts(fa.flash_dq(q, kr, v, do, lse_k, fa.attention_delta(do, out_k),
                                     causal), n_fq),
             "dk": parts(dk, n_kv), "dv": parts(dv, n_kv)}
    if not all(agree.values()):
        raise AssertionError(f"flash {what} at {tuple(q.shape)}: the column parts of "
                             f"{[n for n, a in agree.items() if not a]} differ")
    return agree


def _dq_f32_sm90(fa, q, k, v, do, lse, delta, causal):
    """dq from flash_f32_sm90.cu's float32 entry (its mma.sync kernel, which
    the route no longer takes at Dh 384), launched through its C entry on
    contiguous float32 CUDA tensors and counting no launch: the was_ms of
    FLASH_WAS_LIVE."""
    import ctypes

    from fedml_tpu_torch.ops import _build

    B, T, H, Dh = q.shape
    ts = [t.contiguous() for t in (q, k, v, do, lse, delta)]
    dq = torch.empty_like(ts[0])
    entry = "fedml_flash_dq_f32_sm90"
    fn = _build.function("flash_f32_sm90", entry, [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 +
                         [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_void_p])
    _build.check(fn(*(t.data_ptr() for t in ts), dq.data_ptr(), B, H, T, Dh, 0, int(causal),
                    *ts[0].stride()[:3], 1.0 / math.sqrt(Dh),
                    torch.cuda.current_stream(q.device).cuda_stream), entry)
    return dq


def _fwd_wide_f32(fa, q, k, v, causal):
    """(out, lse) from flash_wide_f32_sm90.cu's float32 forward entry (its
    mma.sync kernel, which the route no longer takes at Dh 512), launched
    on float32 CUDA tensors and counting no launch: the was_ms of
    FLASH_WAS_LIVE."""
    from fedml_tpu_torch.ops import _build

    B, T, H, Dh = q.shape
    q, k, v = fa._strided(q, k, v)
    out = torch.empty((B, T, H, Dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, 1, T), dtype=torch.float32, device=q.device)
    entry = "fedml_flash_fwd_wide_f32_sm90"
    fn = _build.function("flash_wide_f32_sm90", entry, fa._argtypes(5))
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                    B, H, T, Dh, 0, int(causal), *q.stride()[:3], 1.0 / math.sqrt(Dh),
                    torch.cuda.current_stream(q.device).cuda_stream), entry)
    return out, lse


def _check_flash_refusals(fa, dev):
    """The head dims no kernel takes raise on the card, saying that the
    shared guard admits them at no T, before any launch and with no
    fallback: float32 at Dh 1024 (past the guard's budget in float32) and
    576 (no multiple of 128), bf16 at Dh 576 and 1664 (past the guard's
    1536). Every head dim the guard admits runs (FLASH_CASES)."""
    before = _flash_counts()
    refused = {}
    for Dh, dtype in ((1024, torch.float32), (576, torch.float32), (576, torch.bfloat16),
                      (1664, torch.bfloat16)):
        q = torch.zeros(1, 128, 1, Dh, device=dev, dtype=dtype)
        if fa.flash_shapes_ok(FLASH_WIDE_SWEEP_T, Dh, q.element_size()):
            raise AssertionError(f"the guard admits Dh {Dh} in {dtype}")
        try:
            fa.flash_forward(q, q, q, True)
        except ValueError as e:
            if "admits this head dim at no T" in str(e):
                refused[f"{dtype}_dh{Dh}"] = True
                continue
            raise
        raise AssertionError(f"flash at Dh {Dh} in {dtype} ran on the card")
    if _flash_counts() != before:
        raise AssertionError("a refused flash call counted a launch")
    emit("kernel_flash_refusals", refused=refused)


def check_flash(dev, tc_rate):
    """Kernels 4a-4c (flash forward, dq, dk/dv) against their plain versions
    at FLASH_CASES, and the head dims without a kernel refused; out, lse,
    dq, dk and dv repeat bit for bit; timings at the FLASH_TIMED shapes beside SDPA
    (forward for 4a; its backward, which computes dq, dk and dv together,
    for 4b and 4c) and the backend it ran; at the swept head dims the
    kernels' times beside their bounds and SDPA's.
    A kernel on three TF32 products (flash_f32_sm90, flash_f32_wgmma_sm90,
    flash_wide_f32_sm90) also reports its operations at the float32 FMA rate (fma_bound_ms) and
    at ``tc_rate``, the rate mma.sync TF32 reached in phase tc_rate
    (mma_sync_ms)."""
    import ctypes

    from fedml_tpu_torch.ops import _build
    from fedml_tpu_torch.ops import flash_attention as fa

    clusters = _build.function("flash_f32_wgmma_sm90", "fedml_flash_f32wg_clusters",
                               [ctypes.c_int, ctypes.c_int])
    resident = {"P3_dh384": {"flash_dq": clusters(0, 3)},
                "P4_dh512": {"flash_fwd": clusters(2, 4), "flash_dq": clusters(0, 4),
                             "flash_dkv": clusters(1, 4)}}
    if min(n for r in resident.values() for n in r.values()) <= 0:
        raise AssertionError(f"the float32 clusters fit no SM set: {resident}")
    emit("flash_f32_clusters", resident_clusters=resident)
    gen = torch.Generator().manual_seed(5)
    entries = []
    for shape, dtype, causal in FLASH_CASES:
        B, T, H, Dh = shape
        q, k, v, do = _flash_inputs(shape, dtype, gen, dev)
        q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
        out, lse = fa.flash_forward(q, k, v, causal)
        out_p, lse_p = fa.flash_forward_plain(q32, k32, v32, causal)
        delta = fa.attention_delta(do, out)
        dq = fa.flash_dq(q, k, v, do, lse, delta, causal)
        dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal)
        # the plain backward from the same lse and delta: it checks the kernels' arithmetic
        dq_p = fa.flash_dq_plain(q32, k32, v32, do32, lse, delta, causal)
        dk_p, dv_p = fa.flash_dkv_plain(q32, k32, v32, do32, lse, delta, causal)
        torch.cuda.synchronize()
        errs = {"out": _flash_err(out, out_p, dtype), "lse": _flash_err(lse, lse_p, torch.float32),
                "dq": _flash_err(dq, dq_p, dtype), "dk": _flash_err(dk, dk_p, dtype),
                "dv": _flash_err(dv, dv_p, dtype)}
        out2, lse2 = fa.flash_forward(q, k, v, causal)
        if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
            raise AssertionError(f"flash forward at {shape} is not repeatable")
        del out2, lse2
        dk2, dv2 = fa.flash_dkv(q, k, v, do, lse, delta, causal)
        if not (torch.equal(dq, fa.flash_dq(q, k, v, do, lse, delta, causal))
                and torch.equal(dk, dk2) and torch.equal(dv, dv2)):
            raise AssertionError(f"flash backward at {shape} is not repeatable")
        row = dict(shape=list(shape), dtype=str(dtype), causal=causal, repeatable=True,
                   normalised_err={n: e[0] for n, e in errs.items()},
                   mismatch_share={n: e[1] for n, e in errs.items()},
                   row_err={n: e[2] for n, e in errs.items()},
                   tol=FLASH_TOL_BF16 if dtype == torch.bfloat16 else FLASH_TOL)
        if dtype == torch.float32 and Dh == 384:
            row["column_parts_equal"] = _column_parts_agree(fa, q, k, v, do, causal, 3, 2,
                                                            "float32 Dh 384")
        if dtype == torch.bfloat16 and Dh in fa.BF16_WIDE:
            n = Dh // (256 if Dh % 256 == 0 else 128)
            row["column_parts_equal"] = _column_parts_agree(fa, q, k, v, do, causal, n, n,
                                                            f"bf16 Dh {Dh}")
        if dtype == torch.float32 and Dh in fa.F32_WIDE:
            row["column_parts_equal"] = _column_parts_agree(fa, q, k, v, do, causal, Dh // 128,
                                                            Dh // 128, f"float32 Dh {Dh}")
        nb = B * T * H * Dh * q.element_size()  # one (B, T, H, Dh) tensor
        rows_b = B * H * T * 4                   # one float32 row vector (lse or delta)
        pairs = _flash_pairs(B, T, H, causal)
        if not (causal and (shape, dtype) in FLASH_TIMED):
            if T == FLASH_WIDE_SWEEP_T and Dh in (fa.BF16_WIDE if dtype == torch.bfloat16
                                                   else fa.F32_WIDE):
                # the head dims no path runs: kernel ms beside the bound and SDPA's
                backend, fwd_ms, bwd_ms, error = _sdpa_ms(q, k, v, do, causal)
                row["sweep_sdpa"] = {"backend": backend, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
                                     **({"error": error} if error else {})}
                row["sweep_ms"] = {
                    "flash_fwd": time_ms(lambda: fa.flash_forward(q, k, v, causal), 3, 3),
                    "flash_dq": time_ms(lambda: fa.flash_dq(q, k, v, do, lse, delta, causal),
                                        3, 3),
                    "flash_dkv": time_ms(lambda: fa.flash_dkv(q, k, v, do, lse, delta, causal),
                                         3, 3)}
                row["sweep_bound_ms"] = {
                    name: _flash_bound(name, dtype, Dh, pairs, nbytes)["bound_ms"]
                    for name, nbytes in (("flash_fwd", 4 * nb + rows_b),
                                         ("flash_dq", 5 * nb + 2 * rows_b),
                                         ("flash_dkv", 6 * nb + 2 * rows_b))}
            emit("kernel_flash", **row)
            continue
        # timings at the main paths' shapes
        row["sdpa_backend"], sdpa_fwd_ms, sdpa_bwd_ms, sdpa_error = _sdpa_ms(q, k, v, do, causal)
        if sdpa_error:
            row["sdpa_error"] = sdpa_error
        torch.cuda.empty_cache()
        cases = (
            ("flash_fwd", ":129", 3 * nb, nb + rows_b,
             lambda: fa.flash_forward(q, k, v, causal),
             lambda: fa.flash_forward_plain(q, k, v, causal),
             sdpa_fwd_ms, errs["out"][0], (out - out_p).abs().max()),
            ("flash_dq", ":167", 4 * nb + 2 * rows_b, nb,
             lambda: fa.flash_dq(q, k, v, do, lse, delta, causal),
             lambda: fa.flash_dq_plain(q, k, v, do, lse, delta, causal),
             sdpa_bwd_ms, errs["dq"][0], (dq - dq_p).abs().max()),
            ("flash_dkv", ":213", 4 * nb + 2 * rows_b, 2 * nb,
             lambda: fa.flash_dkv(q, k, v, do, lse, delta, causal),
             lambda: fa.flash_dkv_plain(q, k, v, do, lse, delta, causal),
             sdpa_bwd_ms, max(errs["dk"][0], errs["dv"][0]),
             max((dk - dk_p).abs().max(), (dv - dv_p).abs().max())),
        )
        for name, line, bytes_in, bytes_out, kern, plain, lib_ms, err, abs_err in cases:
            bf16_ops, f32_ops, tf32_ops = _flash_ops(name, dtype, Dh, pairs)
            lib = fa.route("fedml_" + name, dtype, Dh)[0]
            entry = {"name": name + FLASH_TIMED[shape, dtype], "route": "cuda",
                     "source": f"fedml_tpu_torch/csrc/{lib}.cu",
                     "replaces": "fedml_tpu/ops/pallas/flash_attention.py" + line,
                     "max_abs_err": float(abs_err), "ms": time_ms(kern, reps=3, rounds=3),
                     "plain_ms": time_ms(plain, reps=2, rounds=3),
                     "library_ms": lib_ms,
                     **_flash_bound(name, dtype, Dh, pairs, bytes_in + bytes_out)}
            entries.append(entry)
            was = {}
            if entry["name"] in FLASH_WAS_MS:
                was = dict(zip(("was_ms", "was_from"), FLASH_WAS_MS[entry["name"]]))
            if entry["name"] in FLASH_WAS_LIVE and name == "flash_dq":
                was = {"was_ms": time_ms(lambda: _dq_f32_sm90(fa, q, k, v, do, lse, delta,
                                                              causal), reps=3, rounds=3),
                       "was_from": "flash_f32_sm90.cu's mma.sync kernel, timed in this run"}
            if entry["name"] in FLASH_WAS_LIVE and name == "flash_fwd":
                # the earlier kernel, held to the plain version before it is timed
                was = {"was_err": _flash_err(_fwd_wide_f32(fa, q, k, v, causal)[0], out_p,
                                             dtype)[0],
                       "was_ms": time_ms(lambda: _fwd_wide_f32(fa, q, k, v, causal), reps=3,
                                         rounds=3),
                       "was_from": ("flash_wide_f32_sm90.cu's mma.sync kernel <4, 4>, timed in "
                                    "this run")}
            if tf32_ops:
                was.update(fma_bound_ms=_bound(tf32_ops / 3, bytes_in + bytes_out)["bound_ms"],
                           mma_sync_ms=tf32_ops / tc_rate * 1e3)
            emit("kernel_" + entry["name"], **row, **was,
                 gflop=(bf16_ops + f32_ops + tf32_ops / 3) / 1e9, bf16_gflop=bf16_ops / 1e9,
                 tf32_gflop=tf32_ops / 1e9, kernel_source=entry["source"],
                 library="F.scaled_dot_product_attention " +
                 ("forward" if name == "flash_fwd" else "backward (dq, dk and dv together)"),
                 **{k: v for k, v in entry.items() if k not in ("name", "route", "source")})
    _check_flash_refusals(fa, dev)
    return entries


# (B, T, H, Dh), dtype and causal of phase_flash_times: in bf16 causal the
# XXL LM's attention (Dh 512) and the XL LM's (Dh 384; a package without
# those kernels refuses them, and the refusal is printed), the wide LM's,
# then the LM slice's (Dh 64) and one at Dh 128 with its width (H Dh 1024)
# and tokens, where the bf16 kernels of flash_attention_sm90.cu run; in
# float32 the XXL and XL float32 LMs' attention (refused likewise by a
# package without the float32 Dh-512 or Dh-384 kernels), the wide float32 LM's,
# small_lm_256's, a full one at T 4352, lm_mid_f32's and small_lm_128's
FLASH_MODE_SHAPES = ((FLASH_XXL, torch.bfloat16, True), (FLASH_XL, torch.bfloat16, True),
                     (FLASH_XXL_F32, torch.float32, True), (FLASH_XL_F32, torch.float32, True),
                     (FLASH_WIDE, torch.bfloat16, True), (FLASH_SLICE, torch.bfloat16, True),
                     ((2, 8192, 8, 128), torch.bfloat16, True),
                     (FLASH_WIDE_F32, torch.float32, True),
                     (FLASH_SMALL_LM_256, torch.float32, True),
                     (FLASH_F32_256_FULL, torch.float32, False),
                     (FLASH_MID_F32, torch.float32, True),
                     (FLASH_SMALL_LM_128, torch.float32, True))


def _digest(*ts):
    """The first 16 hex digits of the SHA-256 of the tensors' bytes: two
    runs' outputs are bit-equal where their digests are."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def phase_flash_times(dev, reps=3, rounds=5):
    """Kernel ms of flash forward, dq and dk/dv at FLASH_MODE_SHAPES for the
    package first on sys.path: with ``flash DIR`` a checkout's, so two
    commits compare in one call (parent, change, change, parent); with the
    float32 outputs' digests (out and lse; dq; dk and dv, from the plain
    forward's lse and delta), equal across the commits where their kernels'
    bits are."""
    from fedml_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(5)
    package = str(Path(fa.__file__).parents[2])
    for shape, dtype, causal in FLASH_MODE_SHAPES:
        q, k, v, do = _flash_inputs(shape, dtype, gen, dev)
        try:
            out, lse = fa.flash_forward(q, k, v, causal)
        except ValueError as e:  # a package without kernels at this head dim
            emit("flash_times", shape=list(shape), dtype=str(dtype), package=package,
                 refused=str(e))
            continue
        delta = fa.attention_delta(do, out)
        bits = {}
        if dtype == torch.float32:
            # the backward's digests from the plain forward's lse and delta,
            # the same inputs on both commits whatever their forwards give
            out_p, lse_p = fa.flash_forward_plain(q, k, v, causal)
            delta_p = fa.attention_delta(do, out_p)
            bits = {"fwd": _digest(out, lse),
                    "dq": _digest(fa.flash_dq(q, k, v, do, lse_p, delta_p, causal)),
                    "dkv": _digest(*fa.flash_dkv(q, k, v, do, lse_p, delta_p, causal))}
            del out_p, lse_p, delta_p
        emit("flash_times", shape=list(shape), dtype=str(dtype), causal=causal, package=package,
             **({"digests": bits} if bits else {}),
             fwd_ms=time_ms(lambda: fa.flash_forward(q, k, v, causal), reps, rounds),
             dq_ms=time_ms(lambda: fa.flash_dq(q, k, v, do, lse, delta, causal), reps, rounds),
             dkv_ms=time_ms(lambda: fa.flash_dkv(q, k, v, do, lse, delta, causal), reps, rounds))
        del q, k, v, do, out, lse, delta


def phase_conv_times(dev):
    """Device ms of the bf16 forward (kernel 3a under use_bf16, also dx) at
    CONV_MAIN and CONV_EVAL, beside cuDNN's grouped bf16 conv and the
    bound, and of the bf16 weight gradient (kernel 3b) at CONV_MAIN, each on
    the route the wrapper picks, for the package first on sys.path: with
    ``conv DIR`` a checkout's, so two commits compare in one call (parent,
    change, change, parent). Then the float32 stem at CONV_STEM_F32: the
    route's kernel, the stem's tensor-core kernel (where the package has
    it) and the FMA kernel, each held to the plain version, beside cuDNN."""
    from fedml_tpu_torch.ops import conv as C

    package = str(Path(C.__file__).parents[2])
    gen = torch.Generator().manual_seed(12)
    rows = []
    for shape in CONV_STEM_F32:
        L, B, H, W, ci, co = shape
        x, w, _, xn, wn, _ = _conv_case(shape, gen, dev)
        yp = C.conv3x3_plain(x, w)
        mag = C.conv3x3_plain(x.abs(), w.abs())
        row = {"shape": list(shape), "route": C.fwd_route(ci, co),
               "ms": device_ms(lambda: C.conv3x3_lanes(x, w), CONV_FWD_KERNELS),
               "library_ms": device_ms(lambda: F.conv2d(xn, wn, padding=1, groups=L), ("",))}
        for route in ("stem_tf32x3", "fma"):
            if route not in C.FWD_ROUTES:
                continue
            err = _normalised_err(C.conv3x3_fwd_route(x, w, route), yp, mag)
            if not err <= CONV_TOL:
                raise AssertionError(f"conv3x3 {route} at {shape}: {err} > {CONV_TOL}")
            row[route + "_ms"] = device_ms(lambda: C.conv3x3_fwd_route(x, w, route),
                                           CONV_FWD_KERNELS)
        rows.append(row)
    emit("conv_stem_f32_times", package=package, rows=rows)
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(13)
    rows = []
    for shape in CONV_MAIN + CONV_EVAL:
        L, B, H, W, ci, co = shape
        x, w, _, xn, wn, _ = (t.to(bf) for t in _conv_case(shape, gen, dev))
        nbytes = (L * B * H * W * (ci + co) + L * 9 * ci * co) * 2
        rows.append({"shape": list(shape), "route": C.fwd_route(ci, co, bf),
                     "ms": device_ms(lambda: C.conv3x3_lanes(x, w), CONV_FWD_KERNELS),
                     "library_ms": device_ms(lambda: F.conv2d(xn, wn, padding=1, groups=L),
                                             ("",)),
                     **_bound(0, nbytes, bf16_ops=_conv_ops(shape))})
    emit("conv_fwd_bf16_times", package=package, rows=rows)
    gen = torch.Generator().manual_seed(14)
    rows = []
    for shape in CONV_MAIN:
        x, _, dy, *_ = (t.to(bf) for t in _conv_case(shape, gen, dev))
        rows.append({"shape": list(shape),
                     "ms": device_ms(lambda: C.conv3x3_dw_lanes(x, dy), CONV_DW_KERNELS)})
    emit("conv_dw_bf16_times", package=package, rows=rows)


def lm_data(vocab, B, T, seed=0):
    """The Cheetah example's data (examples/cheetah_lm/main.py): each row an
    arithmetic run of tokens from a random start; targets shifted by one."""
    rng = np.random.default_rng(seed)
    while True:
        start = rng.integers(0, vocab, (B, 1))
        seq = (start + np.arange(T + 1)) % vocab
        yield seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)


SMALL_LM = dict(vocab_size=256, dim=64, num_heads=1, num_layers=2, max_len=4096)
# the float32 Dh-128 and Dh-256 kernels under the trainer: one head of 128 at
# T 4608 and one of 256 at T 4352, where auto dispatch picks flash in float32
SMALL_LM_128 = dict(vocab_size=256, dim=128, num_heads=1, num_layers=2, max_len=4608)
SMALL_LM_256 = dict(vocab_size=256, dim=256, num_heads=1, num_layers=2, max_len=4352)

def _zero_flash_counts():
    from fedml_tpu_torch.ops import flash_attention as fa

    fa.flash_forward.launches = fa.flash_dq.launches = fa.flash_dkv.launches = 0


def _flash_counts(suffix=""):
    from fedml_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd" + suffix: fa.flash_forward.launches,
            "flash_dq" + suffix: fa.flash_dq.launches,
            "flash_dkv" + suffix: fa.flash_dkv.launches}


def _want_flash(layers, steps, suffix=""):
    """Launches of ``steps`` trainer steps with every block rematerialized
    (full or dots): each block's flash forward runs twice per step (the
    forward and its recompute in the backward), dq and dk/dv once."""
    return {"flash_fwd" + suffix: 2 * layers * steps, "flash_dq" + suffix: layers * steps,
            "flash_dkv" + suffix: layers * steps}


def phase_small_lm(phase="small_lm", model=SMALL_LM, steps=3, suffix="_f32"):
    """The trainer at f32 and T = max_len, where auto dispatch picks flash, on
    the card (the kernels) vs on the CPU (their plain versions). Returns the
    card run's flash launches, keyed with ``suffix``."""
    from fedml_tpu_torch.ops.attention import auto_attention_impl
    from fedml_tpu_torch.parallel import DistTrainConfig, DistributedLMTrainer

    T, H = model["max_len"], model["num_heads"]
    if auto_attention_impl(1, H, T, model["dim"] // H, 4) != "flash":
        raise AssertionError(f"auto dispatch must pick flash at T {T}")
    # the chunked cross-entropy's chunk divides T: 256, or 128 at T 4224
    cfg = DistTrainConfig(lr=3e-4, weight_decay=0.01, use_remat=True,
                          ce_chunk=math.gcd(T, 256))
    losses, params = {}, {}
    for device in ("cuda", "cpu"):
        tr = DistributedLMTrainer(cfg, dtype=torch.float32, device=device, seed=0, **model)
        _zero_flash_counts()
        losses[device] = tr.train(lm_data(model["vocab_size"], 1, T), steps, log_fn=None)
        if device == "cuda":
            launches = _flash_counts(suffix)
            if launches != _want_flash(model["num_layers"], steps, suffix):
                raise AssertionError(f"{phase} did not run the flash kernels: {launches}")
        params[device] = {k: p.detach().cpu() for k, p in tr.params.items()}
    # float32 sums in another order: measured at most 8e-8 relative between
    # the losses and 4.1e-6 between the parameters on an H100 (small_lm), so
    # 1e-6 and 1e-4 (a third of lr; one Adam step moves a parameter by up to
    # ~lr) leave >10x margin
    diff = max((params["cuda"][k] - params["cpu"][k]).abs().max().item() for k in params["cpu"])
    loss_rel = max(abs(lg - lc) / abs(lc) for lg, lc in zip(losses["cuda"], losses["cpu"]))
    if not (loss_rel <= 1e-6 and diff <= 1e-4):
        raise AssertionError(f"{phase} differs: losses {losses}, parameters by {diff}")
    emit(phase, config=model, steps=steps, cuda=losses["cuda"], cpu=losses["cpu"],
         loss_max_rel_diff=loss_rel, param_max_abs_diff=diff, launches=launches)
    return launches


# the LM slice: scripts/bench_lm_mfu.py's widths (vocab 32000, dim 1024, 16
# heads, 12 layers) with max_len = T, the trainer's and the Cheetah example's
# settings on one device; cut: 5 steps of the example's 100
LM_MODEL = dict(vocab_size=32000, dim=1024, num_heads=16, num_layers=12, max_len=8192)
LM_TRAIN = dict(dp=1, tp=1, sp=1, lr=3e-4, weight_decay=0.01, use_remat=True,
                remat_policy="full", ce_chunk=256)
LM_B, LM_T, LM_STEPS = 2, 8192, 5
# the wide LM: examples/cheetah_lm/main.py at --dim 2048 (vocab 32000, its 8
# heads, so Dh 256, and its 8 layers) with its batch 8, T 4608 and max_len =
# T; cut: 5 steps of its 100, then 2 steps under remat "dots". At the
# example's T 2048 auto picks dense; at 4096 the shared guard's budget
# refuses Dh 256 (block 1024); at 4608 (block 512) auto picks flash
LM_WIDE_MODEL = dict(vocab_size=32000, dim=2048, num_heads=8, num_layers=8, max_len=4608)
LM_WIDE_B, LM_WIDE_T, LM_WIDE_STEPS, LM_WIDE_DOTS_STEPS = 8, 4608, 5, 2
# the wide LM trained in float32 (DistributedLMTrainer's dtype): the same
# widths and batch at T 4352, the T near the example's where auto picks flash
# in float32 (at 4096 and 4608 it picks dense); cut: 3 steps of its 100, and
# 2 of its 8 layers (8 until lm_xxl_f32 joined the run, which then took
# 1,045 s of the 1,200 on one host; small_lm_256 and the kernel checks run
# the same kernels)
LM_WIDE_F32_MODEL = dict(LM_WIDE_MODEL, num_layers=2, max_len=4352)
LM_WIDE_F32_T, LM_WIDE_F32_STEPS = 4352, 3
# the float32 LM at --dim 1024: examples/cheetah_lm/main.py's model at that
# width (its 8 heads, so Dh 128, its 8 layers) trained in float32 at its
# batch 8 and T 4608 (max_len = T), where auto picks flash (at 4096 the
# shared guard's budget refuses block 1024 in float32); cut: 3 steps of its
# 100
LM_MID_F32_MODEL = dict(LM_WIDE_MODEL, dim=1024)
LM_MID_F32_T, LM_MID_F32_STEPS = 4608, 3
# the XL LM: examples/cheetah_lm/main.py --dim 3072 --seq_len 4352 (vocab
# 32000, its 8 heads, so Dh 384, its 8 layers; 1,116,174,336 parameters) at
# its batch 8 in bf16 (the trainer's dtype), max_len = T; cut: 3 steps of its
# 100. At T 4352 auto picks flash (block 256); at 2048, 4096, 4608 and 8192
# dense
LM_XL_MODEL = dict(LM_WIDE_MODEL, dim=3072, max_len=4352)
LM_XL_T, LM_XL_STEPS, LM_XL_PARAMS = 4352, 3, 1_116_174_336
# the XL LM trained in float32 (DistributedLMTrainer's dtype): the same
# widths, batch and T, where auto picks flash with 4-byte items too; cut: 3
# steps of its 100 (2 fail the falling-loss check), and 2 of its 8 layers
# (436,531,200 parameters; 8 until lm_xxl_f32 joined the run, as
# lm_wide_f32; small_lm_384_f32 and the kernel checks run the same kernels)
LM_XL_F32_MODEL = dict(LM_XL_MODEL, num_layers=2)
LM_XL_F32_STEPS, LM_XL_F32_PARAMS = 3, 436_531_200
# the XXL LM: examples/cheetah_lm/main.py --dim 4096 --seq_len 4352 (vocab
# 32000, its 8 heads, so Dh 512, its 8 layers; 1,890,885,632 parameters) at
# its batch 8 in bf16 (the trainer's dtype), max_len = T; cut: 3 steps of
# its 100. At T 4352 auto picks flash in bf16 (in float32 dense)
LM_XXL_MODEL = dict(LM_WIDE_MODEL, dim=4096, max_len=4352)
LM_XXL_STEPS, LM_XXL_PARAMS = 3, 1_890_885_632
# the XXL LM trained in float32 (DistributedLMTrainer's dtype):
# examples/cheetah_lm/main.py --dim 4096 --seq_len 4224 --ce_chunk 128 at
# its batch 8, max_len = T (1,890,361,344 parameters: 128 fewer rows of the
# position table); cut: 3 steps of its 100. T 4224 = 33 x 128 is the T
# nearest the example's where auto picks flash in float32 (at 4352 the
# guard's budget refuses block 256 with 4-byte items); 4224 % 256 != 0, so
# the chunked cross-entropy takes chunks of 128, as --ce_chunk 128 asks
LM_XXL_F32_MODEL = dict(LM_XXL_MODEL, max_len=FLASH_WIDE_SWEEP_T)
LM_XXL_F32_TRAIN = dict(LM_TRAIN, ce_chunk=128)
LM_XXL_F32_PARAMS = 1_890_361_344


def _lm_phase(phase, model, train, B, T, steps, suffix, dtype=torch.bfloat16):
    """``steps`` steps of DistributedLMTrainer.train at (model, train) on
    batches of B x T in ``dtype``: the flash launches (zeroed just before,
    read just after) must be those of rematerialized blocks, the losses
    finite and falling, the first within 1.5 of ln V (at init the logits
    have unit variance, which adds ~0.5 to ln V). Returns (trainer, data,
    launches, losses)."""
    from fedml_tpu_torch.parallel import DistTrainConfig, DistributedLMTrainer

    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    tr = DistributedLMTrainer(DistTrainConfig(**train), dtype=dtype,
                              device="cuda", seed=0, **model)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in tr.params.values())
    data = lm_data(model["vocab_size"], B, T)
    _zero_flash_counts()
    losses, step_s = [], []
    for _ in range(steps):
        t = time.perf_counter()
        losses += tr.train(data, 1, log_fn=None)  # float(loss) waits for the step
        step_s.append(time.perf_counter() - t)
    launches = _flash_counts(suffix)
    want = _want_flash(model["num_layers"], steps, suffix)
    if launches != want:
        raise AssertionError(f"{phase} launches {launches}, expected {want}")
    from fedml_tpu_torch.ops import flash_attention as fa

    Dh = model["dim"] // model["num_heads"]
    routes = {n: fa.route("fedml_" + n, dtype, Dh)[0] for n in ("flash_fwd", "flash_dq",
                                                                 "flash_dkv")}
    ln_v = math.log(model["vocab_size"])
    if not (all(math.isfinite(x) for x in losses) and abs(losses[0] - ln_v) < 1.5
            and losses[-1] < losses[0]):
        raise AssertionError(f"{phase} losses {losses} (ln V = {ln_v})")
    emit(phase, model=model, train=train, dtype=str(dtype), batch=B, seq_len=T, steps=steps,
         params=n_params,
         setup_s=setup_s, losses=losses, ln_vocab=ln_v, step_s=step_s,
         tokens_per_s_after_first=B * T * (steps - 1) / sum(step_s[1:]),
         launches=launches, routes=routes, peak_mem_bytes=torch.cuda.max_memory_allocated())
    return tr, data, launches, losses


def phase_lm_main():
    """The LM slice for LM_STEPS steps through DistributedLMTrainer.train:
    per step 2 x 12 flash forward launches, 12 dq and 12 dk/dv."""
    return _lm_phase("lm_main", LM_MODEL, LM_TRAIN, LM_B, LM_T, LM_STEPS, "")[:3]


def phase_lm_wide():
    """The wide LM (Dh 256) for LM_WIDE_STEPS steps under full remat: auto
    dispatch must pick flash, and the bf16 Dh-256 kernels launch 2 x 8
    forward, 8 dq and 8 dk/dv times per step."""
    from fedml_tpu_torch.ops.attention import auto_attention_impl

    H = LM_WIDE_MODEL["num_heads"]
    if auto_attention_impl(LM_WIDE_B, H, LM_WIDE_T, LM_WIDE_MODEL["dim"] // H) != "flash":
        raise AssertionError(f"auto dispatch must pick flash at {LM_WIDE_B, H, LM_WIDE_T}")
    return _lm_phase("lm_wide", LM_WIDE_MODEL, LM_TRAIN, LM_WIDE_B, LM_WIDE_T, LM_WIDE_STEPS,
                     "_dh256")


def phase_lm_wide_dots(full_losses):
    """The wide LM from the same seed and data under remat "dots" for
    LM_WIDE_DOTS_STEPS steps: the matrix products' outputs are saved, the
    rest (the flash forward too) recomputed, so the launches per step are
    full remat's. The policy changes what is kept, not what is computed:
    the first loss (a forward of the same weights on the same batch) equals
    full remat's bit for bit, the second (after one AdamW step from either
    policy's gradients) within 1e-4 relative, a tenth of what that step
    itself moves the loss (~1e-3 relative); measured equal on an H100."""
    tr, _, launches, losses = _lm_phase("lm_wide_dots", LM_WIDE_MODEL,
                                        dict(LM_TRAIN, remat_policy="dots"), LM_WIDE_B,
                                        LM_WIDE_T, LM_WIDE_DOTS_STEPS, "_dh256")
    if tr.model.remat != "dots":
        raise AssertionError(f"lm_wide_dots ran remat {tr.model.remat!r}")
    rel = abs(losses[1] - full_losses[1]) / abs(full_losses[1])
    if not (losses[0] == full_losses[0] and rel <= 1e-4):
        raise AssertionError(f"lm_wide_dots losses {losses} vs full remat's {full_losses}")
    emit("lm_wide_dots_vs_full", dots=losses, full=full_losses[:2], second_loss_rel_diff=rel)


def phase_lm_wide_f32():
    """The wide LM in float32 (two layers) for LM_WIDE_F32_STEPS steps
    under full remat: auto dispatch must pick flash, and per step the
    float32 Dh-256 forward, dq and dk/dv (flash_f32_sm90.cu) launch 2 x 2, 2
    and 2 times. Returns (trainer, data, launches)."""
    from fedml_tpu_torch.ops.attention import auto_attention_impl

    H = LM_WIDE_F32_MODEL["num_heads"]
    if auto_attention_impl(LM_WIDE_B, H, LM_WIDE_F32_T, LM_WIDE_F32_MODEL["dim"] // H,
                           4) != "flash":
        raise AssertionError(f"auto dispatch must pick flash at {LM_WIDE_B, H, LM_WIDE_F32_T}")
    return _lm_phase("lm_wide_f32", LM_WIDE_F32_MODEL, LM_TRAIN, LM_WIDE_B, LM_WIDE_F32_T,
                     LM_WIDE_F32_STEPS, "_dh256_f32", dtype=torch.float32)[:3]


def _check_routes(phase, Dh, want):
    """Raises unless the float32 forward, dq and dk/dv at head dim ``Dh``
    route to the kernel libraries ``want``."""
    from fedml_tpu_torch.ops import flash_attention as fa

    routes = [fa.route(n, torch.float32, Dh)[0] for n in fa.TENSOR_CORE]
    if routes != list(want):
        raise AssertionError(f"{phase}'s flash calls route to {routes}, not {list(want)}")


# the float32 XXL LM's routes: all three on flash_f32_wgmma_sm90.cu's
# four-block clusters
XXL_F32_ROUTES = ("flash_f32_wgmma_sm90",) * 3
# the float32 XL LM's (Dh 384): the forward and dk/dv on flash_f32_sm90.cu,
# dq on flash_f32_wgmma_sm90.cu's three-block clusters
XL_F32_ROUTES = ("flash_f32_sm90", "flash_f32_wgmma_sm90", "flash_f32_sm90")


def phase_lm_mid_f32(check_routes=True):
    """The float32 LM at --dim 1024 for LM_MID_F32_STEPS steps under full
    remat: auto dispatch must pick flash, and per step the float32 Dh-128
    forward (flash_f32_sm90.cu) launches 2 x 8 times, dq and dk/dv
    (flash_f32_wgmma_sm90.cu) 8 times each, none on the FMA kernels
    (``check_routes``; ``lm_mid DIR`` runs an earlier checkout's routes).
    Returns (trainer, data, launches)."""
    from fedml_tpu_torch.ops.attention import auto_attention_impl

    H = LM_MID_F32_MODEL["num_heads"]
    Dh = LM_MID_F32_MODEL["dim"] // H
    if auto_attention_impl(LM_WIDE_B, H, LM_MID_F32_T, Dh, 4) != "flash":
        raise AssertionError(f"auto dispatch must pick flash at {LM_WIDE_B, H, LM_MID_F32_T}")
    if check_routes:
        _check_routes("lm_mid_f32", Dh, ("flash_f32_sm90", "flash_f32_wgmma_sm90",
                                         "flash_f32_wgmma_sm90"))
    return _lm_phase("lm_mid_f32", LM_MID_F32_MODEL, LM_TRAIN, LM_WIDE_B, LM_MID_F32_T,
                     LM_MID_F32_STEPS, "_dh128_f32_mid", dtype=torch.float32)[:3]


def phase_lm_xl():
    """The XL LM (Dh 384) for LM_XL_STEPS steps under full remat: auto
    dispatch must pick flash, the model must hold the example's parameter
    count, and per step the bf16 Dh-384 forward, dq and dk/dv
    (flash_dh384_sm90.cu) launch 2 x 8, 8 and 8 times. Returns (trainer,
    data, launches)."""
    from fedml_tpu_torch.ops.attention import auto_attention_impl

    H = LM_XL_MODEL["num_heads"]
    if auto_attention_impl(LM_WIDE_B, H, LM_XL_T, LM_XL_MODEL["dim"] // H, 2) != "flash":
        raise AssertionError(f"auto dispatch must pick flash at {LM_WIDE_B, H, LM_XL_T}")
    tr, data, launches, _ = _lm_phase("lm_xl", LM_XL_MODEL, LM_TRAIN, LM_WIDE_B, LM_XL_T,
                                      LM_XL_STEPS, "_dh384")
    n_params = sum(p.numel() for p in tr.params.values())
    if n_params != LM_XL_PARAMS:
        raise AssertionError(f"lm_xl holds {n_params} parameters, not {LM_XL_PARAMS}")
    return tr, data, launches


def phase_lm_xxl():
    """The XXL LM (Dh 512) for LM_XXL_STEPS steps under full remat: auto
    dispatch must pick flash, the model must hold the example's parameter
    count, and per step the bf16 forward, dq and dk/dv of
    flash_wide_sm90.cu launch 2 x 8, 8 and 8 times. Returns (trainer, data,
    launches)."""
    from fedml_tpu_torch.ops.attention import auto_attention_impl

    H = LM_XXL_MODEL["num_heads"]
    if auto_attention_impl(LM_WIDE_B, H, LM_XL_T, LM_XXL_MODEL["dim"] // H, 2) != "flash":
        raise AssertionError(f"auto dispatch must pick flash at {LM_WIDE_B, H, LM_XL_T}")
    tr, data, launches, _ = _lm_phase("lm_xxl", LM_XXL_MODEL, LM_TRAIN, LM_WIDE_B, LM_XL_T,
                                      LM_XXL_STEPS, "_dh512")
    n_params = sum(p.numel() for p in tr.params.values())
    if n_params != LM_XXL_PARAMS:
        raise AssertionError(f"lm_xxl holds {n_params} parameters, not {LM_XXL_PARAMS}")
    return tr, data, launches


def phase_lm_xxl_f32(check_routes=True):
    """The XXL LM in float32 for LM_XXL_STEPS steps under full remat: auto
    dispatch must pick flash, the model must hold the example's parameter
    count, and per step the float32 forward launches 2 x 8 times, dq and
    dk/dv 8 times each (all three on flash_f32_wgmma_sm90.cu, as clusters
    of four blocks) (``check_routes``; ``lm_xxl_f32 DIR`` runs
    an earlier checkout's routes). Returns (trainer, data, launches)."""
    from fedml_tpu_torch.ops.attention import auto_attention_impl

    H, T = LM_XXL_F32_MODEL["num_heads"], LM_XXL_F32_MODEL["max_len"]
    if auto_attention_impl(LM_WIDE_B, H, T, LM_XXL_F32_MODEL["dim"] // H, 4) != "flash":
        raise AssertionError(f"auto dispatch must pick flash at {LM_WIDE_B, H, T} in float32")
    if check_routes:
        _check_routes("lm_xxl_f32", LM_XXL_F32_MODEL["dim"] // H, XXL_F32_ROUTES)
    tr, data, launches, _ = _lm_phase("lm_xxl_f32", LM_XXL_F32_MODEL, LM_XXL_F32_TRAIN,
                                      LM_WIDE_B, T, LM_XXL_STEPS, "_dh512_f32",
                                      dtype=torch.float32)
    n_params = sum(p.numel() for p in tr.params.values())
    if n_params != LM_XXL_F32_PARAMS:
        raise AssertionError(f"lm_xxl_f32 holds {n_params} parameters, not {LM_XXL_F32_PARAMS}")
    return tr, data, launches


def phase_lm_xl_f32(check_routes=True):
    """The XL LM in float32 (two layers) for LM_XL_F32_STEPS steps under
    full remat: auto dispatch must pick flash, the model must hold the
    two-layer parameter count, and per step the float32 Dh-384 forward and
    dk/dv (flash_f32_sm90.cu) launch 2 x 2 and 2 times, dq
    (flash_f32_wgmma_sm90.cu's three-block clusters) 2 times
    (``check_routes``; ``lm_xl_f32 DIR`` runs an earlier checkout's
    routes). Returns (trainer, data, launches)."""
    from fedml_tpu_torch.ops.attention import auto_attention_impl

    H = LM_XL_F32_MODEL["num_heads"]
    if auto_attention_impl(LM_WIDE_B, H, LM_XL_T, LM_XL_F32_MODEL["dim"] // H, 4) != "flash":
        raise AssertionError(f"auto dispatch must pick flash at {LM_WIDE_B, H, LM_XL_T} in "
                             "float32")
    if check_routes:
        _check_routes("lm_xl_f32", LM_XL_F32_MODEL["dim"] // H, XL_F32_ROUTES)
    tr, data, launches, _ = _lm_phase("lm_xl_f32", LM_XL_F32_MODEL, LM_TRAIN, LM_WIDE_B,
                                      LM_XL_T, LM_XL_F32_STEPS, "_dh384_f32",
                                      dtype=torch.float32)
    n_params = sum(p.numel() for p in tr.params.values())
    if n_params != LM_XL_F32_PARAMS:
        raise AssertionError(f"lm_xl_f32 holds {n_params} parameters, not {LM_XL_F32_PARAMS}")
    return tr, data, launches


# the bf16 Dh-384 kernels under the trainer: one head of 384 at T 4352,
# where auto dispatch picks flash in bf16 (and in float32: small_lm_384_f32
# runs the float32 Dh-384 kernels under small_lm's gates); the bf16 kernels
# of flash_wide_sm90.cu likewise: one head of 512 at T 4352 and one of 1536
# at T 4224 (its slices of 256 columns: two, and six), where auto picks
# flash in bf16; the latter in one layer (two took 100-118 s on the card's
# host, most of it the CPU run)
SMALL_LM_384 = dict(vocab_size=256, dim=384, num_heads=1, num_layers=2, max_len=4352)
SMALL_LM_512 = dict(SMALL_LM_384, dim=512)
SMALL_LM_1536 = dict(SMALL_LM_384, dim=1536, num_layers=1, max_len=FLASH_WIDE_SWEEP_T)
# the float32 kernels of flash_wide_f32_sm90.cu under the trainer: one head of
# 896 (its widest row group, its fullest shared memory) at T 4224, where auto
# picks flash in float32, in one layer, under small_lm's float32 gates; and
# one head of 512 likewise, whose forward, dq and dk/dv run
# flash_f32_wgmma_sm90.cu's four-block clusters (small_lm_512_f32)
SMALL_LM_896 = dict(SMALL_LM_1536, dim=896)
SMALL_LM_512_F32 = dict(SMALL_LM_1536, dim=512)
# the bf16 small LMs' gate. bf16 GEMMs round differently on the card and on the
# CPU, so small_lm's float32 bounds do not apply; the same comparison with
# dense attention on both devices measures what that rounding alone does
# over the same steps, and the flash run's loss and parameter differences
# (card kernels against the CPU's plain versions, both float32 inside and
# rounded once to bf16) must stay within this multiple of the dense run's.
SMALL_LM_384_FACTOR = 4.0


def phase_small_lm_bf16(phase="small_lm_384", model=SMALL_LM_384, suffix="_dh384", steps=3):
    """One bf16 head (Dh = dim) at T = max_len for ``steps`` trainer steps
    on the card (the kernels) and on the CPU (their plain versions), from
    the same parameters and data, then the same with dense attention on
    both devices; the flash run's differences must stay within
    SMALL_LM_384_FACTOR of the dense run's. Returns the flash run's
    launches, keyed with ``suffix``."""
    from fedml_tpu_torch.ops.attention import auto_attention_impl
    from fedml_tpu_torch.parallel import DistTrainConfig, DistributedLMTrainer

    T, layers, Dh = model["max_len"], model["num_layers"], model["dim"]
    if auto_attention_impl(1, 1, T, Dh, 2) != "flash":
        raise AssertionError(f"auto dispatch must pick flash at T {T}, Dh {Dh}")
    # the chunked cross-entropy's chunk divides T: 256, or 128 at an odd
    # multiple of 128 (T 4224, where the guard's budget admits Dh 1536)
    cfg = DistTrainConfig(lr=3e-4, weight_decay=0.01, use_remat=True,
                          ce_chunk=math.gcd(T, 256))
    row = {}
    for impl in ("flash", "dense"):
        losses, params = {}, {}
        for device in ("cuda", "cpu"):
            tr = DistributedLMTrainer(cfg, dtype=torch.bfloat16, device=device, seed=0,
                                      **model)
            if impl == "dense":
                for i in range(layers):
                    getattr(tr.model, f"block_{i}").SelfAttention_0.attn_impl = "dense"
            _zero_flash_counts()
            losses[device] = tr.train(lm_data(model["vocab_size"], 1, T), steps, log_fn=None)
            if device == "cuda":
                launches = _flash_counts(suffix)
                want = _want_flash(layers, steps if impl == "flash" else 0, suffix)
                if launches != want:
                    raise AssertionError(f"{phase} ({impl}) launches {launches}, "
                                         f"expected {want}")
            params[device] = {k: p.detach().float().cpu() for k, p in tr.params.items()}
        row[impl] = dict(
            cuda=losses["cuda"], cpu=losses["cpu"], launches=launches,
            loss_max_rel_diff=max(abs(lg - lc) / abs(lc)
                                  for lg, lc in zip(losses["cuda"], losses["cpu"])),
            param_max_abs_diff=max((params["cuda"][k] - params["cpu"][k]).abs().max().item()
                                   for k in params["cpu"]))
    flash, dense = row["flash"], row["dense"]
    keys = ("loss_max_rel_diff", "param_max_abs_diff")
    if not all(flash[k] <= SMALL_LM_384_FACTOR * dense[k] for k in keys):
        raise AssertionError(f"{phase}: the flash run's differences exceed "
                             f"{SMALL_LM_384_FACTOR} x the dense run's: {row}")
    ratios = {k: flash[k] / dense[k] if dense[k] else None for k in keys}
    emit(phase, config=model, steps=steps, ratio_to_dense=ratios, factor=SMALL_LM_384_FACTOR,
         **row)
    return flash["launches"]


# the LM profiles' kernel groups: the flash kernels, the matrix products
# (cuBLAS's Hopper kernels are named nvjet_*, sm90_xmma_gemm_* or cutlass_*)
LM_GROUPS = {"flash": ("flash_",), "gemm": ("nvjet", "gemm", "cutlass")}


def phase_lm_profile(tr, data, steps=2, phase="lm_profile"):
    """Where an LM step's time goes: ``steps`` warm steps of an LM phase's
    trainer. Each profile must show the flash kernels of rematerialized
    blocks a step (2 x layers forward, one dq and one dk/dv a layer), and
    the wrappers' counters must count the same over the profiled runs."""
    want = _want_flash(tr.model.num_layers, 1)
    _zero_flash_counts()
    row = profile_run(lambda: tr.train(data, steps, log_fn=None), steps, (
        "flash_fwd_wgmma_kernel", "flash_dq_wgmma_kernel", "flash_dkv_wgmma_kernel",
        "flash_fwd_dh256_kernel", "flash_dq_dh256_kernel", "flash_dkv_dh256_kernel",
        "flash_fwd_dh384_kernel", "flash_dq_dh384_kernel", "flash_dkv_dh384_kernel",
        "flash_fwd_wide_kernel", "flash_dq_wide_kernel", "flash_dkv_wide_kernel",
        "flash_fwd_wide_f32_kernel", "flash_dq_wide_f32_kernel", "flash_dkv_wide_f32_kernel",
        "flash_fwd_f32tc_kernel", "flash_dq_f32tc_kernel", "flash_dkv_f32tc_kernel",
        "flash_fwd_f32tc_kernel<384>", "flash_dq_f32tc_kernel<384>",
        "flash_dkv_f32tc_kernel<384>", "flash_dq_f32wg_kernel", "flash_dkv_f32wg_kernel",
        "flash_dq_f32wg_kernel<3>", "flash_dq_f32wg_kernel<4>", "flash_dkv_f32wg_kernel<4>",
        "flash_fwd_f32wg_kernel", "flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel"),
        unit="step", groups=LM_GROUPS, calls=want)
    launches = _flash_counts()
    runs = steps * row["profiles_taken"]
    if launches != {k: v * runs for k, v in want.items()}:
        raise AssertionError(f"{phase}: the wrappers counted {launches} over {runs} steps, "
                             f"the profile {row['calls_per_step']} a step")
    emit(phase, **row, launches=launches)


def main(argv):
    modes = (["agg"], ["flash"], ["conv"], ["resnet_bf16"], ["lm_f32"], ["lm_mid"], ["lm_xl"],
             ["lm_xl_f32"], ["lm_xxl"], ["lm_xxl_f32"])
    if not (argv in ([], ["kernels"]) or (argv[:1] in modes and len(argv) <= 2)):
        print("usage: python3 chip_smoke.py [kernels | agg [DIR] | flash [DIR] | conv [DIR] | "
              "resnet_bf16 [DIR] | lm_f32 [DIR] | lm_mid [DIR] | lm_xl [DIR] | "
              "lm_xl_f32 [DIR] | lm_xxl [DIR] | lm_xxl_f32 [DIR]]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv[:1] in modes:
        if len(argv) == 2:  # before any import of the package
            sys.path.insert(0, str(Path(argv[1]).resolve()))
        phase_device()
        {"agg": phase_agg, "flash": lambda: phase_flash_times(dev),
         "conv": lambda: phase_conv_times(dev),
         "resnet_bf16": lambda: _stateful_resnet_phase(
             "bf16", dict(norm="batch", use_bf16=True), _bn_auto_rule, _bn_check, by_shape=True),
         "lm_f32": lambda: phase_lm_profile(*phase_lm_wide_f32()[:2], steps=1,
                                            phase="lm_wide_f32_profile"),
         "lm_mid": lambda: phase_lm_profile(*phase_lm_mid_f32(False)[:2], steps=1,
                                            phase="lm_mid_f32_profile"),
         "lm_xl": lambda: phase_lm_profile(*phase_lm_xl()[:2], steps=1,
                                           phase="lm_xl_profile"),
         "lm_xl_f32": lambda: phase_lm_profile(*phase_lm_xl_f32(False)[:2], steps=1,
                                               phase="lm_xl_f32_profile"),
         "lm_xxl": lambda: phase_lm_profile(*phase_lm_xxl()[:2], steps=1,
                                            phase="lm_xxl_profile"),
         "lm_xxl_f32": lambda: phase_lm_profile(*phase_lm_xxl_f32(False)[:2], steps=1,
                                                phase="lm_xxl_f32_profile")}[argv[0]]()
        return 0
    smi = phase_device()
    phase_build()
    tc_rate, bf16_rate = phase_tc_rate(dev)
    entries = [check_quant(dev), check_gram(dev), *check_conv(dev, tc_rate), check_conv_dw(dev),
               *check_conv_bf16(dev, bf16_rate), check_conv_dw_bf16(dev),
               *check_flash(dev, tc_rate)]
    check_conv_nested(dev)
    if argv == ["kernels"]:
        return 0
    check_fused_krum(dev)
    phase_small()
    phase_repeat()
    launches = phase_main()
    phase_profile()
    phase_mnist_lr_main()
    phase_mnist_lr_dp()
    phase_small_resnet()
    phase_small_bn()
    phase_algorithms()
    phase_resume()
    launches.update(phase_resnet_main())
    phase_resnet_profile()
    phase_resnet_scaffold()
    phase_resnet_fedopt()
    bn_row, _ = phase_resnet_bn()
    launches.update(phase_resnet_bf16(bn_row))
    launches.update(phase_small_lm())
    launches.update(phase_small_lm("small_lm_128", SMALL_LM_128, suffix="_dh128_f32"))
    tr, data, lm_launches = phase_lm_main()
    launches.update(lm_launches)
    phase_lm_profile(tr, data)
    del tr
    launches.update(phase_small_lm("small_lm_256", SMALL_LM_256, suffix="_dh256_f32_small"))
    tr, data, lm_launches, full_losses = phase_lm_wide()
    launches.update(lm_launches)
    phase_lm_profile(tr, data, phase="lm_wide_profile")
    del tr
    phase_lm_wide_dots(full_losses)
    tr, data, lm_launches = phase_lm_wide_f32()
    launches.update(lm_launches)
    phase_lm_profile(tr, data, steps=1, phase="lm_wide_f32_profile")
    del tr
    tr, data, lm_launches = phase_lm_mid_f32()
    launches.update(lm_launches)
    phase_lm_profile(tr, data, steps=1, phase="lm_mid_f32_profile")
    del tr
    tr, data, lm_launches = phase_lm_xl()
    launches.update(lm_launches)
    phase_lm_profile(tr, data, steps=1, phase="lm_xl_profile")
    del tr
    torch.cuda.empty_cache()
    tr, data, lm_launches = phase_lm_xl_f32()
    launches.update(lm_launches)
    phase_lm_profile(tr, data, steps=1, phase="lm_xl_f32_profile")
    del tr
    torch.cuda.empty_cache()
    phase_small_lm_bf16()
    _check_routes("small_lm_384_f32", SMALL_LM_384["dim"], XL_F32_ROUTES)
    launches.update(phase_small_lm("small_lm_384_f32", SMALL_LM_384, suffix="_dh384_f32_small"))
    tr, data, lm_launches = phase_lm_xxl()
    launches.update(lm_launches)
    phase_lm_profile(tr, data, steps=1, phase="lm_xxl_profile")
    del tr
    torch.cuda.empty_cache()
    phase_small_lm_bf16("small_lm_512", SMALL_LM_512, "_dh512_small")
    launches.update(phase_small_lm_bf16("small_lm_1536", SMALL_LM_1536, "_dh1536_small"))
    tr, data, lm_launches = phase_lm_xxl_f32()
    launches.update(lm_launches)
    phase_lm_profile(tr, data, steps=1, phase="lm_xxl_f32_profile")
    del tr
    torch.cuda.empty_cache()
    _check_routes("small_lm_512_f32", SMALL_LM_512_F32["dim"], XXL_F32_ROUTES)
    launches.update(phase_small_lm("small_lm_512_f32", SMALL_LM_512_F32,
                                   suffix="_dh512_f32_small"))
    launches.update(phase_small_lm("small_lm_896_f32", SMALL_LM_896, suffix="_dh896_f32_small"))
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
