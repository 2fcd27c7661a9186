"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--seed N] [--stop-after kernels]

Phases (any failure exits non-zero; there is no CPU fallback):

1. Card: prints ``nvidia-smi --query-gpu=name,power.limit`` and builds the
   hand-written kernels from ``horovod_tpu_torch/csrc`` (one nvcc per
   source, started together, into ``horovod_tpu_torch/_build/``) and,
   beside them, the native negotiation core from ``csrc/core`` (g++);
   prints nvcc's report and each flash kernel's registers and spill
   bytes.  Every phase below asserts it ran on the native core.
2. Kernels: each flash kernel (K4 forward, K5 dQ, K6 dK/dV) against its
   plain PyTorch version, computed in fp32 from the same bf16 inputs, at the
   slice's shape (B 8, S 1024, H 12, D 64, causal; q, k and v are views of
   one fused [B, S, 3, H, D] tensor, as the model's qkv projection gives
   them), at a ragged one (S 1000, D 128, non-causal, contiguous) and at a
   ragged causal one (S 1000, D 64, fused views: the last tile of 128 rows
   is cut short inside each batch).  At the slice's shape it times the
   kernel, the plain version and, as yardsticks the port never calls,
   PyTorch's SDPA forward and backward (dq, dk and dv in one call, beside
   the port's whole backward: K5 with its delta, and K6).  K5 also
   computes the backward's delta = rowsum(dO * O) - dlse, held against the
   plain version's with dlse and without, and K6 is held on the delta K5
   wrote.  Every time is device time: over the kernels that one call
   launches, each one's mean from a profiler trace times its launches a
   call (``kernel_ms``, ``library_ms``), with the wall time by CUDA events
   beside it (``*_wall_ms``), which for a short kernel is mostly the
   host's cost of the call.  ``--stop-after kernels`` ends the run here.
3. Reference: a smoke check of the whole model -- a 2-layer GPT at
   GPT-2-small width, flash path against the dense-attention path of the
   same model on the card (logits, loss, a gradient).
4. Slice: the trainer a user writes — ``hvd.init()`` (NCCL, world 1),
   ``GPT(GPT_SMALL)`` from a seed, ``hvd.broadcast_parameters``,
   ``hvd.DistributedOptimizer(AdamW)``, steps on one fixed batch of 8 x 1024
   tokens with the loss averaged by ``hvd.allreduce``.  The kernels' launch
   counts are zeroed just before and read just after: each must rise by
   exactly 12 (one per layer) per step.  One more step is profiled: the
   device time by category, and the flash kernels' share of it.
5. Codec kernels: K1 (int8 codes), K2 (packed int4 codes) and K3 (decode)
   through ``quantize``, ``dequantize`` and ``fake_quantize`` for int8,
   int4 and int8g, held bitwise against the same functions composed from
   the plain versions on the card, at the size of GPT-2 small's gradient
   (163,109,376 fp32) and on an adversarial tensor; each kernel timed, and
   K3 beside ``torch.mul(codes, scales)``, which must give its bits.
6. World 2 on the one card: two ranks, both on ``cuda:0``.  Two ranks
   first ask NCCL for a group on the one card; the world-2 ranks use NCCL
   if it accepts, and ``HOROVOD_GPU_OPERATIONS=GLOO`` only if both are
   refused (NCCL 2.28 refuses: "Duplicate GPU detected"): a gloo group,
   tensors and kernels on the card.  (a) Collectives:
   ``quantized_allreduce`` for each codec x {ring, bidi} x {Sum,
   Average}, ``quantized_allgather`` and
   ``quantized_broadcast`` on 2^24 + 37 fp32 per rank, each bitwise
   identical on both ranks, bitwise equal to a CPU simulation of both ranks
   (the same ring code in two threads, plain versions), and launching the
   kernels exactly as often as its schedule implies.  (b) The slice's main
   path: ``hvd.DistributedOptimizer(AdamW, device_compression="int8")``
   training ``GPT(GPT_SMALL)`` for 3 steps, each rank on its own batch of
   4 x 1024 tokens, with launch counts exact per step, parameters bitwise
   identical across ranks, the error-feedback residual of three leaves
   bitwise equal to the plain arithmetic on the CPU, and the device byte
   counters equal to the ring's byte count.  Step times of two ranks
   sharing one card are printed and are not a speed result.
7. The negotiated spine (``spine``), through the port's native core.
   (a) World 1 over NCCL: the GPT_SMALL trainer for 5 steps with
   ``DistributedOptimizer(AdamW, named_parameters=...)``, plain and with
   ``num_groups=4``, on a side stream; per step the negotiated responses
   and tensors, the device plane's completions, host fallbacks (none
   allowed), K4-K6 launches (12 each), the step time and the host time
   from the last gradient's enqueue to ``synchronize``'s return.  (b) Two
   ranks on ``cuda:0`` (as in 6) with ``HOROVOD_WIRE_COMPRESSION=
   device=int8``: eager cases (allreduce Sum/Average/Min/Max/Product and
   pre/postscale, a grouped allreduce, a ragged allgather, broadcast, an
   uneven alltoall, an even reducescatter, a singleton process set, an
   int4 quantized_allreduce, CPU tensors over the C++ host ring, join with
   zero participation), each bitwise equal to a CPU simulation of both
   ranks on the buckets the device plane logged, with K1-K3 launches equal
   to what those buckets imply; then 3 GPT_SMALL steps with a plain
   ``DistributedOptimizer``, whose fused gradient buckets ride the int8
   ring: launches exact per step, parameters bitwise equal across ranks
   after every step, and each step's first quantized bucket replayed on
   the CPU from both ranks' inputs, bitwise.

8. The CNN harness (``cnn``), world 1 over NCCL, through
   ``horovod_tpu_torch.examples.cnn_benchmark``: ResNet-50 at 224 px,
   batch 64, bf16 activations and fp32 parameters, BatchNorm synced over
   the ranks, ``DistributedOptimizer(SGD(0.01, momentum=0.9))``: one
   warm-up and five timed steps (finite, falling loss; images/s, median
   step ms, peak memory), one more step profiled (device ms for
   convolution, BatchNorm, elementwise, optimizer; the idle share); then
   three steps replicated and three with ZeRO-1 from the same weights
   under cuDNN's deterministic algorithms, whose parameters must be equal
   to the bit; then the MNIST MLP trainer (two epochs) and VGG-16 and
   Inception V3 (299 px) for two steps each.
   No K1-K6 kernel may launch on these paths (the JAX package's CNNs reach
   no ``pallas_call``).
9. BERT-Large pretraining (``bert``), world 1 over NCCL, through
   ``examples.bert_pretraining``: 32 x 128 tokens, AdamW(1e-4) with
   ``Compression.fp16``, one warm-up and five timed steps (loss,
   sequences/s, step ms, peak memory), one more profiled; dense attention,
   so again no K1-K6 launch.
10. The CNN harness at world 2 (``cnn_world2``), two ranks on ``cuda:0``
   as in 6: ResNet-50 with synced BatchNorm, batch 16 per rank, two steps
   replicated and two with ZeRO-1.  Parameters and BatchNorm statistics
   bitwise equal across ranks; the first step's statistics held against
   a one-process replay on the two ranks' 32 images (``BN_REPLAY_TOL``);
   the ZeRO-1 parameters held to the replicated run's (``ZERO_W2_TOL``);
   each rank's optimizer-state bytes printed beside the replicated run's.

11. The rest of the eager spine (``spine_extras``).  (a) World 1 over NCCL:
   the GPT_SMALL trainer of 7 for 5 steps with the core's planes off and
   with all of them on (metrics, flight recorder, step trace), twice each
   in turns, the timeline around the steps and ``hvd.start_device_trace``
   around the last: the timeline must show a NEGOTIATE for every gradient's
   name, ``metrics()`` must count the responses and tensors
   ``HorovodContext.stats`` popped, ``metrics_prometheus()`` must parse
   with one HELP and one TYPE per family, ``step_trace()`` must hold
   consecutive rows of the five phases, the flight recorder must be on, and
   the device trace must name K4-K6 (12 launches a step each); the median
   step ms of steps 1-3 of both runs of each is printed.  (b) Two ranks on
   ``cuda:0`` as in 6: ``quantized_alltoall`` and
   ``quantized_reducescatter`` (Sum, Average) for each codec on 8,192 x 768
   fp32 a rank, bitwise equal to a CPU simulation of both ranks, K1-K3
   launched as the schedule implies, the device byte counters equal to
   (world-1) chunks raw and encoded, an fp16 input demoted to the plain
   alltoall bit for bit.  (c) GPT-2 small's token and position tables
   (``nn.Embedding(sparse=True)``) trained 3 steps by
   ``DistributedOptimizer(SGD, sparse_params=...)`` and with
   ``sparse_as_dense=True``, each rank on its own batch, rank 1's skipping
   the position table at one step: parameters bitwise equal across ranks,
   within ``SPARSE_REPLAY_TOL`` of a one-process replay, the gathers' bytes
   printed beside the dense tables'.  (d) The ``cnn`` phase prints the step
   trace's phase sums over ResNet-50's timed steps.

Each phase prints its seconds.  The line before the last is
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Limits of kernel vs plain version.  Inputs are unit-normal bf16 and the
# scale is D^-1/2, so scores have unit variance and P is spread over the
# live keys: entries of out, dq, dk and dv have a size of about
# sqrt(e / n_live) -- about 0.05 at S 1000, and from O(1) on the first rows
# down to 0.05 on the last in the causal slice.  So out and the gradients
# are held tile by tile: the largest, over (batch, 64-row tile, head), of
# ||kernel - plain|| / ||plain||, which a wrong tile or a percent-level
# error on every row exceeds.  The kernels round P and dS to bf16 before
# their second product and store bf16 outputs (2^-9 relative each); the
# plain version keeps fp32.  On an H100 these errors measured 2.3e-3 (out)
# and 2.4e-3 to 2.9e-3 (dq, dk, dv) at both shapes, lse 1e-6.  delta is
# a sum of D exact fp32 products of bf16 values on both sides, only in
# another order: it is held by max |kernel - plain| / max |plain|.
TILE = 64
TOL = {"out": 1e-2,     # bf16 output and P rounding
       "lse": 1e-4,     # absolute; fp32 on both sides, only summation order
       "delta": 1e-5,   # max-abs-relative; fp32 sums in another order
       "grad": 1e-2}    # bf16 P/dS operands and bf16 outputs

FLASH_CATEGORIES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
KERNELS = {
    "flash_fwd": ("horovod_tpu/ops/flash_attention.py:74", "_mha_kernel"),
    "flash_bwd_dq": ("horovod_tpu/ops/flash_attention.py:170",
                     "_mha_bwd_dq_kernel"),
    "flash_bwd_dkv": ("horovod_tpu/ops/flash_attention.py:220",
                      "_mha_bwd_dkv_kernel"),
}
KERNEL_SYMBOL = {"flash_fwd": "fwd_kernel", "flash_bwd_dq": "bwd_dq_kernel",
                 "flash_bwd_dkv": "bwd_dkv_kernel"}
SOURCE = "horovod_tpu_torch/csrc/flash_attention.cu"
CODEC_KERNELS = {
    "quant_int8": ("horovod_tpu/ops/quantize.py:338", "_quant_kernel"),
    "quant_int4": ("horovod_tpu/ops/quantize.py:350", "_quant_kernel_int4"),
    "dequant": ("horovod_tpu/ops/quantize.py:360", "_dequant_kernel"),
}
CODEC_SOURCE = "horovod_tpu_torch/csrc/quantize.cu"
_NO_LIBRARY = ("none: no one PyTorch call has the codec's NaN clamp and "
               "all-zero/non-finite block gate")
CODEC_LIBRARY = {"quant_int8": _NO_LIBRARY, "quant_int4": _NO_LIBRARY,
                 "dequant": "torch.mul(codes, scales)"}
CODECS = ("int8", "int4", "int8g")
# fp32 elements of GPT_SMALL's gradient (untied lm_head): 637,146 blocks.
GPT_SMALL_PARAMS = 163_109_376
WORLD2_ELEMS = (1 << 24) + 37
EF_STEPS = 3
EF_LEAVES = 51  # GPT_SMALL's weights of >= 64 KiB: 48 block matrices,
                # wte, wpe and lm_head


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean wall time of ``fn`` in ms by CUDA events after warm-up: the
    device's time only when the host enqueues faster than the device runs
    (a Python wrapper's own cost sets it for short kernels)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class ClockSampler:
    """The SM clock and power draw, sampled by ``nvidia-smi -lms`` while the
    block runs (the process is stopped on exit); ``summary()`` gives the
    median and range of the samples taken."""

    def __init__(self, period_ms: int = 10):
        self.cmd = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                    "--format=csv,noheader,nounits", f"-lms={period_ms}"]
        self.proc = None
        self.lines = []

    def __enter__(self):
        import tempfile

        self.out = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen(self.cmd, stdout=self.out,
                                     stderr=subprocess.DEVNULL, text=True)
        deadline = time.perf_counter() + 5.0  # until the first sample
        while self.out.tell() == 0 and time.perf_counter() < deadline:
            time.sleep(0.01)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            self.proc.wait(10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.out.seek(0)
        self.lines = self.out.read().splitlines()
        self.out.close()
        return False

    def summary(self) -> dict:
        clocks, watts = [], []
        for line in self.lines:
            try:
                mhz, w = (float(x) for x in line.split(","))
            except ValueError:
                continue
            clocks.append(mhz)
            watts.append(w)
        if not clocks:
            return {"sm_clock_mhz": "not measured"}
        clocks.sort()
        return {"sm_clock_mhz": clocks[len(clocks) // 2],
                "sm_clock_mhz_range": [clocks[0], clocks[-1]],
                "power_draw_w_max": max(watts), "samples": len(clocks)}


def device_kernels(prof) -> dict:
    """(device ms, event count) by kernel name from a torch.profiler trace:
    device events, less the record_function ranges mirrored onto the device
    timeline (they span kernels already counted)."""
    per_kernel = {}
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            ms, n = per_kernel.get(evt.name, (0.0, 0))
            per_kernel[evt.name] = (ms + evt.time_range.elapsed_us() / 1e3,
                                    n + 1)
    return per_kernel


def per_call_ms(per_kernel: dict, iters: int):
    """Device ms of one call, from the (ms, count) by kernel name of
    ``iters`` calls, and the number of events the trace lost.  A kernel
    that one call launches c times shows c * iters times unless the
    profiler dropped some of its events (it did, in one run on the card
    machine, and the sum fell 17% short), so each kernel counts as its mean
    time times round(count / iters)."""
    ms, lost = 0.0, 0
    for total, n in per_kernel.values():
        per_call = max(1, round(n / iters))
        ms += total / n * per_call
        lost += abs(per_call * iters - n)
    return ms, lost


def timed(fn, iters: int = 20, warmup: int = 3) -> dict:
    """``device_ms``: the device time of the kernels one call of ``fn``
    launches, from a torch.profiler trace of ``iters`` calls (``per_call_ms``,
    with the events it lost as ``events_lost``); ``wall_ms``: the same calls
    by CUDA events (host cost included)."""
    from torch.profiler import ProfilerActivity, profile

    wall = cuda_ms(fn, iters, warmup)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_kernel = device_kernels(prof)
    if not per_kernel:
        raise AssertionError("torch.profiler recorded no device time")
    ms, lost = per_call_ms(per_kernel, iters)
    return {"device_ms": ms, "wall_ms": wall, "events_lost": lost}


def ptxas_summary(report: str) -> dict:
    """Registers and spill bytes of each flash kernel from nvcc's
    ``-Xptxas -v`` report, keyed ``name<template args>``, and whether
    ptxas serialised its wgmma for want of registers (warning C7512)."""
    import re

    def kernel(symbol):
        k = re.search(r"(fwd_kernel|bwd_dq_kernel|bwd_dkv_kernel)"
                      r"ILi(\d+)E(?:Li(\d+)E)?", symbol)
        return None if k is None else \
            f"{k.group(1)}<{','.join(g for g in k.groups()[1:] if g)}>"

    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"\(C7512\).*for the function '([^']+)'", line)
        if m and kernel(m.group(1)):
            out.setdefault(kernel(m.group(1)), {})["wgmma_serialized"] = True
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = kernel(m.group(1))
            if name is not None:
                out.setdefault(name, {}).setdefault("wgmma_serialized", False)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(name, {})["spill_bytes"] = \
                int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def bound(b, s, h, d, causal, products, bytes_moved):
    """(bound_ms, bound_by): the larger of the products' FLOP at the bf16
    peak and the bytes at the HBM rate; causal counts the live pairs."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    flop_ms = products * 2 * pairs * d / PEAK_BF16_FLOPS * 1e3
    byte_ms = bytes_moved / PEAK_HBM_BYTES * 1e3
    return (flop_ms, "operations") if flop_ms >= byte_ms else \
        (byte_ms, "bytes")


def tile_rel_err(got, ref) -> float:
    """Largest over (batch, 64-row tile, head) of ||got - ref|| / ||ref||,
    for [B, S, H, D] tensors; NaN if any value is NaN."""
    worst = []
    for r0 in range(0, ref.shape[1], TILE):
        r = ref[:, r0:r0 + TILE].float()
        e = got[:, r0:r0 + TILE].float() - r
        worst.append((e.square().sum((1, 3)) /
                      r.square().sum((1, 3))).sqrt().max())
    return torch.stack(worst).max().item()


def kernel_phase(fa, shape, causal, seed, timing, fused_qkv):
    """Each kernel against its plain version on the same inputs.  With
    ``fused_qkv`` q, k and v are views of one [B, S, 3, H, D] tensor, as the
    model's qkv projection hands them to the kernels (seq stride 3*H*D)."""
    import torch.nn.functional as F

    b, s, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*sz):
        return torch.randn(*sz, generator=gen, device="cuda")

    if fused_qkv:
        qkv = randn(b, s, 3, h, d).to(torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v = (randn(b, s, h, d).to(torch.bfloat16) for _ in range(3))
    dout = randn(b, s, h, d).to(torch.bfloat16)
    scale = d ** -0.5
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, dout))
    blk = 64
    # Forward.
    out, lse = fa.flash_fwd_cuda(q, k, v, scale, causal)
    r_out, r_lse = fa.flash_fwd_reference(q32, k32, v32, scale, causal, blk)
    # Backward on shared inputs: K4's bf16 out (which K5 reads for delta)
    # and lse from the plain forward, with an lse cotangent (the dlse path
    # of the autograd function, last, so that K6 is held on the delta K5
    # wrote with dlse folded in) and without one (the path GPT takes).
    r_lse = r_lse.contiguous()
    dq_pairs, deltas = {}, {}
    for case, dlse in (("no_dlse", None), ("dlse", 0.1 * randn(b, h, s))):
        dq, delta = fa.flash_bwd_dq_cuda(q, k, v, dout, out, r_lse, dlse,
                                         scale, causal)
        r_dq, r_delta = fa.flash_bwd_dq_reference(
            q32, k32, v32, do32, out, r_lse, dlse, scale, causal, blk)
        dq_pairs[f"dq_{case}"] = (dq, r_dq)
        deltas[f"delta_{case}"] = (delta, r_delta)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, dout, r_lse, delta, scale,
                                   causal)
    r_dk, r_dv = fa.flash_bwd_dkv_reference(q32, k32, v32, do32, r_lse,
                                            r_delta, scale, causal, blk)
    torch.cuda.synchronize()
    pairs = {"flash_fwd": {"out": (out, r_out)},
             "flash_bwd_dq": dq_pairs,
             "flash_bwd_dkv": {"dk": (dk, r_dk), "dv": (dv, r_dv)}}
    # held: the error each limit in TOL applies to (tile-relative; lse max
    # abs; delta max abs over the largest plain value); max_abs: the largest
    # absolute difference, for the record.
    max_abs, held = {}, {}
    for name, outs in pairs.items():
        max_abs[name] = {o: (g.float() - r).abs().max().item()
                         for o, (g, r) in outs.items()}
        held[name] = {o: tile_rel_err(g, r) for o, (g, r) in outs.items()}
    max_abs["flash_fwd"]["lse"] = held["flash_fwd"]["lse"] = \
        (lse - r_lse).abs().max().item()
    for o, (g, r) in deltas.items():
        max_abs["flash_bwd_dq"][o] = (g - r).abs().max().item()
        held["flash_bwd_dq"][o] = max_abs["flash_bwd_dq"][o] / \
            r.abs().max().item()
    for name, per in held.items():
        for out_name, err in per.items():
            tol = TOL.get(out_name.split("_")[0], TOL["grad"])
            if not err <= tol:  # also catches NaN
                raise AssertionError(
                    f"{name} {out_name} at {shape} causal={causal}: error "
                    f"{err} > {tol}")
    errs = {"max_abs_err": max_abs, "held_err": held}
    if not timing:
        return errs, None, None
    elt = b * s * h * d * 2  # one bf16 [B, S, H, D] tensor
    stat = b * h * s * 4     # one fp32 [B, H, S] row statistic
    # (kernel, plain version, bound); each timed by device time (the
    # profiler's sum over the kernels one call launches) beside its wall
    # time by CUDA events.
    with ClockSampler() as clocks:
        kernels = {name: timed(fn) for name, fn in (
            ("flash_fwd",
             lambda: fa.flash_fwd_cuda(q, k, v, scale, causal)),
            ("flash_bwd_dq",
             lambda: fa.flash_bwd_dq_cuda(q, k, v, dout, out, r_lse, dlse,
                                          scale, causal)),
            ("flash_bwd_dkv",
             lambda: fa.flash_bwd_dkv_cuda(q, k, v, dout, r_lse, delta,
                                           scale, causal)))}
    times = {
        "flash_fwd": (
            kernels["flash_fwd"],
            timed(lambda: fa.flash_fwd_reference(q32, k32, v32, scale,
                                                 causal, blk), iters=3),
            bound(b, s, h, d, causal, 2, 4 * elt + stat)),
        "flash_bwd_dq": (
            kernels["flash_bwd_dq"],
            timed(lambda: fa.flash_bwd_dq_reference(
                q32, k32, v32, do32, out, r_lse, dlse, scale, causal, blk),
                iters=3),
            # q, k, v, dO and O read, dq written; lse and dlse read, delta
            # written.
            bound(b, s, h, d, causal, 3, 6 * elt + 3 * stat)),
        "flash_bwd_dkv": (
            kernels["flash_bwd_dkv"],
            timed(lambda: fa.flash_bwd_dkv_reference(
                q32, k32, v32, do32, r_lse, delta, scale, causal, blk),
                iters=3),
            bound(b, s, h, d, causal, 4, 6 * elt + 2 * stat)),
    }
    # Yardsticks only, never called by the port: PyTorch's SDPA on the same
    # inputs ([B, H, S, D] views), its forward, and its backward alone (the
    # graph is kept) -- dq, dk and dv in one call, set beside the port's
    # whole backward through autograd (K5 with its delta, and K6).
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_fwd = timed(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal))
    ql, kl, vl = (x.detach().clone().requires_grad_() for x in (qt, kt, vt))
    o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
    sdpa_bwd = timed(lambda: torch.autograd.grad(
        o, (ql, kl, vl), dout.transpose(1, 2), retain_graph=True))
    qp, kp, vp = (x.detach().requires_grad_() for x in (q, k, v))
    op = fa.flash_attention(qp, kp, vp, causal=causal, scale=scale)
    port_bwd = timed(lambda: torch.autograd.grad(
        op, (qp, kp, vp), dout, retain_graph=True))
    library = {"flash_fwd": (sdpa_fwd, "sdpa forward"),
               "flash_bwd_dq": (sdpa_bwd, "sdpa backward (dq, dk, dv)"),
               "flash_bwd_dkv": (sdpa_bwd, "sdpa backward (dq, dk, dv)")}
    backward = {"sdpa_backward": sdpa_bwd, "port_backward": port_bwd,
                "port_backward_parts": "K5 (with delta), K6",
                "kernel_timing_clocks": clocks.summary()}
    return errs, {n: (*times[n], *library[n]) for n in times}, backward


def reference_phase(seed):
    """Smoke check of the whole model: the flash path of a 2-layer
    GPT-2-small-width model against its dense-attention path, same weights,
    on the card, at a small batch.  The kernels themselves are held against
    their plain versions by kernel_phase."""
    import dataclasses

    from horovod_tpu_torch.models import GPT, GPT_SMALL, lm_loss

    torch.manual_seed(seed)
    cfg = dataclasses.replace(GPT_SMALL, num_layers=2)
    flash = GPT(cfg).cuda()
    dense = GPT(dataclasses.replace(cfg, use_flash=False)).cuda()
    dense.load_state_dict(flash.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    ids = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                        device="cuda")
    res = {}
    for name, model in (("flash", flash), ("dense", dense)):
        logits = model(ids)
        loss = lm_loss(logits, ids)
        loss.backward()
        res[name] = (logits.detach(), loss.item(),
                     model.h[0].attn.qkv.weight.grad)
    lf, ld = res["flash"][0], res["dense"][0]
    if lf.shape != (2, 256, cfg.vocab_size) or not torch.isfinite(lf).all():
        raise AssertionError("flash GPT logits not finite or misshapen")
    # bf16 attention output on both paths, rounded in different places,
    # carried through 2 layers and an fp32 head: logits and the layer-0 qkv
    # gradient are held by ||flash - dense|| / ||dense|| (on an H100 1.8e-3
    # and 4.6e-3).
    gf, gd = res["flash"][2], res["dense"][2]
    check = {"logits_rel": (((lf - ld).norm() / ld.norm()).item(), 1e-2),
             "loss": (abs(res["flash"][1] - res["dense"][1]), 1e-2),
             "qkv_grad_rel": (((gf - gd).norm() / gd.norm()).item(), 2e-2)}
    for key, (err, tol) in check.items():
        if not err <= tol:
            raise AssertionError(f"flash vs dense GPT {key}: {err} > {tol}")
    return {k: v[0] for k, v in check.items()}


def slice_phase(hvd, fa, seed, steps=5, batch=8, seq=1024):
    """Horovod's main loop on GPT-2 small: init, broadcast, steps."""
    from horovod_tpu_torch.models import GPT, GPT_SMALL, lm_loss

    from horovod_tpu_torch.context import HorovodContext

    hvd.init()
    try:
        if hvd.backend() != "nccl" or hvd.device().type != "cuda":
            raise AssertionError(f"init chose {hvd.backend()} on "
                                 f"{hvd.device()}")
        if HorovodContext.instance().core.name != "native":
            raise AssertionError("the slice ran without the native core")
        torch.manual_seed(seed)
        model = GPT(GPT_SMALL).to(hvd.device())
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=3e-4,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters())
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        gen = torch.Generator(device=hvd.device()).manual_seed(seed + 2)
        ids = torch.randint(0, GPT_SMALL.vocab_size, (batch, seq),
                            generator=gen, device=hvd.device())
        layers = GPT_SMALL.num_layers

        def train_step():
            opt.zero_grad()
            loss = lm_loss(model(ids), ids)
            loss.backward()
            opt.step()
            return hvd.allreduce(loss.detach()).item()  # readback ends it

        losses, step_ms = [], []
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        for _ in range(steps):
            before = dict(fa.LAUNCHES)
            t0 = time.perf_counter()
            losses.append(train_step())
            step_ms.append((time.perf_counter() - t0) * 1e3)
            rose = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES}
            if any(r != layers for r in rose.values()):
                raise AssertionError(f"kernel launches per step {rose}, "
                                     f"expected {layers} each")
        launches = dict(fa.LAUNCHES)
        mem_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        breakdown = profile_step(train_step)  # after the counted run
    finally:
        hvd.shutdown()
    if not all(x == x and abs(x) < float("inf") for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    if isinstance(breakdown["device_ms"], float):
        breakdown["idle_share"] = max(0.0, 1.0 - breakdown["device_ms"] /
                                      steady)
    return {"losses": losses, "step_ms": step_ms,
            "steady_step_ms": steady,
            "tokens_per_s": batch * seq / (steady / 1e3),
            "peak_mem_gb": mem_gb, "launches": launches,
            "breakdown": breakdown}


def profile_step(step) -> dict:
    """Device time of one more train step by kernel category, from a
    torch.profiler trace (the profiler itself stretches the step's wall
    time; the caller sets busy time against an unprofiled step)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {n: ms for n, (ms, _) in device_kernels(prof).items()}
    if not per_kernel:
        return {"profiled_wall_ms": wall_ms, "device_ms": "not measured"}
    rules = (("flash_fwd", ("fwd_kernel",)), ("flash_bwd_dq", ("bwd_dq",)),
             ("flash_bwd_dkv", ("bwd_dkv",)), ("nccl", ("nccl",)),
             ("optimizer", ("multi_tensor", "adam")),
             ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "wgmma")))
    cats = {}
    for name, ms in per_kernel.items():
        low = name.lower()
        cat = next((c for c, keys in rules if any(k in low for k in keys)),
                   "other")
        cats[cat] = cats.get(cat, 0.0) + ms
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    flash = sum(cats.get(c, 0.0) for c in FLASH_CATEGORIES)
    return {"profiled_wall_ms": wall_ms, "device_ms": busy,
            "flash_device_ms": flash, "flash_share": flash / busy,
            "by_category_ms": cats,
            "top_kernels_ms": [[n[:80], ms] for n, ms in top]}


# ---------------------------------------------------------------------------
# Codec kernels K1-K3.
# ---------------------------------------------------------------------------

def plain_quantize(qz, flat, codec):
    """``qz.quantize`` composed from the kernels' plain versions."""
    xb = qz._to_blocks(flat)
    if codec == "int4":
        scale, inv = qz._block_scales(xb, float(qz.WIRE_INT4_MAX))
        return qz.quant_int4_reference(xb, inv), scale
    if codec == "int8g":
        sub, gscale, inv = qz._group_scales(xb)
        return qz.quant_int8_reference(xb, inv), (sub, gscale)
    scale, inv = qz._block_scales(xb)
    return qz.quant_int8_reference(xb, inv), scale


def plain_dequantize(qz, codes, scales, count, codec):
    """``qz.dequantize`` composed from the kernels' plain versions."""
    if codec == "int4":
        codes = qz._unpack_int4(codes)
    elif codec == "int8g":
        scales = qz._effective_scales(*scales, codes.shape[0])
    return qz.dequant_reference(codes, scales).reshape(-1)[:count]


def same_bits(a, b) -> bool:
    """Bitwise equality (NaN bits count), shapes and dtypes included."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def max_abs_err(a, b) -> float:
    """Largest |a - b| over the elements finite in both (0.0 when none)."""
    a, b = a.double(), b.double()
    ok = torch.isfinite(a) & torch.isfinite(b)
    return (a - b)[ok].abs().max().item() if ok.any() else 0.0


def adversarial(numel: int, seed: int) -> torch.Tensor:
    """Unit normals of a length whose last block is short (37), with every
    special block of the codecs: all zeros, all NaN, a NaN in a finite
    block, +-inf blocks, an inf in a finite block, subnormals (a whole block
    and some beside normals), +-FLT_MAX, -0.0, and values at exactly k + 0.5
    quantization steps for int8 (scale 1) and for int4 (scale 1)."""
    import numpy as np

    f32 = np.finfo(np.float32)
    x = np.random.default_rng(seed).standard_normal(numel).astype(np.float32)
    x[0:256] = 0.0
    x[256:512] = np.nan
    x[600] = np.nan
    x[768:1024] = np.inf
    x[1024:1280] = -np.inf
    x[1300] = np.inf
    x[1536:1792] *= 1e-40                      # a block of subnormals
    x[1792:1802] = f32.smallest_subnormal * np.arange(1, 11)
    x[2048], x[2049] = f32.max, -f32.max
    x[2304:2560] = np.arange(256) % 20 - 10 + 0.5
    x[2304] = 127.0
    x[2560:2816] = -0.0
    x[2816:3072] = np.arange(256) % 14 - 7 + 0.5
    x[2816] = 7.0
    return torch.from_numpy(x).cuda()


def codec_phase(qz, seed):
    """The public codec functions through the kernels, bitwise against the
    same functions through the plain versions, at GPT_SMALL's gradient size
    and on the adversarial tensor; then each kernel timed at that size."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    inputs = {
        "gpt_small_grad": torch.randn(GPT_SMALL_PARAMS, generator=gen,
                                      device="cuda"),
        "adversarial": adversarial(256 * 1000 + 37, seed + 4),
    }
    errs = {name: 0.0 for name in CODEC_KERNELS}
    checked = {}
    for label, x in inputs.items():
        n = x.numel()
        for codec in CODECS:
            kcodes, kscales = qz.quantize(x, codec)
            pcodes, pscales = plain_quantize(qz, x, codec)
            quant = "quant_int4" if codec == "int4" else "quant_int8"
            kdeq = qz.dequantize(kcodes, kscales, n, codec)
            pdeq = plain_dequantize(qz, pcodes, pscales, n, codec)
            kfake = qz.fake_quantize(x, codec)
            ks = kscales if codec == "int8g" else (kscales,)
            ps = pscales if codec == "int8g" else (pscales,)
            ok = {"codes": same_bits(kcodes, pcodes),
                  "scales": all(same_bits(a, b) for a, b in zip(ks, ps)),
                  "dequantize": same_bits(kdeq, pdeq),
                  "fake_quantize": same_bits(kfake, pdeq)}
            torch.cuda.synchronize()
            checked[f"{label}/{codec}"] = ok
            if not all(ok.values()):
                raise AssertionError(f"codec kernels differ from their plain "
                                     f"versions: {label} {codec} {ok}")
            errs[quant] = max(errs[quant], max_abs_err(
                kcodes.float(), pcodes.float()))
            errs["dequant"] = max(errs["dequant"], max_abs_err(kdeq, pdeq))
            del kcodes, pcodes, kdeq, pdeq, kfake
    # Times at GPT_SMALL's gradient size, inputs as the int8 codec feeds
    # them (int4's scales differ only in value).
    x = inputs["gpt_small_grad"]
    xb = qz._to_blocks(x)
    scale, inv = qz._block_scales(xb)
    codes = qz.quant_int8_cuda(xb, inv)
    nb, n = xb.shape[0], x.numel()
    per_block = 4 * nb                        # one fp32 inv or scale each
    # K3 alone is one PyTorch call, int8 codes promoted to fp32 and
    # multiplied by the broadcast scales; it must give the kernel's bits.
    # K1 and K2 have none: no one call has the codec's NaN clamp and
    # all-zero/non-finite block gate.
    if not same_bits(torch.mul(codes, scale), qz.dequant_cuda(codes, scale)):
        raise AssertionError("torch.mul(codes, scales) differs from K3")
    work = {
        "quant_int8": (lambda: qz.quant_int8_cuda(xb, inv),
                       lambda: qz.quant_int8_reference(xb, inv), None,
                       4 * n + per_block + n),
        "quant_int4": (lambda: qz.quant_int4_cuda(xb, inv),
                       lambda: qz.quant_int4_reference(xb, inv), None,
                       4 * n + per_block + n // 2),
        "dequant": (lambda: qz.dequant_cuda(codes, scale),
                    lambda: qz.dequant_reference(codes, scale),
                    lambda: torch.mul(codes, scale),
                    n + per_block + 4 * n),
    }
    timing = {}
    for name, (kernel, plain, library, nbytes) in work.items():
        timing[name] = (timed(kernel), timed(plain, iters=5),
                        (nbytes / PEAK_HBM_BYTES * 1e3, "bytes"),
                        None if library is None else timed(library))
    del inputs, x, xb, codes
    torch.cuda.empty_cache()
    return {"checked": checked, "max_abs_err": errs,
            "elements": {"gpt_small_grad": GPT_SMALL_PARAMS,
                         "adversarial": 256 * 1000 + 37}}, timing


# ---------------------------------------------------------------------------
# World 2 on one card.
# ---------------------------------------------------------------------------

class ThreadRing:
    """The ring exchange of ``ops.collectives`` between threads of one
    process: the CPU simulation of every rank of a world."""

    def __init__(self, rank, size, box):
        self.rank, self.size, self._box = rank, size, box

    def exchange(self, tensors, dst, src):
        cond, mail = self._box
        with cond:
            mail.setdefault((self.rank, dst), []).append(list(tensors))
            cond.notify_all()
            while not mail.get((src, self.rank)):
                cond.wait()
            return mail[(src, self.rank)].pop(0)


def world2_input(seed, rank):
    import numpy as np

    return torch.from_numpy(np.random.default_rng(seed + rank)
                            .standard_normal(WORLD2_ELEMS, dtype=np.float32))


def digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy()
                          .tobytes()).hexdigest()


COLLECTIVE_CASES = ([("allreduce", c, s, o) for c in CODECS
                     for s in ("ring", "bidi") for o in ("sum", "average")]
                    + [("allgather", c, None, None) for c in CODECS]
                    + [("broadcast", c, None, None) for c in CODECS])
BROADCAST_ROOT = 1


def expected_launches(kind, codec, sched, rank, world=2):
    """Kernel launches one call makes on ``rank``: a ring allreduce encodes
    world times (world-1 hops and the owned chunk) and decodes 2*world-1
    times (world-1 hops and world gathered chunks); bidi runs two such
    rings."""
    if kind == "allreduce":
        rings = 2 if sched == "bidi" else 1
        quant, deq = rings * world, rings * (2 * world - 1)
    elif kind == "allgather":
        quant, deq = 1, world
    else:
        quant, deq = int(rank == BROADCAST_ROOT), 1
    key = "quant_int4" if codec == "int4" else "quant_int8"
    out = {"quant_int8": 0, "quant_int4": 0, "dequant": deq}
    out[key] = quant
    return out


def simulate_collectives(seed):
    """Digest of each case's result, from both ranks run as threads on the
    CPU with the same ring code and the kernels' plain versions."""
    import threading

    from horovod_tpu_torch.ops import collectives as col
    from horovod_tpu_torch.ops import quantize as qz

    xs = [world2_input(seed, r) for r in range(2)]
    out = {}
    for kind, codec, sched, op in COLLECTIVE_CASES:
        if kind == "allreduce":
            box = (threading.Condition(), {})
            res = [None, None]

            def run(r):
                res[r] = col._quantized_ring_allreduce_sum(
                    ThreadRing(r, 2, box), xs[r], codec, sched)

            threads = [threading.Thread(target=run, args=(r,))
                       for r in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if op == "average":
                res = [qz._div(a, 2) for a in res]
            if not same_bits(res[0], res[1]):
                raise AssertionError(f"simulated ranks differ: {codec} "
                                     f"{sched} {op}")
            result = res[0]
        elif kind == "allgather":
            result = torch.cat([qz.fake_quantize(x, codec) for x in xs])
        else:
            result = qz.fake_quantize(xs[BROADCAST_ROOT], codec)
        out[f"{kind}/{codec}/{sched}/{op}"] = digest(result)
    return out


def ef_leaf_check(qz, grad, old, new):
    """The residual error feedback stored, held bitwise against the plain
    arithmetic on the CPU: (g + r) - fake_quantize(g + r)."""
    g = grad.cpu()
    corrected = g + (0.0 if old is None else old.cpu())
    want = corrected - qz.fake_quantize(corrected, "int8")
    return same_bits(new.cpu(), want)


def world2_rank(rank, port, seed, gpu_operations, queue):
    """One of two ranks sharing ``cuda:0``, its collectives run by
    ``gpu_operations`` (NCCL or GLOO); puts its report on ``queue``."""
    import traceback

    os.environ.update(
        HOROVOD_RANK=str(rank), HOROVOD_SIZE="2", HOROVOD_LOCAL_RANK=str(rank),
        HOROVOD_LOCAL_SIZE="2", HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
        HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
        HOROVOD_GLOO_TIMEOUT_SECONDS="300",
        HOROVOD_GPU_OPERATIONS=gpu_operations)
    for var in ("HOROVOD_WIRE_COMPRESSION", "HOROVOD_DEVICE_SCHEDULE",
                "HOROVOD_WIRE_COMPRESSION_MIN_BYTES"):
        os.environ.pop(var, None)
    try:
        queue.put(world2_work(rank, seed))
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


def world2_work(rank, seed):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import GPT, GPT_SMALL, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import quantize as qz

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from horovod_tpu_torch.context import HorovodContext

    hvd.init(device="cuda:0")
    rep = {"rank": rank, "backend": hvd.backend(), "device": str(hvd.device())}
    try:
        if HorovodContext.instance().core.name != "native":
            raise AssertionError("world 2 ran without the native core")
        # (a) The collectives, counts zeroed just before and read after.
        x = world2_input(seed, rank).cuda()
        cases, wall_ms = {}, {}
        qz.reset_launch_counts()
        for kind, codec, sched, op in COLLECTIVE_CASES:
            before = dict(qz.LAUNCHES)
            t0 = time.perf_counter()
            if kind == "allreduce":
                out = hvd.quantized_allreduce(
                    x, op=hvd.Sum if op == "sum" else hvd.Average,
                    codec=codec, schedule=sched)
            elif kind == "allgather":
                out = hvd.quantized_allgather(x, codec=codec)
            else:
                out = hvd.quantized_broadcast(x, BROADCAST_ROOT, codec=codec)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rose = {k: qz.LAUNCHES[k] - before[k] for k in qz.LAUNCHES}
            want = expected_launches(kind, codec, sched, rank)
            if rose != want:
                raise AssertionError(f"{kind} {codec} {sched}: launches "
                                     f"{rose}, expected {want}")
            key = f"{kind}/{codec}/{sched}/{op}"
            cases[key], wall_ms[key] = digest(out), ms
            peers = hvd.allgather_object(cases[key])
            if len(set(peers)) != 1:
                raise AssertionError(f"{key}: ranks differ {peers}")
        rep["collectives"] = {"digests": cases, "wall_ms": wall_ms,
                              "launches": dict(qz.LAUNCHES)}
        del x, out
        torch.cuda.empty_cache()
        rep["ef_trainer"] = ef_trainer(hvd, fa, qz, GPT, GPT_SMALL, lm_loss,
                                       seed, rank)
    finally:
        hvd.shutdown()
    return rep


def ef_trainer(hvd, fa, qz, GPT, GPT_SMALL, lm_loss, seed, rank,
               batch=4, seq=1024):
    """The slice's main path: GPT-2 small through
    DistributedOptimizer(AdamW, device_compression="int8") at world 2."""
    dev = hvd.device()
    torch.manual_seed(seed)
    model = GPT(GPT_SMALL).to(dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(), device_compression="int8")
    gen = torch.Generator(device=dev).manual_seed(seed + 10 + rank)
    ids = torch.randint(0, GPT_SMALL.vocab_size, (batch, seq), generator=gen,
                        device=dev)
    named = dict(model.named_parameters())
    eligible = [n for n, p in named.items()
                if p.dtype == torch.float32 and p.numel() * 4 >= 1 << 16]
    if len(eligible) != EF_LEAVES:
        raise AssertionError(f"{len(eligible)} eligible leaves, expected "
                             f"{EF_LEAVES}")
    watch = ("wte.weight", "h.0.attn.qkv.weight", "lm_head.weight")
    per_step = {"quant_int8": 3 * EF_LEAVES, "quant_int4": 0,
                "dequant": 4 * EF_LEAVES, "flash_fwd": GPT_SMALL.num_layers,
                "flash_bwd_dq": GPT_SMALL.num_layers,
                "flash_bwd_dkv": GPT_SMALL.num_layers}
    losses, step_ms, leaf_ok = [], [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    qz.reset_launch_counts()
    fa.reset_launch_counts()
    qz.reset_device_byte_counters()
    for step in range(EF_STEPS):
        before = {**qz.LAUNCHES, **fa.LAUNCHES}
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = lm_loss(model(ids), ids)
        loss.backward()
        last = step == EF_STEPS - 1
        if last:  # error feedback's inputs, before synchronize() reduces
            local = {n: named[n].grad.clone() for n in watch}
            old = {n: opt.state[named[n]].get("ef_residual") for n in watch}
            old = {n: None if r is None else r.clone()
                   for n, r in old.items()}
        opt.step()
        losses.append(hvd.allreduce(loss.detach()).item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        now = {**qz.LAUNCHES, **fa.LAUNCHES}
        rose = {k: now[k] - before[k] for k in per_step}
        if rose != per_step:
            raise AssertionError(f"step {step}: launches {rose}, expected "
                                 f"{per_step}")
    launches = {**qz.LAUNCHES, **fa.LAUNCHES}
    raw, encoded = qz.device_byte_counters()
    want_bytes = [0, 0]
    for n in eligible:
        r, e = qz.ring_bytes(named[n].numel(), 2, "int8", "ring")
        want_bytes[0] += EF_STEPS * r
        want_bytes[1] += EF_STEPS * e
    if [raw, encoded] != want_bytes:
        raise AssertionError(f"device bytes {(raw, encoded)}, expected "
                             f"{want_bytes}")
    for n in watch:
        leaf_ok[n] = ef_leaf_check(qz, local[n], old[n],
                                   opt.state[named[n]]["ef_residual"])
    if not all(leaf_ok.values()):
        raise AssertionError(f"error-feedback residuals differ from the "
                             f"plain arithmetic: {leaf_ok}")
    params = digest(torch.cat([p.detach().reshape(-1)
                               for p in model.parameters()]))
    residuals = digest(torch.cat([opt.state[named[n]]["ef_residual"]
                                  .reshape(-1) for n in eligible]))
    peers = hvd.allgather_object((params, residuals))
    if len({p for p, _ in peers}) != 1:
        raise AssertionError("parameters differ across ranks after the "
                             "steps")
    if not all(x == x and abs(x) < float("inf") for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    return {"losses": losses, "step_ms": step_ms, "launches": launches,
            "launches_per_step": per_step, "eligible_leaves": len(eligible),
            "device_bytes": [raw, encoded],
            "residual_leaves_checked": leaf_ok,
            "params_identical_across_ranks": True,
            "residuals_identical_across_ranks":
                len({r for _, r in peers}) == 1,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def nccl_pair_rank(rank, port, queue):
    """One of two ranks asking NCCL for a group on the same card; reports
    NCCL's answer."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    try:
        dist.init_process_group("nccl", rank=rank, world_size=2,
                                init_method=f"tcp://127.0.0.1:{port}")
        t = torch.ones(1, device="cuda:0")
        dist.all_reduce(t)  # NCCL forms its communicator here
        torch.cuda.synchronize()
        dist.destroy_process_group()
        queue.put({"rank": rank, "accepted": True})
    except Exception as e:  # the answer is the result
        queue.put({"rank": rank, "accepted": False,
                   "error": str(e).strip().splitlines()[-1]})


def spawn_pair(target, args, timeout_s):
    """Run ``target(rank, port, *args, queue)`` in two spawned processes;
    returns their reports by rank.  Every process is joined or killed."""
    import queue as queue_mod
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, port, *args, results))
             for r in range(2)]
    for p in procs:
        p.start()
    reports = {}
    try:
        for _ in procs:
            rep = results.get(timeout=timeout_s)
            reports[rep["rank"]] = rep
    except queue_mod.Empty:
        raise AssertionError(f"{target.__name__}: a rank sent no report in "
                             f"{timeout_s} s")
    finally:
        for p in procs:
            p.join(60)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return reports, [p.exitcode for p in procs]


def world2_phase(seed, gpu_operations):
    """Both ranks in processes of their own on cuda:0, with the CPU
    simulation run meanwhile (in a thread of this process: the ranks spend
    most of their time waiting on each other).  Returns rank 0's report and
    rank 1's."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        simulated = pool.submit(simulate_collectives, seed)
        reports, codes = spawn_pair(world2_rank, (seed, gpu_operations), 900)
        sim = simulated.result()
    for rep in reports.values():
        if "error" in rep:
            raise AssertionError(f"world-2 rank {rep['rank']} failed:\n"
                                 f"{rep['error']}")
    if codes != [0, 0]:
        raise AssertionError(f"world-2 exit codes {codes}")
    for key, want in sim.items():
        got = reports[0]["collectives"]["digests"][key]
        if got != want:
            raise AssertionError(f"{key}: the card's result differs from the "
                                 "CPU simulation")
    return reports[0], reports[1]


# ---------------------------------------------------------------------------
# The negotiated spine.
# ---------------------------------------------------------------------------

SPINE_STEPS_W1 = 5
SPINE_STEPS_W2 = 3
SPINE_ELEMS = (1 << 20) + 37     # eager inputs: 4 MiB fp32, past the floor
SPINE_SET_ROWS = 1024            # rows of 8 for the row-wise collectives


def spine_world1(hvd, fa, seed, steps=SPINE_STEPS_W1, batch=8, seq=1024):
    """(a) GPT_SMALL at world 1 over NCCL through the negotiated spine:
    DistributedOptimizer(AdamW, named_parameters) plain and with
    num_groups=4, the trainer on a side stream, so that every gradient
    crosses the enqueue/executor streams by their events."""
    from horovod_tpu_torch.context import HorovodContext
    from horovod_tpu_torch.models import GPT, GPT_SMALL, lm_loss

    hvd.init()
    out = {}
    try:
        ctx = HorovodContext.instance()
        if hvd.backend() != "nccl" or ctx.core.name != "native":
            raise AssertionError(f"spine world 1 on {hvd.backend()} with the "
                                 f"{ctx.core.name} core")
        plane = ctx.device_plane
        dev = hvd.device()
        gen = torch.Generator(device=dev).manual_seed(seed + 2)
        ids = torch.randint(0, GPT_SMALL.vocab_size, (batch, seq),
                            generator=gen, device=dev)
        side = torch.cuda.Stream()
        for variant, kwargs in (("plain", {}), ("num_groups4",
                                                {"num_groups": 4})):
            torch.manual_seed(seed)
            model = GPT(GPT_SMALL).to(dev)
            hvd.broadcast_parameters(model.state_dict(), root_rank=0)
            opt = hvd.DistributedOptimizer(
                torch.optim.AdamW(model.parameters(), lr=3e-4,
                                  weight_decay=1e-4),
                named_parameters=model.named_parameters(), **kwargs)
            rows = []
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            for _ in range(steps):
                before = (dict(fa.LAUNCHES), dict(ctx.stats),
                          dict(plane.stats), ctx.core.negotiation_stats())
                t0 = time.perf_counter()
                with torch.cuda.stream(side):
                    opt.zero_grad()
                    loss = lm_loss(model(ids), ids)
                    loss.backward()
                    opt.synchronize()
                    overhead_ms = (time.monotonic()
                                   - ctx.last_enqueue_at) * 1e3
                    with opt.skip_synchronize():
                        opt.step()
                    value = hvd.allreduce(loss.detach(),
                                          name="spine.loss").item()
                step_ms = (time.perf_counter() - t0) * 1e3
                rose = {n: fa.LAUNCHES[n] - before[0][n] for n in fa.LAUNCHES}
                if any(r != GPT_SMALL.num_layers for r in rose.values()):
                    raise AssertionError(f"{variant}: launches {rose}, "
                                         "expected 12 each")
                neg = ctx.core.negotiation_stats()
                rows.append({
                    "loss": value, "step_ms": step_ms,
                    "sync_after_last_enqueue_ms": overhead_ms,
                    "responses": ctx.stats["responses"] - before[1]["responses"],
                    "tensors": ctx.stats["tensors"] - before[1]["tensors"],
                    "device_identity": plane.stats["identity"]
                    - before[2]["identity"],
                    "host_fallback": plane.stats["host_fallback"]
                    - before[2]["host_fallback"],
                    "ctrl_bytes": neg["ctrl_sent"] + neg["ctrl_recv"]
                    - before[3]["ctrl_sent"] - before[3]["ctrl_recv"],
                    "launches": rose})
            losses = [r["loss"] for r in rows]
            if not all(x == x and abs(x) < float("inf") for x in losses):
                raise AssertionError(f"{variant}: non-finite loss {losses}")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"{variant}: loss did not fall {losses}")
            if any(r["host_fallback"] for r in rows):
                raise AssertionError(f"{variant}: host fallbacks {rows}")
            steady = sorted(r["step_ms"] for r in rows[1:])
            out[variant] = {"steps": rows,
                            "median_step_ms": steady[len(steady) // 2],
                            "launches": dict(fa.LAUNCHES)}
            del model, opt
            torch.cuda.empty_cache()
    finally:
        hvd.shutdown()
    return out


def spine_input(seed, rank, n=SPINE_ELEMS):
    import numpy as np

    return torch.from_numpy(np.random.default_rng(seed + 100 + rank)
                            .standard_normal(n, dtype=np.float32))


SPINE_SPLITS = ([300, 724], [1000, 24])  # alltoall rows, per rank
# Eager cases whose result differs between the ranks.
SPINE_PER_RANK = ("alltoall", "alltoall_splits", "reducescatter",
                  "singleton_set")


def spine_eager(hvd, x, rank, sets):
    """The world-2 eager cases on cuda:0 tensors (one CPU tensor for the
    host ring); returns name -> result."""
    out = {}
    for op in ("Sum", "Average", "Min", "Max", "Product"):
        out[f"allreduce/{op}"] = hvd.allreduce(x, op=getattr(hvd, op),
                                               name=f"s.{op}")
    out["allreduce/scaled"] = hvd.allreduce(
        x, op=hvd.Sum, prescale_factor=2.0, postscale_factor=0.25,
        name="s.scaled")
    half = x.numel() // 2
    out["grouped"] = torch.cat(hvd.grouped_allreduce(
        [x[:half], x[half:] * 2], op=hvd.Sum, name="s.grouped"))
    rows = x[:8 * SPINE_SET_ROWS].reshape(SPINE_SET_ROWS, 8)
    out["allgather"] = hvd.allgather(rows[:SPINE_SET_ROWS // (2 - rank)],
                                     name="s.allgather")
    out["broadcast"] = hvd.broadcast(x, root_rank=1, name="s.broadcast")
    out["alltoall"], splits = hvd.alltoall(rows, splits=SPINE_SPLITS[rank],
                                           name="s.alltoall")
    out["alltoall_splits"] = splits.to(torch.float32)
    out["reducescatter"] = hvd.reducescatter(rows, op=hvd.Sum,
                                             name="s.reducescatter")
    out["singleton_set"] = hvd.allreduce(x, op=hvd.Sum, process_set=sets[rank],
                                         name=f"s.own{rank}")
    out["int4"] = hvd.quantized_allreduce(x, op=hvd.Sum, codec="int4")
    out["host"] = hvd.allreduce(x.cpu(), op=hvd.Sum, name="s.host")
    return out


def spine_expected(seed, logs):
    """The world-2 eager cases on the CPU from both ranks' inputs: exact
    arithmetic where the device plane moves fp32 exactly, and the quantized
    ring of ops.collectives in two threads with the kernels' plain versions
    on each bucket the ranks logged (zero-padded to its logged length)."""
    import threading

    from horovod_tpu_torch.ops import collectives as col
    from horovod_tpu_torch.ops import quantize as qz

    xs = [spine_input(seed, r) for r in range(2)]

    def ring(flats, codec, schedule="ring"):
        box = (threading.Condition(), {})
        res = [None, None]

        def run(r):
            res[r] = col._quantized_ring_allreduce_sum(
                ThreadRing(r, 2, box), flats[r], codec, schedule)

        threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if not same_bits(res[0], res[1]):
            raise AssertionError("simulated ranks differ")
        return res[0]

    def reduced(names, parts):
        """Each member's result: the logged buckets holding ``names``,
        rebuilt from ``parts`` (parts[rank][i] is member i) and summed, by
        the simulated ring where the bucket was quantized."""
        out = {}
        for entry in logs:
            idx = [names.index(nm) for nm in entry["names"] if nm in names]
            if not idx:
                continue
            if len(idx) != len(entry["names"]):
                raise AssertionError(f"bucket {entry['names']} mixes cases")
            flats = []
            for r in range(2):
                flat = torch.zeros(entry["length"])
                cat = torch.cat([parts[r][i] for i in idx])
                flat[:cat.numel()] = cat
                flats.append(flat)
            total = (sum(flats) if entry["codec"] == "none"
                     else ring(flats, entry["codec"], entry["schedule"]))
            off = 0
            for i in idx:
                m = parts[0][i].numel()
                out[names[i]] = total[off:off + m]
                off += m
        return [out[nm] for nm in names]

    n = xs[0].numel()
    want = {}
    (want["allreduce/Sum"],) = reduced(["s.Sum"], [[x] for x in xs])
    (total,) = reduced(["s.Average"], [[x] for x in xs])
    want["allreduce/Average"] = qz._div(total, 2)
    want["allreduce/Min"] = torch.minimum(*xs)
    want["allreduce/Max"] = torch.maximum(*xs)
    want["allreduce/Product"] = xs[0] * xs[1]
    (total,) = reduced(["s.scaled"], [[x * 2.0] for x in xs])
    want["allreduce/scaled"] = total * 0.25
    half = n // 2
    want["grouped"] = torch.cat(reduced(
        ["s.grouped.0", "s.grouped.1"], [[x[:half], x[half:] * 2]
                                         for x in xs]))
    rows = [x[:8 * SPINE_SET_ROWS].reshape(SPINE_SET_ROWS, 8) for x in xs]
    want["allgather"] = torch.cat([rows[0][:SPINE_SET_ROWS // 2], rows[1]])
    want["broadcast"] = xs[1]
    for r in range(2):
        got_rows = []
        for src in range(2):
            off = sum(SPINE_SPLITS[src][:r])
            got_rows.append(rows[src][off:off + SPINE_SPLITS[src][r]])
        want[f"alltoall/{r}"] = torch.cat(got_rows)
        want[f"alltoall_splits/{r}"] = torch.tensor(
            [SPINE_SPLITS[src][r] for src in range(2)], dtype=torch.float32)
        per = SPINE_SET_ROWS // 2
        want[f"reducescatter/{r}"] = (rows[0] + rows[1])[r * per:(r + 1) * per]
        want[f"singleton_set/{r}"] = xs[r]
    want["int4"] = ring(list(xs), "int4")
    want["host"] = xs[0] + xs[1]
    return {k: digest(v) for k, v in want.items()}


def spine_rank(rank, port, seed, gpu_operations, tmpdir, queue):
    """One of two ranks on cuda:0 for the spine's world-2 phase, with the
    device codec int8; puts its report on ``queue``."""
    import traceback

    os.environ.update(
        HOROVOD_RANK=str(rank), HOROVOD_SIZE="2", HOROVOD_LOCAL_RANK=str(rank),
        HOROVOD_LOCAL_SIZE="2", HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
        HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
        HOROVOD_GLOO_TIMEOUT_SECONDS="300",
        HOROVOD_GPU_OPERATIONS=gpu_operations,
        HOROVOD_WIRE_COMPRESSION="device=int8")
    for var in ("HOROVOD_DEVICE_SCHEDULE",
                "HOROVOD_WIRE_COMPRESSION_MIN_BYTES"):
        os.environ.pop(var, None)
    try:
        queue.put(spine_work(rank, seed, tmpdir))
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


def spine_work(rank, seed, tmpdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.context import HorovodContext
    from horovod_tpu_torch.models import GPT, GPT_SMALL, lm_loss
    from horovod_tpu_torch.ops import device_plane as dp
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import quantize as qz

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Each step's first quantized bucket, input and result, for the CPU
    # replay: the plane's ring is wrapped here, in the script.
    capture = {"step": None, "saved": set()}
    ring = dp._quantized_ring_allreduce_sum

    def capturing_ring(r, flat, codec, schedule):
        res = ring(r, flat, codec, schedule)
        step = capture["step"]
        if step is not None and step not in capture["saved"]:
            capture["saved"].add(step)
            torch.save({"flat": flat.cpu(), "digest": digest(res),
                        "codec": codec, "schedule": schedule},
                       os.path.join(tmpdir, f"bucket{rank}.{step}.pt"))
        return res

    dp._quantized_ring_allreduce_sum = capturing_ring
    hvd.init(device="cuda:0")
    rep = {"rank": rank, "backend": hvd.backend()}
    try:
        ctx = HorovodContext.instance()
        plane = ctx.device_plane
        if ctx.core.name != "native":
            raise AssertionError(f"{ctx.core.name} core")
        sets = [hvd.add_process_set([0]), hvd.add_process_set([1])]
        x = spine_input(seed, rank).cuda()
        qz.reset_launch_counts()
        plane.bucket_log.clear()
        fallback0 = plane.stats["host_fallback"]
        results = spine_eager(hvd, x, rank, sets)
        torch.cuda.synchronize()
        logs = list(plane.bucket_log)
        codec_buckets = sum(e["codec"] == "int8" for e in logs)
        want = {"quant_int8": 2 * codec_buckets, "quant_int4": 2,
                "dequant": 3 * codec_buckets + 3}
        if dict(qz.LAUNCHES) != want:
            raise AssertionError(f"eager launches {dict(qz.LAUNCHES)}, "
                                 f"the logged buckets imply {want}")
        if plane.stats["host_fallback"] != fallback0:
            raise AssertionError("eager cases fell back to the host ring")
        # Join: rank 1 joins; rank 0's Sum runs with its zeros, demoted by
        # negotiation to the host ring (the reference's semantics).
        if rank == 0:
            results["join_sum"] = hvd.allreduce(x, op=hvd.Sum, name="s.join")
        rep["join"] = hvd.join()
        rep["join_fallback"] = plane.stats["host_fallback"] - fallback0
        digests = {f"{k}/{rank}" if k in SPINE_PER_RANK else k: digest(v)
                   for k, v in results.items()}
        if rank == 0 and digests["join_sum"] != digest(x):
            raise AssertionError("joined Sum is not rank 0's own input")
        rep["eager"] = {"digests": digests, "bucket_log": logs,
                        "launches": dict(qz.LAUNCHES)}
        del x, results
        torch.cuda.empty_cache()
        rep["trainer"] = spine_trainer(hvd, ctx, plane, qz, fa, GPT,
                                       GPT_SMALL, lm_loss, seed, rank,
                                       capture)
    finally:
        hvd.shutdown()
    return rep


def spine_trainer(hvd, ctx, plane, qz, fa, GPT, GPT_SMALL, lm_loss, seed,
                  rank, capture, batch=4, seq=1024):
    """3 steps of GPT_SMALL with plain DistributedOptimizer(AdamW): the
    gradients' fused buckets ride the device codec's quantized ring."""
    dev = hvd.device()
    torch.manual_seed(seed)
    model = GPT(GPT_SMALL).to(dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters(), device_compression="none")
    gen = torch.Generator(device=dev).manual_seed(seed + 10 + rank)
    ids = torch.randint(0, GPT_SMALL.vocab_size, (batch, seq), generator=gen,
                        device=dev)
    steps = []
    torch.cuda.synchronize()
    qz.reset_launch_counts()
    fa.reset_launch_counts()
    for step in range(SPINE_STEPS_W2):
        plane.bucket_log.clear()
        before = {**qz.LAUNCHES, **fa.LAUNCHES}
        stats0 = dict(plane.stats)
        capture["step"] = step
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = lm_loss(model(ids), ids)
        loss.backward()
        opt.step()
        capture["step"] = None
        value = hvd.allreduce(loss.detach(), name="spine.loss").item()
        step_ms = (time.perf_counter() - t0) * 1e3
        logs = [e for e in plane.bucket_log if "spine.loss" not in e["names"]]
        quantized = [e for e in logs if e["codec"] == "int8"]
        now = {**qz.LAUNCHES, **fa.LAUNCHES}
        rose = {k: now[k] - before[k] for k in now}
        want = {"quant_int8": 2 * len(quantized), "quant_int4": 0,
                "dequant": 3 * len(quantized),
                "flash_fwd": GPT_SMALL.num_layers,
                "flash_bwd_dq": GPT_SMALL.num_layers,
                "flash_bwd_dkv": GPT_SMALL.num_layers}
        if rose != want:
            raise AssertionError(f"step {step}: launches {rose}, the logged "
                                 f"buckets imply {want}")
        if plane.stats["host_fallback"] != stats0["host_fallback"]:
            raise AssertionError(f"step {step}: host fallbacks")
        params = digest(torch.cat([p.detach().reshape(-1)
                                   for p in model.parameters()]))
        peers = hvd.allgather_object(params, name=f"spine.params.{step}")
        if len(set(peers)) != 1:
            raise AssertionError(f"step {step}: parameters differ across "
                                 "ranks")
        steps.append({
            "loss": value, "step_ms": step_ms, "launches": rose,
            "buckets": len(logs), "quantized_buckets": len(quantized),
            "bucket_elems": [e["length"] for e in logs],
            "bucket_tensors": [len(e["names"]) for e in logs],
            "fused_tensors": plane.stats["fused_tensors"]
            - stats0["fused_tensors"]})
    losses = [s["loss"] for s in steps]
    if not all(x == x and abs(x) < float("inf") for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    return {"steps": steps, "launches": {**qz.LAUNCHES, **fa.LAUNCHES},
            "params_identical_across_ranks": True,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def spine_replay(tmpdir, steps=SPINE_STEPS_W2):
    """Each step's first quantized bucket, replayed on the CPU from both
    ranks' captured inputs with the kernels' plain versions."""
    import threading

    from horovod_tpu_torch.ops import collectives as col

    checked = []
    for step in range(steps):
        caps = [torch.load(os.path.join(tmpdir, f"bucket{r}.{step}.pt"))
                for r in range(2)]
        box = (threading.Condition(), {})
        res = [None, None]

        def run(r):
            res[r] = col._quantized_ring_allreduce_sum(
                ThreadRing(r, 2, box), caps[r]["flat"], caps[r]["codec"],
                caps[r]["schedule"])

        threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for r in range(2):
            if digest(res[r]) != caps[r]["digest"]:
                raise AssertionError(f"step {step}: rank {r}'s bucket "
                                     "differs from the CPU replay")
        checked.append(caps[0]["flat"].numel())
    return checked


def spine_world2(seed, gpu_operations):
    """(b) Two ranks on cuda:0 with HOROVOD_WIRE_COMPRESSION=device=int8:
    the eager cases, then the GPT_SMALL trainer; every result held against
    the other rank and a CPU simulation on the logged buckets."""
    import shutil
    import tempfile

    tmpdir = tempfile.mkdtemp(prefix="hvd_spine_")
    try:
        reports, codes = spawn_pair(spine_rank,
                                    (seed, gpu_operations, tmpdir), 900)
        for rep in reports.values():
            if "error" in rep:
                raise AssertionError(f"spine rank {rep['rank']} failed:\n"
                                     f"{rep['error']}")
        if codes != [0, 0]:
            raise AssertionError(f"spine world-2 exit codes {codes}")
        logs = [reports[r]["eager"]["bucket_log"] for r in range(2)]
        if logs[0] != logs[1]:
            raise AssertionError("the ranks logged different buckets")
        want = spine_expected(seed, logs[0])
        for r in range(2):
            got = reports[r]["eager"]["digests"]
            for key, d in want.items():
                if key in got and got[key] != d:
                    raise AssertionError(f"rank {r} {key}: differs from the "
                                         "CPU simulation")
            missing = [k for k in got if k not in want and k != "join_sum"]
            if missing:
                raise AssertionError(f"unchecked cases {missing}")
        replayed = spine_replay(tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    for r in range(2):
        if reports[r]["join_fallback"] != (1 if r == 0 else 0):
            raise AssertionError(f"rank {r} join fallbacks "
                                 f"{reports[r]['join_fallback']}")
    return reports[0], reports[1], replayed


# ---------------------------------------------------------------------------
# The rest of the eager spine: the observability planes, the quantized
# alltoall and reducescatter, sparse gradients.
# ---------------------------------------------------------------------------

EXTRAS_STEPS = 5
EXTRAS_TRACED_STEP = 4      # the step inside start/stop_device_trace
# The core's planes: all off, and the reference's defaults plus metrics
# (with a step-trace ring long enough for every cycle of the steps).
PLANES = {"off": {"HOROVOD_METRICS": "0", "HOROVOD_FLIGHT_RECORDER": "off",
                  "HOROVOD_STEP_TRACE": "off"},
          "on": {"HOROVOD_METRICS": "1", "HOROVOD_FLIGHT_RECORDER": "on",
                 "HOROVOD_STEP_TRACE": "on",
                 "HOROVOD_STEP_TRACE_SLOTS": "4096"}}
# Each twice, in turns: one host's step time drifts between runs.
PLANE_RUNS = ("off", "on", "off", "on")
STEP_PHASES = ["negotiation_wait", "fusion", "ring", "fence", "idle"]
FLASH_SYMBOLS = ("fwd_kernel", "bwd_dq_kernel", "bwd_dkv_kernel")
# An MoE dispatch of GPT-2 small: one batch of 8 x 1024 tokens at width
# 768, fp32, per rank (25.2 MB).
A2A_ROWS, A2A_COLS = 8 * 1024, 768
SPARSE_VOCAB, SPARSE_POSITIONS, SPARSE_WIDTH = 50257, 1024, 768
SPARSE_BATCH, SPARSE_SEQ, SPARSE_STEPS, SPARSE_LR = 8, 128, 3, 0.1
# The sparse trainer against a one-process replay with dense embeddings:
# the same sums of fp32 gradients, duplicates summed in another order.
SPARSE_REPLAY_TOL = 1e-6


def init_with(hvd, env, **kwargs):
    """``hvd.init(**kwargs)`` with ``env`` set for it; the process's own
    environment is put back after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        hvd.init(**kwargs)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def prometheus_families(text: str) -> dict:
    """Check the exposition text line by line; returns family -> number of
    HELP and TYPE lines.  Every sample's family must have one of each."""
    import re

    label = r'[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*"'
    sample = re.compile(rf'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
                        rf'(\{{{label}(,{label})*\}})? -?[0-9.eE+Inf]+$')
    meta, samples = {}, set()
    for line in text.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            fam = line.split()[2]
            meta.setdefault(fam, [0, 0])[line.startswith("# TYPE ")] += 1
            continue
        m = sample.match(line)
        if not m:
            raise AssertionError(f"malformed exposition line {line!r}")
        samples.add(m.group(1))
    for name in samples:
        fam = next((name[:-len(s)] for s in ("_bucket", "_sum", "_count")
                    if name.endswith(s) and name[:-len(s)] in meta), name)
        if meta.get(fam) != [1, 1]:
            raise AssertionError(f"family {fam}: HELP/TYPE {meta.get(fam)}")
    if any(v != [1, 1] for v in meta.values()):
        raise AssertionError(f"repeated HELP/TYPE lines: {meta}")
    return meta


def step_trace_phase_sums(trace: dict, since_us: int, until_us: int) -> dict:
    """Phase sums (us) of the step-trace rows that started in
    [since_us, until_us] (the core closes a row per cycle that shipped
    work, so a train step spans many rows)."""
    rows = [r for r in trace.get("steps", [])
            if since_us <= r[1] <= until_us]
    sums = {p: sum(r[3 + i] for r in rows)
            for i, p in enumerate(trace.get("phases", STEP_PHASES))}
    return {"rows": len(rows), "phase_us": sums}


def observed_world1(hvd, fa, seed, tmpdir, steps=EXTRAS_STEPS, batch=8,
                    seq=1024):
    """(a) The GPT_SMALL spine trainer at world 1 over NCCL, in turns with
    the core's planes off and with all of them on, the timeline around the
    steps and torch.profiler's device trace around the last of them."""
    from horovod_tpu_torch.context import HorovodContext
    from horovod_tpu_torch.models import GPT, GPT_SMALL, lm_loss

    out = {"off": [], "on": []}
    for planes in PLANE_RUNS:
        init_with(hvd, PLANES[planes])
        try:
            ctx = HorovodContext.instance()
            if hvd.backend() != "nccl" or ctx.core.name != "native":
                raise AssertionError(f"planes {planes}: {hvd.backend()} on "
                                     f"the {ctx.core.name} core")
            dev = hvd.device()
            gen = torch.Generator(device=dev).manual_seed(seed + 2)
            ids = torch.randint(0, GPT_SMALL.vocab_size, (batch, seq),
                                generator=gen, device=dev)
            torch.manual_seed(seed)
            model = GPT(GPT_SMALL).to(dev)
            names = sorted(n for n, _ in model.named_parameters())
            opt = hvd.DistributedOptimizer(
                torch.optim.AdamW(model.parameters(), lr=3e-4,
                                  weight_decay=1e-4),
                named_parameters=model.named_parameters())
            timeline = os.path.join(tmpdir, f"timeline.{planes}.json")
            if planes == "on":
                hvd.start_timeline(timeline)
            before = (dict(ctx.stats), hvd.metrics().get("counters", {}))
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            rows, trace_path, t_first = [], None, time.time()
            for step in range(steps):
                traced = planes == "on" and step == EXTRAS_TRACED_STEP
                if traced:
                    hvd.start_device_trace(tmpdir)
                launched = dict(fa.LAUNCHES)
                t0 = time.perf_counter()
                opt.zero_grad()
                loss = lm_loss(model(ids), ids)
                loss.backward()
                opt.step()
                value = hvd.allreduce(loss.detach(),
                                      name="extras.loss").item()
                rows.append({"loss": value,
                             "step_ms": (time.perf_counter() - t0) * 1e3})
                if traced:
                    trace_path = hvd.stop_device_trace()
                rose = {n: fa.LAUNCHES[n] - launched[n] for n in fa.LAUNCHES}
                if any(r != GPT_SMALL.num_layers for r in rose.values()):
                    raise AssertionError(f"planes {planes}: launches {rose}, "
                                         "expected 12 each")
            t_last = time.time()
            check_losses(f"observed_{planes}", [r["loss"] for r in rows])
            # Steps 1-3 of every run: past the first, before the traced one.
            rep = {"steps": rows, "launches": dict(fa.LAUNCHES),
                   "steady_step_ms": [r["step_ms"] for r in
                                      rows[1:EXTRAS_TRACED_STEP]]}
            if planes == "on":
                hvd.stop_timeline()
                rep.update(check_planes(hvd, ctx, before, names, timeline,
                                        trace_path, t_first, t_last))
                rep["step_trace"]["rows_per_train_step"] = \
                    rep["step_trace"]["rows"] / steps
            out[planes].append(rep)
            del model, opt
            torch.cuda.empty_cache()
        finally:
            hvd.shutdown()
    for planes in PLANES:
        pooled = sorted(ms for rep in out[planes]
                        for ms in rep["steady_step_ms"])
        out[f"median_step_ms_planes_{planes}"] = pooled[len(pooled) // 2]
    return out


def check_planes(hvd, ctx, before, names, timeline, trace_path, t_first,
                 t_last) -> dict:
    """Every check of (a) on what the planes recorded over the steps."""
    with open(timeline) as f:
        events = json.load(f)
    negotiated = {e["args"]["tensor"] for e in events
                  if e.get("name") == "NEGOTIATE" and e.get("ph") == "B"}
    missing = sorted(set(names) - negotiated)
    if missing:
        raise AssertionError(f"timeline: no NEGOTIATE for {missing[:5]} "
                             f"({len(missing)} gradients)")
    counters = hvd.metrics()["counters"]
    seen = {"responses": counters["responses_total"]
            - before[1].get("responses_total", 0),
            "tensors": counters["tensors_fused_total"]
            - before[1].get("tensors_fused_total", 0)}
    popped = {k: ctx.stats[k] - before[0][k] for k in seen}
    if seen != popped:
        raise AssertionError(f"metrics {seen} against the context's {popped}")
    families = prometheus_families(hvd.metrics_prometheus())
    trace = hvd.step_trace()
    if trace.get("phases") != STEP_PHASES:
        raise AssertionError(f"step trace phases {trace.get('phases')}")
    ids = [r[0] for r in trace["steps"]]
    done = trace["completed"]
    if ids != list(range(done - len(ids), done)) or \
            {len(r) for r in trace["steps"]} != {9}:
        raise AssertionError(f"step trace rows {ids[:5]}... of {done}")
    flight = hvd.flight_record()
    if not flight or not flight.get("types"):
        raise AssertionError("the flight recorder is off")
    with open(trace_path) as f:
        kernels = {e.get("name", "") for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"}
    for symbol in FLASH_SYMBOLS:
        if not any(symbol in k for k in kernels):
            raise AssertionError(f"device trace: no {symbol} among "
                                 f"{len(kernels)} kernels")
    return {"timeline_events": len(events),
            "negotiated_names": len(negotiated), "metrics_vs_stats": seen,
            "prometheus_families": len(families),
            "step_trace": {"rows": len(ids), "completed": done,
                           **step_trace_phase_sums(
                               trace, int(t_first * 1e6),
                               int(t_last * 1e6))},
            "flight_events": len(flight["events"]),
            "device_trace_kernels": len(kernels),
            "device_trace_bytes": os.path.getsize(trace_path)}


def extras_input(seed, rank):
    import numpy as np

    x = np.random.default_rng(seed + 300 + rank).standard_normal(
        (A2A_ROWS, A2A_COLS), dtype=np.float32)
    x[17, :256] *= 1e3          # a loud block beside quiet ones
    return torch.from_numpy(x)


EXTRAS_CASES = [(kind, codec, op) for codec in CODECS
                for kind, op in (("alltoall", None), ("reducescatter", "Sum"),
                                 ("reducescatter", "Average"))]


def extras_key(kind, codec, op) -> str:
    return f"{kind}/{codec}" + (f"/{op}" if op else "")


def extras_launches(kind, codec, world=2) -> dict:
    """An alltoall encodes and decodes each of world chunks; a reducescatter
    encodes and decodes once per hop, world-1 hops."""
    n = world if kind == "alltoall" else world - 1
    out = {"quant_int8": 0, "quant_int4": 0, "dequant": n}
    out["quant_int4" if codec == "int4" else "quant_int8"] = n
    return out


def extras_bytes(codec, world=2) -> tuple:
    """(raw, encoded) device bytes of one call: (world-1) chunks of c."""
    from horovod_tpu_torch.ops import quantize as qz

    c = A2A_ROWS * A2A_COLS // world
    return (world - 1) * c * 4, (world - 1) * qz.encoded_nbytes(c, codec)


def simulate_extras(seed) -> dict:
    """Digest of each case's result on each rank, from both ranks run as
    threads on the CPU with the same code and the kernels' plain
    versions."""
    import threading

    from horovod_tpu_torch.ops import collectives as col
    from horovod_tpu_torch.wire import ReduceOp

    xs = [extras_input(seed, r) for r in range(2)]
    out = {}
    for kind, codec, op in EXTRAS_CASES:
        box = (threading.Condition(), {})
        res = [None, None]

        def run(r):
            ring = ThreadRing(r, 2, box)
            res[r] = (col._quantized_alltoall(ring, xs[r], codec)
                      if kind == "alltoall" else
                      col._quantized_reducescatter(ring, xs[r],
                                                   ReduceOp[op.upper()],
                                                   codec))

        threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for r in range(2):
            out[(r, extras_key(kind, codec, op))] = digest(res[r])
    return out


def extras_rank(rank, port, seed, gpu_operations, queue):
    """One of two ranks on ``cuda:0`` for (b) and (c)."""
    import traceback

    os.environ.update(
        HOROVOD_RANK=str(rank), HOROVOD_SIZE="2", HOROVOD_LOCAL_RANK=str(rank),
        HOROVOD_LOCAL_SIZE="2", HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
        HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
        HOROVOD_GLOO_TIMEOUT_SECONDS="300",
        HOROVOD_GPU_OPERATIONS=gpu_operations)
    for var in ("HOROVOD_WIRE_COMPRESSION", "HOROVOD_DEVICE_SCHEDULE",
                "HOROVOD_WIRE_COMPRESSION_MIN_BYTES"):
        os.environ.pop(var, None)
    try:
        queue.put(extras_work(rank, seed))
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


def extras_work(rank, seed):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.context import HorovodContext
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import quantize as qz
    from horovod_tpu_torch.ops.collectives import _caller_ring
    from horovod_tpu_torch.ops.device_plane import plain_alltoall

    hvd.init(device="cuda:0")
    rep = {"rank": rank, "backend": hvd.backend()}
    try:
        if HorovodContext.instance().core.name != "native":
            raise AssertionError("world 2 ran without the native core")
        # (b) The quantized alltoall and reducescatter.
        x = extras_input(seed, rank).cuda()
        digests, wall_ms = {}, {}
        qz.reset_launch_counts()
        for kind, codec, op in EXTRAS_CASES:
            key = extras_key(kind, codec, op)
            launched, sent = dict(qz.LAUNCHES), qz.device_byte_counters()
            t0 = time.perf_counter()
            if kind == "alltoall":
                out = hvd.quantized_alltoall(x, codec=codec)
            else:
                out = hvd.quantized_reducescatter(x, op=getattr(hvd, op),
                                                  codec=codec)
            torch.cuda.synchronize()
            wall_ms[key] = (time.perf_counter() - t0) * 1e3
            rose = {k: qz.LAUNCHES[k] - launched[k] for k in qz.LAUNCHES}
            if rose != extras_launches(kind, codec):
                raise AssertionError(f"{key}: launches {rose}, expected "
                                     f"{extras_launches(kind, codec)}")
            now = qz.device_byte_counters()
            moved = (now[0] - sent[0], now[1] - sent[1])
            if moved != extras_bytes(codec):
                raise AssertionError(f"{key}: device bytes {moved}, "
                                     f"expected {extras_bytes(codec)}")
            digests[key] = digest(out)
        launches = dict(qz.LAUNCHES)
        half = x.half()
        demoted = hvd.quantized_alltoall(half)
        if not same_bits(demoted, plain_alltoall(half, _caller_ring())) \
                or dict(qz.LAUNCHES) != launches:
            raise AssertionError("fp16 alltoall did not demote to the plain "
                                 "one bit for bit")
        rep["collectives"] = {"digests": digests, "wall_ms": wall_ms,
                              "launches": launches,
                              "flight_events":
                                  len(hvd.flight_record()["events"])}
        if not rep["collectives"]["flight_events"]:
            raise AssertionError("no flight-recorder event at world 2")
        del x, half, out, demoted
        torch.cuda.empty_cache()
        # (c) Sparse gradients.
        fa.reset_launch_counts()
        qz.reset_launch_counts()
        rep["sparse"] = {v: sparse_trainer(hvd, seed, rank, v)
                         for v in ("sparse_params", "sparse_as_dense")}
        if any({**fa.LAUNCHES, **qz.LAUNCHES}.values()):
            raise AssertionError("the embedding trainer launched a TPU "
                                 "kernel's port")
    finally:
        hvd.shutdown()
    if rank == 0:
        for v, r in rep["sparse"].items():
            r["replay_max_abs_err"] = sparse_replay(seed, v, r.pop("params"))
            if r["replay_max_abs_err"] > SPARSE_REPLAY_TOL:
                raise AssertionError(f"{v}: {r['replay_max_abs_err']} from "
                                     "the one-process replay")
    else:
        for r in rep["sparse"].values():
            r.pop("params")
    return rep


def sparse_model(sparse, dev):
    torch.manual_seed(0)
    return torch.nn.ModuleDict({
        "wte": torch.nn.Embedding(SPARSE_VOCAB, SPARSE_WIDTH, sparse=sparse),
        "wpe": torch.nn.Embedding(SPARSE_POSITIONS, SPARSE_WIDTH,
                                  sparse=sparse)}).to(dev)


def sparse_loss(model, seed, step, rank):
    """Each rank's own token ids; rank 1's batch at step 1 touches no
    position row (the zero-nnz case of the declared ``wpe``)."""
    gen = torch.Generator().manual_seed(seed + 400 + 10 * step + rank)
    dev = model["wte"].weight.device
    ids = torch.randint(0, SPARSE_VOCAB, (SPARSE_BATCH, SPARSE_SEQ),
                        generator=gen).to(dev)
    h = model["wte"](ids)
    if not (step == 1 and rank == 1):
        h = h + model["wpe"](torch.arange(SPARSE_SEQ, device=dev))
    return h.square().mean()


def sparse_trainer(hvd, seed, rank, variant) -> dict:
    """(c) GPT-2 small's token and position tables through
    DistributedOptimizer(SGD): sparse_params= or sparse_as_dense=True."""
    dev = hvd.device()
    model = sparse_model(True, dev)
    named = list(model.named_parameters())
    kwargs = ({"sparse_params": [n for n, _ in named]}
              if variant == "sparse_params" else {"sparse_as_dense": True})
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=SPARSE_LR),
        named_parameters=named, **kwargs)
    steps = []
    for step in range(SPARSE_STEPS):
        opt.zero_grad()
        sparse_loss(model, seed, step, rank).backward()
        # Bytes each rank's gathers carry: indices (int64) and fp32 rows of
        # the coalesced gradient, against the dense allreduce of the table.
        rows = {n: (p.grad.coalesce()._nnz() if p.grad is not None
                    and p.grad.is_sparse else 0) for n, p in named}
        t0 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        params = {n: digest(p) for n, p in named}
        peers = hvd.allgather_object(params)
        if peers[0] != peers[1]:
            raise AssertionError(f"{variant} step {step}: parameters differ "
                                 "across ranks")
        steps.append({"step_ms": ms, "rows": rows,
                      "gather_bytes": {n: r * (8 + SPARSE_WIDTH * 4)
                                       for n, r in rows.items()},
                      "dense_bytes": {n: p.numel() * 4 for n, p in named}})
    return {"steps": steps,
            "params": {n: p.detach().cpu() for n, p in named}}


def sparse_replay(seed, variant, got) -> float:
    """One process, dense tables, the two ranks' losses averaged: the
    largest distance of the trained parameters from ``got``."""
    dev = torch.device("cuda:0")
    model = sparse_model(False, dev)
    opt = torch.optim.SGD(model.parameters(), lr=SPARSE_LR)
    for step in range(SPARSE_STEPS):
        opt.zero_grad()
        loss = sum(sparse_loss(model, seed, step, r) for r in range(2))
        (loss / 2).backward()
        opt.step()
    return max(float((p.detach().cpu() - got[n]).abs().max())
               for n, p in model.named_parameters())


def spine_extras_phase(seed, gpu_operations) -> tuple:
    """(b) and (c): both ranks on cuda:0, with the CPU simulation of (b)
    run meanwhile in a thread of this process."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        simulated = pool.submit(simulate_extras, seed)
        reports, codes = spawn_pair(extras_rank, (seed, gpu_operations), 900)
        sim = simulated.result()
    for rep in reports.values():
        if "error" in rep:
            raise AssertionError(f"spine_extras rank {rep['rank']} failed:\n"
                                 f"{rep['error']}")
    if codes != [0, 0]:
        raise AssertionError(f"spine_extras exit codes {codes}")
    for (r, key), want in sim.items():
        if reports[r]["collectives"]["digests"][key] != want:
            raise AssertionError(f"rank {r} {key}: the card's result "
                                 "differs from the CPU simulation")
    return reports[0], reports[1]


# ---------------------------------------------------------------------------
# The CNN and BERT data-parallel paths.  The JAX package's ResNet, VGG,
# Inception, MLP and dense BERT reach no pallas_call, so no K1-K6 kernel
# may launch on them.
# ---------------------------------------------------------------------------

CNN_BATCH = 64          # the reference harness's default batch per chip
CNN_STEPS = 5           # timed, after one warm-up step
ZERO_STEPS = 3          # the ZeRO-1 run and its replicated twin
CNN_SHORT_STEPS = 2     # VGG-16 and Inception V3, after one warm-up step
CNN_W2_BATCH = 16       # per rank, two ranks on the one card
CNN_W2_STEPS = 2
BERT_BATCH = 32
BERT_SEQ = 128          # the reference's default
BERT_STEPS = 5
# The synced BatchNorm statistics of two ranks of 16 images against one
# process's BatchNorm over the 32: the same sums, but cuDNN may pick other
# algorithms for batches of 16 and 32, and a bf16 convolution output that
# differs by one rounding (2^-8) moves a layer's statistics and every
# layer after it; held per layer to this share of its largest magnitude.
BN_REPLAY_TOL = 5e-3
# ZeRO-1 against the replicated optimizer: both reduce the same fp32 sums
# and step the same SGD arithmetic, so at world 1 under cuDNN's
# deterministic algorithms the parameters must be equal to the bit.  At
# world 2 they are held to this share of the largest update the replicated
# run made (its gradients cross gloo in buckets whose fusion may differ
# from the sharded run's single reduce-scatter only in where the sums are
# rounded, which is nowhere for a sum of two).
ZERO_W2_TOL = 1e-3
# Kernel-name rules for the step breakdowns; BatchNorm's kernels are the
# ones inside its record_function ranges.
STEP_CATEGORIES = (
    ("nccl", ("nccl",)),
    ("optimizer", ("multi_tensor", "fused_sgd", "fused_adam")),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit_gemm",
                     "winograd", "precomputed")),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "wgmma")),
)


def kernel_launches(fa, qz) -> dict:
    return {**fa.LAUNCHES, **qz.LAUNCHES}


def categorize(prof, annotation_prefix: str = "batch_norm.") -> dict:
    """Device ms by category from a torch.profiler trace: kernels that run
    inside a ``record_function`` range named ``annotation_prefix...`` (on
    the device timeline) form their own category, the rest go by name
    (``STEP_CATEGORIES``, else ``elementwise_and_other``)."""
    ranges, kernels = [], []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (evt.time_range.start, evt.time_range.end)
        if getattr(evt, "is_user_annotation", False):
            if evt.name.startswith(annotation_prefix):
                ranges.append(span)
        else:
            kernels.append((evt.name, span))
    ranges.sort()
    starts = [r[0] for r in ranges]
    cats = {}
    import bisect

    for name, (start, end) in kernels:
        i = bisect.bisect_right(starts, start) - 1
        if i >= 0 and ranges[i][0] <= start and end <= ranges[i][1]:
            cat = "batch_norm"
        else:
            low = name.lower()
            cat = next((c for c, keys in STEP_CATEGORIES
                        if any(k in low for k in keys)),
                       "elementwise_and_other")
        cats[cat] = cats.get(cat, 0.0) + (end - start) / 1e3
    return {"by_category_ms": cats, "annotated_ranges": len(ranges)}


def profile_train_step(step) -> dict:
    """One more train step under torch.profiler: device ms by category
    (``categorize``), busy ms and the step's profiled wall ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step().item()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = device_kernels(prof)
    if not per_kernel:
        raise AssertionError("torch.profiler recorded no device time")
    busy = sum(ms for ms, _ in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    # Where the host's time goes: operators by self CPU time.
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"profiled_wall_ms": wall_ms, "device_ms": busy,
            **categorize(prof),
            "top_kernels_ms": [[n[:80], ms, k] for n, (ms, k) in top],
            "top_host_ops_self_ms": [[e.key[:60], e.self_cpu_time_total / 1e3,
                                      e.count] for e in host[:10]]}


def check_losses(what, losses, falling=True):
    if not all(x == x and abs(x) < float("inf") for x in losses):
        raise AssertionError(f"{what}: non-finite loss {losses}")
    if falling and not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: loss did not fall {losses}")


def trainer_report(res, batch, breakdown) -> dict:
    steady = res["step_ms_median"]
    if isinstance(breakdown.get("device_ms"), float):
        breakdown["idle_share"] = max(0.0, 1.0 - breakdown["device_ms"] /
                                      steady)
    return {"losses": res["losses"], "step_ms": res["step_ms"],
            "median_step_ms": steady, "batch": batch,
            "breakdown": breakdown}


def params_of(model) -> dict:
    return {n: p.detach().float().cpu().clone()
            for n, p in model.named_parameters()}


# The zoo BatchNorm's CUDA passes (PyTorch's batch-norm kernels) against
# its plain fp32 arithmetic on the same bf16 inputs: the fp32 statistics
# and parameter gradients sum the same values in another order; the bf16
# output and input gradient round values that differ by that much, so an
# element may move by one bf16 ulp (2^-8 of its size).
BN_CHECK_TOL = {"mean": 1e-4, "var": 1e-4, "grad_weight": 1e-4,
                "grad_bias": 1e-4, "out": 2 ** -7, "grad_input": 2 ** -7}
BN_CHECK_SHAPES = ((64, 64, 112, 112), (64, 2048, 7, 7))  # ResNet-50's ends


def batch_norm_check(seed) -> dict:
    """Each error as max |cuda - plain| / max |plain|, at the first and the
    last BatchNorm shape of ResNet-50 at batch 64; and device ms of one
    forward and backward of each at the first."""
    from horovod_tpu_torch import sync_batch_norm as sbn

    eps = 1e-5
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    out = {}
    for shape in BN_CHECK_SHAPES:
        c, cl = shape[1], torch.channels_last

        def rand(*s, scale=1.0, shift=0.0):
            return torch.randn(s, generator=gen, device="cuda") * scale + \
                shift

        x = rand(*shape, scale=2.0, shift=0.5).to(torch.bfloat16) \
            .contiguous(memory_format=cl)
        dy = rand(*shape).to(torch.bfloat16).contiguous(memory_format=cl)
        w, b = rand(c, scale=0.3, shift=1.0), rand(c, scale=0.1)

        def native():
            xr, wr, br = (t.detach().requires_grad_() for t in (x, w, b))
            o, mean, var, _ = sbn._BatchNormFn.apply(xr, wr, br, eps, None,
                                                     None)
            o.backward(dy)
            return {"out": o, "mean": mean, "var": var,
                    "grad_input": xr.grad, "grad_weight": wr.grad,
                    "grad_bias": br.grad}

        def plain():
            xf = x.float()
            dims = [0, 2, 3]
            count = torch.full((1,), float(x.numel() // c), device="cuda")
            mean, var, invstd, count = sbn._stats_from_sums(
                torch.cat([xf.sum(dims), (xf * xf).sum(dims), count]), c,
                eps)
            sums, gw, gb = sbn.plain_backward_sums(dy, x, mean, invstd)
            return {"out": sbn.plain_forward(x, w, b, mean, invstd),
                    "mean": mean, "var": var,
                    "grad_input": sbn.plain_backward_input(
                        dy, x, mean, invstd, w, sums, count),
                    "grad_weight": gw, "grad_bias": gb}

        got, want = native(), plain()
        errs = {k: (got[k].float() - want[k].float()).abs().max().item() /
                max(want[k].float().abs().max().item(), 1e-30)
                for k in want}
        bad = {k: e for k, e in errs.items() if not e <= BN_CHECK_TOL[k]}
        if bad:
            raise AssertionError(f"BatchNorm CUDA passes vs plain at "
                                 f"{shape}: {bad}")
        rep = {"rel_err": errs}
        if shape == BN_CHECK_SHAPES[0]:
            rep["native_ms"] = timed(native, iters=10)
            rep["plain_ms"] = timed(plain, iters=10)
        out["x".join(map(str, shape))] = rep
    return {"tol": BN_CHECK_TOL, **out}


def cnn_phase(hvd, fa, qz, seed) -> dict:
    """The CNN harness at world 1 over NCCL: ResNet-50 at 224 px, batch
    64, bf16 activations, DistributedOptimizer(SGD(0.01, momentum 0.9)):
    one warm-up and five timed steps, one more profiled; then three steps
    replicated and three with ZeRO-1 from the same weights under cuDNN's
    deterministic algorithms, the parameters compared; then the MNIST MLP
    for two epochs, and VGG-16 and Inception V3 (299 px) for two steps
    each."""
    from horovod_tpu_torch.context import HorovodContext
    from horovod_tpu_torch.examples import cnn_benchmark, mnist_mlp

    # A step-trace ring long enough for every cycle of ResNet-50's steps.
    init_with(hvd, {"HOROVOD_STEP_TRACE_SLOTS": "4096"})
    out = {}
    try:
        if hvd.backend() != "nccl" or \
                HorovodContext.instance().core.name != "native":
            raise AssertionError("the CNN phase needs NCCL and the native "
                                 "core")
        out["batch_norm_check"] = batch_norm_check(seed)
        torch.cuda.empty_cache()
        base = ["--batch-per-chip", str(CNN_BATCH), "--seed", str(seed)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        qz.reset_launch_counts()
        res = cnn_benchmark.main(["--model", "resnet50", "--steps",
                                  str(CNN_STEPS)] + base)
        launches = kernel_launches(fa, qz)
        check_losses("resnet50", res["losses"])
        # Where the host's time goes in the timed steps, by the core's
        # step-trace phases (data, not a check).
        phases = step_trace_phase_sums(hvd.step_trace(),
                                       *res["timed_unix_us"])
        out["resnet50"] = {
            "step_trace_timed_steps": phases,
            **trainer_report(res, CNN_BATCH,
                             profile_train_step(res["step"])),
            "images_per_sec": res["images_per_sec_per_chip"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "tpu_kernel_launches": launches}
        del res
        torch.cuda.empty_cache()
        out["zero1"] = zero1_world1(cnn_benchmark, base)
        # The first Horovod script, examples/jax_mnist_mlp.py's port: two
        # epochs of the MLP on synthetic MNIST-shaped data.
        fa.reset_launch_counts()
        qz.reset_launch_counts()
        t0 = time.perf_counter()
        mnist = mnist_mlp.main(["--seed", str(seed)])
        check_losses("mnist_mlp", mnist["epoch_losses"], falling=False)
        out["mnist_mlp"] = {"epoch_losses": mnist["epoch_losses"],
                            "seconds": time.perf_counter() - t0,
                            "tpu_kernel_launches": kernel_launches(fa, qz)}
        del mnist
        for model, steps in (("vgg16", CNN_SHORT_STEPS),
                             ("inception3", CNN_SHORT_STEPS)):
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launch_counts()
            qz.reset_launch_counts()
            res = cnn_benchmark.main(["--model", model, "--steps",
                                      str(steps)] + base)
            check_losses(model, res["losses"], falling=False)
            out[model] = {"losses": res["losses"],
                          "step_ms": res["step_ms"],
                          "images_per_sec": res["images_per_sec_per_chip"],
                          "peak_mem_gb":
                              torch.cuda.max_memory_allocated() / 2 ** 30,
                          "tpu_kernel_launches": kernel_launches(fa, qz)}
            del res
            torch.cuda.empty_cache()
    finally:
        hvd.shutdown()
    for name, rep in out.items():
        if any(rep.get("tpu_kernel_launches", {}).values()):
            raise AssertionError(f"{name} launched a TPU kernel's port: "
                                 f"{rep['tpu_kernel_launches']}")
    return out


def zero1_world1(cnn_benchmark, base) -> dict:
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for key, extra in (("replicated", []),
                           ("sharded", ["--shard-optimizer"])):
            t = cnn_benchmark.setup(["--model", "resnet50"] + base + extra)
            losses = [t["step"]().item() for _ in range(ZERO_STEPS)]
            opt = t["optimizer"]
            runs[key] = {"losses": losses, "params": params_of(t["model"]),
                         "bytes": opt.shard_bytes() if key == "sharded"
                         else {"state": optimizer_state_bytes(opt)}}
            del t, opt
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    rep, sh = runs["replicated"], runs["sharded"]
    diff = max((rep["params"][n] - sh["params"][n]).abs().max().item()
               for n in rep["params"])
    if diff != 0.0:
        raise AssertionError(f"ZeRO-1 parameters differ from the replicated "
                             f"run's by up to {diff}")
    check_losses("resnet50 zero1", sh["losses"])
    return {"steps": ZERO_STEPS, "bitwise_equal": True,
            "losses_replicated": rep["losses"], "losses_sharded": sh["losses"],
            "bytes_replicated": rep["bytes"], "bytes_sharded": sh["bytes"]}


def optimizer_state_bytes(opt) -> int:
    return sum(v.numel() * v.element_size() for st in opt.state.values()
               for v in st.values() if torch.is_tensor(v) and v.dim() > 0)


def bert_phase(hvd, fa, qz, seed) -> dict:
    """BERT-Large pretraining at world 1 over NCCL: 32 x 128 tokens,
    DistributedOptimizer(AdamW(1e-4), compression=Compression.fp16), one
    warm-up and five timed steps, one more profiled."""
    from horovod_tpu_torch.examples import bert_pretraining

    hvd.init()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        qz.reset_launch_counts()
        res = bert_pretraining.main(
            ["--large", "--batch-per-chip", str(BERT_BATCH), "--seq-len",
             str(BERT_SEQ), "--steps", str(BERT_STEPS), "--seed", str(seed)])
        launches = kernel_launches(fa, qz)
        check_losses("bert_large", res["losses"])
        out = {**trainer_report(res, BERT_BATCH,
                                profile_train_step(res["step"])),
               "seq": BERT_SEQ,
               "sequences_per_sec": res["sequences_per_sec_per_chip"],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
               "parameters": sum(p.numel() for p in res["model"].parameters()),
               "tpu_kernel_launches": launches}
        del res
        torch.cuda.empty_cache()
    finally:
        hvd.shutdown()
    if any(launches.values()):
        raise AssertionError(f"BERT launched a TPU kernel's port: {launches}")
    return out


def cnn_world2_rank(rank, port, seed, gpu_operations, tmpdir, queue):
    """One of two ranks on ``cuda:0``: ResNet-50 with synced BatchNorm,
    replicated and then with ZeRO-1; puts its report on ``queue``."""
    import traceback

    os.environ.update(
        HOROVOD_RANK=str(rank), HOROVOD_SIZE="2", HOROVOD_LOCAL_RANK=str(rank),
        HOROVOD_LOCAL_SIZE="2", HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
        HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
        HOROVOD_GLOO_TIMEOUT_SECONDS="300",
        HOROVOD_GPU_OPERATIONS=gpu_operations)
    for var in ("HOROVOD_WIRE_COMPRESSION", "HOROVOD_DEVICE_SCHEDULE",
                "HOROVOD_WIRE_COMPRESSION_MIN_BYTES"):
        os.environ.pop(var, None)
    try:
        queue.put(cnn_world2_work(rank, seed, tmpdir))
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


def cnn_world2_work(rank, seed, tmpdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import cnn_benchmark
    from horovod_tpu_torch.sync_batch_norm import BatchNorm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    hvd.init(device="cuda:0")  # both ranks on the one card
    rep = {"rank": rank, "backend": hvd.backend(), "device": str(hvd.device())}
    try:
        argv = ["--model", "resnet50", "--batch-per-chip", str(CNN_W2_BATCH),
                "--seed", str(seed)]
        params = {}
        for key, extra in (("replicated", []),
                           ("sharded", ["--shard-optimizer"])):
            t = cnn_benchmark.setup(argv + extra)
            init = params_of(t["model"]) if key == "replicated" else None
            losses, step_ms = [], []
            for i in range(CNN_W2_STEPS):
                t0 = time.perf_counter()
                losses.append(hvd.allreduce(t["step"]().detach(),
                                            name="w2.loss").item())
                step_ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0 and key == "replicated":
                    stats = {n: b.detach().cpu().clone() for n, b in
                             t["model"].named_buffers()}
            check_losses(f"world-2 {key}", losses, falling=False)
            params[key] = params_of(t["model"])
            opt = t["optimizer"]
            rep[key] = {
                "losses": losses, "step_ms": step_ms,
                "params_digest": digest(torch.cat(
                    [p.reshape(-1) for p in params[key].values()])),
                "bytes": opt.shard_bytes() if key == "sharded"
                else {"state": optimizer_state_bytes(opt)},
                "synced_bn_layers": sum(isinstance(m, BatchNorm) and m.sync
                                        for m in t["model"].modules())}
            if key == "replicated":
                rep[key]["stats_digest"] = digest(torch.cat(
                    [b.reshape(-1).float() for b in stats.values()]))
                rep[key]["buffers_digest"] = digest(torch.cat(
                    [b.detach().reshape(-1).float()
                     for b in t["model"].buffers()]))
                update = max((params[key][n] - init[n]).abs().max().item()
                             for n in init)
            del t, opt
            torch.cuda.empty_cache()
        diff = max((params["replicated"][n] - params["sharded"][n])
                   .abs().max().item() for n in params["sharded"])
        rep["zero1_vs_replicated_max_abs"] = diff
        rep["replicated_max_update"] = update
        if rank == 0:
            torch.save({"stats": stats}, os.path.join(tmpdir, "stats.pt"))
    finally:
        hvd.shutdown()
    return rep


def cnn_world2_phase(seed, gpu_operations) -> dict:
    """Two ranks of the CNN harness on the one card (``cnn_world2_rank``),
    then a one-process replay of the first step's BatchNorm statistics on
    the two ranks' 32 images."""
    import tempfile

    from horovod_tpu_torch.examples import cnn_benchmark

    with tempfile.TemporaryDirectory() as tmpdir:
        reports, codes = spawn_pair(cnn_world2_rank,
                                    (seed, gpu_operations, tmpdir), 900)
        for rep in reports.values():
            if "error" in rep:
                raise AssertionError(f"cnn world-2 rank {rep['rank']} "
                                     f"failed:\n{rep['error']}")
        if codes != [0, 0]:
            raise AssertionError(f"cnn world-2 exit codes {codes}")
        stats = torch.load(os.path.join(tmpdir, "stats.pt"))["stats"]
    r0, r1 = reports[0], reports[1]
    for key in ("replicated", "sharded"):
        if r0[key]["params_digest"] != r1[key]["params_digest"]:
            raise AssertionError(f"world-2 {key}: parameters differ across "
                                 "ranks")
    if r0["replicated"]["buffers_digest"] != r1["replicated"]["buffers_digest"]:
        raise AssertionError("world-2: BatchNorm statistics differ across "
                             "ranks")
    if not r0["zero1_vs_replicated_max_abs"] <= \
            ZERO_W2_TOL * r0["replicated_max_update"]:
        raise AssertionError(
            f"world-2 ZeRO-1 parameters {r0['zero1_vs_replicated_max_abs']} "
            f"from the replicated run's (largest update "
            f"{r0['replicated_max_update']})")
    # The replay: one process, both ranks' images as one batch of 32, on
    # the weights and images cnn_benchmark.setup made from the seed.
    device = torch.device("cuda:0")
    build, hw = cnn_benchmark.MODELS["resnet50"]
    torch.manual_seed(seed)
    model = build(torch.bfloat16).to(device)
    images = []
    for rank in range(2):
        gen = torch.Generator(device=device).manual_seed(seed * 1000 + rank)
        images.append(torch.randn(CNN_W2_BATCH, 3, hw, hw, generator=gen,
                                  device=device))
    model.train()
    with torch.no_grad():
        model(torch.cat(images).contiguous(memory_format=torch.channels_last))
    worst = 0.0
    for name, buf in model.named_buffers():
        want = buf.detach().float().cpu()
        err = (stats[name].float() - want).abs().max().item() / \
            max(want.abs().max().item(), 1e-30)
        worst = max(worst, err)
    if not worst <= BN_REPLAY_TOL:
        raise AssertionError(f"synced BatchNorm statistics {worst} from the "
                             "one-process replay")
    del model, images
    torch.cuda.empty_cache()
    return {"ranks": [r0, r1], "bn_replay_max_rel_err": worst,
            "bn_replay_tol": BN_REPLAY_TOL, "zero1_tol": ZERO_W2_TOL}


def timed_phase(fn, *args):
    """``fn(*args)`` and its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    return out, round(time.perf_counter() - t0, 3)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, inputs and token ids")
    ap.add_argument("--stop-after", choices=("kernels",),
                    help="stop after the flash kernel phase (a short check "
                         "of a changed kernel); prints no result line")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)

    from concurrent.futures import ThreadPoolExecutor

    from horovod_tpu_torch.ops import quantize as qz

    t0 = time.perf_counter()
    sources = ("flash_attention", "quantize")
    # One nvcc per kernel source and the native core's g++ builds, at once.
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        core = pool.submit(_build.build_core)
        builds = dict(zip(sources, pool.map(_build.build, sources)))
        core_lib = core.result()
    print(json.dumps({"phase": "build", "seconds":
                      round(time.perf_counter() - t0, 3),
                      "native_core": os.path.relpath(core_lib)}), flush=True)
    for name, (_, report) in builds.items():
        if report:
            print(f"nvcc {name}.cu:\n{report.strip()}", flush=True)
    ptxas = ptxas_summary(builds["flash_attention"][1])
    print(json.dumps({"phase": "ptxas", "flash_attention": ptxas}),
          flush=True)

    # (shape [B, S, H, D], causal, q/k/v as views of one fused qkv tensor)
    shapes = {"slice": ((8, 1024, 12, 64), True, True),
              "ragged": ((2, 1000, 4, 128), False, False),
              "ragged_causal": ((2, 1000, 12, 64), True, True)}
    errors = {}
    for label, (shape, causal, fused) in shapes.items():
        errs, tm, bwd = kernel_phase(fa, shape, causal, args.seed,
                                     timing=label == "slice",
                                     fused_qkv=fused)
        errors[label] = errs
        if tm is not None:
            timing, backward = tm, bwd
        print(json.dumps({"phase": "kernels", "shape": label,
                          "bshd": shape, "causal": causal,
                          "fused_qkv_views": fused, "tol": TOL,
                          **errs}), flush=True)
    for name, (ms, plain, (bound_ms, bound_by), lib, lib_call) \
            in timing.items():
        print(json.dumps({"kernel": name, "shape": "slice",
                          "max_abs_err": errors["slice"]["max_abs_err"][name],
                          "held_err": errors["slice"]["held_err"][name],
                          "kernel_ms": ms["device_ms"],
                          "kernel_wall_ms": ms["wall_ms"],
                          "plain_ms": plain["device_ms"],
                          "library_ms": lib["device_ms"],
                          "library_wall_ms": lib["wall_ms"],
                          "library_call": lib_call,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "events_lost": [ms["events_lost"],
                                          plain["events_lost"],
                                          lib["events_lost"]],
                          "card": card}), flush=True)
    print(json.dumps({"phase": "backward", "shape": "slice", "card": card,
                      **backward}), flush=True)
    if args.stop_after == "kernels":
        return 0

    (codec, codec_timing), secs = timed_phase(codec_phase, qz, args.seed)
    print(json.dumps({"phase": "codec_kernels", "seconds": secs, **codec}),
          flush=True)
    for name, (ms, plain, (bound_ms, bound_by), lib) \
            in codec_timing.items():
        print(json.dumps({"kernel": name, "elements": GPT_SMALL_PARAMS,
                          "kernel_ms": ms["device_ms"],
                          "kernel_wall_ms": ms["wall_ms"],
                          "plain_ms": plain["device_ms"],
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": None if lib is None
                          else lib["device_ms"],
                          "library_call": CODEC_LIBRARY[name],
                          "card": card}), flush=True)

    ref, secs = timed_phase(reference_phase, args.seed)
    print(json.dumps({"phase": "reference", "seconds": secs,
                      "flash_vs_dense": ref}), flush=True)

    res, secs = timed_phase(slice_phase, hvd, fa, args.seed)
    print(json.dumps({"phase": "slice", "model": "GPT_SMALL",
                      "batch": 8, "seq": 1024, "card": card,
                      "seconds": secs, **res}), flush=True)
    torch.cuda.empty_cache()
    spine1, secs = timed_phase(spine_world1, hvd, fa, args.seed)
    print(json.dumps({"phase": "spine", "part": "world1_nccl",
                      "model": "GPT_SMALL", "batch": 8, "seq": 1024,
                      "card": card, "seconds": secs, **spine1}), flush=True)

    torch.cuda.empty_cache()
    cnn, secs = timed_phase(cnn_phase, hvd, fa, qz, args.seed)
    print(json.dumps({"phase": "cnn", "world": 1, "image_px": 224,
                      "batch": CNN_BATCH, "dtype": "bf16 activations, fp32 "
                      "parameters", "optimizer": "SGD(0.01, momentum 0.9)",
                      "card": card, "seconds": secs, **cnn}), flush=True)
    torch.cuda.empty_cache()
    bert, secs = timed_phase(bert_phase, hvd, fa, qz, args.seed)
    print(json.dumps({"phase": "bert", "model": "BERT_LARGE", "world": 1,
                      "optimizer": "AdamW(1e-4), Compression.fp16",
                      "card": card, "seconds": secs, **bert}), flush=True)

    torch.cuda.empty_cache()
    nccl, _ = spawn_pair(nccl_pair_rank, (), 300)
    # NCCL whenever it takes two ranks on one card; gloo on the card only
    # when both ranks were refused.
    gpu_operations = ("GLOO" if not any(a["accepted"] for a in nccl.values())
                      else "NCCL")
    print(json.dumps({"phase": "nccl_two_ranks_one_card",
                      "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                      "answers": [nccl[r] for r in sorted(nccl)],
                      "world2_gpu_operations": gpu_operations}), flush=True)
    (rank0, rank1), secs = timed_phase(world2_phase, args.seed,
                                       gpu_operations)
    for rep in (rank0, rank1):
        print(json.dumps({"phase": "world2", "model": "GPT_SMALL",
                          "batch_per_rank": 4, "seq": 1024,
                          "note": "two ranks share one card: step times "
                                  "are not a speed result",
                          "card": card, "seconds": secs, **rep}), flush=True)
    torch.cuda.empty_cache()
    (spine0, spine1_rank, replayed), secs = timed_phase(
        spine_world2, args.seed, gpu_operations)
    for rep in (spine0, spine1_rank):
        print(json.dumps({"phase": "spine", "part": "world2",
                          "model": "GPT_SMALL", "batch_per_rank": 4,
                          "seq": 1024, "gpu_operations": gpu_operations,
                          "device_codec": "int8",
                          "replayed_bucket_elems": replayed,
                          "note": "two ranks share one card: step times "
                                  "are not a speed result",
                          "card": card, "seconds": secs, **rep}), flush=True)
    torch.cuda.empty_cache()
    import shutil
    import tempfile

    tmpdir = tempfile.mkdtemp(prefix="hvd_extras_")
    try:
        observed, secs = timed_phase(observed_world1, hvd, fa, args.seed,
                                     tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    print(json.dumps({"phase": "spine_extras", "part": "world1_planes",
                      "model": "GPT_SMALL", "batch": 8, "seq": 1024,
                      "card": card, "seconds": secs, **observed}),
          flush=True)
    torch.cuda.empty_cache()
    (extras0, extras1), secs = timed_phase(spine_extras_phase, args.seed,
                                           gpu_operations)
    for rep in (extras0, extras1):
        print(json.dumps({"phase": "spine_extras", "part": "world2",
                          "a2a_rs_shape": [A2A_ROWS, A2A_COLS],
                          "sparse_tables": [[SPARSE_VOCAB, SPARSE_WIDTH],
                                            [SPARSE_POSITIONS,
                                             SPARSE_WIDTH]],
                          "gpu_operations": gpu_operations,
                          "note": "two ranks share one card: times are not "
                                  "a speed result",
                          "card": card, "seconds": secs, **rep}), flush=True)
    torch.cuda.empty_cache()
    cnn2, secs = timed_phase(cnn_world2_phase, args.seed, gpu_operations)
    print(json.dumps({"phase": "cnn_world2", "model": "resnet50",
                      "batch_per_rank": CNN_W2_BATCH,
                      "gpu_operations": gpu_operations,
                      "note": "two ranks share one card over gloo staged "
                              "through the host: step times are not a "
                              "speed result",
                      "card": card, "seconds": secs, **cnn2}), flush=True)
    ef = rank0["ef_trainer"]
    trainer = spine0["trainer"]["launches"]
    codec_launches = {"quant_int8": trainer["quant_int8"],
                      "quant_int4": spine0["eager"]["launches"]["quant_int4"],
                      "dequant": trainer["dequant"]}
    codec_path = {"quant_int8": "spine world-2 trainer (device codec int8)",
                  "quant_int4": "spine world-2 eager cases (the int4 case)",
                  "dequant": "spine world-2 trainer (device codec int8)"}

    summary = []
    for name, (replaces, tpu_kernel) in KERNELS.items():
        ms, plain, (bound_ms, bound_by), lib, lib_call = timing[name]
        summary.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": res["launches"][name],
            "max_abs_err": max(max(e["max_abs_err"][name].values())
                               for e in errors.values()),
            "held_err": max(max(e["held_err"][name].values())
                            for e in errors.values()),
            "ms": ms["device_ms"], "wall_ms": ms["wall_ms"],
            "plain_ms": plain["device_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib["device_ms"],
            "library_call": lib_call, "tpu_kernel": tpu_kernel,
            "ptxas": {k: v for k, v in ptxas.items()
                      if k.startswith(KERNEL_SYMBOL[name])},
            "launch_path": "world-1 trainer",
            "launches_spine_world1": spine1["plain"]["launches"][name],
            "launches_cnn": cnn["resnet50"]["tpu_kernel_launches"][name],
            "launches_bert": bert["tpu_kernel_launches"][name],
            "launches_spine_world2": trainer[name],
            "launches_spine_extras_world1":
                observed["on"][-1]["launches"][name],
            "launches_world2_ef_trainer": ef["launches"][name]})
    for name, (replaces, tpu_kernel) in CODEC_KERNELS.items():
        ms, plain, (bound_ms, bound_by), lib = codec_timing[name]
        summary.append({
            "name": name, "route": "cuda", "source": CODEC_SOURCE,
            "replaces": replaces, "launches": codec_launches[name],
            "launch_path": codec_path[name],
            "max_abs_err": codec["max_abs_err"][name], "bitwise": True,
            "ms": ms["device_ms"], "wall_ms": ms["wall_ms"],
            "plain_ms": plain["device_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None if lib is None else lib["device_ms"],
            "library_call": CODEC_LIBRARY[name], "tpu_kernel": tpu_kernel,
            "launches_world2_ef_trainer": ef["launches"][name],
            "launches_cnn": cnn["resnet50"]["tpu_kernel_launches"][name],
            "launches_bert": bert["tpu_kernel_launches"][name],
            "launches_world2_collectives":
                rank0["collectives"]["launches"][name],
            "launches_spine_extras_a2a_rs":
                extras0["collectives"]["launches"][name]})
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
