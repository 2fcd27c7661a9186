"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--seed N] [--stop-after kernels]

Phases (any failure exits non-zero; there is no CPU fallback):

1. Card: prints ``nvidia-smi --query-gpu=name,power.limit`` and builds the
   hand-written kernels from ``horovod_tpu_torch/csrc`` (one nvcc per
   source, started together, into ``horovod_tpu_torch/_build/``); prints
   nvcc's report and each flash kernel's registers and spill bytes.
2. Kernels: each flash kernel (K4 forward, K5 dQ, K6 dK/dV) against its
   plain PyTorch version, computed in fp32 from the same bf16 inputs, at the
   slice's shape (B 8, S 1024, H 12, D 64, causal; q, k and v are views of
   one fused [B, S, 3, H, D] tensor, as the model's qkv projection gives
   them), at a ragged one (S 1000, D 128, non-causal, contiguous) and at a
   ragged causal one (S 1000, D 64, fused views: the last tile of 128 rows
   is cut short inside each batch).  At the slice's shape it times the
   kernel, the plain version and, as yardsticks the port never calls,
   PyTorch's SDPA forward and backward (dq, dk and dv in one call, beside
   the port's whole backward: the delta pass, K5 and K6).  Every time is
   device time: the profiler's sum over the kernels that one call launches
   (``kernel_ms``, ``library_ms``), with the wall time by CUDA events beside
   it (``*_wall_ms``), which for a short kernel is mostly the host's cost
   of the call.  ``--stop-after kernels`` ends the run here.
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

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
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
# and 2.4e-3 to 2.9e-3 (dq, dk, dv) at both shapes, lse 1e-6.
TILE = 64
TOL = {"out": 1e-2,     # bf16 output and P rounding
       "lse": 1e-4,     # absolute; fp32 on both sides, only summation order
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


def device_kernels_ms(prof) -> dict:
    """Device time by kernel name (ms) from a torch.profiler trace: device
    events, less the record_function ranges mirrored onto the device
    timeline (they span kernels already counted)."""
    per_kernel = {}
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            ms = evt.time_range.elapsed_us() / 1e3
            per_kernel[evt.name] = per_kernel.get(evt.name, 0.0) + ms
    return per_kernel


def timed(fn, iters: int = 20, warmup: int = 3) -> dict:
    """``device_ms``: the device time of the kernels one call of ``fn``
    launches, summed from a torch.profiler trace over ``iters`` calls;
    ``wall_ms``: the same calls by CUDA events (host cost included)."""
    from torch.profiler import ProfilerActivity, profile

    wall = cuda_ms(fn, iters, warmup)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_kernel = device_kernels_ms(prof)
    if not per_kernel:
        raise AssertionError("torch.profiler recorded no device time")
    return {"device_ms": sum(per_kernel.values()) / iters, "wall_ms": wall}


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
    # Backward on shared inputs: lse from the plain forward, delta with an
    # lse cotangent folded in (the dlse path of the autograd function).
    dlse = 0.1 * randn(b, h, s)
    delta = ((do32 * r_out).sum(-1).permute(0, 2, 1) - dlse).contiguous()
    r_lse = r_lse.contiguous()
    dq = fa.flash_bwd_dq_cuda(q, k, v, dout, r_lse, delta, scale, causal)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, dout, r_lse, delta, scale,
                                   causal)
    r_dq = fa.flash_bwd_dq_reference(q32, k32, v32, do32, r_lse, delta,
                                     scale, causal, blk)
    r_dk, r_dv = fa.flash_bwd_dkv_reference(q32, k32, v32, do32, r_lse,
                                            delta, scale, causal, blk)
    torch.cuda.synchronize()
    pairs = {"flash_fwd": {"out": (out, r_out)},
             "flash_bwd_dq": {"dq": (dq, r_dq)},
             "flash_bwd_dkv": {"dk": (dk, r_dk), "dv": (dv, r_dv)}}
    # held: the error each limit in TOL applies to (tile-relative; lse max
    # abs); max_abs: the largest absolute difference, for the record.
    max_abs, held = {}, {}
    for name, outs in pairs.items():
        max_abs[name] = {o: (g.float() - r).abs().max().item()
                         for o, (g, r) in outs.items()}
        held[name] = {o: tile_rel_err(g, r) for o, (g, r) in outs.items()}
    max_abs["flash_fwd"]["lse"] = held["flash_fwd"]["lse"] = \
        (lse - r_lse).abs().max().item()
    for name, per in held.items():
        for out_name, err in per.items():
            tol = TOL.get(out_name, TOL["grad"])
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
             lambda: fa.flash_bwd_dq_cuda(q, k, v, dout, r_lse, delta,
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
                q32, k32, v32, do32, r_lse, delta, scale, causal, blk),
                iters=3),
            bound(b, s, h, d, causal, 3, 5 * elt + 2 * stat)),
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
    # whole backward through autograd (the delta pass, K5 and K6).
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
                "port_backward_parts": "delta pass, K5, K6",
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

    hvd.init()
    try:
        if hvd.backend() != "nccl" or hvd.device().type != "cuda":
            raise AssertionError(f"init chose {hvd.backend()} on "
                                 f"{hvd.device()}")
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
    per_kernel = device_kernels_ms(prof)
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
    hvd.init(device="cuda:0")
    rep = {"rank": rank, "backend": hvd.backend(), "device": str(hvd.device())}
    try:
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
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc each, at once
        builds = dict(zip(sources, pool.map(_build.build, sources)))
    print(json.dumps({"phase": "build", "seconds":
                      round(time.perf_counter() - t0, 3)}), flush=True)
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
                          "card": card}), flush=True)
    print(json.dumps({"phase": "backward", "shape": "slice", "card": card,
                      **backward}), flush=True)
    if args.stop_after == "kernels":
        return 0

    codec, codec_timing = codec_phase(qz, args.seed)
    print(json.dumps({"phase": "codec_kernels", **codec}), flush=True)
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

    ref = reference_phase(args.seed)
    print(json.dumps({"phase": "reference", "flash_vs_dense": ref}),
          flush=True)

    res = slice_phase(hvd, fa, args.seed)
    print(json.dumps({"phase": "slice", "model": "GPT_SMALL",
                      "batch": 8, "seq": 1024, "card": card, **res}),
          flush=True)

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
    rank0, rank1 = world2_phase(args.seed, gpu_operations)
    for rep in (rank0, rank1):
        print(json.dumps({"phase": "world2", "model": "GPT_SMALL",
                          "batch_per_rank": 4, "seq": 1024,
                          "note": "two ranks share one card: step times "
                                  "are not a speed result",
                          "card": card, **rep}), flush=True)
    ef = rank0["ef_trainer"]
    codec_launches = {"quant_int8": ef["launches"]["quant_int8"],
                      "quant_int4": rank0["collectives"]["launches"][
                          "quant_int4"],
                      "dequant": ef["launches"]["dequant"]}
    codec_path = {"quant_int8": "world-2 EF trainer",
                  "quant_int4": "world-2 collectives (int4 cases)",
                  "dequant": "world-2 EF trainer"}

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
            "library_call": CODEC_LIBRARY[name], "tpu_kernel": tpu_kernel})
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
