"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; there is no CPU fallback):

1. Card: prints ``nvidia-smi --query-gpu=name,power.limit`` and builds the
   hand-written kernels from ``horovod_tpu_torch/csrc`` (nvcc, into
   ``horovod_tpu_torch/_build/``).
2. Kernels: each flash kernel (K4 forward, K5 dQ, K6 dK/dV) against its
   plain PyTorch version, computed in fp32 from the same bf16 inputs, at the
   slice's shape (B 8, S 1024, H 12, D 64, causal; q, k and v are views of
   one fused [B, S, 3, H, D] tensor, as the model's qkv projection gives
   them) and at a ragged one (S 1000, D 128, non-causal, contiguous); times
   the kernel, the plain version and, as a yardstick the port never calls,
   PyTorch's SDPA.
3. Reference: a smoke check of the whole model -- a 2-layer GPT at
   GPT-2-small width, flash path against the dense-attention path of the
   same model on the card (logits, loss, a gradient).
4. Slice: the trainer a user writes — ``hvd.init()`` (NCCL, world 1),
   ``GPT(GPT_SMALL)`` from a seed, ``hvd.broadcast_parameters``,
   ``hvd.DistributedOptimizer(AdamW)``, steps on one fixed batch of 8 x 1024
   tokens with the loss averaged by ``hvd.allreduce``.  The kernels' launch
   counts are zeroed just before and read just after: each must rise by
   exactly 12 (one per layer) per step.

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

KERNELS = {
    "flash_fwd": ("horovod_tpu/ops/flash_attention.py:74", "_mha_kernel"),
    "flash_bwd_dq": ("horovod_tpu/ops/flash_attention.py:170",
                     "_mha_bwd_dq_kernel"),
    "flash_bwd_dkv": ("horovod_tpu/ops/flash_attention.py:220",
                      "_mha_bwd_dkv_kernel"),
}
SOURCE = "horovod_tpu_torch/csrc/flash_attention.cu"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events after warm-up."""
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


def kernel_phase(fa, shape, causal, seed, timed, fused_qkv):
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
    if not timed:
        return errs, None
    elt = b * s * h * d * 2  # one bf16 [B, S, H, D] tensor
    stat = b * h * s * 4     # one fp32 [B, H, S] row statistic
    times = {
        "flash_fwd": (
            cuda_ms(lambda: fa.flash_fwd_cuda(q, k, v, scale, causal)),
            cuda_ms(lambda: fa.flash_fwd_reference(q32, k32, v32, scale,
                                                   causal, blk), iters=5),
            bound(b, s, h, d, causal, 2, 4 * elt + stat)),
        "flash_bwd_dq": (
            cuda_ms(lambda: fa.flash_bwd_dq_cuda(q, k, v, dout, r_lse, delta,
                                                 scale, causal)),
            cuda_ms(lambda: fa.flash_bwd_dq_reference(
                q32, k32, v32, do32, r_lse, delta, scale, causal, blk),
                iters=5),
            bound(b, s, h, d, causal, 3, 5 * elt + 2 * stat)),
        "flash_bwd_dkv": (
            cuda_ms(lambda: fa.flash_bwd_dkv_cuda(q, k, v, dout, r_lse,
                                                  delta, scale, causal)),
            cuda_ms(lambda: fa.flash_bwd_dkv_reference(
                q32, k32, v32, do32, r_lse, delta, scale, causal, blk),
                iters=5),
            bound(b, s, h, d, causal, 4, 6 * elt + 2 * stat)),
    }
    # Yardstick only: PyTorch's SDPA on the same inputs ([B, H, S, D]).
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal))
    ql, kl, vl = (x.detach().clone().requires_grad_() for x in (qt, kt, vt))
    o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
    dot = dout.transpose(1, 2)
    # Its backward alone (the graph is kept): dq, dk and dv in one call.
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(
        o, (ql, kl, vl), dot, retain_graph=True))
    library = {"flash_fwd": (sdpa_fwd, "sdpa forward"),
               "flash_bwd_dq": (sdpa_bwd, "sdpa backward (dq, dk, dv)"),
               "flash_bwd_dkv": (sdpa_bwd, "sdpa backward (dq, dk, dv)")}
    return errs, {n: (*times[n], *library[n]) for n in times}


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
    per_kernel = {}
    for evt in prof.events():
        # Device events, less the record_function ranges mirrored onto the
        # device timeline (they span kernels already counted).
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            ms = evt.time_range.elapsed_us() / 1e3
            per_kernel[evt.name] = per_kernel.get(evt.name, 0.0) + ms
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
    return {"profiled_wall_ms": wall_ms, "device_ms": busy,
            "by_category_ms": cats,
            "top_kernels_ms": [[n[:80], ms] for n, ms in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, inputs and token ids")
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

    t0 = time.perf_counter()
    _, report = _build.build("flash_attention")
    print(json.dumps({"phase": "build", "seconds":
                      round(time.perf_counter() - t0, 3)}), flush=True)
    if report:
        print(f"nvcc flash_attention.cu:\n{report.strip()}", flush=True)

    shapes = {"slice": ((8, 1024, 12, 64), True),
              "ragged": ((2, 1000, 4, 128), False)}
    errors, timing = {}, None
    for label, (shape, causal) in shapes.items():
        errs, tm = kernel_phase(fa, shape, causal, args.seed,
                                timed=label == "slice",
                                fused_qkv=label == "slice")
        errors[label] = errs
        if tm is not None:
            timing = tm
        print(json.dumps({"phase": "kernels", "shape": label,
                          "bshd": shape, "causal": causal,
                          "fused_qkv_views": label == "slice", "tol": TOL,
                          **errs}), flush=True)
    for name, (ms, plain_ms, (bound_ms, bound_by), lib_ms, lib_call) \
            in timing.items():
        print(json.dumps({"kernel": name, "shape": "slice",
                          "max_abs_err": errors["slice"]["max_abs_err"][name],
                          "held_err": errors["slice"]["held_err"][name],
                          "kernel_ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "library_call": lib_call,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "card": card}), flush=True)

    ref = reference_phase(args.seed)
    print(json.dumps({"phase": "reference", "flash_vs_dense": ref}),
          flush=True)

    res = slice_phase(hvd, fa, args.seed)
    print(json.dumps({"phase": "slice", "model": "GPT_SMALL",
                      "batch": 8, "seq": 1024, "card": card, **res}),
          flush=True)

    summary = []
    for name, (replaces, tpu_kernel) in KERNELS.items():
        ms, plain_ms, (bound_ms, bound_by), lib_ms, lib_call = timing[name]
        summary.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": res["launches"][name],
            "max_abs_err": max(max(e["max_abs_err"][name].values())
                               for e in errors.values()),
            "held_err": max(max(e["held_err"][name].values())
                            for e in errors.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
            "library_call": lib_call, "tpu_kernel": tpu_kernel})
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
