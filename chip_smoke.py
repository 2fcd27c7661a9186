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

12. The parallel layers (``parallel``), two ranks on ``cuda:0`` as in 6.
   (a) The sequence-parallel trainer of
   ``horovod_tpu_torch.examples.gpt_long_context``: GPT_SMALL with
   ``sp_use_flash``, a ``{"dp": 1, "sp": 2}`` mesh, 2 x 2048 tokens (1024
   a rank), ``broadcast_parameters`` and ``DistributedOptimizer(AdamW)``,
   3 steps: K4, K5 and K6 launched once a layer on rank 0 (the diagonal
   hop; its other hop is in the future) and twice on rank 1, exactly, each
   step; every K5 launch fed the ring merge's lse cotangent, non-zero on
   rank 1 (rank 0's diagonal merges only with a future chunk, so its
   output does not depend on lse and the cotangent is exactly 0);
   the averaged loss falling and the parameters bitwise equal across the
   ranks after every step; the first step's averaged gradients of three
   leaves held against a one-process replay of the whole sequences with
   dense attention (``PAR_GRAD_TOL``).  (b) ``examples.bert_pretraining
   --large --seq-parallel --sp-flash`` at BERT-Large's width, its depth
   cut to 3 layers, 2 x 2048 tokens, 2 steps: non-causal hops, 2 launches
   a layer on each rank, parameters bitwise equal across ranks.  (c)
   Ulysses, ``tp_mlp``, ``vocab_parallel_embedding``, ``gpipe`` and
   ``switch_moe`` on card tensors at axis size 2, each output and one
   gradient against its dense one-process version (``LAYER_TOL``), with
   no K1-K6 launch.

13. Elastic training (``elastic``) through the port's own launcher:
   ``python -m horovod_tpu_torch.runner.launch --min-np 2 -np 2 -H
   localhost:2 --verbose python <worker>``, the worker written to a temp
   directory (``elastic_worker``): two ranks on ``cuda:0`` as in 6, each
   a GPT at ``GPT_SMALL``'s full width and 4 of its 12 blocks
   (``ELASTIC_LAYERS``) from the seed, 4 x 1024 tokens a rank a step from
   a seeded token set through ``ElasticSampler``,
   ``DistributedOptimizer(AdamW(3e-4))`` in a ``TorchState`` under
   ``@hvd.elastic.run``, ``state.commit()`` after each of 2 steps (each
   commit replicates the 1.28 GB state to the ring successor, as the
   defaults say).  Rank 1 SIGKILLs itself after the forward of step 1;
   the driver must form exactly two generations of size 2, the survivor
   must restore the last commit, both ranks resume by migration (neither
   cold nor fallback), the respawned rank adopting the committed record's
   digest; K4-K6 launch 4 a step on each rank in both generations, the
   losses stay finite, the final parameters are bitwise equal across
   ranks and within ``ELASTIC_PARAM_TOL`` of an uninterrupted run of the
   same worker (the two jobs run at once), and a ``ShardedCheckpointer`` round trip of the
   full-width state is bitwise.  Prints each replication's seconds and
   bytes, the seconds from the kill to generation 1's resume and first
   step, peak device memory per rank and the checkpoint's bytes and
   seconds.

14. Fleet operations (``fleet``) through the port's launcher:
   ``-np 3 --min-np 2 -H 127.0.0.1:2,localhost:1 --autopilot --cockpit
   --fault-inject coordinator-recv:*:2:delay:400``, three ranks on
   ``cuda:0`` over gloo (``fleet_worker``): ``GPT(GPT_SMALL)`` at full
   width, ``DistributedOptimizer(AdamW)`` in a ``TorchState``, 4 x 1024
   tokens a rank a step from ``hvd.data.ShardedDataset`` through
   ``hvd.data.prefetch_to_device``, the rate from
   ``hvd.callbacks.warmup_schedule`` at each step and world size, the loss
   averaged by ``MetricAverageCallback``, a commit a step without
   replication.  Rank 2, alone on "localhost", lags every negotiation
   cycle; the autopilot must evict its host, the fleet re-form at 2, and
   re-form at 3 when the blacklist expires.  A ``CockpitWatch`` reads
   rank 0's cockpit from outside in every generation (one sticky port;
   ``/state`` naming rank 2 as the straggler, step rows tagged eager,
   ``/metrics``' ``hvd_*`` families, ``/history``, ``tools/hvd_top.py
   --once``, and an ``/events`` stream that must carry step summaries and
   the eviction).  The journal, the flight dump, K4-K6 12 a step a rank
   (K1-K3 none), batches on the card and complete epochs of
   ``len(ShardedDataset)`` batches, finite losses and final parameters
   bitwise equal across the last generation's ranks are checked; the
   steps, the commits, the times from the first flagged window to the
   eviction, from the eviction to the first step at world 2 and from the
   sentence's expiry to the first step at world 3, and peak device memory
   are printed.

15. The cluster integrations (``integrations``).  (a) The slice's main
   path: ``TorchEstimator(backend="local")`` at world 1 over NCCL fits
   ``GPT(GPT_SMALL)`` from the seed on 16 seeded sequences of 1,024 token
   ids (targets shifted by one; ``feature_dtype=None``, an LM cross
   entropy, ``AdamW(3e-4)`` from ``model.parameters()``, batch 8, one
   epoch: 2 steps) with a ``LocalStore`` in a temporary directory: K4-K6
   12 a step, K1-K3 none (counted between the loss calls), finite losses,
   the fitted state bitwise equal to the same two steps written directly
   with ``DistributedOptimizer(AdamW)``, ``TorchModel.load`` from the
   Store bitwise, ``predict`` on one sequence equal to the forward.  (b)
   ``TorchEstimator(backend="spark", num_proc=2, device="cuda:0")``
   through a barrier-mode fake pyspark of spawned processes (the task and
   the worker travel by stdlib pickle where there is no cloudpickle):
   GPT_SMALL, 8 sequences a rank in batches of 4, K4-K6 12 a step a rank,
   both ranks' states bitwise equal, the driver's model rank 0's state;
   then ``spark.run`` of a task that prefetches a ``ShardedDataset`` of
   card tensors through ``hvd.data.prefetch_to_device``: every batch on
   the card, equal to the dataset's.  (c) ``RayExecutor(num_workers=2)``
   through a fake ray of spawned actors: ``ef_trainer`` at GPT_SMALL's
   width and 2 blocks, 2 steps on the int8 ring (K1 33 and K3 44 a step,
   K4-K6 2), results in rank order, parameters bitwise equal.  (d)
   ``ElasticRayExecutor(min_np=2, max_np=2)`` over ``localhost:2``: 2
   plain steps of the same model through ``runner._exec_fn``, equal
   digests and losses, K4-K6 2 a step a rank.  World-2 parts run two ranks
   on ``cuda:0`` over gloo; their times are not a speed result.  The phase
   runs in a spawned process of its own (``IntegrationsRun``), started
   with the compiled plane's ranks (16) and beside them and the world-2
   phases (6, 7, 10, 11 and 12); its lines print after the parallel
   phase's.

16. The compiler data plane (``compiled_plane``).  (a) World 1 over NCCL:
   ``DistributedOptimizer(plane="gspmd")`` counts ``demote_world1`` and
   trains ``GPT(GPT_SMALL)`` 2 steps bitwise as ``plane="eager"`` does.
   (b) Two ranks on ``cuda:0`` over gloo (``plane_rank``): a GPT at
   ``GPT_SMALL``'s full width and 4 of its 12 blocks (``PLANE_LAYERS``)
   from the seed, its parameters replicated DTensors (``distribute_module``
   on ``gspmd_plane.build_gspmd_mesh()``, a ``DeviceMesh`` over the gloo
   group on ``cuda``), 8 x 1024 tokens a step as ``Shard(0)``,
   ``DistributedOptimizer(AdamW(3e-4, fused), plane="gspmd")``, and 3
   steps of ``hlo_inspect.instrument(step)`` over Inductor, ``step``
   holding the forward, ``lm_loss``, the backward and ``opt.step()``: K4-K6
   4 a step a rank inside the compiled step (K1-K3 none), one inventory
   a rank of all-reduces only, its raw bytes the fp32 parameters' and its
   wire bytes the ring model's at g = 2, ``data_plane_stats()``'s
   ``gspmd_raw`` / ``gspmd_wire`` equal to it, ``plane_counters() ==
   {"gspmd": 1}``, every step-trace record tagged plane 1; then the same
   steps on the eager plane (plain tensors, the hooks, each rank its 4
   sequences): the first loss within ``PLANE_LOSS_RTOL`` and the
   parameters within ``PLANE_UPDATE_RTOL`` of the compiled run's, which
   must be bitwise equal across ranks.  Prints the
   compile and step seconds, the compile's seconds by stage, peak device
   memory a rank and the profiled last step's device time by category.
   The two ranks start before the world-2 phases (6 on) and run beside
   them and the elastic phase (13): their compile is host work of
   minutes.  ``chip_plane_faults.py``
   runs the phase's ranks alone and with planted faults.  After its steps
   rank 0 saves the compiled step's graph code
   (``hlo_inspect.write_graphs``) and its ``hvd.metrics()`` dump, and
   ``python -m horovod_tpu_torch.tools.hlo_report <graphs> --metrics``
   must exit 0 with totals equal to the phase's inventory and to
   ``data_plane_stats()``'s gspmd bytes.
17. Eager example: ``horovod_tpu_torch.examples.eager_device_plane`` at
   world 1 on the card (NCCL): the reference's MLP, 10 SGD steps whose
   gradients the hooks send through the device plane; its stats must
   show the plane served them (allreduce + identity > 0, no host
   fallback) and the parameters stay on the card, finite.
18. Matrix: ``python -m horovod_tpu_torch.tools.test_matrix --quick
   --card --device cuda``, the quick rows whose tensors reach the card:
   world 1 on NCCL, a world-3 row over gloo, the qdev rows (int8 and
   int4 on the bidi schedule, 4 ranks, the device plane's quantized ring
   on K1-K3), the dplane row (``HOROVOD_DATA_PLANE=gspmd``, a step
   compiled by Inductor) and the hloinspect row.  Every row must pass;
   each qdev rank's K1-K3 launches in its one quantized allreduce must
   be ``expected_launches`` at world 4.  Prints one line a row with its
   seconds.  The rows run beside the elastic phase (13), whose lines
   print first.
19. Benchmark tools (``bench_tools``).  (a) The microbenchmark
   (``python -m horovod_tpu_torch.examples.microbenchmark``'s ``main``)
   ``--plane eager --mb 16 --iters 20`` at world 1 over NCCL in this
   process, after the eager example: every call an identity on the device
   plane (no host fallback), every output on the card and exact.  (b) The
   microbenchmark ``--plane eager`` and ``--plane jit`` through the port's
   launcher at ``-np 2``, both ranks on ``cuda:0`` over gloo with
   ``TORCHINDUCTOR_COMPILE_THREADS=1``: rank 0's line an op in the
   reference's format.  (c) ``python -m horovod_tpu_torch.tools.
   bench_negotiation --np 4 --steps 60 --tensors 50 --device-codec int8
   --device-schedule bidi``, four ranks on ``cuda:0`` over gloo: the
   cache's announce ratio under 0.5, the device codec's baseline untouched,
   each rank's K1 8 and K3 14 in its one quantized allreduce
   (``expected_launches`` at world 4), the encoded-to-raw ratio 0.254 and
   the error inside the ring's bound.  (a) and (c) run after the eager
   example with nothing beside them: the cache's announce bytes a step
   grow with the step's idle negotiation cycles (16 bytes each), which a
   loaded host multiplies.  (b) runs beside the fleet phase (14).  The
   world-2 and world-4 times are not a speed result.

Phase 19 runs after 17, before 8.  Each phase prints its seconds.  The
line before the last is
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
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


def ef_leaves(layers: int) -> int:
    """GPT_SMALL-width weights of at least 64 KiB at ``layers`` blocks,
    those error feedback quantizes: four matrices a block (qkv, out,
    mlp_in, mlp_out), wte, wpe and lm_head."""
    return 4 * layers + 3


EF_LEAVES = ef_leaves(12)  # 51


def ef_launches_per_step(layers: int) -> dict:
    """Kernel launches a step of ``ef_trainer`` makes on a rank at world
    2: for each quantized leaf the ring's two encodes and three decodes
    (``expected_launches``) and the residual's ``fake_quantize``, one of
    each; K4-K6 once a block."""
    leaves = ef_leaves(layers)
    return {"quant_int8": 3 * leaves, "quant_int4": 0,
            "dequant": 4 * leaves, "flash_fwd": layers,
            "flash_bwd_dq": layers, "flash_bwd_dkv": layers}


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
               batch=4, seq=1024, layers=None, steps=EF_STEPS):
    """The slice's main path: GPT-2 small through
    DistributedOptimizer(AdamW, device_compression="int8") at world 2
    (``layers`` cuts its depth, ``steps`` its length)."""
    import dataclasses

    cfg = (GPT_SMALL if layers is None
           else dataclasses.replace(GPT_SMALL, num_layers=layers))
    leaves = ef_leaves(cfg.num_layers)
    dev = hvd.device()
    torch.manual_seed(seed)
    model = GPT(cfg).to(dev)
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
    if len(eligible) != leaves:
        raise AssertionError(f"{len(eligible)} eligible leaves, expected "
                             f"{leaves}")
    watch = ("wte.weight", "h.0.attn.qkv.weight", "lm_head.weight")
    per_step = ef_launches_per_step(cfg.num_layers)
    losses, step_ms, leaf_ok = [], [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    qz.reset_launch_counts()
    fa.reset_launch_counts()
    qz.reset_device_byte_counters()
    for step in range(steps):
        before = {**qz.LAUNCHES, **fa.LAUNCHES}
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = lm_loss(model(ids), ids)
        loss.backward()
        last = step == steps - 1
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
        want_bytes[0] += steps * r
        want_bytes[1] += steps * e
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


class RankPair:
    """``target(rank, port, *args, queue)`` in two spawned processes,
    started at once; :meth:`collect` waits for their reports."""

    def __init__(self, target, args):
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        ctx = torch.multiprocessing.get_context("spawn")
        self.name = target.__name__
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=target,
                                  args=(r, port, *args, self.results))
                      for r in range(2)]
        for p in self.procs:
            p.start()

    def kill(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)

    def collect(self, timeout_s):
        """The ranks' reports by rank and their exit codes; every process
        is joined or killed."""
        import queue as queue_mod

        reports = {}
        try:
            for _ in self.procs:
                rep = self.results.get(timeout=timeout_s)
                reports[rep["rank"]] = rep
        except queue_mod.Empty:
            raise AssertionError(f"{self.name}: a rank sent no report in "
                                 f"{timeout_s} s")
        finally:
            for p in self.procs:
                p.join(60)
            self.kill()
        return reports, [p.exitcode for p in self.procs]


def spawn_pair(target, args, timeout_s):
    """Run ``target(rank, port, *args, queue)`` in two spawned processes;
    returns their reports by rank.  Every process is joined or killed."""
    return RankPair(target, args).collect(timeout_s)


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


# ---------------------------------------------------------------------------
# The parallel layers: GPT-2 small and BERT-Large sequence-parallel on the
# flash kernels at every ring hop, and the tensor, pipeline and expert
# parallel layers, two ranks on the one card.
# ---------------------------------------------------------------------------

PAR_STEPS = 3
PAR_BATCH = 2           # sequences of the GPT trainer's batch
PAR_SEQ = 2048          # tokens a sequence: 1024 a rank at sp = 2
PAR_LEAVES = ("h.0.attn.qkv.weight", "h.11.mlp_in.weight", "wpe.weight")
# The trainer's first averaged gradients against a one-process replay of
# the whole 2048-token sequences with dense attention, held by
# ||ring - replay|| / ||replay|| per leaf: bf16 activations rounded in other
# places through 12 layers (the 2-layer flash-vs-dense check measured
# 4.6e-3 on the layer-0 qkv gradient); the loss by its absolute difference.
PAR_GRAD_TOL = 3e-2
PAR_LOSS_TOL = 1e-2
BERT_SP_LAYERS = 3      # BERT-Large's width, its depth cut to fit the phase
BERT_SP_BATCH = 2
BERT_SP_SEQ = 2048
BERT_SP_STEPS = 2
# (c): each layer and one gradient against its dense one-process version,
# fp32 on both sides with TF32 off; sums in other orders only.  Held by
# ||parallel - dense|| / ||dense||.
LAYER_TOL = 1e-4


def ring_launches(rank: int, world: int, layers: int, causal: bool) -> int:
    """Launches of each flash kernel (K4, K5, K6) in one train step on
    ``rank`` of a ring of ``world``: one per layer for every hop whose chunk
    is not in the future (the diagonal and the ``rank`` chunks before it
    when causal, all ``world`` otherwise)."""
    return layers * (rank + 1 if causal else world)


def split_loss(lm_loss, logits, ids, sp: int):
    """The mean over ``sp`` sequence shards of each shard's own LM loss,
    from logits of the whole sequences: the loss the sequence-parallel
    trainer's ranks average, each shift staying inside its shard."""
    s = ids.shape[1] // sp
    return sum(lm_loss(logits[:, i * s:(i + 1) * s], ids[:, i * s:(i + 1) * s])
               for i in range(sp)) / sp


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).norm() /
            want.float().norm().clamp_min(1e-30)).item()


def parallel_rank(rank, port, seed, gpu_operations, tmpdir, queue):
    """One of two ranks on ``cuda:0``: the sequence-parallel GPT and BERT
    trainers, then the other layers; puts its report on ``queue``."""
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
        queue.put(parallel_work(rank, seed, tmpdir))
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


class _Watch:
    """K5's lse cotangents and the seconds of gloo staging, seen by wrappers
    around ``flash_bwd_dq_cuda``, the mesh's ``_send_recv`` (the ring's K/V
    exchanges: ``exchange_s``) and the device plane's ``plain_allreduce``
    (the gradients' and the loss's allreduces on the executor's thread:
    ``allreduce_s``); the counting stays the kernel wrapper's.
    ``sync_wait_s`` is the caller's wait in the optimizer's synchronize
    after backward, the part of ``allreduce_s`` that backward did not
    hide."""

    def __init__(self, fa, pcol, dp):
        self.fa, self.pcol, self.dp = fa, pcol, dp
        self.dq, self.send_recv = fa.flash_bwd_dq_cuda, pcol._send_recv
        self.allreduce = dp.plain_allreduce
        self.reset()

    def timed(self, fn, key):
        def call(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                setattr(self, key, getattr(self, key)
                        + time.perf_counter() - t0)
        return call

    def __enter__(self):
        def dq(q, k, v, dout, out, lse, dlse, *args):
            self.dlse.append(None if dlse is None
                             else dlse.abs().max().item())
            return self.dq(q, k, v, dout, out, lse, dlse, *args)

        self.fa.flash_bwd_dq_cuda = dq
        self.pcol._send_recv = self.timed(self.send_recv, "exchange_s")
        self.dp.plain_allreduce = self.timed(self.allreduce, "allreduce_s")
        return self

    def __exit__(self, *exc):
        self.fa.flash_bwd_dq_cuda = self.dq
        self.pcol._send_recv = self.send_recv
        self.dp.plain_allreduce = self.allreduce

    def reset(self):
        self.dlse = []
        self.exchange_s = self.allreduce_s = self.sync_wait_s = 0.0


def sp_trainer_steps(hvd, fa, qz, watch, trainer, steps, want, merged,
                     what):
    """``steps`` steps of a sequence-parallel trainer's closure, each with
    its flash launches held to ``want`` a kernel (K1-K3 to none), K5 fed
    the merge's lse cotangent at every launch, and the parameters' digest.
    A rank that merges ``merged`` > 1 chunks a row must feed K5 a non-zero
    one; with one chunk (rank 0 of a causal ring: its other hop is in the
    future) out does not depend on lse and the cotangent is exactly 0."""
    model, opt = trainer["model"], trainer["optimizer"]
    opt.synchronize = watch.timed(opt.synchronize, "sync_wait_s")
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    qz.reset_launch_counts()
    out = []
    for i in range(steps):
        before = kernel_launches(fa, qz)
        watch.reset()
        t0 = time.perf_counter()
        loss = hvd.allreduce(trainer["step"]().detach(),
                             name=f"{what}.loss").item()
        ms = (time.perf_counter() - t0) * 1e3
        rose = {n: c - before[n] for n, c in kernel_launches(fa, qz).items()}
        expected = {n: want if n in fa.LAUNCHES else 0 for n in rose}
        if rose != expected:
            raise AssertionError(f"{what} step {i}: launches {rose}, "
                                 f"expected {expected}")
        if len(watch.dlse) != want or None in watch.dlse or \
                (merged > 1) != (max(watch.dlse) > 0):
            raise AssertionError(f"{what} step {i}: K5's lse cotangents "
                                 f"{watch.dlse} ({merged} chunks merged)")
        out.append({"loss": loss, "step_ms": ms,
                    "ring_exchange_s": watch.exchange_s,
                    "allreduce_s": watch.allreduce_s,
                    "sync_wait_s": watch.sync_wait_s,
                    "max_abs_dlse": max(watch.dlse), "launches": rose,
                    "params_digest": digest(torch.cat(
                        [p.detach().reshape(-1).float()
                         for p in model.parameters()]))})
        if i == 0:
            first = {n: p.grad.detach().float().cpu().clone()
                     for n, p in model.named_parameters()
                     if n in PAR_LEAVES}
    return out, first


def parallel_layers(hvd, par, fa, qz, seed, rank) -> dict:
    """(c): Ulysses, tp_mlp, vocab_parallel_embedding, gpipe and switch_moe
    on card tensors at axis size 2, each output and one gradient against
    its dense one-process version; none may launch K1-K6."""
    import torch.nn.functional as F

    dev = hvd.device()
    gen = torch.Generator().manual_seed(seed + 7)

    def randn(*shape, scale=1.0, grad=False):
        t = (torch.randn(*shape, generator=gen) * scale).to(dev)
        return t.requires_grad_(grad)

    def gelu(x):
        return F.gelu(x, approximate="tanh")

    def grad_of(loss, x):
        return torch.autograd.grad(loss, x)[0]

    half = slice(rank * 1024, (rank + 1) * 1024)
    errs = {}
    before = kernel_launches(fa, qz)
    t0 = time.perf_counter()
    with par.build_mesh({"sp": 2}):       # Ulysses: [2, 2048, 16, 64]
        q, k, v = (randn(2, 2048, 16, 64) for _ in range(3))
        c = randn(2, 2048, 16, 64)
        ql = q[:, half].clone().requires_grad_()
        out = par.ulysses_attention(ql, k[:, half], v[:, half], "sp",
                                    causal=True)
        dq = grad_of((out * c[:, half]).sum(), ql)
        qd = q.clone().requires_grad_()
        logits = torch.einsum("bqhd,bkhd->bhqk", qd, k) * 64 ** -0.5
        mask = torch.ones(2048, 2048, dtype=torch.bool, device=dev).tril()
        probs = torch.softmax(logits.masked_fill(~mask, torch.finfo(
            torch.float32).min), dim=-1)
        dense = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        errs["ulysses"] = (rel_err(out, dense[:, half]),
                           rel_err(dq, grad_of((dense * c).sum(), qd)[:, half]))
        del logits, probs, dense
    with par.build_mesh({"tp": 2}):       # GPT-2 small's MLP, 1024 tokens
        x = randn(1024, 768, grad=True)
        w_in, w_out = randn(768, 3072, scale=0.02), randn(3072, 768,
                                                           scale=0.02)
        b_in, b_out = randn(3072, scale=0.02), randn(768, scale=0.02)
        c = randn(1024, 768)
        y = par.tp_mlp(x, par.shard_kernel(w_in, "tp", 1),
                       par.shard_kernel(w_out, "tp", 0),
                       par.shard_kernel(b_in, "tp", 0), b_out, "tp")
        dx = grad_of((y * c).sum(), x)
        dense = gelu(x @ w_in + b_in) @ w_out + b_out
        errs["tp_mlp"] = (rel_err(y, dense),
                          rel_err(dx, grad_of((dense * c).sum(), x)))
        table = randn(50304, 768, grad=True)   # GPT-2 small's token table
        ids = torch.randint(0, 50304, (8, 1024), generator=gen).to(dev)
        c = randn(8, 1024, 768)
        e = par.vocab_parallel_embedding(ids, par.shard_kernel(table, "tp",
                                                               0), "tp")
        rows = slice(rank * 25152, (rank + 1) * 25152)
        dt = grad_of((e * c).sum(), table)[rows]
        dense = table[ids]
        errs["vocab_parallel_embedding"] = (
            rel_err(e, dense),
            rel_err(dt, grad_of((dense * c).sum(), table)[rows]))
    with par.build_mesh({"pp": 2}):       # two stages of gelu(a @ W)
        ws = randn(2, 768, 768, scale=0.03)
        x = randn(4, 256, 768, grad=True)
        c = randn(4, 256, 768)
        out = par.last_stage_value(par.gpipe(
            lambda w, a: gelu(a @ w), par.pipeline_stage_params(ws, "pp"), x,
            "pp"), "pp")
        dx = grad_of((out * c).sum(), x)
        dense = gelu(gelu(x @ ws[0]) @ ws[1])
        errs["gpipe"] = (rel_err(out, dense),
                         rel_err(dx, grad_of((dense * c).sum(), x)))
    with par.build_mesh({"ep": 2}):       # 2 experts, no token dropped
        x_all = randn(2048, 768, grad=True)
        router = randn(768, 2, scale=0.05)
        w_in, w_out = randn(2, 768, 3072, scale=0.02), randn(
            2, 3072, 768, scale=0.02)
        c = randn(2048, 768)
        out = par.switch_moe(
            x_all[half], router, par.moe_ffn(
                par.pipeline_stage_params(w_in, "ep"),
                par.pipeline_stage_params(w_out, "ep")), "ep",
            capacity_factor=2.0)
        dx = grad_of((out * c[half]).sum(), x_all)[half]
        # Routed block by block, as each rank routed its own tokens.
        gates = torch.cat([torch.softmax(x_all[b] @ router, dim=-1)
                           for b in (slice(0, 1024), slice(1024, 2048))])
        gate, expert = gates.max(dim=-1)
        dense = torch.stack([gelu(x_all @ w_in[i]) @ w_out[i]
                             for i in range(2)])
        dense = dense[expert, torch.arange(2048, device=dev)] * gate[:, None]
        errs["switch_moe"] = (
            rel_err(out, dense[half]),
            rel_err(dx, grad_of((dense * c).sum(), x_all)[half]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rose = {n: c - before[n] for n, c in kernel_launches(fa, qz).items()}
    if any(rose.values()):
        raise AssertionError(f"the parallel layers launched {rose}")
    for name, (e_out, e_grad) in errs.items():
        if not (e_out <= LAYER_TOL and e_grad <= LAYER_TOL):
            raise AssertionError(f"{name}: output {e_out}, gradient {e_grad} "
                                 f"from the dense version (limit "
                                 f"{LAYER_TOL})")
    return {"rel_err": {n: {"out": a, "grad": b}
                        for n, (a, b) in errs.items()},
            "tol": LAYER_TOL, "launches": rose, "seconds": seconds}


def parallel_work(rank, seed, tmpdir):
    import dataclasses

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import models, parallel as par
    from horovod_tpu_torch.examples import bert_pretraining, gpt_long_context
    from horovod_tpu_torch.ops import device_plane as dp
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import quantize as qz
    from horovod_tpu_torch.parallel import collectives as pcol

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init(device="cuda:0")  # both ranks on the one card
    rep = {"rank": rank, "backend": hvd.backend(), "device": str(hvd.device())}
    try:
        with _Watch(fa, pcol, dp) as watch:
            t = gpt_long_context.setup(
                ["--seq-len", str(PAR_SEQ), "--sp", "2", "--batch-per-dp",
                 str(PAR_BATCH), "--sp-flash", "--seed", str(seed)],
                base=models.GPT_SMALL)
            if (t["sp"], t["config"].sp_axis_name) != (2, "sp") or \
                    tuple(t["local_ids"].shape) != (PAR_BATCH, PAR_SEQ // 2):
                raise AssertionError("the GPT trainer did not shard the "
                                     "sequence over sp = 2")
            layers = t["config"].num_layers
            want = ring_launches(rank, 2, layers, causal=True)
            steps, first = sp_trainer_steps(hvd, fa, qz, watch, t, PAR_STEPS,
                                            want, rank + 1, "gpt_sp")
            check_losses("gpt sp", [s["loss"] for s in steps])
            rep["gpt"] = {"steps": steps, "launches_per_step": want}
            if rank == 0:
                torch.save(first, os.path.join(tmpdir, "grads.pt"))
            del t
            torch.cuda.empty_cache()

            base = dataclasses.replace(models.BERT_LARGE,
                                       num_layers=BERT_SP_LAYERS)
            t = bert_pretraining.setup(
                ["--large", "--seq-parallel", "--sp-flash", "--batch-per-chip",
                 str(BERT_SP_BATCH), "--seq-len", str(BERT_SP_SEQ), "--seed",
                 str(seed)], base)
            want = ring_launches(rank, 2, BERT_SP_LAYERS, causal=False)
            steps, _ = sp_trainer_steps(hvd, fa, qz, watch, t, BERT_SP_STEPS,
                                        want, 2, "bert_sp")
            check_losses("bert sp", [s["loss"] for s in steps],
                         falling=False)
            rep["bert"] = {"steps": steps, "launches_per_step": want}
            del t
            torch.cuda.empty_cache()
        rep["layers"] = parallel_layers(hvd, par, fa, qz, seed, rank)
    finally:
        hvd.shutdown()
    return rep


def parallel_replay(seed, grads, loss) -> dict:
    """The GPT trainer's first step in one process: the whole 2048-token
    sequences, dense attention, the mean of the two shards' losses."""
    import dataclasses

    from horovod_tpu_torch.examples import gpt_long_context
    from horovod_tpu_torch.models import GPT, GPT_SMALL, lm_loss

    cfg = dataclasses.replace(GPT_SMALL, max_seq_len=PAR_SEQ,
                              use_flash=False)
    torch.manual_seed(seed)
    model = GPT(cfg).cuda()
    ids = gpt_long_context.global_batch(seed, PAR_BATCH, PAR_SEQ,
                                        cfg.vocab_size).cuda()
    replay = split_loss(lm_loss, model(ids), ids, 2)
    replay.backward()
    errs = {n: rel_err(grads[n].cuda(), p.grad)
            for n, p in model.named_parameters() if n in PAR_LEAVES}
    out = {"grad_rel_err": errs, "grad_tol": PAR_GRAD_TOL,
           "loss": replay.item(), "loss_abs_err": abs(replay.item() - loss),
           "loss_tol": PAR_LOSS_TOL}
    del model
    torch.cuda.empty_cache()
    if not all(e <= PAR_GRAD_TOL for e in errs.values()):
        raise AssertionError(f"sp GPT gradients from the replay: {errs}")
    if not out["loss_abs_err"] <= PAR_LOSS_TOL:
        raise AssertionError(f"sp GPT loss {loss} against the replay's "
                             f"{replay.item()}")
    return out


def parallel_phase(seed, gpu_operations) -> dict:
    """Both ranks on cuda:0 (``parallel_rank``), then the replay of the
    GPT trainer's first gradients in this process."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmpdir:
        reports, codes = spawn_pair(parallel_rank,
                                    (seed, gpu_operations, tmpdir), 900)
        for rep in reports.values():
            if "error" in rep:
                raise AssertionError(f"parallel rank {rep['rank']} failed:\n"
                                     f"{rep['error']}")
        if codes != [0, 0]:
            raise AssertionError(f"parallel exit codes {codes}")
        grads = torch.load(os.path.join(tmpdir, "grads.pt"))
    r0, r1 = reports[0], reports[1]
    for what in ("gpt", "bert"):
        for i, (a, b) in enumerate(zip(r0[what]["steps"],
                                       r1[what]["steps"])):
            if a["params_digest"] != b["params_digest"]:
                raise AssertionError(f"{what} sp step {i}: parameters differ "
                                     "across ranks")
            if a["loss"] != b["loss"]:
                raise AssertionError(f"{what} sp step {i}: averaged losses "
                                     f"{a['loss']} and {b['loss']}")
    replay = parallel_replay(seed, grads, r0["gpt"]["steps"][0]["loss"])
    return {"ranks": [r0, r1], "replay": replay}


# The elastic phase: GPT-2 small at full width, two ranks on cuda:0 under
# the port's launcher and elastic driver, rank 1 killed once mid-step.
# Steps of the job, over both generations, and its blocks are cut to keep
# the script inside its time limit: 4 of GPT-2 small's 12 blocks cut each
# commit's replication to 106,406,400 parameters (163,109,376 at 12) and
# their AdamW moments; the embeddings and the head keep their full size.
ELASTIC_STEPS = 2
ELASTIC_KILL_STEP = 1      # rank 1 dies after this step's forward
ELASTIC_LAYERS = 4
ELASTIC_BATCH = 4          # sequences a rank a step
ELASTIC_SEQ = 1024         # tokens a sequence
ELASTIC_SEQS = 64          # the seeded synthetic token set, in sequences
ELASTIC_LR = 3e-4
# Final parameters of the killed run against the uninterrupted run, held
# bitwise: the resume adopts the committed bits, the data order is the
# same, and the kernels, cuBLAS and gloo's two-rank sum are deterministic.
# A step lost or repeated, or AdamW's moments reset on the resume, moves
# a parameter by about lr, so any looser limit would let one through.
ELASTIC_PARAM_TOL = 0.0
ELASTIC_LAUNCHER_TIMEOUT_S = 600
# The kernels whose launches the elastic workers count: K4-K6 run in every
# step, K1-K3 (no device compression on this path) in none.
ELASTIC_CATEGORIES = FLASH_CATEGORIES + tuple(CODEC_KERNELS)
ELASTIC_WORKER = """import json, os, sys
sys.path.insert(0, {repo!r})
import chip_smoke
spec = json.loads(os.environ["HVD_SMOKE_ELASTIC"])
sys.exit(chip_smoke.elastic_worker(spec))
"""


def params_digest(model) -> str:
    """sha256 over the bytes of every parameter, in name order."""
    import hashlib

    h = hashlib.sha256()
    for _, p in sorted(model.named_parameters()):
        h.update(p.detach().contiguous().cpu().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def same_tree(a, b) -> bool:
    """Bitwise equality of two nested state_dict-like structures."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu().reshape(-1).view(torch.uint8),
                                b.cpu().reshape(-1).view(torch.uint8)))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y)
                                        for x, y in zip(a, b))
    return a == b


def checkpoint_roundtrip(hvd, model, opt, step, outdir) -> dict:
    """A ShardedCheckpointer save of the model's and optimizer's whole
    state, restored and held bitwise against the live state."""
    from horovod_tpu_torch.elastic.state import _to_host

    ckpt = hvd.checkpoint.ShardedCheckpointer(os.path.join(outdir, "ckpt"))
    live = _to_host({"model": model.state_dict(),
                     "optimizer": opt.state_dict(), "step": step})
    t0 = time.perf_counter()
    ckpt.save(step, live)
    ckpt.wait_until_finished()
    save_s = time.perf_counter() - t0
    # restore() takes the newest step whose every shard exists, so it waits
    # until each rank's write has ended: otherwise rank 0 may find this
    # step incomplete and restore nothing.
    hvd.barrier()
    path = ckpt._shard_path(step, hvd.rank())
    t0 = time.perf_counter()
    restored = ckpt.restore()
    restore_s = time.perf_counter() - t0
    return {"bytes": os.path.getsize(path), "save_s": save_s,
            "restore_s": restore_s, "bitwise": same_tree(restored, live)}


def elastic_worker(spec) -> int:
    """One worker of the elastic job (launched by the port's elastic
    driver): GPT at ``GPT_SMALL``'s width and ``ELASTIC_LAYERS`` blocks on
    cuda:0, ``DistributedOptimizer(AdamW)``, an ``ElasticSampler`` over
    the seeded token set, ``state.commit()`` after every step.  Writes one
    JSON line per event to ``<outdir>/events.<pid>.jsonl``."""
    import dataclasses
    import signal

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import migrate
    from horovod_tpu_torch.models import GPT, GPT_SMALL, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import quantize as qz

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hvd.init(device="cuda:0")
    dev = hvd.device()
    torch.manual_seed(spec["seed"])
    model = GPT(dataclasses.replace(GPT_SMALL, num_layers=ELASTIC_LAYERS)) \
        .to(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=ELASTIC_LR),
        named_parameters=model.named_parameters())
    sampler = hvd.elastic.ElasticSampler(ELASTIC_SEQS, shuffle=True,
                                         seed=spec["seed"])
    state = hvd.elastic.TorchState(model=model, optimizer=opt,
                                   sampler=sampler, step=0)
    gen = torch.Generator().manual_seed(spec["seed"] + 3)
    tokens = torch.randint(0, GPT_SMALL.vocab_size, (ELASTIC_SEQS, ELASTIC_SEQ),
                           generator=gen)
    log = open(os.path.join(spec["outdir"], f"events.{os.getpid()}.jsonl"),
               "a", buffering=1)

    def emit(event, **kw):
        log.write(json.dumps({
            "event": event, "pid": os.getpid(), "time": time.time(),
            "generation": int(os.environ.get("HOROVOD_ELASTIC_GENERATION",
                                             "0")),
            "rank": hvd.rank(), "size": hvd.size(), **kw}) + "\n")

    def launched():
        return {**fa.LAUNCHES, **qz.LAUNCHES}

    fa.reset_launch_counts()
    qz.reset_launch_counts()
    flag = spec["kill_flag"]
    batch = ELASTIC_BATCH

    @hvd.elastic.run
    def train(state):
        plan, st = migrate.last_plan() or {}, migrate.store()
        emit("resume", mode=plan.get("mode"), cut=plan.get("cut"),
             commits=st.commits, step=state.step,
             own_digest=st.own.digest if st.own else None,
             params=params_digest(model))
        b, avg = 0, None
        while state.step < ELASTIC_STEPS:
            rows = torch.as_tensor(
                sampler.local_indices[b * batch:(b + 1) * batch])
            ids = tokens[rows].to(dev)
            t0 = time.perf_counter()
            before = launched()
            opt.zero_grad()
            loss = lm_loss(model(ids), ids)
            if (flag and state.step == ELASTIC_KILL_STEP
                    and hvd.rank() == 1 and not os.path.exists(flag)):
                torch.cuda.synchronize()
                with open(flag, "w") as f:
                    f.write(repr(time.time()))
                os.kill(os.getpid(), signal.SIGKILL)
            loss.backward()
            opt.step()
            avg = hvd.allreduce(loss.detach(),
                                name=f"elastic.loss.{state.step}").item()
            step_s = time.perf_counter() - t0
            now = launched()
            rose = {k: now[k] - before[k] for k in ELASTIC_CATEGORIES}
            sampler.record_batch(b, batch)
            b += 1
            state.step += 1
            t0 = time.perf_counter()
            state.commit()
            commit_s = time.perf_counter() - t0
            st = migrate.store()
            emit("step", step=state.step - 1, loss=avg, launches=rose,
                 step_s=step_s, commit_s=commit_s, commits=st.commits,
                 replication=st.last_replication,
                 own_digest=st.own.digest if st.own else None,
                 params=params_digest(model))
        return avg

    train(state)
    now = launched()
    emit("final", params=params_digest(model),
         launches={k: now[k] for k in ELASTIC_CATEGORIES},
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    if hvd.rank() == 0:
        torch.save({n: p.detach().cpu() for n, p in model.named_parameters()},
                   os.path.join(spec["outdir"], "final_params.pt"))
    if spec["checkpoint"]:
        emit("checkpoint", **checkpoint_roundtrip(hvd, model, opt,
                                                  state.step, spec["outdir"]))
    hvd.shutdown()
    return 0


def driver_generations(log: str) -> list:
    """``[(generation, size), ...]`` from the elastic driver's verbose
    log ("elastic driver: generation G formed with N worker(s)")."""
    import re

    return [(int(g), int(n)) for g, n in re.findall(
        r"elastic driver: generation (\d+) formed with (\d+) worker", log)]


def elastic_expected_launches(layers: int, steps: int,
                              world: int = 2) -> dict:
    """K1-K6 launches of the elastic job's completed steps: each of
    ``world`` ranks launches K4, K5 and K6 once a layer a step, whichever
    generation runs the step; no codec kernel runs."""
    per = layers * steps * world
    return {"flash_fwd": per, "flash_bwd_dq": per, "flash_bwd_dkv": per,
            "quant_int8": 0, "quant_int4": 0, "dequant": 0}


def run_launcher(argv, env, timeout_s, log_path,
                 module="horovod_tpu_torch.runner.launch", started=None):
    """``python -m <module> argv`` (the port's launcher by default) in a
    session of its own (so a timeout kills it and its workers together);
    ``started`` receives the process.  Returns (rc, stdout, stderr,
    seconds)."""
    import signal

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", module, *argv],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    if started is not None:
        started(proc)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        err += f"\nchip_smoke: launcher killed after {timeout_s} s"
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)  # strays of the session
        except OSError:
            pass
    with open(log_path, "w") as f:
        f.write(out + "\n--- stderr ---\n" + err)
    return proc.returncode, out, err, time.perf_counter() - t0


def read_events(outdir) -> list:
    events = []
    for name in sorted(os.listdir(outdir)):
        if name.startswith("events."):
            with open(os.path.join(outdir, name)) as f:
                events.extend(json.loads(line) for line in f if line.strip())
    return sorted(events, key=lambda e: e["time"])


def check_elastic(events, gens, layers, killed: bool) -> dict:
    """The elastic run's checks (raise on a failure) and its report."""
    want = [(0, 2), (1, 2)] if killed else [(0, 2)]
    if gens != want:
        raise AssertionError(f"elastic generations {gens}, expected {want}")
    steps = [e for e in events if e["event"] == "step"]
    per_step = elastic_expected_launches(layers, 1, 1)
    for e in steps:
        if e["launches"] != per_step:
            raise AssertionError(f"elastic step {e['step']} rank "
                                 f"{e['rank']} generation {e['generation']}"
                                 f": launches {e['launches']}, expected "
                                 f"{per_step}")
        if not e["loss"] == e["loss"] or abs(e["loss"]) == float("inf"):
            raise AssertionError(f"non-finite elastic loss {e['loss']}")
    for g, _ in want:
        if not any(e["generation"] == g for e in steps):
            raise AssertionError(f"generation {g} trained no step")
    finals = [e for e in events if e["event"] == "final"]
    if len(finals) != 2 or len({e["params"] for e in finals}) != 1:
        raise AssertionError(f"final parameters differ across ranks: "
                             f"{[(e['rank'], e['params']) for e in finals]}")
    rep = {"generations": gens,
           "losses": {f"{e['generation']}:{e['rank']}:{e['step']}":
                      e["loss"] for e in steps},
           "replications": [{"generation": e["generation"],
                             "rank": e["rank"], "step": e["step"],
                             **(e["replication"] or {})} for e in steps],
           "commit_s": [e["commit_s"] for e in steps],
           "step_s": [e["step_s"] for e in steps],
           "peak_mem_gb": {e["rank"]: e["peak_mem_gb"] for e in finals},
           "launches": {k: sum(e["launches"][k] for e in steps)
                        for k in ELASTIC_CATEGORIES}}
    if not killed:
        return rep
    resumes = [e for e in events
               if e["event"] == "resume" and e["generation"] == 1]
    modes = {e["rank"]: e["mode"] for e in resumes}
    if len(resumes) != 2 or any(m in (None, "cold", "fallback")
                                for m in modes.values()):
        raise AssertionError(f"generation 1 resumed by modes {modes}")
    last = {}  # (pid) -> its last committed step event in generation 0
    for e in steps:
        if e["generation"] == 0:
            last[e["pid"]] = e
    cut = ELASTIC_KILL_STEP - 1
    for e in resumes:
        survivor = e["pid"] in last
        if survivor:
            committed = last[e["pid"]]
        else:
            dead = [x for pid, x in last.items()
                    if pid not in {r["pid"] for r in resumes}]
            if len(dead) != 1:
                raise AssertionError("no record of the killed rank's steps")
            committed = dead[0]
        if committed["step"] != cut or e["step"] != cut + 1:
            raise AssertionError(f"rank {e['rank']} resumed at step "
                                 f"{e['step']} from commit of step "
                                 f"{committed['step']}")
        if e["params"] != committed["params"]:
            raise AssertionError(f"rank {e['rank']} (survivor {survivor}) "
                                 "did not resume the committed parameters")
        if e["own_digest"] != committed["own_digest"]:
            raise AssertionError(f"rank {e['rank']} adopted a record of "
                                 "another digest than the committed one")
    rep["resume"] = {e["rank"]: {"mode": e["mode"], "cut": e["cut"],
                                 "survivor": e["pid"] in last,
                                 "digest": e["own_digest"][:16]}
                     for e in resumes}
    return rep


def elastic_phase(seed, gpu_operations) -> dict:
    """The port's launcher drives two elastic jobs of ``elastic_worker``:
    one whose rank 1 SIGKILLs itself after the forward of step
    ``ELASTIC_KILL_STEP`` (once, behind a flag file), and one
    uninterrupted, whose final parameters the first must match bit for
    bit."""
    import shutil
    import tempfile

    layers = ELASTIC_LAYERS
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="hvd_elastic_")
    try:
        script = os.path.join(tmp, "worker.py")
        with open(script, "w") as f:
            f.write(ELASTIC_WORKER.format(repo=repo))

        def run(label, killed) -> dict:
            outdir = os.path.join(tmp, label)
            os.makedirs(outdir)
            spec = {"outdir": outdir, "seed": seed, "checkpoint": killed,
                    "kill_flag": (os.path.join(outdir, "killed.flag")
                                  if killed else None)}
            env = dict(os.environ)
            for var in ("HOROVOD_WIRE_COMPRESSION", "HOROVOD_DEVICE_SCHEDULE",
                        "HOROVOD_WIRE_COMPRESSION_MIN_BYTES"):
                env.pop(var, None)
            env.update({
                "PYTHONPATH": repo + os.pathsep + env.get("PYTHONPATH", ""),
                "HOROVOD_GPU_OPERATIONS": gpu_operations,
                "HOROVOD_GLOO_TIMEOUT_SECONDS": "300",
                "HVD_SMOKE_ELASTIC": json.dumps(spec)})
            rc, out, err, secs = run_launcher(
                ["--min-np", "2", "-np", "2", "-H", "localhost:2",
                 "--verbose", sys.executable, script], env,
                ELASTIC_LAUNCHER_TIMEOUT_S,
                os.path.join(tmp, f"{label}.log"))
            if rc != 0:
                raise AssertionError(
                    f"elastic {label} run: launcher exit {rc}\n"
                    f"{out[-6000:]}\n--- stderr ---\n{err[-6000:]}")
            events = read_events(outdir)
            rep = check_elastic(events, driver_generations(err), layers,
                                killed)
            want = elastic_expected_launches(layers, ELASTIC_STEPS)
            if rep["launches"] != want:
                raise AssertionError(f"elastic {label} run: launches "
                                     f"{rep['launches']}, expected {want}")
            rep["seconds"] = secs
            if killed:
                with open(spec["kill_flag"]) as f:
                    killed_at = float(f.read())
                gen1 = [e for e in events if e["generation"] == 1]
                rep["kill_to_resume_s"] = min(
                    e["time"] for e in gen1 if e["event"] == "resume") \
                    - killed_at
                rep["kill_to_first_step_s"] = min(
                    e["time"] for e in gen1 if e["event"] == "step") \
                    - killed_at
                ckpts = [e for e in events if e["event"] == "checkpoint"]
                if len(ckpts) != 2 or not all(e["bitwise"] for e in ckpts):
                    raise AssertionError(f"checkpoint round trip {ckpts}")
                rep["checkpoint"] = {e["rank"]: {
                    k: e[k] for k in ("bytes", "save_s", "restore_s",
                                      "bitwise")} for e in ckpts}
            rep["final_params"] = torch.load(
                os.path.join(outdir, "final_params.pt"))
            rep["final_digest"] = next(e["params"] for e in events
                                       if e["event"] == "final")
            return rep

        # Both runs at once: the resume's bits and the launches do not
        # depend on the timing, and the time is not a speed result.
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(2) as pool:
            futures = {label: pool.submit(run, label, killed)
                       for label, killed in (("killed", True),
                                             ("uninterrupted", False))}
        runs = {label: f.result() for label, f in futures.items()}
        a = runs["killed"].pop("final_params")
        b = runs["uninterrupted"].pop("final_params")
        err = max(float((a[n] - b[n]).abs().max()) for n in a)
        if (runs["killed"]["final_digest"]
                != runs["uninterrupted"]["final_digest"]
                or not same_tree(a, b) or err > ELASTIC_PARAM_TOL):
            raise AssertionError(f"killed run's final parameters differ "
                                 f"from the uninterrupted run's (max abs "
                                 f"{err}, limit {ELASTIC_PARAM_TOL}: "
                                 "bitwise)")
        return {"runs": runs, "vs_uninterrupted_max_abs": err,
                "vs_uninterrupted_tol": ELASTIC_PARAM_TOL,
                "vs_uninterrupted_bitwise": True}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# The fleet phase: GPT-2 small at full width, three ranks on cuda:0 under
# the port's launcher with the fleet autopilot and the live cockpit.  Rank
# 2, alone on host "localhost", is made a persistent straggler by injected
# delay on every coordinator receive from it; the autopilot evicts its host
# and the blacklist's expiry re-admits it.
FLEET_WORLD = 3
FLEET_HOSTS = "127.0.0.1:2,localhost:1"  # sorts into rank order: rank 2 alone
FLEET_BATCH = 4            # sequences a rank a step
FLEET_SEQ = 1024           # tokens a sequence
FLEET_SEQS = 24            # the seeded token set: an epoch is 2 batches a
#                            rank at world 3 and 3 at world 2
FLEET_LR = 3e-4
FLEET_WARMUP = 8           # steps of hvd.callbacks.warmup_schedule
FLEET_AFTER_STEPS = 2      # steps at world 3 after the re-growth
FLEET_DELAY_MS = 400       # on each coordinator receive from rank 2
FLEET_SENTENCE_S = 40      # the eviction's blacklist sentence
FLEET_LR_RTOL = 1e-12
FLEET_LAUNCHER_TIMEOUT_S = 600
# The straggler rule compares each rank's mean announce lag in a report
# window with max(skew x the median rank's, a floor).  The workers meet at
# the loss average just before each forward, so ranks 0 and 1 announce
# their gradients in the same negotiation cycles and lag about 0, while
# rank 2's every frame reaches the coordinator FLEET_DELAY_MS late.  A
# window of 8 s holds at least one step's backward (a step takes 3-6 s on
# the shared card), so no window passes without rank 2's announcements:
# such a window would break its streak.
FLEET_ENV = {
    "HOROVOD_METRICS_REPORT_SECONDS": "8",
    "HOROVOD_STRAGGLER_SKEW": "2",
    "HOROVOD_STRAGGLER_MIN_MS": "150",
    "HOROVOD_AUTOPILOT_EVICT_WINDOWS": "2",
    # One eviction a job: the re-admitted straggler is still slow.
    "HOROVOD_AUTOPILOT_COOLDOWN_SECS": "3600",
    "HOROVOD_ELASTIC_BLACKLIST_BASE_SECS": str(FLEET_SENTENCE_S),
    # Collateral deaths at teardown never blacklist a host by themselves.
    "HOROVOD_ELASTIC_BLACKLIST_FAILURES": "10",
    # The elastic phase covers replication; here survivors keep their own
    # commit and a re-admitted rank is synced from rank 0.
    "HOROVOD_MIGRATE_REPLICAS": "0",
    "HOROVOD_FLIGHT_RECORDER": "1",
}
FLEET_WORKER = """import json, os, sys
sys.path.insert(0, {repo!r})
import chip_smoke
spec = json.loads(os.environ["HVD_SMOKE_FLEET"])
sys.exit(chip_smoke.fleet_worker(spec))
"""


def fleet_lr(step: int, size: int) -> float:
    """``warmup_schedule(FLEET_LR, FLEET_WARMUP)`` at ``step`` and world
    ``size``, written out: a third of the rate rising linearly to ``size``
    times the rate."""
    start, scaled = FLEET_LR / 3.0, FLEET_LR * size
    if step < FLEET_WARMUP:
        return start + (scaled - start) * (step / FLEET_WARMUP)
    return scaled


def prefetch_threads_left(timeout_s: float = 3.0) -> int:
    """Producer threads of ``hvd.data.prefetch_to_device`` still alive
    after up to ``timeout_s`` (an abandoned iterator's thread ends within
    half a second)."""
    import threading

    deadline = time.monotonic() + timeout_s
    while True:
        left = sum(t.name == "hvd-prefetch" for t in threading.enumerate())
        if left == 0 or time.monotonic() >= deadline:
            return left
        time.sleep(0.05)


def fleet_worker(spec) -> int:
    """One worker of the fleet job: GPT at ``GPT_SMALL`` on cuda:0,
    ``DistributedOptimizer(AdamW)`` in a ``TorchState``; batches from
    ``hvd.data.ShardedDataset`` through ``hvd.data.prefetch_to_device``;
    the rate set each step from ``hvd.callbacks.warmup_schedule``; the
    loss averaged by ``hvd.callbacks.MetricAverageCallback``; a commit
    after every step.  It trains until it has seen the shrink (world < 3)
    and the re-growth, then ``FLEET_AFTER_STEPS`` steps more.  Writes one
    JSON line per event to ``<outdir>/events.<pid>.jsonl``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import GPT, GPT_SMALL, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import quantize as qz

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hvd.init(device="cuda:0")
    dev = hvd.device()
    torch.manual_seed(spec["seed"])
    model = GPT(GPT_SMALL).to(dev)
    schedule = hvd.callbacks.warmup_schedule(FLEET_LR, FLEET_WARMUP)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=schedule(0)),
        named_parameters=model.named_parameters())
    state = hvd.elastic.TorchState(model=model, optimizer=opt, step=0,
                                   epoch=0, phase=0, after=0)
    gen = torch.Generator().manual_seed(spec["seed"] + 3)
    tokens = torch.randint(0, GPT_SMALL.vocab_size, (FLEET_SEQS, FLEET_SEQ),
                           generator=gen)
    data = hvd.data.ShardedDataset([tokens], batch_size=FLEET_BATCH,
                                   seed=spec["seed"])
    average = hvd.callbacks.MetricAverageCallback()
    log = open(os.path.join(spec["outdir"], f"events.{os.getpid()}.jsonl"),
               "a", buffering=1)

    def emit(event, **kw):
        log.write(json.dumps({
            "event": event, "pid": os.getpid(), "time": time.time(),
            "generation": int(os.environ.get("HOROVOD_ELASTIC_GENERATION",
                                             "0")),
            "rank": hvd.rank(), "size": hvd.size(), **kw}) + "\n")

    def launched():
        return {**fa.LAUNCHES, **qz.LAUNCHES}

    def finished():
        return state.phase == 2 and state.after >= FLEET_AFTER_STEPS

    fa.reset_launch_counts()
    qz.reset_launch_counts()

    @hvd.elastic.run
    def train(state):
        emit("resume", step=state.step, epoch=state.epoch,
             phase=state.phase, params=params_digest(model),
             prefetch_threads=prefetch_threads_left(),
             cockpit_port=os.environ.get("HOROVOD_COCKPIT_PORT"))
        while not finished():
            data.set_epoch(state.epoch)
            length, count = len(data), 0
            for (ids,) in hvd.data.prefetch_to_device(data, depth=2,
                                                      device=dev):
                if finished():
                    break
                count += 1
                lr = schedule(state.step)
                for group in opt.param_groups:
                    group["lr"] = lr
                t0 = time.perf_counter()
                before = launched()
                opt.zero_grad()
                loss = lm_loss(model(ids), ids)
                loss.backward()
                opt.step()
                local = loss.item()
                step_s = time.perf_counter() - t0
                now = launched()
                size = hvd.size()
                state.step += 1
                if state.phase == 0 and size < FLEET_WORLD:
                    state.phase = 1
                elif state.phase == 1 and size >= FLEET_WORLD:
                    state.phase = 2
                if state.phase == 2:
                    state.after += 1
                emit("step", step=state.step - 1, epoch=state.epoch,
                     batch=count - 1, lr=lr, local_loss=local,
                     on_card=ids.device == dev, ids_shape=list(ids.shape),
                     launches={k: now[k] - before[k]
                               for k in ELASTIC_CATEGORIES},
                     step_s=step_s)
                t0 = time.perf_counter()
                state.commit()
                commit_s = time.perf_counter() - t0
                # The average is the ranks' meeting point before the next
                # forward (the commit's host snapshot leaves them apart).
                avg = average.on_epoch_end({"loss": local})["loss"]
                emit("commit", step=state.step - 1, commit_s=commit_s,
                     loss=avg)
            else:
                emit("epoch", epoch=state.epoch, batches=count,
                     length=length)
            state.epoch += 1

    train(state)
    emit("final", params=params_digest(model), step=state.step,
         launches={k: v for k, v in launched().items()
                   if k in ELASTIC_CATEGORIES},
         peak_mem_gb=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                      if dev.type == "cuda" else 0.0))
    hvd.shutdown()
    return 0


class CockpitWatch:
    """Reads rank 0's cockpit from outside the job while it runs: the
    sticky port from rank 0's ``resume`` events, per generation ``/state``,
    ``/metrics``, ``/history`` and ``tools/hvd_top.py --once``; ``/state``
    again every half second (the straggler report, the step rows); and an
    ``/events`` client held open, reconnecting across re-formations."""

    def __init__(self, outdir: str, repo: str):
        import threading

        self.outdir, self.repo = outdir, repo
        self.port = None
        self.generation = -1
        self.ports = set()
        self.snapshots = {}       # generation -> first /state, /metrics...
        self.flagged_at = {}      # generation -> (time, report) when rank
        #                           2 was first named a straggler
        self.steps_tagged = {}    # generation -> plane tags of step rows
        self.sse = []             # (time, event) from /events
        self.sse_connects = 0
        self.errors = []
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=f, daemon=True)
                         for f in (self._poll, self._stream)]

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)

    def _get(self, path: str, timeout: float = 5.0):
        import urllib.request

        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.port}{path}", timeout=timeout) as r:
            return r.read()

    def _rank0_resumes(self):
        out = []
        for name in os.listdir(self.outdir):
            if name.startswith("events."):
                with open(os.path.join(self.outdir, name)) as f:
                    for line in f:
                        if '"resume"' in line and line.endswith("\n"):
                            e = json.loads(line)
                            if e["rank"] == 0 and e["cockpit_port"]:
                                out.append(e)
        return out

    def _poll(self):
        while not self._stop.wait(0.5):
            try:
                for e in self._rank0_resumes():
                    if e["generation"] > self.generation:
                        self.generation = e["generation"]
                        self.port = int(e["cockpit_port"])
                        self.ports.add(self.port)
                if self.port is None:
                    continue
                gen = self.generation
                state = json.loads(self._get("/state"))
                if state.get("elastic_generation") != gen:
                    continue
                report = state.get("straggler_report") or ""
                if "rank 2" in report and gen not in self.flagged_at:
                    self.flagged_at[gen] = (time.time(), report)
                tags = self.steps_tagged.setdefault(gen, set())
                tags.update(s.get("plane") for s in state.get("steps") or [])
                if gen not in self.snapshots:
                    top = subprocess.run(
                        [sys.executable,
                         os.path.join(self.repo, "tools", "hvd_top.py"),
                         "--once", "--no-color", "--port", str(self.port)],
                        capture_output=True, text=True, timeout=30)
                    self.snapshots[gen] = {
                        "port": self.port, "state": state,
                        "metrics": self._get("/metrics").decode(),
                        "history": json.loads(self._get("/history")),
                        "hvd_top_rc": top.returncode,
                        "hvd_top_lines": len(top.stdout.splitlines())}
            except Exception as exc:  # noqa: BLE001 - between generations
                self.errors.append(repr(exc)[:200])

    def _stream(self):
        import http.client

        while not self._stop.is_set():
            if self.port is None:
                time.sleep(0.2)
                continue
            try:
                conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                                  timeout=5)
                conn.request("GET", "/events")
                resp = conn.getresponse()
                self.sse_connects += 1
                while not self._stop.is_set():
                    line = resp.fp.readline()
                    if not line:
                        break
                    if line.startswith(b"data: "):
                        self.sse.append((time.time(),
                                         json.loads(line[len(b"data: "):])))
                conn.close()
            except Exception:  # noqa: BLE001 - the server is between
                time.sleep(0.2)  # generations; reconnect to the same port


def read_flight_autopilot(pm_dir) -> list:
    """``(action, rank)`` of every autopilot record in the flight dumps."""
    import glob

    found = []
    for path in sorted(glob.glob(os.path.join(pm_dir, "flight.*.json"))):
        with open(path) as f:
            dump = json.load(f)
        code = next((int(k) for k, v in (dump.get("types") or {}).items()
                     if v == "autopilot"), None)
        found += [(row[4], row[5]) for row in dump.get("events") or []
                  if row[2] == code]
    return found


def check_fleet(events, err, journal, flights, watch, layers) -> dict:
    """The fleet run's checks (raise on a failure) and its report."""
    gens = driver_generations(err)
    sizes = [n for _, n in gens]
    if "autopilot evicted host localhost" not in err:
        raise AssertionError("the driver log names no eviction of localhost")
    if not (sizes and sizes[0] == FLEET_WORLD and sizes[-1] == FLEET_WORLD
            and 2 in sizes and sizes.count(FLEET_WORLD) >= 2):
        raise AssertionError(f"fleet generations {gens}")
    actions = [r["action"] for r in journal]
    evicts = [r for r in journal if r["action"] == "evict"]
    if not evicts or evicts[0]["rank"] != 2 \
            or "localhost" not in evicts[0]["detail"]:
        raise AssertionError(f"autopilot journal {journal}")
    if not {"readmit", "scale_up"} & set(actions):
        raise AssertionError(f"no re-admission in the journal {actions}")
    if (1, 2) not in flights:
        raise AssertionError(f"no evict of rank 2 in the flight dumps "
                             f"{flights}")

    # The cockpit: every generation on one port.
    gen_ids = [g for g, _ in gens]
    missing = [g for g in gen_ids if g not in watch.snapshots]
    if missing or len(watch.ports) != 1:
        raise AssertionError(f"cockpit snapshots missing for generations "
                             f"{missing}, ports {watch.ports}, errors "
                             f"{watch.errors[-5:]}")
    for g, snap in watch.snapshots.items():
        st = snap["state"]
        if st.get("schema") != "cockpit-state-v1" \
                or st.get("elastic_generation") != g:
            raise AssertionError(f"cockpit /state of generation {g}: {st}")
        fams = prometheus_families(snap["metrics"])
        if not fams or not all(f.startswith("hvd_") for f in fams):
            raise AssertionError(f"cockpit /metrics of generation {g}")
        if snap["hvd_top_rc"] != 0 or snap["hvd_top_lines"] == 0:
            raise AssertionError(f"tools/hvd_top.py --once on generation "
                                 f"{g}: rc {snap['hvd_top_rc']}")
    if 0 not in watch.flagged_at:
        raise AssertionError("no /state straggler report named rank 2")
    if not any("eager" in tags for tags in watch.steps_tagged.values()) \
            or any(tags - {"eager"} for tags in watch.steps_tagged.values()):
        raise AssertionError(f"step rows' planes {watch.steps_tagged}")
    sse_steps = [e for _, e in watch.sse if e.get("type") == "step"]
    sse_evict = [(t, e) for t, e in watch.sse if e.get("type") == "autopilot"
                 and e.get("action") == "evict" and e.get("rank") == 2]
    if not sse_steps or not sse_evict:
        raise AssertionError(f"SSE: {len(sse_steps)} step summaries, "
                             f"autopilot instants {sse_evict}")

    steps = [e for e in events if e["event"] == "step"]
    per_step = elastic_expected_launches(layers, 1, 1)
    for e in steps:
        where = f"step {e['step']} rank {e['rank']} gen {e['generation']}"
        if e["launches"] != per_step:
            raise AssertionError(f"fleet {where}: launches {e['launches']}")
        if not e["on_card"]:
            raise AssertionError(f"fleet {where}: batch not on the card")
        want = fleet_lr(e["step"], e["size"])
        if abs(e["lr"] - want) > FLEET_LR_RTOL * want:
            raise AssertionError(f"fleet {where}: lr {e['lr']}, schedule "
                                 f"{want}")
        if not e["local_loss"] == e["local_loss"] \
                or abs(e["local_loss"]) == float("inf"):
            raise AssertionError(f"fleet {where}: loss {e['local_loss']}")
    losses = [e["loss"] for e in events if e["event"] == "commit"]
    if not losses or any(not x == x or abs(x) == float("inf")
                         for x in losses):
        raise AssertionError(f"fleet averaged losses {losses}")
    epochs = [e for e in events if e["event"] == "epoch"]
    for e in epochs:
        if e["batches"] != e["length"] or e["length"] != \
                FLEET_SEQS // e["size"] // FLEET_BATCH:
            raise AssertionError(f"fleet epoch {e}: batches vs length")
    if {e["size"] for e in epochs} != {2, FLEET_WORLD}:
        raise AssertionError(f"completed epochs at sizes "
                             f"{sorted({e['size'] for e in epochs})}")
    resumes = [e for e in events if e["event"] == "resume"]
    if any(e["prefetch_threads"] for e in resumes):
        raise AssertionError("a prefetch thread outlived its iterator: "
                             f"{[e['prefetch_threads'] for e in resumes]}")
    finals = [e for e in events if e["event"] == "final"]
    last = gens[-1][0]
    if len(finals) != FLEET_WORLD or len({e["params"] for e in finals}) != 1 \
            or any(e["generation"] != last for e in finals):
        raise AssertionError(f"final parameters across ranks: "
                             f"{[(e['rank'], e['params']) for e in finals]}")

    evict_t = evicts[0]["ts"]
    first_w2 = min(e["time"] for e in steps if e["size"] == 2)
    regrown = min(e["time"] for e in steps
                  if e["size"] == FLEET_WORLD and e["time"] > first_w2)
    by_rank = {}
    for e in steps:
        by_rank.setdefault(f"{e['generation']}:{e['rank']}", []).append(
            round(e["step_s"], 3))
    return {
        "generations": gens,
        "journal": [(r["action"], r["rank"]) for r in journal],
        "flight_autopilot": flights,
        "cockpit": {"port": next(iter(watch.ports)),
                    "generations": sorted(watch.snapshots),
                    "sse_connects": watch.sse_connects,
                    "sse_steps": len(sse_steps),
                    "sse_autopilot": [e for _, e in watch.sse
                                      if e.get("type") == "autopilot"],
                    "metric_families": len(prometheus_families(
                        watch.snapshots[0]["metrics"])),
                    "straggler_report": watch.flagged_at[0][1]},
        "steps": len(steps), "step_s": by_rank,
        "commit_s": [round(e["commit_s"], 3) for e in events
                     if e["event"] == "commit"],
        "losses": losses,
        "epochs": [(e["generation"], e["size"], e["batches"])
                   for e in epochs],
        "flagged_to_evict_s": evict_t - watch.flagged_at[0][0],
        "sse_evict_after_decision_s": sse_evict[0][0] - evict_t,
        "evict_to_first_world2_step_s": first_w2 - evict_t,
        "expiry_to_first_world3_step_s":
            regrown - (evict_t + FLEET_SENTENCE_S),
        "readmit_journal_to_first_world3_step_s": regrown - min(
            [r["ts"] for r in journal if r["action"] == "readmit"]
            or [regrown]),
        "peak_mem_gb": {e["rank"]: e["peak_mem_gb"] for e in finals},
        "launches": {k: sum(e["launches"][k] for e in steps)
                     for k in ELASTIC_CATEGORIES},
        "final_digest": finals[0]["params"][:16],
    }


def fleet_phase(seed, gpu_operations) -> dict:
    """The port's launcher runs ``fleet_worker`` on three ranks with
    ``--autopilot --cockpit`` and rank 2 delayed; a ``CockpitWatch`` reads
    the cockpit from outside while it runs."""
    import shutil
    import tempfile

    from horovod_tpu_torch.models import GPT_SMALL

    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="hvd_fleet_")
    try:
        script = os.path.join(tmp, "worker.py")
        with open(script, "w") as f:
            f.write(FLEET_WORKER.format(repo=repo))
        outdir = os.path.join(tmp, "out")
        pm_dir = os.path.join(tmp, "pm")
        os.makedirs(outdir)
        os.makedirs(pm_dir)
        env = dict(os.environ)
        for var in ("HOROVOD_WIRE_COMPRESSION", "HOROVOD_DEVICE_SCHEDULE",
                    "HOROVOD_WIRE_COMPRESSION_MIN_BYTES",
                    "HOROVOD_AUTOPILOT", "HOROVOD_COCKPIT"):
            env.pop(var, None)
        env.update(FLEET_ENV)
        env.update({
            "PYTHONPATH": repo + os.pathsep + env.get("PYTHONPATH", ""),
            "HOROVOD_GPU_OPERATIONS": gpu_operations,
            "HOROVOD_GLOO_TIMEOUT_SECONDS": "300",
            "HOROVOD_POSTMORTEM_DIR": pm_dir,
            "HVD_SMOKE_FLEET": json.dumps({"outdir": outdir, "seed": seed})})
        with CockpitWatch(outdir, repo) as watch:
            rc, out, err, secs = run_launcher(
                ["-np", str(FLEET_WORLD), "--min-np", "2", "-H", FLEET_HOSTS,
                 "--autopilot", "--cockpit", "--verbose",
                 "--start-timeout", "300", "--fault-inject",
                 f"coordinator-recv:*:2:delay:{FLEET_DELAY_MS}",
                 sys.executable, script], env, FLEET_LAUNCHER_TIMEOUT_S,
                os.path.join(tmp, "fleet.log"))
        if rc != 0:
            raise AssertionError(f"fleet run: launcher exit {rc}\n"
                                 f"{out[-6000:]}\n--- stderr ---\n"
                                 f"{err[-6000:]}")
        journal_path = os.path.join(pm_dir, "autopilot.jsonl")
        journal = []
        if os.path.exists(journal_path):
            with open(journal_path) as f:
                journal = [json.loads(line) for line in f if line.strip()]
        rep = check_fleet(read_events(outdir), err, journal,
                          read_flight_autopilot(pm_dir), watch,
                          GPT_SMALL.num_layers)
        rep["seconds"] = secs
        return rep
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# The cluster integrations: the estimator, Spark and Ray.
# ---------------------------------------------------------------------------

INT_SEQS = 16              # the seeded token set: 16 sequences of 1,024 + 1
INT_SEQ = 1024
INT_BATCH_W1 = 8           # the world-1 estimator's batch: 2 steps
INT_BATCH_W2 = 4           # a rank's batch at world 2: 8 sequences, 2 steps
INT_LR = 3e-4
INT_STEPS = 2
RAY_LAYERS = 2             # GPT_SMALL's width, its depth cut to fit the phase
RAY_STEPS = 2
PREFETCH_SEQS = 24         # the CUDA token set spark.run prefetches
PREFETCH_BATCH = 4
INT_TIMEOUT_S = 600


def int_tokens(seed):
    """The estimator's data: seeded token ids, features the first 1,024 of
    each sequence and labels the same shifted by one."""
    import numpy as np

    from horovod_tpu_torch.models import GPT_SMALL

    tok = np.random.default_rng(seed + 40).integers(
        0, GPT_SMALL.vocab_size, (INT_SEQS, INT_SEQ + 1), dtype=np.int64)
    return tok[:, :-1].copy(), tok[:, 1:].copy()


class CountedLoss:
    """The LM cross entropy of the estimator's runs, noting at each call
    the time and the kernels' launch counts so far (the step's forward has
    run, its backward not yet)."""

    def __init__(self):
        self.log = []

    def __call__(self, logits, targets):
        import torch.nn.functional as F

        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.ops import quantize as qz

        self.log.append((time.perf_counter(), {**fa.LAUNCHES, **qz.LAUNCHES}))
        return F.cross_entropy(logits.flatten(0, 1).float(),
                               targets.flatten())


def estimator_launches(log, final) -> list:
    """Launches between consecutive loss calls, and after the last: the
    first interval holds step 0's forward, each later one the previous
    step's backward and this step's forward, the last one the last
    backward."""
    marks = [counts for _, counts in log] + [final]
    zero = {k: 0 for k in final}
    return [{k: b[k] - a[k] for k in final}
            for a, b in zip([zero] + marks[:-1], marks)]


def check_estimator_launches(per_interval, layers, steps) -> None:
    """K4 ``layers`` in each of the first ``steps`` intervals, K5 and K6
    ``layers`` in each but the first, K1-K3 none."""
    if len(per_interval) != steps + 1:
        raise AssertionError(f"{len(per_interval) - 1} loss calls, expected "
                             f"{steps}")
    for i, rose in enumerate(per_interval):
        want = {k: 0 for k in rose}
        if i < steps:
            want["flash_fwd"] = layers
        if i > 0:
            want["flash_bwd_dq"] = want["flash_bwd_dkv"] = layers
        if rose != want:
            raise AssertionError(f"interval {i}: launches {rose}, expected "
                                 f"{want}")


def counted_worker(*args):
    """The estimator's own worker (``spark.estimator._torch_train_worker``)
    between a reset of the launch counts and a read of them; returns its
    (state, history) and what was counted."""
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import quantize as qz
    from horovod_tpu_torch.spark.estimator import _torch_train_worker

    loss = args[1]
    fa.reset_launch_counts()
    qz.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, history = _torch_train_worker(*args)
    seconds = time.perf_counter() - t0
    final = {**fa.LAUNCHES, **qz.LAUNCHES}
    times = [t for t, _ in loss.log]
    return state, history, {
        "launches": final,
        "per_interval": estimator_launches(loss.log, final),
        "step_s": [b - a for a, b in zip(times, times[1:])],
        "worker_seconds": seconds,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def _counted_estimator():
    """``TorchEstimator`` whose worker is :func:`counted_worker`; ``fit``
    keeps what was counted in ``counted``."""
    from horovod_tpu_torch.spark.estimator import TorchEstimator

    class CountedEstimator(TorchEstimator):
        _WORKER = staticmethod(counted_worker)

        def _finish(self, out):
            self.counted = out[2]
            return super()._finish(out[:2])

    return CountedEstimator


def wire_digest(state: dict) -> str:
    """sha256 over a wire-valued state dict's bytes, in key order."""
    import hashlib

    from horovod_tpu_torch.spark.estimator import _state_to_torch

    h = hashlib.sha256()
    for k, v in sorted(_state_to_torch(state).items()):
        h.update(k.encode())
        h.update(v.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def state_digest(module) -> str:
    from horovod_tpu_torch.spark.estimator import _state_to_wire

    return wire_digest(_state_to_wire(module.state_dict()))


def estimator_world1(hvd, fa, seed, tmpdir) -> dict:
    """``TorchEstimator(backend="local")`` at world 1 over NCCL: GPT_SMALL
    fitted on the token set in 2 steps, then the same 2 steps replayed
    directly with ``DistributedOptimizer(AdamW)``, the Store's checkpoint
    loaded into a fresh model, and ``predict`` against the forward."""
    from horovod_tpu_torch.models import GPT, GPT_SMALL
    from horovod_tpu_torch.spark import LocalStore
    from horovod_tpu_torch.spark.estimator import TorchModel

    x, y = int_tokens(seed)
    torch.manual_seed(seed)
    model = GPT(GPT_SMALL)
    loss = CountedLoss()
    store = LocalStore(tmpdir)
    est = _counted_estimator()(
        model=model, loss=loss,
        optimizer=torch.optim.AdamW(model.parameters(), lr=INT_LR),
        batch_size=INT_BATCH_W1, epochs=1, store=store, run_id="world1",
        feature_dtype=None)
    t0 = time.perf_counter()
    trained = est.fit(x, y)
    fit_s = time.perf_counter() - t0
    counted = est.counted
    check_estimator_launches(counted["per_interval"], GPT_SMALL.num_layers,
                             INT_STEPS)
    history = trained.metadata["loss_history"]
    if not all(v == v and abs(v) < float("inf") for v in history):
        raise AssertionError(f"non-finite loss: {history}")
    if next(trained.model.parameters()).device.type != "cuda":
        raise AssertionError("the local estimator did not train on the card")
    fitted = state_digest(trained.model)

    # The same two steps, written directly.
    hvd.init()
    try:
        dev = hvd.device()
        torch.manual_seed(seed)
        ref = GPT(GPT_SMALL).to(dev)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(ref.parameters(), lr=INT_LR),
            named_parameters=ref.named_parameters())
        hvd.broadcast_parameters(ref.state_dict(), root_rank=0)
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        ref.train()
        replay_losses = []
        for i in range(INT_STEPS):
            sl = slice(i * INT_BATCH_W1, (i + 1) * INT_BATCH_W1)
            opt.zero_grad()
            out = CountedLoss()(ref(torch.from_numpy(x[sl]).to(dev)),
                                torch.from_numpy(y[sl]).to(dev))
            out.backward()
            opt.step()
            replay_losses.append(float(out.detach()))
    finally:
        hvd.shutdown()
    replayed = state_digest(ref)
    if fitted != replayed:
        raise AssertionError("the estimator's fitted state differs from the "
                             "direct replay of its two steps")
    if history != [sum(replay_losses) / INT_STEPS]:
        raise AssertionError(f"loss history {history} against the replay's "
                             f"{replay_losses}")
    del ref, opt
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    torch.manual_seed(seed + 1)
    loaded = TorchModel.load(GPT(GPT_SMALL), store, "world1")
    load_s = time.perf_counter() - t0
    if state_digest(loaded.model) != fitted:
        raise AssertionError("TorchModel.load from the Store differs from "
                             "the fitted state")
    if loaded.metadata.get("feature_dtype", "x") is not None:
        raise AssertionError(f"metadata lost feature_dtype: "
                             f"{loaded.metadata}")
    got = trained.predict(x[:1])
    with torch.no_grad():
        want = trained.model(torch.from_numpy(x[:1]).to(
            next(trained.model.parameters()).device)).cpu().numpy()
    if got.shape != want.shape or got.tobytes() != want.tobytes():
        raise AssertionError("predict differs from the model's forward")
    ckpt = os.path.getsize(store.get_checkpoint_path("world1"))
    trained.model.cpu()
    torch.cuda.empty_cache()
    return {"fit_s": fit_s, "loss_history": history,
            "replay_losses": replay_losses,
            "state_bitwise_vs_replay": True, "store_roundtrip_bitwise": True,
            "predict_bitwise": True, "predict_shape": list(got.shape),
            "checkpoint_bytes": ckpt, "load_s": load_s,
            "launches": counted["launches"],
            "launches_per_interval": counted["per_interval"],
            "step_s": counted["step_s"],
            "worker_seconds": counted["worker_seconds"],
            "peak_mem_gb": counted["peak_mem_gb"]}


# -- a barrier-mode pyspark of spawned processes ------------------------------

class FakeBarrierContext:
    """``pyspark.BarrierTaskContext`` of one spawned partition."""

    _current = None

    def __init__(self, rank, to_driver, from_driver):
        self._rank = rank
        self._to_driver = to_driver
        self._from_driver = from_driver

    @classmethod
    def get(cls):
        return cls._current

    def partitionId(self):
        return self._rank

    def allGather(self, message=""):
        self._to_driver.put((self._rank, message))
        return self._from_driver.get()


def partition_main(f_blob, rank, to_driver, from_driver, results):
    import pickle
    import traceback

    FakeBarrierContext._current = FakeBarrierContext(rank, to_driver,
                                                     from_driver)
    try:
        out = list(pickle.loads(f_blob)(iter([rank])))
        results.put((rank, out, None))
    except BaseException:  # noqa: BLE001 - reported to the driver
        results.put((rank, None, traceback.format_exc()))


class FakeBarrierRDD:
    """``parallelize(n).barrier().mapPartitions(f).collect()``: one spawned
    process a partition, ``allGather`` through queues this process
    gathers; the task travels by stdlib pickle, as it must where there is
    no cloudpickle."""

    def __init__(self, n):
        self._n = n

    def barrier(self):
        return self

    def mapPartitions(self, f):
        self._f = f
        return self

    def collect(self):
        import pickle
        import queue as queue_mod
        import threading

        ctx = torch.multiprocessing.get_context("spawn")
        to_driver = ctx.Queue()
        from_driver = [ctx.Queue() for _ in range(self._n)]
        results = ctx.Queue()
        f_blob = pickle.dumps(self._f)
        procs = [ctx.Process(target=partition_main,
                             args=(f_blob, r, to_driver, from_driver[r],
                                   results)) for r in range(self._n)]
        for p in procs:
            p.start()
        stop = threading.Event()

        def gather():
            while not stop.is_set():
                got = {}
                while len(got) < self._n:
                    try:
                        rank, msg = to_driver.get(timeout=0.2)
                    except queue_mod.Empty:
                        if stop.is_set():
                            return
                        continue
                    got[rank] = msg
                for q in from_driver:
                    q.put([got[r] for r in range(self._n)])

        threading.Thread(target=gather, daemon=True).start()
        out, errors = [], []
        try:
            for _ in range(self._n):
                rank, res, err = results.get(timeout=INT_TIMEOUT_S)
                if err is not None:
                    errors.append(f"partition {rank}:\n{err}")
                else:
                    out.extend(res)
        finally:
            stop.set()
            for p in procs:
                p.join(60)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        if errors:
            raise AssertionError("; ".join(errors))
        return out


class FakeSparkContext:
    defaultParallelism = 2

    def parallelize(self, data, n):
        return FakeBarrierRDD(n)


def fake_module(name, **attrs):
    import types

    mod = types.ModuleType(name)
    mod.__dict__.update(attrs)
    return mod


class FakeSparkSession:
    sparkContext = FakeSparkContext()

    class builder:  # noqa: N801 - pyspark's name
        @staticmethod
        def getOrCreate():
            return FakeSparkSession()


def fake_pyspark() -> dict:
    """The modules ``horovod_tpu_torch.spark.run`` imports."""
    sql = fake_module("pyspark.sql", SparkSession=FakeSparkSession)
    return {"pyspark": fake_module("pyspark",
                                   BarrierTaskContext=FakeBarrierContext,
                                   sql=sql),
            "pyspark.sql": sql}


@contextlib.contextmanager
def patched(modules=None, env=None):
    """Fake modules and environment variables for a block; what was there
    is put back after."""
    modules, env = modules or {}, env or {}
    saved = [(sys.modules, {k: sys.modules.get(k) for k in modules}),
             (os.environ, {k: os.environ.get(k) for k in env})]
    sys.modules.update(modules)
    os.environ.update(env)
    try:
        yield
    finally:
        for where, was in saved:
            for k, v in was.items():
                if v is None:
                    where.pop(k, None)
                else:
                    where[k] = v


def world2_env(gpu_operations) -> dict:
    """What the spawned ranks of the world-2 parts inherit."""
    return {"HOROVOD_GPU_OPERATIONS": gpu_operations,
            "HOROVOD_GLOO_TIMEOUT_SECONDS": "300",
            "HOROVOD_SHM_DISABLE": "1"}


def estimator_spark(seed, tmpdir, gpu_operations) -> dict:
    """``TorchEstimator(backend="spark", num_proc=2, device="cuda:0")``
    through the barrier-mode fake: GPT_SMALL on 8 sequences a rank in
    batches of 4.  Every rank's result is kept (``spark.run`` wrapped):
    the ranks' states bitwise equal, the driver's model rank 0's."""
    import horovod_tpu_torch.spark as hvd_spark
    from horovod_tpu_torch.models import GPT, GPT_SMALL

    x, y = int_tokens(seed)
    torch.manual_seed(seed)
    model = GPT(GPT_SMALL)
    every = {}
    run = hvd_spark.run

    def keep_every_rank(fn, *args, **kwargs):
        every["results"] = run(fn, *args, **kwargs)
        return every["results"]

    est = _counted_estimator()(
        model=model, loss=CountedLoss(),
        optimizer=torch.optim.AdamW(model.parameters(), lr=INT_LR),
        batch_size=INT_BATCH_W2, epochs=1, store=hvd_spark.LocalStore(tmpdir),
        backend="spark", num_proc=2, run_id="world2", feature_dtype=None,
        device="cuda:0")
    hvd_spark.run = keep_every_rank
    try:
        with patched(fake_pyspark(), world2_env(gpu_operations)):
            t0 = time.perf_counter()
            trained = est.fit(x, y)
            fit_s = time.perf_counter() - t0
    finally:
        hvd_spark.run = run
    ranks = []
    digests = []
    for rank, (state, history, counted) in enumerate(every["results"]):
        check_estimator_launches(counted["per_interval"],
                                 GPT_SMALL.num_layers, INT_STEPS)
        if not all(v == v and abs(v) < float("inf") for v in history):
            raise AssertionError(f"rank {rank}: non-finite loss {history}")
        digests.append(wire_digest(state))
        ranks.append({"rank": rank, "loss_history": history,
                      "launches": counted["launches"],
                      "step_s": counted["step_s"],
                      "worker_seconds": counted["worker_seconds"],
                      "peak_mem_gb": counted["peak_mem_gb"]})
    if len(set(digests)) != 1:
        raise AssertionError("the two ranks' fitted states differ")
    if state_digest(trained.model) != digests[0]:
        raise AssertionError("the driver's TorchModel differs from rank 0's "
                             "state")
    return {"fit_s": fit_s, "ranks": ranks,
            "states_bitwise_across_ranks": True,
            "driver_model_is_rank0_state": True}


def prefetch_task(seed):
    """One rank of ``spark.run``: a ``ShardedDataset`` of token ids made
    on the card, through ``hvd.data.prefetch_to_device``; every batch
    must come out on the card, equal to the dataset's own batch."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cuda:0")
    try:
        dev = hvd.device()
        gen = torch.Generator(device=dev).manual_seed(seed)
        ids = torch.randint(0, 50304, (PREFETCH_SEQS, INT_SEQ),
                            generator=gen, device=dev)
        ds = hvd.data.ShardedDataset([ids, ids.float()], PREFETCH_BATCH,
                                     seed=seed)
        want = list(ds)
        got = list(hvd.data.prefetch_to_device(ds, device=dev))
        torch.cuda.synchronize()
        return {"rank": hvd.rank(), "batches": len(got),
                "expected": len(ds),
                "on_card": all(t.device == dev for b in got for t in b),
                "equal": len(got) == len(want) and all(
                    torch.equal(a, b) for g, w in zip(got, want)
                    for a, b in zip(g, w))}
    finally:
        hvd.shutdown()


def spark_prefetch(seed, gpu_operations) -> list:
    import horovod_tpu_torch.spark as hvd_spark

    with patched(fake_pyspark(), world2_env(gpu_operations)):
        out = hvd_spark.run(prefetch_task, args=(seed,), num_proc=2)
    for rep in out:
        if not (rep["on_card"] and rep["equal"]
                and rep["batches"] == rep["expected"] > 0):
            raise AssertionError(f"prefetch of card tensors: {rep}")
    if [rep["rank"] for rep in out] != [0, 1]:
        raise AssertionError(f"spark.run results out of rank order: {out}")
    return out


# -- a ray of spawned actors --------------------------------------------------

def actor_main(cls, cmd_q, res_q):
    import traceback

    obj = cls()
    while True:
        msg = cmd_q.get()
        if msg is None:
            return
        seq, name, args, kwargs = msg
        try:
            res_q.put((seq, "ok", getattr(obj, name)(*args, **kwargs)))
        except BaseException:  # noqa: BLE001 - reported to the caller
            res_q.put((seq, "err", traceback.format_exc()))


class FakeActor:
    """An actor in a spawned process; method calls and results travel by
    stdlib pickle over its queues."""

    def __init__(self, cls):
        ctx = torch.multiprocessing.get_context("spawn")
        self._cmd, self._res = ctx.Queue(), ctx.Queue()
        self._done, self._seq = {}, 0
        self._proc = ctx.Process(target=actor_main,
                                 args=(cls, self._cmd, self._res))
        self._proc.start()

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        actor = self

        class Method:
            @staticmethod
            def remote(*args, **kwargs):
                actor._seq += 1
                actor._cmd.put((actor._seq, name, args, kwargs))
                return (actor, actor._seq)

        return Method()

    def _result(self, seq, timeout):
        while seq not in self._done:
            got, status, value = self._res.get(timeout=timeout
                                               or INT_TIMEOUT_S)
            self._done[got] = (status, value)
        status, value = self._done.pop(seq)
        if status != "ok":
            raise AssertionError(f"actor call failed:\n{value}")
        return value

    def _kill(self):
        self._cmd.put(None)
        self._proc.join(30)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join(10)


def fake_ray() -> dict:
    """The modules ``horovod_tpu_torch.ray`` imports: ``ray.remote`` makes
    spawned actors, ``ray.get`` waits for their results, a placement
    group is always ready."""

    class Remote:
        def __init__(self, cls):
            self._cls = cls

        def options(self, **kwargs):
            return self

        def remote(self):
            return FakeActor(self._cls)

    def get(obj, timeout=None):
        if isinstance(obj, list):
            return [get(o, timeout) for o in obj]
        if isinstance(obj, tuple):
            return obj[0]._result(obj[1], timeout)
        return obj

    pg = fake_module("ray.util.placement_group",
                     placement_group=lambda bundles, strategy="PACK":
                     type("PG", (), {"ready": lambda self: "ready"})(),
                     remove_placement_group=lambda pg: None)
    util = fake_module("ray.util", placement_group=pg)
    ray = fake_module("ray", remote=lambda **kw: Remote, get=get,
                      kill=lambda actor: actor._kill(),
                      get_gpu_ids=lambda: [], util=util,
                      nodes=lambda: [{"Alive": True,
                                      "NodeManagerHostname": "localhost",
                                      "Resources": {"CPU": 2.0}}])
    return {"ray": ray, "ray.util": util, "ray.util.placement_group": pg}


def ray_trainer(seed):
    """One Ray worker: ``ef_trainer`` (the world-2 error-feedback trainer,
    int8 ring, K1 and K3) at GPT_SMALL's width, ``RAY_LAYERS`` blocks,
    ``RAY_STEPS`` steps."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import GPT, GPT_SMALL, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import quantize as qz

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init(device="cuda:0")
    try:
        rank = hvd.rank()
        rep = ef_trainer(hvd, fa, qz, GPT, GPT_SMALL, lm_loss, seed, rank,
                         seq=INT_SEQ, layers=RAY_LAYERS, steps=RAY_STEPS)
        return {"rank": rank, "size": hvd.size(),
                "local_rank": hvd.local_rank(), **rep}
    finally:
        hvd.shutdown()


def ray_executor(seed, gpu_operations) -> list:
    from horovod_tpu_torch.ray import RayExecutor

    with patched(fake_ray(), world2_env(gpu_operations)):
        ex = RayExecutor(num_workers=2)
        ex.start()
        try:
            out = ex.run(ray_trainer, args=[seed])
        finally:
            ex.shutdown()
    if [r["rank"] for r in out] != [0, 1] or any(r["size"] != 2
                                                 for r in out):
        raise AssertionError(f"RayExecutor results out of rank order: "
                             f"{[(r['rank'], r['size']) for r in out]}")
    return out


def elastic_ray_trainer(seed):
    """One worker of ``ElasticRayExecutor``: plain ``DistributedOptimizer
    (AdamW)`` steps of GPT at GPT_SMALL's width and ``RAY_LAYERS``
    blocks, each rank on its own batch."""
    import dataclasses

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import GPT, GPT_SMALL, lm_loss
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import quantize as qz

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init(device="cuda:0")
    try:
        rank, dev = hvd.rank(), hvd.device()
        cfg = dataclasses.replace(GPT_SMALL, num_layers=RAY_LAYERS)
        torch.manual_seed(seed)
        model = GPT(cfg).to(dev)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=INT_LR),
            named_parameters=model.named_parameters())
        gen = torch.Generator(device=dev).manual_seed(seed + 60 + rank)
        ids = torch.randint(0, cfg.vocab_size, (4, INT_SEQ), generator=gen,
                            device=dev)
        fa.reset_launch_counts()
        qz.reset_launch_counts()
        per_step, losses, step_s = [], [], []
        for _ in range(RAY_STEPS):
            before = {**fa.LAUNCHES, **qz.LAUNCHES}
            t0 = time.perf_counter()
            opt.zero_grad()
            loss = lm_loss(model(ids), ids)
            loss.backward()
            opt.step()
            losses.append(hvd.allreduce(loss.detach()).item())
            step_s.append(time.perf_counter() - t0)
            now = {**fa.LAUNCHES, **qz.LAUNCHES}
            per_step.append({k: now[k] - before[k] for k in now})
        return {"rank": rank, "size": hvd.size(), "losses": losses,
                "step_s": step_s, "launches_per_step": per_step,
                "launches": {**fa.LAUNCHES, **qz.LAUNCHES},
                "digest": params_digest(model),
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    finally:
        hvd.shutdown()


def elastic_ray(seed, gpu_operations) -> list:
    """``ElasticRayExecutor(min_np=2, max_np=2)`` over ``localhost:2``:
    the elastic driver runs ``elastic_ray_trainer`` through ``python -m
    horovod_tpu_torch.runner._exec_fn``; the function is this script's,
    taken from the importable module ``chip_smoke``, so it travels by
    reference where there is no cloudpickle."""
    import importlib
    import tempfile

    from horovod_tpu_torch.ray import ElasticRayExecutor
    from horovod_tpu_torch.runner.elastic_driver import FixedHosts

    repo = os.path.dirname(os.path.abspath(__file__))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    trainer = importlib.import_module("chip_smoke").elastic_ray_trainer
    env = {**world2_env(gpu_operations),
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    cwd = os.getcwd()
    work = tempfile.mkdtemp(prefix="hvd_elastic_ray_")
    try:
        os.chdir(work)
        with patched(fake_ray(), env):
            ex = ElasticRayExecutor(
                min_np=2, max_np=2,
                override_discovery=FixedHosts({"localhost": 2}))
            out = ex.run(trainer, args=[seed])
    finally:
        os.chdir(cwd)
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    out.sort(key=lambda r: r["rank"])
    if [r["rank"] for r in out] != [0, 1]:
        raise AssertionError(f"ElasticRayExecutor results: {out}")
    if len({r["digest"] for r in out}) != 1 or out[0]["losses"] != \
            out[1]["losses"]:
        raise AssertionError("the elastic Ray ranks' parameters or losses "
                             "differ")
    want = {k: 0 for k in out[0]["launches_per_step"][0]}
    want.update(flash_fwd=RAY_LAYERS, flash_bwd_dq=RAY_LAYERS,
                flash_bwd_dkv=RAY_LAYERS)
    for r in out:
        if any(step != want for step in r["launches_per_step"]):
            raise AssertionError(f"rank {r['rank']}: launches "
                                 f"{r['launches_per_step']}, expected "
                                 f"{want} a step")
        if not all(v == v and abs(v) < float("inf") for v in r["losses"]):
            raise AssertionError(f"non-finite loss {r['losses']}")
    return out


INTEGRATION_PARTS = {
    "estimator_world1": {"model": "GPT_SMALL", "world": 1,
                         "backend": "local", "sequences": INT_SEQS,
                         "seq": INT_SEQ, "batch": INT_BATCH_W1,
                         "steps": INT_STEPS},
    "estimator_spark": {"model": "GPT_SMALL", "world": 2, "backend": "spark",
                        "num_proc": 2, "batch_per_rank": INT_BATCH_W2,
                        "steps": INT_STEPS},
    "spark_prefetch": {"world": 2, "sequences": PREFETCH_SEQS,
                       "batch": PREFETCH_BATCH},
    "ray_executor": {"model": "GPT_SMALL width", "world": 2,
                     "layers": RAY_LAYERS, "steps": RAY_STEPS,
                     "device_compression": "int8"},
    "elastic_ray": {"model": "GPT_SMALL width", "world": 2,
                    "layers": RAY_LAYERS, "steps": RAY_STEPS},
}


def integrations_phase(hvd, fa, seed, gpu_operations, card="") -> dict:
    """The estimator at world 1 (the slice's main path), then the world-2
    parts on the one card: the spark estimator, ``spark.run`` of the
    prefetch task, ``RayExecutor`` and ``ElasticRayExecutor``.  Prints a
    line for each part as it ends."""
    import shutil
    import tempfile

    out, seconds = {}, {}
    tmp = tempfile.mkdtemp(prefix="hvd_integrations_")
    try:
        parts = {
            "estimator_world1": lambda: estimator_world1(
                hvd, fa, seed, os.path.join(tmp, "w1")),
            "estimator_spark": lambda: estimator_spark(
                seed, os.path.join(tmp, "w2"), gpu_operations),
            "spark_prefetch": lambda: spark_prefetch(seed, gpu_operations),
            "ray_executor": lambda: ray_executor(seed, gpu_operations),
            "elastic_ray": lambda: elastic_ray(seed, gpu_operations)}
        for name, part in parts.items():
            t0 = time.perf_counter()
            out[name] = part()
            seconds[name] = round(time.perf_counter() - t0, 3)
            torch.cuda.empty_cache()
            world2 = ({} if name == "estimator_world1" else {
                "gpu_operations": gpu_operations,
                "note": "two ranks share one card over gloo staged through "
                        "the host: times are not a speed result"})
            print(json.dumps({"phase": "integrations", "part": name,
                              **INTEGRATION_PARTS[name], **world2,
                              "card": card, "seconds": seconds[name],
                              "result": out[name]}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = seconds
    return out


INTEGRATIONS_TIMEOUT_S = 900


def integrations_child(seed, gpu_operations, card, queue):
    """:func:`integrations_phase` in a spawned process of its own (its
    environment and working-directory changes stay there); its lines,
    captured, its result and its seconds go back through ``queue``."""
    import contextlib
    import io
    import traceback

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    lines = io.StringIO()
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.ops import flash_attention as fa

        with contextlib.redirect_stdout(lines):
            out, secs = timed_phase(integrations_phase, hvd, fa, seed,
                                    gpu_operations, card)
        queue.put({"lines": lines.getvalue(), "result": out,
                   "seconds": secs})
    except BaseException:
        queue.put({"lines": lines.getvalue(),
                   "error": traceback.format_exc()})


class IntegrationsRun:
    """The integrations phase in a spawned process, started by the
    constructor, so ``main`` runs the world-2 phases meanwhile (none of
    its times is a speed result); :meth:`result` waits for it, prints its
    lines and returns its result and seconds."""

    def __init__(self, seed, gpu_operations, card):
        ctx = torch.multiprocessing.get_context("spawn")
        self.results = ctx.Queue()
        self.proc = ctx.Process(target=integrations_child,
                                args=(seed, gpu_operations, card,
                                      self.results))
        self.proc.start()

    def kill(self):
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(10)

    def result(self) -> tuple:
        import queue as queue_mod

        try:
            rep = self.results.get(timeout=INTEGRATIONS_TIMEOUT_S)
        except queue_mod.Empty:
            raise AssertionError(f"integrations: no result in "
                                 f"{INTEGRATIONS_TIMEOUT_S} s") from None
        finally:
            self.proc.join(60)
            self.kill()
        print(rep["lines"], end="", flush=True)
        if "error" in rep:
            raise AssertionError(f"integrations failed:\n{rep['error']}")
        return rep["result"], rep["seconds"]


# ---------------------------------------------------------------------------
# The compiler data plane: GPT-2 small on DTensor under torch.compile.
# ---------------------------------------------------------------------------

PLANE_STEPS = 3
# GPT_SMALL's full width, 4 of its 12 blocks: Inductor compiles each block
# on its own, so the compile (184-266 s a rank at 12 blocks) shrinks with
# the depth, and it loads the host under the world-2 and elastic phases.
PLANE_LAYERS = 4
PLANE_BATCH = 8            # sequences a step, Shard(0): 4 a rank
PLANE_SEQ = 1024
PLANE_LR = 3e-4
PLANE_TIMEOUT_S = 900
# AdamW is the fused one (``fused=True``, one multi-tensor kernel, on both
# planes): under torch.compile the compiled step calls it as it is, where
# the per-parameter foreach arithmetic of 149 parameters is Inductor's to
# trace and generate, tens of seconds of each rank's compile.
# The compiled step against the eager replay: ||update difference|| /
# ||update|| over all parameters.  The gradients differ by bf16 rounding
# in another fusion order, which flips Adam's sign-like first updates
# where |g| is that small.  The largest element difference is reported
# and held to nothing: Adam bounds every element's update by about lr a
# step on any gradients, so a planted fault stays under that bound too.
# Read with ``chip_plane_faults.py`` on an NVIDIA H100 80GB HBM3 at 700 W
# at 4 blocks: the sound run 0.0248, rank 1 training on rank 0's shard
# 0.736, the embeddings stepped on unreduced gradients 0.446 (at 12
# blocks: 0.0406, 0.844, 0.347).  The limit lies between them, at least
# 3x from each side.  The first step's loss, the same weights and tokens
# through both forwards, to 1e-2 relative.
PLANE_UPDATE_READINGS = {"sound": 0.0248, "dup_shard": 0.736,
                         "unreduced_embeddings": 0.446}
PLANE_UPDATE_RTOL = 0.12
PLANE_LOSS_RTOL = 1e-2


def plane_config():
    """The phase's model: GPT_SMALL's width at ``PLANE_LAYERS`` blocks."""
    import dataclasses

    from horovod_tpu_torch.models import GPT_SMALL

    return dataclasses.replace(GPT_SMALL, num_layers=PLANE_LAYERS)


def plane_tokens(seed) -> torch.Tensor:
    """Every step's global batch of token ids, ``[steps, 8, 1024]``."""
    from horovod_tpu_torch.models import GPT_SMALL

    gen = torch.Generator().manual_seed(seed + 12)
    return torch.randint(0, GPT_SMALL.vocab_size,
                         (PLANE_STEPS, PLANE_BATCH, PLANE_SEQ),
                         generator=gen)


def plane_rank(rank, port, seed, gpu_operations, cache, queue):
    """One of two ranks of the compiled-plane phase on ``cuda:0``; both
    keep Inductor's and Triton's caches in ``cache``."""
    import traceback

    os.environ.update(
        TORCHINDUCTOR_CACHE_DIR=os.path.join(cache, "inductor"),
        TRITON_CACHE_DIR=os.path.join(cache, "triton"),
        HOROVOD_RANK=str(rank), HOROVOD_SIZE="2", HOROVOD_LOCAL_RANK=str(rank),
        HOROVOD_LOCAL_SIZE="2", HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
        HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
        HOROVOD_GLOO_TIMEOUT_SECONDS="600", HOROVOD_SHM_DISABLE="1",
        HOROVOD_GPU_OPERATIONS=gpu_operations)
    for var in ("HOROVOD_WIRE_COMPRESSION", "HOROVOD_DATA_PLANE",
                "HOROVOD_HLO_INSPECT"):
        os.environ.pop(var, None)
    try:
        queue.put(plane_work(rank, seed))
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


def plane_params(model) -> dict:
    """Each parameter's values on the host (a replicated DTensor's local
    copy)."""
    return {n: getattr(p, "_local_tensor", p).detach().float().cpu()
            for n, p in model.named_parameters()}


def plane_compiled(hvd, fa, qz, seed, rank, tokens) -> tuple:
    """The phase model's parameters replicated as DTensors on the plane's
    mesh, the batch ``Shard(0)``, ``DistributedOptimizer(AdamW,
    plane="gspmd")`` and ``PLANE_STEPS`` steps of
    ``hlo_inspect.instrument(step)`` over Inductor.  Returns the report and
    the final parameters."""
    from torch.distributed.tensor import DTensor, Shard, distribute_module

    from horovod_tpu_torch.context import HorovodContext
    from horovod_tpu_torch.models import GPT, lm_loss
    from horovod_tpu_torch.ops import gspmd_plane as gp
    from horovod_tpu_torch.ops import hlo_inspect as hi

    dev = hvd.device()
    gp.reset_plane_counters()
    hi.reset()
    core = HorovodContext.instance().core
    before_stats = core.data_plane_stats()
    torch.manual_seed(seed)
    model = GPT(plane_config()).to(dev)
    mesh = gp.build_gspmd_mesh()
    distribute_module(model, mesh)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=PLANE_LR, fused=True),
        named_parameters=model.named_parameters(), plane="gspmd")

    def step(ids):
        loss = lm_loss(model(ids), ids)
        loss.backward()
        opt.step()
        opt.zero_grad()
        return loss

    cstep = hi.instrument(step, label="gpt_small_gspmd_step")
    per = PLANE_BATCH // 2
    losses, seconds, launches = [], [], []
    breakdown = None
    torch.cuda.reset_peak_memory_stats()
    for i in range(PLANE_STEPS):
        ids = DTensor.from_local(
            tokens[i, rank * per:(rank + 1) * per].to(dev), mesh, [Shard(0)],
            run_check=False)
        torch.cuda.synchronize()
        before = kernel_launches(fa, qz)
        t0 = time.perf_counter()
        if i == PLANE_STEPS - 1:
            box = []
            breakdown = profile_step(lambda: box.append(cstep(ids)))
            loss = box[0]
        else:
            loss = cstep(ids)
        value = loss.full_tensor().item()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches.append({n: c - before[n]
                         for n, c in kernel_launches(fa, qz).items()})
        losses.append(value)
        print(json.dumps({"phase": "compiled_plane", "rank": rank,
                          "step": i, "seconds": seconds[-1],
                          "loss": value}), flush=True)
        # A negotiated collective closes step-trace records, each stamped
        # with the plane tag the step's optimizer left.
        hvd.allreduce(torch.tensor([value], device=dev), name=f"plane.{i}")
    plane_tags = [row[-1] for row in hvd.step_trace().get("steps") or []]
    peak = torch.cuda.max_memory_allocated()
    invs = hi.inventories()
    stats = core.data_plane_stats()
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    report = {
        "compile_and_first_step_s": seconds[0],
        "step_s": seconds[1:-1], "profiled_step_s": seconds[-1],
        "losses": losses, "launches": launches, "plane_tags": plane_tags,
        "peak_mem_gb": peak / 2 ** 30,
        "plane_counters": gp.plane_counters(),
        "inventories": [{k: v for k, v in inv.to_dict().items()
                         if k != "ops"} for inv in invs],
        "inventory_ops_sample": [op.to_dict() for op in
                                 (invs[0].ops[:2] if invs else [])],
        "gspmd_raw": stats["gspmd_raw"] - before_stats["gspmd_raw"],
        "gspmd_wire": stats["gspmd_wire"] - before_stats["gspmd_wire"],
        "param_bytes": param_bytes,
        "ring_wire_bytes": sum(hi.ring_wire_bytes(op.kind, op.raw_bytes, 2)
                               for inv in invs for op in inv.ops),
        "compile_seconds_by_stage": compile_stages(),
        "breakdown": breakdown}
    if rank == 0:
        report["hlo_report"] = plane_hlo_report(hvd, hi)
    params = plane_params(model)
    del model, opt, cstep
    torch._dynamo.reset()
    return report, params


def plane_hlo_report(hvd, hi) -> dict:
    """The compiled step's graph code and ``hvd.metrics()`` saved to a
    directory, and the port's ``hlo_report`` over them with ``--metrics``:
    its exit code and totals."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="hvd_graphs_") as td:
        t0 = time.perf_counter()
        paths = hi.write_graphs(td, "gpt_small_gspmd_step")
        metrics = os.path.join(td, "metrics.json")
        with open(metrics, "w") as f:
            json.dump(hvd.metrics(), f)
        written = time.perf_counter() - t0
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.tools.hlo_report",
             *paths, "--metrics", metrics, "--json"],
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        sizes = sum(os.path.getsize(p) for p in paths)
    out = {"rc": proc.returncode, "files": len(paths), "file_bytes": sizes,
           "write_s": round(written, 3),
           "report_s": round(time.perf_counter() - t0 - written, 3)}
    try:
        res = json.loads(proc.stdout)
    except json.JSONDecodeError:
        out["error"] = (proc.stdout + proc.stderr)[-3000:]
        return out
    kinds = {}
    for trace in res.get("traces", []):
        for kind, n in trace["kinds"].items():
            kinds[kind] = kinds.get(kind, 0) + n
    out.update(metrics_match=res.get("metrics_match"), kinds=kinds,
               collectives=sum(t["collectives"] for t in res["traces"]),
               raw_bytes=sum(t["raw_bytes"] for t in res["traces"]),
               wire_bytes=sum(t["wire_bytes"] for t in res["traces"]))
    if proc.returncode:
        out["error"] = proc.stderr[-3000:]
    return out


def compile_stages() -> dict:
    """Seconds ``torch.compile`` spent by stage, summed over its calls."""
    from torch._dynamo.utils import compilation_time_metrics

    return {name: round(sum(times), 3)
            for name, times in compilation_time_metrics.items()}


def plane_eager(hvd, seed, rank, tokens) -> tuple:
    """The same steps on the eager plane: plain tensors, the hooks,
    ``plane="eager"``, each rank its half of every batch."""
    from horovod_tpu_torch.models import GPT, lm_loss

    dev = hvd.device()
    torch.manual_seed(seed)
    model = GPT(plane_config()).to(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=PLANE_LR, fused=True),
        named_parameters=model.named_parameters(), plane="eager")
    per = PLANE_BATCH // 2
    losses, seconds = [], []
    for i in range(PLANE_STEPS):
        ids = tokens[i, rank * per:(rank + 1) * per].to(dev)
        t0 = time.perf_counter()
        loss = lm_loss(model(ids), ids)
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(hvd.allreduce(loss.detach(),
                                    name=f"plane.eager.{i}").item())
        seconds.append(time.perf_counter() - t0)
    params = plane_params(model)
    del model, opt
    return {"losses": losses, "step_s": seconds}, params


def plane_compare(compiled, eager, init) -> dict:
    """The compiled run's parameters against the eager replay's: the
    largest element difference and ||update difference|| / ||update||."""
    max_abs, diff2, upd2 = 0.0, 0.0, 0.0
    for name, want in eager.items():
        got = compiled[name]
        d = (got - want).abs()
        max_abs = max(max_abs, float(d.max()))
        diff2 += float((d.double() ** 2).sum())
        upd2 += float(((want - init[name]).double() ** 2).sum())
    return {"max_abs": max_abs, "update_rel": (diff2 / upd2) ** 0.5}


def plane_work(rank, seed) -> dict:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.context import HorovodContext
    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import quantize as qz

    tokens = plane_tokens(seed)
    torch.manual_seed(seed)
    init = plane_params(GPT(plane_config()))
    hvd.init(device="cuda:0")
    try:
        if HorovodContext.instance().core.name != "native":
            raise AssertionError("the plane ran without the native core")
        compiled, got = plane_compiled(hvd, fa, qz, seed, rank, tokens)
        torch.cuda.empty_cache()
        eager, want = plane_eager(hvd, seed, rank, tokens)
    finally:
        hvd.shutdown()
    return {"rank": rank, "compiled": compiled, "eager": eager,
            "vs_eager": plane_compare(got, want, init),
            "params_digest": digest(torch.cat(
                [got[n].reshape(-1) for n in sorted(got)]))}


def check_plane(rep, layers: int) -> None:
    """Every check of one rank's compiled run (module constants)."""
    c = rep["compiled"]
    want = {n: layers if n in FLASH_CATEGORIES else 0
            for n in c["launches"][0]}
    for i, rose in enumerate(c["launches"]):
        if rose != want:
            raise AssertionError(f"rank {rep['rank']} compiled step {i}: "
                                 f"launches {rose}, expected {want}")
    if len(c["inventories"]) != 1:
        raise AssertionError(f"rank {rep['rank']}: {len(c['inventories'])} "
                             "inventories, expected one")
    inv = c["inventories"][0]
    if set(inv["kinds"]) != {"all-reduce"} or inv["world"] != 2:
        raise AssertionError(f"inventory kinds {inv['kinds']} at world "
                             f"{inv['world']}")
    if inv["raw_bytes"] != c["param_bytes"] or \
            inv["wire_bytes"] != c["ring_wire_bytes"]:
        raise AssertionError(f"inventory bytes {inv['raw_bytes']} raw, "
                             f"{inv['wire_bytes']} wire; parameters "
                             f"{c['param_bytes']}, ring model "
                             f"{c['ring_wire_bytes']}")
    if (c["gspmd_raw"], c["gspmd_wire"]) != (inv["raw_bytes"],
                                             inv["wire_bytes"]):
        raise AssertionError(f"data_plane_stats gspmd {c['gspmd_raw']}, "
                             f"{c['gspmd_wire']} against the inventory")
    if c["plane_counters"] != {"gspmd": 1}:
        raise AssertionError(f"plane counters {c['plane_counters']}")
    if not c["plane_tags"] or set(c["plane_tags"]) != {1}:
        raise AssertionError(f"step-trace plane tags {c['plane_tags']}")
    losses = c["losses"] + rep["eager"]["losses"]
    if not all(abs(x) < float("inf") for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if abs(c["losses"][0] - rep["eager"]["losses"][0]) > \
            PLANE_LOSS_RTOL * abs(rep["eager"]["losses"][0]):
        raise AssertionError(f"first losses {c['losses'][0]} compiled, "
                             f"{rep['eager']['losses'][0]} eager")
    cmp = rep["vs_eager"]
    if cmp["update_rel"] > PLANE_UPDATE_RTOL:
        raise AssertionError(f"parameters against the eager replay {cmp}, "
                             f"limit {PLANE_UPDATE_RTOL}")


def check_plane_report(rep) -> None:
    """The port's ``hlo_report`` over rank 0's saved graphs: exit 0, the
    ``--metrics`` cross-check matched, and its totals the phase's
    inventory and ``data_plane_stats()``'s gspmd bytes."""
    c = rep["compiled"]
    inv, h = c["inventories"][0], c["hlo_report"]
    want = {"rc": 0, "metrics_match": True,
            "collectives": inv["collectives"], "kinds": inv["kinds"],
            "raw_bytes": inv["raw_bytes"], "wire_bytes": inv["wire_bytes"]}
    if {k: h.get(k) for k in want} != want or \
            (h["raw_bytes"], h["wire_bytes"]) != (c["gspmd_raw"],
                                                  c["gspmd_wire"]):
        raise AssertionError(f"hlo_report over the saved graphs {h}, "
                             f"expected {want} and data_plane_stats "
                             f"{c['gspmd_raw']}, {c['gspmd_wire']}")


def plane_world1(hvd, seed, steps=2, batch=8, seq=1024) -> dict:
    """World 1 over NCCL: ``plane="gspmd"`` counts ``demote_world1`` and
    trains bitwise as ``plane="eager"`` does."""
    from horovod_tpu_torch.models import GPT, GPT_SMALL, lm_loss
    from horovod_tpu_torch.ops import gspmd_plane as gp

    hvd.init()
    try:
        dev = hvd.device()
        gen = torch.Generator().manual_seed(seed + 13)
        ids = torch.randint(0, GPT_SMALL.vocab_size, (batch, seq),
                            generator=gen).to(dev)
        digests, counters = {}, {}
        for plane in ("gspmd", "eager"):
            gp.reset_plane_counters()
            torch.manual_seed(seed)
            model = GPT(GPT_SMALL).to(dev)
            opt = hvd.DistributedOptimizer(
                torch.optim.AdamW(model.parameters(), lr=PLANE_LR, fused=True),
                named_parameters=model.named_parameters(), plane=plane)
            counters[plane] = gp.plane_counters()
            for _ in range(steps):
                lm_loss(model(ids), ids).backward()
                opt.step()
                opt.zero_grad()
            digests[plane] = digest(torch.cat(
                [p.detach().reshape(-1).float()
                 for p in model.parameters()]))
            del model, opt
            torch.cuda.empty_cache()
    finally:
        hvd.shutdown()
    if counters != {"gspmd": {"demote_world1": 1}, "eager": {}}:
        raise AssertionError(f"world-1 plane counters {counters}")
    if digests["gspmd"] != digests["eager"]:
        raise AssertionError("world-1 gspmd request differs from eager")
    return {"counters": counters, "bitwise": True,
            "digest": digests["eager"]}


class CompiledPlane:
    """The ``compiled_plane`` phase: the world-1 demotion in this process,
    then two ranks on ``cuda:0`` (gloo: NCCL refuses two ranks on one
    card) running the compiled gspmd plane and its eager replay, started
    by the constructor; :meth:`result` waits for them and makes every
    check of :func:`check_plane`, and both ranks' final parameters must be
    bitwise equal.  Their compile is mostly host work, so ``main`` runs
    the world-2, elastic and matrix phases meanwhile."""

    def __init__(self, hvd, seed, gpu_operations):
        import tempfile

        self.t0 = time.perf_counter()
        self.world1, seconds = timed_phase(plane_world1, hvd, seed)
        self.world1["seconds"] = seconds
        self.cache = tempfile.mkdtemp(prefix="hvd_plane_")
        self.pair = RankPair(plane_rank, (seed, gpu_operations, self.cache))

    def result(self) -> tuple:
        import shutil

        try:
            reports, codes = self.pair.collect(PLANE_TIMEOUT_S)
        finally:
            shutil.rmtree(self.cache, ignore_errors=True)
        for rep in reports.values():
            if "error" in rep:
                raise AssertionError(f"compiled-plane rank {rep['rank']} "
                                     f"failed:\n{rep['error']}")
        if codes != [0, 0]:
            raise AssertionError(f"compiled-plane exit codes {codes}")
        for rep in reports.values():
            check_plane(rep, PLANE_LAYERS)
        check_plane_report(reports[0])
        if reports[0]["params_digest"] != reports[1]["params_digest"]:
            raise AssertionError("the ranks' compiled parameters differ")
        return ({"world1": self.world1, "ranks": [reports[0], reports[1]]},
                round(time.perf_counter() - self.t0, 3))


def integration_launches(res, name) -> dict:
    """A kernel's launches on each integration path (per rank where there
    are two)."""
    return {"estimator_world1": res["estimator_world1"]["launches"][name],
            "estimator_spark": [r["launches"][name]
                                for r in res["estimator_spark"]["ranks"]],
            "ray_executor": [r["launches"][name]
                             for r in res["ray_executor"]],
            "elastic_ray": [r["launches"][name] for r in res["elastic_ray"]]}


def plane_launches(res, name) -> list:
    """A kernel's launches in each compiled-plane step, per rank."""
    return [[step[name] for step in rep["compiled"]["launches"]]
            for rep in res["ranks"]]


def print_plane(plane, secs, gpu_operations, card, beside) -> None:
    """The ``compiled_plane`` phase's lines."""
    print(json.dumps({"phase": "compiled_plane", "part": "world1_demotion",
                      "model": "GPT_SMALL", "card": card,
                      **plane["world1"]}), flush=True)
    for rep in plane["ranks"]:
        print(json.dumps({"phase": "compiled_plane", "part": "world2",
                          "model": "GPT_SMALL", "layers": PLANE_LAYERS,
                          "batch": PLANE_BATCH,
                          "seq": PLANE_SEQ, "steps": PLANE_STEPS,
                          "gpu_operations": gpu_operations,
                          "tolerances": {"loss_rtol": PLANE_LOSS_RTOL,
                                         "update_rtol": PLANE_UPDATE_RTOL},
                          "note": "two ranks share one card over gloo "
                                  f"staged through the host{beside}: times "
                                  "are not a speed result",
                          "card": card, "seconds": secs, **rep}),
              flush=True)


def eager_example_phase() -> dict:
    """``examples/eager_device_plane`` at world 1 on the card through its
    entry point: the device plane served every gradient exchange."""
    from horovod_tpu_torch.examples import eager_device_plane as ex

    out = ex.main([])
    stats, params = out["device_plane"], list(out["model"].parameters())
    if stats["allreduce"] + stats["identity"] <= 0 or \
            stats["host_fallback"]:
        raise AssertionError(f"eager example device plane {stats}")
    if not all(p.is_cuda and bool(torch.isfinite(p).all())
               for p in params):
        raise AssertionError("eager example parameters off the card or "
                             "not finite")
    return {"steps": ex.STEPS, "device_plane": stats,
            "params_device": str(params[0].device)}


# The bench_tools phase: the port's benchmark tools through their entry
# points.
BENCH_MB = 16                   # the microbenchmark's defaults
BENCH_ITERS = 20
MICRO_OPS = ("allreduce", "allgather", "alltoall", "reducescatter",
             "broadcast")
BENCH_NP = 4
BENCH_CODEC = "int8"
BENCH_SCHEDULE = "bidi"
BENCH_DEVICE_MB = 4.0           # bench_negotiation's --device-mb default
BENCH_ARGS = ["--np", str(BENCH_NP), "--steps", "60", "--tensors", "50",
              "--device-codec", BENCH_CODEC, "--device-schedule",
              BENCH_SCHEDULE]
BENCH_TIMEOUT_S = 600
# The reference's encoded-to-raw ratios (docs/benchmarks.md): a property
# of each codec, so the card must read the same to three decimals.
CODEC_RATIOS = {"int8": 0.254, "int4": 0.129, "int8g": 0.251}
# The cache's bar on the announce bytes (tests/parallel/
# test_negotiation_cache.py: under half without the cache).
ANNOUNCE_RATIO_BAR = 0.5


def bench_codec_ratio(codec, schedule, world=BENCH_NP,
                      mb=BENCH_DEVICE_MB) -> float:
    """The device codec's encoded-to-raw ratio in one quantized allreduce
    of the section's per-rank tensor, padded as the device plane pads
    it."""
    from horovod_tpu_torch.ops import quantize as qz
    from horovod_tpu_torch.ops.device_plane import bucket_len

    per_rank = (int(mb * (1 << 20)) // 4) // world
    raw, enc = qz.ring_bytes(bucket_len(per_rank), world, codec, schedule)
    return round(enc / raw, 3)


def micro_lines(text: str) -> dict:
    """The microbenchmark's lines, ``{op: (MiB/s, plane, size)}``, from
    its output (the launcher's rank prefix allowed)."""
    import re

    out = {}
    for m in re.finditer(r"^(?:\[\d+\]<stdout>: ?)?(\w+) +([0-9.]+) MiB/s "
                         r"\((\w+) plane, size=(\d+)\)$", text, re.M):
        out[m.group(1)] = (float(m.group(2)), m.group(3), int(m.group(4)))
    return out


def bench_env() -> dict:
    """The environment of the tools' jobs of more ranks than cards: every
    rank on ``cuda:0`` over gloo, one Inductor compile thread a rank."""
    env = dict(os.environ)
    env.update(HOROVOD_GPU_OPERATIONS="GLOO", HOROVOD_CUDA_DEVICE="0",
               TORCHINDUCTOR_COMPILE_THREADS="1",
               HOROVOD_GLOO_TIMEOUT_SECONDS="300",
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__))
               + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def micro_world1() -> dict:
    """(a) The microbenchmark's eager plane at world 1 over NCCL, in this
    process: every op an identity on the device plane, no host fallback,
    every output on the card and exact."""
    from horovod_tpu_torch.examples import microbenchmark as mb

    out = mb.main(["--plane", "eager", "--mb", str(BENCH_MB), "--iters",
                   str(BENCH_ITERS)])
    stats = out["device_plane"]
    calls = len(MICRO_OPS) * (BENCH_ITERS + 1)
    if stats["host_fallback"] or stats["identity"] != calls:
        raise AssertionError(f"microbenchmark world 1: device plane {stats}, "
                             f"expected {calls} identities")
    for op, t in out["outputs"].items():
        if not (t.is_cuda and bool((t == 1).all())):
            raise AssertionError(f"microbenchmark world 1: {op} output on "
                                 f"{t.device}, not all ones")
    return {"mib_per_s": out["mib_per_s"], "device_plane": stats,
            "outputs_device": sorted({str(t.device)
                                      for t in out["outputs"].values()})}


def micro_world2(plane, tmpdir, started=None) -> dict:
    """(b) The microbenchmark at ``-np 2`` through the port's launcher,
    both ranks on ``cuda:0`` over gloo: rank 0 prints one line an op."""
    rc, out, err, secs = run_launcher(
        ["-np", "2", sys.executable, "-m",
         "horovod_tpu_torch.examples.microbenchmark", "--plane", plane,
         "--mb", str(BENCH_MB), "--iters", str(BENCH_ITERS)],
        bench_env(), BENCH_TIMEOUT_S,
        os.path.join(tmpdir, f"micro_{plane}.log"), started=started)
    lines = micro_lines(out)
    want = MICRO_OPS if plane == "eager" else MICRO_OPS[:4]
    if rc != 0 or sorted(lines) != sorted(want) or any(
            (p, s) != (plane, 2) for _, p, s in lines.values()):
        raise AssertionError(f"microbenchmark -np 2 --plane {plane}: exit "
                             f"{rc}, lines {lines}\n{out[-3000:]}\n"
                             f"{err[-3000:]}")
    return {"mib_per_s": {op: v[0] for op, v in lines.items()},
            "seconds": round(secs, 3)}


def check_bench_negotiation(lines: list, world: int = BENCH_NP) -> dict:
    """The negotiation tool's lines: three configurations and the cache's
    summary under its bar; the device codec's baseline untouched, each
    rank's K1-K3 launches in its one call the ring's, its ratio the
    codec's and its error inside the ring's bound."""
    by = {ln.get("config") or ln.get("metric"): ln for ln in lines}
    for name in ("cache_on", "cache_off", "fusion_off"):
        if name not in by:
            raise AssertionError(f"bench_negotiation: no {name} line")
    summary = by["negotiation_cache_speedup"]
    if not summary["announce_bytes_ratio_on_vs_off"] < ANNOUNCE_RATIO_BAR:
        raise AssertionError(f"bench_negotiation: announce ratio {summary}")
    base = by["device_none"]
    comp = by[f"device_{BENCH_CODEC}_{BENCH_SCHEDULE}"]
    idle = {"quant_int8": 0, "quant_int4": 0, "dequant": 0}
    if base["device_raw_bytes_per_step"] or \
            base["launches"] != [idle] * world:
        raise AssertionError(f"bench_negotiation: baseline {base}")
    want = [expected_launches("allreduce", BENCH_CODEC, BENCH_SCHEDULE, r,
                              world=world) for r in range(world)]
    if comp["launches"] != want:
        raise AssertionError(f"bench_negotiation: K1-K3 launches "
                             f"{comp['launches']}, expected {want}")
    codec = by["device_codec"]
    ratio = bench_codec_ratio(BENCH_CODEC, BENCH_SCHEDULE, world)
    if not (codec["device_encoded_vs_raw_ratio"] == ratio
            == CODEC_RATIOS[BENCH_CODEC]):
        raise AssertionError(f"bench_negotiation: ratio {codec}, analytic "
                             f"{ratio}")
    if not codec["max_abs_err"] <= codec["max_abs_err_bound"]:
        raise AssertionError(f"bench_negotiation: error {codec}")
    if not all(ln.get("shared_card") for ln in lines):
        raise AssertionError("bench_negotiation: a line of a job on the one "
                             "card does not say so")
    return {"lines": lines, "launches": comp["launches"]}


def bench_negotiation(tmpdir) -> dict:
    """(c) ``bench_negotiation`` through its command line, alone on the
    host: its lines, checked."""
    rc, out, err, secs = run_launcher(
        BENCH_ARGS, bench_env(), BENCH_TIMEOUT_S,
        os.path.join(tmpdir, "bench_negotiation.log"),
        module="horovod_tpu_torch.tools.bench_negotiation")
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    if rc != 0:
        raise AssertionError(f"bench_negotiation exit {rc}:\n{out[-3000:]}"
                             f"\n{err[-3000:]}")
    try:
        res = check_bench_negotiation(lines)
    except AssertionError as e:
        raise AssertionError(f"{e}\nlines: {json.dumps(lines)}") from None
    res["seconds"] = round(secs, 3)
    return res


def bench_tools_phase() -> dict:
    """(a), then (c), with nothing beside them: the cache's announce bytes
    a step grow with the step's idle negotiation cycles, which a loaded
    host multiplies."""
    import shutil
    import tempfile

    world1, secs = timed_phase(micro_world1)
    world1["seconds"] = secs
    tmpdir = tempfile.mkdtemp(prefix="hvd_bench_")
    try:
        negotiation = bench_negotiation(tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return {"micro_world1": world1, "negotiation": negotiation}


class MicroWorld2:
    """(b), both planes one after the other, in a thread started by the
    constructor, so ``main`` runs another phase meanwhile; :meth:`result`
    waits for them."""

    def __init__(self):
        import tempfile
        import threading

        self.tmp = tempfile.mkdtemp(prefix="hvd_micro_")
        self.proc, self.killed, self.out = None, False, {}
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _started(self, proc):
        self.proc = proc
        if self.killed:
            self.kill()

    def _run(self):
        try:
            for plane in ("eager", "jit"):
                if self.killed:
                    return
                self.out[plane] = micro_world2(plane, self.tmp,
                                               started=self._started)
        except BaseException as e:  # re-raised by result()
            self.out["error"] = e

    def kill(self):
        import signal

        self.killed = True
        if self.proc is not None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except OSError:
                pass

    def result(self) -> dict:
        import shutil

        self.thread.join(2 * BENCH_TIMEOUT_S + 60)
        shutil.rmtree(self.tmp, ignore_errors=True)
        if self.thread.is_alive():
            self.kill()
            raise AssertionError("the microbenchmark's -np 2 runs did not "
                                 "end in time")
        if "error" in self.out:
            raise self.out["error"]
        return self.out


# The kill callables of the phases ``main`` left running in the background
# (the compiled plane's ranks, the matrix's rows), called when it returns
# or raises.
_BACKGROUND: list = []

# The matrix phase's rows run this many at once; each rank is a process
# that reaches the card in about 8 s.
MATRIX_JOBS = 4
MATRIX_TIMEOUT_S = 300


def matrix_expected(axes: dict, rank: int) -> dict:
    """K1-K3 launches of a qdev row's one quantized allreduce on
    ``rank``."""
    from horovod_tpu_torch.ops.collectives import resolve_device_schedule

    codec, _, sched = axes["qdev"].partition(":")
    return expected_launches(
        "allreduce", codec, resolve_device_schedule(axes["np"],
                                                    sched or "auto"),
        rank, world=axes["np"])


class MatrixRun:
    """The card rows of the port's configuration matrix, through its
    command line, started by the constructor; :meth:`result` waits for
    them: every row must pass and the qdev rows' K1-K3 launches must be
    the ring's.  The rows are separate processes with their own counters,
    so ``main`` runs the elastic phase meanwhile."""

    def __init__(self):
        import tempfile

        self.t0 = time.perf_counter()
        self.tmp = tempfile.mkdtemp(prefix="hvd_matrix_")
        self.path = os.path.join(self.tmp, "matrix.json")
        self.log = open(os.path.join(self.tmp, "matrix.log"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.tools.test_matrix",
             "--quick", "--card", "--device", "cuda", "--jobs",
             str(MATRIX_JOBS), "--timeout", str(MATRIX_TIMEOUT_S),
             "--report", self.path],
            stdout=self.log, stderr=subprocess.STDOUT, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)

    def result(self) -> tuple:
        import shutil

        try:
            try:
                rc = self.proc.wait(MATRIX_TIMEOUT_S + 120)
            except subprocess.TimeoutExpired:
                self.kill()
                raise AssertionError("test_matrix did not end in time")
            self.log.seek(0)
            out = self.log.read()
            if rc != 0 or not os.path.exists(self.path):
                raise AssertionError(f"test_matrix exit {rc}:\n{out[-6000:]}")
            with open(self.path) as f:
                rep = json.load(f)
        finally:
            self.log.close()
            shutil.rmtree(self.tmp, ignore_errors=True)
        rows, launches = [], {}
        for row in rep["rows"]:
            axes = row["axes"]
            entry = {"row": row["row"], "ok": row["ok"],
                     "seconds": round(row["seconds"], 3), "np": axes["np"],
                     "device_plane": [r["device_plane"]
                                      for r in row["ranks"]]}
            if axes["qdev"] != "off":
                got = [r["qdev_launches"] for r in row["ranks"]]
                want = [matrix_expected(axes, r) for r in range(axes["np"])]
                if got != want:
                    raise AssertionError(f"matrix row {row['row']}: K1-K3 "
                                         f"launches {got}, expected {want}")
                entry.update(launches=got,
                             bytes=[r["qdev_bytes"] for r in row["ranks"]],
                             err_and_bound=[r["qdev_err"]
                                            for r in row["ranks"]])
                launches[axes["qdev"]] = got
            rows.append(entry)
        if len(rows) != 6 or not all(r["ok"] for r in rows):
            raise AssertionError(f"matrix rows {rows}")
        return ({"rows": rows, "launches": launches},
                round(time.perf_counter() - self.t0, 3))


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
    from horovod_tpu_torch.runner import _pickling

    # Which carrier the run API, spark.run and ElasticRayExecutor use here.
    print(json.dumps({"cloudpickle": _pickling.cloudpickle_version()}),
          flush=True)

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
    eager, secs = timed_phase(eager_example_phase)
    print(json.dumps({"phase": "eager_example", "model": "MLP",
                      "world": 1, "card": card, "seconds": secs, **eager}),
          flush=True)
    bench, secs = timed_phase(bench_tools_phase)
    neg = bench["negotiation"]
    print(json.dumps({"phase": "bench_tools", "part": "microbenchmark",
                      "world": 1, "mb": BENCH_MB, "iters": BENCH_ITERS,
                      "card": card, **bench["micro_world1"]}), flush=True)
    print(json.dumps({"phase": "bench_tools", "part": "bench_negotiation",
                      "args": BENCH_ARGS, "seconds": neg["seconds"],
                      "launches": neg["launches"], "card": card}),
          flush=True)
    for line in neg["lines"]:
        print(json.dumps({"phase": "bench_tools", "part": "bench_negotiation",
                          **line}), flush=True)
    print(json.dumps({"phase": "bench_tools", "part": "alone",
                      "seconds": secs}), flush=True)

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
    nccl, _ = spawn_pair(nccl_pair_rank, (), 300)
    # NCCL whenever it takes two ranks on one card; gloo on the card only
    # when both ranks were refused.
    gpu_operations = ("GLOO" if not any(a["accepted"] for a in nccl.values())
                      else "NCCL")
    print(json.dumps({"phase": "nccl_two_ranks_one_card",
                      "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                      "answers": [nccl[r] for r in sorted(nccl)],
                      "world2_gpu_operations": gpu_operations}), flush=True)
    # The compiled-plane ranks compile (host work, minutes) while the
    # world-2 phases and the elastic jobs run, none of them a speed result.
    compiled = CompiledPlane(hvd, args.seed, gpu_operations)
    _BACKGROUND.append(compiled.pair.kill)
    # The integrations (Spark, Ray: host work) run beside the world-2
    # phases too.
    integrations = IntegrationsRun(args.seed, gpu_operations, card)
    _BACKGROUND.append(integrations.kill)
    (rank0, rank1), secs = timed_phase(world2_phase, args.seed,
                                       gpu_operations)
    for rep in (rank0, rank1):
        print(json.dumps({"phase": "world2", "model": "GPT_SMALL",
                          "batch_per_rank": 4, "seq": 1024,
                          "note": "two ranks share one card: step times "
                                  "are not a speed result",
                          "beside": "compiled_plane, integrations",
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
                          "beside": "compiled_plane, integrations",
                          "card": card, "seconds": secs, **rep}), flush=True)
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
                          "beside": "compiled_plane, integrations",
                          "card": card, "seconds": secs, **rep}), flush=True)
    torch.cuda.empty_cache()
    cnn2, secs = timed_phase(cnn_world2_phase, args.seed, gpu_operations)
    print(json.dumps({"phase": "cnn_world2", "model": "resnet50",
                      "batch_per_rank": CNN_W2_BATCH,
                      "gpu_operations": gpu_operations,
                      "note": "two ranks share one card over gloo staged "
                              "through the host: step times are not a "
                              "speed result", "beside": "compiled_plane, integrations",
                      "card": card, "seconds": secs, **cnn2}), flush=True)
    torch.cuda.empty_cache()
    par, secs = timed_phase(parallel_phase, args.seed, gpu_operations)
    for rep in par["ranks"]:
        print(json.dumps({"phase": "parallel", "part": "ranks",
                          "gpt": {"model": "GPT_SMALL", "sp": 2,
                                  "batch": PAR_BATCH, "seq": PAR_SEQ},
                          "bert": {"model": "BERT_LARGE", "sp": 2,
                                   "layers": BERT_SP_LAYERS,
                                   "batch": BERT_SP_BATCH,
                                   "seq": BERT_SP_SEQ},
                          "gpu_operations": gpu_operations,
                          "note": "two ranks share one card over gloo "
                                  "staged through the host: times are not "
                                  "a speed result",
                          "beside": "compiled_plane, integrations",
                          "card": card, "seconds": secs, **rep}),
              flush=True)
    print(json.dumps({"phase": "parallel", "part": "replay",
                      "card": card, **par["replay"]}), flush=True)
    integ, secs = integrations.result()
    print(json.dumps({"phase": "integrations", "part": "total",
                      "seconds": secs, "parts": integ["seconds"],
                      "beside": "the world-2 phases and compiled_plane"}),
          flush=True)
    torch.cuda.empty_cache()
    # The matrix's rows run beside the elastic jobs; they count their
    # launches in their own processes.
    matrix_run = MatrixRun()
    _BACKGROUND.append(matrix_run.kill)
    ela, secs = timed_phase(elastic_phase, args.seed, gpu_operations)
    for label, run in ela["runs"].items():
        print(json.dumps({"phase": "elastic", "part": label,
                          "model": "GPT_SMALL", "world": 2,
                          "batch_per_rank": ELASTIC_BATCH,
                          "seq": ELASTIC_SEQ, "steps": ELASTIC_STEPS,
                          "layers": ELASTIC_LAYERS,
                          "kill_step": ELASTIC_KILL_STEP if label == "killed"
                          else None,
                          "gpu_operations": gpu_operations,
                          "note": "two ranks share one card over gloo "
                                  "staged through the host, beside the "
                                  "other elastic job, the compiled-plane "
                                  "phase's ranks and the matrix's rows: "
                                  "times are not a speed result",
                          "card": card, **run}), flush=True)
    print(json.dumps({"phase": "elastic", "part": "compare", "card": card,
                      "seconds": secs,
                      "vs_uninterrupted_max_abs":
                          ela["vs_uninterrupted_max_abs"],
                      "vs_uninterrupted_tol": ela["vs_uninterrupted_tol"],
                      "vs_uninterrupted_bitwise":
                          ela["vs_uninterrupted_bitwise"]}),
          flush=True)
    matrix, secs = matrix_run.result()
    for row in matrix["rows"]:
        print(json.dumps({"phase": "matrix", "card": card, **row}),
              flush=True)
    print(json.dumps({"phase": "matrix", "part": "total", "seconds": secs,
                      "jobs": MATRIX_JOBS, "rows": len(matrix["rows"]),
                      "beside": "elastic"}), flush=True)
    plane, plane_secs = compiled.result()
    print_plane(plane, plane_secs, gpu_operations, card,
                ", beside the world-2, elastic and matrix phases' ranks")
    torch.cuda.empty_cache()
    # The microbenchmark's two ranks run beside the fleet's three: no time
    # of either is a speed result, and the fleet waits out its windows.
    micro = MicroWorld2()
    _BACKGROUND.append(micro.kill)
    fleet, secs = timed_phase(fleet_phase, args.seed, gpu_operations)
    print(json.dumps({"phase": "fleet", "model": "GPT_SMALL",
                      "world": FLEET_WORLD, "hosts": FLEET_HOSTS,
                      "batch_per_rank": FLEET_BATCH, "seq": FLEET_SEQ,
                      "delay_ms_rank2": FLEET_DELAY_MS,
                      "sentence_s": FLEET_SENTENCE_S, "env": FLEET_ENV,
                      "gpu_operations": gpu_operations,
                      "note": "three ranks share one card over gloo staged "
                              "through the host: times are not a speed "
                              "result",
                      "card": card, "phase_seconds": secs, **fleet}),
          flush=True)
    for micro_plane, run in micro.result().items():
        print(json.dumps({"phase": "bench_tools", "part": "microbenchmark",
                          "world": 2, "plane": micro_plane, "mb": BENCH_MB,
                          "iters": BENCH_ITERS, "gpu_operations": "GLOO",
                          "note": "two ranks share one card over gloo "
                                  "staged through the host, beside the "
                                  "fleet phase's ranks: not a speed result",
                          "card": card, **run}), flush=True)
    elastic_launches = ela["runs"]["killed"]["launches"]
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
            "launches_world2_ef_trainer": ef["launches"][name],
            "launches_parallel_gpt_sp_per_step": [
                r["gpt"]["steps"][0]["launches"][name]
                for r in par["ranks"]],
            "launches_parallel_bert_sp_per_step": [
                r["bert"]["steps"][0]["launches"][name]
                for r in par["ranks"]],
            "launches_elastic": elastic_launches[name],
            "launches_fleet": fleet["launches"][name],
            "launches_integrations": integration_launches(integ, name),
            "launches_compiled_plane_per_step": plane_launches(plane,
                                                               name)})
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
                extras0["collectives"]["launches"][name],
            "launches_parallel": [r["layers"]["launches"][name]
                                  for r in par["ranks"]],
            "launches_elastic": elastic_launches[name],
            "launches_fleet": fleet["launches"][name],
            "launches_integrations": integration_launches(integ, name),
            "launches_compiled_plane_per_step": plane_launches(plane,
                                                               name),
            "launches_matrix": {row: [rank[name] for rank in ranks]
                                for row, ranks in
                                matrix["launches"].items()},
            "launches_bench_negotiation": [rank[name] for rank in
                                           neg["launches"]]})
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        for kill in _BACKGROUND:
            kill()
