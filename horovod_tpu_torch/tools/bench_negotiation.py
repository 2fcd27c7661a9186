"""Steady-state negotiation benchmark over the port: response cache on vs
off vs fusion off at np=4, the port of ``tools/bench_negotiation.py``.

Measures, per configuration:
- steady-state cycle throughput (gradient-bucket steps/s, 50 named
  64-element fp32 tensors per step on the rank's device, the
  DistributedOptimizer eager shape), and
- negotiation ctrl-channel bytes per step on a worker rank (cache hits
  travel as 16-byte (id, handle) pairs; misses re-serialize the full
  request metadata every cycle).

Usage: python -m horovod_tpu_torch.tools.bench_negotiation [--np 4]
       [--steps 60] [--device cuda|cpu]
Prints one JSON line per configuration plus a summary ratio line.  Every
job starts through the port's ``runner.run``.  The optional sections are
the reference's, under the same flags, keys and lines:

- ``--wire-compression {bf16,int8,int4,int8g}``: a large fp32 allreduce
  over two fake hosts with the hierarchical plane (so the codec engages on
  the cross-host leader ring): cross-host wire bytes/step against the fp32
  baseline and the max abs error the codec introduced.  The buffers are
  numpy arrays on the core's host ring on every device, by design (the
  reference measures the host ring), so its lines say ``"device": "cpu"``.
- ``--device-codec {int8,int4,int8g}`` / ``--device-schedule
  {auto,ring,bidi,torus}``: ``--np`` ranks, one device each (the
  reference's forced 8-device host platform), allreduce (Sum) one
  ``--device-mb`` fp32 tensor a step through the device plane's quantized
  ring under ``HOROVOD_WIRE_COMPRESSION=device=<codec>`` and
  ``HOROVOD_DEVICE_SCHEDULE``, against the uncompressed plane: the
  encoded-vs-raw ratio from ``ops/quantize.device_byte_counters()`` over
  the warm-up call (one step), the error against the fp64 sum beside the
  ring's bound (``quantize.ring_error_bound``), and each rank's K1-K3
  launches in that call (non-zero on the card only).
- ``--data-plane``: one SGD step of the elementwise model ``mean((x*w -
  y)^2)``, ``w`` of ``--device-mb`` fp32 and a batch of ``2*world``, under
  the eager plane (plain tensors, the grad-hook ``DistributedOptimizer``)
  vs the gspmd plane (``w`` a replicated DTensor, the batch ``Shard(0)``
  on ``gspmd_plane.build_gspmd_mesh()``, ``DistributedOptimizer(plane=
  "gspmd")``, the step through ``hlo_inspect.instrument`` over Inductor
  on the card and ``aot_eager`` on the CPU), interleaved best-of-3, on
  the ``--np`` ranks; the gspmd leg's inventory is stamped as ``hlo``.
- ``--hlo-inspect``: the gspmd leg with HOROVOD_HLO_INSPECT=0 vs 1,
  interleaved best-of-3.
- ``--metrics``, ``--flight-recorder``, ``--step-trace``,
  ``--fleet-telemetry``: the cache_on workload under HOROVOD_METRICS=1,
  HOROVOD_FLIGHT_RECORDER, HOROVOD_STEP_TRACE (plus a leg with metrics),
  HOROVOD_FLEET_TELEMETRY over metrics on; the last three interleaved
  best-of-3.
- ``--np-sweep N,N,...`` (alone): coordinator control messages and bytes
  per cycle, flat vs the auto-depth tree vs the tree forced three levels
  deep (at 3 fake hosts or more), over ``max(2, np // 4)`` fake hosts with
  HOROVOD_SHM_DISABLE=1.

Devices: ``--device cuda`` (the default) puts each rank on its card and
raises when there is none.  A job of more ranks than the host has cards
puts every rank on card 0 over gloo (``HOROVOD_GPU_OPERATIONS=GLOO``,
``HOROVOD_CUDA_DEVICE=0``: NCCL refuses two ranks on one card), and every
line it prints says ``"shared_card": true``: its times are not a speed
result.  ``--device cpu`` runs every rank on the CPU over gloo.  A job
that fails, a card job whose device plane fell back to the host ring, or a
device baseline that touched the codec ends the tool with a non-zero exit.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Elements of each negotiated tensor (the reference's).
TENSOR_ELEMS = 64
# Best-of rounds of the interleaved overhead sections.
BEST_OF = 3


# ---------------------------------------------------------------------------
# Jobs and devices
# ---------------------------------------------------------------------------

def shares_card(device: str, np_: int) -> bool:
    """Whether a job of ``np_`` ranks on ``device`` puts them all on card 0
    (more ranks than the host has cards)."""
    if device == "cpu":
        return False
    import torch

    return np_ > torch.cuda.device_count()


def job_env(device: str, np_: int, env: Optional[dict] = None) -> dict:
    """The environment a job's ranks get beside the caller's."""
    full = {"PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             "")}
    if shares_card(device, np_):
        full.update(HOROVOD_GPU_OPERATIONS="GLOO", HOROVOD_CUDA_DEVICE="0",
                    # Inductor compiles in each rank's process: one thread
                    # a rank, as the ranks share the host.
                    TORCHINDUCTOR_COMPILE_THREADS="1")
    full.update(env or {})
    return full


def device_keys(device: str, np_: int) -> dict:
    """The keys every line of a job carries: where its ranks ran."""
    shared = shares_card(device, np_)
    return {"device": "cuda:0" if shared else device, "shared_card": shared}


def run_job(fn: Callable, args: tuple, np_: int, device: str,
            env: Optional[dict] = None) -> list:
    """``fn(*args, rank_device)`` on ``np_`` ranks through the port's
    ``runner.run``; per-rank results in rank order."""
    from horovod_tpu_torch.runner import run

    rank_device = "cpu" if device == "cpu" else None  # None: the rank's card
    return run(fn, args=args + (rank_device,), np=np_,
               env=job_env(device, np_, env), stream_prefix=False)


def emit(lines: list, obj: dict) -> dict:
    print(json.dumps(obj), flush=True)
    lines.append(obj)
    return obj


# ---------------------------------------------------------------------------
# Rank-side helpers
# ---------------------------------------------------------------------------

def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _check_no_fallback() -> None:
    """A card collective demoted to the host ring fails the job."""
    from horovod_tpu_torch.context import HorovodContext

    stats = HorovodContext.instance().device_plane.stats
    if stats["host_fallback"]:
        raise RuntimeError(f"device plane fell back to the host ring: "
                           f"{dict(stats)}")


# ---------------------------------------------------------------------------
# Negotiation: cache on / off / fusion off and the overhead sections
# ---------------------------------------------------------------------------

def _worker(steps: int, tensors: int, device):
    import time

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import mpi_ops
    from horovod_tpu_torch.context import HorovodContext

    hvd.init(device=device)
    dev = hvd.device()
    grads = [torch.full((TENSOR_ELEMS,), float(i), device=dev)
             for i in range(tensors)]

    def step():
        hs = [mpi_ops.allreduce_async(g, name=f"grad.{i}", op=hvd.Sum)
              for i, g in enumerate(grads)]
        for h in hs:
            mpi_ops.synchronize(h)

    # Warmup: populate the response cache / reach steady state.
    for _ in range(5):
        step()
    core = HorovodContext.instance().core
    stats0 = core.negotiation_stats() if hasattr(core, "negotiation_stats") \
        else None
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    _sync(dev)
    dt = time.perf_counter() - t0
    result = {"rank": hvd.rank(), "steps_per_s": steps / dt,
              "tensor_ops_per_s": steps * len(grads) / dt}
    if stats0 is not None:
        stats1 = core.negotiation_stats()
        # Announce direction (worker -> coordinator): where the cache's
        # (id, handle) pairs replace full request metadata.  The recv
        # direction is the response list, identical in both configs.
        result["announce_bytes_per_step"] = (
            (stats1["ctrl_sent"] - stats0["ctrl_sent"]) / steps)
        result["ctrl_bytes_per_step"] = (
            (stats1["ctrl_sent"] + stats1["ctrl_recv"]
             - stats0["ctrl_sent"] - stats0["ctrl_recv"]) / steps)
    _check_no_fallback()
    hvd.shutdown()
    return result


def run_config(name: str, env: dict, np_: int, steps: int, tensors: int,
               device: str, lines: list) -> dict:
    results = run_job(_worker, (steps, tensors), np_, device, env)
    agg = {
        "config": name,
        "np": np_,
        "steps_per_s": round(min(r["steps_per_s"] for r in results), 2),
        "tensor_ops_per_s": round(
            min(r["tensor_ops_per_s"] for r in results), 1),
    }
    per_step = [r.get("ctrl_bytes_per_step") for r in results[1:]]
    if per_step and per_step[0] is not None:
        # Worker ranks only: the coordinator's ctrl traffic counts every
        # worker's frames and would double-book.
        agg["worker_ctrl_bytes_per_step"] = round(max(per_step), 1)
        agg["worker_announce_bytes_per_step"] = round(
            max(r["announce_bytes_per_step"] for r in results[1:]), 1)
    return emit(lines, {**agg, **device_keys(device, np_)})


def cache_summary(cache_on: dict, cache_off: dict, fusion_off: dict) -> dict:
    summary = {
        "metric": "negotiation_cache_speedup",
        "steps_ratio_cache_on_vs_off": round(
            cache_on["steps_per_s"] / cache_off["steps_per_s"], 3),
        "steps_ratio_cache_on_vs_fusion_off": round(
            cache_on["steps_per_s"] / fusion_off["steps_per_s"], 3),
    }
    if "worker_ctrl_bytes_per_step" in cache_on and \
            "worker_ctrl_bytes_per_step" in cache_off:
        summary["ctrl_bytes_ratio_on_vs_off"] = round(
            cache_on["worker_ctrl_bytes_per_step"]
            / max(cache_off["worker_ctrl_bytes_per_step"], 1.0), 3)
        summary["announce_bytes_ratio_on_vs_off"] = round(
            cache_on["worker_announce_bytes_per_step"]
            / max(cache_off["worker_announce_bytes_per_step"], 1.0), 3)
    return summary


def overhead(metric: str, off: List[dict], on: List[dict],
             both: Optional[List[dict]] = None) -> dict:
    """An overhead line from each leg's rows: the best steps/s of each leg
    (the fastest, least-perturbed run bounds its true cost), their ratio
    and the overhead in percent.  ``best_of`` is stamped where a leg ran
    more than once, as the reference's interleaved sections do."""
    best_off = max([0.0] + [r["steps_per_s"] for r in off])
    best_on = max([0.0] + [r["steps_per_s"] for r in on])
    ratio = best_on / max(best_off, 1e-9)
    out = {"metric": metric}
    if len(off) > 1:
        out["best_of"] = len(off)
    out["steps_ratio_on_vs_off"] = round(ratio, 3)
    out["overhead_pct"] = round(max(0.0, (1.0 - ratio)) * 100.0, 2)
    if both is not None:
        best_both = max([0.0] + [r["steps_per_s"] for r in both])
        out["steps_ratio_with_metrics_vs_off"] = round(
            best_both / max(best_off, 1e-9), 3)
    return out


def interleaved(legs: dict, np_: int, steps: int, tensors: int, device: str,
                lines: list) -> dict:
    """``legs`` ({tag: (config prefix, env)}) run in turns, ``BEST_OF``
    rounds: loopback wall clock is noisier than the effects measured, so
    each leg keeps all of its rows for the best-of."""
    rows: dict = {tag: [] for tag in legs}
    for i in range(BEST_OF):
        for tag, (prefix, env) in legs.items():
            rows[tag].append(run_config(f"{prefix}_r{i}", env, np_, steps,
                                        tensors, device, lines))
    return rows


# ---------------------------------------------------------------------------
# Host wire codec over two fake hosts
# ---------------------------------------------------------------------------

def _wire_worker(steps: int, elems: int, device):
    import time

    import numpy as np

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.context import HorovodContext

    hvd.init(device=device)
    r, s = hvd.rank(), hvd.size()
    # numpy buffers: the core's host ring on every device.
    x = ((np.arange(elems) % 251) + r).astype(np.float32)
    exact = sum(((np.arange(elems) % 251) + rr).astype(np.float64)
                for rr in range(s))
    core = HorovodContext.instance().core
    hvd.allreduce(x, op=hvd.Sum, name="wb.warm")
    hvd.barrier()
    s0 = core.data_plane_stats()
    max_err = 0.0
    t0 = time.perf_counter()
    for i in range(steps):
        out = np.asarray(hvd.allreduce(x, op=hvd.Sum, name=f"wb.{i}"),
                         dtype=np.float64)
        max_err = max(max_err, float(np.max(np.abs(out - exact))))
    dt = time.perf_counter() - t0
    s1 = core.data_plane_stats()
    hvd.barrier()
    hvd.shutdown()
    return {"rank": r, "steps_per_s": steps / dt, "max_abs_err": max_err,
            "xhost_bytes_per_step":
                (s1["data_sent_xhost"] - s0["data_sent_xhost"]) / steps,
            "raw_xhost_bytes_per_step":
                (s1["data_raw_xhost"] - s0["data_raw_xhost"]) / steps}


def run_wire_config(codec: str, np_: int, steps: int, elems: int,
                    device: str, lines: list) -> dict:
    env = {"HOROVOD_HIER_FAKE_HOSTS": "2",
           "HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
           "HOROVOD_WIRE_COMPRESSION": codec}
    results = run_job(_wire_worker, (steps, elems), np_, device, env)
    agg = {
        "config": f"wire_{codec}",
        "np": np_,
        "payload_bytes": elems * 4,
        "steps_per_s": round(min(r["steps_per_s"] for r in results), 2),
        "xhost_bytes_per_step": round(
            sum(r["xhost_bytes_per_step"] for r in results), 1),
        "raw_xhost_bytes_per_step": round(
            sum(r["raw_xhost_bytes_per_step"] for r in results), 1),
        "max_abs_err": max(r["max_abs_err"] for r in results),
    }
    return emit(lines, {**agg, "device": "cpu",
                        "shared_card": shares_card(device, np_)})


def wire_summary(codec: str, base: dict, comp: dict) -> dict:
    return {
        "metric": "wire_compression",
        "codec": codec,
        "xhost_bytes_ratio_vs_fp32": round(
            comp["xhost_bytes_per_step"]
            / max(base["xhost_bytes_per_step"], 1.0), 3),
        "wire_vs_raw_ratio": round(
            comp["xhost_bytes_per_step"]
            / max(comp["raw_xhost_bytes_per_step"], 1.0), 3),
        "max_abs_err": comp["max_abs_err"],
        "steps_ratio_vs_fp32": round(
            comp["steps_per_s"] / max(base["steps_per_s"], 1e-9), 3),
    }


# ---------------------------------------------------------------------------
# The device plane's quantized ring
# ---------------------------------------------------------------------------

def device_input(world: int, elems: int):
    """The reference's input, one row a rank: ``world`` x ``elems //
    world`` fp32 in [-0.5, 0.5)."""
    import numpy as np

    per_dev = max(1, elems // world)
    return (((np.arange(world * per_dev) % 509) / 509.0 - 0.5)
            .astype(np.float32).reshape(world, per_dev))


def _device_worker(steps: int, elems: int, device):
    import time

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.ops.quantize as qz

    hvd.init(device=device)
    dev, r = hvd.device(), hvd.rank()
    x_np = device_input(hvd.size(), elems)
    exact = np.sum(x_np.astype(np.float64), axis=0)
    x = torch.from_numpy(x_np[r].copy()).to(dev)

    # One call's ring volume and kernel launches: the warm-up's.
    qz.reset_device_byte_counters()
    launches0 = dict(qz.LAUNCHES)
    out = hvd.allreduce(x, op=hvd.Sum, name="dq").cpu().numpy()
    launches = {k: qz.LAUNCHES[k] - launches0[k] for k in launches0}
    raw, enc = qz.device_byte_counters()
    max_err = float(np.max(np.abs(out.astype(np.float64) - exact)))

    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        hvd.allreduce(x, op=hvd.Sum, name="dq")
    _sync(dev)
    dt = time.perf_counter() - t0
    _check_no_fallback()
    hvd.shutdown()
    return {"steps_per_s": steps / dt, "max_abs_err": max_err,
            "device_raw_bytes_per_step": raw,
            "device_encoded_bytes_per_step": enc, "launches": launches}


def run_device_config(codec: str, steps: int, elems: int, np_: int,
                      device: str, lines: list,
                      schedule: Optional[str] = None) -> dict:
    env = {"HOROVOD_WIRE_COMPRESSION_MIN_BYTES": "4096"}
    if codec != "none":
        env["HOROVOD_WIRE_COMPRESSION"] = f"device={codec}"
    if schedule:
        env["HOROVOD_DEVICE_SCHEDULE"] = schedule
    results = run_job(_device_worker, (steps, elems), np_, device, env)
    agg = dict(results[0])
    name = f"device_{codec}" + (f"_{schedule}" if schedule else "")
    agg.update({"config": name, "np": np_, "payload_bytes": elems * 4,
                "steps_per_s": round(min(r["steps_per_s"]
                                         for r in results), 2),
                "max_abs_err": max(r["max_abs_err"] for r in results),
                "launches": [r["launches"] for r in results],
                **device_keys(device, np_)})
    return emit(lines, agg)


def device_error_bound(codec: str, np_: int, elems: int,
                       schedule: Optional[str]) -> float:
    """The quantized ring's bound on the Sum's error for this section's
    input, with fp32 rounding of the sum beside it."""
    import numpy as np

    from horovod_tpu_torch.ops import quantize as qz
    from horovod_tpu_torch.ops.collectives import resolve_device_schedule

    big_x = float(np.abs(device_input(np_, elems)).max())
    sched = resolve_device_schedule(np_, schedule or "auto")
    return (qz.ring_error_bound(codec, np_, big_x, sched)
            + 1e-6 * np_ * big_x)


def device_summary(codec: str, schedule: Optional[str], base: dict,
                   comp: dict, bound: float) -> dict:
    if base["device_raw_bytes_per_step"] != 0:
        raise RuntimeError("baseline must not touch the device codec")
    return {
        "metric": "device_codec",
        "codec": codec,
        "schedule": schedule or "auto",
        "device_encoded_vs_raw_ratio": round(
            comp["device_encoded_bytes_per_step"]
            / max(comp["device_raw_bytes_per_step"], 1.0), 3),
        "max_abs_err": comp["max_abs_err"],
        "max_abs_err_bound": bound,
        "steps_ratio_vs_fp32": round(
            comp["steps_per_s"] / max(base["steps_per_s"], 1e-9), 3),
    }


# ---------------------------------------------------------------------------
# Eager vs gspmd data planes
# ---------------------------------------------------------------------------

def _plane_worker(steps: int, elems: int, plane: str, device):
    import time

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import gspmd_plane as gp
    from horovod_tpu_torch.ops import hlo_inspect as hi

    hvd.init(device=device)
    dev, n, r = hvd.device(), hvd.size(), hvd.rank()

    # One SGD step on an elementwise model: the weight vector IS the
    # collective payload (elems fp32), the batch is sharded n ways.  An
    # elementwise (not matmul) backward keeps the comparison about the
    # planes.
    d = max(8, elems)
    batch = 2 * n
    rs = np.random.RandomState(0)
    x_np = rs.randn(batch, d).astype(np.float32)
    y_np = rs.randn(batch, d).astype(np.float32)
    mine = slice(2 * r, 2 * (r + 1))

    if plane == "gspmd":
        from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                              distribute_tensor)

        # gspmd convention: a replicated parameter, batch-sharded inputs,
        # global-mean loss -- DTensor inserts the gradient reduction.
        mesh = gp.build_gspmd_mesh()
        w = torch.nn.Parameter(distribute_tensor(
            torch.zeros(d, device=dev), mesh, [Replicate()]))

        def put(a):
            return DTensor.from_local(torch.from_numpy(a[mine]).to(dev),
                                      mesh, [Shard(0)], run_check=False)
    else:
        # eager convention: plain tensors, each rank its rows, the hooks
        # average the gradient.
        w = torch.nn.Parameter(torch.zeros(d, device=dev))

        def put(a):
            return torch.from_numpy(a[mine].copy()).to(dev)

    x, y = put(x_np), put(y_np)
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.01),
                                   named_parameters=[("w", w)], plane=plane)

    def step(xs, ys):
        loss = ((xs * w - ys) ** 2).mean()
        loss.backward()
        opt.step()
        opt.zero_grad()
        return loss

    if plane == "gspmd":
        # Compiled-collective introspection rides the warmup compile (once
        # per signature).  With HOROVOD_HLO_INSPECT=0 ``instrument``
        # returns ``step`` unchanged, and the --hlo-inspect baseline is the
        # same step compiled without the recorder.
        backend = "inductor" if dev.type == "cuda" else "aot_eager"
        inspected = hi.instrument(step, label="bench_plane", backend=backend)
        step = (torch.compile(step, backend=backend) if inspected is step
                else inspected)

    step(x, y)  # compile outside the timed loop
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        step(x, y)
    _sync(dev)
    dt = time.perf_counter() - t0
    _check_no_fallback()
    hvd.shutdown()
    res = {"steps_per_s": steps / dt, "plane": plane, "grad_bytes": d * 4}
    invs = [i for i in hi.inventories() if i.label == "bench_plane"]
    if invs:
        # Provenance: the collectives the compiled step holds (none when
        # introspection is off or the plane resolved eager).
        inv = invs[-1]
        res["hlo"] = {"collectives": inv.collectives,
                      "kinds": inv.kind_counts(),
                      "raw_bytes": inv.raw_bytes,
                      "wire_bytes": inv.wire_bytes}
    return res


def run_plane_config(plane: str, steps: int, elems: int, np_: int,
                     device: str, lines: list, extra_env=None,
                     tag: str = "") -> dict:
    results = run_job(_plane_worker, (steps, elems, plane), np_, device,
                      extra_env)
    agg = dict(results[0])
    agg.update({"config": f"plane_{plane}{tag}", "np": np_,
                "steps_per_s": round(min(r["steps_per_s"]
                                         for r in results), 2),
                **device_keys(device, np_)})
    return emit(lines, agg)


def plane_summary(eager: List[dict], gspmd: List[dict]) -> dict:
    best_eager = max([0.0] + [r["steps_per_s"] for r in eager])
    best_gspmd = max([0.0] + [r["steps_per_s"] for r in gspmd])
    hlo = None
    for g in gspmd:
        hlo = g.get("hlo") or hlo
    return {
        "metric": "data_plane",
        "best_of": len(eager),
        "steps_ratio_gspmd_vs_eager": round(
            best_gspmd / max(best_eager, 1e-9), 3),
        "step_time_ratio_gspmd_vs_eager": round(
            best_eager / max(best_gspmd, 1e-9), 3),
        # Compiled-collective provenance for the gspmd leg (None on a
        # HOROVOD_HLO_INSPECT=0 run).
        "hlo": hlo,
    }


# ---------------------------------------------------------------------------
# Control-plane scaling sweep
# ---------------------------------------------------------------------------

def _sweep_worker(steps: int, tensors: int, device):
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import mpi_ops

    hvd.init(device=device)
    dev = hvd.device()
    grads = [torch.full((TENSOR_ELEMS,), float(i), device=dev)
             for i in range(tensors)]

    def step():
        hs = [mpi_ops.allreduce_async(g, name=f"sw.{i}", op=hvd.Sum)
              for i, g in enumerate(grads)]
        for h in hs:
            mpi_ops.synchronize(h)

    for _ in range(5):  # steady state: response cache populated
        step()
    hvd.barrier()
    c0 = hvd.metrics()["counters"]
    for _ in range(steps):
        step()
    hvd.barrier()
    c1 = hvd.metrics()["counters"]
    rank = hvd.rank()
    _check_no_fallback()
    hvd.shutdown()
    return {"rank": rank,
            "cycles": c1["cycle_count"] - c0["cycle_count"],
            "msgs_recv": c1["ctrl_msgs_recv"] - c0["ctrl_msgs_recv"],
            "msgs_sent": c1["ctrl_msgs_sent"] - c0["ctrl_msgs_sent"],
            "bytes_recv": c1["ctrl_bytes_recv"] - c0["ctrl_bytes_recv"],
            "bytes_sent": c1["ctrl_bytes_sent"] - c0["ctrl_bytes_sent"]}


def run_np_sweep(np_list, steps: int, tensors: int, device: str,
                 lines: list) -> None:
    """Coordinator control messages + bytes per cycle -- flat vs the
    auto-depth tree vs the tree forced three levels deep -- at each job
    size over fake hosts (4 consecutive ranks per host).  The lockstep
    makes messages/cycle a topology constant -- (np-1) flat,
    (local-1)+(hosts-1) for the two-level tree, (local-1)+direct-children
    once a super layer absorbs leader clusters -- so the per-cycle numbers
    are exact while bytes/cycle reflect the measured aggregate framing
    overhead."""
    for np_ in np_list:
        hosts = max(2, np_ // 4)
        row = {"metric": "ctrl_plane_np_sweep", "np": np_, "hosts": hosts}
        modes = [("flat", "off", None), ("tree", "on", None)]
        if hosts >= 3:  # depth 3 needs >= 3 leaders to grow a super layer
            modes.append(("tree_d3", "on", "3"))
        for mode, tree, depth in modes:
            env = {"HOROVOD_METRICS": "1", "HOROVOD_SHM_DISABLE": "1",
                   "HOROVOD_HIER_FAKE_HOSTS": str(hosts),
                   "HOROVOD_CONTROL_TREE": tree}
            if depth is not None:
                env["HOROVOD_CONTROL_TREE_DEPTH"] = depth
            results = run_job(_sweep_worker, (steps, tensors), np_, device,
                              env)
            coord = next(r for r in results if r["rank"] == 0)
            cycles = max(coord["cycles"], 1)
            row[f"{mode}_msgs_per_cycle"] = round(
                coord["msgs_recv"] / cycles, 2)
            row[f"{mode}_bytes_per_cycle"] = round(
                coord["bytes_recv"] / cycles, 1)
        row["msgs_ratio"] = round(
            row["flat_msgs_per_cycle"]
            / max(row["tree_msgs_per_cycle"], 1e-9), 2)
        if "tree_d3_msgs_per_cycle" in row:
            row["msgs_ratio_d3"] = round(
                row["flat_msgs_per_cycle"]
                / max(row["tree_d3_msgs_per_cycle"], 1e-9), 2)
        emit(lines, {**row, **device_keys(device, np_)})


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------

def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--np", type=int, default=4)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--tensors", type=int, default=50)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the ranks' device: each rank's card (the "
                         "default), or the CPU")
    ap.add_argument("--wire-compression", default=None,
                    choices=["bf16", "int8", "int4", "int8g"],
                    help="also benchmark the wire codec on a cross-host "
                         "(fake two-host, hierarchical) topology against "
                         "the fp32 baseline: bytes/step + max abs error")
    ap.add_argument("--wire-mb", type=float, default=4.0,
                    help="fp32 payload size for the wire benchmark (MiB)")
    ap.add_argument("--wire-steps", type=int, default=10)
    ap.add_argument("--device-codec", default=None,
                    choices=["int8", "int4", "int8g"],
                    help="also benchmark the device plane's quantized ring "
                         "(HOROVOD_WIRE_COMPRESSION device= plane) over "
                         "--np ranks: encoded/raw wire ratio, quantization "
                         "error, K1-K3 launches, steps/s vs the "
                         "uncompressed plane")
    ap.add_argument("--device-schedule", default=None,
                    choices=["auto", "ring", "bidi", "torus"],
                    help="ring topology for the device benchmark "
                         "(HOROVOD_DEVICE_SCHEDULE); implies the device "
                         "section with codec int8 if --device-codec is "
                         "not given")
    ap.add_argument("--device-mb", type=float, default=4.0,
                    help="fp32 payload size for the device benchmark (MiB)")
    ap.add_argument("--device-steps", type=int, default=20)
    ap.add_argument("--data-plane", action="store_true",
                    help="also measure one SGD train step under the eager "
                         "plane (hooks) vs the gspmd plane (DTensor, "
                         "compiled collectives) on --np ranks -- "
                         "interleaved, best-of-3 -- and report the "
                         "gspmd-vs-eager step ratio")
    ap.add_argument("--hlo-inspect", action="store_true",
                    help="also measure compiled-collective introspection's "
                         "step overhead: the gspmd-plane worker with "
                         "HOROVOD_HLO_INSPECT=0 vs 1, interleaved "
                         "best-of-3")
    ap.add_argument("--metrics", action="store_true",
                    help="also measure the metrics registry's negotiation "
                         "overhead: cache_on rerun with HOROVOD_METRICS=1, "
                         "steps/s ratio vs the metrics-off baseline")
    ap.add_argument("--step-trace", action="store_true",
                    help="also measure causal step tracing's negotiation "
                         "overhead (off vs on vs on+metrics, interleaved "
                         "best-of-3; cockpit stays disabled)")
    ap.add_argument("--flight-recorder", action="store_true",
                    help="also measure the flight recorder's negotiation "
                         "overhead: cache_on with the recorder off vs on, "
                         "interleaved best-of-3")
    ap.add_argument("--fleet-telemetry", action="store_true",
                    help="also measure the fleet telemetry plane's "
                         "negotiation overhead: metrics-on with "
                         "HOROVOD_FLEET_TELEMETRY=0 vs 1, interleaved "
                         "best-of-3")
    ap.add_argument("--np-sweep", default=None, metavar="N,N,...",
                    help="run ONLY the control-plane scaling sweep: "
                         "coordinator ctrl messages + bytes per cycle -- "
                         "flat vs auto-depth tree vs forced depth-3 -- at "
                         "each np over fake hosts (4 ranks/host)")
    ap.add_argument("--sweep-steps", type=int, default=30)
    return ap.parse_args(argv)


def main(argv=None) -> List[dict]:
    """Run the sections ``argv`` asks for; returns every printed line."""
    args = parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("bench_negotiation: --device cuda needs a "
                               "card; pass --device cpu to run on the CPU")
    dev, np_ = args.device, args.np
    lines: List[dict] = []

    if args.np_sweep:
        run_np_sweep([int(n) for n in args.np_sweep.split(",")],
                     args.sweep_steps, args.tensors, dev, lines)
        return lines

    def config(name, env):
        return run_config(name, env, np_, args.steps, args.tensors, dev,
                          lines)

    def best_of(legs):
        return interleaved(legs, np_, args.steps, args.tensors, dev, lines)

    shared = device_keys(dev, np_)["shared_card"]
    cache_on = config("cache_on", {})
    cache_off = config("cache_off", {"HOROVOD_CACHE_CAPACITY": "0"})
    fusion_off = config("fusion_off", {"HOROVOD_FUSION_THRESHOLD": "1"})
    emit(lines, {**cache_summary(cache_on, cache_off, fusion_off),
                 "shared_card": shared})

    if args.metrics:
        metrics_on = config("cache_on_metrics", {"HOROVOD_METRICS": "1"})
        emit(lines, {**overhead("metrics_overhead", [cache_on],
                                [metrics_on]), "shared_card": shared})

    if args.flight_recorder:
        rows = best_of({
            "off": ("cache_on_flight_off", {"HOROVOD_FLIGHT_RECORDER":
                                            "off"}),
            "on": ("cache_on_flight_on", {"HOROVOD_FLIGHT_RECORDER": "1"})})
        emit(lines, {**overhead("flight_recorder_overhead", rows["off"],
                                rows["on"]), "shared_card": shared})

    if args.step_trace:
        # The third leg stacks metrics on so the full CYCLE trailer is
        # priced too.
        rows = best_of({
            "off": ("cache_on_trace_off", {"HOROVOD_STEP_TRACE": "0"}),
            "on": ("cache_on_trace_on", {"HOROVOD_STEP_TRACE": "1"}),
            "both": ("cache_on_trace_metrics",
                     {"HOROVOD_STEP_TRACE": "1", "HOROVOD_METRICS": "1"})})
        emit(lines, {**overhead("step_trace_overhead", rows["off"],
                                rows["on"], rows["both"]),
                     "shared_card": shared})

    if args.fleet_telemetry:
        # Against a metrics-on baseline: the plane rides the metrics
        # plumbing, so the delta priced is the plane's own.
        rows = best_of({
            "off": ("cache_on_fleet_off", {"HOROVOD_METRICS": "1",
                                           "HOROVOD_FLEET_TELEMETRY": "0"}),
            "on": ("cache_on_fleet_on", {"HOROVOD_METRICS": "1",
                                         "HOROVOD_FLEET_TELEMETRY": "1"})})
        emit(lines, {**overhead("fleet_telemetry_overhead", rows["off"],
                                rows["on"]), "shared_card": shared})

    elems = int(args.device_mb * (1 << 20)) // 4
    if args.data_plane:
        eager, gspmd = [], []
        for _ in range(BEST_OF):
            eager.append(run_plane_config("eager", args.device_steps, elems,
                                          np_, dev, lines))
            gspmd.append(run_plane_config("gspmd", args.device_steps, elems,
                                          np_, dev, lines))
        emit(lines, {**plane_summary(eager, gspmd), "shared_card": shared})

    if args.hlo_inspect:
        off, on = [], []
        for i in range(BEST_OF):
            off.append(run_plane_config(
                "gspmd", args.device_steps, elems, np_, dev, lines,
                extra_env={"HOROVOD_HLO_INSPECT": "0"},
                tag=f"_hlo_off_r{i}"))
            on.append(run_plane_config(
                "gspmd", args.device_steps, elems, np_, dev, lines,
                extra_env={"HOROVOD_HLO_INSPECT": "1"},
                tag=f"_hlo_on_r{i}"))
        hlo = None
        for h in on:
            hlo = h.get("hlo") or hlo
        emit(lines, {**overhead("hlo_inspect_overhead", off, on), "hlo": hlo,
                     "shared_card": shared})

    if args.wire_compression:
        welems = int(args.wire_mb * (1 << 20)) // 4
        base = run_wire_config("none", np_, args.wire_steps, welems, dev,
                               lines)
        comp = run_wire_config(args.wire_compression, np_, args.wire_steps,
                               welems, dev, lines)
        emit(lines, {**wire_summary(args.wire_compression, base, comp),
                     "device": "cpu", "shared_card": shared})

    if args.device_codec or args.device_schedule:
        codec = args.device_codec or "int8"
        dbase = run_device_config("none", args.device_steps, elems, np_,
                                  dev, lines)
        dcomp = run_device_config(codec, args.device_steps, elems, np_,
                                  dev, lines, schedule=args.device_schedule)
        bound = device_error_bound(codec, np_, elems, args.device_schedule)
        emit(lines, {**device_summary(codec, args.device_schedule, dbase,
                                      dcomp, bound), "shared_card": shared})
    return lines


if __name__ == "__main__":
    main()
