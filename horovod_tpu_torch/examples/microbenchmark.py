"""Collective microbenchmarks: allreduce/allgather/alltoall/reducescatter/
broadcast, the port of ``examples/jax_microbenchmark.py``.

Reference analog: the timeline/benchmark harness Horovod ships for
measuring fused-allreduce throughput (docs/benchmarks.rst synthetic
benchmarks).

Two planes are measured:

- ``--plane jit``: the compiled plane.  Each rank holds its shard of
  ``mb`` MiB (``n / world`` fp32), and each op is one functional collective
  over the group of ``ops/gspmd_plane.build_gspmd_mesh()``, compiled
  through ``ops/hlo_inspect.instrument`` (Inductor on the card,
  ``aot_eager`` on the CPU), which inventories its collective.  Under
  gloo on a card the shard crosses host memory in the compiled step.
- ``--plane eager``: the negotiated spine, enqueue -> negotiate -> fuse ->
  execute.  Tensors on the rank's card ride the device plane (NCCL, or
  gloo with ``HOROVOD_GPU_OPERATIONS=GLOO`` when ranks share a card, the
  card named by ``HOROVOD_CUDA_DEVICE``); with ``--device cpu`` numpy
  buffers ride the core's host ring, as the reference's numpy arrays do.

Each op is timed as the reference times it: one warm-up call, ``iters``
calls, then (jit) one readback of the last output; MiB/s is
``mb * iters / seconds``.  Rank ``r``'s inputs are filled with ``r + 1``,
so every output has an exact value to hold it against.

Run:  python -m horovod_tpu_torch.examples.microbenchmark --plane eager
      python -m horovod_tpu_torch.runner.launch -np 2 \\
          python -m horovod_tpu_torch.examples.microbenchmark --plane jit
      (``--device cpu`` runs on the CPU)
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.context import HorovodContext


def _readback(out: torch.Tensor) -> float:
    """A host readback of ``out``: it waits for every call before it on
    the device."""
    return float(out.sum())


def bench_jit(mb: float, iters: int, keep: Optional[dict] = None) -> dict:
    """MiB/s of each compiled collective; ``keep`` receives each op's last
    output."""
    import torch.distributed._functional_collectives as funcol

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops import gspmd_plane as gp
    from horovod_tpu_torch.ops import hlo_inspect as hi

    world, dev = hvd.size(), hvd.device()
    wire = basics.wire_device()
    mesh = gp.build_gspmd_mesh()
    backend = "inductor" if dev.type == "cuda" else "aot_eager"
    n = int(mb * (1 << 20) / 4)
    x = torch.full((n // world,), float(hvd.rank() + 1), device=dev)

    def compiled(op, fn, post):
        def step(s):
            # The step's collectives are the compiled plane's: inventory them.
            hi.mark_plane("gspmd")
            # Gloo takes host tensors (ranks sharing a card): the shard
            # crosses host memory each way, as the device plane's do, and
            # every computation stays on the device.
            return post(fn(s.to(wire)).to(dev))

        return hi.instrument(step, label=f"bench_{op}", backend=backend)

    def same(t):
        return t

    results = {}
    for name, fn, post in [
        # The reference's in-jit allreduce averages.
        ("allreduce", lambda s: funcol.all_reduce(s, "sum", mesh),
         lambda t: t / world),
        ("allgather", lambda s: funcol.all_gather_tensor(s, 0, mesh), same),
        # alltoall and reducescatter split the shard's rows across ranks.
        ("alltoall", lambda s: funcol.all_to_all_single(
            s.reshape(world, -1), None, None, mesh), same),
        ("reducescatter", lambda s: funcol.reduce_scatter_tensor(
            s.reshape(world, -1), "sum", 0, mesh), same),
    ]:
        f = compiled(name, fn, post)
        _readback(f(x))  # warm-up and compile, then a real sync
        t0 = time.perf_counter()
        for _ in range(iters):
            out = f(x)
        # Device work runs in order: reading back the last output bounds
        # every call.
        _readback(out)
        dt = time.perf_counter() - t0
        results[name] = (mb * iters) / dt
        if keep is not None:
            keep[name] = out
    return results


def bench_eager(mb: float, iters: int, keep: Optional[dict] = None) -> dict:
    """MiB/s of each negotiated collective; ``keep`` receives each op's
    last output."""
    dev, size = hvd.device(), hvd.size()
    fill = float(hvd.rank() + 1)
    n = int(mb * (1 << 20) / 4)
    # alltoall moves the same mb per rank: n rows split evenly across ranks.
    rows = n // max(size, 1) * size
    if dev.type == "cpu":
        x = np.full(n, fill, np.float32)
        xa = np.full((rows, 1), fill, np.float32)
    else:
        x = torch.full((n,), fill, device=dev)
        xa = torch.full((rows, 1), fill, device=dev)
    results = {}
    # xa doubles for reducescatter: both split first-dim rows across the
    # set.
    for name, fn in [
        ("allreduce", lambda i: hvd.allreduce(x, name=f"b.ar.{i}")),
        ("allgather", lambda i: hvd.allgather(x, name=f"b.ag.{i}")),
        ("alltoall", lambda i: hvd.alltoall(xa, name=f"b.a2a.{i}")),
        ("reducescatter", lambda i: hvd.reducescatter(
            xa, op=hvd.Sum, name=f"b.rs.{i}")),
        ("broadcast", lambda i: hvd.broadcast(
            x, root_rank=0, name=f"b.bc.{i}")),
    ]:
        fn(0)  # warmup
        t0 = time.perf_counter()
        for i in range(1, iters + 1):
            out = fn(i)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        results[name] = (mb * iters) / dt
        if keep is not None:
            keep[name] = out[0] if isinstance(out, tuple) else out
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plane", choices=["jit", "eager"], default="jit")
    ap.add_argument("--mb", type=float, default=16.0,
                    help="payload size in MiB")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="the rank's device (default: its card; 'cpu')")
    args = ap.parse_args(argv)

    hvd.init(device=args.device)
    outputs: dict = {}
    results = (bench_jit if args.plane == "jit" else bench_eager)(
        args.mb, args.iters, outputs)
    if hvd.rank() == 0:
        for op, mbps in results.items():
            print(f"{op:14s} {mbps:10.1f} MiB/s ({args.plane} plane, "
                  f"size={hvd.size()})", flush=True)
    stats = dict(HorovodContext.instance().device_plane.stats)
    rank, size, dev = hvd.rank(), hvd.size(), hvd.device()
    hvd.shutdown()
    if dev.type == "cuda" and stats["host_fallback"]:
        raise RuntimeError(f"microbenchmark: {stats['host_fallback']} card "
                           "collective(s) fell back to the host ring")
    return {"rank": rank, "size": size, "device": str(dev),
            "plane": args.plane, "mb": args.mb, "iters": args.iters,
            "mib_per_s": results, "device_plane": stats,
            "outputs": outputs}


if __name__ == "__main__":
    main()
