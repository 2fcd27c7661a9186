"""Render compiled-collective inventories for the port's gspmd data plane.

The counterpart of the JAX package's ``tools/hlo_report.py``.  The gspmd
plane never enqueues a collective: DTensor inserts the all-reduces its
pins need, and they appear only in the graphs ``torch.compile`` hands the
compiler.  This tool renders their inventory
(``horovod_tpu_torch/ops/hlo_inspect.py``) offline, from three sources:

  Graph-code files    Positional args: the printed code of a compiled
                      step's graphs (``GraphModule.print_readable``), as
                      ``hlo_inspect.write_graphs(directory)`` saves them.
                      Each file is walked for functional collectives:
                      kind, dtype, shape, group size, and analytic
                      ring-model wire bytes.
  --bundle DIR        A crash bundle (tools/postmortem.py layout): every
                      type-16 ``hloinspect`` flight event is tallied per
                      rank (a = collective op count, b = analytic wire
                      bytes), so an aborted gspmd run still reports what
                      its steps inventoried.
  --live              Self-check: two ranks through
                      ``horovod_tpu_torch.runner.run`` take one gspmd SGD
                      step through ``hlo_inspect.instrument``, save its
                      graphs' code, parse it back, and verify the parsed
                      inventory's byte totals equal the live
                      ``gspmd_byte_counters()`` exactly.  Exit code 1 on
                      mismatch.  On the card unless ``--device cpu``.

A ``--metrics FILE`` (a saved ``hvd.metrics()`` JSON dump) cross-checks
the totals of the graph-code inputs against the live
``gspmd_raw_bytes`` / ``gspmd_wire_bytes`` counters of the run that
produced the dump: exact equality is the contract (both sides use the same
integer ring model), and a mismatch exits 1.

Usage:
    python -m horovod_tpu_torch.tools.hlo_report graphs/step.0.py ...
    python -m horovod_tpu_torch.tools.hlo_report graphs/*.py --metrics m.json
    python -m horovod_tpu_torch.tools.hlo_report --bundle /path/to/postmortem
    python -m horovod_tpu_torch.tools.hlo_report --live [--device cpu]
    python -m horovod_tpu_torch.tools.hlo_report ... --json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Dict, List, Optional

from ..ops import hlo_inspect

# Flight-recorder event type of hloinspect (csrc/core/flight_recorder.h).
FLIGHT_HLO_INSPECT_TYPE = 16


# ---------------------------------------------------------------------------
# Source 1: graph-code files
# ---------------------------------------------------------------------------

def inventories_from_files(paths: List[str]) -> List[hlo_inspect.TraceInventory]:
    out = []
    for path in paths:
        with open(path) as f:
            text = f.read()
        out.append(hlo_inspect.inventory_from_text(
            text, label=os.path.basename(path)))
    return out


def render_inventory(inv: hlo_inspect.TraceInventory, out=None) -> None:
    out = out or sys.stdout
    print(f"\ntrace {inv.label or '<unnamed>'}  "
          f"(num_partitions={inv.world})", file=out)
    print("-" * 72, file=out)
    if not inv.ops:
        print("  no compiler-inserted collectives", file=out)
        return
    print(f"  {'kind':<19} {'dtype':<9} {'elements':>9} {'g':>3} "
          f"{'raw_bytes':>10} {'wire_bytes':>10}  name", file=out)
    for op in inv.ops:
        mark = "*" if op.asynchronous else " "
        print(f"  {op.kind:<19} {op.dtype:<9} {op.elements:>9} "
              f"{op.group_size:>3} {op.raw_bytes:>10} {op.wire_bytes:>10} "
              f"{mark} {op.name}", file=out)
    kinds = ", ".join(f"{k}: {n}"
                      for k, n in sorted(inv.kind_counts().items()))
    print(f"  total: {inv.collectives} collectives ({kinds}), "
          f"raw {inv.raw_bytes} B, analytic wire {inv.wire_bytes} B",
          file=out)
    if inv.cost:
        cost = ", ".join(f"{k}={v:g}" for k, v in sorted(inv.cost.items()))
        print(f"  compiler cost analysis: {cost}", file=out)


# ---------------------------------------------------------------------------
# Source 2: crash bundles (type-16 flight events)
# ---------------------------------------------------------------------------

def bundle_hlo_events(path: str) -> Dict[int, Dict[str, int]]:
    """Tally hloinspect flight events per rank from a postmortem bundle:
    digests in postmortem.json plus full flight.<rank>.json dumps (which
    supersede the digest for the same rank)."""
    if os.path.isdir(path):
        directory, pm_path = path, os.path.join(path, "postmortem.json")
    else:
        directory, pm_path = os.path.dirname(path) or ".", path
    per_rank_events: Dict[int, List[list]] = {}
    types: Dict[str, str] = {}
    if os.path.exists(pm_path):
        with open(pm_path) as f:
            pm = json.load(f)
        types = pm.get("types") or {}
        for rank_str, rec in (pm.get("ranks") or {}).items():
            per_rank_events[int(rank_str)] = rec.get("events") or []
    for fp in sorted(glob.glob(os.path.join(directory, "flight.*.json"))):
        m = re.match(r"flight\.(\d+)\.json$", os.path.basename(fp))
        if not m:
            continue
        try:
            with open(fp) as f:
                dump = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        types = types or dump.get("types") or {}
        per_rank_events[int(m.group(1))] = dump.get("events") or []

    def _is_hlo(typ: int) -> bool:
        name = types.get(str(typ))
        if name is not None:
            return name == "hloinspect"
        return typ == FLIGHT_HLO_INSPECT_TYPE

    tally: Dict[int, Dict[str, int]] = {}
    for rank, events in per_rank_events.items():
        rows = [e for e in events
                if isinstance(e, list) and len(e) >= 6 and _is_hlo(e[2])]
        if rows:
            tally[rank] = {"traces": len(rows),
                           "ops": sum(e[4] for e in rows),
                           "wire_bytes": sum(e[5] for e in rows)}
    return tally


def render_bundle(tally: Dict[int, Dict[str, int]], out=None) -> None:
    out = out or sys.stdout
    print("\nhloinspect flight events (type 16) per rank", file=out)
    print("-" * 72, file=out)
    if not tally:
        print("  none recorded (eager-plane run, HOROVOD_HLO_INSPECT=0, "
              "or a pre-introspection .so)", file=out)
        return
    for rank in sorted(tally):
        t = tally[rank]
        print(f"  rank {rank:<4} traces={t['traces']:<4} "
              f"collectives={t['ops']:<6} "
              f"analytic wire bytes={t['wire_bytes']}", file=out)


# ---------------------------------------------------------------------------
# Cross-checks
# ---------------------------------------------------------------------------

def crosscheck_metrics(invs: List[hlo_inspect.TraceInventory],
                       metrics_path: str, out=None) -> bool:
    """Compare the graph-code inputs' analytic totals against the gspmd
    byte counters of a saved hvd.metrics() dump.  Exact equality is the
    bar: the live counters and this tool share one integer wire model."""
    out = out or sys.stdout
    with open(metrics_path) as f:
        dump = json.load(f)
    counters = dump.get("counters") or {}
    live_raw = int(counters.get("gspmd_raw_bytes", 0))
    live_wire = int(counters.get("gspmd_wire_bytes", 0))
    raw = sum(i.raw_bytes for i in invs)
    wire = sum(i.wire_bytes for i in invs)
    ok = (raw == live_raw) and (wire == live_wire)
    print(f"\ncross-check vs {metrics_path}", file=out)
    print("-" * 72, file=out)
    print(f"  analytic (graph inputs): raw {raw} B, wire {wire} B", file=out)
    print(f"  live counters          : raw {live_raw} B, wire {live_wire} B",
          file=out)
    print(f"  {'MATCH' if ok else 'MISMATCH'}", file=out)
    return ok


LIVE_WORLD = 2


def _live_rank(device: str) -> dict:
    """One rank of :func:`live_check`: a gspmd SGD step of a linear model
    on DTensor parameters, through ``hlo_inspect.instrument``, and the
    code of the graphs it recorded."""
    import tempfile

    import numpy as np
    import torch
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.context import HorovodContext
    from horovod_tpu_torch.ops import gspmd_plane as gp

    hvd.init(device=device)
    try:
        r, s = hvd.rank(), hvd.size()
        dev = hvd.device()
        hlo_inspect.reset()
        mesh = gp.build_gspmd_mesh()
        rs = np.random.RandomState(0)
        per = 64 // s
        x = torch.from_numpy(rs.randn(64, 4).astype(np.float32))
        y = torch.from_numpy(rs.randn(64).astype(np.float32))
        mine = slice(r * per, (r + 1) * per)
        xs = DTensor.from_local(x[mine].to(dev), mesh, [Shard(0)],
                                run_check=False)
        ys = DTensor.from_local(y[mine].to(dev), mesh, [Shard(0)],
                                run_check=False)
        params = {k: torch.nn.Parameter(distribute_tensor(
                      torch.zeros(shape, device=dev), mesh, [Replicate()]))
                  for k, shape in (("w", (4,)), ("b", ()))}
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(params.values(), lr=0.1),
            named_parameters=params.items(), plane="gspmd")

        def step(xs, ys):
            loss = ((xs @ params["w"] + params["b"] - ys) ** 2).mean()
            loss.backward()
            opt.step()
            opt.zero_grad()
            return loss

        wrapped = hlo_inspect.instrument(
            step, label="live_check",
            backend="inductor" if dev.type == "cuda" else "aot_eager")
        wrapped(xs, ys)
        stats = HorovodContext.instance().core.data_plane_stats()
        with tempfile.TemporaryDirectory() as td:
            texts = []
            for path in hlo_inspect.write_graphs(td, "live_check"):
                with open(path) as f:
                    texts.append((os.path.basename(path), f.read()))
        return {"texts": texts,
                "counters": list(hlo_inspect.gspmd_byte_counters()),
                "stats": [stats["gspmd_raw"], stats["gspmd_wire"]]}
    finally:
        hvd.shutdown()


def live_check(device: str = "cuda", out=None) -> bool:
    """Run one gspmd step on two ranks through the instrumented path and
    verify that the inventory parsed from its saved graph code equals the
    live counters."""
    out = out or sys.stdout
    from ..runner import run
    from . import hlo_report

    env = {"HOROVOD_SHM_DISABLE": "1", "HOROVOD_HLO_INSPECT": "1"}
    if device == "cuda":
        import torch

        if torch.cuda.device_count() < LIVE_WORLD:
            # Both ranks on the first card, over gloo: NCCL refuses two
            # ranks on one card.
            device = "cuda:0"
            env["HOROVOD_GPU_OPERATIONS"] = "GLOO"
    results = run(hlo_report._live_rank, args=(device,), np=LIVE_WORLD,
                  env=env, stream_prefix=False)
    ok = True
    for rank, res in enumerate(results):
        invs = [hlo_inspect.inventory_from_text(text, label=name)
                for name, text in res["texts"]]
        if rank == 0:
            for inv in invs:
                render_inventory(inv, out=out)
        a_raw = sum(i.raw_bytes for i in invs)
        a_wire = sum(i.wire_bytes for i in invs)
        raw, wire = res["counters"]
        match = (any(i.collectives for i in invs)
                 and [a_raw, a_wire] == res["counters"] == res["stats"])
        print(f"\nlive check rank {rank}: {len(invs)} graph(s), analytic "
              f"raw/wire {a_raw}/{a_wire} B vs counters {raw}/{wire} B "
              f"-> {'MATCH' if match else 'MISMATCH'}", file=out)
        ok = ok and match
    return ok


# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("graphs", nargs="*",
                   help="graph-code files (print_readable) to inventory")
    p.add_argument("--bundle", default=None, metavar="DIR",
                   help="postmortem bundle: tally type-16 flight events")
    p.add_argument("--metrics", default=None, metavar="FILE",
                   help="saved hvd.metrics() JSON: cross-check byte totals")
    p.add_argument("--live", action="store_true",
                   help="self-check: one gspmd step on two ranks")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the ranks' device for --live (default: the card)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit machine-readable JSON instead of text")
    args = p.parse_args(argv)
    if not (args.graphs or args.bundle or args.live):
        p.error("nothing to do: give graph-code files, --bundle, or --live")

    result: Dict[str, object] = {}
    ok = True
    invs = inventories_from_files(args.graphs) if args.graphs else []
    if invs:
        result["traces"] = [i.to_dict() for i in invs]
    if args.bundle:
        tally = bundle_hlo_events(args.bundle)
        result["bundle"] = {str(r): t for r, t in sorted(tally.items())}
    sink = sys.stderr if args.as_json else sys.stdout
    if args.live:
        if args.device == "cuda":
            import torch

            if not torch.cuda.is_available():
                print("hlo_report --live: no card; pass --device cpu",
                      file=sys.stderr)
                return 2
        ok = live_check(args.device, out=sink) and ok
        result["live_ok"] = ok
    if not args.as_json:
        for inv in invs:
            render_inventory(inv)
        if args.bundle:
            render_bundle(bundle_hlo_events(args.bundle))
    if args.metrics:
        if not invs:
            print("--metrics needs graph-code inputs to cross-check against",
                  file=sys.stderr)
            return 2
        match = crosscheck_metrics(invs, args.metrics, out=sink)
        result["metrics_match"] = match
        ok = match and ok
    if args.as_json:
        json.dump(result, sys.stdout, indent=2)
        print()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
