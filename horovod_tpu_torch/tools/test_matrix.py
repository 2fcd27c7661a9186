"""Controller/config test matrix over the port (reference analog: the
docker-compose + Buildkite matrix exercising framework x controller x
device combos), the counterpart of the JAX package's
``tools/test_matrix.py``.

Runs one collective-correctness workload, through ``horovod_tpu_torch``
and the port's launcher (``python -m horovod_tpu_torch.runner.launch``),
across the combinations of:

- core:    native (LocalController at np=1, socket controller at np>1)
           x pure-python (``HVD_TPU_PURE_PY=1``, np=1 only: the fallback
           core's contract)
- np:      1, 2, 3
- fusion:  default threshold / disabled (HOROVOD_FUSION_THRESHOLD=0)
- cache:   default capacity / disabled (HOROVOD_CACHE_CAPACITY=0)
- plane:   shared-memory / pipelined TCP ring (HOROVOD_SHM_DISABLE=1) /
           legacy whole-segment TCP ring (+HOROVOD_RING_CHUNK_BYTES=0),
           np>1 only / hierarchical (HOROVOD_HIERARCHICAL_ALLREDUCE=1 over
           two fake hosts, HOROVOD_HIER_FAKE_HOSTS=2), np>=3 only
- wire:    none / bf16 / int8 (HOROVOD_WIRE_COMPRESSION) on the hier
           plane's cross-host leader ring, plus demotion rows where the
           knob is set on an all-local topology
- metrics: off / on (HOROVOD_METRICS=1): the registry populated
- ctrl_tree: auto / on (HOROVOD_CONTROL_TREE) / d3 (three levels deep,
           HOROVOD_CONTROL_TREE_DEPTH=3 over three fake hosts)
- flight:  def / on / off (HOROVOD_FLIGHT_RECORDER): the black box
           recorded the workload, or reports {}
- autopilot: off / on (HOROVOD_AUTOPILOT=1): the launch goes through the
           elastic driver with the policy thread; a healthy fleet gives
           zero decisions and the same results
- qdev:    off / <codec>[:<schedule>] / demote: the device plane's
           quantized ring (HOROVOD_WIRE_COMPRESSION ``device=<codec>``,
           HOROVOD_DEVICE_SCHEDULE), on np=4 ranks (the reference runs it
           in-jit over a forced 4-device host).  A codec moves the byte
           counters within the codec's scale/2 bound; "demote" keeps the
           codec cold under the floor, bit-identical to the plain ring
- migrate: off / on (HOROVOD_MIGRATE_REPLICAS): a committed
           ``TorchState`` lands bit-exact on the ring successors' shard
           stores
- trace:   def / on / off (HOROVOD_STEP_TRACE): the step ring recorded
           the workload, or reports {}
- fleet:   def / on / off (HOROVOD_FLEET_TELEMETRY, forcing the metrics
           plane on): the coordinator's fleet histograms and the
           ``fleethistory-v1`` payload, or both empty
- dplane:  off / gspmd / diff (HOROVOD_DATA_PLANE) on np=2 ranks: the
           env-plumbed request reaches the optimizer and a compiled step
           runs; "diff" trains the same problem on both planes to fp32
           reduction-order tolerance
- hloinspect: def / on / off (HOROVOD_HLO_INSPECT) on np=2 ranks: a gspmd
           step through ``ops/hlo_inspect.instrument`` whose inventory
           equals ``data_plane_stats()``'s gspmd bytes exactly (and reads
           back from its saved graph code); "off" returns the step
           unchanged with every counter at zero

The plane and wire axes act on the core's host ring, so the workload runs
each collective on host buffers (CPU tensors on a card rank; numpy
buffers on a CPU rank, whose CPU tensors ride the device plane), and then
again on tensors of the rank's device, which go through the device plane.
``--device cuda`` puts each rank on its local rank's card; a row of more
ranks than cards puts them all on the first card over gloo
(HOROVOD_GPU_OPERATIONS=GLOO: NCCL refuses two ranks on one card).
Compiled rows use Inductor on the card, ``aot_eager`` on the CPU.

Plus non-workload check rows: ``fault-spec`` (the HOROVOD_FAULT_INJECT
parser contract, both sets) and, full set only, ``fault-np4`` (an injected
death aborts every survivor within the bound naming the culprit; an
injected corrupt tag fails fast), ``postmortem-np4`` (the merged
``postmortem.json`` names the culprit, read by ``tools/postmortem.py``),
``autopilot-np4`` and ``migration-np4`` (the port's test files of those
paths), ``cockpit-np4`` (an injected coordinator-recv delay attributed to
the delayed rank by ``tools/critical_path.py`` and the live ``/state``)
and ``ctrl-np8`` (flat, depth-2 and depth-3 control trees agree).

Usage:
    python -m horovod_tpu_torch.tools.test_matrix              # full
    python -m horovod_tpu_torch.tools.test_matrix --quick      # covering
    python -m horovod_tpu_torch.tools.test_matrix --quick --device cuda

Prints one PASS/FAIL line per row and exits nonzero if any fail.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import textwrap
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

WORKLOAD = textwrap.dedent("""
    import json
    import os
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.context import HorovodContext

    hvd.init(device=os.environ.get("HVD_MATRIX_DEVICE", "cpu"))
    r, s = hvd.rank(), hvd.size()
    dev = hvd.device()
    ctx = HorovodContext.instance()
    plane = ctx.device_plane
    report = {"rank": r}

    # The codecs in force: a bare codec is the host ring's, the per-plane
    # syntax names each plane's.
    wire = os.environ.get("HOROVOD_WIRE_COMPRESSION", "none")
    codecs = (dict(kv.split("=", 1) for kv in wire.split(","))
              if "=" in wire else {"host": wire})
    qmax = {"int8": 127, "int8g": 127, "int4": 7}
    dcodec = codecs.get("device", "none")
    floor = int(os.environ.get("HOROVOD_WIRE_COMPRESSION_MIN_BYTES", "0"))

    def check(got, want, **tol):
        if isinstance(got, torch.Tensor):
            got = got.cpu().numpy()
        np.testing.assert_allclose(np.asarray(got), want, **tol)

    # process set (channel + lane + per-set plane) over the first s-1 ranks
    ps = hvd.add_process_set(list(range(s - 1))) if s >= 2 else None

    def workload(tag, put, big_tol):
        p = tag + "."
        # allreduce ops + dtypes, out of place and in place
        x = put(torch.full((33,), float(r + 1)))
        total = s * (s + 1) / 2.0
        check(hvd.allreduce(x, op=hvd.Sum, name=p + "m.sum"), total)
        check(hvd.allreduce(x, op=hvd.Average, name=p + "m.avg"), total / s)
        check(hvd.allreduce(x, op=hvd.Min, name=p + "m.min"), 1.0)
        check(hvd.allreduce(x, op=hvd.Max, name=p + "m.max"), float(s))
        y = put(torch.full((33,), float(r + 1)))
        hvd.allreduce_(y, op=hvd.Average, name=p + "m.avg_")
        check(y, total / s)
        v = put(torch.arange(6, dtype=torch.int64) + r)
        out = hvd.allreduce(v, op=hvd.Sum, name=p + "m.i64")
        np.testing.assert_array_equal(
            np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out),
            sum(np.arange(6) + rr for rr in range(s)))

        # fusion sweep: many small tensors in one window
        handles = [hvd.allreduce_async(put(torch.full((8,), float(i + r))),
                                       op=hvd.Sum, name=f"{p}m.f.{i}")
                   for i in range(40)]
        for i, h in enumerate(handles):
            check(hvd.synchronize(h), s * i + s * (s - 1) / 2.0)

        # cache steady state: identical negotiation repeated
        for it in range(20):
            check(hvd.allreduce(put(torch.full((16,), float(r))), op=hvd.Sum,
                                name=p + "m.cached"), s * (s - 1) / 2.0)

        # ragged allgather
        g = hvd.allgather(put(torch.full((r + 1, 2), float(r))),
                          name=p + "m.ag")
        assert tuple(g.shape) == (s * (s + 1) // 2, 2), g.shape
        check(g, np.concatenate([np.full((rr + 1, 2), float(rr))
                                 for rr in range(s)]))

        # broadcast from every root, out of place and in place
        for root in range(s):
            out = hvd.broadcast(put(torch.full((5,), float(r),
                                               dtype=torch.float64)),
                                root_rank=root, name=f"{p}m.bc.{root}")
            check(out, float(root))
            b = put(torch.full((5,), float(r), dtype=torch.float64))
            hvd.broadcast_(b, root_rank=root, name=f"{p}m.bc_.{root}")
            check(b, float(root))

        # equal-splits alltoall
        data = put((torch.arange(2 * s, dtype=torch.float32)
                    + 10 * r).reshape(2 * s, 1))
        out, _ = hvd.alltoall(data, splits=[2] * s, name=p + "m.a2a")
        assert tuple(out.shape) == (2 * s, 1), out.shape
        check(out, np.concatenate([np.arange(2 * r, 2 * r + 2) + 10.0 * src
                                   for src in range(s)]).reshape(-1, 1))

        if ps is not None and r < s - 1:
            out = hvd.allreduce(put(torch.full((7,), float(r + 1))),
                                op=hvd.Sum, process_set=ps, name=p + "m.ps")
            check(out, (s - 1) * s / 2.0)

        # big fp32 payload above the codec floor: rides the codec where one
        # engages (tolerance keyed off the knob; the small tensors above
        # stay under the floor, so their exact asserts hold).
        big = put(torch.remainder(torch.arange(1 << 16, dtype=torch.float32),
                                  251.0) + r)
        wexp = sum(((np.arange(1 << 16) % 251) + rr).astype(np.float32)
                   for rr in range(s))
        check(hvd.allreduce(big, op=hvd.Sum, name=p + "m.wire"), wexp,
              **big_tol)

    # Host pass: the core's host ring, where the plane and wire axes act.
    host_tol = {"bf16": dict(rtol=0.04, atol=1e-3),
                "int8": dict(rtol=0.05, atol=6.0)}.get(
                    codecs.get("host", "none"), dict(rtol=1e-6))
    before = dict(plane.stats)
    workload("host", (lambda t: t) if dev.type == "cuda"
             else (lambda t: t.numpy()), host_tol)
    assert plane.stats == before, ("host pass reached the device plane",
                                   before, plane.stats)

    # Device pass: the same collectives on the rank's device, through the
    # device plane (the quantized ring for the big payload under a device
    # codec: each hop's rounding is at most half a block scale).
    dev_tol = dict(rtol=1e-6)
    if dcodec != "none" and s > 1 and (1 << 18) >= floor:
        dev_tol = dict(rtol=0, atol=s * s * (250.0 + s) / qmax[dcodec])
    workload("dev", lambda t: t.to(dev), dev_tol)
    moved = {k: plane.stats[k] - before[k] for k in plane.stats}
    report["device_plane"] = moved
    if s == 1:
        assert moved["identity"] > 0, moved
    else:
        assert all(moved[k] > 0 for k in ("allreduce", "allgather",
                                          "broadcast", "alltoall")), moved
    assert moved["host_fallback"] == 0, moved

    # qdev axis: the device plane's quantized ring (device=<codec>,
    # optional ":<schedule>").  A codec value must engage (byte counters
    # move) within the codec's scale/2 bound; "demote" pins the min-bytes
    # floor: codec cold, the result bit-identical to the plain ring.
    qdev = os.environ.get("HVD_MATRIX_QDEV", "off")
    if qdev != "off":
        import horovod_tpu_torch.ops.quantize as qz
        from horovod_tpu_torch.ops.device_plane import (bucket_len,
                                                        plain_allreduce)
        from horovod_tpu_torch.wire import ReduceOp

        assert s >= 2, "qdev rows run on several ranks"
        qx = ((np.arange(s * 4096) % 509) / 509.0 - 0.5) \\
            .astype(np.float32).reshape(s, 4096)
        qz.reset_device_byte_counters()
        launches = dict(qz.LAUNCHES)
        qout = hvd.allreduce(torch.from_numpy(qx[r]).to(dev),
                             name="m.qdev").cpu().numpy()
        report["qdev_launches"] = {k: qz.LAUNCHES[k] - launches[k]
                                   for k in launches}
        qraw, qenc = qz.device_byte_counters()
        report["qdev_bytes"] = [qraw, qenc]
        qmean = qx.mean(axis=0)
        if qdev != "demote":
            from horovod_tpu_torch.ops.collectives import \\
                resolve_device_schedule

            qcodec = qdev.split(":", 1)[0]
            assert qraw > 0 and qenc < qraw, (qraw, qenc)
            # The ring's bound on the sum (quantize.ring_error_bound);
            # the sum's error over s is the average's.
            big_x = float(np.abs(qx).max())
            qbound = qz.ring_error_bound(qcodec, s, big_x,
                                         resolve_device_schedule(s)) / s \\
                + 1e-6 * big_x
            qerr = float(np.max(np.abs(qout - qmean)))
            report["qdev_err"] = [qerr, qbound]
            assert qerr <= qbound, (qcodec, qerr, qbound)
        else:
            assert (qraw, qenc) == (0, 0), (qraw, qenc)
            flat = torch.zeros(bucket_len(4096), device=dev)
            flat[:4096] = torch.from_numpy(qx[r]).to(dev)
            qplain = plain_allreduce(flat, ReduceOp.AVERAGE,
                                     plane._ring(0))[:4096]
            np.testing.assert_array_equal(qout, qplain.cpu().numpy())

    # dplane and hloinspect axes: the gspmd plane on DTensor parameters
    # over the ranks' batch mesh, compiled (Inductor on the card).
    dplane = os.environ.get("HVD_MATRIX_DPLANE", "off")
    hli = os.environ.get("HVD_MATRIX_HLOINSPECT", "def")
    if dplane != "off" or hli != "def":
        from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                              distribute_tensor)
        from horovod_tpu_torch.ops import gspmd_plane as gp
        from horovod_tpu_torch.ops import hlo_inspect as hi

        assert s >= 2, "dplane/hloinspect rows run on several ranks"
        backend = "inductor" if dev.type == "cuda" else "aot_eager"
        mesh = gp.build_gspmd_mesh()
        drs = np.random.RandomState(7)
        dx = torch.from_numpy(drs.randn(8 * s, 4).astype(np.float32))
        dy = torch.from_numpy(drs.randn(8 * s).astype(np.float32))
        mine = slice(8 * r, 8 * (r + 1))

        def shard(t):
            return DTensor.from_local(t[mine].to(dev), mesh, [Shard(0)],
                                      run_check=False)

        def linear(plane_name, dtensor=True, bias=True):
            init = {"w": torch.zeros(4, device=dev)}
            if bias:
                init["b"] = torch.zeros((), device=dev)
            params = {k: torch.nn.Parameter(
                          distribute_tensor(v, mesh, [Replicate()])
                          if dtensor else v) for k, v in init.items()}
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(params.values(), lr=0.1),
                named_parameters=params.items(), plane=plane_name)

            def step(xs, ys):
                pred = xs @ params["w"]
                if bias:
                    pred = pred + params["b"]
                loss = ((pred - ys) ** 2).mean()
                loss.backward()
                opt.step()
                opt.zero_grad()
                return loss

            return params, step

        def local(p):
            return getattr(p, "_local_tensor", p).detach().cpu().numpy()

        if dplane != "off":
            gp.reset_plane_counters()
            # plane unset: HOROVOD_DATA_PLANE=gspmd must have ridden the
            # environment into the optimizer.
            pg, step = linear("gspmd" if dplane == "diff" else None)
            dc = gp.plane_counters()
            if dplane == "gspmd":
                assert dc.get("gspmd") == 1, dc
            cstep = torch.compile(step, backend=backend)
            for _ in range(3):
                cstep(shard(dx), shard(dy))
            assert np.isfinite(local(pg["w"])).all()
            if dplane == "diff":
                pe, estep = linear("eager", dtensor=False)
                for _ in range(3):
                    estep(dx[mine].to(dev), dy[mine].to(dev))
                for k in ("w", "b"):
                    np.testing.assert_allclose(local(pg[k]), local(pe[k]),
                                               rtol=2e-6, atol=1e-7)

        if hli != "def":
            import tempfile
            hi.reset()
            st0 = ctx.core.data_plane_stats()
            hp, hstep = linear("gspmd", bias=False)
            hwrapped = hi.instrument(hstep, label="matrix", backend=backend)
            if hli == "on":
                hwrapped(shard(dx), shard(dy))
                hinvs = [i for i in hi.inventories() if i.label == "matrix"]
                assert hinvs, "the gspmd step yielded no inventory"
                hinv = hinvs[-1]
                assert hinv.collectives > 0, hinv.to_dict()
                st1 = ctx.core.data_plane_stats()
                live = (st1["gspmd_raw"] - st0["gspmd_raw"],
                        st1["gspmd_wire"] - st0["gspmd_wire"])
                assert (hinv.raw_bytes, hinv.wire_bytes) == live == \\
                    hi.gspmd_byte_counters(), (hinv.to_dict(), live)
                with tempfile.TemporaryDirectory() as td:
                    texts = [open(path).read()
                             for path in hi.write_graphs(td, "matrix")]
                parsed = [hi.inventory_from_text(t) for t in texts]
                assert (sum(i.raw_bytes for i in parsed),
                        sum(i.wire_bytes for i in parsed)) == live, parsed
            else:  # off: the identity wrapper, every counter at zero
                assert hwrapped is hstep, \\
                    "HOROVOD_HLO_INSPECT=0 must return the step unchanged"
                hwrapped(shard(dx), shard(dy))
                st1 = ctx.core.data_plane_stats()
                assert hi.inventories() == [], "inspection off but recorded"
                assert hi.gspmd_byte_counters() == (0, 0)
                assert (st1["gspmd_raw"], st1["gspmd_wire"]) == \\
                    (st0["gspmd_raw"], st0["gspmd_wire"])

    # flight axis: the always-on black box must have recorded the work
    # (ctrl frames exist at np>1 only; np=1 has no socket control plane).
    fl = os.environ.get("HOROVOD_FLIGHT_RECORDER", "")
    if fl == "1" and s > 1:
        fr = hvd.flight_record()
        assert fr.get("events"), fr
        assert fr.get("rank") == r, fr
        assert fr.get("types"), fr
    elif fl == "off":
        assert hvd.flight_record() == {}, "recorder off but ring non-empty"

    # migrate axis: a committed elastic state must land, bit-exact, on the
    # ring successors' shard stores via the data-plane replication path.
    if os.environ.get("HVD_MATRIX_MIGRATE") == "on" and s > 1:
        import pickle
        from horovod_tpu_torch.elastic import migrate as mig

        model = torch.nn.Linear(4, 1).to(dev)
        with torch.no_grad():
            model.weight.fill_(float(r))
            model.bias.fill_(float(r))
        est = hvd.elastic.TorchState(model=model, step=0)
        est.step = 1
        est.commit()
        st = mig.store()
        assert st.own is not None and st.own.owner == r, (r, st.own)
        assert len(st.peers) >= min(2, s - 1), sorted(st.peers)
        pred = (r - 1) % s
        recs = [p for p in st.peers.values() if p.owner == pred]
        assert recs, sorted(st.peers)
        payload = pickle.loads(recs[0].data)
        assert payload["attrs"]["step"] == 1, payload["attrs"]
        snap = payload["handled"]["model"]
        for key in ("weight", "bias"):
            np.testing.assert_array_equal(
                snap[key].numpy(), np.full(tuple(snap[key].shape),
                                           float(pred), np.float32))

    # trace axis: the causal step ring must carry the work done above --
    # completed steps with wall-clock bounds and the 5-phase breakdown,
    # plus the coordinator's fleet attribution at np>1.
    tr = os.environ.get("HOROVOD_STEP_TRACE", "")
    if tr == "1":
        t = hvd.step_trace()
        assert t.get("completed", 0) > 0, t
        assert t["phases"] == ["negotiation_wait", "fusion", "ring",
                               "fence", "idle"], t["phases"]
        assert t["steps"] and all(len(row) == 9 and row[2] >= row[1] > 0
                                  for row in t["steps"]), t["steps"][:3]
        assert any(sum(row[3:8]) > 0 for row in t["steps"]), t["steps"][:3]
        if r == 0 and s > 1:
            assert t["fleet"], "coordinator recorded no fleet attribution"
    elif tr == "0":
        assert hvd.step_trace() == {}, "tracing off but ring non-empty"

    # metrics axis: the registry must have seen the work done above.
    if os.environ.get("HOROVOD_METRICS") == "1":
        m = hvd.metrics()
        assert m.get("enabled"), m
        assert m["counters"]["cycle_count"] > 0, m["counters"]
        assert m["histograms"]["negotiation_wait_us"]["count"] > 0, \\
            m["histograms"]
        assert hvd.metrics_prometheus().startswith("# HELP")

    # fleet axis: the sketch sections must have landed true fleet
    # histograms on the coordinator, and the history endpoint must serve
    # the fleethistory-v1 payload; "off" keeps both surfaces empty.
    ft = os.environ.get("HOROVOD_FLEET_TELEMETRY", "")
    if ft == "1":
        if r == 0:
            fleet = hvd.metrics().get("fleet") or {}
            assert fleet.get("negotiation_wait_us", {}).get("count", 0) > 0, \\
                fleet
            fh = hvd.fleet_history()
            assert fh.get("schema") == "fleethistory-v1", fh
            assert fh.get("tiers"), fh
    elif ft == "0":
        assert "fleet" not in (hvd.metrics() or {}), \\
            "fleet telemetry off but metrics carries a fleet section"
        assert hvd.fleet_history() == {}, \\
            "fleet telemetry off but history non-empty"

    hvd.barrier()
    hvd.shutdown()
    print("WORKLOAD-REPORT " + json.dumps(report), flush=True)
    print(f"WORKLOAD-OK rank={r}", flush=True)
""")

# The axes of a row, in order, and each one's default.
AXES = (("core", "native"), ("np", 1), ("fusion", "on"), ("cache", "on"),
        ("plane", "shm"), ("wire", "none"), ("metrics", "off"),
        ("tree", "auto"), ("flight", "def"), ("autopilot", "off"),
        ("qdev", "off"), ("migrate", "off"), ("trace", "def"),
        ("fleet", "def"), ("dplane", "off"), ("hloinspect", "def"))

# The ranks of the rows the reference runs in-jit over a forced multi-
# device host: the port runs them on ranks.
QDEV_NP = 4
DPLANE_NP = 2
QDEV_FLOOR = 8192  # bytes: HOROVOD_WIRE_COMPRESSION_MIN_BYTES of qdev rows


def row(**axes) -> dict:
    """One row of the matrix: every axis, at its default where not
    given."""
    unknown = set(axes) - {name for name, _ in AXES}
    if unknown:
        raise ValueError(f"unknown axes {sorted(unknown)}")
    return {name: axes.get(name, default) for name, default in AXES}


def combos(quick: bool):
    cores = ["native", "purepy"]
    nps = [1, 2, 3]
    fusion = ["on", "off"]
    cache = ["on", "off"]
    planes = ["shm", "tcp", "tcp0", "hier"]
    wires = ["none", "bf16", "int8"]
    if quick:
        # One covering set instead of the full product: every axis value
        # of the reference's quick set appears (its torch-binding rows
        # fold in: the port has one binding).
        yield row(np=3, plane="shm")
        # Same-host links: the coordinator must demote the codec (knob
        # harmless, results exact).
        yield row(np=2, fusion="off", cache="off", plane="tcp", wire="bf16")
        yield row(np=3, cache="off", plane="tcp0")
        yield row(np=3, plane="hier", wire="bf16")
        yield row(np=3, cache="off", plane="hier", wire="int8")
        # ctrl_tree axis: the leader tree over two fake hosts, and the
        # forced depth-3 chain over three.
        yield row(np=3, plane="hier", tree="on")
        yield row(np=3, plane="hier", tree="d3")
        yield row(np=3, flight="on")
        # autopilot axis: elastic driver + policy thread over a healthy
        # fleet; zero decisions, same results.
        yield row(np=3, autopilot="on")
        # qdev axis: the int8 baseline plus the int4 codec on the bidi
        # schedule, on ranks.
        yield row(np=QDEV_NP, plane="tcp", qdev="int8")
        yield row(np=QDEV_NP, plane="tcp", qdev="int4:bidi")
        yield row(np=DPLANE_NP, plane="tcp", dplane="gspmd")
        yield row(np=DPLANE_NP, plane="tcp", hloinspect="on")
        yield row(np=3, migrate="on")
        yield row(np=3, trace="on")
        yield row(np=3, metrics="on", fleet="on")
        yield row(np=1, cache="off")
        yield row(core="purepy", np=1, fusion="off")
        yield row(np=2)
        yield row(np=3, fusion="off", cache="off", plane="tcp")
        return
    for core, np_, f, c, p, w in itertools.product(cores, nps, fusion,
                                                   cache, planes, wires):
        if core == "purepy" and np_ > 1:
            continue  # pure-python core is single-process by contract
        if np_ == 1 and p != "shm":
            continue  # no data plane at np=1; plane axis is meaningless
        if p == "hier" and np_ < 3:
            continue  # 2 ranks / 2 fake hosts has no multi-rank host
        if w != "none" and (p != "hier" or core != "native"):
            continue  # codec engages only on cross-host hops (leader ring)
        yield row(core=core, np=np_, fusion=f, cache=c, plane=p, wire=w)
    # Demotion coverage: codec requested on an all-local flat ring.
    yield row(np=2, plane="tcp", wire="bf16")
    yield row(np=3, wire="int8")
    # Metrics axis across controller shapes.
    yield row(np=1, metrics="on")
    yield row(np=3, metrics="on")
    yield row(np=3, fusion="off", cache="off", plane="tcp", metrics="on")
    yield row(np=3, plane="hier", wire="bf16", metrics="on")
    # Control-tree axis, plus a single-host demotion row.
    yield row(np=3, plane="hier", tree="on")
    yield row(np=3, fusion="off", cache="off", plane="hier", metrics="on",
              tree="on")
    yield row(np=3, plane="hier", wire="bf16", tree="on")
    yield row(np=3, plane="tcp", tree="on")
    yield row(np=3, plane="hier", metrics="on", tree="d3")
    yield row(np=3, fusion="off", cache="off", plane="hier", tree="d3")
    # Flight-recorder axis.
    yield row(np=3, flight="on")
    yield row(np=3, fusion="off", cache="off", plane="tcp", metrics="on",
              flight="on")
    yield row(np=3, plane="hier", tree="on", flight="on")
    yield row(np=3, flight="off")
    # Autopilot axis.
    yield row(np=3, autopilot="on")
    yield row(np=3, fusion="off", cache="off", plane="tcp", autopilot="on")
    # qdev axis: engagement, one cross-plane row (host bf16 on the leader
    # ring + device int8 in the same processes), the floor's demotion, the
    # codecs and the schedules (4 ranks factor as 2x2: torus).  The
    # reference's purepy qdev row has no port: the pure-Python core is
    # single-process, and the port's device ring needs ranks.
    yield row(np=QDEV_NP, plane="tcp", qdev="int8")
    yield row(np=QDEV_NP, plane="hier", wire="bf16", qdev="int8")
    yield row(np=QDEV_NP, plane="tcp", qdev="demote")
    for q in ("int4", "int8g", "int8:bidi", "int4:torus", "int8g:ring"):
        yield row(np=QDEV_NP, plane="tcp", qdev=q)
    # dplane and hloinspect axes.
    yield row(np=DPLANE_NP, plane="tcp", dplane="gspmd")
    yield row(np=DPLANE_NP, plane="tcp", dplane="diff")
    yield row(np=DPLANE_NP, plane="tcp", hloinspect="on")
    yield row(np=DPLANE_NP, plane="tcp", hloinspect="off")
    # Migrate axis across the planes the shards ride.
    yield row(np=3, migrate="on")
    yield row(np=2, plane="tcp", migrate="on")
    yield row(np=3, plane="hier", metrics="on", migrate="on")
    # Trace axis.
    yield row(np=1, trace="on")
    yield row(np=3, metrics="on", trace="on")
    yield row(np=3, plane="hier", tree="on", trace="on")
    yield row(np=3, fusion="off", cache="off", plane="tcp", trace="off")
    # Fleet-telemetry axis.
    yield row(np=3, metrics="on", fleet="on")
    yield row(np=3, fusion="off", cache="off", plane="tcp", metrics="on",
              fleet="on")
    yield row(np=3, plane="hier", metrics="on", tree="on", fleet="on")
    yield row(np=3, metrics="on", fleet="off")


def card_rows():
    """The quick rows whose tensors reach the card, as ``--device cuda``
    on one card runs them: world 1 on NCCL, one world-3 row over gloo,
    both qdev rows and the dplane and hloinspect rows."""
    for r in combos(quick=True):
        if r in (row(np=1, cache="off"), row(np=3)) or r["qdev"] != "off" \
                or r["dplane"] != "off" or r["hloinspect"] != "def":
            yield r


def label(r: dict) -> str:
    return (f"core={r['core']:<7} np={r['np']} fusion={r['fusion']:<3} "
            f"cache={r['cache']:<3} plane={r['plane']:<4} "
            f"wire={r['wire']:<4} metrics={r['metrics']:<3} "
            f"tree={r['tree']:<4} flight={r['flight']:<4} "
            f"ap={r['autopilot']} qdev={r['qdev']} mig={r['migrate']} "
            f"trace={r['trace']} fleet={r['fleet']} dp={r['dplane']} "
            f"hlo={r['hloinspect']}")


def _port_script(body: str) -> str:
    return textwrap.dedent(body).strip() + "\n"


# fault-spec: well-formed specs accepted, malformed ones refused with the
# parser's message, and a malformed spec fails hvd.init() fast.
FAULT_SPEC = _port_script("""
    import os, subprocess, sys
    from horovod_tpu_torch import _core
    for spec in ("", "ring-send:*:*:drop", "ring-recv:0:2:truncate",
                 "coordinator-recv:*:1:delay:50", "frame-header:3:*:corrupt-tag",
                 "ring-send:2:1:die", "ring-send:2:1:die:/tmp/flag",
                 "leader-recv:*:2:drop,super-recv:0:*:delay:5"):
        assert _core.check_fault_spec(spec) == "", spec
    for spec in ("bogus:*:*:drop", "ring-send:*:*:explode", "ring-send:x:*:drop",
                 "ring-send:*:*", "ring-send:*:*:delay:abc"):
        msg = _core.check_fault_spec(spec)
        assert msg, spec
    env = dict(os.environ, HOROVOD_FAULT_INJECT="ring-send:*:*:explode")
    proc = subprocess.run([sys.executable, "-c",
                           "import horovod_tpu_torch as h; h.init(device='cpu')"],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "explode" in proc.stderr, proc.stderr[-800:]
    print("FAULT-SPEC-OK")
""")


def checks(quick: bool):
    """Non-workload rows: ``(name, [argv, ...], cwd[, timeout])``, the
    argvs run in sequence and all must exit 0.

    The reference's C++ selftest rows (``asan``, ``ubsan``, ``chaos``,
    ``ctrl-soak``, ``ctrl-soak-1024``) and its ``lint*`` rows stay with
    it: the port's core is a byte copy of the reference's sources
    without the selftests, pinned by ``tests/test_torch_core.py``."""
    yield ("fault-spec", [[sys.executable, "-c", FAULT_SPEC]], REPO)
    if quick:
        return
    for name, mode in FULL_CHECKS.items():
        yield (name, [[sys.executable, "-c", FAULT_ROWS, mode, REPO]], REPO,
               600.0)
    # The port's test files of these paths run as they are.
    yield ("autopilot-np4",
           [[sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
             os.path.join("tests", "test_torch_autopilot.py"),
             os.path.join("tests", "test_torch_fleet.py")]], REPO, 600.0)
    yield ("migration-np4",
           [[sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
             os.path.join("tests", "test_torch_elastic.py")]], REPO, 600.0)


# The full set's fault rows, one script with a mode: the ranks of a job of
# the port's launcher write what they saw to files (survivors ignore the
# launcher's SIGTERM so each records its exception), and the script holds
# them to the reference's bounds (tests/parallel/test_fault_injection.py,
# test_postmortem.py, test_step_trace.py, test_ctrl_tree_np8.py and
# test_ctrl_tree_depth.py).
FAULT_ROWS = _port_script(r'''
    import glob, json, os, subprocess, sys, tempfile, textwrap
    MODE, REPO = sys.argv[1], sys.argv[2]
    ABORT_S, SLACK_S = 2.0, 13.0
    WORKER = textwrap.dedent("""
        import json, os, signal, sys, time, urllib.request
        import numpy as np
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.context import HorovodContext
        from horovod_tpu_torch.exceptions import HorovodInternalError
        mode, out_dir = sys.argv[1], sys.argv[2]
        r = int(os.environ.get("HOROVOD_RANK", "-1"))
        out = {"rank": r, "error": "", "elapsed": -1.0}
        if mode == "collapse":
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
            t0 = time.monotonic()
            try:
                hvd.init(device="cpu")
                assert hvd.flight_record().get("rank") == r
                for i in range(2000):
                    t0 = time.monotonic()
                    hvd.allreduce(np.full(1024, float(r), np.float32),
                                  op=hvd.Sum, name=f"pm.{i % 8}")
            except HorovodInternalError as exc:
                out["error"] = str(exc)
                out["elapsed"] = time.monotonic() - t0
        else:
            hvd.init(device="cpu")
            if mode == "delay":
                for i in range(25):
                    hvd.allreduce(np.full(32, float(r), np.float32),
                                  op=hvd.Sum, name=f"d.{i}")
                hvd.barrier()
                if r == 0:
                    port = HorovodContext.instance().cockpit.port
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/state",
                            timeout=10) as rsp:
                        out["state"] = json.loads(rsp.read())
            else:  # tree: every collective, results by name
                t = out["tensors"] = {}
                for i in range(3):
                    t[f"ctd.ar.{i}"] = hvd.allreduce(
                        np.arange(16, dtype=np.float32) * (r + 1) + i,
                        op=hvd.Sum, name=f"ctd.ar.{i}").tolist()
                t["ctd.ag"] = hvd.allgather(
                    np.full((r + 1, 2), float(r), np.float32),
                    name="ctd.ag").tolist()
                t["ctd.bc"] = hvd.broadcast(
                    np.full(8, float(r * 10 + 7), np.float32), root_rank=5,
                    name="ctd.bc").tolist()
                hvd.barrier()
        with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
            json.dump(out, f)
        try:
            hvd.shutdown()
        except Exception:
            pass
    """)


    def launch(np_, mode, out_dir, **env):
        os.makedirs(out_dir, exist_ok=True)
        worker = os.path.join(out_dir, "worker.py")
        with open(worker, "w") as f:
            f.write(WORKER)
        full = dict(os.environ, HOROVOD_SHM_DISABLE="1",
                    HOROVOD_ABORT_PROPAGATION_TIMEOUT=str(ABORT_S), **env)
        full["PYTHONPATH"] = REPO + os.pathsep + full.get("PYTHONPATH", "")
        return subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
             str(np_), sys.executable, worker, mode, out_dir], env=full,
            capture_output=True, text=True, timeout=300, cwd=REPO)


    def ranks(out_dir, which):
        res = {}
        for r in which:
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                res[r] = json.load(f)
        return res


    def collapse(out_dir, **env):
        # Rank 1 dies at its 200th ring send: every survivor's collective
        # fails naming it within the abort bound, not a TCP timeout.
        latch = os.path.join(out_dir, "die.latch")
        proc = launch(4, "collapse", out_dir, HOROVOD_HIER_FAKE_HOSTS="2",
                      HOROVOD_FAULT_INJECT=f"ring-send:200:1:die:{latch}",
                      **env)
        assert proc.returncode != 0 and os.path.exists(latch), proc.stderr
        assert not os.path.exists(os.path.join(out_dir, "rank1.json"))
        for r, out in ranks(out_dir, (0, 2, 3)).items():
            assert "culprit rank 1" in out["error"], out
            slack = SLACK_S + (ABORT_S if r == 0 else 0)
            assert 0 <= out["elapsed"] < ABORT_S + slack, out


    with tempfile.TemporaryDirectory() as td:
        if MODE == "fault":
            collapse(os.path.join(td, "death"))
            # A corrupted frame tag on rank 2 fails every rank fast.
            tag = os.path.join(td, "tag")
            launch(4, "collapse", tag, HOROVOD_HIER_FAKE_HOSTS="2",
                   HOROVOD_FAULT_INJECT="frame-header:300:2:corrupt-tag")
            for out in ranks(tag, range(4)).values():
                assert out["error"], out
                assert 0 <= out["elapsed"] < ABORT_S + SLACK_S, out
        elif MODE == "postmortem":
            pm = os.path.join(td, "bundle")
            collapse(td, HOROVOD_POSTMORTEM_DIR=pm)
            with open(os.path.join(pm, "postmortem.json")) as f:
                doc = json.load(f)
            assert doc["schema"] == "hvd-postmortem-v1", doc
            assert (doc["world_size"], doc["culprit_rank"]) == (4, 1), doc
            assert doc["missing_ranks"] == [1], doc
            trace = os.path.join(td, "merged.json")
            proc = subprocess.run(
                [sys.executable, os.path.join(REPO, "tools", "postmortem.py"),
                 pm, "--trace", trace], capture_output=True, text=True,
                timeout=60)
            assert proc.returncode == 0, proc.stdout + proc.stderr
            assert "rank 1" in proc.stdout and "culprit" in proc.stdout
            assert "fault_trip" in proc.stdout, proc.stdout
            with open(trace) as f:
                merged = json.load(f)
            assert {e["pid"] for e in merged if e.get("ph") == "i"} == \
                {0, 1, 2, 3}
        elif MODE == "cockpit":
            # Every coordinator receive from rank 3 sleeps 25 ms: the other
            # ranks stall in negotiation, and both surfaces must say so.
            proc = launch(4, "delay", td, HOROVOD_COCKPIT="1",
                          HOROVOD_METRICS="1", HOROVOD_POSTMORTEM_DIR=td,
                          HOROVOD_FAULT_INJECT="coordinator-recv:*:3:delay:25")
            assert proc.returncode == 0, proc.stdout + proc.stderr
            state = ranks(td, (0,))[0]["state"]
            assert state["schema"] == "cockpit-state-v1", state
            assert (state["rank"], state["world"]) == (0, 4)
            steps = state["steps"]
            hits = sum(1 for f in steps if f["dominant_rank"] == 3 and
                       f["dominant_phase"] == "negotiation_wait")
            assert len(steps) >= 10 and hits > len(steps) / 2, steps[:5]
            dumps = sorted(glob.glob(os.path.join(td, "steptrace.*.json")))
            assert len(dumps) == 4, dumps
            proc = subprocess.run(
                [sys.executable, os.path.join(REPO, "tools",
                                              "critical_path.py"),
                 *dumps, "--json"], capture_output=True, text=True,
                timeout=60)
            assert proc.returncode == 0, proc.stdout + proc.stderr
            summary = json.loads(proc.stdout)["summary"]
            assert summary["ranks"] == [0, 1, 2, 3], summary
            assert (summary["dominant_rank"], summary["dominant_phase"]) \
                == (3, "negotiation_wait"), summary
            assert summary["dominant_steps"] > summary["steps"] / 2
            assert summary["bubble_fraction"] > 0.5, summary
        else:  # tree: flat == depth 2 == depth 3 at np=8 over 4 fake hosts
            got = {}
            for name, env in (("flat", {"HOROVOD_CONTROL_TREE": "off"}),
                              ("d2", {"HOROVOD_CONTROL_TREE": "on"}),
                              ("d3", {"HOROVOD_CONTROL_TREE": "on",
                                      "HOROVOD_CONTROL_TREE_DEPTH": "3"})):
                out = os.path.join(td, name)
                proc = launch(8, "tree", out, HOROVOD_HIER_FAKE_HOSTS="4",
                              **env)
                assert proc.returncode == 0, proc.stdout + proc.stderr
                got[name] = [r["tensors"] for r in
                             ranks(out, range(8)).values()]
            assert got["flat"] == got["d2"] == got["d3"]
            assert got["flat"][0]["ctd.ar.0"] == [
                float(36 * k) for k in range(16)]
    print(f"CHECK-OK {MODE}")
''')

FULL_CHECKS = {"fault-np4": "fault", "postmortem-np4": "postmortem",
               "cockpit-np4": "cockpit", "ctrl-np8": "tree"}
# The repo's files the full set's check rows run: its tools read the
# port's dumps, and the port's test files of the autopilot, fleet and
# elastic paths.
CHECKOUT_FILES = ("tools/postmortem.py", "tools/critical_path.py",
                  "tests/test_torch_autopilot.py", "tests/test_torch_fleet.py",
                  "tests/test_torch_elastic.py")


def checkout_missing() -> List[str]:
    """The files of :data:`CHECKOUT_FILES` that ``REPO`` lacks (all of
    them where the package was installed without its checkout)."""
    return [f for f in CHECKOUT_FILES
            if not os.path.isfile(os.path.join(REPO, *f.split("/")))]


def run_check(cmds, cwd: str, timeout: float) -> tuple:
    t0 = time.monotonic()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for cmd in cmds:
        try:
            proc = subprocess.run(cmd, cwd=cwd, capture_output=True,
                                  text=True, timeout=timeout, env=env)
        except subprocess.TimeoutExpired as exc:
            return False, time.monotonic() - t0, f"timeout: {exc}"
        if proc.returncode != 0:
            return False, time.monotonic() - t0, \
                (proc.stdout + proc.stderr)[-800:]
    return True, time.monotonic() - t0, ""


# Knobs a row owns: an ambient setting is popped before the row sets its
# own (the reference's run_combo list).
OWNED_KNOBS = (
    # The plane axis: an ambient setting would silently collapse the
    # pipelined-vs-legacy distinction.
    "HOROVOD_RING_CHUNK_BYTES", "HOROVOD_HIERARCHICAL_ALLREDUCE",
    "HOROVOD_HIER_FAKE_HOSTS",
    # The wire and qdev axes: ambient codec settings would skew both the
    # exact asserts and the demotion rows.
    "HOROVOD_WIRE_COMPRESSION", "HOROVOD_WIRE_COMPRESSION_MIN_BYTES",
    "HOROVOD_DEVICE_SCHEDULE",
    # The metrics axis: an ambient metrics file would make every row
    # write snapshot files.
    "HOROVOD_METRICS", "HOROVOD_METRICS_FILE", "HOROVOD_METRICS_INTERVAL",
    # Faults belong to the dedicated check rows only.
    "HOROVOD_FAULT_INJECT",
    # The ctrl_tree axis owns the control-plane topology knobs.
    "HOROVOD_CONTROL_TREE", "HOROVOD_CONTROL_TREE_DEPTH",
    "HOROVOD_CTRL_TREE_FANOUT",
    # The flight axis; an ambient postmortem dir would scatter crash
    # bundles on every failing row.
    "HOROVOD_FLIGHT_RECORDER", "HOROVOD_FLIGHT_RECORDER_SLOTS",
    "HOROVOD_POSTMORTEM_DIR",
    # The autopilot axis (its port is per-generation driver state).
    "HOROVOD_AUTOPILOT", "HOROVOD_AUTOPILOT_PORT",
    # The migrate axis: an ambient setting would make every row pay the
    # replication alltoall per commit.
    "HOROVOD_MIGRATE_REPLICAS", "HOROVOD_MIGRATE_INTERVAL_STEPS",
    # The trace axis, and the cockpit, which binds a listener.
    "HOROVOD_STEP_TRACE", "HOROVOD_STEP_TRACE_SLOTS", "HOROVOD_COCKPIT",
    "HOROVOD_COCKPIT_PORT",
    # The fleet axis; an ambient sentinel threshold would skew the
    # anomaly-free expectation of "on" rows.
    "HOROVOD_FLEET_TELEMETRY", "HOROVOD_SENTINEL_ZSCORE",
    # The dplane and hloinspect axes.
    "HOROVOD_DATA_PLANE", "HOROVOD_HLO_INSPECT",
    # The core and the device: the row and --device decide them.
    "HVD_TPU_PURE_PY", "HOROVOD_CONTROLLER", "HOROVOD_GPU_OPERATIONS",
    "HOROVOD_FUSION_THRESHOLD", "HOROVOD_CACHE_CAPACITY",
)

# An autopilot decision line of the elastic driver's policy thread.
_DECISION_RE = re.compile(r"^autopilot: (evict|readmit|scale_up)\b", re.M)
_REPORT_RE = re.compile(r"WORKLOAD-REPORT (\{.*\})")


def row_env(r: dict, device: str, cards: int = 1) -> dict:
    """The environment of one row's ranks; ``cards`` is the number of
    cards a ``cuda`` row may use."""
    env = dict(os.environ)
    for knob in OWNED_KNOBS:
        env.pop(knob, None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["HVD_MATRIX_DEVICE"] = device
    if device == "cuda":
        # Inductor compiles in the rank's own process: a pool of compile
        # workers a rank, in several rows at once, oversubscribes the host
        # for the few kernels of a row's step.
        env["TORCHINDUCTOR_COMPILE_THREADS"] = "1"
    if device == "cuda" and r["np"] > cards:
        # More ranks than cards: every rank on the first card, over gloo
        # (NCCL refuses two ranks on one card).
        env["HVD_MATRIX_DEVICE"] = "cuda:0"
        env["HOROVOD_GPU_OPERATIONS"] = "GLOO"
    if r["core"] == "purepy":
        env["HVD_TPU_PURE_PY"] = "1"
    if r["fusion"] == "off":
        env["HOROVOD_FUSION_THRESHOLD"] = "0"
    if r["cache"] == "off":
        env["HOROVOD_CACHE_CAPACITY"] = "0"
    plane = r["plane"]
    if plane in ("tcp", "tcp0"):
        env["HOROVOD_SHM_DISABLE"] = "1"
    if plane == "tcp0":
        env["HOROVOD_RING_CHUNK_BYTES"] = "0"  # legacy whole-segment frames
    if plane == "hier":
        # Two fake hosts carved out of the rank space: block partition, so
        # np=3 gives hosts {0,1} + {2}, the smallest hierarchical topology.
        env["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
        env["HOROVOD_HIER_FAKE_HOSTS"] = "2"
    # The wire and qdev axes share one knob: a bare codec is the host
    # plane's, the per-plane syntax once the device ring is in play.
    qdev, wire = r["qdev"], r["wire"]
    planes = []
    if wire != "none":
        planes.append(f"host={wire}" if qdev != "off" else wire)
    if qdev != "off":
        qcodec, _, qsched = qdev.partition(":")
        planes.append(f"device={'int8' if qcodec == 'demote' else qcodec}")
        if qsched:
            env["HOROVOD_DEVICE_SCHEDULE"] = qsched
        env["HVD_MATRIX_QDEV"] = qdev
        # The device plane holds a fused bucket's padded length against
        # the floor, and no bucket is shorter than 1,024 elements (4 KiB),
        # so the floor sits above that: the workload's small tensors stay
        # exact, its 16 KiB qdev tensor and big payload ride the codec.
        env["HOROVOD_WIRE_COMPRESSION_MIN_BYTES"] = str(
            (1 << 30) if qdev == "demote" else QDEV_FLOOR)
    if planes:
        env["HOROVOD_WIRE_COMPRESSION"] = ",".join(planes)
    if r["metrics"] == "on":
        env["HOROVOD_METRICS"] = "1"
    if r["tree"] == "d3":
        # A forced three-level tree needs >= 3 leaders: three single-rank
        # fake hosts give the chain coordinator <- super <- leaf leader.
        env["HOROVOD_CONTROL_TREE"] = "on"
        env["HOROVOD_CONTROL_TREE_DEPTH"] = "3"
        env["HOROVOD_HIER_FAKE_HOSTS"] = "3"
    elif r["tree"] != "auto":
        env["HOROVOD_CONTROL_TREE"] = r["tree"]
    if r["flight"] == "on":
        env["HOROVOD_FLIGHT_RECORDER"] = "1"
    elif r["flight"] == "off":
        env["HOROVOD_FLIGHT_RECORDER"] = "off"
    if r["autopilot"] == "on":
        # Routes the launch through the elastic driver with the policy
        # thread attached; the driver forces HOROVOD_METRICS=1.
        env["HOROVOD_AUTOPILOT"] = "1"
    if r["migrate"] == "on":
        env["HVD_MATRIX_MIGRATE"] = "on"
        env["HOROVOD_MIGRATE_REPLICAS"] = "2"
        env["HOROVOD_MIGRATE_INTERVAL_STEPS"] = "1"
    if r["trace"] == "on":
        env["HOROVOD_STEP_TRACE"] = "1"
    elif r["trace"] == "off":
        env["HOROVOD_STEP_TRACE"] = "0"
    if r["dplane"] != "off":
        env["HVD_MATRIX_DPLANE"] = r["dplane"]
        if r["dplane"] == "gspmd":
            env["HOROVOD_DATA_PLANE"] = "gspmd"
    if r["hloinspect"] != "def":
        env["HVD_MATRIX_HLOINSPECT"] = r["hloinspect"]
        env["HOROVOD_HLO_INSPECT"] = "1" if r["hloinspect"] == "on" else "0"
    if r["fleet"] == "on":
        # The fleet plane rides the metrics registry.
        env["HOROVOD_FLEET_TELEMETRY"] = "1"
        env["HOROVOD_METRICS"] = "1"
    elif r["fleet"] == "off":
        env["HOROVOD_FLEET_TELEMETRY"] = "0"
    return env


def run_combo(r: dict, script: str, timeout: float,
              device: str = "cpu", cards: int = 1) -> tuple:
    """Run the workload on one row: ``(ok, seconds, detail, reports)``,
    ``reports`` the ranks' ``WORKLOAD-REPORT`` objects."""
    env = row_env(r, device, cards)
    np_ = r["np"]
    if np_ == 1:
        cmd = [sys.executable, script]
    else:
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
               "-np", str(np_), sys.executable, script]
    t0 = time.monotonic()
    try:
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=timeout, cwd=REPO)
    except subprocess.TimeoutExpired as exc:
        return False, time.monotonic() - t0, f"timeout: {exc}", []
    out = proc.stdout + proc.stderr
    reports = [json.loads(m.group(1)) for m in _REPORT_RE.finditer(out)]
    ok = proc.returncode == 0 and proc.stdout.count("WORKLOAD-OK") == np_
    if ok and r["autopilot"] == "on" and _DECISION_RE.search(proc.stderr):
        ok = False  # a healthy fleet takes no decision
    detail = "" if ok else out[-800:]
    return ok, time.monotonic() - t0, detail, sorted(
        reports, key=lambda rep: rep.get("rank", 0))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="covering subset instead of the full product")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the ranks' device (default: the card)")
    ap.add_argument("--card", action="store_true",
                    help="only the quick rows whose tensors reach the card "
                         "(no check rows)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="rows run at once (default 1)")
    ap.add_argument("--report", default=None, metavar="FILE",
                    help="write each row's result and its ranks' reports "
                         "as JSON")
    ap.add_argument("--timeout", type=float, default=180.0)
    args = ap.parse_args(argv)
    cards = 0
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("test_matrix: --device cuda needs a card; pass --device "
                  "cpu to run on the CPU", file=sys.stderr)
            return 2
        cards = torch.cuda.device_count()

    missing = [] if args.quick or args.card else checkout_missing()
    if missing:
        print(f"test_matrix: the full set's check rows run the repo's "
              f"{', '.join(missing)}, which {REPO} lacks; run it from a "
              "checkout of the repo, or pass --quick", file=sys.stderr)
        return 2

    failures, results = [], []
    if not args.card:
        for item in checks(args.quick):
            name, cmds, cwd = item[:3]
            lab = f"check={name}"
            timeout = item[3] if len(item) > 3 else args.timeout
            ok, dt, detail = run_check(cmds, cwd, timeout)
            print(f"{'PASS' if ok else 'FAIL'}  {lab}  ({dt:5.1f}s)",
                  flush=True)
            results.append({"row": lab, "ok": ok, "seconds": dt})
            if not ok:
                failures.append((lab, detail))
    rows = list(card_rows() if args.card else combos(args.quick))
    with tempfile.TemporaryDirectory(prefix="hvd_matrix_") as td:
        script = os.path.join(td, "workload.py")
        with open(script, "w") as f:
            f.write(WORKLOAD)
        with ThreadPoolExecutor(max(1, args.jobs)) as pool:
            # The compiled rows take longest: they start first.
            first = sorted(rows, key=lambda r: (r["dplane"], r["hloinspect"])
                           == ("off", "def"))
            futures = {id(r): pool.submit(run_combo, r, script, args.timeout,
                                          args.device, cards) for r in first}
            for r in rows:
                ok, dt, detail, reports = futures[id(r)].result()
                lab = label(r)
                print(f"{'PASS' if ok else 'FAIL'}  {lab}  ({dt:5.1f}s)",
                      flush=True)
                results.append({"row": lab, "axes": r, "ok": ok,
                                "seconds": dt, "ranks": reports})
                if not ok:
                    failures.append((lab, detail))
    if args.report:
        with open(args.report, "w") as f:
            json.dump({"device": args.device, "rows": results}, f, indent=1)
    for lab, detail in failures:
        print(f"\n--- {lab} ---\n{detail}", file=sys.stderr)
    print(f"\n{'ALL PASS' if not failures else f'{len(failures)} FAILED'}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
