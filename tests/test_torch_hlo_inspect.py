"""The port's collective inventory (``horovod_tpu_torch/ops/hlo_inspect.py``)
against the JAX package's ``horovod_tpu/ops/hlo_inspect.py``.

The reference walks a compiled HLO module; the port walks the FX graphs
AOTAutograd hands the compiler.  What must agree is the model of an
inventory: the kinds, the fields of an op and of a trace, and the ring
model's wire bytes to the byte.  The graphs here come from a world of two
formed in this process on torch's ``fake`` backend (collectives that
return at once), so a group of two exists without peers: ``make_fx``
captures each functional collective, and ``instrument`` compiles a step
over ``aot_eager`` on DTensor parameters.  Numbers are not the point of
those steps; the collectives in their graphs are.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from horovod_tpu.ops import hlo_inspect as jhi
from horovod_tpu_torch.ops import hlo_inspect as thi

GROUPS = range(1, 9)
PAYLOADS = sorted({0, 1, 2, 3, 7, 8, 255, 256, 1000, 4097, 65535,
                   *np.random.default_rng(0).integers(0, 1 << 20, 24).tolist(),
                   1 << 20})


@pytest.fixture(autouse=True)
def _fresh():
    thi.reset()
    yield
    thi.reset()


@pytest.fixture(scope="module")
def fake_world():
    """A process group of two on the ``fake`` backend, and the 1-D batch
    mesh over it."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        yield DeviceMesh.from_group(dist.group.WORLD, "cpu",
                                    mesh_dim_names=("batch",))
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


def test_kinds_and_fields_are_the_references():
    assert thi.COLLECTIVE_KINDS == jhi.COLLECTIVE_KINDS
    for cls in ("CollectiveOp", "TraceInventory"):
        assert ([f.name for f in dataclasses.fields(getattr(thi, cls))] ==
                [f.name for f in dataclasses.fields(getattr(jhi, cls))])
    op = dict(kind="all-reduce", name="x", dtype="f32", shape="f32[4]",
              elements=4, raw_bytes=16, group_size=2, wire_bytes=16,
              asynchronous=True)
    got = thi.TraceInventory("l", 2, [thi.CollectiveOp(**op)], 16, 16)
    want = jhi.TraceInventory("l", 2, [jhi.CollectiveOp(**op)], 16, 16)
    assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("kind", jhi.COLLECTIVE_KINDS)
def test_ring_wire_bytes_match_the_reference(kind):
    for g in GROUPS:
        for raw in PAYLOADS:
            assert thi.ring_wire_bytes(kind, raw, g) == \
                jhi.ring_wire_bytes(kind, raw, g), (kind, raw, g)


def test_inventory_of_each_functional_collective(fake_world):
    """One captured graph with every functional collective: each op once,
    its ``wait_tensor`` not counted, a coalesced one summed over its
    outputs, a reduce-scatter's payload its output times the group."""
    import torch.distributed._functional_collectives as funcol
    from torch.fx.experimental.proxy_tensor import make_fx

    group = dist.group.WORLD

    def collectives(x, y):
        return (funcol.all_reduce(x, "sum", group),
                funcol.all_gather_tensor(x, 0, group),
                funcol.reduce_scatter_tensor(x, "sum", 0, group),
                funcol.all_to_all_single(x, None, None, group),
                funcol.all_reduce_coalesced([x, y], "sum", group),
                funcol.all_gather_into_tensor_coalesced([x, y], group),
                funcol.reduce_scatter_tensor_coalesced([x, y], "sum", [0, 0],
                                                       group))

    gm = make_fx(collectives, tracing_mode="fake")(
        torch.zeros(4, 3), torch.zeros(6, dtype=torch.bfloat16))
    waits = [n for n in gm.graph.nodes if "wait_tensor" in str(n.target)]
    assert len(waits) == 10
    inv = thi.inventory_from_graph([gm], label="all")
    rows = [(op.kind, op.dtype, op.shape, op.elements, op.raw_bytes,
             op.group_size, op.wire_bytes, op.asynchronous)
            for op in inv.ops]
    assert rows == [
        ("all-reduce", "f32", "f32[4,3]", 12, 48, 2, 48, True),
        ("all-gather", "f32", "f32[8,3]", 24, 96, 2, 48, True),
        ("reduce-scatter", "f32", "f32[2,3]", 6, 48, 2, 24, True),
        ("all-to-all", "f32", "f32[4,3]", 12, 48, 2, 24, True),
        ("all-reduce", "f32", "(f32[4,3], bf16[6])", 18, 60, 2, 60, True),
        ("all-gather", "f32", "(f32[8,3], bf16[12])", 36, 120, 2, 60,
         True),
        ("reduce-scatter", "f32", "(f32[2,3], bf16[3])", 9, 60, 2, 30,
         True)]
    for op in inv.ops:
        assert op.wire_bytes == jhi.ring_wire_bytes(op.kind, op.raw_bytes,
                                                    op.group_size)
    assert (inv.world, inv.collectives, inv.raw_bytes, inv.wire_bytes) == \
        (2, 7, sum(r[4] for r in rows), sum(r[6] for r in rows))
    assert inv.kind_counts() == {"all-reduce": 2, "all-gather": 2,
                                 "reduce-scatter": 2, "all-to-all": 1}
    assert "collective-permute" not in inv.kind_counts()


def _linear_step(mesh, plane):
    """A DTensor linear model, its DistributedOptimizer on ``plane`` and
    one step on a ``Shard(0)`` batch."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    import horovod_tpu_torch as hvd

    params = {"w": torch.nn.Parameter(distribute_tensor(
                  torch.zeros(4), mesh, [Replicate()])),
              "b": torch.nn.Parameter(distribute_tensor(
                  torch.zeros(()), mesh, [Replicate()]))}
    opt = hvd.DistributedOptimizer(torch.optim.SGD(params.values(), lr=0.1),
                                   named_parameters=params.items(),
                                   plane=plane, mesh=mesh)

    def step(x, y):
        loss = ((x @ params["w"] + params["b"] - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.zero_grad()
        return loss

    x = DTensor.from_local(torch.ones(8, 4), mesh, [Shard(0)],
                           run_check=False)
    y = DTensor.from_local(torch.ones(8), mesh, [Shard(0)], run_check=False)
    return step, (x, y)


def test_instrument_records_the_gspmd_step_once(fake_world, monkeypatch):
    monkeypatch.delenv("HOROVOD_HLO_INSPECT", raising=False)
    step, args = _linear_step(fake_world, "gspmd")
    sink = []
    thi.set_native_sink(lambda *a: sink.append(a))
    try:
        fn = thi.instrument(step, label="linear", backend="aot_eager")
        for _ in range(3):
            fn(*args)
    finally:
        thi.set_native_sink(None)
    (inv,) = thi.inventories()
    assert inv.label == "linear" and inv.cost == {}
    assert inv.kind_counts() == {"all-reduce": 2}
    assert inv.raw_bytes == 4 * 4 + 4 and inv.wire_bytes == inv.raw_bytes
    assert thi.counters() == {
        "gspmd_collectives_total": 2, "gspmd_raw_bytes": inv.raw_bytes,
        "gspmd_wire_bytes": inv.wire_bytes, "gspmd_traces_total": 1}
    assert thi.gspmd_byte_counters() == (inv.raw_bytes, inv.wire_bytes)
    assert sink == [(2, inv.raw_bytes, inv.wire_bytes)]


def test_an_eager_plane_step_reports_empty(fake_world, monkeypatch):
    """On the eager plane DTensor still reduces the ``Partial`` gradients
    inside the compiled step (the inner SGD needs their values), but the
    step is not the gspmd plane's: nothing is recorded."""
    monkeypatch.delenv("HOROVOD_HLO_INSPECT", raising=False)
    step, args = _linear_step(fake_world, "eager")
    fn = thi.instrument(step, label="eager", backend="aot_eager")
    fn(*args)
    assert thi.inventories() == []
    assert thi.counters()["gspmd_traces_total"] == 0


def test_disabled_inspection_returns_the_function(monkeypatch):
    monkeypatch.setenv("HOROVOD_HLO_INSPECT", "0")

    def step():
        return 1

    assert thi.instrument(step) is step
    monkeypatch.setenv("HOROVOD_HLO_INSPECT", "1")
    assert thi.instrument(step) is not step


def test_note_inventory_forwards_to_the_native_sink():
    op = thi.CollectiveOp("all-reduce", "n", "f32", "f32[8]", 8, 32, 4, 48,
                          True)
    inv = thi.TraceInventory("t", 4, [op, op], 64, 96)
    sink = []
    thi.set_native_sink(lambda *a: sink.append(a))
    try:
        thi.note_inventory(inv)
    finally:
        thi.set_native_sink(None)
    thi.note_inventory(inv)  # no sink: the counters only
    assert sink == [(2, 64, 96)]
    assert thi.counters() == {"gspmd_collectives_total": 4,
                              "gspmd_raw_bytes": 128,
                              "gspmd_wire_bytes": 192,
                              "gspmd_traces_total": 2}
    assert [i.label for i in thi.inventories()] == ["t", "t"]


def test_mark_plane_gates_and_tags(monkeypatch):
    """The plane marks: the last one is what the instrumented step reads,
    and each change (not each mark) reaches the core's step-trace tag."""
    import types

    from horovod_tpu_torch.context import HorovodContext

    notes = []
    core = types.SimpleNamespace(step_trace_note_plane=notes.append)
    monkeypatch.setattr(HorovodContext, "_instance",
                        types.SimpleNamespace(core=core))
    thi._begin_trace()
    assert thi._end_trace() is None
    for plane in ("eager", "gspmd", "gspmd", "other", "eager"):
        thi.mark_plane(plane)
        assert thi._end_trace() == plane
    assert notes == [0, 1, 0]
