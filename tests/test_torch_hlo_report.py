"""The port's compiled-step report (``horovod_tpu_torch/tools/
hlo_report.py``) and the parser under it,
``horovod_tpu_torch.ops.hlo_inspect.inventory_from_text``, against the
walk of the same graphs and the JAX package's ``tools/hlo_report.py``.

The parser reads the code ``GraphModule.print_readable`` prints (what
``hlo_inspect.write_graphs`` saves); for the same graphs it must give the
inventory :func:`inventory_from_graph` walks, in every field.  The graphs
come from a world of two on torch's ``fake`` backend, as in
``tests/test_torch_hlo_inspect.py``.  The report must print the
reference's lines for an equivalent inventory and for the same crash
bundle, exit 1 on a ``--metrics`` mismatch, and pass its ``--live`` check
on the CPU.
"""

import importlib.util
import io
import json
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from horovod_tpu.ops import hlo_inspect as jhi
from horovod_tpu_torch.ops import hlo_inspect as thi
from horovod_tpu_torch.tools import hlo_report as thr

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _fresh():
    thi.reset()
    yield
    thi.reset()


@pytest.fixture(scope="module")
def fake_world():
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


@pytest.fixture(scope="module")
def reference_report():
    """The JAX package's ``tools/hlo_report.py``, imported from its file."""
    spec = importlib.util.spec_from_file_location(
        "reference_hlo_report", REPO / "tools" / "hlo_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _every_collective():
    """One captured graph with every functional collective (the graph of
    ``test_inventory_of_each_functional_collective``)."""
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

    return make_fx(collectives, tracing_mode="fake")(
        torch.zeros(4, 3), torch.zeros(6, dtype=torch.bfloat16))


def test_text_equals_the_walk_for_each_functional_collective(fake_world):
    gm = _every_collective()
    text = gm.print_readable(print_output=False)
    walked = thi.inventory_from_graph([gm], world=2, label="all")
    assert walked.collectives == 7
    assert thi.inventory_from_text(text, world=2, label="all").to_dict() == \
        walked.to_dict()
    # A saved file states its world in its header.
    header = "# hlo_inspect: label=all world=2\n"
    assert thi.module_partitions(header + text) == 2
    assert thi.module_partitions(text) == 0
    assert thi.inventory_from_text(header + text, label="all").to_dict() == \
        thi.inventory_from_graph([gm], label="all").to_dict()
    # The reference's text parser has the same defaults: no collective,
    # world 1.
    assert thi.inventory_from_text("").to_dict() == \
        jhi.inventory_from_text("").to_dict()


def test_text_equals_the_walk_on_the_gpt_tiny_gspmd_step(fake_world,
                                                        tmp_path,
                                                        monkeypatch):
    """GPT_TINY on DTensor parameters, one gspmd step through
    ``instrument``: each recorded graph's saved code parses to the walk of
    that graph, and the files' totals are the step's inventory (an
    all-reduce of every parameter's gradient)."""
    from torch.distributed.tensor import DTensor, Shard, distribute_module

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import models

    monkeypatch.delenv("HOROVOD_HLO_INSPECT", raising=False)
    torch.manual_seed(0)
    model = models.GPT(models.GPT_TINY)
    distribute_module(model, fake_world)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(), plane="gspmd",
        mesh=fake_world)

    def step(ids):
        loss = models.lm_loss(model(ids), ids)
        loss.backward()
        opt.step()
        opt.zero_grad()
        return loss

    ids = torch.randint(0, models.GPT_TINY.vocab_size, (2, 32),
                        generator=torch.Generator().manual_seed(1))
    thi.instrument(step, label="gpt_tiny", backend="aot_eager")(
        DTensor.from_local(ids, fake_world, [Shard(0)], run_check=False))
    (inv,) = thi.inventories()
    ((label, world, graphs, groups),) = thi._RECORDED
    assert (label, world) == ("gpt_tiny", 2)
    assert list(groups.values()) == [2]
    paths = thi.write_graphs(str(tmp_path), "gpt_tiny")
    assert len(paths) == len(graphs) >= 2
    parsed = []
    for path, gm in zip(paths, graphs):
        name = Path(path).name
        got = thi.inventory_from_text(Path(path).read_text(), label=name)
        assert got.to_dict() == thi.inventory_from_graph(
            [gm], world=2, label=name).to_dict()
        parsed.append(got)
    assert sum(i.collectives for i in parsed) == inv.collectives > 0
    assert (sum(i.raw_bytes for i in parsed),
            sum(i.wire_bytes for i in parsed)) == \
        (inv.raw_bytes, inv.wire_bytes)
    assert inv.raw_bytes == sum(p.numel() * p.element_size()
                                for p in model.parameters())
    assert [i.to_dict() for i in thr.inventories_from_files(paths)] == \
        [i.to_dict() for i in parsed]


def _ops(mod):
    return [mod.CollectiveOp("all-reduce", "all_reduce", "f32", "f32[4,3]",
                             12, 48, 2, 48, True),
            mod.CollectiveOp("reduce-scatter", "rs_1", "bf16",
                             "(bf16[2,3], f32[3])", 9, 60, 2, 30, False)]


@pytest.mark.parametrize("case", ["ops", "empty", "cost"])
def test_render_inventory_prints_the_references_lines(reference_report,
                                                      case):
    def inventory(mod):
        ops = [] if case == "empty" else _ops(mod)
        inv = mod.TraceInventory("step.0.py", 2, ops,
                                 sum(o.raw_bytes for o in ops),
                                 sum(o.wire_bytes for o in ops))
        if case == "cost":
            inv.cost = {"flops": 1234.0, "bytes accessed": 56.5}
        return inv

    got, want = io.StringIO(), io.StringIO()
    thr.render_inventory(inventory(thi), out=got)
    reference_report.render_inventory(inventory(jhi), out=want)
    assert got.getvalue() == want.getvalue()
    assert "num_partitions=2" in got.getvalue()


def test_render_bundle_prints_the_references_lines(reference_report,
                                                   tmp_path):
    types = {"16": "hloinspect", "3": "cycle"}
    (tmp_path / "postmortem.json").write_text(json.dumps({
        "types": types,
        "ranks": {"0": {"events": [[10, 1, 16, 7, 149, 652437504],
                                   [11, 2, 3, 7, 1, 2]]},
                  "1": {"events": [[12, 1, 16, 7, 5, 40]]}}}))
    (tmp_path / "flight.1.json").write_text(json.dumps({
        "types": types, "events": [[13, 1, 16, 7, 2, 16],
                                   [14, 2, 16, 7, 2, 16]]}))
    (tmp_path / "flight.x.json").write_text("not a flight dump")
    tally = thr.bundle_hlo_events(str(tmp_path))
    assert tally == reference_report.bundle_hlo_events(str(tmp_path))
    assert tally == {0: {"traces": 1, "ops": 149, "wire_bytes": 652437504},
                     1: {"traces": 2, "ops": 4, "wire_bytes": 32}}
    for t in (tally, {}):
        got, want = io.StringIO(), io.StringIO()
        thr.render_bundle(t, out=got)
        reference_report.render_bundle(t, out=want)
        assert got.getvalue() == want.getvalue()


def test_metrics_mismatch_exits_one(fake_world, tmp_path, capsys):
    gm = _every_collective()
    graph = tmp_path / "all.0.py"
    graph.write_text("# hlo_inspect: label=all world=2\n"
                     + gm.print_readable(print_output=False))
    inv = thi.inventory_from_graph([gm], world=2)
    metrics = tmp_path / "metrics.json"
    for raw, rc in ((inv.raw_bytes, 0), (inv.raw_bytes + 1, 1)):
        metrics.write_text(json.dumps({"counters": {
            "gspmd_raw_bytes": raw, "gspmd_wire_bytes": inv.wire_bytes}}))
        assert thr.main([str(graph), "--metrics", str(metrics)]) == rc
        out = capsys.readouterr().out
        assert ("MISMATCH" in out) == bool(rc)
    assert thr.main([str(graph), "--metrics", str(metrics), "--json"]) == 1
    result = json.loads(capsys.readouterr().out)
    assert result["metrics_match"] is False
    assert result["traces"][0]["raw_bytes"] == inv.raw_bytes


def test_live_check_on_the_cpu_exits_zero(capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert thr.main(["--live", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("-> MATCH") == thr.LIVE_WORLD
    assert "all-reduce" in out
