"""``horovod_tpu_torch.ops.hlo_inspect`` over collectives of subgroups: on
a 2 x 2 mesh of a world of four (torch's ``fake`` backend), each
collective runs over a line of two ranks.  The file
:func:`write_graphs` saves states each group's size, so the parsed
inventory gives every collective its group's size, as the walk does, and
not the world's."""

import pytest
import torch
import torch.distributed as dist

from horovod_tpu_torch.ops import hlo_inspect as thi


@pytest.fixture(autouse=True)
def _fresh():
    thi.reset()
    yield
    thi.reset()


@pytest.fixture(scope="module")
def mesh_2x2():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (2, 2),
                               mesh_dim_names=("batch", "model"))
    finally:
        dist.destroy_process_group()


def test_parsed_subgroup_sizes_equal_the_walk(mesh_2x2, tmp_path,
                                              monkeypatch):
    import torch.distributed._functional_collectives as funcol

    monkeypatch.delenv("HOROVOD_HLO_INSPECT", raising=False)
    batch, model = mesh_2x2.get_group("batch"), mesh_2x2.get_group("model")

    def step(x):
        return (funcol.all_reduce(x, "sum", model),
                funcol.all_gather_tensor(x, 0, batch),
                funcol.reduce_scatter_tensor(x, "sum", 0, model),
                funcol.all_to_all_single(x, None, None, batch))

    thi.instrument(step, label="mesh", backend="aot_eager")(torch.ones(4, 3))
    ((_, world, graphs, groups),) = thi._RECORDED
    assert world == 4 and sorted(groups.values()) == [2, 2]
    walked = thi.inventory_from_graph(graphs, world=4, label="mesh")
    assert walked.collectives == 4
    assert {op.group_size for op in walked.ops} == {2}
    (path,) = thi.write_graphs(str(tmp_path), "mesh")
    with open(path) as f:
        text = f.read()
    assert thi.inventory_from_text(text, label="mesh").to_dict() == \
        walked.to_dict()
    # Without the header's group sizes every all-reduce would span the
    # world of four.
    body = text.split("\n", 1)[1]
    bare = thi.inventory_from_text(body, world=4, label="mesh")
    assert [op.group_size for op in bare.ops if op.kind == "all-reduce"] \
        == [4]
