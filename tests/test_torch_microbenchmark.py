"""The port's collective microbenchmark (``horovod_tpu_torch/examples/
microbenchmark.py``, from ``examples/jax_microbenchmark.py``) at np 2 on
the CPU through the port's ``runner.run``, with ``--device cpu`` and
``HOROVOD_SHM_DISABLE=1``:

- the eager plane: numpy buffers on the core's host ring, each op's last
  output equal to the exact result on the ranks' inputs (rank ``r``'s
  filled with ``r + 1``);
- the jit plane: functional collectives compiled by
  ``hlo_inspect.instrument`` over ``aot_eager``, whose inventories name
  one collective of each op's kind with the shard's bytes, and whose
  outputs are exact too;
- both print rank 0's lines in the reference's format, and only rank 0.
"""

import re

import numpy as np
import pytest

WORLD = 2
MB = 0.25
ITERS = 2
N = int(MB * (1 << 20) / 4)
LINE = re.compile(r"^(\w+) +([0-9]+\.[0-9]) MiB/s \((\w+) plane, "
                  r"size=(\d+)\)$")


def _rank(plane):
    import contextlib
    import io

    import torch

    from horovod_tpu_torch.examples import microbenchmark as mb
    from horovod_tpu_torch.ops import hlo_inspect as hi

    torch.set_num_threads(1)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mb.main(["--device", "cpu", "--plane", plane, "--mb", str(MB),
                       "--iters", str(ITERS)])
    out["outputs"] = {k: np.asarray(v) for k, v in out["outputs"].items()}
    out["printed"] = buf.getvalue()
    out["inventories"] = [inv.to_dict() for inv in hi.inventories()]
    return out


@pytest.fixture(scope="module", params=["eager", "jit"])
def ranks(request):
    from horovod_tpu_torch.runner import run

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOROVOD_SHM_DISABLE", "1")
        return request.param, run(_rank, args=(request.param,), np=WORLD,
                                  stream_prefix=False)


def _expected(op, rank, plane):
    """Each op's exact output on rank ``rank`` when rank ``r`` holds
    ``r + 1``: ``N`` elements a rank eager, an ``N / WORLD`` shard jit."""
    fills = [float(r + 1) for r in range(WORLD)]
    if plane == "jit":
        shard = N // WORLD
        per = shard // WORLD
        return {
            "allreduce": np.full(shard, np.mean(fills)),
            "allgather": np.repeat(fills, shard),
            "alltoall": np.repeat(fills, per).reshape(WORLD, per),
            "reducescatter": np.full((1, per), sum(fills)),
        }[op]
    # alltoall and reducescatter take N rows of one element.
    return {
        "allreduce": np.full(N, np.mean(fills)),
        "allgather": np.repeat(fills, N),
        "alltoall": np.repeat(fills, N // WORLD).reshape(N, 1),
        "reducescatter": np.full((N // WORLD, 1), sum(fills)),
        "broadcast": np.full(N, fills[0]),
    }[op]


def test_outputs_are_exact(ranks):
    plane, results = ranks
    ops = ["allreduce", "allgather", "alltoall", "reducescatter"] + (
        ["broadcast"] if plane == "eager" else [])
    for rank, res in enumerate(results):
        assert res["size"] == WORLD and res["device"] == "cpu"
        assert sorted(res["outputs"]) == sorted(ops)
        for op in ops:
            np.testing.assert_array_equal(res["outputs"][op],
                                          _expected(op, rank, plane),
                                          err_msg=f"{plane} {op} rank {rank}")


def test_rank0_prints_the_references_lines(ranks):
    plane, results = ranks
    lines = results[0]["printed"].splitlines()
    ops = [LINE.match(ln) for ln in lines]
    assert all(ops), lines
    assert [m.group(1) for m in ops] == list(results[0]["mib_per_s"])
    assert {(m.group(3), int(m.group(4))) for m in ops} == {(plane, WORLD)}
    for m in ops:
        assert float(m.group(2)) == round(
            results[0]["mib_per_s"][m.group(1)], 1)
    assert results[1]["printed"] == ""


def test_planes_ride_where_the_reference_rides(ranks):
    """Eager numpy buffers ride the core's host ring, never the device
    plane; the jit plane's collectives are the compiled step's."""
    plane, results = ranks
    for res in results:
        stats = res["device_plane"]
        assert stats["host_fallback"] == 0
        assert stats["allreduce"] == stats["allgather"] == 0


def test_inventories_name_each_compiled_collective(ranks):
    """One inventory an op of the jit plane, none of the eager plane."""
    plane, results = ranks
    if plane == "eager":
        assert all(res["inventories"] == [] for res in results)
        return
    shard_bytes = N // WORLD * 4
    want = {"bench_allreduce": ("all-reduce", shard_bytes),
            "bench_allgather": ("all-gather", shard_bytes * WORLD),
            "bench_alltoall": ("all-to-all", shard_bytes),
            "bench_reducescatter": ("reduce-scatter", shard_bytes)}
    for res in results:
        invs = {inv["label"]: inv for inv in res["inventories"]}
        assert sorted(invs) == sorted(want)
        for label, (kind, raw) in want.items():
            inv = invs[label]
            assert inv["kinds"] == {kind: 1}, inv
            assert inv["raw_bytes"] == raw, inv
            assert inv["ops"][0]["group_size"] == WORLD


def test_a_cuda_run_without_a_card_raises(monkeypatch):
    import torch

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.examples import microbenchmark as mb

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    # A process whose first init() asks for no device.
    monkeypatch.setattr(basics, "_first_device", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        mb.main(["--plane", "eager"])
    assert not basics.is_initialized()
