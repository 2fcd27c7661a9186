"""The port's sparse gradients against the JAX package's torch binding, on
the CPU.

Two ranks of the port (``horovod_tpu_torch``, CPU tensors on the device
plane over gloo) and two ranks of the reference (``horovod_tpu.torch``, its
host ring) run the same cases at once, as spawned workers
(``tests/test_torch_spine.py``'s harness), fed the same seeded inputs:

- ``sparse_allreduce`` Sum and Average (duplicate indices within a rank),
  over a process set of both ranks and over a set of one, with a rank that
  touched no row, unnamed, and two in flight at once: bitwise against the
  reference and against the dense sum of the ranks' tensors.
- An indices gather that fails (the ranks' sparse dims differ) while the
  values gather succeeds: the error reaches the caller and neither handle
  is left in the handle table.
- Three SGD steps of two sparse embeddings and a linear head through
  ``DistributedOptimizer`` with ``sparse_params=`` (rank 1's batch skips the
  second embedding at one step: a zero-nnz collective), with
  ``sparse_as_dense=True``, and with every parameter in one fusion group
  (the sparse member leaves it): bitwise against the reference, equal
  across ranks, and within 1e-6 of a one-process replay with dense
  embeddings on both ranks' batches (the replay sums the duplicate rows in
  another order).

At world one, in this process on the pure-Python core: error feedback and
ZeRO-1 refuse sparse gradients by name (the reference's torch binding has
neither), and ZeRO-1 takes them with ``sparse_as_dense=True``.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_spine import _build_cores, _env, _phase_port

WORLD = 2
JOIN_TIMEOUT_S = 120
SHAPE = (10, 3)
STEPS = 3
LR = 0.1
REPLAY_TOL = 1e-6
CASES = ("sum", "avg", "set_both", "set_one", "zero_nnz", "unnamed",
         "async")
VARIANTS = ("sparse_params", "sparse_as_dense", "grouped")


def _rows():
    """Each rank's touched rows (duplicates included) and their values."""
    rng = np.random.default_rng(13)
    rows = [np.array([1, 4, 4, 7]), np.array([0, 4, 9])]
    vals = [rng.standard_normal((len(r), SHAPE[1])).astype(np.float32)
            for r in rows]
    return rows, vals


def _sparse(rank, empty=False):
    rows, vals = _rows()
    if empty:
        return torch.sparse_coo_tensor(torch.zeros((1, 0), dtype=torch.int64),
                                       torch.zeros((0, SHAPE[1])), SHAPE)
    return torch.sparse_coo_tensor(torch.from_numpy(rows[rank])[None],
                                   torch.from_numpy(vals[rank]), SHAPE)


def _dense(t):
    t = t.coalesce()
    return {"indices": t.indices().numpy(), "values": t.values().numpy()}


def _sparse_cases(rank, ops, add_process_set):
    """The same calls for both packages; returns name -> coalesced
    (indices, values)."""
    both = add_process_set([0, 1])
    one = add_process_set([1])
    x = _sparse(rank)
    out = {
        "sum": ops.sparse_allreduce(x, name="sp.sum", op=ops.Sum),
        "avg": ops.sparse_allreduce(x, name="sp.avg"),
        "set_both": ops.sparse_allreduce(x, name="sp.set", process_set=both),
        "zero_nnz": ops.sparse_allreduce(_sparse(rank, empty=rank == 1),
                                         name="sp.zero", op=ops.Sum),
        "unnamed": ops.sparse_allreduce(x, op=ops.Sum),
    }
    if rank == 1:
        out["set_one"] = ops.sparse_allreduce(x, name="sp.one",
                                              process_set=one)
    t1 = ops.sparse_allreduce_async(x, name="sp.a1", op=ops.Sum)
    t2 = ops.sparse_allreduce_async(x * 2, name="sp.a2")
    out["async"] = (ops.sparse_synchronize(t2), ops.sparse_synchronize(t1))
    res = {k: tuple(_dense(t) for t in v) if isinstance(v, tuple)
           else _dense(v) for k, v in out.items()}
    # Rank 1's sparse dims differ: the indices (nnz, 1) against (nnz, 2)
    # cannot be gathered, the values (nnz, 3) can.
    bad = x if rank == 0 else torch.sparse_coo_tensor(
        torch.tensor([[0, 1], [2, 3]]), torch.ones(2, SHAPE[1]),
        (SHAPE[0], 4, SHAPE[1]))
    try:
        ops.sparse_allreduce(bad, name="sp.bad", op=ops.Sum)
        res["bad"] = "no error"
    except Exception as exc:  # noqa: BLE001 - the type is compared
        res["bad"] = type(exc).__name__
    return res


def _model(sparse=True):
    torch.manual_seed(0)
    return torch.nn.ModuleDict({
        "emb1": torch.nn.Embedding(50, 4, sparse=sparse),
        "emb2": torch.nn.Embedding(30, 4, sparse=sparse),
        "head": torch.nn.Linear(4, 2)})


def _batches():
    rng = np.random.default_rng(17)
    ids1 = rng.integers(0, 50, (STEPS, WORLD, 6))
    ids2 = rng.integers(0, 30, (STEPS, WORLD, 3))
    return ids1, ids2


def _touches_emb2(step, rank, variant):
    # Rank 1 skips the declared second embedding at step 1; the grouped
    # variant declares nothing, so every rank touches every layer.
    return variant == "grouped" or not (step == 1 and rank == 1)


def _loss(model, step, rank, variant):
    ids1, ids2 = _batches()
    h = model["emb1"](torch.from_numpy(ids1[step, rank])).mean(0)
    if _touches_emb2(step, rank, variant):
        h = h + model["emb2"](torch.from_numpy(ids2[step, rank])).sum(0)
    return model["head"](h).square().sum()


def _train(make_optimizer, rank, variant):
    model = _model()
    named = list(model.named_parameters())
    kwargs = {"sparse_params": ["emb1.weight", "emb2.weight"]} \
        if variant == "sparse_params" else \
        {"sparse_as_dense": True} if variant == "sparse_as_dense" else \
        {"groups": [[p for _, p in named]]}
    opt = make_optimizer(torch.optim.SGD(model.parameters(), lr=LR),
                         named_parameters=named, **kwargs)
    steps = []
    for step in range(STEPS):
        opt.zero_grad()
        _loss(model, step, rank, variant).backward()
        opt.step()
        steps.append({n: p.detach().clone().numpy() for n, p in named})
    emb = model["emb1"].weight
    return {"steps": steps,
            "evicted": id(emb) not in opt._group_of,
            "grad_sparse": emb.grad.is_sparse, "handles": len(opt._handles)}


def _port_worker(rank, outdir):
    torch.set_num_threads(1)
    _env(rank, _phase_port(outdir, rank, "port"))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.context import HorovodContext

    hvd.init(device="cpu")
    res = {"cases": _sparse_cases(rank, hvd, hvd.add_process_set)}
    res["left"] = len(HorovodContext.instance()._entries)
    res["train"] = {v: _train(hvd.DistributedOptimizer, rank, v)
                    for v in VARIANTS}
    hvd.shutdown()
    torch.save(res, os.path.join(outdir, f"port{rank}.pt"))


def _reference_worker(rank, outdir):
    torch.set_num_threads(1)
    _env(rank, _phase_port(outdir, rank, "reference"), JAX_PLATFORMS="cpu")
    import horovod_tpu as hvd
    import horovod_tpu.torch as ht
    from horovod_tpu.context import HorovodContext
    from horovod_tpu.torch import mpi_ops

    hvd.init(build_mesh=False)
    res = {"cases": _sparse_cases(rank, ht, hvd.add_process_set)}
    res["left"] = len(HorovodContext.instance()._entries) + \
        len(mpi_ops._handles._entries)
    res["train"] = {v: _train(ht.DistributedOptimizer, rank, v)
                    for v in VARIANTS}
    hvd.shutdown()
    torch.save(res, os.path.join(outdir, f"reference{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("sparse")
    _build_cores()
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=w, args=(r, str(outdir)))
             for w in (_port_worker, _reference_worker)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    assert not alive, f"{len(alive)} worker(s) did not finish in " \
                      f"{JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    return {pkg: [torch.load(outdir / f"{pkg}{r}.pt", weights_only=False)
                  for r in range(WORLD)]
            for pkg in ("port", "reference")}


def _same(got, want, what):
    assert got["indices"].dtype == want["indices"].dtype, what
    assert np.array_equal(got["indices"], want["indices"]), what
    assert got["values"].dtype == want["values"].dtype, what
    assert np.array_equal(got["values"].view(np.uint32),
                          want["values"].view(np.uint32)), what


def _want_dense(case):
    """The dense result each case must densify to."""
    rows, vals = _rows()
    dense = [np.zeros(SHAPE, np.float32) for _ in range(WORLD)]
    for r in range(WORLD):
        np.add.at(dense[r], rows[r], vals[r])
    if case == "zero_nnz":
        return dense[0]
    if case == "set_one":
        return dense[1]
    total = dense[0] + dense[1]
    # The async case is held by its first call, a Sum.
    return total if case in ("sum", "unnamed", "async") else \
        total / np.float32(2)


@pytest.mark.parametrize("case", CASES)
def test_sparse_allreduce_matches_reference(runs, case):
    for rank in range(WORLD):
        if case == "set_one" and rank == 0:
            continue
        got = runs["port"][rank]["cases"][case]
        want = runs["reference"][rank]["cases"][case]
        if case == "async":
            for i, (g, w) in enumerate(zip(got, want)):
                _same(g, w, f"{case}[{i}] rank {rank}")
            got = got[1]
        else:
            _same(got, want, f"{case} rank {rank}")
        dense = np.zeros(SHAPE, np.float32)
        np.add.at(dense, got["indices"][0], got["values"])
        np.testing.assert_array_equal(dense, _want_dense(case))


def test_failed_indices_gather_retires_both_handles(runs):
    for pkg in ("port", "reference"):
        for r in runs[pkg]:
            assert r["cases"]["bad"] == "HorovodInternalError", pkg
            assert r["left"] == 0, pkg


@pytest.mark.parametrize("variant", VARIANTS)
def test_optimizer_matches_reference(runs, variant):
    for rank in range(WORLD):
        got = runs["port"][rank]["train"][variant]
        want = runs["reference"][rank]["train"][variant]
        for step, (g, w) in enumerate(zip(got["steps"], want["steps"])):
            for name in w:
                assert np.array_equal(g[name], w[name]), (step, name)
                assert np.array_equal(
                    g[name], runs["port"][0]["train"][variant]["steps"][
                        step][name]), ("ranks differ", step, name)
        for key in ("evicted", "grad_sparse", "handles"):
            assert got[key] == want[key], key
        assert got["handles"] == 0
        assert got["grad_sparse"] == (variant != "sparse_as_dense")


@pytest.mark.parametrize("variant", VARIANTS)
def test_optimizer_matches_dense_replay(runs, variant):
    """One process, dense embeddings, both ranks' losses averaged: the mean
    gradient the ranks' Average reduction computes."""
    model = _model(sparse=False)
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    got = runs["port"][0]["train"][variant]["steps"]
    for step in range(STEPS):
        opt.zero_grad()
        loss = sum(_loss(model, step, r, variant) for r in range(WORLD))
        (loss / WORLD).backward()
        opt.step()
        for name, p in model.named_parameters():
            np.testing.assert_allclose(got[step][name], p.detach().numpy(),
                                       rtol=0, atol=REPLAY_TOL,
                                       err_msg=f"{variant} {step} {name}")


def test_grouped_sparse_member_leaves_its_group(runs):
    got = runs["port"][0]["train"]["grouped"]
    assert got["evicted"] and got["grad_sparse"]


# -- world one, in this process -------------------------------------------

@pytest.fixture()
def world_one(monkeypatch):
    """A world of one on the pure-Python core (the JAX package's native
    core may be loaded in this process already)."""
    import horovod_tpu_torch as hvd

    for name in list(os.environ):
        if name.startswith("HOROVOD_"):
            monkeypatch.delenv(name)
    monkeypatch.setenv("HOROVOD_CONTROLLER", "python")
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _embedding_step(opt, emb):
    emb(torch.tensor([1, 2, 2])).sum().backward()
    opt.step()


def test_error_feedback_refuses_sparse_gradients(world_one):
    hvd = world_one
    emb = torch.nn.Embedding(300, 64, sparse=True)
    with pytest.raises(ValueError, match="sparse gradients of"):
        hvd.DistributedOptimizer(
            torch.optim.SGD(emb.parameters(), lr=LR),
            named_parameters=emb.named_parameters(),
            device_compression="int8", sparse_params=["weight"])
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(emb.parameters(), lr=LR),
        named_parameters=emb.named_parameters(), device_compression="int8")
    with pytest.raises(ValueError, match=r"\['weight'\]"):
        emb(torch.tensor([1, 2])).sum().backward()
    del opt


def test_zero1_refuses_sparse_gradients_unless_densified(world_one):
    hvd = world_one
    emb = torch.nn.Embedding(20, 4, sparse=True)
    with pytest.raises(ValueError, match="sparse_params"):
        hvd.DistributedOptimizer(
            torch.optim.SGD(emb.parameters(), lr=LR),
            named_parameters=emb.named_parameters(),
            shard_optimizer_states=True, sparse_params=["weight"])
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(emb.parameters(), lr=LR),
        named_parameters=emb.named_parameters(), shard_optimizer_states=True)
    with pytest.raises(ValueError, match="'weight' is sparse"):
        _embedding_step(opt, emb)
    emb.weight.grad = None
    before = emb.weight.detach().clone()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(emb.parameters(), lr=LR),
        named_parameters=emb.named_parameters(), shard_optimizer_states=True,
        sparse_as_dense=True)
    _embedding_step(opt, emb)
    want = before.clone()
    want[1] -= LR
    want[2] -= 2 * LR
    assert torch.equal(emb.weight.detach(), want)


def test_sparse_allreduce_refuses_dense_and_min(world_one):
    hvd = world_one
    with pytest.raises(ValueError, match="sparse COO"):
        hvd.sparse_allreduce(torch.ones(3))
    with pytest.raises(ValueError, match="Sum and Average"):
        hvd.sparse_allreduce(_sparse(0), op=hvd.Min)
