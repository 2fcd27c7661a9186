"""The port's collectives, broadcast helpers and DistributedOptimizer.

A two-rank job over gloo on the CPU runs once per module: rank 1 in a
process started with ``torch.multiprocessing`` (spawn), rank 0 in the test
process itself, which saves one interpreter start.  The tests read what each
rank saved.  Expected values are
the arithmetic of ``horovod_tpu/optimizer.py``: Average is the mean over
ranks; ``backward_passes_per_step=k`` reduces the sum of k local gradients
prescaled by 1/k; ``gradient_predivide_factor=f`` sums gradients prescaled
by 1/f and postscales by f/size.
"""

import os
import socket

import pytest
import torch

WORLD = 2
JOIN_TIMEOUT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that idle OpenMP
    workers do not spin on a CPU the other test processes share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _make_model(seed):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Tanh(),
                               torch.nn.Linear(3, 2))


def _loss(model, x):
    return model(x).pow(2).mean()


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _worker(rank, port, outdir):
    os.environ.update(
        HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(WORLD),
        HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(WORLD),
        HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
        HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
        HOROVOD_GLOO_TIMEOUT_SECONDS="60",
        # The native core's host ring over TCP: no /dev/shm region, which
        # tests of the JAX package running meanwhile look for.
        HOROVOD_SHM_DISABLE="1")
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    res = {"rank": hvd.rank(), "size": hvd.size()}
    gen = torch.Generator().manual_seed(1000 + rank)
    xs = [torch.randn(5, 4, generator=gen) for _ in range(2)]

    # broadcast_parameters: every rank starts from its own weights.
    model = _make_model(seed=rank)
    res["own_params"] = {n: p.detach().clone()
                         for n, p in model.named_parameters()}
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    res["params"] = {n: p.detach().clone()
                     for n, p in model.named_parameters()}
    base = {k: v.clone() for k, v in model.state_dict().items()}

    def fresh():
        m = _make_model(seed=0)
        m.load_state_dict(base)
        return m

    # Local gradients of each batch, on models without optimizer hooks.
    for i, x in enumerate(xs):
        m = fresh()
        _loss(m, x).backward()
        res[f"local_grad{i}"] = _grads(m)

    # One averaged SGD step.
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.5),
        named_parameters=model.named_parameters())
    res["is_sgd"] = isinstance(opt, torch.optim.SGD)
    _loss(model, xs[0]).backward()
    opt.step()
    res["reduced_grad"] = _grads(model)
    res["stepped"] = {n: p.detach().clone()
                      for n, p in model.named_parameters()}

    # backward_passes_per_step=2: two local passes, one reduction.
    m = fresh()
    opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1),
                                   backward_passes_per_step=2)
    for x in xs:
        _loss(m, x).backward()
    opt.synchronize()
    res["bpps2_grad"] = _grads(m)

    # gradient_predivide_factor=4 (and fp16 compression on the wire).
    for key, kwargs in (("predivide_grad", {"gradient_predivide_factor": 4.0}),
                        ("fp16_grad", {"compression": hvd.Compression.fp16})):
        m = fresh()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(m.parameters(), lr=0.1), **kwargs)
        _loss(m, xs[0]).backward()
        opt.synchronize()
        res[key] = _grads(m)

    # broadcast_optimizer_state: rank 0's AdamW has stepped, rank 1's has
    # no state yet.
    m = fresh()
    adam = torch.optim.AdamW(m.parameters(), lr=1e-2, weight_decay=0.0)
    if rank == 0:
        for x in xs:
            adam.zero_grad()
            _loss(m, x).backward()
            adam.step()
    hvd.broadcast_optimizer_state(adam, root_rank=0)
    res["adam_state"] = {
        k: {kk: vv.clone() for kk, vv in v.items()}
        for k, v in adam.state_dict()["state"].items()}

    # The collectives themselves.
    t = torch.tensor([1.0, 2.0, 3.0]) * (rank + 1)
    res["avg"] = hvd.allreduce(t)
    res["sum"] = hvd.allreduce(t, op=hvd.Sum)
    res["sum_scaled"] = hvd.allreduce(t, op=hvd.Sum, prescale_factor=2.0,
                                      postscale_factor=0.25)
    res["avg_scaled"] = hvd.allreduce(t, prescale_factor=3.0,
                                      postscale_factor=0.5)
    res["min"] = hvd.allreduce(t, op=hvd.Min)
    res["max"] = hvd.allreduce(t, op=hvd.Max)
    inplace = t.clone()
    hvd.allreduce_(inplace, op=hvd.Sum)
    res["inplace"] = inplace
    handle = hvd.allreduce_async(t, op=hvd.Sum)
    res["async"] = hvd.synchronize(handle)
    res["untouched"] = t
    res["allgather"] = hvd.allgather(torch.full((rank + 1, 2), float(rank)))
    res["broadcast"] = hvd.broadcast(t, root_rank=1)
    res["object"] = hvd.broadcast_object({"from": rank}, root_rank=1)
    res["objects"] = hvd.allgather_object(rank * 10)
    hvd.shutdown()
    torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("np2")
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    peer = ctx.Process(target=_worker, args=(1, port, str(outdir)))
    peer.start()
    saved = dict(os.environ)
    try:
        _worker(0, port, str(outdir))
    finally:
        os.environ.clear()
        os.environ.update(saved)
        peer.join(JOIN_TIMEOUT_S)
        if peer.is_alive():
            peer.kill()
            peer.join(10)
            pytest.fail(f"rank 1 did not finish in {JOIN_TIMEOUT_S} s")
    assert peer.exitcode == 0
    return [torch.load(outdir / f"rank{r}.pt") for r in range(WORLD)]


def _close(a, b, tol=1e-6):
    torch.testing.assert_close(a, b, rtol=tol, atol=tol)


def _mean(dicts):
    return {k: sum(d[k] for d in dicts) / len(dicts) for k in dicts[0]}


def test_identity(ranks):
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["size"] == WORLD for r in ranks)


def test_broadcast_parameters_np2(ranks):
    r0, r1 = ranks
    assert any(not torch.equal(r0["own_params"][k], r1["own_params"][k])
               for k in r0["own_params"])
    for k in r0["params"]:
        assert torch.equal(r1["params"][k], r0["own_params"][k])
        assert torch.equal(r0["params"][k], r0["own_params"][k])


def test_step_averages_gradients_np2(ranks):
    want = _mean([r["local_grad0"] for r in ranks])
    for r in ranks:
        assert r["is_sgd"]
        for k in want:
            _close(r["reduced_grad"][k], want[k])
            _close(r["stepped"][k], r["params"][k] - 0.5 * want[k])


def test_backward_passes_per_step_np2(ranks):
    want = _mean([{k: (r["local_grad0"][k] + r["local_grad1"][k]) / 2
                   for k in r["local_grad0"]} for r in ranks])
    for r in ranks:
        for k in want:
            _close(r["bpps2_grad"][k], want[k])


def test_gradient_predivide_factor_np2(ranks):
    want = _mean([r["local_grad0"] for r in ranks])
    for r in ranks:
        for k in want:
            _close(r["predivide_grad"][k], want[k])


def test_fp16_compression_np2(ranks):
    want = _mean([r["local_grad0"] for r in ranks])
    for r in ranks:
        for k in want:
            assert r["fp16_grad"][k].dtype == torch.float32
            _close(r["fp16_grad"][k], want[k], tol=2e-3)


def test_broadcast_optimizer_state_np2(ranks):
    r0, r1 = ranks
    assert r0["adam_state"]
    assert r0["adam_state"].keys() == r1["adam_state"].keys()
    for pid, st in r0["adam_state"].items():
        for key, val in st.items():
            assert torch.equal(r1["adam_state"][pid][key], val), (pid, key)


def test_allreduce_ops_np2(ranks):
    base = torch.tensor([1.0, 2.0, 3.0])
    per_rank = [base * (r + 1) for r in range(WORLD)]
    total = sum(per_rank)
    expected = {
        "avg": total / WORLD,
        "sum": total,
        "sum_scaled": sum(2.0 * t for t in per_rank) * 0.25,
        "avg_scaled": sum(3.0 * t for t in per_rank) / WORLD * 0.5,
        "min": torch.minimum(*per_rank),
        "max": torch.maximum(*per_rank),
        "inplace": total,
        "async": total,
    }
    for rank, r in enumerate(ranks):
        for key, want in expected.items():
            _close(r[key], want)
        _close(r["untouched"], per_rank[rank])


def test_gather_and_broadcast_np2(ranks):
    want_gather = torch.cat([torch.zeros(1, 2), torch.ones(2, 2)])
    for r in ranks:
        assert torch.equal(r["allgather"], want_gather)
        _close(r["broadcast"], torch.tensor([2.0, 4.0, 6.0]))
        assert r["object"] == {"from": 1}
        assert r["objects"] == [0, 10]


@pytest.mark.parametrize("kwargs", [
    {"process_set": object()}, {"num_groups": 2, "groups": [[]]},
    {"shard_optimizer_states": True}, {"groups": "frozen"}])
def test_later_slice_options_raise(kwargs):
    """The options that raised before the negotiated spine and ZeRO-1 are
    served now, and their misuse raises as the reference does: a process
    set that is not a ProcessSet, num_groups with groups, a group holding
    a frozen parameter (its hook never fires, so the group could never
    complete), ZeRO-1 with wire compression (its shard math is fp32)."""
    import horovod_tpu_torch as hvd

    model = _make_model(0)
    if kwargs.get("groups") == "frozen":
        model[2].bias.requires_grad_(False)
        kwargs = {"groups": [[model[0].weight, model[2].bias]]}
    if "shard_optimizer_states" in kwargs:
        kwargs = {"shard_optimizer_states": True,
                  "compression": hvd.Compression.fp16}
    want = {"process_set": (TypeError, "ProcessSet"),
            "num_groups": (ValueError, "either num_groups or groups"),
            "shard_optimizer_states": (ValueError,
                                       "incompatible with compression"),
            "groups": (ValueError, "requires-grad")}[next(iter(kwargs))]
    with pytest.raises(want[0], match=want[1]):
        hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                 **kwargs)


def test_device_compression_options(monkeypatch):
    """The reference's rules for error feedback: an active codec refuses
    wire compression, predivide and ops other than Average and Sum; an
    explicit codec refuses accumulation, a codec from the environment
    leaves an accumulating optimizer on the plain path; "none" overrides
    the environment."""
    import horovod_tpu_torch as hvd

    monkeypatch.delenv("HOROVOD_WIRE_COMPRESSION", raising=False)
    model = _make_model(0)

    def make(**kwargs):
        return hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1), **kwargs)

    for kwargs in ({"device_compression": "int9"},
                   {"device_compression": "int8",
                    "compression": hvd.Compression.fp16},
                   {"device_compression": "int4",
                    "backward_passes_per_step": 2},
                   {"device_compression": "int8g",
                    "gradient_predivide_factor": 2.0},
                   {"device_compression": "int8", "op": hvd.Min}):
        with pytest.raises(ValueError):
            make(**kwargs)
    assert make()._ef_codec == "none"
    assert make(device_compression="INT4")._ef_codec == "int4"
    monkeypatch.setenv("HOROVOD_WIRE_COMPRESSION", "host=bf16,device=int8g")
    assert make()._ef_codec == "int8g"
    assert make(device_compression="none")._ef_codec == "none"
    assert make(backward_passes_per_step=2)._ef_codec == "none"


def test_world_one_error_feedback_is_the_plain_step():
    """At world 1 no gradient is eligible for the quantized ring
    (quantized_collective_eligible needs a ring): the step is the plain
    one and no residual is kept."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        model, ref = _make_model(0), _make_model(0)
        x = torch.randn(5, 4, generator=torch.Generator().manual_seed(1))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            device_compression="int8")
        ref_opt = torch.optim.SGD(ref.parameters(), lr=0.1)
        for o, m in ((opt, model), (ref_opt, ref)):
            _loss(m, x).backward()
            o.step()
        for p, q in zip(model.parameters(), ref.parameters()):
            assert torch.equal(p, q)
            assert "ef_residual" not in opt.state[p]
    finally:
        hvd.shutdown()


def test_predivide_needs_average():
    import horovod_tpu_torch as hvd

    model = _make_model(0)
    with pytest.raises(ValueError):
        hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                 op=hvd.Sum, gradient_predivide_factor=2.0)


def test_world_one_step_keeps_gradient():
    """At world 1 the averaged gradient is the local one, through the same
    allreduce call n ranks make."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        model = _make_model(0)
        x = torch.randn(5, 4, generator=torch.Generator().manual_seed(0))
        ref = _make_model(0)
        _loss(ref, x).backward()
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-3),
            compression=hvd.Compression.bf16)
        assert isinstance(opt, torch.optim.AdamW)
        _loss(model, x).backward()
        # The reference's clipping idiom: reduce, clip, then step without
        # synchronizing again.
        opt.synchronize()
        torch.nn.utils.clip_grad_norm_(model.parameters(), 1e6)
        with opt.skip_synchronize():
            opt.step()
        assert not opt._handles
        for (n, p), (_, q) in zip(model.named_parameters(),
                                  ref.named_parameters()):
            _close(p.grad, q.grad, tol=1e-2)
        with pytest.raises(ValueError, match="not supported for integer"):
            hvd.allreduce(torch.ones(2, dtype=torch.int64))  # Average
    finally:
        hvd.shutdown()
