"""ZeRO-1 (``DistributedOptimizer(shard_optimizer_states=True)``) and
``clip_by_global_norm`` against the replicated optimizer and against the
JAX package's sharded optimizer, mirroring ``tests/single/test_optimizer.py``
at np=2 on gloo.

One two-rank job runs per module (rank 1 spawned, rank 0 in the test
process); each rank feeds toy gradients, rank-dependent through its data,
into the port's optimizers and saves the parameters.  The reference's
results come from ``horovod_tpu.DistributedOptimizer`` under ``shard_map``
over two CPU devices (``check_vma=False``, as the parity tests run it),
computed after the job.  Tolerances are the reference tests' own: 2e-5
for Adam trajectories (the port's and optax's Adam round their bias
corrections in another order), 1e-5 for the clipped step.  The replicated
and the sharded port runs reduce the same fp32 sums, so SGD with momentum
agrees between them to the bit.
"""

import os
import socket

import numpy as np
import pytest
import torch

WORLD = 2
JOIN_TIMEOUT_S = 120
STEPS = 5
CLIP = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data():
    # [steps, ranks, 7]: the reference test's toy data at two ranks.
    return np.arange(STEPS * WORLD * 7, dtype=np.float32).reshape(
        STEPS, WORLD, 7) * 0.01


def _toy_params():
    # 7 + 4 = 11 elements: chunk 6 at two ranks, one padding element.
    return {"w": np.linspace(0.5, 1.5, 7, dtype=np.float32),
            "b": np.zeros(4, np.float32)}


def _toy_grads(w, b, x):
    return w * x - 1.0, b + x[:4]


def _clip_params():
    return {"w": np.linspace(1.0, 2.0, 6, dtype=np.float32),
            "b": np.ones(5, np.float32)}


def _clip_x():
    return np.arange(WORLD * 8, dtype=np.float32).reshape(WORLD, 8)


def _run_port(hvd, rank, make_opt, params, grads_of, steps):
    """``steps`` optimizer steps on toy gradients; the parameters after
    each."""
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = make_opt(list(ps.values()), list(ps.items()))
    out = []
    for i in range(steps):
        opt.zero_grad()
        for k, g in grads_of(i, {k: p.detach() for k, p in ps.items()})\
                .items():
            ps[k].grad = g
        opt.step()
        out.append({k: p.detach().clone() for k, p in ps.items()})
    return out, opt


def _worker(rank, port, outdir):
    os.environ.update(
        HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(WORLD),
        HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(WORLD),
        HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
        HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
        HOROVOD_GLOO_TIMEOUT_SECONDS="60", HOROVOD_SHM_DISABLE="1")
    os.environ.pop("HOROVOD_WIRE_COMPRESSION", None)
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    res = {}
    data = torch.from_numpy(_data())

    def toy(i, p):
        w, b = _toy_grads(p["w"], p["b"], data[i, rank])
        return {"w": w, "b": b}

    for key, shard in (("adam_replicated", False), ("adam_sharded", True)):
        res[key], opt = _run_port(
            hvd, rank, lambda ps, named, shard=shard: hvd.DistributedOptimizer(
                torch.optim.Adam(ps, lr=0.1), named_parameters=named,
                shard_optimizer_states=shard),
            _toy_params(), toy, STEPS)
        if shard:
            res["adam_state_sizes"] = [
                v.numel() for st in opt.state.values() for v in st.values()
                if v.dim() > 0]
            res["adam_master"] = opt._zero_master.numel()
            res["is_adam"] = isinstance(opt, torch.optim.Adam)
    # SGD with momentum and two parameter groups of their own learning
    # rates: the sharded run steps the same fp32 sums.
    for key, shard in (("sgd_replicated", False), ("sgd_sharded", True)):
        res[key], _ = _run_port(
            hvd, rank, lambda ps, named, shard=shard: hvd.DistributedOptimizer(
                torch.optim.SGD([{"params": ps[:1]},
                                 {"params": ps[1:], "lr": 0.05}],
                                lr=0.1, momentum=0.9),
                named_parameters=named, shard_optimizer_states=shard),
            _toy_params(), toy, STEPS)
    # fp32 master weights under a bf16 model: 16 steps of a gradient an
    # eighth of a bf16 ulp at 1.0.
    ps = {"w": torch.nn.Parameter(torch.ones(8, dtype=torch.bfloat16))}
    opt = hvd.DistributedOptimizer(torch.optim.SGD(ps.values(), lr=1.0),
                                   shard_optimizer_states=True)
    for _ in range(16):
        ps["w"].grad = torch.full((8,), 2.0 ** -11, dtype=torch.bfloat16)
        opt.step()
    res["bf16_w"] = ps["w"].detach().clone()
    # The cross-rank clip inside the sharded optimizer against the
    # replicated optimizer clipping the averaged gradient.
    x = torch.from_numpy(_clip_x()[rank])

    def clip_grads(i, p):
        return {"w": p["w"] * x[:6], "b": p["b"] + x[:5]}

    res["clip_sharded"], _ = _run_port(
        hvd, rank, lambda ps, named: hvd.DistributedOptimizer(
            hvd.clip_by_global_norm(torch.optim.SGD(ps, lr=1.0), CLIP,
                                    process_set=hvd.global_process_set),
            named_parameters=named, shard_optimizer_states=True),
        _clip_params(), clip_grads, 1)
    res["clip_replicated"], _ = _run_port(
        hvd, rank, lambda ps, named: hvd.DistributedOptimizer(
            hvd.clip_by_global_norm(torch.optim.SGD(ps, lr=1.0), CLIP),
            named_parameters=named),
        _clip_params(), clip_grads, 1)
    hvd.shutdown()
    torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("zero")
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


def _reference(tx_of, params, grads_of, x, steps):
    """The JAX package's optimizer under shard_map over two CPU devices;
    ``x`` is ``[steps, ranks, n]`` per-rank data, or ``[ranks, n]`` for one
    step."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu.ops.collectives import shard_map

    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("dp",))
    tx = tx_of()
    p0 = {k: jnp.asarray(v) for k, v in params.items()}

    def run(data):
        state = tx.init(p0)

        def body(carry, xi):
            p, s = carry
            upd, s = tx.update(grads_of(p, xi[0]), s, p)
            return (optax.apply_updates(p, upd), s), None

        (p, _), _ = jax.lax.scan(body, (p0, state), data)
        return p

    data = jnp.asarray(x if x.ndim == 3 else x[None])
    out = jax.jit(shard_map(run, mesh=mesh, in_specs=(P(None, "dp"),),
                            out_specs=P(), check_vma=False))(data)
    return {k: np.asarray(v) for k, v in out.items()}


def test_sharded_optimizer_matches_replicated_trajectory(ranks):
    """Adam on sharded states tracks the replicated port and the
    reference's sharded Adam step for step (11 elements: padding)."""
    import horovod_tpu as jhvd
    import optax

    want = _reference(
        lambda: jhvd.DistributedOptimizer(optax.adam(0.1), axis_name="dp",
                                          shard_optimizer_states=True),
        _toy_params(),
        lambda p, x: dict(zip("wb", _toy_grads(p["w"], p["b"], x))),
        _data(), STEPS)
    for r in ranks:
        assert r["is_adam"]
        for step, (sh, rep) in enumerate(zip(r["adam_sharded"],
                                             r["adam_replicated"])):
            for k in sh:
                torch.testing.assert_close(sh[k], rep[k], rtol=2e-5,
                                           atol=2e-5, msg=f"{k} {step}")
        for k, v in want.items():
            np.testing.assert_allclose(r["adam_sharded"][-1][k].numpy(), v,
                                       rtol=2e-5, atol=2e-5, err_msg=k)
    for k in want:   # the ranks hold the same parameters, to the bit
        assert torch.equal(ranks[0]["adam_sharded"][-1][k],
                           ranks[1]["adam_sharded"][-1][k])


def test_sharded_sgd_momentum_is_the_replicated_sgd_bitwise(ranks):
    for r in ranks:
        for sh, rep in zip(r["sgd_sharded"], r["sgd_replicated"]):
            for k in sh:
                assert torch.equal(sh[k], rep[k]), k


def test_sharded_optimizer_state_is_one_nth(ranks):
    """Adam's two moments and the fp32 master live on chunk = ceil(11 / 2)
    = 6 elements per rank, not 11."""
    for r in ranks:
        assert r["adam_master"] == 6
        assert sum(r["adam_state_sizes"]) == 2 * 6


def test_sharded_optimizer_master_weights_bf16(ranks):
    """16 steps of 2^-11 move a bf16 weight at 1.0 (ulp 2^-8 above, 2^-9
    below) only through the fp32 master copy."""
    for r in ranks:
        w = r["bf16_w"]
        assert w.dtype == torch.bfloat16
        assert torch.all(w.float() < 1.0), w
        assert torch.all(w.float() == 1.0 - 2.0 ** -7), w


def test_sharded_optimizer_with_cross_rank_clip(ranks):
    import horovod_tpu as jhvd
    import optax

    want = _reference(
        lambda: jhvd.DistributedOptimizer(
            optax.chain(jhvd.clip_by_global_norm(CLIP, axis_name="dp"),
                        optax.sgd(1.0)),
            axis_name="dp", shard_optimizer_states=True),
        _clip_params(),
        lambda p, x: {"w": p["w"] * x[:6], "b": p["b"] + x[:5]},
        _clip_x(), 1)
    for r in ranks:
        for k, v in want.items():
            got_sh = r["clip_sharded"][0][k].numpy()
            np.testing.assert_allclose(got_sh, v, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(r["clip_replicated"][0][k].numpy(), v,
                                       rtol=1e-5, atol=1e-5)
        # The clip bit: an unclipped step would move w by about 10.
        assert np.abs(r["clip_sharded"][0]["w"].numpy()
                      - _clip_params()["w"]).max() < 2 * CLIP


@pytest.mark.parametrize("kwargs,match", [
    ({"device_compression": "int8"}, "incompatible with "
                                     "shard_optimizer_states"),
    ({"compression": "fp16"}, "incompatible with compression"),
    ({"backward_passes_per_step": 2}, "backward_passes_per_step=1"),
    ({"gradient_predivide_factor": 2.0}, "gradient_predivide_factor"),
    ({"op": "Min"}, "op=Average or Sum"),
    ({"process_set": "global"}, "does not support process_set"),
])
def test_sharded_optimizer_refusals(kwargs, match, monkeypatch):
    """The reference's refusals, with its messages; a codec from the
    environment opts the sharded optimizer out instead."""
    import horovod_tpu_torch as hvd

    monkeypatch.delenv("HOROVOD_WIRE_COMPRESSION", raising=False)
    kwargs = dict(kwargs)
    if kwargs.get("compression") == "fp16":
        kwargs["compression"] = hvd.Compression.fp16
    if kwargs.get("op") == "Min":
        kwargs["op"] = hvd.Min
    if kwargs.get("process_set") == "global":
        kwargs["process_set"] = hvd.global_process_set
    w = torch.nn.Parameter(torch.ones(3))
    with pytest.raises(ValueError, match=match):
        hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                 shard_optimizer_states=True, **kwargs)
    monkeypatch.setenv("HOROVOD_WIRE_COMPRESSION", "device=int8")
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                   shard_optimizer_states=True)
    assert opt._zero_chunk == 3
