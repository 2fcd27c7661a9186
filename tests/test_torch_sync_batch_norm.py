"""Batch normalization over the global batch at np=2 on gloo.

One job of two port ranks (rank 0 in the test process, rank 1 spawned)
and one of two reference ranks (``horovod_tpu``'s eager API, spawned) run
at once on the same seeded inputs:

- ``hvd.SyncBatchNorm`` (torch semantics) for two training steps against
  ``horovod_tpu/torch/sync_batch_norm.py`` on the reference ranks: outputs,
  input and parameter gradients, running statistics, within ``SYNC_TOL``
  (the same fp32 arithmetic; the port scales the running variance by a
  tensor count, the reference by a Python float);
- the same port layer against one process's ``nn.BatchNorm2d`` on the
  concatenated batch, within ``SYNC_TOL``;
- the zoo's synced BatchNorm (flax semantics) inside ``ResNetTiny(bn_sync=
  True)``: one ``DistributedOptimizer`` SGD step against flax's
  ``ResNetTiny(bn_axis_name="hvd")`` with ``horovod_tpu.
  DistributedOptimizer`` under ``shard_map`` over two CPU devices
  (``check_vma=False``, as the parity tests run it): parameters and
  ``batch_stats`` within ``ZOO_TOL`` of each leaf's largest magnitude
  (convolutions sum in another order), and the two port ranks equal to the
  bit.
"""

import os
import socket

import numpy as np
import pytest
import torch

WORLD = 2
JOIN_TIMEOUT_S = 120
SYNC_TOL = 1e-5
ZOO_TOL = 1e-4
LR = 0.1
CHANNELS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs():
    rng = np.random.default_rng(21)
    return {
        # [steps, ranks, B, C, H, W]: the ranks' batches differ in scale,
        # so local statistics would not do.
        "x": (rng.standard_normal((2, WORLD, 4, CHANNELS, 5, 5))
              * np.array([1.0, 3.0])[None, :, None, None, None, None]
              + np.array([0.0, 2.0])[None, :, None, None, None, None]
              ).astype(np.float32),
        "proj": rng.standard_normal((2, WORLD, 4, CHANNELS, 5, 5)).astype(
            np.float32),
        "w": (1.0 + 0.3 * rng.standard_normal(CHANNELS)).astype(np.float32),
        "b": (0.2 * rng.standard_normal(CHANNELS)).astype(np.float32),
        "images": rng.standard_normal((WORLD, 4, 3, 16, 16)).astype(
            np.float32),
        "labels": rng.integers(0, 10, (WORLD, 4)).astype(np.int64),
    }


def _sync_bn_steps(sync_batch_norm, rank):
    """Two training steps of a SyncBatchNorm on this rank's batches."""
    inp = _inputs()
    bn = sync_batch_norm(CHANNELS, name="layer")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["w"]))
        bn.bias.copy_(torch.from_numpy(inp["b"]))
    steps = []
    for s in range(2):
        x = torch.from_numpy(inp["x"][s, rank]).requires_grad_()
        y = bn(x)
        (y * torch.from_numpy(inp["proj"][s, rank])).sum().backward()
        steps.append({"y": y.detach().clone(), "dx": x.grad.clone(),
                      "dw": bn.weight.grad.clone(),
                      "db": bn.bias.grad.clone(),
                      "mean": bn.running_mean.clone(),
                      "var": bn.running_var.clone()})
        bn.weight.grad = bn.bias.grad = None
    return steps


def _env(rank, port):
    for var in [v for v in os.environ if v.startswith("HOROVOD_")]:
        del os.environ[var]
    os.environ.update(
        HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(WORLD),
        HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(WORLD),
        HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
        HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
        HOROVOD_GLOO_TIMEOUT_SECONDS="60", HOROVOD_SHM_DISABLE="1")


def _port_worker(rank, port, outdir):
    torch.set_num_threads(1)
    _env(rank, port)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import models
    from horovod_tpu_torch.models import convert

    hvd.init(device="cpu")
    res = {"sync_bn": _sync_bn_steps(hvd.SyncBatchNorm, rank)}
    inp = _inputs()
    variables = torch.load(os.path.join(outdir, "variables.pt"),
                           weights_only=False)
    model = models.ResNetTiny(num_classes=10, bn_sync=True)
    model.load_state_dict(convert.from_jax(variables))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR),
        named_parameters=model.named_parameters())
    model.train()
    loss = models.xent_loss(model(torch.from_numpy(inp["images"][rank])),
                            torch.from_numpy(inp["labels"][rank]))
    loss.backward()
    opt.step()
    res["zoo"] = convert.to_jax(dict(model.state_dict()), variables)
    res["zoo_bn_names"] = sorted(
        m.name for m in model.modules()
        if isinstance(m, hvd.sync_batch_norm.BatchNorm))
    hvd.shutdown()
    torch.save(res, os.path.join(outdir, f"port{rank}.pt"))


def _reference_worker(rank, port, outdir):
    torch.set_num_threads(1)
    _env(rank, port)
    os.environ["JAX_PLATFORMS"] = "cpu"
    import horovod_tpu as hvd
    from horovod_tpu.torch.sync_batch_norm import SyncBatchNorm

    hvd.init(build_mesh=False)
    res = {"sync_bn": _sync_bn_steps(SyncBatchNorm, rank)}
    hvd.shutdown()
    torch.save(res, os.path.join(outdir, f"reference{rank}.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _random_variables(shapes, seed):
    import jax

    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            a = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        elif name == "scale":
            a = 1.0 + 0.2 * rng.standard_normal(shape)
        elif name == "var":
            a = 1.0 + 0.5 * rng.random(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _flax_model():
    from horovod_tpu import models

    return models.ResNetTiny(num_classes=10, bn_axis_name="hvd")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    outdir = tmp_path_factory.mktemp("syncbn")
    shapes = jax.eval_shape(lambda: _flax_model().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), train=False))
    variables = _random_variables(shapes, seed=3)
    torch.save(variables, outdir / "variables.pt")
    ctx = torch.multiprocessing.get_context("spawn")
    port, ref_port = _free_port(), _free_port()
    procs = [ctx.Process(target=_port_worker, args=(1, port, str(outdir)))]
    procs += [ctx.Process(target=_reference_worker,
                          args=(r, ref_port, str(outdir)))
              for r in range(WORLD)]
    for p in procs:
        p.start()
    saved = dict(os.environ)
    try:
        _port_worker(0, port, str(outdir))
    finally:
        os.environ.clear()
        os.environ.update(saved)
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    assert not alive, f"{len(alive)} worker(s) did not finish"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    load = lambda name: torch.load(outdir / name, weights_only=False)  # noqa
    return {"port": [load(f"port{r}.pt") for r in range(WORLD)],
            "reference": [load(f"reference{r}.pt") for r in range(WORLD)],
            "variables": variables}


def test_sync_batch_norm_matches_reference_torch_binding(runs):
    for rank in range(WORLD):
        got = runs["port"][rank]["sync_bn"]
        want = runs["reference"][rank]["sync_bn"]
        for s, (g, w) in enumerate(zip(got, want)):
            for key in w:
                torch.testing.assert_close(g[key], w[key], rtol=SYNC_TOL,
                                           atol=SYNC_TOL,
                                           msg=f"step {s} {key} rank {rank}")


def test_sync_batch_norm_is_batch_norm_of_the_global_batch(runs):
    """One process's BatchNorm2d over both ranks' batches: the same
    outputs, input gradients, parameter gradients (summed over ranks) and
    running statistics (unbiased, momentum 0.1)."""
    inp = _inputs()
    bn = torch.nn.BatchNorm2d(CHANNELS)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["w"]))
        bn.bias.copy_(torch.from_numpy(inp["b"]))
    got = [runs["port"][r]["sync_bn"] for r in range(WORLD)]
    for s in range(2):
        x = torch.from_numpy(np.concatenate(inp["x"][s])).requires_grad_()
        y = bn(x)
        (y * torch.from_numpy(np.concatenate(inp["proj"][s]))).sum() \
            .backward()
        for rank in range(WORLD):
            part = slice(4 * rank, 4 * rank + 4)
            g = got[rank][s]
            torch.testing.assert_close(g["y"], y[part].detach(),
                                       rtol=SYNC_TOL, atol=SYNC_TOL)
            torch.testing.assert_close(g["dx"], x.grad[part], rtol=SYNC_TOL,
                                       atol=SYNC_TOL)
            torch.testing.assert_close(g["mean"], bn.running_mean,
                                       rtol=SYNC_TOL, atol=SYNC_TOL)
            torch.testing.assert_close(g["var"], bn.running_var,
                                       rtol=SYNC_TOL, atol=SYNC_TOL)
        for key, want in (("dw", bn.weight.grad), ("db", bn.bias.grad)):
            torch.testing.assert_close(got[0][s][key] + got[1][s][key], want,
                                       rtol=SYNC_TOL, atol=SYNC_TOL)
        bn.weight.grad = bn.bias.grad = None


def _flax_step(variables):
    """One SGD step of flax ResNetTiny(bn_axis_name="hvd") under shard_map
    over two CPU devices, each with its rank's batch."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, PartitionSpec as P

    import horovod_tpu as jhvd
    from horovod_tpu import models
    from horovod_tpu.ops.collectives import shard_map

    inp = _inputs()
    model = _flax_model()
    tx = jhvd.DistributedOptimizer(optax.sgd(LR), axis_name="hvd")
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("hvd",))

    def step(params, stats, x, y):
        def loss_fn(p):
            logits, upd = model.apply({"params": p, "batch_stats": stats}, x,
                                      train=True, mutable=["batch_stats"])
            return models.xent_loss(logits, y), upd["batch_stats"]

        grads, stats = jax.grad(loss_fn, has_aux=True)(params)
        upd, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, upd), stats

    images = jnp.asarray(inp["images"].transpose(0, 1, 3, 4, 2).reshape(
        WORLD * 4, 16, 16, 3))
    labels = jnp.asarray(inp["labels"].reshape(-1).astype(np.int32))
    params, stats = jax.jit(shard_map(
        step, mesh=mesh, in_specs=(P(), P(), P("hvd"), P("hvd")),
        out_specs=(P(), P()), check_vma=False))(
        variables["params"], variables["batch_stats"], images, labels)
    return {"params": params, "batch_stats": stats}


def test_zoo_synced_batch_norm_step_matches_flax_axis_name(runs):
    import jax

    want = _flax_step(runs["variables"])
    got = [runs["port"][r]["zoo"] for r in range(WORLD)]
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    for rank in range(WORLD):
        flat_g = jax.tree_util.tree_leaves(got[rank])
        assert len(flat_g) == len(flat_w)
        for (path, w), g in zip(flat_w, flat_g):
            w = np.asarray(w)
            np.testing.assert_allclose(
                g, w, rtol=0, atol=ZOO_TOL * float(np.abs(w).max()),
                err_msg=f"{jax.tree_util.keystr(path)} rank {rank}")
    for g0, g1 in zip(jax.tree_util.tree_leaves(got[0]),
                      jax.tree_util.tree_leaves(got[1])):
        assert np.array_equal(g0, g1)
    # Each layer's collectives were named by its module path.
    names = runs["port"][0]["zoo_bn_names"]
    assert "bn_init" in names and "ResNetBlock_0.BatchNorm_0" in names
