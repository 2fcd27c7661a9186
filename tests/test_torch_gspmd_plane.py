"""The port's compiler data plane (``horovod_tpu_torch/ops/gspmd_plane.py``
and ``DistributedOptimizer(plane=...)``) against the JAX package's, case by
case as ``tests/single/test_gspmd_plane.py`` runs them, at np=2 over gloo
on the CPU.

One two-rank job runs per module, both ranks forked from a fork server
that has torch, the compiler and DTensor loaded already.  Each rank saves
what it computed; the tests hold it against the JAX package run here on a
mesh of ``jax.devices()[:2]``, on the same numpy inputs:

- the mesh ladder, the placement rules and ``resolve_plane``'s rules and
  counters;
- parity on the reference's linear problem (its ``_data``, ``_params`` and
  ``_loss``): the port's gspmd plane, compiled by ``hlo_inspect.instrument``
  over ``aot_eager``, against the port's eager plane and the JAX package's
  gspmd plane within the reference's RTOL of 2e-6 (fp32 reduction order
  only);
- ``plane="auto"`` on either kind of parameter, the world-1 and quantized
  demotions and the per-leaf ``demote_dtype``, each bit-identical to the
  eager plane, the optimizer-level demotions counted, an invalid plane
  refused;
- the slice as a whole: GPT_TINY (weights from ``gpt_params_from_jax``)
  taking 3 SGD steps at world 2 on the port's gspmd plane against the JAX
  package's ``plane="gspmd"`` run, within the 1e-4 of
  ``tests/test_torch_gpt.py``, and both steps' inventories of collectives;
- the repairs of the port's core that this plane needs:
  ``data_plane_stats()``'s eight keys, ``hvd.metrics()["plane_counters"]``
  and ``hvd_init``'s plane argument.

The JAX side is imported inside the functions that use it: the ranks
import this module to find their worker, and need only torch.
"""

import os
import socket

import numpy as np
import pytest
import torch

WORLD = 2
JOIN_TIMEOUT_S = 180
# fp32 reduction-order tolerance, the reference's.
RTOL = 2e-6
LR = 0.1
PARITY_STEPS = 5
GPT_STEPS = 3
GPT_TOL = 1e-4
GPT_BATCH = 4       # sequences a step, 2 a rank
GPT_SEQ = 256     # every position: XLA all-reduces only the live wpe rows
ENV = {"HOROVOD_METRICS": "1"}


def _linear_data(n=64, d=4, seed=0):
    """The reference's ``_data``: x and y as it computes them (y through
    jnp), as numpy."""
    import jax.numpy as jnp

    rs = np.random.RandomState(seed)
    x = jnp.asarray(rs.randn(n, d), jnp.float32)
    w_true = jnp.asarray(rs.randn(d), jnp.float32)
    y = x @ w_true + jnp.asarray(0.1 * rs.randn(n), jnp.float32)
    return np.asarray(x), np.asarray(y)


def _gpt_setup():
    """GPT_TINY's flax parameters drawn with numpy, and each step's ids."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu import models as jmodels

    rng = np.random.default_rng(3)
    ids = rng.integers(0, jmodels.GPT_TINY.vocab_size,
                       (GPT_STEPS, GPT_BATCH, GPT_SEQ), dtype=np.int32)
    shapes = jax.eval_shape(jmodels.GPT(jmodels.GPT_TINY).init,
                            jax.random.PRNGKey(1), jnp.asarray(ids[0]))

    def draw(path, leaf):
        x = rng.normal(0.0, 0.05, leaf.shape).astype(np.float32)
        return x + 1.0 if jax.tree_util.keystr(path).endswith("['scale']") \
            else x

    return ids, jax.tree_util.tree_map_with_path(draw, shapes)


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _names(placements):
    return [type(p).__name__ + (f"({p.dim})" if hasattr(p, "dim") else "")
            for p in placements]


def _placements(mesh, leaf, gp):
    return _names(gp.batch_pspec(leaf, mesh))


def _linear_step(model_params, opt, loss_fn):
    def step(x, y):
        loss = loss_fn(model_params, x, y)
        loss.backward()
        opt.step()
        opt.zero_grad()
        return loss
    return step


def _loss(p, x, y):
    pred = x @ p["w"] + p["b"]
    return ((pred - y) ** 2).mean()


def _params(d=4):
    return {"w": torch.nn.Parameter(torch.zeros(d)),
            "b": torch.nn.Parameter(torch.zeros(()))}


def _worker(rank, port, outdir, data):
    os.environ.update(
        HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(WORLD),
        HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(WORLD),
        HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
        HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
        HOROVOD_GLOO_TIMEOUT_SECONDS="60", HOROVOD_SHM_DISABLE="1", **ENV)
    torch.set_num_threads(1)
    import dataclasses

    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import models
    from horovod_tpu_torch.context import HorovodContext
    from horovod_tpu_torch.ops import gspmd_plane as gp
    from horovod_tpu_torch.ops import hlo_inspect as hi

    hvd.init(device="cpu")
    res = {}
    half = slice(rank * 32, (rank + 1) * 32)
    x = torch.from_numpy(data["x"])
    y = torch.from_numpy(data["y"])

    # The mesh ladder and the placement rules.
    mesh = gp.build_gspmd_mesh()
    mesh2 = gp.build_gspmd_mesh(model_parallel=True)
    mesh1 = gp.build_gspmd_mesh(devices=[0])
    res["mesh"] = {"names": mesh.mesh_dim_names, "size": mesh.size(),
                   "names2": mesh2.mesh_dim_names,
                   "shape2": tuple(mesh2.mesh.shape), "size1": mesh1.size(),
                   "device_type": mesh.device_type}
    res["pspec"] = {
        "divisible": _placements(mesh, torch.zeros(8, 3), gp),
        "ragged": _placements(mesh, torch.zeros(9, 3), gp),
        "scalar": _placements(mesh, torch.zeros(()), gp),
        "model_parallel": _placements(mesh2, torch.zeros(8, 3), gp)}
    tree = gp.tree_shardings({"x": torch.arange(20.0).reshape(4, 5),
                              "b": torch.zeros(3)}, mesh)
    res["tree"] = {k: (type(v).__name__, _names(v.placements),
                       v.to_local().tolist())
                   for k, v in tree.items()}

    # constrain_grads: a Partial fp32 leaf is all-reduced to Replicate, a
    # bf16 one passes through untouched (demote_dtype).
    from torch.distributed.tensor import Partial

    gp.reset_plane_counters()
    leaves = {"f": DTensor.from_local(torch.full((3,), rank + 1.0), mesh,
                                      [Partial()], run_check=False),
              "h": DTensor.from_local(torch.full((2,), rank + 1.0,
                                                 dtype=torch.bfloat16),
                                      mesh, [Partial()], run_check=False)}
    out = gp.constrain_grads(leaves, mesh)
    res["constrain"] = (_names(out["f"].placements),
                        out["f"].to_local().tolist(),
                        out["h"] is leaves["h"], gp.plane_counters())

    # resolve_plane's rules and counters (the reference's sequence).
    rules = []
    gp.reset_plane_counters()
    rules.append((gp.resolve_plane("eager")[0], gp.plane_counters()))
    rules.append((gp.resolve_plane("gspmd", device_codec="int4")[0],
                  gp.plane_counters()))
    plane, m = gp.resolve_plane("gspmd", device_codec="none")
    rules.append((plane, m is not None))
    rules.append((gp.resolve_plane("gspmd", mesh=mesh1)[0],
                  gp.plane_counters()))
    gp.reset_plane_counters()
    rules.append((gp.resolve_plane("auto", mesh=mesh1, count=False)[0],
                  gp.resolve_plane("auto", count=False)[0],
                  gp.plane_counters()))
    res["rules"] = rules

    # Parity: the gspmd plane, compiled, on the batch as Shard(0) ...
    gp.reset_plane_counters()
    hi.reset()
    stats0 = HorovodContext.instance().core.data_plane_stats()
    p = _params()
    for name in p:
        p[name] = torch.nn.Parameter(distribute_tensor(
            p[name].detach(), mesh, [Replicate()]))
    opt = hvd.DistributedOptimizer(torch.optim.SGD(p.values(), lr=LR),
                                   named_parameters=p.items(), plane="gspmd")
    step = hi.instrument(_linear_step(p, opt, _loss), label="linear",
                         backend="aot_eager")
    xs = DTensor.from_local(x[half], mesh, [Shard(0)], run_check=False)
    ys = DTensor.from_local(y[half], mesh, [Shard(0)], run_check=False)
    for _ in range(PARITY_STEPS):
        step(xs, ys)
    res["gspmd"] = {k: v.to_local().detach().clone() for k, v in p.items()}
    res["gspmd_counters"] = gp.plane_counters()
    res["inventory"] = [inv.to_dict() for inv in hi.inventories()]
    res["hlo_counters"] = hi.counters()
    stats = HorovodContext.instance().core.data_plane_stats()
    res["stats_keys"] = list(stats)
    res["gspmd_stats"] = (stats["gspmd_raw"] - stats0["gspmd_raw"],
                          stats["gspmd_wire"] - stats0["gspmd_wire"])
    # Negotiated collectives close step-trace records, each stamped with
    # the plane tag the optimizer left.
    for i in range(2):
        hvd.allreduce(torch.ones(1), name=f"plane.tag.{i}")
    res["step_trace_planes"] = [row[-1] for row in
                                hvd.step_trace().get("steps") or []]

    # ... and the eager plane, each rank its half with a local mean.
    p = _params()
    opt = hvd.DistributedOptimizer(torch.optim.SGD(p.values(), lr=LR),
                                   named_parameters=p.items(), plane="eager")
    for _ in range(PARITY_STEPS):
        _linear_step(p, opt, _loss)(x[half], y[half])
    res["eager"] = {k: v.detach().clone() for k, v in p.items()}

    # auto: the same optimizer class on either kind of parameter; the
    # probe counts nothing.
    gp.reset_plane_counters()
    p = {k: torch.nn.Parameter(distribute_tensor(v.detach(), mesh,
                                                 [Replicate()]))
         for k, v in _params().items()}
    opt = hvd.DistributedOptimizer(torch.optim.SGD(p.values(), lr=LR),
                                   named_parameters=p.items())
    for _ in range(PARITY_STEPS):
        _linear_step(p, opt, _loss)(xs, ys)
    res["auto_dtensor"] = {k: v.to_local().detach().clone()
                           for k, v in p.items()}
    res["auto_resolved"] = opt._plane
    p = _params()
    opt = hvd.DistributedOptimizer(torch.optim.SGD(p.values(), lr=LR),
                                   named_parameters=p.items(), plane="auto")
    for _ in range(PARITY_STEPS):
        _linear_step(p, opt, _loss)(x[half], y[half])
    res["auto_plain"] = {k: v.detach().clone() for k, v in p.items()}
    res["auto_counters"] = gp.plane_counters()

    # World-1 mesh: demoted, the same eager path bit for bit.
    gp.reset_plane_counters()
    outs = {}
    for plane in ("gspmd", "eager"):
        p = _params()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(p.values(), lr=LR), named_parameters=p.items(),
            plane=plane, mesh=mesh1 if plane == "gspmd" else None)
        if plane == "gspmd":
            res["world1_counters"] = gp.plane_counters()
        _linear_step(p, opt, _loss)(x[rank * 4:rank * 4 + 4],
                                    y[rank * 4:rank * 4 + 4])
        outs[plane] = {k: v.detach().clone() for k, v in p.items()}
    res["world1"] = outs

    # A quantized device codec demotes the whole optimizer.
    gp.reset_plane_counters()
    outs = {}
    for plane in ("gspmd", "eager"):
        p = _params()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(p.values(), lr=LR), named_parameters=p.items(),
            plane=plane, device_compression="int4")
        if plane == "gspmd":
            res["quantized_counters"] = gp.plane_counters()
        for _ in range(3):
            _linear_step(p, opt, _loss)(x[half], y[half])
        outs[plane] = {k: v.detach().clone() for k, v in p.items()}
    res["quantized"] = outs

    # A bf16 leaf is not pinned (demote_dtype) and passes through: the
    # whole update bit-identical to plain SGD on the same DTensors.
    def dtype_loss(q, xb, yb):
        pred = xb @ q["w"] + q["e"].float()
        return ((pred - yb) ** 2).mean()

    outs = {}
    for which in ("gspmd", "raw"):
        gp.reset_plane_counters()
        q = {"w": torch.nn.Parameter(distribute_tensor(
                 torch.zeros(4), mesh, [Replicate()])),
             "e": torch.nn.Parameter(distribute_tensor(
                 torch.zeros((), dtype=torch.bfloat16), mesh,
                 [Replicate()]))}
        sgd = torch.optim.SGD(q.values(), lr=LR)
        if which == "gspmd":
            sgd = hvd.DistributedOptimizer(sgd, named_parameters=q.items(),
                                           plane="gspmd")
        _linear_step(q, sgd, dtype_loss)(xs, ys)
        if which == "gspmd":
            res["dtype_counters"] = gp.plane_counters()
        outs[which] = {k: v.to_local().detach().clone()
                       for k, v in q.items()}
    res["dtype"] = outs

    # The optimizer's own demotions, counted under the reference's names.
    demotions = []
    for kwargs in ({"backward_passes_per_step": 2},
                   {"gradient_predivide_factor": 2.0},
                   {"shard_optimizer_states": True},
                   {"process_set": hvd.global_process_set}):
        gp.reset_plane_counters()
        p = _params()
        hvd.DistributedOptimizer(torch.optim.SGD(p.values(), lr=LR),
                                 named_parameters=p.items(), plane="gspmd",
                                 **kwargs)
        demotions.append(gp.plane_counters())
    res["demotions"] = demotions
    try:
        hvd.DistributedOptimizer(torch.optim.SGD(_params().values(), lr=LR),
                                 plane="xla")
        res["invalid"] = None
    except ValueError as e:
        res["invalid"] = str(e)

    # DTensor parameters take no hook, so an option that asks for another
    # reduction than DTensor's own fp32 average is refused, not dropped;
    # a demoting option DTensor honours (predivide) trains as the pin does.
    refused = []
    for kwargs in ({"device_compression": "int8"},
                   {"compression": hvd.Compression.fp16},
                   {"op": hvd.Sum}, {"op": hvd.Adasum},
                   {"process_set": hvd.ProcessSet([0])},
                   {"shard_optimizer_states": True}):
        gp.reset_plane_counters()
        p = {k: torch.nn.Parameter(distribute_tensor(v.detach(), mesh,
                                                     [Replicate()]))
             for k, v in _params().items()}
        try:
            hvd.DistributedOptimizer(torch.optim.SGD(p.values(), lr=LR),
                                     named_parameters=p.items(),
                                     plane="gspmd", **kwargs)
            refused.append((None, gp.plane_counters()))
        except ValueError as e:
            refused.append((str(e), gp.plane_counters()))
    res["dtensor_refused"] = refused
    gp.reset_plane_counters()
    p = {k: torch.nn.Parameter(distribute_tensor(v.detach(), mesh,
                                                 [Replicate()]))
         for k, v in _params().items()}
    opt = hvd.DistributedOptimizer(torch.optim.SGD(p.values(), lr=LR),
                                   named_parameters=p.items(), plane="gspmd",
                                   gradient_predivide_factor=2.0)
    for _ in range(PARITY_STEPS):
        _linear_step(p, opt, _loss)(xs, ys)
    res["dtensor_predivide"] = ({k: v.to_local().detach().clone()
                                 for k, v in p.items()},
                                gp.plane_counters(), opt._plane)

    # A model of DTensor and plain parameters: the pin and the hooks in one
    # compiled step, which reads as gspmd; its inventory holds the pinned
    # leaves' all-reduces and the loss's own.
    gp.reset_plane_counters()
    hi.reset()
    dp = {k: torch.nn.Parameter(distribute_tensor(v.detach(), mesh,
                                                  [Replicate()]))
          for k, v in _params().items()}
    pp = _params()
    mixed = {**{f"d.{k}": v for k, v in dp.items()},
             **{f"p.{k}": v for k, v in pp.items()}}
    opt = hvd.DistributedOptimizer(torch.optim.SGD(mixed.values(), lr=LR),
                                   named_parameters=mixed.items(),
                                   plane="gspmd")

    def mixed_step(xd, yd, xl, yl):
        loss = _loss(dp, xd, yd).full_tensor() + _loss(pp, xl, yl)
        loss.backward()
        opt.step()
        opt.zero_grad()
        return loss

    mstep = hi.instrument(mixed_step, label="mixed", backend="aot_eager")
    seen_steps = len(hvd.step_trace().get("steps") or [])
    for _ in range(PARITY_STEPS):
        mstep(xs, ys, x[half], y[half])
    for i in range(2):
        hvd.allreduce(torch.ones(1), name=f"plane.mixed.{i}")
    res["mixed"] = {
        "dtensor": {k: v.to_local().detach().clone() for k, v in dp.items()},
        "plain": {k: v.detach().clone() for k, v in pp.items()},
        "inventory": [inv.to_dict() for inv in hi.inventories()],
        "counters": gp.plane_counters(),
        "tags": [row[-1] for row in
                 (hvd.step_trace().get("steps") or [])[seen_steps:]]}

    # The repairs: the device plane's pair rises with a quantized
    # allreduce, and the metrics carry the plane counters.
    before = HorovodContext.instance().core.data_plane_stats()
    hvd.quantized_allreduce(torch.ones(1 << 15), codec="int8")
    after = HorovodContext.instance().core.data_plane_stats()
    res["device_bytes"] = (after["device_raw"] - before["device_raw"],
                           after["device_encoded"] - before["device_encoded"])
    gp.reset_plane_counters()
    res["metrics_before"] = "plane_counters" in hvd.metrics()
    gp.note_demotion("demote_accum")
    res["metrics_after"] = hvd.metrics().get("plane_counters")

    # The slice: GPT_TINY on the gspmd plane, compiled, 3 SGD steps.
    cfg = models.GPT_TINY
    model = models.GPT(cfg)
    model.load_state_dict(data["gpt_state"])
    from torch.distributed.tensor import distribute_module

    distribute_module(model, mesh)
    gp.reset_plane_counters()
    hi.reset()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR),
        named_parameters=model.named_parameters(), plane="gspmd")

    def gpt_step(ids):
        loss = models.lm_loss(model(ids), ids)
        loss.backward()
        opt.step()
        opt.zero_grad()
        return loss

    gstep = hi.instrument(gpt_step, label="gpt_tiny", backend="aot_eager")
    per = GPT_BATCH // WORLD
    losses = []
    for t in range(GPT_STEPS):
        ids = torch.from_numpy(
            data["gpt_ids"][t, rank * per:(rank + 1) * per].astype(np.int64))
        loss = gstep(DTensor.from_local(ids, mesh, [Shard(0)],
                                        run_check=False))
        losses.append(loss.full_tensor().item())
    res["gpt_losses"] = losses
    res["gpt_params"] = {n: v.to_local().detach().clone()
                         for n, v in model.state_dict().items()}
    res["gpt_inventory"] = [inv.to_dict() for inv in hi.inventories()]
    res["gpt_param_bytes"] = sum(v.numel() * v.element_size()
                                 for v in model.parameters())
    res["gpt_counters"] = gp.plane_counters()
    res["config"] = dataclasses.asdict(cfg)
    hvd.shutdown()
    torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def inputs():
    from horovod_tpu_torch import models as tmodels

    x, y = _linear_data()
    ids, params = _gpt_setup()
    return {"x": x, "y": y, "gpt_ids": ids, "gpt_flax": params,
            "gpt_state": tmodels.gpt_params_from_jax(params)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, inputs):
    import multiprocessing.forkserver

    outdir = tmp_path_factory.mktemp("gspmd")
    ctx = torch.multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "torch._dynamo",
                                "torch.distributed.tensor",
                                "horovod_tpu_torch"])
    port = _free_port()
    data = {k: v for k, v in inputs.items() if k != "gpt_flax"}
    procs = [ctx.Process(target=_worker, args=(r, port, str(outdir), data))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    finally:
        multiprocessing.forkserver._forkserver._stop()
    if alive:
        pytest.fail(f"{len(alive)} rank(s) did not finish in "
                    f"{JOIN_TIMEOUT_S} s")
    assert [p.exitcode for p in procs] == [0] * WORLD
    return [torch.load(outdir / f"rank{r}.pt") for r in range(WORLD)]


@pytest.fixture(scope="module")
def jax_gspmd(inputs):
    """The JAX package's gspmd plane on the linear problem, 5 steps on a
    mesh of two devices (the reference's ``_train_gspmd``)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from horovod_tpu.ops import gspmd_plane as jgp
    from horovod_tpu.optimizer import DistributedOptimizer

    mesh = jgp.build_gspmd_mesh(devices=jax.devices()[:WORLD])
    tx = DistributedOptimizer(optax.sgd(LR), plane="gspmd", mesh=mesh)
    x = jax.device_put(jnp.asarray(inputs["x"]),
                       NamedSharding(mesh, P(jgp.BATCH_AXIS)))
    y = jax.device_put(jnp.asarray(inputs["y"]),
                       NamedSharding(mesh, P(jgp.BATCH_AXIS)))
    params = {"w": jnp.zeros((4,), jnp.float32),
              "b": jnp.zeros((), jnp.float32)}
    state = tx.init(params)

    def loss(p, xs, ys):
        return jnp.mean((xs @ p["w"] + p["b"] - ys) ** 2)

    @jax.jit
    def step(p, s, xs, ys):
        g = jax.grad(loss)(p, xs, ys)
        u, s2 = tx.update(g, s, p)
        return optax.apply_updates(p, u), s2

    for _ in range(PARITY_STEPS):
        params, state = step(params, state, x, y)
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def jax_gpt(inputs):
    """GPT_TINY on the JAX package's gspmd plane: 3 SGD steps on a mesh of
    two devices, and the inventory of the step's compiled module."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from horovod_tpu import models as jmodels
    from horovod_tpu.ops import gspmd_plane as jgp
    from horovod_tpu.ops import hlo_inspect as jhi
    from horovod_tpu.optimizer import DistributedOptimizer

    mesh = jgp.build_gspmd_mesh(devices=jax.devices()[:WORLD])
    model = jmodels.GPT(jmodels.GPT_TINY)
    tx = DistributedOptimizer(optax.sgd(LR), plane="gspmd", mesh=mesh)
    params = jax.tree_util.tree_map(jnp.asarray, inputs["gpt_flax"])
    state = tx.init(params)

    def step(p, s, ids):
        g = jax.grad(lambda q: jmodels.lm_loss(model.apply(q, ids), ids))(p)
        u, s2 = tx.update(g, s, p)
        return optax.apply_updates(p, u), s2

    shard = NamedSharding(mesh, P(jgp.BATCH_AXIS))
    ids = [jax.device_put(jnp.asarray(b), shard) for b in inputs["gpt_ids"]]
    lowered = jax.jit(step).lower(params, state, ids[0])
    inv = jhi.inspect_lowered(lowered, label="gpt_tiny")
    compiled = lowered.compile()
    for b in ids:
        params, state = compiled(params, state, b)
    return params, inv


# ---------------------------------------------------------------------------
# Mesh and sharding-tree utilities
# ---------------------------------------------------------------------------

def test_mesh_1d_default(ranks):
    for r in ranks:
        assert r["mesh"]["names"] == ("batch",)
        assert r["mesh"]["size"] == WORLD
        assert r["mesh"]["device_type"] == "cpu"


def test_mesh_2d_model_parallel_degrades(ranks):
    from horovod_tpu.ops import gspmd_plane as jgp
    from horovod_tpu_torch.ops import gspmd_plane as tgp

    for r in ranks:
        assert r["mesh"]["names2"] == ("batch", "model")
        assert r["mesh"]["shape2"] == tgp._model_factors(WORLD) == (1, 2)
        assert r["mesh"]["size1"] == 1
    for n in range(1, 17):
        assert tgp._model_factors(n) == jgp._model_factors(n), n


def test_batch_pspec_divisibility_rule(ranks):
    for r in ranks:
        assert r["pspec"] == {"divisible": ["Shard(0)"],
                              "ragged": ["Replicate"],
                              "scalar": ["Replicate"],
                              "model_parallel": ["Replicate", "Replicate"]}


def test_tree_shardings_mirror_tree(ranks):
    for rank, r in enumerate(ranks):
        kind, placements, local = r["tree"]["x"]
        assert (kind, placements) == ("DTensor", ["Shard(0)"])
        assert local == np.arange(20.0).reshape(4, 5)[
            rank * 2:rank * 2 + 2].tolist()
        assert r["tree"]["b"][:2] == ("DTensor", ["Replicate"])


def test_constrain_grads_pins_fp32_and_passes_other_dtypes(ranks):
    for r in ranks:
        assert r["constrain"] == (["Replicate"], [3.0, 3.0, 3.0], True,
                                  {"demote_dtype": 1})


# ---------------------------------------------------------------------------
# resolve_plane's rules
# ---------------------------------------------------------------------------

def test_resolve_plane_rules(ranks):
    for r in ranks:
        eager, quantized, none_codec, world1, auto = r["rules"]
        assert eager == ("eager", {})
        assert quantized == ("eager", {"demote_quantized": 1})
        assert none_codec == ("gspmd", True)
        assert world1 == ("eager", {"demote_quantized": 1, "gspmd": 1,
                                    "demote_world1": 1})
        assert auto == ("eager", "gspmd", {})


def test_no_jax_demotion_has_no_counterpart():
    """Divergence by design (ROADMAP Queue 3): the reference demotes with
    ``demote_no_jax`` when jax does not import; DTensor ships with torch,
    so the port's plane has no such reason."""
    import inspect

    from horovod_tpu.ops import gspmd_plane as jgp
    from horovod_tpu_torch.ops import gspmd_plane as tgp

    assert "demote_no_jax" in inspect.getsource(jgp.resolve_plane)
    assert "no_jax" not in inspect.getsource(tgp.resolve_plane)


# ---------------------------------------------------------------------------
# The parity bar: gspmd == eager == the JAX package's gspmd, fp32 order only
# ---------------------------------------------------------------------------

def _assert_close(got, want, rtol=RTOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=rtol, atol=0, err_msg=k)


def _assert_bit_identical(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_parity_gspmd_vs_eager(ranks):
    for r in ranks:
        assert r["gspmd_counters"] == {"gspmd": 1}
        _assert_close(r["gspmd"], r["eager"])
    _assert_bit_identical(ranks[0]["gspmd"], ranks[1]["gspmd"])


def test_parity_with_the_reference_gspmd_plane(ranks, jax_gspmd):
    for r in ranks:
        _assert_close(r["gspmd"], jax_gspmd)


def test_auto_adapts_to_either_kind_of_parameter(ranks):
    """One ``plane="auto"`` optimizer class serves both: DTensor
    parameters take the pin, plain ones the hooks, bit-identically to
    ``plane="eager"``; the probe never reads as a demotion."""
    for r in ranks:
        assert r["auto_resolved"] == "gspmd"
        _assert_bit_identical(r["auto_dtensor"], r["gspmd"])
        _assert_bit_identical(r["auto_plain"], r["eager"])
        assert r["auto_counters"] == {}


# ---------------------------------------------------------------------------
# Demotions: compose or fall back bit-identically, counted
# ---------------------------------------------------------------------------

def test_world1_demotes_bit_identical(ranks):
    for r in ranks:
        assert r["world1_counters"] == {"demote_world1": 1}
        _assert_bit_identical(r["world1"]["gspmd"], r["world1"]["eager"])


def test_quantized_codec_demotes_whole_optimizer(ranks):
    for r in ranks:
        assert r["quantized_counters"] == {"demote_quantized": 1}
        _assert_bit_identical(r["quantized"]["gspmd"],
                              r["quantized"]["eager"])


def test_non_fp32_leaves_demote_per_leaf_bit_identical(ranks):
    for r in ranks:
        assert r["dtype_counters"].get("gspmd") == 1
        assert r["dtype_counters"].get("demote_dtype", 0) >= 1
        _assert_bit_identical(r["dtype"]["gspmd"], r["dtype"]["raw"])


def test_optimizer_level_demotions_counted(ranks):
    for r in ranks:
        assert r["demotions"] == [{"demote_accum": 1},
                                  {"demote_predivide": 1},
                                  {"demote_sharded": 1},
                                  {"demote_process_set": 1}]


def test_dtensor_parameters_refuse_what_dtensor_cannot_reduce(ranks):
    """DTensor parameters take no hook: an option that asks for another
    reduction (a codec, a wire compression, Sum or Adasum, a process set,
    ZeRO-1) raises before anything is counted; predivide, which DTensor's
    average honours, demotes to eager (counted) and trains as the pin."""
    for r in ranks:
        for (msg, counters), what in zip(r["dtensor_refused"], (
                "device_compression='int8'", "compression", "op=SUM",
                "op=ADASUM", "process_set", "shard_optimizer_states")):
            assert msg is not None and what in msg, (what, msg)
            assert msg.startswith("DTensor parameters are reduced by "
                                  "DTensor")
            assert counters == {}
        got, counters, plane = r["dtensor_predivide"]
        assert counters == {"demote_predivide": 1} and plane == "eager"
        _assert_close(got, r["gspmd"])


def test_mixed_dtensor_and_plain_parameters_read_as_gspmd(ranks):
    """One plain and one DTensor half of a model in one compiled step:
    the DTensor half trains as the gspmd plane, the plain half as the
    eager plane; the steps are tagged gspmd and the inventory holds the
    pinned leaves' bytes besides the loss's scalar all-reduce."""
    for r in ranks:
        m = r["mixed"]
        _assert_close({k: m["dtensor"][k] for k in ("w", "b")}, r["gspmd"])
        _assert_close({k: m["plain"][k] for k in ("w", "b")}, r["eager"])
        assert m["counters"] == {"gspmd": 1}
        # Each step closes the plain half's hook collectives; the first
        # step's close before its compiled trace is known to be gspmd, and
        # every later record carries the gspmd tag.
        per_step = (len(m["tags"]) - 2) // PARITY_STEPS
        assert per_step >= 1 and set(m["tags"][per_step:]) == {1}, m["tags"]
        (inv,) = m["inventory"]
        assert set(inv["kinds"]) == {"all-reduce"}
        sizes = sorted(op["raw_bytes"] for op in inv["ops"])
        # w (4 fp32) and b (1 fp32) pinned; the loss's full_tensor (1 fp32).
        assert sizes == [4, 4, 16], sizes


def test_invalid_plane_rejected(ranks):
    from horovod_tpu_torch.utils.env import DATA_PLANES

    for r in ranks:
        assert r["invalid"] == (f"plane must be one of {DATA_PLANES}, got "
                                "'xla'")


# ---------------------------------------------------------------------------
# The compiled step's inventory and the core's counters
# ---------------------------------------------------------------------------

def test_linear_inventory_matches_the_counters(ranks):
    from horovod_tpu_torch.ops import hlo_inspect as thi

    for r in ranks:
        (inv,) = r["inventory"]
        assert inv["kinds"] == {"all-reduce": 2} and inv["world"] == WORLD
        assert inv["raw_bytes"] == 4 * 4 + 4
        assert inv["wire_bytes"] == sum(
            thi.ring_wire_bytes(op["kind"], op["raw_bytes"], WORLD)
            for op in inv["ops"])
        assert r["hlo_counters"] == {
            "gspmd_collectives_total": 2, "gspmd_raw_bytes": 20,
            "gspmd_wire_bytes": inv["wire_bytes"], "gspmd_traces_total": 1}
        assert r["gspmd_stats"] == (inv["raw_bytes"], inv["wire_bytes"])
        assert r["step_trace_planes"] and set(r["step_trace_planes"]) == {1}


# ---------------------------------------------------------------------------
# The repairs of the core
# ---------------------------------------------------------------------------

def test_data_plane_stats_has_the_reference_keys(ranks):
    for r in ranks:
        assert r["stats_keys"] == [
            "data_sent_local", "data_sent_xhost", "data_raw_local",
            "data_raw_xhost", "device_raw", "device_encoded", "gspmd_raw",
            "gspmd_wire"]
        raw, encoded = r["device_bytes"]
        assert raw > 0 and 0 < encoded < raw


def test_metrics_carry_the_plane_counters(ranks):
    for r in ranks:
        assert r["metrics_before"] is False
        assert r["metrics_after"] == {"demote_accum": 1}


@pytest.mark.parametrize("size,codec,plane,want", [
    (2, "none", "auto", 0), (2, "none", "eager", 0), (2, "none", "gspmd", 1),
    (1, "none", "gspmd", -1), (2, "int8", "gspmd", -1),
    (4, "int4", "auto", -1)])
def test_init_plane_argument_follows_the_reference_rule(size, codec, plane,
                                                        want):
    from horovod_tpu_torch._core import init_plane_arg
    from horovod_tpu_torch.utils.env import Config

    assert init_plane_arg(Config(size=size, wire_compression_device=codec,
                                 data_plane=plane)) == want


def test_launch_help_names_both_planes(capsys):
    from horovod_tpu_torch.runner import launch

    with pytest.raises(SystemExit):
        launch.parse_args(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    entry = text[text.index("--data-plane {auto,eager,gspmd}"):]
    entry = entry[:entry.index("(HOROVOD_DATA_PLANE)")]
    assert "'eager'" in entry and "'gspmd'" in entry
    assert "eager plane only" not in entry


# ---------------------------------------------------------------------------
# The slice as a whole: GPT_TINY on either package's gspmd plane
# ---------------------------------------------------------------------------

def test_gpt_tiny_matches_the_reference_gspmd_plane(ranks, jax_gpt, inputs):
    from horovod_tpu_torch import models as tmodels

    jparams, _ = jax_gpt
    for r in ranks:
        assert r["gpt_counters"] == {"gspmd": 1}
        got = tmodels.gpt_params_to_jax(r["gpt_params"], inputs["gpt_flax"])
        import jax

        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = dict(jax.tree_util.tree_leaves_with_path(
            jparams["params"]))
        assert len(flat_got) == len(flat_want)
        for path, g in flat_got:
            np.testing.assert_allclose(
                g, np.asarray(flat_want[path]), rtol=GPT_TOL, atol=GPT_TOL,
                err_msg=jax.tree_util.keystr(path))
    assert ranks[0]["gpt_losses"] == ranks[1]["gpt_losses"]


def test_gpt_tiny_inventories_hold_all_reduces_of_the_parameters(ranks,
                                                                 jax_gpt):
    """Both packages' inventories hold only all-reduces whose raw bytes sum
    to GPT_TINY's fp32 parameter bytes.  XLA's all-reduce combiner may fuse
    several parameters into one tuple all-reduce, so the op counts are not
    compared; the port reduces each parameter once."""
    _, jinv = jax_gpt
    n_params = len(ranks[0]["gpt_params"])
    for r in ranks:
        (inv,) = r["gpt_inventory"]
        assert inv["kinds"] == {"all-reduce": n_params}
        assert inv["raw_bytes"] == r["gpt_param_bytes"]
        assert inv["wire_bytes"] == inv["raw_bytes"]  # g = 2: 2 (g-1)/g = 1
    assert set(jinv.kind_counts()) == {"all-reduce"}
    assert jinv.raw_bytes == ranks[0]["gpt_param_bytes"]
