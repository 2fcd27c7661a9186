"""The port's mesh, tensor, pipeline and expert parallel layers
(``horovod_tpu_torch.parallel``) against the JAX package's, at np=2 and
np=4 over gloo on the CPU.

One job per world size, every rank a process forked from a fork server
that has torch and the port loaded (``tests/test_torch_quantized_a2a_rs.py``
runs its ranks the same way); each rank runs every case on the same seeded
numpy inputs and saves its outputs and gradients.  The reference is
``horovod_tpu.parallel`` in ``shard_map`` over the conftest's CPU mesh at
the same world size, one compiled program per world, run in a thread of
the test process while the ranks run.

Gradients follow JAX's varying-manual-axes typing, which torch lacks: a
replicated leaf that meets a varying value (a weight sliced by
``shard_kernel`` or ``pipeline_stage_params``, the MoE router) has its
per-rank parts summed by JAX's AD, so the port's per-rank gradients summed
over the ranks are held against it; a leaf used only on replicated values
(``tp_mlp``'s output bias) and a replicated input the layer takes as such
(``column_parallel_dense``'s input, ``gpipe``'s microbatches: their
gradient is summed over the axis in the backward) are held rank by rank; a
sharded input's gradient is held shard by shard.  Tolerances are
``tests/single/test_parallelism.py``'s.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_spine import _phase_port

WORLDS = (2, 4)
JOIN_TIMEOUT_S = 120
# (rtol, atol), as tests/single/test_parallelism.py holds each layer.
TOL = {"tp": (1e-4, 1e-5), "vocab": (1e-5, 1e-6), "pp": (1e-4, 1e-5),
       "moe": (1e-3, 1e-4)}
D_TP, HIDDEN_TP = 16, 64
VOCAB, D_EMB = 64, 4
D_PP, MB, N_MICRO = 8, 4, 5
D_MOE, HIDDEN_MOE, TOKENS = 8, 16, 16
CAPACITY = (1.0, 8.0)   # tokens dropped, none dropped


def _inputs(world):
    rng = np.random.default_rng(31 + world)

    def f32(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {
        "tp": [f32(4, D_TP), f32(D_TP, HIDDEN_TP, scale=0.1),
               f32(HIDDEN_TP, scale=0.1), f32(HIDDEN_TP, D_TP, scale=0.1),
               f32(D_TP, scale=0.1)],
        "tp_c": f32(4, D_TP),
        "col": [f32(3, 8), f32(8, 8 * world)],
        "col_c": f32(3, 8 * world),
        "ids": rng.integers(0, VOCAB, (2, 10)).astype(np.int64),
        "table": f32(VOCAB, D_EMB),
        "emb_c": f32(2, 10, D_EMB),
        "pp": [f32(N_MICRO, MB, D_PP), f32(world, D_PP, D_PP, scale=0.5)],
        "pp_c": f32(N_MICRO, MB, D_PP),
        "moe": [f32(world * TOKENS, D_MOE), f32(D_MOE, world),
                f32(world, D_MOE, HIDDEN_MOE, scale=0.3),
                f32(world, HIDDEN_MOE, D_MOE, scale=0.3)],
        "moe_c": f32(world * TOKENS, D_MOE),
    }


def _leaves(arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


def _grads(leaves):
    return [t.grad.clone() for t in leaves]


def _worker(rank, world, outdir):
    port = _phase_port(outdir, rank, f"np{world}")
    os.environ.update(
        HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(world),
        HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(world),
        HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
        HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
        HOROVOD_GLOO_TIMEOUT_SECONDS="60", HOROVOD_SHM_DISABLE="1")
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import parallel as par

    hvd.init(device="cpu")
    inp = _inputs(world)
    res = {"global": (par.global_mesh().axis("hvd").index,
                      par.global_mesh().axis("hvd").size,
                      par.mesh_axis_name())}
    grid = par.build_mesh({"dp": world // 2, "sp": 2})
    res["grid"] = {n: (grid.axis(n).index, grid.axis(n).ranks)
                   for n in grid.axis_names}
    pair = par.sub_mesh([0, 1], "pair")   # every rank makes the group
    res["sub"] = pair.axis("pair").ranks if rank < 2 else None
    errors = {"mesh": lambda: par.build_mesh({"dp": world, "sp": 2}),
              "shard_kernel": lambda: par.shard_kernel(
                  torch.zeros(3, 8 * world - 1), "tp", 1)}
    meshes = {n: par.build_mesh({n: world}) for n in ("tp", "pp", "ep")}

    with meshes["tp"]:
        x, w_in, b_in, w_out, b_out = leaves = _leaves(inp["tp"])
        y = par.tp_mlp(x, par.shard_kernel(w_in, "tp", 1),
                       par.shard_kernel(w_out, "tp", 0),
                       par.shard_kernel(b_in, "tp", 0), b_out,
                       axis_name="tp")
        (y * torch.from_numpy(inp["tp_c"])).sum().backward()
        res["tp"] = (y.detach(), _grads(leaves))

        x, w = leaves = _leaves(inp["col"])
        y = par.column_parallel_dense(x, par.shard_kernel(w, "tp", 1),
                                      axis_name="tp", gather_output=True)
        (y * torch.from_numpy(inp["col_c"])).sum().backward()
        res["col"] = (y.detach(), _grads(leaves))

        table, = leaves = _leaves([inp["table"]])
        e = par.vocab_parallel_embedding(
            torch.from_numpy(inp["ids"]), par.shard_kernel(table, "tp", 0),
            axis_name="tp")
        (e * torch.from_numpy(inp["emb_c"])).sum().backward()
        res["vocab"] = (e.detach(), _grads(leaves))
        for key, call in errors.items():
            try:
                call()
                res[f"error/{key}"] = "no error"
            except ValueError as exc:
                res[f"error/{key}"] = str(exc)

    with meshes["pp"]:
        x, ws = leaves = _leaves(inp["pp"])
        out = par.gpipe(lambda w, a: torch.nn.functional.gelu(
            a @ w, approximate="tanh"), par.pipeline_stage_params(ws, "pp"),
            x, axis_name="pp")
        out = par.last_stage_value(out, "pp")
        (out * torch.from_numpy(inp["pp_c"])).sum().backward()
        res["pp"] = (out.detach(), _grads(leaves))

    with meshes["ep"]:
        rows = slice(rank * TOKENS, (rank + 1) * TOKENS)
        for factor in CAPACITY:
            x_all, router, w_in_all, w_out_all = _leaves(inp["moe"])
            x = x_all[rows]
            out = par.switch_moe(
                x, router, par.moe_ffn(
                    par.pipeline_stage_params(w_in_all, "ep"),
                    par.pipeline_stage_params(w_out_all, "ep")),
                axis_name="ep", capacity_factor=factor)
            (out * torch.from_numpy(inp["moe_c"][rows])).sum().backward()
            res[f"moe/{factor}"] = (out.detach(), [
                x_all.grad[rows].clone(), router.grad.clone(),
                w_in_all.grad.clone(), w_out_all.grad.clone()])
        x_all, router = _leaves(inp["moe"][:2])
        lb = par.load_balancing_loss(x_all[rows], router, "ep")
        lb.backward()
        res["lb"] = (lb.detach(), [x_all.grad[rows].clone(),
                                   router.grad.clone()])
    hvd.shutdown()
    torch.save(res, os.path.join(outdir, f"np{world}.rank{rank}.pt"))


def _jax_side():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu import parallel as jpar
    from horovod_tpu.ops.collectives import shard_map

    out = {}
    for world in WORLDS:
        inp = _inputs(world)
        devices = jax.devices()[:world]

        def mesh(name):
            return Mesh(np.asarray(devices), (name,))

        grid = jpar.build_mesh({"dp": world // 2, "sp": 2}, devices=devices)
        ids = np.vectorize(lambda d: d.id)(grid.devices)
        out[f"{world}/grid"] = {
            r: {n: int(np.argwhere(ids == devices[r].id)[0][i])
                for i, n in enumerate(grid.axis_names)}
            for r in range(world)}
        try:
            jpar.build_mesh({"dp": world, "sp": 2}, devices=devices)
        except ValueError as exc:
            out[f"{world}/error/mesh"] = str(exc)

        def tp(x, w_in, b_in, w_out, b_out):
            def fn(x, w_in, b_in, w_out, b_out):
                return jpar.tp_mlp(x, jpar.shard_kernel(w_in, "tp", 1),
                                   jpar.shard_kernel(w_out, "tp", 0),
                                   jpar.shard_kernel(b_in, "tp", 0), b_out,
                                   axis_name="tp")

            y = shard_map(fn, mesh=mesh("tp"), in_specs=(P(),) * 5,
                          out_specs=P())(x, w_in, b_in, w_out, b_out)
            return jnp.sum(y * inp["tp_c"]), y

        def col(x, w):
            def fn(x, w):
                return jpar.column_parallel_dense(
                    x, jpar.shard_kernel(w, "tp", 1), axis_name="tp",
                    gather_output=True)[None]

            y = shard_map(fn, mesh=mesh("tp"), in_specs=(P(), P()),
                          out_specs=P("tp"))(x, w)
            return jnp.sum(y * inp["col_c"]), y

        def vocab(table):
            def fn(ids, table):
                return jpar.vocab_parallel_embedding(
                    ids, jpar.shard_kernel(table, "tp", 0), axis_name="tp")

            e = shard_map(fn, mesh=mesh("tp"), in_specs=(P(), P()),
                          out_specs=P())(jnp.asarray(inp["ids"]), table)
            return jnp.sum(e * inp["emb_c"]), e

        def pp(x, ws):
            def stage(w, a):
                return jax.nn.gelu(a @ w)

            def fn(x, ws):
                o = jpar.gpipe(stage, jpar.pipeline_stage_params(ws, "pp"),
                               x, axis_name="pp")
                return jpar.last_stage_value(o, "pp")

            o = shard_map(fn, mesh=mesh("pp"), in_specs=(P(), P()),
                          out_specs=P())(x, ws)
            return jnp.sum(o * inp["pp_c"]), o

        def moe(factor):
            def loss(x_all, router, w_in_all, w_out_all):
                def fn(x, router, w_in_all, w_out_all):
                    return jpar.switch_moe(
                        x, router, jpar.moe_ffn(
                            jpar.pipeline_stage_params(w_in_all, "ep"),
                            jpar.pipeline_stage_params(w_out_all, "ep")),
                        axis_name="ep", capacity_factor=factor)

                o = shard_map(fn, mesh=mesh("ep"),
                              in_specs=(P("ep"), P(), P(), P()),
                              out_specs=P("ep"))(x_all, router, w_in_all,
                                                 w_out_all)
                return jnp.sum(o * inp["moe_c"]), o
            return loss

        def lb(x_all, router):
            v = shard_map(lambda x, r: jpar.load_balancing_loss(x, r, "ep")
                          [None], mesh=mesh("ep"), in_specs=(P("ep"), P()),
                          out_specs=P("ep"))(x_all, router)
            return jnp.sum(v), v

        cases = {"tp": (tp, inp["tp"]), "col": (col, inp["col"]),
                 "vocab": (vocab, [inp["table"]]), "pp": (pp, inp["pp"]),
                 "lb": (lb, inp["moe"][:2])}
        cases.update({f"moe/{f}": (moe(f), inp["moe"]) for f in CAPACITY})

        def everything(args):
            return {k: jax.value_and_grad(fn, argnums=tuple(range(len(a))),
                                          has_aux=True)(*a)
                    for k, ((fn, _), a) in zip(cases, zip(cases.values(),
                                                          args))}

        args = [[jnp.asarray(a) for a in arrays]
                for _, arrays in cases.values()]
        # XLA's default optimization: at level 0 its CPU tanh is off by
        # 1e-5 in the pipeline's weight gradient (fp64 puts torch's within
        # 3e-6 and the optimized reference's within 2e-6).
        res = jax.jit(everything)(args)
        for key, ((_, value), grads) in res.items():
            out[f"{world}/{key}"] = (np.asarray(value),
                                     [np.asarray(g) for g in grads])
    return out


@pytest.fixture(scope="module")
def reference():
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(1)
    future = pool.submit(_jax_side)
    try:
        yield future
    finally:
        pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference):
    import multiprocessing.forkserver

    from horovod_tpu_torch.ops import _build

    _build.build_core()   # once, before the ranks' time limit starts
    outdir = tmp_path_factory.mktemp("parallel")
    ctx = torch.multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "horovod_tpu_torch"])
    procs = [ctx.Process(target=_worker, args=(r, world, str(outdir)))
             for world in WORLDS for r in range(world)]
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
        multiprocessing.forkserver._forkserver._stop()
    assert not alive, f"{len(alive)} rank(s) did not finish in " \
                      f"{JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    return {world: [torch.load(outdir / f"np{world}.rank{r}.pt")
                    for r in range(world)] for world in WORLDS}


def _close(got, want, tol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    rtol, atol = tol
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _check(ranks, reference, world, key, tol, by_rank, summed,
           out_rows=None):
    """Outputs rank by rank (``out_rows(rank)`` slices a sharded output);
    gradients ``by_rank`` (indices held rank by rank, sliced by
    ``out_rows`` where sharded) and ``summed`` (summed over the ranks)."""
    want_out, want_grads = reference.result()[f"{world}/{key}"]
    got = [r[key] for r in ranks[world]]
    for r, (out, grads) in enumerate(got):
        rows = out_rows(r) if out_rows else slice(None)
        _close(out, want_out[rows], tol, f"np{world} {key} out rank {r}")
        for i in by_rank:
            want = want_grads[i]
            if isinstance(by_rank, dict):
                want = want[by_rank[i](r)]
            _close(grads[i], want, tol, f"np{world} {key} grad {i} rank {r}")
    for i in summed:
        total = sum(g[1][i] for g in got)
        _close(total, want_grads[i], tol, f"np{world} {key} grad {i} summed")


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_layout_matches_reference(ranks, reference, world):
    """Row-major ranks, as the reference's ``np.reshape(devices, sizes)``;
    the global mesh is the world on axis ``hvd``; ``sub_mesh`` keeps the
    ranks given."""
    want = reference.result()[f"{world}/grid"]
    for r, res in enumerate(ranks[world]):
        assert res["global"] == (r, world, "hvd")
        assert {n: idx for n, (idx, _) in res["grid"].items()} == want[r]
        dp, sp = r // 2, r % 2
        assert res["grid"]["sp"][1] == [2 * dp, 2 * dp + 1]
        assert res["grid"]["dp"][1] == list(range(sp, world, 2))
        assert res["sub"] == ([0, 1] if r < 2 else None)


@pytest.mark.parametrize("world", WORLDS)
def test_refusals_match_reference(ranks, reference, world):
    """Too few ranks for a mesh and a dim the axis does not divide raise
    ValueError, with the reference's message."""
    for res in ranks[world]:
        assert res["error/mesh"] == reference.result()[f"{world}/error/mesh"]
        assert "not divisible by axis 'tp'" in res["error/shard_kernel"]


@pytest.mark.parametrize("world", WORLDS)
def test_tp_mlp_matches_reference(ranks, reference, world):
    # x (pvary) and b_out (replicated use) rank by rank; w_in, b_in, w_out
    # sliced per rank, summed.
    _check(ranks, reference, world, "tp", TOL["tp"], by_rank=[0, 4],
           summed=[1, 2, 3])


@pytest.mark.parametrize("world", WORLDS)
def test_column_parallel_gather_matches_reference(ranks, reference, world):
    _check(ranks, reference, world, "col", TOL["tp"], by_rank=[0],
           summed=[1], out_rows=lambda r: r)


@pytest.mark.parametrize("world", WORLDS)
def test_vocab_parallel_embedding_matches_reference(ranks, reference, world):
    _check(ranks, reference, world, "vocab", TOL["vocab"], by_rank=[],
           summed=[0])


@pytest.mark.parametrize("world", WORLDS)
def test_gpipe_last_stage_value_matches_reference(ranks, reference, world):
    _check(ranks, reference, world, "pp", TOL["pp"], by_rank=[0],
           summed=[1])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("factor", CAPACITY)
def test_switch_moe_matches_reference(ranks, reference, world, factor):
    """Outputs and the tokens' gradients shard by shard; the router's and
    the stacked experts' gradients summed.  At factor 1.0 tokens drop."""
    def rows(r):
        return slice(r * TOKENS, (r + 1) * TOKENS)

    _check(ranks, reference, world, f"moe/{factor}", TOL["moe"],
           by_rank={0: rows}, summed=[1, 2, 3], out_rows=rows)


@pytest.mark.parametrize("world", WORLDS)
def test_load_balancing_loss_matches_reference(ranks, reference, world):
    _check(ranks, reference, world, "lb", TOL["moe"],
           by_rank={0: lambda r: slice(r * TOKENS, (r + 1) * TOKENS)},
           summed=[1], out_rows=lambda r: r)
