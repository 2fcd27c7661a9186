"""The port's ring attention, Ulysses and the sequence-parallel GPT and BERT
(``horovod_tpu_torch.parallel``, ``models`` with ``sp_axis_name``) against
the JAX package's, at np=2 and np=4 over gloo on the CPU.

One job per world size, every rank a process forked from a fork server
that has torch and the port loaded, as ``tests/test_torch_parallel_layers.py``
runs its ranks; each rank holds its sequence shard of the same seeded numpy
inputs (models: weights drawn by ``torch.manual_seed(0)`` on every rank and
converted for the reference) and saves its outputs and gradients.  The
reference runs in ``shard_map`` over the conftest's CPU mesh at the same
world size in a thread of the test process: the dense-chunk ring, Ulysses
and the models in one program with ``check_vma=True``; the flash-chunk
ring, whose Pallas kernels run only in interpret mode, in another with
``check_vma=False`` (as ``tests/single/test_ring_attention.py`` runs it).
The port's flash chunks run the plain versions of its kernels on the CPU.
Off the TPU the reference's models dispatch ``sp_use_flash`` hops to
``dense_attention_with_lse``.

Inputs' gradients are held shard by shard; a model parameter's gradient is
summed over the ranks (JAX's AD sums a replicated parameter's parts under
vma typing).  Tolerances are ``tests/single/test_ring_attention.py``'s: 2e-5
for the dense ring and Ulysses, 2e-4 for the flash-chunk output and 3e-4
for its gradients, 1e-4 for the models.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from test_torch_spine import _phase_port

WORLDS = (2, 4)
JOIN_TIMEOUT_S = 120
TOL = {"dense": 2e-5, "flash_out": 2e-4, "flash_grad": 3e-4,
       "ulysses": 2e-5, "model": 1e-4}
DENSE = (2, 8, 4, 8)        # B, S_local, H, D
FLASH = (1, 4, 2, 8)        # tests/single/test_ring_attention.py's
FLASH_BLOCK = 2
ULYSSES = (2, 4, 4, 4)      # heads divisible by 4
CAUSAL = (False, True)
GPT_CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4)
BERT_CFG = dict(vocab_size=256, hidden_size=32, num_layers=1, num_heads=4,
                intermediate_size=64, max_position_embeddings=64)
SEQ_LOCAL = 8               # model tokens a rank
FAST = {"xla_backend_optimization_level": 0}
BATCH = 2


def _inputs(world):
    rng = np.random.default_rng(41 + world)

    def qkv(b, s, h, d):
        return [rng.standard_normal((b, s * world, h, d)).astype(np.float32)
                for _ in range(3)]

    mask = np.ones((BATCH, SEQ_LOCAL * world), np.int32)
    mask[0, -3:] = 0
    return {"dense": qkv(*DENSE), "flash": qkv(*FLASH),
            "ulysses": qkv(*ULYSSES),
            "gpt_ids": rng.integers(0, GPT_CFG["vocab_size"],
                                    (BATCH, SEQ_LOCAL * world)),
            "bert_ids": rng.integers(0, BERT_CFG["vocab_size"],
                                     (BATCH, SEQ_LOCAL * world)),
            "mask": mask}


def _gpt(**kw):
    from horovod_tpu_torch import models

    torch.manual_seed(0)
    return models.GPT(models.GPTConfig(max_seq_len=SEQ_LOCAL * 4,
                                       dtype=torch.float32, **GPT_CFG, **kw))


def _bert(**kw):
    from horovod_tpu_torch import models

    torch.manual_seed(0)
    return models.BertEncoder(models.BertConfig(dtype=torch.float32,
                                                **BERT_CFG, **kw))


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


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
    from horovod_tpu_torch import models, parallel as par

    hvd.init(device="cpu")
    inp = _inputs(world)
    res = {}

    def shard(a, s_local):
        return torch.tensor(a[:, rank * s_local:(rank + 1) * s_local],
                            requires_grad=True)

    with par.build_mesh({"sp": world}):
        for causal in CAUSAL:
            for kind, shape in (("dense", DENSE), ("flash", FLASH)):
                q, k, v = xs = [shard(a, shape[1]) for a in inp[kind]]
                out = par.ring_attention(q, k, v, "sp", causal=causal,
                                         use_flash=kind == "flash",
                                         block_size=FLASH_BLOCK)
                torch.sin(out).sum().backward()
                res[f"{kind}/{causal}"] = (out.detach(),
                                           [x.grad for x in xs])
            q, k, v = xs = [shard(a, ULYSSES[1]) for a in inp["ulysses"]]
            out = par.ulysses_attention(q, k, v, "sp", causal=causal)
            torch.sin(out).sum().backward()
            res[f"ulysses/{causal}"] = (out.detach(), [x.grad for x in xs])
        try:
            par.ulysses_attention(*[torch.zeros(1, 2, 3, 4)] * 3, "sp")
            res["error/ulysses"] = "no error"
        except ValueError as exc:
            res["error/ulysses"] = str(exc)

        ids = torch.from_numpy(inp["gpt_ids"][:, rank * SEQ_LOCAL:
                                              (rank + 1) * SEQ_LOCAL])
        for flash in (False, True):
            gpt = _gpt(sp_axis_name="sp", sp_use_flash=flash)
            logits = gpt(ids)
            models.lm_loss(logits, ids).backward()
            res[f"gpt/{flash}"] = (logits.detach(), _grads(gpt))
        gpt = _gpt(sp_axis_name="sp", remat=True)   # hops rerun in backward
        logits = gpt(ids)
        models.lm_loss(logits, ids).backward()
        res["gpt/remat"] = (logits.detach(), _grads(gpt))
        bert = _bert(sp_axis_name="sp")
        ids = torch.from_numpy(inp["bert_ids"][:, rank * SEQ_LOCAL:
                                               (rank + 1) * SEQ_LOCAL])
        hidden = bert(ids)
        torch.sin(hidden).sum().backward()
        res["bert"] = (hidden.detach(), _grads(bert))
        mask = torch.from_numpy(inp["mask"][:, rank * SEQ_LOCAL:
                                            (rank + 1) * SEQ_LOCAL])
        with torch.no_grad():
            res["bert/masked"] = bert(ids, attention_mask=mask)
    hvd.shutdown()
    torch.save(res, os.path.join(outdir, f"np{world}.rank{rank}.pt"))


def _jax_world(world):
    """The reference's outputs and gradients at ``world`` devices, in a
    process of its own (tracing the programs takes most of the time)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu import models as jmodels
    from horovod_tpu.ops.collectives import shard_map
    from horovod_tpu.parallel import ring_attention, ulysses_attention
    from horovod_tpu_torch import models as tmodels

    torch.set_num_threads(1)
    gpt, bert = _gpt(), _bert()
    out = {}
    inp = _inputs(world)
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("sp",))
    seq = P(None, "sp")

    def attention(fn, flash):
        def loss(q, k, v):
            o = shard_map(fn, mesh=mesh, in_specs=seq, out_specs=seq,
                          check_vma=not flash)(q, k, v)
            return jnp.sum(jnp.sin(o)), o
        return jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)

    def ring(causal, flash):
        return attention(lambda q, k, v: ring_attention(
            q, k, v, "sp", causal=causal, use_flash=flash,
            block_size=FLASH_BLOCK, interpret=flash), flash)

    def ulysses(causal):
        return attention(lambda q, k, v: ulysses_attention(
            q, k, v, "sp", causal=causal), False)

    gcfg = jmodels.GPTConfig(max_seq_len=SEQ_LOCAL * 4,
                             dtype=jnp.float32, **GPT_CFG)
    ids = jnp.asarray(inp["gpt_ids"], jnp.int32)
    like = jax.eval_shape(jmodels.GPT(gcfg).init, jax.random.PRNGKey(0),
                          ids[:, :SEQ_LOCAL])
    gparams = {"params": tmodels.gpt_params_to_jax(
        dict(gpt.named_parameters()), like)}

    def gpt_loss(flash):
        model = jmodels.GPT(dataclasses.replace(
            gcfg, sp_axis_name="sp", sp_use_flash=flash))

        def fn(p, ids):
            logits = model.apply(p, ids)
            return jmodels.lm_loss(logits, ids)[None], logits

        def loss(p):
            losses, logits = shard_map(
                fn, mesh=mesh, in_specs=(P(), seq),
                out_specs=(P("sp"), seq))(p, ids)
            return jnp.sum(losses), logits
        return jax.value_and_grad(loss, has_aux=True)

    bcfg = jmodels.BertConfig(dtype=jnp.float32, sp_axis_name="sp",
                              **BERT_CFG)
    bids = jnp.asarray(inp["bert_ids"], jnp.int32)
    blike = jax.eval_shape(
        jmodels.BertEncoder(dataclasses.replace(bcfg, sp_axis_name=None))
        .init, jax.random.PRNGKey(0), bids)
    bparams = {"params": tmodels.to_jax(dict(bert.named_parameters()),
                                        blike["params"])}
    bmodel = jmodels.BertEncoder(bcfg)

    def bert_loss(p):
        o = shard_map(lambda p, i: bmodel.apply(p, i), mesh=mesh,
                      in_specs=(P(), seq), out_specs=seq)(p, bids)
        return jnp.sum(jnp.sin(o)), o

    def bert_masked(p, mask):
        return shard_map(lambda p, i, m: bmodel.apply(p, i, None, m),
                         mesh=mesh, in_specs=(P(), seq, seq),
                         out_specs=seq)(p, bids, mask)

    def dense_program(args):
        res = {}
        for causal in CAUSAL:
            res[f"dense/{causal}"] = ring(causal, False)(*args["dense"])
            res[f"ulysses/{causal}"] = ulysses(causal)(*args["ulysses"])
        for flash in (False, True):
            res[f"gpt/{flash}"] = gpt_loss(flash)(args["gpt"])
        res["bert"] = jax.value_and_grad(bert_loss, has_aux=True)(
            args["bert"])
        res["bert/masked"] = bert_masked(args["bert"], args["mask"])
        return res

    def flash_program(args):
        return {f"flash/{causal}": ring(causal, True)(*args)
                for causal in CAUSAL}

    args = {"dense": [jnp.asarray(a) for a in inp["dense"]],
            "ulysses": [jnp.asarray(a) for a in inp["ulysses"]],
            "gpt": gparams, "bert": bparams,
            "mask": jnp.asarray(inp["mask"])}
    fargs = [jnp.asarray(a) for a in inp["flash"]]
    res = dict(jax.jit(dense_program).lower(args).compile(FAST)(args))
    res.update(jax.jit(flash_program).lower(fargs).compile(FAST)(fargs))
    for key, value in res.items():
        if key == "bert/masked":
            out[f"{world}/{key}"] = np.asarray(value)
        else:
            (_, o), grads = value
            out[f"{world}/{key}"] = (
                np.asarray(o), jax.tree_util.tree_map(np.asarray, grads))
    shapes = jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, x.dtype), (like, blike["params"]))
    out[f"{world}/gpt_like"], out[f"{world}/bert_like"] = shapes
    try:
        shard_map(lambda q: ulysses_attention(q, q, q, "sp"), mesh=mesh,
                  in_specs=seq, out_specs=seq)(
            jnp.zeros((1, 2 * world, 3, 4)))
        out[f"{world}/error/ulysses"] = "no error"
    except ValueError as exc:
        out[f"{world}/error/ulysses"] = str(exc)
    return out


@pytest.fixture(scope="module")
def reference():
    """One spawned process per world size computes the reference while the
    ranks run; ``reference[world].result()`` waits for it."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(len(WORLDS),
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        yield {world: pool.submit(_jax_world, world) for world in WORLDS}
    finally:
        pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference):
    import multiprocessing.forkserver

    from horovod_tpu_torch.ops import _build

    _build.build_core()   # once, before the ranks' time limit starts
    outdir = tmp_path_factory.mktemp("ring")
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
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


def _shard_of(a, rank, world):
    s = a.shape[1] // world
    return a[:, rank * s:(rank + 1) * s]


def _hold_attention(ranks, reference, world, key, tol_out, tol_grad):
    want_out, want_grads = reference[world].result()[f"{world}/{key}"]
    for r, res in enumerate(ranks[world]):
        out, grads = res[key]
        _close(out, _shard_of(want_out, r, world), tol_out,
               f"np{world} {key} out rank {r}")
        for name, g, w in zip("qkv", grads, want_grads):
            assert torch.isfinite(g).all(), (key, r, name)
            _close(g, _shard_of(w, r, world), tol_grad,
                   f"np{world} {key} d{name} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("causal", CAUSAL)
def test_ring_attention_dense_chunks_match_reference(ranks, reference, world,
                                                     causal):
    _hold_attention(ranks, reference, world, f"dense/{causal}", TOL["dense"],
                    TOL["dense"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("causal", CAUSAL)
def test_ring_attention_flash_chunks_match_reference(ranks, reference, world,
                                                     causal):
    """The lse cotangents of the merge cross the flash backward; rank 0 of
    a causal ring merges only future chunks after its diagonal, and its
    gradients are finite."""
    _hold_attention(ranks, reference, world, f"flash/{causal}",
                    TOL["flash_out"], TOL["flash_grad"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("causal", CAUSAL)
def test_ulysses_matches_reference(ranks, reference, world, causal):
    _hold_attention(ranks, reference, world, f"ulysses/{causal}",
                    TOL["ulysses"], TOL["ulysses"])


@pytest.mark.parametrize("world", WORLDS)
def test_ulysses_refuses_indivisible_heads(ranks, reference, world):
    for res in ranks[world]:
        assert res["error/ulysses"] == \
            reference[world].result()[f"{world}/error/ulysses"]


def _hold_model(ranks, reference, world, key, to_jax, like, want=None):
    want_out, want_grads = reference[world].result()[
        f"{world}/{want or key}"]
    for r, res in enumerate(ranks[world]):
        _close(res[key][0], _shard_of(want_out, r, world), TOL["model"],
               f"np{world} {key} out rank {r}")
    names = ranks[world][0][key][1]
    summed = {n: sum(res[key][1][n] for res in ranks[world]) for n in names}
    got = to_jax(summed, reference[world].result()[f"{world}/{like}"])
    import jax

    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want_grads["params"])):
        _close(g, w, TOL["model"],
               f"np{world} {key} {jax.tree_util.keystr(path)} summed")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("flash", (False, True))
def test_gpt_sequence_parallel_matches_reference(ranks, reference, world,
                                                 flash):
    """Logits shard by shard (global positions), the parameters' gradients
    summed over the ranks, of the sum of the per-shard LM losses."""
    from horovod_tpu_torch.models import gpt_params_to_jax

    _hold_model(ranks, reference, world, f"gpt/{flash}", gpt_params_to_jax,
                "gpt_like")


@pytest.mark.parametrize("world", WORLDS)
def test_gpt_remat_matches_reference(ranks, reference, world):
    """``remat`` checkpoints each block: backward reruns its ring hops, in
    the same order on every rank, and the gradients are the reference's."""
    from horovod_tpu_torch.models import gpt_params_to_jax

    _hold_model(ranks, reference, world, "gpt/remat", gpt_params_to_jax,
                "gpt_like", want="gpt/False")


@pytest.mark.parametrize("world", WORLDS)
def test_bert_sequence_parallel_matches_reference(ranks, reference, world):
    from horovod_tpu_torch.models import to_jax

    _hold_model(ranks, reference, world, "bert", to_jax, "bert_like")


@pytest.mark.parametrize("world", WORLDS)
def test_bert_ring_ignores_the_attention_mask(ranks, reference, world):
    """The reference's sequence-parallel BERT passes no mask to its ring
    (``horovod_tpu/models/bert.py:61-65``); the port's does the same: the
    masked run equals the unmasked one and the reference's masked run."""
    want = reference[world].result()[f"{world}/bert/masked"]
    for r, res in enumerate(ranks[world]):
        torch.testing.assert_close(res["bert/masked"], res["bert"][0],
                                   rtol=0, atol=0)
        _close(res["bert/masked"], _shard_of(want, r, world), TOL["model"],
               f"np{world} masked rank {r}")


def test_merge_of_two_empty_rows_is_finite():
    """``m = m_c = -inf`` (no key so far, a fully masked chunk): the merge
    keeps the row empty, and its gradients are finite."""
    from horovod_tpu_torch.parallel.ring_attention import merge

    b, s, h, d = 1, 3, 2, 4
    gen = torch.Generator().manual_seed(0)
    acc = torch.zeros(b, s, h, d, requires_grad=True)
    m = torch.tensor([[[-torch.inf, 0.5, -torch.inf],
                       [-torch.inf, -torch.inf, 1.0]]], requires_grad=True)
    l = torch.tensor([[[0.0, 2.0, 0.0], [0.0, 0.0, 3.0]]],
                     requires_grad=True)
    ctx = torch.randn(b, s, h, d, generator=gen, requires_grad=True)
    m_c = torch.full((b, h, s), -torch.inf, requires_grad=True)
    l_c = torch.zeros(b, h, s, requires_grad=True)
    acc_new, m_new, l_new = merge(acc, m, l, ctx, m_c, l_c)
    assert torch.isfinite(acc_new).all() and torch.isfinite(l_new).all()
    assert torch.equal(l_new, l.detach())
    assert torch.equal(acc_new, acc.detach())
    (acc_new.sum() + l_new.sum() + torch.where(
        torch.isfinite(m_new), m_new, 0).sum()).backward()
    for t in (acc, m, l, ctx, m_c, l_c):
        assert torch.isfinite(t.grad).all()
