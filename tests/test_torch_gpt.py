"""The port's GPT (horovod_tpu_torch.models) against the JAX package's flax
GPT, and the port's DistributedOptimizer trainer against the JAX trainer of
examples/jax_gpt_long_context.py, on the CPU in fp32.

Both sides run the flash path (``use_flash=True``): on the CPU the JAX GPT
dispatches it to ``dense_attention`` and the port to the plain version of
its kernels, the same math.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu import models as jmodels
from horovod_tpu.ops.collectives import shard_map

import horovod_tpu_torch as thvd
from horovod_tpu_torch import models as tmodels

JCFG = jmodels.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                         num_heads=4, max_seq_len=32, use_flash=True,
                         dtype=jnp.float32)
TCFG = tmodels.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                         num_heads=4, max_seq_len=32, use_flash=True,
                         dtype=torch.float32)
# AdamW hyperparameters, all passed explicitly on both sides (optax's and
# torch's weight_decay defaults differ).  eps is 1e-6, not 1e-8: the k
# projection's bias has a gradient that is zero in exact arithmetic (softmax
# ignores a constant added to every key's score), so in fp32 it is rounding
# noise of about 5e-9, which Adam at eps=1e-8 would blow up into full +-lr
# steps whose signs differ between the two frameworks.
LR, WD, EPS = 3e-4, 1e-4, 1e-6
# XLA's CPU backend at optimization level 0: the JAX side compiles in about
# half the CPU time, to the same fp32 values within the tolerances here.
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that idle OpenMP
    workers do not spin on a CPU the other test processes share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    """Token ids and flax-layout parameters, all drawn with numpy."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, JCFG.vocab_size, (4, JCFG.max_seq_len),
                       dtype=np.int32)
    shapes = jax.eval_shape(jmodels.GPT(JCFG).init, jax.random.PRNGKey(1),
                            jnp.asarray(ids))

    def draw(path, leaf):
        x = rng.normal(0.0, 0.05, leaf.shape).astype(np.float32)
        return x + 1.0 if jax.tree_util.keystr(path).endswith("['scale']") \
            else x

    return ids, jax.tree_util.tree_map_with_path(draw, shapes)


def _torch_model(params):
    torch.manual_seed(0)
    model = tmodels.GPT(TCFG)
    model.load_state_dict(tmodels.gpt_params_from_jax(params))
    return model


def _assert_tree_close(got, want, tol):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        np.testing.assert_allclose(
            g, np.asarray(flat_want[path]), rtol=tol, atol=tol,
            err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def flax_outputs(setup):
    """Logits, loss and gradients of the flax model, from one compile."""
    ids, params = setup
    model = jmodels.GPT(JCFG)

    def loss_and_logits(p):
        logits = model.apply(p, jnp.asarray(ids))
        return jmodels.lm_loss(logits, jnp.asarray(ids)), logits

    (loss, logits), grads = _compile(jax.value_and_grad(
        loss_and_logits, has_aux=True), params)(params)
    return np.asarray(logits), float(loss), grads


def test_logits_and_loss_match_flax(setup, flax_outputs):
    ids, params = setup
    jlogits, jloss, _ = flax_outputs
    tids = torch.from_numpy(ids.astype(np.int64))
    with torch.no_grad():
        tlogits = _torch_model(params)(tids)
        tloss = tmodels.lm_loss(tlogits, tids)
    assert tlogits.shape == (4, JCFG.max_seq_len, JCFG.vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), jlogits, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tloss.item(), jloss, rtol=1e-4, atol=1e-4)


def test_grads_match_flax(setup, flax_outputs):
    ids, params = setup
    tmodel = _torch_model(params)
    tids = torch.from_numpy(ids.astype(np.int64))
    tmodels.lm_loss(tmodel(tids), tids).backward()
    tgrads = tmodels.gpt_params_to_jax(
        {n: p.grad for n, p in tmodel.named_parameters()}, params)
    _assert_tree_close(tgrads, flax_outputs[2]["params"], 2e-4)


def test_conversion_round_trips(setup):
    _, params = setup
    back = tmodels.gpt_params_to_jax(tmodels.gpt_params_from_jax(params),
                                     params)
    _assert_tree_close(back, params["params"], 0.0)


def test_two_distributed_steps_match_jax_trainer(setup, hvd_single,
                                                 monkeypatch):
    """Two DistributedOptimizer(AdamW) steps of the port at world 1 on the
    full batch against the JAX trainer pattern: optax.adamw inside
    DistributedOptimizer under shard_map over a 2-device CPU mesh, each
    device holding half the batch (the averaged gradient is the same).

    ``check_vma=False``, as tests/single/test_optimizer.py runs it: with
    vma tracking on (this jax's default), AD hands the optimizer gradients
    that are already summed over "dp" for every leaf, and the reference's
    ``_tree_allreduce`` reads an all-invariant tree as "tracking off" and
    sums them again, so the averaged gradient comes out world-size times
    the mean (ROADMAP Queue 3).  AdamW hides a uniform scale except where
    |g| is near eps, which is where this test caught it.

    The port runs on its pure-Python core here: the reference's native
    core is up in this process, and the two libraries are never loaded
    into one process together."""
    ids, params = setup
    jhvd = hvd_single
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    model = jmodels.GPT(JCFG)
    tx = jhvd.DistributedOptimizer(
        optax.adamw(LR, b1=0.9, b2=0.999, eps=EPS, weight_decay=WD),
        axis_name="dp")

    def train_step(p, opt_state, batch):
        loss, grads = jax.value_and_grad(
            lambda q: jmodels.lm_loss(model.apply(q, batch), batch))(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        return (optax.apply_updates(p, updates), opt_state,
                jhvd.allreduce(loss, axis_name="dp"))

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jparams)
    step = _compile(shard_map(train_step, mesh=mesh,
                              in_specs=(P(), P(), P("dp")),
                              out_specs=(P(), P(), P()), check_vma=False),
                    jparams, jstate, jnp.asarray(ids))
    jlosses = []
    for _ in range(2):
        jparams, jstate, jloss = step(jparams, jstate, jnp.asarray(ids))
        jlosses.append(float(jloss))

    monkeypatch.setenv("HOROVOD_CONTROLLER", "python")
    thvd.init(device="cpu")
    try:
        tmodel = _torch_model(params)
        thvd.broadcast_parameters(tmodel.state_dict(), root_rank=0)
        opt = thvd.DistributedOptimizer(
            torch.optim.AdamW(tmodel.parameters(), lr=LR, weight_decay=WD,
                              betas=(0.9, 0.999), eps=EPS),
            named_parameters=tmodel.named_parameters())
        tids = torch.from_numpy(ids.astype(np.int64))
        tlosses = []
        for _ in range(2):
            opt.zero_grad()
            loss = tmodels.lm_loss(tmodel(tids), tids)
            loss.backward()
            opt.step()
            tlosses.append(thvd.allreduce(loss.detach()).item())
    finally:
        thvd.shutdown()
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4, atol=1e-4)
    _assert_tree_close(
        tmodels.gpt_params_to_jax(dict(tmodel.named_parameters()), params),
        jparams["params"], 1e-4)


def test_small_and_tiny_configs_mirror_jax():
    for tcfg, jcfg in ((tmodels.GPT_SMALL, jmodels.GPT_SMALL),
                       (tmodels.GPT_TINY, jmodels.GPT_TINY)):
        for f in dataclasses.fields(tcfg):
            if f.name != "dtype":
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
        assert str(tcfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name


@pytest.mark.parametrize("check_vma", [True, False])
def test_reference_average_scale_under_shard_map(hvd_single, check_vma):
    """Pins the reference fault logged in ROADMAP Queue 3: inside
    shard_map with vma tracking on, the JAX DistributedOptimizer's Average
    of a replicated parameter's gradient comes out world-size times the
    mean (here 2x), and the mean with tracking off.  The port's Average is
    the mean (tests/test_torch_optimizer.py, np=2)."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    x = np.random.default_rng(5).standard_normal((4, 3)).astype(np.float32)
    w = jnp.ones((3,), jnp.float32)
    tx = hvd_single.DistributedOptimizer(optax.sgd(1.0), axis_name="dp")

    def step(w, state, xb):
        g = jax.grad(lambda w: jnp.mean(xb @ w))(w)
        return tx.update(g, state, w)[0]

    args = (w, tx.init(w), jnp.asarray(x))
    upd = _compile(shard_map(step, mesh=mesh, in_specs=(P(), P(), P("dp")),
                             out_specs=P(), check_vma=check_vma), *args)(*args)
    mean_grad = x.mean(axis=0)
    np.testing.assert_allclose(np.asarray(upd) / -mean_grad,
                               np.full(3, 2.0 if check_vma else 1.0),
                               rtol=1e-5)
