"""The port's BERT and Inception V3 against the JAX package's, on the CPU.

The same harness as ``test_torch_models_zoo.py``: flax variables drawn
from a numpy seed, converted by ``models.convert``, one step through both
sides, held to ``FP32_TOL`` of each compared tensor's largest magnitude.

- BERT_TINY in fp32 with token types and an attention mask: the MLM
  logits, ``mlm_loss`` and every gradient.
- Inception V3's blocks A-E in training mode, each at its real input
  width and a spatial size that leaves BatchNorm at least 32 values per
  channel: output, gradients, batch_stats.  The whole net at 75 px with a
  batch of 2 normalizes two values per channel in its last blocks, where a
  last-bit difference in the input decides the output (both sides are
  right, and they differ by 3e-2), so the whole net is held in eval mode,
  on running statistics from the seed: its logits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import models as jm
from horovod_tpu.models import inception as jinc
from horovod_tpu_torch import models as tm
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import inception as tinc

FP32_TOL = 1e-4
O0 = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_variables(shapes, seed):
    """Every leaf from a numpy seed: kernels at He scale, norm scales near
    1, running variances positive."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            parent = path[-2].key
            fan_in = (shape[0] * shape[1] if parent == "out" else
                      shape[0] if parent == "qkv" or len(shape) == 2 else
                      int(np.prod(shape[:-1])))
            a = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        elif name == "scale":
            a = 1.0 + 0.2 * rng.standard_normal(shape)
        elif name == "var":
            a = 1.0 + 0.5 * rng.random(shape)
        elif name == "embedding":
            a = 0.5 * rng.standard_normal(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def assert_close(got, want, tol, what):
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves(got)
    assert len(flat_g) == len(flat_w), what
    for (path, w), g in zip(flat_w, flat_g):
        w, g = np.asarray(w, np.float32), np.asarray(g, np.float32)
        assert g.shape == w.shape, (what, path)
        np.testing.assert_allclose(
            g, w, rtol=0, atol=tol * max(float(np.abs(w).max()), 1e-30),
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(O0)(*args)


def test_bert_tiny_matches_flax():
    cfg_j = jm.BertConfig(**{**jm.BERT_TINY.__dict__, "dtype": jnp.float32})
    cfg_t = tm.BertConfig(**{**tm.BERT_TINY.__dict__,
                             "dtype": torch.float32})
    rng = np.random.default_rng(5)
    b, s = 2, 16
    ids = rng.integers(0, cfg_j.vocab_size, (b, s)).astype(np.int32)
    types = rng.integers(0, 2, (b, s)).astype(np.int32)
    mask = np.ones((b, s), bool)
    mask[1, 11:] = False
    labels = rng.integers(0, cfg_j.vocab_size, (b, s)).astype(np.int32)
    weights = (rng.random((b, s)) < 0.3).astype(np.float32)
    jmodel = jm.BertForPreTraining(cfg_j)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(types)))
    variables = random_variables(shapes, seed=9)

    def loss_fn(params):
        logits = jmodel.apply({"params": params}, ids, types, mask)
        return jm.mlm_loss(logits, labels, weights), logits

    (loss, logits), grads = compiled(
        jax.value_and_grad(loss_fn, has_aux=True), variables["params"])

    tmodel = tm.BertForPreTraining(cfg_t)
    tmodel.load_state_dict(convert.from_jax(variables), strict=True)
    t = {k: torch.from_numpy(v) for k, v in
         dict(ids=ids, types=types, mask=mask, labels=labels,
              weights=weights).items()}
    tlogits = tmodel(t["ids"], t["types"], t["mask"])
    tloss = tm.mlm_loss(tlogits, t["labels"], t["weights"])
    tloss.backward()
    assert_close(tlogits.detach().numpy(), logits, FP32_TOL, "logits")
    assert tloss.item() == pytest.approx(float(loss), rel=FP32_TOL)
    tgrads = convert.to_jax({n: p.grad for n, p in tmodel.named_parameters()},
                            variables["params"])
    assert_close(tgrads, grads, FP32_TOL, "gradients")


def test_bert_embeddings_cast_after_the_gather():
    """bf16 BERT: the port gathers fp32 rows and casts them, flax casts the
    table and gathers; the embedded values are the same bits."""
    cfg = tm.BertConfig(**{**tm.BERT_TINY.__dict__, "num_layers": 0})
    model = tm.BertForPreTraining(cfg).encoder
    ids = torch.tensor([[3, 7, 1000]])
    pos = torch.arange(3)[None]
    want = model.word_embeddings.weight.to(torch.bfloat16)[ids] + \
        model.position_embeddings.weight.to(torch.bfloat16)[pos]
    got = model.word_embeddings(ids).to(torch.bfloat16) + \
        model.position_embeddings(pos).to(torch.bfloat16)
    assert torch.equal(got, want)


# block -> (flax block, port block class, port args, input NHWC shape);
# the input widths are the net's own.
BLOCKS = {
    "A": (lambda conv: jinc.InceptionA(32, conv), tinc.InceptionA, (32,),
          (2, 5, 5, 192)),
    "B": (lambda conv: jinc.InceptionB(conv), tinc.InceptionB, (),
          (2, 9, 9, 288)),
    "C": (lambda conv: jinc.InceptionC(128, conv), tinc.InceptionC, (128,),
          (2, 4, 4, 768)),
    "D": (lambda conv: jinc.InceptionD(conv), tinc.InceptionD, (),
          (2, 9, 9, 768)),
    "E": (lambda conv: jinc.InceptionE(conv), tinc.InceptionE, (),
          (2, 4, 4, 1280)),
}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_inception_block_training_step_matches_flax(block):
    make_j, cls_t, args, shape = BLOCKS[block]
    rng = np.random.default_rng(ord(block))
    x = rng.standard_normal(shape).astype(np.float32)
    jblock = make_j(functools.partial(jinc.ConvBN, dtype=jnp.float32))
    shapes = jax.eval_shape(lambda: jblock.init(
        jax.random.PRNGKey(0), jnp.asarray(x), False))
    variables = random_variables(shapes, seed=11)
    out_shape = jax.eval_shape(
        lambda: jblock.apply(variables, jnp.asarray(x), False)).shape
    proj = rng.standard_normal(out_shape).astype(np.float32)

    def loss_fn(params, stats):
        out, upd = jblock.apply({"params": params, "batch_stats": stats},
                                x, True, mutable=["batch_stats"])
        return jnp.sum(out * proj), (out, upd["batch_stats"])

    (_, (out, stats)), grads = compiled(
        jax.value_and_grad(loss_fn, has_aux=True), variables["params"],
        variables["batch_stats"])

    tblock = cls_t(shape[-1], *args, functools.partial(tinc.ConvBN))
    tblock.load_state_dict(convert.from_jax(variables), strict=True)
    tblock.train()
    tout = tblock(torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 3, 1, 2))))
    (tout * torch.from_numpy(np.ascontiguousarray(
        proj.transpose(0, 3, 1, 2)))).sum().backward()
    assert_close(tout.detach().numpy().transpose(0, 2, 3, 1), out, FP32_TOL,
                 "output")
    assert_close(convert.to_jax(
        {n: p.grad for n, p in tblock.named_parameters()},
        variables["params"]), grads, FP32_TOL, "gradients")
    assert_close(convert.to_jax(dict(tblock.state_dict()), variables)[
        "batch_stats"], stats, FP32_TOL, "batch_stats")


def test_inception_v3_eval_logits_match_flax():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 75, 75, 3)).astype(np.float32)
    jmodel = jm.InceptionV3(num_classes=10)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    variables = random_variables(shapes, seed=12)
    logits = compiled(lambda v: jmodel.apply(v, x, train=False), variables)
    tmodel = tm.InceptionV3(num_classes=10)
    tmodel.load_state_dict(convert.from_jax(variables), strict=True)
    tmodel.eval()
    with torch.no_grad():
        tlogits = tmodel(torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2))))
    assert_close(tlogits.numpy(), logits, FP32_TOL, "logits")
