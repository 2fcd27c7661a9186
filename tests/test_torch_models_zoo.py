"""The port's CNN zoo and MLP against the JAX package's, on the CPU.

Every leaf of a flax variable tree is drawn from a numpy seed and goes
through ``models.convert.from_jax`` into the port's model (so the
converter is under test too); one training-mode step runs through both:
the logits, the loss, every parameter's gradient (brought back through
``models.convert.to_jax``) and the updated ``batch_stats``.  Images are
NHWC for flax and the same values NCHW for the port.

Tolerances: fp32 results within ``FP32_TOL`` of the largest magnitude of
the compared tensor (convolutions and reductions sum in another order on
each side; the measured gaps are 1e-6 to 2e-5 of that).  In bf16 both
sides round every activation to 8 bits, and a different summation order
moves some by an ulp; through BatchNorm's backward that is noise of about
20% in the gradients on both sides (each side's bf16 gradient is 0.21 of
the fp32 one away from it, by the global norm).  So the bf16 ResNet's
logits and batch_stats are held to the reference's bf16 ones within
``BF16_TOL`` of their largest magnitude, and its gradient to the fp32
gradient: no further from it than ``BF16_GRAD_RATIO`` times the
reference's bf16 gradient is.  The JAX side is compiled at XLA
optimization level 0, which compiles in a third of the time and changes
no value that matters at these tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import models as jm
from horovod_tpu_torch import models as tm
from horovod_tpu_torch.models import convert

FP32_TOL = 1e-4
BF16_TOL = 5e-2
BF16_GRAD_RATIO = 1.5
O0 = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_variables(shapes, seed):
    """A flax variable tree of ``shapes`` filled from a numpy seed at the
    scales a trained model has: kernels at He scale, norm scales near 1,
    running variances positive."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name == "kernel":
            if path[-2].key == "out":
                fan_in = shape[0] * shape[1]
            else:
                fan_in = int(np.prod(shape[:-1])) if len(shape) == 4 \
                    and path[-2].key != "qkv" else shape[0]
            a = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        elif name == "scale":
            a = 1.0 + 0.2 * rng.standard_normal(shape)
        elif name == "var":
            a = 1.0 + 0.5 * rng.random(shape)
        elif name == "embedding":
            a = 0.5 * rng.standard_normal(shape)
        else:                               # bias, mean
            a = 0.1 * rng.standard_normal(shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def assert_close(got, want, tol, what):
    """Every leaf of ``got`` within ``tol`` of the largest magnitude of the
    matching leaf of ``want``."""
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves(got)
    assert len(flat_g) == len(flat_w), what
    for (path, w), g in zip(flat_w, flat_g):
        w, g = np.asarray(w, np.float32), np.asarray(g, np.float32)
        assert g.shape == w.shape, (what, path)
        np.testing.assert_allclose(
            g, w, rtol=0, atol=tol * max(float(np.abs(w).max()), 1e-30),
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def jax_step(jmodel, variables, x, labels, train_kw):
    """Logits, loss, parameter gradients and updated batch_stats of one
    training-mode forward and backward of the flax model."""
    has_bn = "batch_stats" in variables

    def loss_fn(params, stats):
        vs = {"params": params}
        if has_bn:
            vs["batch_stats"] = stats
            logits, upd = jmodel.apply(vs, x, mutable=["batch_stats"],
                                       **train_kw)
            stats = upd["batch_stats"]
        else:
            logits = jmodel.apply(vs, x, **train_kw)
        return jm.xent_loss(logits, labels), (logits, stats)

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    args = (variables["params"], variables.get("batch_stats", {}))
    (loss, (logits, stats)), grads = fn.lower(*args).compile(O0)(*args)
    return np.asarray(logits), float(loss), grads, stats


def port_step(tmodel, variables, x, labels, train: bool):
    tmodel.load_state_dict(convert.from_jax(variables), strict=True)
    tmodel.train(train)
    logits = tmodel(nchw(x) if np.ndim(x) == 4 else torch.from_numpy(
        np.asarray(x)))
    loss = tm.xent_loss(logits, torch.from_numpy(np.asarray(labels)))
    loss.backward()
    grads = convert.to_jax(
        {n: p.grad for n, p in tmodel.named_parameters()},
        variables["params"])
    stats = {}
    if "batch_stats" in variables:
        stats = convert.to_jax(dict(tmodel.state_dict()), variables)[
            "batch_stats"]
    return logits.detach().float().numpy(), loss.item(), grads, stats


def _bottleneck(mod, **kw):
    return mod.ResNet(stage_sizes=[1, 1, 1, 1],
                      block_cls=mod.resnet.BottleneckResNetBlock,
                      num_filters=8, num_classes=10, **kw)


# name -> (flax model, port model, input NHWC shape, train-mode flax kwargs,
# train flag of the port, tolerance)
CASES = {
    # 33 px: every stride-2 convolution sees an odd size (SAME pads 1, 1).
    "resnet_tiny_33": (lambda: jm.ResNetTiny(num_classes=10),
                       lambda: tm.ResNetTiny(num_classes=10),
                       (4, 33, 33, 3), {"train": True}, True, FP32_TOL),
    # 32 px: even sizes (SAME pads 0, 1 at stride 2).
    "bottleneck_32": (lambda: _bottleneck(jm), lambda: _bottleneck(tm),
                      (4, 32, 32, 3), {"train": True}, True, FP32_TOL),
    "mlp": (lambda: jm.MLP(features=(64, 32, 10)),
            lambda: tm.MLP(784, (64, 32, 10)), (8, 28, 28, 1), {}, True,
            FP32_TOL),
    # Dropout draws from each framework's own generator: VGG is compared
    # with it off (train=False is its only effect; VGG has no BatchNorm).
    "vgg_tiny": (lambda: jm.VGGTiny(num_classes=10),
                 lambda: tm.VGGTiny(num_classes=10, image_size=32),
                 (2, 32, 32, 3), {"train": False}, False, FP32_TOL),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_training_step_matches_flax(case):
    make_j, make_t, shape, train_kw, train, tol = CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal(shape).astype(np.float32)
    labels = rng.integers(0, 10, shape[0]).astype(np.int32)
    jmodel = make_j()
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]),
        **({"train": False} if train_kw else {})))
    variables = random_variables(shapes, seed=7)
    want = jax_step(jmodel, variables, jnp.asarray(x), jnp.asarray(labels),
                    train_kw)
    got = port_step(make_t(), variables, x, labels, train)
    assert_close(got[0], want[0], tol, "logits")
    assert got[1] == pytest.approx(want[1], rel=tol)
    assert_close(got[2], want[2], tol, "gradients")
    assert_close(got[3], want[3], tol, "batch_stats")
    if train_kw.get("train"):
        assert jax.tree_util.tree_leaves(want[3])  # BatchNorm was updated


def _global_norm(tree):
    return float(np.sqrt(sum(np.sum(np.square(np.asarray(leaf, np.float32)))
                             for leaf in jax.tree_util.tree_leaves(tree))))


def _diff(a, b):
    return jax.tree_util.tree_map(
        lambda p, q: np.asarray(p, np.float32) - np.asarray(q, np.float32),
        a, b)


def test_bf16_resnet_tiny_is_as_close_to_fp32_as_flax():
    """ResNetTiny with bf16 activations, 8 images of 64 px (the last stage
    still normalizes over 32 values per channel)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 64, 64, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 8).astype(np.int32)
    steps = {}
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jmodel = jm.ResNetTiny(num_classes=10, dtype=jdt)
        shapes = jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.asarray(x[:1]), train=False))
        variables = random_variables(shapes, seed=7)
        if jdt == jnp.float32:
            steps["fp32"] = jax_step(jmodel, variables, jnp.asarray(x),
                                     jnp.asarray(labels), {"train": True})
            continue
        steps["flax"] = jax_step(jmodel, variables, jnp.asarray(x),
                                 jnp.asarray(labels), {"train": True})
        steps["port"] = port_step(tm.ResNetTiny(num_classes=10, dtype=tdt),
                                  variables, x, labels, True)
    fp32, flax, port = steps["fp32"], steps["flax"], steps["port"]
    assert_close(port[0], flax[0], BF16_TOL, "bf16 logits")
    assert_close(port[3], flax[3], BF16_TOL, "bf16 batch_stats")
    ref_gap = _global_norm(_diff(flax[2], fp32[2]))
    port_gap = _global_norm(_diff(port[2], fp32[2]))
    assert 0 < port_gap <= BF16_GRAD_RATIO * ref_gap, (port_gap, ref_gap)


@pytest.mark.parametrize("case", ["resnet_tiny_33", "vgg_tiny", "mlp"])
def test_converters_round_trip(case):
    """to_jax then from_jax gives the port's state_dict back exactly."""
    make_j, make_t, shape, train_kw, _, _ = CASES[case]
    tmodel = make_t()
    jmodel = make_j()
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + shape[1:]),
        **({"train": False} if train_kw else {})))
    sd = tmodel.state_dict()
    back = convert.from_jax(convert.to_jax(dict(sd), shapes))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v.float()), k


def test_vgg_dropout_in_train_mode():
    """The port's VGG drops half the classifier's activations in train mode
    and none in eval mode."""
    torch.manual_seed(0)
    model = tm.VGGTiny(num_classes=10, image_size=32)
    x = torch.randn(4, 3, 32, 32)
    model.eval()
    a, b = model(x), model(x)
    assert torch.equal(a, b)
    model.train()
    c = model(x)
    assert torch.isfinite(c).all() and not torch.equal(a, c)


def test_flax_same_padding_is_asymmetric_at_stride_two():
    """A 3x3 convolution of stride 2 pads (0, 1) on an even size and (1, 1)
    on an odd one, as flax's "SAME" does."""
    from horovod_tpu_torch.models import _layers

    assert _layers._same_pads(32, 3, 2) == (0, 1)
    assert _layers._same_pads(33, 3, 2) == (1, 1)
    assert _layers._same_pads(32, 1, 2) == (0, 0)
    assert _layers._same_pads(17, 7, 1) == (3, 3)
