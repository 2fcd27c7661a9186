"""The port's flash attention (horovod_tpu_torch.ops.flash_attention) against
the JAX package's Pallas kernels run in interpret mode.

On the CPU the port takes the plain version of its kernels (online softmax
over kv tiles; P rebuilt from lse in the backward), so these tests pin the
arithmetic the CUDA kernels implement; the kernels themselves are checked
against the same plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa

SHAPES = [(1, 32, 2, 16), (2, 64, 4, 32), (1, 23, 2, 16)]  # last: padded S
FWD_TOL = 2e-5   # fp32, as tests/single/test_flash_attention.py
GRAD_TOL = 2e-4
# XLA's CPU backend at optimization level 0: the interpret-mode grid loops
# compile in about half the CPU time, and the values stay within FWD_TOL.
FAST_COMPILE = {"xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread, so that idle OpenMP
    workers do not spin on a CPU the other test processes share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _jax_case(q, k, v, causal):
    """The Pallas forward and the pullbacks of both cotangents (without and
    with an lse term), compiled once as one program."""
    def case(q, k, v):
        (o, l), pullback = jax.vjp(
            lambda q, k, v: jfa.flash_attention_with_lse(
                q, k, v, causal=causal, block_q=16, block_k=16,
                interpret=True), q, k, v)
        ct_out, ct_lse = jnp.cos(o), -0.5 * jnp.sin(0.5 * l)
        return (o, l, pullback((ct_out, jnp.zeros_like(l))),
                pullback((ct_out, ct_lse)))

    return jax.jit(case).lower(q, k, v).compile(FAST_COMPILE)(q, k, v)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_pallas(shape, causal):
    """Forward (out, lse) and the gradients of sum(sin(out)) and of
    sum(sin(out)) + sum(cos(lse/2)), whose lse term exercises the dlse
    fold (delta = rowsum(dO * O) - dlse), against the Pallas kernels and
    their custom-VJP backward."""
    q, k, v = _inputs(shape, 0)
    jo, jl, *jgrads_by_case = _jax_case(q, k, v, causal)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tfa.reset_launch_counts()
    out, lse = tfa.flash_attention_with_lse(tq, tk, tv, causal=causal,
                                            block_q=16, block_k=16)
    assert out.shape == shape and lse.shape == (shape[0], shape[2], shape[1])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jl),
                               rtol=FWD_TOL, atol=FWD_TOL)
    for with_lse, jgrads in zip((False, True), jgrads_by_case):
        loss = out.sin().sum()
        if with_lse:
            loss = loss + torch.cos(0.5 * lse).sum()
        tgrads = torch.autograd.grad(loss, (tq, tk, tv), retain_graph=True)
        for name, tg, jg in zip("qkv", tgrads, jgrads):
            np.testing.assert_allclose(
                tg.numpy(), np.asarray(jg), rtol=GRAD_TOL, atol=GRAD_TOL,
                err_msg=f"d{name} with_lse={with_lse}")
    # CPU tensors take the plain version: no kernel launched.
    assert tfa.LAUNCHES == {name: 0 for name in tfa.LAUNCHES}


@pytest.mark.parametrize("causal", [False, True])
def test_dense_matches_jax_dense(causal):
    q, k, v = _inputs((2, 24, 3, 8), 2)
    jo, jl = jax.jit(jfa.dense_attention_with_lse, static_argnums=3)(
        q, k, v, causal)
    to, tl = tfa.dense_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=FWD_TOL,
                               atol=FWD_TOL)


def test_plain_version_streams_tiles():
    """The plain forward's result does not depend on the kv tile size (the
    online softmax is exact), and equals dense attention."""
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 40, 2, 8), 3))
    ref, ref_lse = tfa.dense_attention_with_lse(q, k, v, causal=True)
    for block in (8, 16, 40):
        out, lse = tfa.flash_fwd_reference(q, k, v, 8 ** -0.5, True, block)
        torch.testing.assert_close(out, ref, rtol=FWD_TOL, atol=FWD_TOL)
        torch.testing.assert_close(lse, ref_lse, rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("case", ["fp32", "head_dim", "layout", "scale"])
def test_kernel_wrapper_raises_on_what_it_does_not_take(case):
    """The CUDA wrappers check dtype, head_dim, layout and scale before
    anything is built or launched, and raise: there is no fallback."""
    shape = (1, 16, 2, 64)
    q = torch.zeros(shape, dtype=torch.bfloat16)
    scale = 0.125
    if case == "scale":
        # K4 and K6 fold the scale into the exponent after the row max.
        scale, err = -0.125, ValueError
        with pytest.raises(err):
            tfa.flash_bwd_dkv_cuda(q, q, q, q, None, None, scale, True)
    elif case == "fp32":
        q, err = q.float(), TypeError
    elif case == "head_dim":
        q, err = torch.zeros((1, 16, 2, 32), dtype=torch.bfloat16), ValueError
    else:
        q, err = torch.zeros((1, 16, 64, 2),
                             dtype=torch.bfloat16).transpose(-1, -2), \
            ValueError
    with pytest.raises(err):
        tfa.flash_fwd_cuda(q, q, q, scale, True)
    assert tfa._lib is None  # nothing was built


def test_mixed_devices_raise():
    q = torch.zeros((1, 8, 1, 8))
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q.to("meta"), q)
