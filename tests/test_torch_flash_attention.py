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


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("with_dlse", [False, True])
def test_plain_dq_returns_the_reference_delta(with_dlse, padded):
    """The plain K5 returns delta = rowsum(dO * O) - dlse as the reference's
    fold in ``_flash_bwd_bhsd`` gives it (computed here with numpy on the
    same inputs), which K6 then takes.  Padded: S 23 with zero rows
    appended up to 32, as the reference's wrapper pads; rows past S get
    delta 0 and zero dq, and the rows before S the unpadded results."""
    b, s, h, d = 1, 23, 2, 16
    rng = np.random.default_rng(4)
    q, k, v, do, o = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                      for _ in range(5))
    dlse = (0.1 * rng.standard_normal((b, h, s))).astype(np.float32)
    sp = 32 if padded else s

    def pad(x, axis):
        width = [(0, 0)] * x.ndim
        width[axis] = (0, sp - s)
        return torch.from_numpy(np.pad(x, width))

    tq, tk, tv, tdo, to = (pad(x, 1) for x in (q, k, v, do, o))
    tdlse = pad(dlse, 2) if with_dlse else None
    scale = d ** -0.5
    _, lse = tfa.flash_fwd_reference(tq, tk, tv, scale, True, 16)
    dq, delta = tfa.flash_bwd_dq_reference(tq, tk, tv, tdo, to, lse, tdlse,
                                           scale, True, 16)
    # The reference's fold, on [BH, S, D] as _flash_bwd_bhsd holds them.
    ob, dob = (x.transpose(0, 2, 1, 3).reshape(b * h, s, d) for x in (o, do))
    want = np.sum(dob.astype(np.float32) * ob.astype(np.float32), axis=-1)
    if with_dlse:
        want = want - dlse.reshape(b * h, s)
    assert delta.shape == (b, h, sp) and delta.is_contiguous()
    got = delta.reshape(b * h, sp).numpy()
    # fp32 on both sides; only the order of the 16-term sums differs.
    np.testing.assert_allclose(got[:, :s], want, rtol=1e-6, atol=1e-6)
    if padded:
        assert not got[:, s:].any() and not dq[:, s:].any()
        dq_s, _ = tfa.flash_bwd_dq_reference(
            *(torch.from_numpy(x) for x in (q, k, v, do, o)), lse[..., :s],
            None if tdlse is None else tdlse[..., :s], scale, True, 16)
        torch.testing.assert_close(dq[:, :s], dq_s, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["fp32", "head_dim", "layout", "scale",
                                  "dlse_shape", "dlse_dtype", "delta_shape",
                                  "delta_dtype"])
def test_kernel_wrapper_raises_on_what_it_does_not_take(case):
    """The CUDA wrappers check dtype, head_dim, layout, scale and the row
    statistics (K5's dlse, K6's delta: contiguous fp32 [B, H, S]) before
    anything is built or launched, and raise: there is no fallback."""
    shape = (1, 16, 2, 64)
    q = torch.zeros(shape, dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 16))
    bad = lse[..., :8] if case.endswith("shape") else lse.double()
    scale, err = 0.125, ValueError
    if case.startswith("dlse"):
        def call():
            tfa.flash_bwd_dq_cuda(q, q, q, q, q, lse, bad, scale, True)
    elif case.startswith("delta"):
        def call():
            tfa.flash_bwd_dkv_cuda(q, q, q, q, lse, bad, scale, True)
    else:
        if case == "scale":
            # K4 and K6 fold the scale into the exponent after the row max.
            scale = -0.125
            with pytest.raises(err):
                tfa.flash_bwd_dkv_cuda(q, q, q, q, None, None, scale, True)
        elif case == "fp32":
            q, err = q.float(), TypeError
        elif case == "head_dim":
            q = torch.zeros((1, 16, 2, 32), dtype=torch.bfloat16)
        else:
            q = torch.zeros((1, 16, 64, 2),
                            dtype=torch.bfloat16).transpose(-1, -2)

        def call():
            tfa.flash_fwd_cuda(q, q, q, scale, True)
    with pytest.raises(err):
        call()
    assert tfa._lib is None  # nothing was built


def test_mixed_devices_raise():
    q = torch.zeros((1, 8, 1, 8))
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q.to("meta"), q)


@pytest.mark.parametrize("compiled", [False, True])
@pytest.mark.parametrize("uses_lse", [False, True])
def test_unused_lse_cotangent_reaches_k5_as_none(monkeypatch, uses_lse,
                                                 compiled):
    """The custom ops' backward gets no materialized zeros for an output
    the loss does not use: on GPT's path (out only) K5 receives dlse None,
    eagerly and in a graph ``torch.compile`` traces whole (``fullgraph``);
    a loss that uses lse hands K5 its cotangent.  The gradients equal
    dense attention's either way."""
    seen = []
    real = tfa._flash_bwd_dq_op

    def spy(q, k, v, dout, out, lse, dlse, *rest):
        seen.append(dlse is None)
        return real(q, k, v, dout, out, lse, dlse, *rest)

    monkeypatch.setattr(tfa, "_flash_bwd_dq_op", spy)

    def loss_of(attn):
        def loss(q, k, v):
            out, lse = attn(q, k, v, causal=True)
            total = (out * out).sum()
            return total + lse.sum() if uses_lse else total
        return loss

    fn = loss_of(tfa.flash_attention_with_lse)
    if compiled:
        torch._dynamo.reset()
        fn = torch.compile(fn, backend="aot_eager", fullgraph=True)
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _inputs((1, 32, 2, 16), 7))
    grads = torch.autograd.grad(fn(q, k, v), (q, k, v))
    qd, kd, vd = (x.detach().clone().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(
        loss_of(tfa.dense_attention_with_lse)(qd, kd, vd), (qd, kd, vd))
    assert seen and set(seen) == {not uses_lse}
    for got, ref in zip(grads, want):
        torch.testing.assert_close(got, ref, rtol=GRAD_TOL, atol=GRAD_TOL)
    if compiled:
        torch._dynamo.reset()
