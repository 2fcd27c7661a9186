"""Flash attention: hand-written Hopper kernels with a plain PyTorch twin.

Port of ``horovod_tpu/ops/flash_attention.py``.  The public functions keep
the JAX package's ``[batch, seq, heads, head_dim]`` layout and names:
``flash_attention``, ``flash_attention_with_lse`` (lse shaped
``[B, H, S]``), ``dense_attention`` and ``dense_attention_with_lse``.

Three kernels, in ``csrc/flash_attention.cu``, replace the three Pallas
kernels:

- K4 ``flash_fwd``      <- ``_mha_kernel`` (online-softmax forward, out + lse)
- K5 ``flash_bwd_dq``   <- ``_mha_bwd_dq_kernel``
- K6 ``flash_bwd_dkv``  <- ``_mha_bwd_dkv_kernel``

Dispatch is by where the tensors lie.  A CUDA tensor launches the kernel,
or raises if the kernel does not take its dtype (bf16 only), head_dim (64
or 128), layout (last dim contiguous, other strides multiples of 8
elements, 16-byte aligned: what TMA reads in place) or, for K4 and K6, its
scale (positive); nothing catches a failed build or launch.  K4 and K6 need
``sm_90a``: they load tiles by TMA and multiply on wgmma.  A CPU tensor
takes the plain version, which recomputes each tile's arithmetic as the
Pallas body does: online softmax over kv tiles for the forward, P rebuilt
from lse for the backward.  ``LAUNCHES`` counts kernel launches.

The differentiable core is a ``torch.autograd.Function`` returning
``(out, lse)``.  Its backward carries the ``dlse`` fold of the JAX custom
VJP: ``delta = rowsum(dO * O) - dlse``, computed in torch outside the
kernels, so a loss that uses lse (ring attention's merge) differentiates
through the same kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPE = torch.bfloat16

# Launches of each hand-written kernel: a wrapper adds one where it launches
# its kernel, and nowhere else.
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# The plain versions: [B, S, H, D] in, tile loops as the Pallas kernels run.
# ---------------------------------------------------------------------------

def _bhsd(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 1, 3).float()


def _causal_mask(q0: int, q1: int, k0: int, k1: int, device) -> torch.Tensor:
    """True where key position > query position (masked)."""
    qpos = torch.arange(q0, q1, device=device)[:, None]
    kpos = torch.arange(k0, k1, device=device)[None, :]
    return kpos > qpos


def flash_fwd_reference(q, k, v, sm_scale: float, causal: bool,
                        block_k: int = 128):
    """K4's arithmetic: the kv tiles stream past every query row while the
    running max ``m``, sum ``l`` and accumulator ``acc`` update online.
    Returns out ``[B, S, H, D]`` (q's dtype) and lse ``[B, H, S]`` fp32."""
    qb, kb, vb = _bhsd(q), _bhsd(k), _bhsd(v)
    b, h, s, d = qb.shape
    acc = torch.zeros_like(qb)
    m = torch.full((b, h, s, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, s, 1), device=q.device)
    for k0 in range(0, s, block_k):
        k1 = min(k0 + block_k, s)
        sc = qb @ kb[:, :, k0:k1].transpose(-1, -2) * sm_scale
        if causal:
            sc = sc.masked_fill(_causal_mask(0, s, k0, k1, q.device),
                                NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vb[:, :, k0:k1]
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    out = (acc / l).to(q.dtype).permute(0, 2, 1, 3)
    return out, (m + torch.log(l)).squeeze(-1)


def flash_bwd_dq_reference(q, k, v, dout, lse, delta, sm_scale: float,
                           causal: bool, block_k: int = 128):
    """K5's arithmetic: dQ accumulates ``dS K`` over kv tiles, with
    ``P = exp(S * scale - lse)`` and ``dS = P * (dP - delta) * scale``."""
    qb, kb, vb, dob = _bhsd(q), _bhsd(k), _bhsd(v), _bhsd(dout)
    s = qb.shape[2]
    lse_c, delta_c = lse.float()[..., None], delta.float()[..., None]
    dq = torch.zeros_like(qb)
    for k0 in range(0, s, block_k):
        k1 = min(k0 + block_k, s)
        kt, vt = kb[:, :, k0:k1], vb[:, :, k0:k1]
        sc = qb @ kt.transpose(-1, -2) * sm_scale
        if causal:
            sc = sc.masked_fill(_causal_mask(0, s, k0, k1, q.device),
                                NEG_INF)
        p = torch.exp(sc - lse_c)
        dp = dob @ vt.transpose(-1, -2)
        ds = p * (dp - delta_c) * sm_scale
        dq = dq + ds.to(k.dtype).float() @ kt
    return dq.to(q.dtype).permute(0, 2, 1, 3)


def flash_bwd_dkv_reference(q, k, v, dout, lse, delta, sm_scale: float,
                            causal: bool, block_q: int = 128):
    """K6's arithmetic: dK and dV accumulate ``dS^T Q`` and ``P^T dO`` over
    q tiles streaming past every key row."""
    qb, kb, vb, dob = _bhsd(q), _bhsd(k), _bhsd(v), _bhsd(dout)
    s = qb.shape[2]
    lse, delta = lse.float(), delta.float()
    dk = torch.zeros_like(kb)
    dv = torch.zeros_like(vb)
    for q0 in range(0, s, block_q):
        q1 = min(q0 + block_q, s)
        qt, dot = qb[:, :, q0:q1], dob[:, :, q0:q1]
        sc = qt @ kb.transpose(-1, -2) * sm_scale
        if causal:
            sc = sc.masked_fill(_causal_mask(q0, q1, 0, s, q.device),
                                NEG_INF)
        p = torch.exp(sc - lse[:, :, q0:q1, None])
        dv = dv + p.to(dout.dtype).float().transpose(-1, -2) @ dot
        dp = dot @ vb.transpose(-1, -2)
        ds = p * (dp - delta[:, :, q0:q1, None]) * sm_scale
        dk = dk + ds.to(q.dtype).float().transpose(-1, -2) @ qt
    return (dk.to(k.dtype).permute(0, 2, 1, 3),
            dv.to(v.dtype).permute(0, 2, 1, 3))


# ---------------------------------------------------------------------------
# The kernels' wrappers.
# ---------------------------------------------------------------------------

_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ._build import load

        lib = load("flash_attention")
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.hvd_flash_fwd.argtypes = [vp] * 6 + [i32] * 4 + [f32, i32, vp]
        lib.hvd_flash_bwd_dq.argtypes = [vp] * 8 + [i32] * 4 + [f32, i32, vp]
        lib.hvd_flash_bwd_dkv.argtypes = [vp] * 9 + [i32] * 4 + [f32, i32, vp]
        for fn in (lib.hvd_flash_fwd, lib.hvd_flash_bwd_dq,
                   lib.hvd_flash_bwd_dkv):
            fn.restype = i32
        lib.hvd_cuda_error_string.argtypes = [i32]
        lib.hvd_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _kernel_layout(x: torch.Tensor) -> bool:
    """Whether the kernels can read ``x`` in place with 16-byte loads."""
    return (x.stride(-1) == 1 and not any(st % 8 for st in x.stride()[:3])
            and x.data_ptr() % 16 == 0)


def _check_kernel_input(name: str, x: torch.Tensor, like: torch.Tensor):
    if x.dtype != KERNEL_DTYPE:
        raise TypeError(f"flash kernel takes bf16 {name}, got {x.dtype}")
    if x.dim() != 4 or x.shape != like.shape:
        raise ValueError(f"flash kernel: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(like.shape)} [B, S, H, D]")
    if x.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {x.shape[-1]}")
    if x.device != like.device:
        raise ValueError(f"flash kernel: {name} on {x.device}, "
                         f"expected {like.device}")
    if not _kernel_layout(x):
        raise ValueError(
            f"flash kernel: {name} has strides {x.stride()}; it takes a "
            "contiguous last dim, other strides a multiple of 8 elements "
            "and 16-byte alignment")


def _check_scale(sm_scale: float) -> None:
    # The kernels take the row max of the raw scores and fold the scale into
    # the exponent, which is right only for a positive scale.
    if not sm_scale > 0:
        raise ValueError(f"flash kernel takes a positive scale, got "
                         f"{sm_scale}")


def _strides(*tensors) -> ctypes.Array:
    vals = []
    for x in tensors:
        vals += [x.stride(0), x.stride(1), x.stride(2)]
    return (ctypes.c_longlong * 12)(*(vals + [0] * (12 - len(vals))))


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        msg = _kernels().hvd_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {rc} "
                           f"({msg})")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def flash_fwd_cuda(q, k, v, sm_scale: float, causal: bool):
    """K4 on the card: out ``[B, S, H, D]`` bf16, lse ``[B, H, S]`` fp32."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_kernel_input(name, x, q)
    _check_scale(sm_scale)
    b, s, h, d = q.shape
    lib = _kernels()
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v)
    rc = lib.hvd_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), lse.data_ptr(),
                           ctypes.addressof(strides), b, h, s, d,
                           float(sm_scale), int(causal), _stream())
    _check_rc(rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def _check_stats(lse, delta, q):
    b, s, h, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.dtype != torch.float32 or tuple(x.shape) != (b, h, s)
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"flash kernel takes {name} as contiguous fp32 "
                             f"[B, H, S] = {(b, h, s)} on {q.device}")


def flash_bwd_dq_cuda(q, k, v, dout, lse, delta, sm_scale: float,
                      causal: bool):
    """K5 on the card: dq ``[B, S, H, D]`` bf16."""
    for name, x in (("q", q), ("k", k), ("v", v), ("dout", dout)):
        _check_kernel_input(name, x, q)
    _check_stats(lse, delta, q)
    b, s, h, d = q.shape
    lib = _kernels()
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    strides = _strides(q, k, v, dout)
    rc = lib.hvd_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              dout.data_ptr(), lse.data_ptr(),
                              delta.data_ptr(), dq.data_ptr(),
                              ctypes.addressof(strides), b, h, s, d,
                              float(sm_scale), int(causal), _stream())
    _check_rc(rc, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, sm_scale: float,
                       causal: bool):
    """K6 on the card: dk, dv ``[B, S, H, D]`` bf16."""
    for name, x in (("q", q), ("k", k), ("v", v), ("dout", dout)):
        _check_kernel_input(name, x, q)
    _check_scale(sm_scale)
    _check_stats(lse, delta, q)
    b, s, h, d = q.shape
    lib = _kernels()
    dk = torch.empty((b, s, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, s, h, d), dtype=v.dtype, device=q.device)
    strides = _strides(q, k, v, dout)
    rc = lib.hvd_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               dout.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dk.data_ptr(),
                               dv.data_ptr(), ctypes.addressof(strides),
                               b, h, s, d, float(sm_scale), int(causal),
                               _stream())
    _check_rc(rc, "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


# ---------------------------------------------------------------------------
# Dispatch and autograd.
# ---------------------------------------------------------------------------

def _on_cuda(*tensors) -> bool:
    devices = {x.device.type for x in tensors}
    if devices == {"cuda"}:
        return True
    if devices == {"cpu"}:
        return False
    raise ValueError(f"flash attention inputs on {sorted(devices)}; "
                     "expected all on one CUDA device or all on the CPU")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal, block_q, block_k):
        if _on_cuda(q, k, v):
            out, lse = flash_fwd_cuda(q, k, v, sm_scale, causal)
        else:
            out, lse = flash_fwd_reference(q, k, v, sm_scale, causal,
                                           block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (sm_scale, causal, block_q, block_k)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        sm_scale, causal, block_q, block_k = ctx.args
        if dout is None:
            dout = torch.zeros_like(out)
        # delta = rowsum(dO * O), less the lse cotangent: the fold of
        # _flash_bhsd_lse_bwd, outside the kernels.
        delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1)
        if dlse is not None:
            delta = delta - dlse.float()
        delta = delta.contiguous()
        if _on_cuda(q, k, v, dout):
            if not _kernel_layout(dout):
                dout = dout.contiguous()  # the incoming gradient's layout
            dq = flash_bwd_dq_cuda(q, k, v, dout, lse, delta, sm_scale,
                                   causal)
            dk, dv = flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, sm_scale,
                                        causal)
        else:
            dq = flash_bwd_dq_reference(q, k, v, dout, lse, delta, sm_scale,
                                        causal, block_k)
            dk, dv = flash_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                             sm_scale, causal, block_q)
        return dq, dk, dv, None, None, None, None


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: Optional[float] = None,
                             block_q: int = 128, block_k: int = 128):
    """Attention over ``[B, S, H, D]`` returning ``(out, lse)``, lse shaped
    ``[B, H, S]`` fp32.  ``block_q``/``block_k`` tile the plain version
    (the CPU path); the kernels use their own tiles (csrc)."""
    s, d = q.shape[1], q.shape[-1]
    sm_scale = d ** -0.5 if scale is None else scale
    block_q, block_k = min(block_q, s), min(block_k, s)
    if causal and block_q != block_k:
        block_q = block_k = min(block_q, block_k)
    return _FlashAttention.apply(q, k, v, sm_scale, causal, block_q, block_k)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128):
    """Attention over ``[batch, seq, heads, head_dim]``."""
    out, _ = flash_attention_with_lse(q, k, v, causal, scale, block_q,
                                      block_k)
    return out


def dense_attention_with_lse(q, k, v, causal: bool = False,
                             scale: Optional[float] = None):
    """Dense attention (fp32 softmax) that also returns lse ``[B, H, S]``."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = q.shape[1]
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None]).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(v.dtype), lse


def dense_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None):
    """Reference-math dense attention over ``[B, S, H, D]``."""
    out, _ = dense_attention_with_lse(q, k, v, causal, scale)
    return out
