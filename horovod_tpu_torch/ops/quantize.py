"""Block-scaled wire codecs: hand-written Hopper kernels with plain twins.

Port of ``horovod_tpu/ops/quantize.py``, the device plane's mirror of the
host ring's codecs (``horovod_tpu/cpp/wire_codec.h``): the same block
geometry, scale rules and all-zero / non-finite-block handling, bit for bit.

- ``int8``: one fp32 scale per 256-element block, ``scale = max|x| / 127``.
- ``int4``: the same block scale over 7, codes packed two per byte.
- ``int8g``: one fp32 scale per 4096-element group (``max|group| / 127``)
  and one uint8 sub-scale per block, ``sub = min(255, rint(max|block| /
  max|group| * 256))``; the block's effective scale is ``gscale * sub/256``.
  The power-of-two denominator keeps ``eff`` bit-stable however a decoder
  associates the product, which cross-rank bit-identity relies on.

A flat fp32 tensor is viewed as ``[nblocks, WIRE_BLOCK]``, its last block
zero-padded (zeros cannot raise ``max|x|``).  ``quantize`` returns codes and
scales: for int8 and int4 one fp32 per block, for int8g a ``(sub,
group_scale)`` pair.  That payload is what the rings of
``ops/collectives.py`` move between ranks.

Three kernels, in ``csrc/quantize.cu``, replace the three Pallas kernels:

- K1 ``quant_int8``  <- ``_quant_kernel``       (int8 and int8g codes)
- K2 ``quant_int4``  <- ``_quant_kernel_int4``  (here with the pack fused)
- K3 ``dequant``     <- ``_dequant_kernel``     (every codec)

The per-block max, the scales and their reciprocals stay in torch outside
the kernels, as in the reference.  Every divide there takes a tensor
divisor: PyTorch's CUDA division by a Python scalar multiplies by its
reciprocal, which is not correctly rounded.  Dispatch is by where the
tensor lies: a CUDA tensor launches the kernel or raises (layout, dtype,
device); a CPU tensor takes the plain version; nothing catches a failed
build or launch.  ``LAUNCHES`` counts kernel launches.

Byte accounting: every quantized collective calls :func:`note_device_bytes`
with its raw and encoded wire bytes.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Callable, Optional, Tuple

import torch

from ..utils.env import DEVICE_WIRE_COMPRESSION_CODECS

# --- Block geometry and codec ids: mirror cpp/wire_codec.h ---------------
WIRE_BLOCK = 256           # kWireBlock: elements per scale record
WIRE_SCALE_BYTES = 4       # kWireScaleBytes: little-endian fp32 scale
WIRE_GROUP = 4096          # kWireGroup: elements per int8g group scale
WIRE_INT4_MAX = 7          # kWireInt4Max: int4 code clamp bound
WIRE_SUB_DENOM = 256       # kWireSubDenom: int8g sub-scale denominator (2^8)
WIRE_CODEC_IDS = {"none": 0, "bf16": 1, "int8": 2, "int4": 3, "int8g": 4}
# Codecs the device plane implements (the reference module's name for
# utils.env's list); bf16 stays a host-ring codec.
DEVICE_WIRE_CODECS = DEVICE_WIRE_COMPRESSION_CODECS

_BLOCKS_PER_GROUP = WIRE_GROUP // WIRE_BLOCK   # int8g sub-scales per group

# Launches of each hand-written kernel: a wrapper adds one where it launches
# its kernel, and nowhere else.
LAUNCHES = {"quant_int8": 0, "quant_int4": 0, "dequant": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def encoded_nbytes(count: int, codec: str = "int8") -> int:
    """Wire bytes for ``count`` fp32 elements under ``codec`` (the formula
    of WireEncodedBytes)."""
    count = int(count)
    blocks = -(-count // WIRE_BLOCK)
    if codec == "none":
        return 4 * count
    if codec == "bf16":
        return 2 * count
    if codec == "int4":
        return blocks * WIRE_SCALE_BYTES + (count + 1) // 2
    if codec == "int8g":
        groups = -(-count // WIRE_GROUP)
        return groups * WIRE_SCALE_BYTES + blocks + count
    return blocks * WIRE_SCALE_BYTES + count


def torus_factors(world: int) -> Optional[Tuple[int, int]]:
    """Near-square factorization ``(a, b)`` of ``world``, ``2 <= a <= b``
    with ``a`` maximal (a = major axis, b = minor axis); None when ``world``
    is prime or < 4 (the torus schedule then demotes)."""
    world = int(world)
    if world < 4:
        return None
    a = int(math.isqrt(world))
    while a >= 2:
        if world % a == 0:
            return (a, world // a)
        a -= 1
    return None


def ring_bytes(count: int, world: int, codec: str = "int8",
               schedule: str = "ring") -> Tuple[int, int]:
    """Per-rank (raw, encoded) wire bytes of one quantized allreduce of
    ``count`` fp32 elements over ``world`` ranks under ``schedule``: ring
    and bidi take 2(world-1) hops of ceil(count/world) elements (bidi in
    two halves); torus a x b takes 2(b-1) hops of ceil(count/b) and 2(a-1)
    of ceil(ceil(count/b)/a)."""
    world = max(1, int(world))
    count = int(count)
    if world == 1:
        return (0, 0)
    if schedule == "torus":
        f = torus_factors(world)
        if f is not None:
            a, b = f
            c1 = -(-count // b)
            c2 = -(-c1 // a)
            h1 = 2 * (b - 1)
            h2 = 2 * (a - 1)
            return (4 * (h1 * c1 + h2 * c2),
                    h1 * encoded_nbytes(c1, codec) +
                    h2 * encoded_nbytes(c2, codec))
        schedule = "bidi"          # prime/small world: torus -> bidi
    chunk = -(-count // world)
    hops = 2 * (world - 1)
    if schedule == "bidi" and chunk >= 2:
        front = chunk // 2
        back = chunk - front
        return (hops * chunk * 4,
                hops * (encoded_nbytes(front, codec) +
                        encoded_nbytes(back, codec)))
    return (hops * chunk * 4, hops * encoded_nbytes(chunk, codec))


def ring_error_bound(codec: str, world: int, max_abs: float,
                     schedule: str = "ring") -> float:
    """Bound on the error of one quantized ring Sum over ``world`` ranks
    whose inputs are at most ``max_abs`` in magnitude, under a resolved
    ``schedule``.  Each encode of a partial of k inputs adds at most half
    its block's scale, max|block| / qmax, where max|block| <= k * max_abs
    plus the error the partial carries; int8g's sub-scale rounding adds
    max|group| / 512 an encode, as a qmax of 84 does.  A torus reduces
    along its minor axis, then along its major axis over the minor sums;
    the gathered sum is encoded once more."""
    qm = {"int8": 127.0, "int4": 7.0, "int8g": 84.0}[codec]

    def chain(e_in, n, unit):
        # n partials of at most `unit` each, each carrying e_in.
        e = e_in
        for k in range(1, n):
            e += (k * unit + e) / (2 * qm) + e_in
        return e

    a, b = 1, int(world)
    if schedule == "torus" and torus_factors(world) is not None:
        a, b = torus_factors(world)
    total = chain(chain(0.0, b, max_abs), a, b * max_abs)
    return total + (world * max_abs + total) / (2 * qm)


# --- Device-plane byte counters ------------------------------------------

_DEV_LOCK = threading.Lock()
_DEV_BYTES = [0, 0]   # raw, encoded
_NATIVE_SINK: Optional[Callable[[int, int], None]] = None


def set_native_byte_sink(fn: Optional[Callable[[int, int], None]]) -> None:
    """Forward every (raw, encoded) delta to ``fn`` as well: the native
    core's ``hvd_device_plane_note``, so the device plane's bytes reach its
    metrics registry (``hvd.metrics()``, Prometheus).  None stops it."""
    global _NATIVE_SINK
    _NATIVE_SINK = fn


def note_device_bytes(raw: int, encoded: int) -> None:
    with _DEV_LOCK:
        _DEV_BYTES[0] += int(raw)
        _DEV_BYTES[1] += int(encoded)
    sink = _NATIVE_SINK
    if sink is not None:
        sink(int(raw), int(encoded))


def device_byte_counters() -> Tuple[int, int]:
    with _DEV_LOCK:
        return (_DEV_BYTES[0], _DEV_BYTES[1])


def reset_device_byte_counters() -> None:
    with _DEV_LOCK:
        _DEV_BYTES[0] = _DEV_BYTES[1] = 0


# --- Scale derivation (plain torch on every device, as in the reference) --

def _div(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b``, correctly rounded on every device: a Python scalar divisor
    becomes a tensor first (see the module docstring)."""
    if not isinstance(b, torch.Tensor):
        b = torch.full((), float(b), dtype=a.dtype, device=a.device)
    return a / b


def _nan_free_absmax(xb: torch.Tensor) -> torch.Tensor:
    """Per-row max|x| with NaN excluded ([nb, 1]); torch.amax propagates
    NaN, the C++ scan (``a > maxabs``) never lets it win."""
    absx = xb.abs()
    return torch.where(torch.isnan(absx), 0.0, absx).amax(dim=1, keepdim=True)


def _block_scales(xb: torch.Tensor, qmax: float = 127.0):
    """Per-block (scale, inv) of WireEncode(kInt8/kInt4): ``inv`` is 0
    exactly for all-zero and non-finite blocks (a block whose max is inf
    keeps scale inf, so decode flags it as NaN)."""
    scale = _div(_nan_free_absmax(xb), qmax)
    ok = (scale > 0.0) & torch.isfinite(scale)
    inv = torch.where(ok, _div(torch.ones_like(scale),
                               torch.where(ok, scale, 1.0)), 0.0)
    return scale, inv


def _group_scales(xb: torch.Tensor):
    """Two-level (int8g) scales of WireEncode(kInt8g): returns (sub [nb, 1]
    uint8, gscale [ng, 1] fp32, inv [nb, 1] fp32) where ``inv`` is 1/eff
    for ok blocks and 0 otherwise."""
    nb = xb.shape[0]
    ng = -(-nb // _BLOCKS_PER_GROUP)
    bmax = _nan_free_absmax(xb)
    bmax_p = torch.nn.functional.pad(bmax, (0, 0, 0,
                                            ng * _BLOCKS_PER_GROUP - nb))
    gmax = bmax_p.reshape(ng, _BLOCKS_PER_GROUP).amax(dim=1, keepdim=True)
    gscale = _div(gmax, 127.0)
    gok = (gscale > 0.0) & torch.isfinite(gscale)

    def rep(a):
        return torch.repeat_interleave(a, _BLOCKS_PER_GROUP, dim=0)[:nb]

    gmax_b, gok_b, gscale_b = rep(gmax), rep(gok), rep(gscale)
    ratio = _div(bmax, torch.where(gok_b, gmax_b, 1.0))
    sub_f = torch.where(
        gok_b,
        torch.clamp_max(torch.round(ratio * float(WIRE_SUB_DENOM)), 255.0),
        0.0)
    eff = gscale_b * _div(sub_f, float(WIRE_SUB_DENOM))
    ok = gok_b & (sub_f > 0.0)
    inv = torch.where(ok, _div(torch.ones_like(eff),
                               torch.where(ok, eff, 1.0)), 0.0)
    return sub_f.to(torch.uint8), gscale, inv


def _effective_scales(sub: torch.Tensor, gscale: torch.Tensor,
                      nblocks: int) -> torch.Tensor:
    """Per-block fp32 scale ``gscale * (sub/256)`` from int8g's (sub,
    group) scales, bit-identical to the encoder's ``eff``."""
    gs_b = torch.repeat_interleave(gscale.float(), _BLOCKS_PER_GROUP,
                                   dim=0)[:nblocks]
    return gs_b * _div(sub.float(), float(WIRE_SUB_DENOM))


# --- The plain versions of the kernels -----------------------------------

def _round_clamp(xb: torch.Tensor, inv: torch.Tensor,
                 qmax: float) -> torch.Tensor:
    """The arithmetic K1 and K2 share: round half to even, clamp in
    std::min/max operand order (NaN -> +qmax), zero where ``inv == 0``."""
    v = torch.round(xb * inv)
    v = torch.where(v < qmax, v, qmax)
    v = torch.where(v > -qmax, v, -qmax)
    return torch.where(inv > 0.0, v, 0.0).to(torch.int8)


def _pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """[nb, 256] int8 codes in [-7, 7] -> [nb, 128] packed bytes: element
    2i in the low nibble, 2i+1 in the high one, unsigned mod-256."""
    u = codes.contiguous().view(torch.uint8)
    lo = u[:, 0::2] & 0x0F
    hi = u[:, 1::2] & 0x0F
    return (lo | (hi << 4)).view(torch.int8)


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack_int4`, sign-extending each nibble with
    ``(nib ^ 8) - 8``."""
    b = packed.contiguous().view(torch.uint8).to(torch.int32)
    lo = ((b & 0x0F) ^ 8) - 8
    hi = (((b >> 4) & 0x0F) ^ 8) - 8
    nb = packed.shape[0]
    return torch.stack([lo, hi], dim=-1).reshape(nb, WIRE_BLOCK).to(
        torch.int8)


def quant_int8_reference(xb: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """K1's plain version: int8 codes [nb, 256]."""
    return _round_clamp(xb, inv, 127.0)


def quant_int4_reference(xb: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """K2's plain version: packed int4 codes [nb, 128]."""
    return _pack_int4(_round_clamp(xb, inv, float(WIRE_INT4_MAX)))


def dequant_reference(qb: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """K3's plain version: fp32 ``scale * code``."""
    return scales.float() * qb.float()


# --- The kernels' wrappers -----------------------------------------------

_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ._build import load

        lib = load("quantize")
        vp = ctypes.c_void_p
        for fn in (lib.hvd_quant_int8, lib.hvd_quant_int4, lib.hvd_dequant):
            fn.argtypes = [vp, vp, vp, ctypes.c_longlong, vp]
            fn.restype = ctypes.c_int
        lib.hvd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hvd_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_rows(name: str, x: torch.Tensor, dtype: torch.dtype, width: int,
                align: int) -> None:
    if x.dtype != dtype:
        raise TypeError(f"codec kernel takes {dtype} {name}, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != width or x.shape[0] < 1:
        raise ValueError(f"codec kernel takes {name} as [nblocks >= 1, "
                         f"{width}], got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % align:
        raise ValueError(f"codec kernel takes a contiguous {name} aligned "
                         f"to {align} bytes")


def _check_scales(name: str, s: torch.Tensor, like: torch.Tensor) -> None:
    if s.dtype != torch.float32 or s.shape != (like.shape[0], 1) \
            or not s.is_contiguous():
        raise ValueError(f"codec kernel takes {name} as contiguous fp32 "
                         f"[{like.shape[0]}, 1], got {s.dtype} "
                         f"{tuple(s.shape)}")
    if s.device != like.device:
        raise ValueError(f"codec kernel: {name} on {s.device}, expected "
                         f"{like.device}")


def _launch(fn_name: str, a: torch.Tensor, s: torch.Tensor,
            out: torch.Tensor) -> torch.Tensor:
    lib = _kernels()
    rc = getattr(lib, f"hvd_{fn_name}")(
        a.data_ptr(), s.data_ptr(), out.data_ptr(), a.shape[0],
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        msg = lib.hvd_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn_name} failed to launch: CUDA error {rc} "
                           f"({msg})")
    LAUNCHES[fn_name] += 1
    return out


def quant_int8_cuda(xb: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """K1 on the card: int8 codes [nb, 256] of fp32 [nb, 256] rows."""
    _check_rows("x", xb, torch.float32, WIRE_BLOCK, 16)
    _check_scales("inv", inv, xb)
    out = torch.empty(xb.shape, dtype=torch.int8, device=xb.device)
    return _launch("quant_int8", xb, inv, out)


def quant_int4_cuda(xb: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """K2 on the card: packed int4 codes [nb, 128] of fp32 [nb, 256] rows."""
    _check_rows("x", xb, torch.float32, WIRE_BLOCK, 16)
    _check_scales("inv", inv, xb)
    out = torch.empty((xb.shape[0], WIRE_BLOCK // 2), dtype=torch.int8,
                      device=xb.device)
    return _launch("quant_int4", xb, inv, out)


def dequant_cuda(qb: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """K3 on the card: fp32 [nb, 256] of int8 codes and fp32 scales."""
    _check_rows("codes", qb, torch.int8, WIRE_BLOCK, 4)
    _check_scales("scales", scales, qb)
    out = torch.empty(qb.shape, dtype=torch.float32, device=qb.device)
    return _launch("dequant", qb, scales, out)


def _on_cuda(*tensors: torch.Tensor) -> bool:
    devices = {x.device.type for x in tensors}
    if devices == {"cuda"}:
        return True
    if devices == {"cpu"}:
        return False
    raise ValueError(f"codec inputs on {sorted(devices)}; expected all on "
                     "one CUDA device or all on the CPU")


def _quant_int8(xb, inv):
    if _on_cuda(xb, inv):
        return quant_int8_cuda(xb, inv)
    return quant_int8_reference(xb, inv)


def _quant_int4(xb, inv):
    if _on_cuda(xb, inv):
        return quant_int4_cuda(xb, inv)
    return quant_int4_reference(xb, inv)


# --- Public API ----------------------------------------------------------

def quantize_blocks(xb: torch.Tensor):
    """[nblocks, WIRE_BLOCK] fp32 -> (int8 codes, fp32 [nblocks, 1] scales)."""
    scale, inv = _block_scales(xb)
    return _quant_int8(xb, inv), scale


def dequantize_blocks(qb: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 codes [nblocks, WIRE_BLOCK] and fp32 [nblocks, 1] scales -> fp32
    [nblocks, WIRE_BLOCK]."""
    if _on_cuda(qb, scales):
        return dequant_cuda(qb, scales)
    return dequant_reference(qb, scales)


def _to_blocks(flat: torch.Tensor) -> torch.Tensor:
    """Flat fp32 [n] -> contiguous [nblocks, WIRE_BLOCK], the last block
    zero-padded; a copy unless ``flat`` already is such a buffer."""
    n = flat.shape[0]
    nblocks = max(1, -(-n // WIRE_BLOCK))
    if (n == nblocks * WIRE_BLOCK and flat.dtype == torch.float32
            and flat.is_contiguous() and flat.data_ptr() % 16 == 0):
        return flat.view(nblocks, WIRE_BLOCK)
    xb = torch.zeros(nblocks * WIRE_BLOCK, dtype=torch.float32,
                     device=flat.device)
    xb[:n] = flat
    return xb.view(nblocks, WIRE_BLOCK)


def quantize(flat: torch.Tensor, codec: str = "int8"):
    """Flat fp32 [n] -> (codes, scales) under ``codec``:

    - ``int8``: codes [nblocks, WIRE_BLOCK] int8, scales [nblocks, 1] fp32.
    - ``int4``: codes [nblocks, WIRE_BLOCK/2] int8 (packed nibbles),
      scales [nblocks, 1] fp32.
    - ``int8g``: codes [nblocks, WIRE_BLOCK] int8, scales = (sub
      [nblocks, 1] uint8, group [ngroups, 1] fp32).
    """
    xb = _to_blocks(flat)
    if codec == "int4":
        scale, inv = _block_scales(xb, float(WIRE_INT4_MAX))
        return _quant_int4(xb, inv), scale
    if codec == "int8g":
        sub, gscale, inv = _group_scales(xb)
        return _quant_int8(xb, inv), (sub, gscale)
    return quantize_blocks(xb)


def dequantize(qb: torch.Tensor, scales, count: int,
               codec: str = "int8") -> torch.Tensor:
    """Inverse of :func:`quantize`: back to flat fp32 [count]."""
    if codec == "int4":
        qb = _unpack_int4(qb)
    elif codec == "int8g":
        sub, gscale = scales
        scales = _effective_scales(sub, gscale, qb.shape[0])
    return dequantize_blocks(qb, scales).reshape(-1)[:count]


def fake_quantize(x: torch.Tensor, codec: str = "int8") -> torch.Tensor:
    """dequantize(quantize(x)) with x's shape: the local quantization image
    error feedback subtracts (residual = x - fake_quantize(x))."""
    flat = x.reshape(-1)
    qb, s = quantize(flat, codec)
    return dequantize(qb, s, flat.shape[0], codec).reshape(x.shape)
