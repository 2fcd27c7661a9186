"""Block-scaled (quantized) collectives on device tensors.

Port of the quantized half of ``horovod_tpu/ops/collectives.py``: where the
JAX package lowers the quantized ring to ``lax.ppermute`` hops inside
``jit``, this module moves block-scaled encodings (``ops/quantize.py``)
between the ranks of a ``torch.distributed`` group: ``lax.ppermute``
becomes a ring exchange through ``dist.batch_isend_irecv`` and
``lax.axis_index`` the rank's position in the group.  Every reduce-scatter
hop re-encodes its running fp32 partial and accumulates in fp32; the gather
phase forwards the owner's encoding verbatim, so every rank decodes
identical bytes and the result is bit-identical across ranks.  Tensors stay
where they are, except that gloo takes host tensors only: under
``HOROVOD_GPU_OPERATIONS=GLOO`` a card's tensors are staged through host
memory for each transfer, and the kernels still run on the card.

``quantized_alltoall`` and ``quantized_reducescatter`` (the MoE dispatch
and a ZeRO-style gradient scatter) encode once per destination chunk and
once per reduce-scatter hop respectively.

Two callers run these rings.  The device plane (``ops/device_plane.py``)
runs ``_quantized_ring_allreduce_sum`` on a negotiated fused bucket under
``HOROVOD_WIRE_COMPRESSION=device=<codec>``, on the executor's thread and
the process set's group.  The public ``quantized_*`` functions and the
optimizer's error feedback run on the caller's thread, in issue order, on a
process group of their own (``basics.caller_group()``), so the two threads'
collectives can never interleave differently on two ranks.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import basics
from ..utils.env import (get_device_schedule, get_wire_compression_min_bytes,
                         get_wire_compression_planes)
from ..wire import ReduceOp
from . import quantize as qz


class GroupRing:
    """A rank's place in a process group and its ring exchange: send a list
    of tensors to one position of the group and receive tensors of the same
    shapes from another, all in one ``batch_isend_irecv`` (either side may
    be None: a one-sided transfer).  ``rank`` and ``size`` are the position
    in and the size of the group; ``wire`` is the device the group's
    backend takes tensors on."""

    def __init__(self, group, ranks: Sequence[int], me: int,
                 wire: torch.device):
        self.group = group
        self.ranks = [int(r) for r in ranks]
        self.rank = self.ranks.index(int(me))
        self.size = len(self.ranks)
        self.wire = wire

    def exchange(self, tensors: Sequence[torch.Tensor], dst: Optional[int],
                 src: Optional[int]) -> List[Optional[torch.Tensor]]:
        """The tensors received from ``src``, each on its sent tensor's
        device (None each when ``src`` is None)."""
        ops = [] if dst is None else [
            dist.P2POp(dist.isend, t.to(self.wire).contiguous(),
                       self.ranks[dst], self.group) for t in tensors]
        recvs = [] if src is None else [
            torch.empty(t.shape, dtype=t.dtype, device=self.wire)
            for t in tensors]
        ops += [dist.P2POp(dist.irecv, r, self.ranks[src], self.group)
                for r in recvs]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if src is None:
            return [None] * len(tensors)
        return [r.to(t.device) for r, t in zip(recvs, tensors)]


def _caller_ring() -> GroupRing:
    """The world's ring on the caller's thread (``basics.caller_group``)."""
    return GroupRing(basics.caller_group(), range(basics.size()),
                     basics.rank(), basics.wire_device())


# --- Quantized (block-scaled) collectives ---------------------------------

def _device_codec_defaults() -> Tuple[str, int]:
    """(device codec, min_bytes): read once by ``hvd.init()``, from the
    environment before it."""
    if basics.is_initialized():
        cfg = basics._get().cfg
        return cfg.wire_compression_device, cfg.wire_compression_min_bytes
    return (get_wire_compression_planes()[1],
            get_wire_compression_min_bytes())


def _device_schedule_default() -> str:
    """The configured ring schedule, unresolved: read once by
    ``hvd.init()``, from the environment before it."""
    if basics.is_initialized():
        return basics._get().cfg.device_schedule
    return get_device_schedule()


def _codec_enabled(codec: str) -> bool:
    return codec != "none" and codec in qz.DEVICE_WIRE_CODECS


def _resolve_explicit_codec(codec: Optional[str]) -> str:
    """Codec of a direct quantized_* call: the configured device codec, or
    int8 when it is none (an explicit call asks for quantization)."""
    if codec is None:
        codec = _device_codec_defaults()[0]
    return codec if _codec_enabled(codec) else "int8"


def resolve_device_schedule(world: int, schedule: Optional[str] = None) -> str:
    """A concrete {ring, bidi, torus} for ``world`` ranks; ``None`` takes
    the configured HOROVOD_DEVICE_SCHEDULE.  ``torus`` demotes to ``bidi``
    when ``world`` has no 2-D factorization; ``auto`` takes torus when the
    factorization's major axis is at least 4, bidi for 4+ ranks, ring
    otherwise."""
    if schedule is None:
        schedule = _device_schedule_default()
    s = (schedule or "auto").lower()
    f = qz.torus_factors(world)
    if s == "torus" and f is None:
        s = "bidi"
    if s == "auto":
        if f is not None and f[0] >= 4:
            s = "torus"
        elif world >= 4:
            s = "bidi"
        else:
            s = "ring"
    if s not in ("ring", "bidi", "torus"):
        s = "ring"
    return s


def quantized_collective_eligible(x: torch.Tensor, world: int, min_bytes: int,
                                  divisor: int = 1) -> bool:
    """The demotion rule every quantized collective and the optimizer's
    error feedback share: fp32 only, at least ``min_bytes`` of payload, and
    a ring to run on (world > 1).  ``divisor`` adds the leading-dim
    divisibility of reducescatter and alltoall."""
    if divisor > 1 and (x.dim() == 0 or x.shape[0] % divisor):
        return False
    return (world > 1 and x.dtype == torch.float32
            and x.numel() * 4 >= int(min_bytes))


def _flatten(payload) -> List[torch.Tensor]:
    """The tensors of a (codes, scales) payload, int8g's (sub, group)
    scales included, in order."""
    if isinstance(payload, tuple):
        return [leaf for part in payload for leaf in _flatten(part)]
    return [payload]


def _unflatten(like, leaves):
    """A payload shaped as ``like`` from an iterator over its tensors."""
    if isinstance(like, tuple):
        return tuple(_unflatten(part, leaves) for part in like)
    return next(leaves)


def _permutation(n: int, fn) -> Tuple[List[int], List[int]]:
    """(dst, src) of the ring pattern ``g -> fn(g)``: rank g sends to
    dst[g] and receives from src[g]."""
    dst = [fn(g) for g in range(n)]
    src = [0] * n
    for g, d in enumerate(dst):
        src[d] = g
    return dst, src


def _exchange(ring, payload, perm):
    dst, src = perm
    got = ring.exchange(_flatten(payload), dst[ring.rank], src[ring.rank])
    return _unflatten(payload, iter(got))


def _ring_reduce_scatter(ring, chunks: torch.Tensor, size: int, pos: int,
                         off: int, d: int, perm, codec: str) -> torch.Tensor:
    """Quantized reduce-scatter over one logical ring of ``size`` positions.

    ``chunks`` is [size, c] fp32; the rank at position p starts the partial
    of row (p + off) % size and adds row (p + off - d*t) % size at hop t;
    after size-1 hops the fully summed row (p + off + d) % size lands on it.
    Each hop encodes the running partial, moves codes and scales, and
    accumulates the decoded partial in fp32 against the receiver's own
    row: quantized values are never added together."""
    c = chunks.shape[1]
    acc = chunks[(pos + off) % size]
    for t in range(size - 1):
        payload = _exchange(ring, qz.quantize(acc, codec), perm)
        own = chunks[(pos + off - d * (t + 1)) % size]
        acc = qz.dequantize(payload[0], payload[1], c, codec) + own
    return acc


def _ring_all_gather(ring, payload, size: int, pos: int, owned_off: int,
                     d: int, perm, chunk: int, codec: str) -> torch.Tensor:
    """Gather phase: the position-p rank owns row (p + owned_off) % size,
    already encoded in ``payload``; encodings are forwarded verbatim around
    the ring and every rank decodes each one.  Returns [size, chunk]."""
    out = torch.empty((size, chunk), dtype=torch.float32,
                      device=payload[0].device)
    cur = payload
    for t in range(size):
        out[(pos - d * t + owned_off) % size] = qz.dequantize(
            cur[0], cur[1], chunk, codec)
        if t < size - 1:
            cur = _exchange(ring, cur, perm)
    return out


def _ring_all_gather_payload(ring, payload, size: int, pos: int,
                             owned_off: int, d: int, perm):
    """Gather encodings without decoding: every tensor of the payload gains
    a leading ``size`` dim whose slot s holds the encoding of ring row s.
    The torus forwards its stage-2 encodings through stage 1 this way."""
    leaves = _flatten(payload)
    out = [torch.empty((size,) + tuple(x.shape), dtype=x.dtype,
                       device=x.device) for x in leaves]
    cur = payload
    for t in range(size):
        slot = (pos - d * t + owned_off) % size
        for o, x in zip(out, _flatten(cur)):
            o[slot] = x
        if t < size - 1:
            cur = _exchange(ring, cur, perm)
    return _unflatten(payload, iter(out))


def _index_payload(payload, *idx):
    return _unflatten(payload, iter(x[idx] for x in _flatten(payload)))


def _chunked(flat: torch.Tensor, n: int) -> torch.Tensor:
    """``flat`` zero-padded to a multiple of ``n``, as [n, ceil(len/n)]."""
    chunk = -(-flat.shape[0] // n)
    pad = n * chunk - flat.shape[0]
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(n, chunk)


def _ring_allreduce_sum(ring, flat: torch.Tensor, codec: str) -> torch.Tensor:
    """Unidirectional ring: reduce-scatter then all-gather, world-1 hops
    each, one chunk of ceil(len/world) per hop."""
    n, length = ring.size, flat.shape[0]
    chunks = _chunked(flat, n)
    perm = _permutation(n, lambda i: (i + 1) % n)
    acc = _ring_reduce_scatter(ring, chunks, n, ring.rank, 0, +1, perm, codec)
    out = _ring_all_gather(ring, qz.quantize(acc, codec), n, ring.rank, +1,
                           +1, perm, chunks.shape[1], codec)
    return out.reshape(-1)[:length]


def _bidi_ring_allreduce_sum(ring, flat: torch.Tensor,
                             codec: str) -> torch.Tensor:
    """Bidirectional ring: each chunk's front half rides the forward ring
    and its back half the backward ring.  The two rings run one after the
    other here; their arithmetic, and so the result, is the reference's."""
    n, length = ring.size, flat.shape[0]
    chunks = _chunked(flat, n)
    chunk = chunks.shape[1]
    front = chunk // 2
    me = ring.rank
    perm_f = _permutation(n, lambda i: (i + 1) % n)
    perm_b = _permutation(n, lambda i: (i - 1) % n)
    acc_f = _ring_reduce_scatter(ring, chunks[:, :front], n, me, 0, +1,
                                 perm_f, codec)
    acc_b = _ring_reduce_scatter(ring, chunks[:, front:], n, me, 0, -1,
                                 perm_b, codec)
    pf = qz.quantize(acc_f, codec)
    pb = qz.quantize(acc_b, codec)
    out_f = _ring_all_gather(ring, pf, n, me, +1, +1, perm_f, front, codec)
    out_b = _ring_all_gather(ring, pb, n, me, -1, -1, perm_b, chunk - front,
                             codec)
    return torch.cat([out_f, out_b], dim=1).reshape(-1)[:length]


def _torus_allreduce_sum(ring, flat: torch.Tensor, a: int, b: int,
                         codec: str) -> torch.Tensor:
    """2-D torus over an a x b logical mesh (rank = i*b + j): reduce-scatter
    along the minor axis (rings of b), then the major axis (rings of a);
    the globally summed sub-chunk is encoded once and both gather phases
    forward that encoding verbatim, so every rank decodes identical bytes.
    The row and column rings are exchanges between global ranks."""
    n, length, me = a * b, flat.shape[0], ring.rank
    row_pos, col_pos = me % b, me // b
    rows = _chunked(flat, b)
    c1 = rows.shape[1]
    perm_row = _permutation(n, lambda g: (g // b) * b + ((g % b) + 1) % b)
    perm_col = _permutation(n, lambda g: ((g // b + 1) % a) * b + (g % b))
    # Stage 1: rank (i, j) ends with minor chunk (j+1) % b summed over its
    # major row.  Stage 2: then with sub-chunk (i+1) % a of it, summed over
    # every rank.
    acc1 = _ring_reduce_scatter(ring, rows, b, row_pos, 0, +1, perm_row,
                                codec)
    sub_rows = _chunked(acc1, a)
    c2 = sub_rows.shape[1]
    acc2 = _ring_reduce_scatter(ring, sub_rows, a, col_pos, 0, +1, perm_col,
                                codec)
    stacked2 = _ring_all_gather_payload(ring, qz.quantize(acc2, codec), a,
                                        col_pos, +1, +1, perm_col)
    stacked1 = _ring_all_gather_payload(ring, stacked2, b, row_pos, +1, +1,
                                        perm_row)
    # stacked1's slot (m, s) is the encoding of sub-chunk s of minor chunk m.
    pieces = [qz.dequantize(*_index_payload(stacked1, m, s), c2, codec)
              for m in range(b) for s in range(a)]
    out = torch.stack(pieces).reshape(b, a * c2)[:, :c1]
    return out.reshape(-1)[:length]


def _quantized_ring_allreduce_sum(ring, flat: torch.Tensor, codec: str,
                                  schedule: str) -> torch.Tensor:
    """Block-scaled sum of a flat fp32 vector over the ring's ranks under
    ``schedule``, demoting as the reference does: torus to bidi without a
    2-D factorization, bidi to ring when chunks are too short to split
    (``quantize.ring_bytes`` mirrors both)."""
    if schedule == "torus":
        f = qz.torus_factors(ring.size)
        if f is not None:
            return _torus_allreduce_sum(ring, flat, f[0], f[1], codec)
        schedule = "bidi"
    if schedule == "bidi" and -(-flat.shape[0] // ring.size) >= 2:
        return _bidi_ring_allreduce_sum(ring, flat, codec)
    return _ring_allreduce_sum(ring, flat, codec)


def quantized_allreduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                        min_bytes: Optional[int] = None,
                        codec: Optional[str] = None,
                        schedule: Optional[str] = None) -> torch.Tensor:
    """Allreduce through the block-scaled ring when ``tensor`` is eligible,
    returning a new tensor; otherwise the plain allreduce, bit-identically.

    ``min_bytes=None`` takes the configured
    HOROVOD_WIRE_COMPRESSION_MIN_BYTES; ``codec=None`` the configured
    device codec (int8 when it is none); ``schedule=None`` the configured
    HOROVOD_DEVICE_SCHEDULE, 'auto' resolved from the world size.  Average
    divides the sum by the world size, as the reference does."""
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            f"quantized_allreduce supports Sum and Average, got {op}")
    if min_bytes is None:
        min_bytes = _device_codec_defaults()[1]
    world = basics.size()
    ring = _caller_ring()
    if not quantized_collective_eligible(tensor, world, min_bytes):
        from .device_plane import plain_allreduce

        return plain_allreduce(tensor.reshape(-1).clone(), op,
                               ring).reshape(tensor.shape)
    codec = _resolve_explicit_codec(codec)
    sched = resolve_device_schedule(world, schedule)
    out = _quantized_ring_allreduce_sum(ring, tensor.reshape(-1), codec,
                                        sched)
    qz.note_device_bytes(*qz.ring_bytes(tensor.numel(), world, codec, sched))
    if op == ReduceOp.AVERAGE:
        out = qz._div(out, world)
    return out.reshape(tensor.shape)


def _allgather_quantizable(tensor: torch.Tensor, counts: List[int],
                           min_bytes: int) -> bool:
    return (tensor.dim() >= 1 and len(set(counts)) == 1
            and quantized_collective_eligible(tensor, len(counts), min_bytes))


def _gather_rows(tensor: torch.Tensor, ring: GroupRing) -> List[int]:
    """Every rank's dim 0 (1 for a scalar), in rank order."""
    rows = torch.tensor([tensor.shape[0] if tensor.dim() else 1],
                        dtype=torch.int64, device=ring.wire)
    all_rows = [torch.empty_like(rows) for _ in range(ring.size)]
    dist.all_gather(all_rows, rows, group=ring.group)
    return [int(r.item()) for r in all_rows]


def _quantized_allgather(tensor: torch.Tensor, codec: str,
                         ring: GroupRing) -> torch.Tensor:
    """Each rank encodes its shard once; the encodings are gathered and
    every rank, the owner included, decodes all of them from the same
    bytes."""
    world = ring.size
    flat = tensor.reshape(-1)
    length = flat.shape[0]
    payload = qz.quantize(flat, codec)
    gathered = []
    for leaf in _flatten(payload):
        parts = [torch.empty_like(leaf, device=ring.wire)
                 for _ in range(world)]
        dist.all_gather(parts, leaf.to(ring.wire), group=ring.group)
        gathered.append([p.to(leaf.device) for p in parts])
    shards = [qz.dequantize(*_unflatten(payload, iter(g[r] for g in gathered)),
                            length, codec) for r in range(world)]
    qz.note_device_bytes((world - 1) * length * 4,
                         (world - 1) * qz.encoded_nbytes(length, codec))
    return torch.stack(shards).reshape((world * tensor.shape[0],)
                                       + tuple(tensor.shape[1:]))


def quantized_allgather(tensor: torch.Tensor, min_bytes: Optional[int] = None,
                        codec: Optional[str] = None) -> torch.Tensor:
    """Allgather of block-scaled encodings, bit-identical across ranks.  It
    needs every rank's dim 0 to be equal (sizes are exchanged first);
    otherwise, or for an ineligible tensor, the plain allgather runs."""
    if min_bytes is None:
        min_bytes = _device_codec_defaults()[1]
    ring = _caller_ring()
    counts = _gather_rows(tensor, ring)
    if not _allgather_quantizable(tensor, counts, min_bytes):
        from .device_plane import plain_allgather

        return plain_allgather(tensor, counts, ring)
    return _quantized_allgather(tensor, _resolve_explicit_codec(codec), ring)


def _empty_payload(length: int, codec: str, device: torch.device):
    """Buffers shaped as ``quantize``'s payload of ``length`` elements."""
    nb = max(1, -(-length // qz.WIRE_BLOCK))
    width = qz.WIRE_BLOCK // 2 if codec == "int4" else qz.WIRE_BLOCK
    codes = torch.empty((nb, width), dtype=torch.int8, device=device)
    if codec == "int8g":
        ng = -(-nb // (qz.WIRE_GROUP // qz.WIRE_BLOCK))
        return codes, (torch.empty((nb, 1), dtype=torch.uint8, device=device),
                       torch.empty((ng, 1), dtype=torch.float32,
                                   device=device))
    return codes, torch.empty((nb, 1), dtype=torch.float32, device=device)


def quantized_broadcast(tensor: torch.Tensor, root_rank: int,
                        min_bytes: Optional[int] = None,
                        codec: Optional[str] = None) -> torch.Tensor:
    """Broadcast of the root's block-scaled encoding: the root encodes,
    the encoding is broadcast, and every rank, the root included, decodes
    the same bytes.  The result is within one quantization step of the
    root's value and bit-identical across ranks; an ineligible tensor takes
    the plain broadcast."""
    if not 0 <= root_rank < basics.size():
        raise ValueError(f"root_rank {root_rank} outside world of "
                         f"{basics.size()}")
    if min_bytes is None:
        min_bytes = _device_codec_defaults()[1]
    ring = _caller_ring()
    if not quantized_collective_eligible(tensor, basics.size(), min_bytes):
        from .device_plane import plain_broadcast

        return plain_broadcast(tensor.clone(), root_rank, ring)
    codec = _resolve_explicit_codec(codec)
    flat = tensor.reshape(-1)
    length = flat.shape[0]
    wire = ring.wire
    if basics.rank() == root_rank:
        payload = qz.quantize(flat, codec)
        bufs = [leaf.to(wire) for leaf in _flatten(payload)]
    else:
        payload = _empty_payload(length, codec, flat.device)
        bufs = [torch.empty_like(leaf, device=wire)
                for leaf in _flatten(payload)]
    for buf in bufs:
        dist.broadcast(buf, src=root_rank, group=ring.group)
    payload = _unflatten(payload, iter(b.to(flat.device) for b in bufs))
    out = qz.dequantize(payload[0], payload[1], length, codec)
    qz.note_device_bytes(length * 4, qz.encoded_nbytes(length, codec))
    return out.reshape(tensor.shape)


def _alltoall_exchange(ring, payloads: Sequence) -> List:
    """``payloads[d]`` goes to the rank at position d; returns the payloads
    received, indexed by the position they came from.  Round t sends to
    position ``rank + t`` and receives from ``rank - t``, so each round is
    one ring exchange; the own payload stays where it is."""
    n, me = ring.size, ring.rank
    got = [None] * n
    got[me] = payloads[me]
    for t in range(1, n):
        dst, src = (me + t) % n, (me - t) % n
        leaves = ring.exchange(_flatten(payloads[dst]), dst, src)
        got[src] = _unflatten(payloads[dst], iter(leaves))
    return got


def _quantized_alltoall(ring, x: torch.Tensor, codec: str) -> torch.Tensor:
    """Each rank encodes each of its ``world`` destination chunks with
    scales of its own, its own chunk included; the encodings cross and
    every received chunk, the own one included, is decoded: exactly one
    quantization step end to end, as the reference's."""
    n = ring.size
    rows = x.reshape(n, -1)
    c = rows.shape[1]
    got = _alltoall_exchange(ring, [qz.quantize(rows[d], codec)
                                    for d in range(n)])
    out = torch.stack([qz.dequantize(p[0], p[1], c, codec) for p in got])
    qz.note_device_bytes((n - 1) * c * 4,
                         (n - 1) * qz.encoded_nbytes(c, codec))
    return out.reshape(x.shape)


def quantized_alltoall(tensor: torch.Tensor, min_bytes: Optional[int] = None,
                       codec: Optional[str] = None) -> torch.Tensor:
    """Equal-splits alltoall of block-scaled encodings, the MoE dispatch and
    combine path: dim 0 is cut into ``world`` chunks, chunk d goes to rank
    d, and the chunks received are concatenated in rank order.  An
    ineligible tensor (not fp32, under ``min_bytes``, dim 0 not divisible
    by the world size, or 0-d) takes the plain alltoall, bit-identically.
    ``min_bytes`` and ``codec`` default as in :func:`quantized_allreduce`.
    """
    if min_bytes is None:
        min_bytes = _device_codec_defaults()[1]
    ring = _caller_ring()
    if not quantized_collective_eligible(tensor, ring.size, min_bytes,
                                         divisor=ring.size):
        from .device_plane import plain_alltoall

        return plain_alltoall(tensor, ring)
    return _quantized_alltoall(ring, tensor, _resolve_explicit_codec(codec))


def _quantized_reducescatter(ring, x: torch.Tensor, op: ReduceOp,
                             codec: str) -> torch.Tensor:
    """The reduce-scatter half of the quantized ring, started at offset -1
    so that the rank at position r ends with row r, summed in fp32 between
    hops."""
    n = ring.size
    rows = x.reshape(n, -1)
    c = rows.shape[1]
    acc = _ring_reduce_scatter(ring, rows, n, ring.rank, -1, +1,
                               _permutation(n, lambda i: (i + 1) % n), codec)
    qz.note_device_bytes((n - 1) * c * 4,
                         (n - 1) * qz.encoded_nbytes(c, codec))
    if op == ReduceOp.AVERAGE:
        acc = qz._div(acc, n)
    return acc.reshape((x.shape[0] // n,) + tuple(x.shape[1:]))


def quantized_reducescatter(tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                            min_bytes: Optional[int] = None,
                            codec: Optional[str] = None) -> torch.Tensor:
    """Reduce-scatter through the block-scaled ring: rank r gets the r-th of
    ``world`` equal chunks of dim 0, reduced over the ranks.  Sum and
    Average only (Average divides by the world size); an ineligible tensor
    takes the plain reducescatter, bit-identically.  ``min_bytes`` and
    ``codec`` default as in :func:`quantized_allreduce`."""
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            f"quantized_reducescatter supports Sum and Average, got {op}")
    if min_bytes is None:
        min_bytes = _device_codec_defaults()[1]
    ring = _caller_ring()
    if not quantized_collective_eligible(tensor, ring.size, min_bytes,
                                         divisor=ring.size):
        from .device_plane import plain_reducescatter

        return plain_reducescatter(tensor, op, ring)
    return _quantized_reducescatter(ring, tensor, op,
                                    _resolve_explicit_codec(codec))
