"""The device data plane: negotiated collectives of tensors on the rank's
device, over the process set's ``torch.distributed`` group.

Port of ``horovod_tpu/ops/device_plane.py`` (reference analog:
horovod/common/ops/nccl_operations.cc, where NCCLAllreduce and
NCCLBroadcast run on the accelerator and the fused buffer stays on the
device).  Where the JAX package dispatches a cached jitted XLA collective
over a one-device-per-rank mesh, this module runs one NCCL (on a card) or
gloo (on the CPU, or on a card under ``HOROVOD_GPU_OPERATIONS=GLOO``, each
transfer staged through host memory) collective on the set's group.

Which plane serves a collective is negotiated: every enqueue announces a
``device`` capability bit (:meth:`DevicePlane.adopt`), the coordinator ANDs
the bits, and a response flagged ``device`` runs here on every rank in the
same negotiated order; a host tensor on any rank demotes it to the host
ring for all.

A fused allreduce bucket is packed into one flat buffer padded to
:func:`bucket_len`.  There is no program to cache here, but the padded
length still matters: under ``HOROVOD_WIRE_COMPRESSION=device=<codec>`` an
fp32 Sum or Average bucket of at least the codec's minimum size rides the
quantized ring (``ops/collectives.py``), whose chunks and 256-element
blocks follow from that length, so the length decides the bits.

Streams: the executor issues this plane's work on a stream of its own.  It
waits on the event each entry recorded on its caller's stream at enqueue
before it reads the tensor, and records one event after the results are
written, which ``synchronize`` makes the caller's stream wait on.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..exceptions import HorovodInternalError
from ..utils.logging import get_logger
from ..wire import OpType, ReduceOp, validate_alltoall_splits
from . import quantize as qz
from .collectives import (GroupRing, _quantized_ring_allreduce_sum,
                          resolve_device_schedule)

log = get_logger()

_MIN_BUCKET = 1024

_SUPPORTED_REDUCE = (ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.MIN,
                     ReduceOp.MAX, ReduceOp.PRODUCT)

_DIST_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.AVERAGE: dist.ReduceOp.SUM,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
}

# dtypes both NCCL and gloo reduce; the rest ride the host ring.
_DEVICE_DTYPES = (torch.uint8, torch.int8, torch.int32, torch.int64,
                  torch.float16, torch.bfloat16, torch.float32,
                  torch.float64)


def bucket_len(n: int) -> int:
    """Pad a flat element count up to the {1, 1.25, 1.5, 1.75}·2^k size-class
    set (<= 25% padding)."""
    if n <= _MIN_BUCKET:
        return _MIN_BUCKET
    base = 1 << (int(n).bit_length() - 1)  # largest pow2 <= n
    for num in (4, 5, 6, 7, 8):
        cls = base * num // 4
        if n <= cls:
            return cls
    return base * 2


# --- Plain collectives on a group -----------------------------------------
# The device plane's executors, and the demotion of the public quantized_*
# functions (ops/collectives.py) on the caller's group.

def _to_wire(t: torch.Tensor, ring: GroupRing) -> torch.Tensor:
    return t if t.device == ring.wire else t.to(ring.wire)


def _gather_equal(flat: torch.Tensor, ring: GroupRing) -> torch.Tensor:
    """[k, ...] stack of every member's equally shaped ``flat``."""
    src = _to_wire(flat.contiguous(), ring)
    parts = [torch.empty_like(src) for _ in range(ring.size)]
    dist.all_gather(parts, src, group=ring.group)
    return torch.stack(parts).to(flat.device)


def _factor(f: float, like: torch.Tensor) -> torch.Tensor:
    """A scale factor rounded to ``like``'s dtype, as the reference's device
    plane uses it (``jnp.asarray(f, x.dtype)``).  Multiplying by the Python
    float instead would scale a 16-bit tensor in fp32 by the unrounded
    factor, 1 ulp off in many elements."""
    return torch.tensor(f, dtype=like.dtype, device=like.device)


def _times(x: torch.Tensor, f: float) -> torch.Tensor:
    return x * _factor(f, x)


def plain_allreduce(flat: torch.Tensor, rop: ReduceOp,
                    ring: GroupRing) -> torch.Tensor:
    """Reduce ``flat`` (owned by the caller, may be overwritten) over the
    ring's group.  Average divides the sum by the group's size, correctly
    rounded; Product is an allgather followed by a product."""
    rop = ReduceOp(rop)
    if rop == ReduceOp.PRODUCT:
        return torch.prod(_gather_equal(flat, ring), dim=0)
    t = _to_wire(flat, ring)
    dist.all_reduce(t, op=_DIST_OPS[rop], group=ring.group)
    out = t if t.device == flat.device else t.to(flat.device)
    if rop == ReduceOp.AVERAGE:
        out = qz._div(out, ring.size)
    return out


def plain_broadcast(t: torch.Tensor, root_rank: int,
                    ring: GroupRing) -> torch.Tensor:
    """``root_rank``'s (a global rank) value of ``t``, overwriting ``t``
    where it lies on the wire's device."""
    w = _to_wire(t.contiguous(), ring)
    dist.broadcast(w, src=int(root_rank), group=ring.group)
    return w if w.device == t.device else w.to(t.device)


def plain_allgather(t: torch.Tensor, counts: Sequence[int],
                    ring: GroupRing) -> torch.Tensor:
    """Concatenation along dim 0 of every member's ``t``, whose dim 0 is
    ``counts[member]``: rows are padded to the largest and sliced back."""
    src = _to_wire(t.contiguous(), ring)
    if src.dim() == 0:
        src = src.reshape(1)
    top = max(max(counts), 1)
    if src.shape[0] < top:
        pad = src.new_zeros((top - src.shape[0],) + tuple(src.shape[1:]))
        src = torch.cat([src, pad])
    parts = [torch.empty_like(src) for _ in range(ring.size)]
    dist.all_gather(parts, src, group=ring.group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)]).to(t.device)


def _equal_rows(t: torch.Tensor, what: str, k: int) -> int:
    """dim 0 of ``t`` over ``k`` equal chunks, or the reference's refusal."""
    if t.dim() == 0 or t.shape[0] % k:
        raise ValueError(f"{what} needs a dim 0 divisible by the "
                         f"{k} ranks, got shape {tuple(t.shape)}")
    return t.shape[0] // k


def plain_alltoall(t: torch.Tensor, ring: GroupRing) -> torch.Tensor:
    """Equal-splits alltoall of ``t`` over the ring's group: chunk d of dim
    0 goes to member d; the chunks received are concatenated in member
    order."""
    _equal_rows(t, "alltoall", ring.size)
    src = _to_wire(t.contiguous(), ring)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=ring.group)
    return out.to(t.device)


def plain_reducescatter(t: torch.Tensor, rop: ReduceOp,
                        ring: GroupRing) -> torch.Tensor:
    """Sum (or Average, divided by the group's size, correctly rounded) of
    ``t`` over the ring's group, keeping this member's equal chunk of
    dim 0."""
    rows = _equal_rows(t, "reducescatter", ring.size)
    src = _to_wire(t.contiguous().reshape(-1), ring)
    out = torch.empty(src.numel() // ring.size, dtype=src.dtype,
                      device=src.device)
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                               group=ring.group)
    out = out.to(t.device)
    if ReduceOp(rop) == ReduceOp.AVERAGE:
        out = qz._div(out, ring.size)
    return out.reshape((rows,) + tuple(t.shape[1:]))


class DevicePlane:
    """Executes negotiated ``device=True`` responses on the process sets'
    groups."""

    def __init__(self, core, cfg, device: torch.device, backend: str):
        self._core = core
        self._cfg = cfg
        self.device = device
        self._wire = device if backend == "nccl" else torch.device("cpu")
        self._lock = threading.Lock()
        self._rings: Dict[int, GroupRing] = {}
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)
        self.stats = {
            "allreduce": 0,       # fused device allreduces run
            "broadcast": 0,
            "reducescatter": 0,
            "allgather": 0,
            "alltoall": 0,
            "identity": 0,        # single-member completions (no transfer)
            "quantized": 0,       # fused allreduces that rode the codec ring
            "fused_tensors": 0,   # tensors in the fused allreduces above
            "host_fallback": 0,   # device tensors demoted to the host ring
            "late_device_put": 0,  # cache-replayed device bit, host entry
        }
        # Composition of each fused allreduce of more than one rank, in
        # negotiated order: what a replay of the quantized ring needs.
        self.bucket_log: collections.deque = collections.deque(maxlen=4096)

    # -- process sets --------------------------------------------------------
    def register(self, psid: int, group, ranks: Sequence[int]) -> None:
        """The group of process set ``psid`` (``dist.new_group``; the
        world's group for set 0).  A rank outside the set registers
        nothing, so it never announces the device bit for it."""
        me = self._core.rank()
        if me in ranks:
            with self._lock:
                self._rings[psid] = GroupRing(group, ranks, me, self._wire)

    def invalidate(self, psid: int) -> None:
        with self._lock:
            self._rings.pop(psid, None)

    def _ring(self, psid: int) -> GroupRing:
        with self._lock:
            ring = self._rings.get(psid)
        if ring is None:
            raise HorovodInternalError(
                f"device plane has no group for process set {psid}")
        return ring

    # -- enqueue-side capability --------------------------------------------
    def adopt(self, tensor, op: OpType, reduce_op: ReduceOp, psid: int):
        """``tensor`` if this enqueue can ride the device plane, else None
        (host ring).  This decides the rank's announced ``device`` bit, so
        it returns a tensor only when execute() cannot fail locally: a
        tensor on the rank's device, of a dtype both backends reduce, whose
        op and reduce op are served, in a set this rank belongs to."""
        if not isinstance(tensor, torch.Tensor) or tensor.device != self.device:
            return None
        if tensor.dtype not in _DEVICE_DTYPES:
            return None
        with self._lock:
            ring = self._rings.get(psid)
        if ring is None:
            return None
        if op == OpType.ALLREDUCE:
            if reduce_op not in _SUPPORTED_REDUCE:
                return None
        elif op in (OpType.ALLGATHER, OpType.ALLTOALL):
            if tensor.dim() == 0:
                return None
        elif op == OpType.REDUCESCATTER:
            # Even first dims only; the host ring's extra-row slicing
            # serves the rest.  Shapes are negotiated equal across ranks,
            # so every rank decides alike.
            if reduce_op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
                return None
            d0 = tensor.shape[0] if tensor.dim() else 0
            if d0 == 0 or d0 % ring.size:
                return None
        elif op != OpType.BROADCAST:
            return None
        return tensor

    def note_host_fallback(self, name: str) -> None:
        """A device tensor was demoted to the host ring by negotiation (a
        host tensor, an unserved op or a joined rank elsewhere)."""
        with self._lock:
            self.stats["host_fallback"] += 1
            warned = getattr(self, "_fallback_warned", False)
            self._fallback_warned = True
        if not warned and self.device.type == "cuda":
            log.warning(
                "eager collective %r has a tensor on %s but was negotiated "
                "onto the host ring (another rank submitted a host tensor, "
                "an unserved op or dtype, or a rank is joined): its bytes "
                "cross host memory and TCP. (warned once)", name,
                self.device)

    def _device_codec(self, rop: ReduceOp, dtype: torch.dtype, length: int,
                      k: int) -> str:
        """The configured block-scaled codec when this fused bucket should
        ride the quantized ring, else ``"none"``: fp32 Sum or Average, a
        padded payload of at least HOROVOD_WIRE_COMPRESSION_MIN_BYTES, and
        more than one member.  Config is rank-uniform, so every member
        decides alike."""
        codec = self._cfg.wire_compression_device
        if codec not in qz.DEVICE_WIRE_CODECS or codec == "none":
            return "none"
        if k <= 1 or rop not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            return "none"
        if dtype != torch.float32:
            return "none"
        if length * 4 < int(self._cfg.wire_compression_min_bytes):
            return "none"
        return codec

    def _device_schedule(self, k: int) -> str:
        return resolve_device_schedule(k, self._cfg.device_schedule)

    # -- execution -----------------------------------------------------------
    def execute(self, resp, entries: Sequence) -> None:
        """Run a negotiated ``device=True`` response on this rank's stream;
        fills each entry's result with a tensor on the device.

        A response-cache replay carries the bit of the original
        negotiation, so an entry that is a host buffer now can arrive here:
        its bytes are put on the device first (one slow step, the right
        result)."""
        if self._stream is None:
            self._put_late(entries)
            self._dispatch(resp, entries)
            return
        torch.cuda.set_device(self.device)
        with torch.cuda.stream(self._stream):
            self._put_late(entries)
            for e in entries:
                if e.ready_event is not None:
                    self._stream.wait_event(e.ready_event)
            self._dispatch(resp, entries)
            done = torch.cuda.Event()
            done.record(self._stream)
        for e in entries:
            e.done_event = done

    def _put_late(self, entries: Sequence) -> None:
        for e in entries:
            if e.device_tensor is None:
                e.device_tensor = _host_tensor(e).to(self.device)
                self._count("late_device_put")

    def _dispatch(self, resp, entries: Sequence) -> None:
        op = resp.op
        if op == OpType.ALLREDUCE:
            self._exec_allreduce(resp, entries)
        elif op == OpType.BROADCAST:
            self._exec_broadcast(resp, entries[0])
        elif op == OpType.REDUCESCATTER:
            self._exec_reducescatter(resp, entries[0])
        elif op == OpType.ALLGATHER:
            self._exec_allgather(resp, entries)
        elif op == OpType.ALLTOALL:
            self._exec_alltoall(resp, entries[0])
        else:
            raise HorovodInternalError(
                f"op {op} is not served by the device plane")

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.stats[key] += n

    @staticmethod
    def _finish(e, value: torch.Tensor) -> None:
        """``value`` as the entry's result: written into the tensor itself
        for an in-place op, else a tensor of its own."""
        x = e.device_tensor
        if e.inplace:
            if value.data_ptr() != x.data_ptr():
                with torch.no_grad():
                    x.copy_(value.reshape(x.shape))
            e.result = x
        else:
            e.result = value.reshape(x.shape) if value is not x \
                else x.clone()

    @staticmethod
    def _scaled(x: torch.Tensor, pre: float, post: float) -> torch.Tensor:
        if pre != 1.0:
            x = _times(x, pre)
        if post != 1.0:
            x = _times(x, post)
        return x

    def _exec_allreduce(self, resp, entries: Sequence) -> None:
        ring = self._ring(resp.process_set_id)
        rop = entries[0].reduce_op
        pre = float(entries[0].prescale_factor)
        post = float(entries[0].postscale_factor)
        k = ring.size
        if k == 1:
            # Every served reduce over one member is the identity, modulo
            # the scale factors: no transfer.
            for e in entries:
                self._finish(e, self._scaled(e.device_tensor, pre, post))
            self._count("identity", len(entries))
            return
        tensors = [e.device_tensor for e in entries]
        total = sum(t.numel() for t in tensors)
        length = bucket_len(total)
        flat = torch.zeros(length, dtype=tensors[0].dtype, device=self.device)
        off = 0
        for t in tensors:
            flat[off:off + t.numel()] = t.reshape(-1)
            off += t.numel()
        if pre != 1.0:
            flat[:total].mul_(_factor(pre, flat))
        codec = self._device_codec(rop, flat.dtype, length, k)
        schedule = self._device_schedule(k)
        if codec != "none":
            out = _quantized_ring_allreduce_sum(ring, flat, codec, schedule)
            if rop == ReduceOp.AVERAGE:
                out = qz._div(out, k)
            qz.note_device_bytes(*qz.ring_bytes(length, k, codec, schedule))
        else:
            out = plain_allreduce(flat, rop, ring)
        off = 0
        for e in entries:
            n = e.device_tensor.numel()
            seg = out[off:off + n]
            if post != 1.0:
                seg = _times(seg, post)
            elif len(entries) > 1 and not e.inplace:
                seg = seg.clone()  # a result must not pin the whole bucket
            self._finish(e, seg)
            off += n
        self.bucket_log.append({
            "psid": resp.process_set_id, "names": [e.name for e in entries],
            "numels": [e.device_tensor.numel() for e in entries],
            "length": length, "codec": codec, "schedule": schedule, "k": k})
        with self._lock:
            self.stats["allreduce"] += 1
            self.stats["fused_tensors"] += len(entries)
            if codec != "none":
                self.stats["quantized"] += 1

    def _exec_reducescatter(self, resp, e) -> None:
        ring = self._ring(resp.process_set_id)
        pre = float(e.prescale_factor)
        post = float(e.postscale_factor)
        x = e.device_tensor
        k = ring.size
        if k == 1:
            # One member keeps the whole reduced buffer.
            e.result = self._scaled(x, pre, post)
            if e.result is x:
                e.result = x.clone()
            self._count("identity")
            return
        flat = x.reshape(-1).clone()
        if pre != 1.0:
            flat.mul_(_factor(pre, flat))
        src = _to_wire(flat, ring)
        out = torch.empty(flat.numel() // k, dtype=flat.dtype,
                          device=src.device)
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                                   group=ring.group)
        out = out.to(self.device)
        if e.reduce_op == ReduceOp.AVERAGE:
            out = qz._div(out, k)
        if post != 1.0:
            out = _times(out, post)
        e.result = out.reshape((x.shape[0] // k,) + tuple(x.shape[1:]))
        self._count("reducescatter")

    def _exec_allgather(self, resp, entries: Sequence) -> None:
        """Each member's first dims cross the host ring as int64 metadata
        (a few bytes), then each tensor rides one padded all_gather."""
        ring = self._ring(resp.process_set_id)
        k = ring.size
        if k == 1:
            for e in entries:
                e.result = e.device_tensor.clone()
            self._count("identity", len(entries))
            return
        dims = np.ascontiguousarray(
            [int(e.device_tensor.shape[0]) for e in entries], dtype=np.int64)
        stacked, _ = self._core.allgather_buffer(dims, resp.process_set_id)
        per_rank = np.asarray(stacked, dtype=np.int64).reshape(k, len(entries))
        for j, e in enumerate(entries):
            counts = [int(c) for c in per_rank[:, j]]
            e.result = plain_allgather(e.device_tensor, counts, ring)
        self._count("allgather")

    def _exec_alltoall(self, resp, e) -> None:
        """Each member's splits cross the host ring as metadata, then one
        all_to_all_single moves the rows."""
        ring = self._ring(resp.process_set_id)
        k = ring.size
        x = e.device_tensor
        splits = validate_alltoall_splits(e.splits, x.shape[0], k)
        if k == 1:
            e.result = x.clone()
            e.recv_splits = splits.copy()
            self._count("identity")
            return
        stacked, _ = self._core.allgather_buffer(splits, resp.process_set_id)
        mat = np.asarray(stacked, dtype=np.int64).reshape(k, k)
        recv = [int(mat[src, ring.rank]) for src in range(k)]
        rest = tuple(x.shape[1:])
        row = int(np.prod(rest, dtype=np.int64)) if rest else 1
        src = _to_wire(x.contiguous().reshape(-1), ring)
        out = torch.empty(sum(recv) * row, dtype=x.dtype, device=src.device)
        dist.all_to_all_single(out, src, [r * row for r in recv],
                               [int(s) * row for s in splits],
                               group=ring.group)
        e.result = out.to(self.device).reshape((sum(recv),) + rest)
        e.recv_splits = np.asarray(recv, dtype=np.int64)
        self._count("alltoall")

    def _exec_broadcast(self, resp, e) -> None:
        ring = self._ring(resp.process_set_id)
        x = e.device_tensor
        if ring.size == 1:
            self._finish(e, x)
            self._count("identity")
            return
        buf = x if (e.inplace and x.is_contiguous()
                    and x.device == ring.wire) else x.contiguous().clone()
        self._finish(e, plain_broadcast(buf, e.root_rank, ring))
        self._count("broadcast")


def _host_tensor(e) -> torch.Tensor:
    """A host entry's buffer as a torch tensor of its wire dtype."""
    from ..wire import torch_dtype

    arr = np.ascontiguousarray(e.array)
    return torch.from_numpy(arr.copy()).view(torch_dtype(e.dtype)) \
        .reshape(arr.shape)
