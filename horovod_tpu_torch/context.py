"""The process-wide Horovod context: handle table, executor, host data plane.

Port of ``horovod_tpu/context.py`` (reference analogs: HorovodGlobalState in
global_state.h, HandleManager in torch/handle_manager.cc, the fuse/unfuse
of ops/collective_operations.cc and the op execution of
ops/operation_manager.cc).

Every eager collective is enqueued under a name; the core negotiates it
across ranks and fuses it into buckets; the dispatcher pops the negotiated
``FusedResponse``s and finalizes each on an executor lane:

- responses negotiated ``device`` run on the device plane
  (``ops/device_plane.py``: NCCL on a card, gloo on the CPU), all of them
  on one lane, in negotiated order;
- the rest run on the host plane: the core's own TCP/shm ring over numpy
  buffers (numpy arrays, and CPU tensors on a card rank), one lane per
  process set.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from .exceptions import HorovodInternalError
from .ops import hlo_inspect
from .ops.device_plane import DevicePlane
from .runtime import CoreBackend, FusedResponse, PyLocalCore, TensorEntry
from .utils.env import Config, get_bool
from .utils.logging import get_logger
from .wire import (DataType, OpType, ReduceOp, numpy_dtype,
                   validate_alltoall_splits, wire_dtype)

log = get_logger()

_INT_TYPES = (
    DataType.UINT8, DataType.INT8, DataType.UINT16, DataType.INT16,
    DataType.INT32, DataType.INT64, DataType.BOOL,
)

# Pseudo process-set id keying the single shared device-plane executor lane
# (never collides with real psids, which are >= 0).
_DEVICE_LANE = -1


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(
        torch.bfloat16).float().numpy()


def _f32_to_bf16(vals: np.ndarray) -> np.ndarray:
    """Round to nearest even, as a ``uint16`` bit array."""
    return torch.from_numpy(np.ascontiguousarray(vals, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _scale(arr: np.ndarray, factor: float,
           dtype: Optional[DataType] = None) -> np.ndarray:
    """Scale a host buffer by a scalar, as the reference does bit for bit:
    f32/f64 in place; 16-bit floats widened to f32 for the multiply (bf16
    from its uint16 bits); anything else through f64."""
    if dtype == DataType.BFLOAT16:
        return _f32_to_bf16(_bf16_to_f32(arr) * np.float32(factor)).reshape(
            arr.shape)
    if arr.dtype in (np.float32, np.float64):
        np.multiply(arr, arr.dtype.type(factor), out=arr)
        return arr
    if arr.itemsize == 2:
        return (arr.astype(np.float32) * np.float32(factor)).astype(arr.dtype)
    return (arr.astype(np.float64) * factor).astype(arr.dtype)


def _rows2d(a: np.ndarray) -> np.ndarray:
    """View as (rows, row_width) for the row-oriented plane calls (a
    zero-row contribution is legal for ragged allgather)."""
    if a.ndim == 0:
        return a.reshape(1, 1)
    row = int(np.prod(a.shape[1:], dtype=np.int64)) if a.ndim > 1 else 1
    return a.reshape(a.shape[0], row)


class _FusionBuffer:
    """Reusable pack/unpack buffer for the host data plane (reference:
    fusion_buffer_manager.cc).  Grows to the largest bucket seen."""

    def __init__(self, initial_bytes: int = 0):
        self._buf = np.empty(int(initial_bytes), np.uint8)

    def view(self, dtype, count: int) -> np.ndarray:
        dtype = np.dtype(dtype)
        nbytes = int(count) * dtype.itemsize
        if self._buf.nbytes < nbytes:
            self._buf = np.empty(nbytes, np.uint8)
        return self._buf[:nbytes].view(dtype)


def _select_backend(cfg: Config) -> CoreBackend:
    """The native C++ core, unless ``HOROVOD_CONTROLLER=python`` or
    ``HVD_TPU_PURE_PY=1`` asks for the pure-Python one (single process
    only).  A native core that fails to build or load raises."""
    if cfg.force_pure_python or cfg.controller == "python":
        if cfg.size > 1:
            raise HorovodInternalError(
                "pure-Python core only supports single-process mode")
        return PyLocalCore()
    from ._core import NativeCore

    return NativeCore()


class _ExecutorLane:
    """One finalization lane (reference analog: thread_pool.cc plus
    per-communicator streams).  Responses of one lane finalize strictly in
    negotiated order; different lanes proceed concurrently."""

    def __init__(self, ctx: "HorovodContext", psid: int):
        self.psid = psid
        self._ctx = ctx
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(
            target=self._run, name=f"hvd-lane-{psid}", daemon=True)
        self._thread.start()

    def submit(self, resp: FusedResponse) -> None:
        self._q.put(resp)

    def stop(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=5.0)

    def _run(self) -> None:
        while True:
            resp = self._q.get()
            if resp is None or self._ctx._shutdown.is_set():
                return
            self._ctx._process_response(resp)


class HorovodContext:
    """Process-wide singleton created by ``hvd.init()``."""

    _instance: Optional["HorovodContext"] = None
    _instance_lock = threading.Lock()

    def __init__(self, cfg: Config, device: torch.device, backend: str,
                 core_port: int = 0):
        self.cfg = cfg
        self.core = _select_backend(cfg)
        self._entries: Dict[int, TensorEntry] = {}
        self._entries_lock = threading.Lock()
        self._inflight_names: set = set()
        self._deferred: Dict[str, List[TensorEntry]] = {}
        self._joined = False  # this rank called join() and awaits the rest
        self._handle_counter = itertools.count(1)
        self._noname_counter = itertools.count(0)
        # Unnamed groups need a key that matches across ranks: like the
        # noname counter, it follows from every rank issuing grouped calls
        # in the same order.
        self._group_counter = itertools.count(0)
        self._shutdown = threading.Event()
        self._fusion_tls = threading.local()
        self._fusion_initial = min(cfg.fusion_threshold_bytes, 64 << 20)
        # Negotiated responses and the tensors they carried, as popped, and
        # when the latest entry was enqueued (time.monotonic()).
        self.stats = {"responses": 0, "tensors": 0}
        self.last_enqueue_at = 0.0
        self.core.start(dataclasses.replace(cfg, rendezvous_port=core_port))
        # The step trace's plane tag starts eager; the optimizer's marks
        # (ops/hlo_inspect.mark_plane) change it from here.
        self.core.step_trace_note_plane(0)
        hlo_inspect._STEP_PLANE[0] = 0
        self.device_plane = DevicePlane(self.core, cfg, device, backend)
        # Set 0 runs on the default (world) group.
        self.device_plane.register(0, None, range(cfg.size))
        self._use_lanes = (
            self.core.parallel_lanes and cfg.size > 1
            and get_bool("HOROVOD_EXECUTOR_LANES", True))
        self._lanes: Dict[int, _ExecutorLane] = {}
        # The live cockpit (HOROVOD_COCKPIT, rank 0 only): a loopback HTTP
        # endpoint over the core's metrics and step trace; None when off.
        from .cockpit import maybe_start_cockpit

        self.cockpit = maybe_start_cockpit(self)
        self._executor = threading.Thread(
            target=self._executor_loop, name="hvd-executor", daemon=True)
        self._executor.start()

    @property
    def _fusion(self) -> _FusionBuffer:
        buf = getattr(self._fusion_tls, "buf", None)
        if buf is None:
            buf = _FusionBuffer(self._fusion_initial)
            self._fusion_tls.buf = buf
        return buf

    # -- lifecycle ----------------------------------------------------------
    @classmethod
    def instance(cls) -> "HorovodContext":
        inst = cls._instance
        if inst is None:
            raise ValueError(
                "Horovod has not been initialized; run hvd.init() first.")
        return inst

    @classmethod
    def start(cls, *args, **kwargs) -> "HorovodContext":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = HorovodContext(*args, **kwargs)
            return cls._instance

    @classmethod
    def shutdown(cls) -> None:
        with cls._instance_lock:
            inst, cls._instance = cls._instance, None
        if inst is None:
            return
        inst._shutdown.set()
        inst._executor.join(timeout=5.0)
        if inst.cockpit is not None:
            # Frees the port before an elastic re-init binds it again.
            inst.cockpit.stop()
        inst.core.shutdown()
        # Fail still-pending handles so blocked synchronize() callers wake
        # with an error instead of hanging.
        with inst._entries_lock:
            pending = [e for e in inst._entries.values() if not e.done.is_set()]
        for e in pending:
            e.error = "Horovod has been shut down"
            e.done.set()

    # -- enqueue ------------------------------------------------------------
    def enqueue(self, array, op: OpType, name: Optional[str] = None,
                reduce_op: ReduceOp = ReduceOp.SUM, root_rank: int = 0,
                splits=None, process_set_id: int = 0,
                prescale_factor: float = 1.0, postscale_factor: float = 1.0,
                group_key: str = "", group_size: int = 0,
                inplace: bool = False) -> int:
        """Enqueue one collective of ``array`` (a torch tensor or a numpy
        array) under ``name``; returns its handle."""
        dev = self.device_plane.adopt(array, op, reduce_op, process_set_id)
        if dev is not None:
            # The device plane serves it: negotiation needs only the shape
            # and dtype, which a zero-memory proxy carries.
            dtype = wire_dtype(dev.dtype)
            host = np.broadcast_to(np.zeros((), numpy_dtype(dtype)),
                                   tuple(dev.shape))
            was_torch, orig_dtype, orig_device = True, dev.dtype, dev.device
        else:
            host, dtype, was_torch, orig_dtype, orig_device = _to_host(array)
        if name is None:
            name = f"{op.name.lower()}.noname.{next(self._noname_counter)}"
        if dtype in _INT_TYPES:
            if reduce_op == ReduceOp.AVERAGE and op in (
                    OpType.ALLREDUCE, OpType.REDUCESCATTER):
                raise ValueError(
                    "hvd.Average is not supported for integer tensors; use hvd.Sum"
                )
            if prescale_factor != 1.0 or postscale_factor != 1.0:
                raise ValueError("pre/postscale not supported for integer tensors")
        if splits is not None:
            splits = np.ascontiguousarray(np.asarray(splits, dtype=np.int64))
        ready = None
        if isinstance(array, torch.Tensor) and array.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(array.device))
        entry = TensorEntry(
            handle=next(self._handle_counter), name=name, op=op, array=host,
            dtype=dtype, reduce_op=reduce_op, root_rank=root_rank,
            splits=splits, process_set_id=process_set_id,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, was_torch=was_torch,
            orig_dtype=orig_dtype, orig_device=orig_device,
            group_key=group_key, group_size=group_size, device_tensor=dev,
            inplace=inplace and dev is not None, ready_event=ready)
        with self._entries_lock:
            self._entries[entry.handle] = entry
            self.last_enqueue_at = entry.enqueued_at
            if name in self._inflight_names:
                # Reference semantics: a second op with an in-flight name
                # queues behind the first and is submitted once the first
                # completes (every rank orders instances the same way).
                self._deferred.setdefault(name, []).append(entry)
                return entry.handle
            self._inflight_names.add(name)
        self.core.enqueue(entry)
        return entry.handle

    def group_key_for(self, name: Optional[str]) -> str:
        """Negotiation key of one grouped call (group_table.cc analog):
        named groups key on the name, unnamed ones on the grouped-call
        counter."""
        if name:
            return f"g.{name}"
        return f"g.anon.{next(self._group_counter)}"

    def join_begin(self) -> None:
        with self._entries_lock:
            self._joined = True

    # -- completion ---------------------------------------------------------
    def poll(self, handle: int) -> bool:
        with self._entries_lock:
            entry = self._entries.get(handle)
        if entry is None:
            raise ValueError(f"unknown handle {handle}")
        return entry.done.is_set()

    def synchronize(self, handle: int):
        """The result of ``handle`` (``(result, received splits)`` for
        alltoall), once complete.  A device result is ordered before any
        later work of the caller's current stream."""
        with self._entries_lock:
            entry = self._entries.get(handle)
        if entry is None:
            raise ValueError(f"unknown handle {handle}")
        entry.done.wait()
        if entry.done_event is not None:
            stream = torch.cuda.current_stream(entry.device_tensor.device)
            stream.wait_event(entry.done_event)
            if isinstance(entry.result, torch.Tensor):
                entry.result.record_stream(stream)
        with self._entries_lock:
            self._entries.pop(handle, None)
        if entry.error is not None:
            raise HorovodInternalError(entry.error)
        result = _from_host(entry.result, entry)
        if entry.op == OpType.ALLTOALL:
            return result, entry.recv_splits
        return result

    # -- executor -----------------------------------------------------------
    def _executor_loop(self) -> None:
        """Dispatcher: pop negotiated responses and finalize each inline
        (one rank) or on its lane."""
        while not self._shutdown.is_set():
            resp = self.core.pop_response(timeout=0.05)
            if resp is None:
                continue
            self.stats["responses"] += 1
            self.stats["tensors"] += len(resp.handles)
            # Join-state transitions follow the global negotiated order,
            # which only the dispatcher sees: stamp the joined flag on each
            # response, and clear it when the JOIN itself dispatches.
            with self._entries_lock:
                resp.joined_at_dispatch = self._joined
                if resp.op == OpType.JOIN and not resp.error:
                    self._joined = False
            if resp.device and self._use_lanes:
                # Every device response shares ONE lane: each rank issues
                # the groups' collectives in the same negotiated order.
                self._lane_for(_DEVICE_LANE).submit(resp)
            elif self._use_lanes:
                self._lane_for(resp.process_set_id).submit(resp)
            else:
                self._process_response(resp)
        for lane in list(self._lanes.values()):
            lane.stop()

    def _lane_for(self, psid: int) -> _ExecutorLane:
        lane = self._lanes.get(psid)
        if lane is None:
            lane = _ExecutorLane(self, psid)
            self._lanes[psid] = lane
        return lane

    def remove_process_set(self, psid: int) -> None:
        """Remove a set from the core and retire its executor lane."""
        self.core.remove_process_set(psid)
        self.device_plane.invalidate(psid)
        lane = self._lanes.pop(psid, None)
        if lane is not None:
            lane.stop()

    def _process_response(self, resp: FusedResponse) -> None:
        """Finalize one response: collect entries, run the data plane, set
        completion."""
        self.core.set_current_seq(resp.seq)
        entries = []
        with self._entries_lock:
            for h in resp.handles:
                e = self._entries.get(h)
                if e is not None:
                    entries.append(e)
        if not entries:
            # Joined rank (hvd.join): no local tensors, but ring
            # collectives need every member -- participate with zeros.
            if resp.joined_at_dispatch and not resp.error:
                try:
                    self._participate_absent(resp)
                except Exception as exc:  # noqa: BLE001 - lane must go on
                    log.warning("zero-participation failed: %s", exc)
            return
        try:
            if resp.error:
                raise HorovodInternalError(resp.error)
            self._execute(resp, entries)
            for e in entries:
                e.done.set()
        except Exception as exc:  # noqa: BLE001 - propagate via handle
            if resp.op == OpType.JOIN:
                with self._entries_lock:
                    self._joined = False
            for e in entries:
                e.error = str(exc)
                e.done.set()
        self._release_names(entries)

    def _release_names(self, entries: List[TensorEntry]) -> None:
        """After a name's instance completes, submit its next queued
        instance or free the name."""
        to_enqueue = []
        with self._entries_lock:
            for e in entries:
                queued = self._deferred.get(e.name)
                if queued:
                    to_enqueue.append(queued.pop(0))
                    if not queued:
                        del self._deferred[e.name]
                else:
                    self._inflight_names.discard(e.name)
        for nxt in to_enqueue:
            self.core.enqueue(nxt)

    def _execute(self, resp: FusedResponse, entries: List[TensorEntry]) -> None:
        op = resp.op
        psid = resp.process_set_id
        if resp.device:
            self.device_plane.execute(resp, entries)
            return
        # Host plane.  Negotiation may have demoted device entries (a host
        # tensor or a joined rank elsewhere): their bytes cross to the host
        # here, once the caller's stream has written them.
        for e in entries:
            if e.device_tensor is not None:
                if e.ready_event is not None:
                    e.ready_event.synchronize()
                e.array = _host_array(e.device_tensor)
                e.device_tensor = None
                self.device_plane.note_host_fallback(e.name)
        if op == OpType.ALLREDUCE:
            self._exec_allreduce(entries, psid)
        elif op == OpType.ALLGATHER:
            self._exec_allgather(entries, psid)
        elif op == OpType.BROADCAST:
            self._exec_broadcast(entries[0], psid)
        elif op == OpType.ALLTOALL:
            self._exec_alltoall(entries[0], psid)
        elif op == OpType.REDUCESCATTER:
            self._exec_reducescatter(entries[0], psid)
        elif op == OpType.BARRIER:
            self.core.barrier(psid)
            for e in entries:
                e.result = e.array
        elif op == OpType.JOIN:
            # Every rank joined; no data moves.  The result is the last
            # rank to join.
            with self._entries_lock:
                self._joined = False
            for e in entries:
                e.result = np.int64(resp.last_joined)
        else:
            raise HorovodInternalError(f"unsupported op {op}")

    def _participate_absent(self, resp: FusedResponse) -> None:
        """Walk a collective this rank submitted nothing for (it joined):
        zero contribution for Sum/Average allreduce, plain participation
        for barriers.  The coordinator lets only these become ready while
        ranks are joined, and demotes them to the host plane."""
        psid = resp.process_set_id
        if self.cfg.rank not in self.core.process_set_ranks(psid):
            return
        if resp.device:
            raise HorovodInternalError(
                "joined rank received a device-plane response")
        if resp.op == OpType.ALLREDUCE:
            count = int(sum(resp.counts or []))
            zeros = np.zeros(count, numpy_dtype(resp.dtype))
            self.core.allreduce_buffer(zeros, psid, ReduceOp.SUM, resp.dtype)
        elif resp.op == OpType.BARRIER:
            self.core.barrier(psid)
        elif resp.op == OpType.JOIN:
            pass  # our own join entry always exists locally
        else:
            raise HorovodInternalError(
                f"op {resp.op} cannot proceed with joined ranks")

    def _ps_size(self, psid: int) -> int:
        return len(self.core.process_set_ranks(psid))

    # -- host plane ---------------------------------------------------------
    def _exec_allreduce(self, entries: List[TensorEntry], psid: int) -> None:
        dtype = entries[0].array.dtype
        wire = entries[0].dtype
        reduce_op = entries[0].reduce_op
        if len(entries) == 1 and reduce_op != ReduceOp.ADASUM:
            # One tensor: one owned copy (the plane reduces in place).
            e = entries[0]
            flat = np.array(e.array, dtype=dtype, copy=True,
                            order="C").reshape(-1)
            if e.prescale_factor != 1.0:
                flat = _scale(flat, e.prescale_factor, wire)
            wire_op = ReduceOp.SUM if reduce_op == ReduceOp.AVERAGE \
                else reduce_op
            flat = self.core.allreduce_buffer(flat, psid, wire_op, wire)
            if reduce_op == ReduceOp.AVERAGE:
                n = self._ps_size(psid)
                if n > 1:
                    flat = _scale(flat, 1.0 / n, wire)
            if e.postscale_factor != 1.0:
                flat = _scale(flat, e.postscale_factor, wire)
            e.result = flat.reshape(e.array.shape)
            return
        total = sum(e.array.size for e in entries)
        fused = self._fusion.view(dtype, total)
        off = 0
        for e in entries:
            n = e.array.size
            np.copyto(fused[off:off + n], e.array.ravel(), casting="no")
            off += n
        pre = entries[0].prescale_factor
        if pre != 1.0:
            fused = _scale(fused, pre, wire)
        if reduce_op == ReduceOp.ADASUM and self._ps_size(psid) > 1:
            # Allgather every rank's fused buffer, then a deterministic
            # pairwise-tree combine per tensor segment (adasum's dot/norm
            # coefficients are per tensor): every rank computes the same.
            stacked, _ = self.core.allgather_buffer(fused.reshape(1, -1), psid)
            vectors = (_bf16_to_f32(stacked) if wire == DataType.BFLOAT16
                       else stacked).astype(np.float64)
            segments = []
            offset = 0
            for e in entries:
                seg = vectors[:, offset:offset + e.array.size]
                segments.append(_adasum_tree(seg))
                offset += e.array.size
            combined = np.concatenate(segments)
            fused = (_f32_to_bf16(combined.astype(np.float32))
                     if wire == DataType.BFLOAT16 else combined.astype(dtype))
        else:
            wire_op = ReduceOp.SUM \
                if reduce_op in (ReduceOp.AVERAGE, ReduceOp.ADASUM) \
                else reduce_op
            fused = self.core.allreduce_buffer(fused, psid, wire_op, wire)
            if reduce_op == ReduceOp.AVERAGE:
                n = self._ps_size(psid)
                if n > 1:
                    fused = _scale(fused, 1.0 / n, wire)
        post = entries[0].postscale_factor
        if post != 1.0:
            fused = _scale(fused, post, wire)
        # Results own their memory: the fusion buffer is reused.
        offset = 0
        for e in entries:
            n = e.array.size
            e.result = fused[offset:offset + n].reshape(e.array.shape).copy()
            offset += n

    def _exec_allgather(self, entries: List[TensorEntry], psid: int) -> None:
        if len(entries) == 1:
            e = entries[0]
            stacked, counts = self.core.allgather_buffer(
                _rows2d(e.array), psid)
            rest = e.array.shape[1:] if e.array.ndim else ()
            e.result = np.asarray(stacked).reshape(
                (int(np.sum(counts)),) + tuple(rest))
            return
        # Fused allgather: members length-prefixed into one payload of
        # one-byte rows (rank blocks are ragged), gathered once, then each
        # rank's block split back into per-tensor segments.
        parts = []
        for e in entries:
            raw = np.ascontiguousarray(e.array).view(np.uint8).ravel()
            parts.append(np.frombuffer(
                np.int64(raw.nbytes).tobytes(), np.uint8))
            parts.append(raw)
        packed = np.concatenate(parts)
        stacked, counts = self.core.allgather_buffer(
            packed.reshape(-1, 1), psid)
        flat = np.asarray(stacked).view(np.uint8).ravel()
        per_entry: List[List[np.ndarray]] = [[] for _ in entries]
        off = 0
        for rank_bytes in counts:
            end = off + int(rank_bytes)
            for i, e in enumerate(entries):
                n = int(flat[off:off + 8].view(np.int64)[0])
                off += 8
                per_entry[i].append(flat[off:off + n])
                off += n
            if off != end:
                raise HorovodInternalError(
                    "fused allgather block framing desynced")
        for i, e in enumerate(entries):
            rest = tuple(e.array.shape[1:]) if e.array.ndim else ()
            row_bytes = int(np.prod(rest, dtype=np.int64)) * e.array.itemsize \
                if rest else e.array.itemsize
            blob = np.concatenate(per_entry[i]) if per_entry[i] else \
                np.empty(0, np.uint8)
            total_rows = blob.nbytes // max(row_bytes, 1)
            e.result = blob.view(e.array.dtype).reshape(
                (total_rows,) + rest)

    def _exec_broadcast(self, e: TensorEntry, psid: int) -> None:
        e.result = self.core.broadcast_buffer(e.array, e.root_rank, psid)

    def _exec_alltoall(self, e: TensorEntry, psid: int) -> None:
        n = self._ps_size(psid)
        splits = validate_alltoall_splits(e.splits, e.array.shape[0], n)
        out, recv_splits = self.core.alltoall_buffer(
            _rows2d(e.array), splits, psid)
        rest = e.array.shape[1:]
        e.result = np.asarray(out).reshape(
            (int(np.sum(recv_splits)),) + tuple(rest))
        e.recv_splits = np.asarray(recv_splits, dtype=np.int64)

    def _exec_reducescatter(self, e: TensorEntry, psid: int) -> None:
        # Ring reduce-scatter; the first (d0 % size) ranks receive one
        # extra row (the reference's ReducescatterOp slicing).
        n = self._ps_size(psid)
        wire = e.dtype
        fused = e.array.ravel().copy()
        if e.prescale_factor != 1.0:
            fused = _scale(fused, e.prescale_factor, wire)
        wire_op = ReduceOp.SUM if e.reduce_op == ReduceOp.AVERAGE else e.reduce_op
        d0 = e.array.shape[0]
        row = fused.size // d0 if d0 else 0
        ranks = self.core.process_set_ranks(psid)
        my_pos = ranks.index(self.core.rank()) if self.core.rank() in ranks else 0
        base, extra = divmod(d0, n)
        slice_rows = [base + (1 if p < extra else 0) for p in range(n)]
        fused = self.core.reducescatter_buffer(
            fused, psid, wire_op, [r * row for r in slice_rows], wire)
        start = (my_pos * base + min(my_pos, extra)) * row
        mine = fused[start:start + slice_rows[my_pos] * row]
        if e.reduce_op == ReduceOp.AVERAGE:
            mine = _scale(mine, 1.0 / max(n, 1), wire)
        if e.postscale_factor != 1.0:
            mine = _scale(mine, e.postscale_factor, wire)
        e.result = mine.reshape((slice_rows[my_pos],) + e.array.shape[1:])


def _adasum_pair(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Scale-invariant pairwise combine (reference: adasum/adasum.h):
    adasum(a, b) = (1 - a.b/(2|a|^2)) a + (1 - a.b/(2|b|^2)) b."""
    dot = float(np.dot(a, b))
    na = max(float(np.dot(a, a)), 1e-300)
    nb = max(float(np.dot(b, b)), 1e-300)
    return (1.0 - dot / (2.0 * na)) * a + (1.0 - dot / (2.0 * nb)) * b


def _adasum_tree(vectors: np.ndarray) -> np.ndarray:
    """Pairwise-tree Adasum over rank-major rows; an odd row passes
    through to the next level."""
    rows = [vectors[i].ravel() for i in range(vectors.shape[0])]
    while len(rows) > 1:
        nxt = [_adasum_pair(rows[i], rows[i + 1])
               for i in range(0, len(rows) - 1, 2)]
        if len(rows) % 2:
            nxt.append(rows[-1])
        rows = nxt
    return rows[0]


def _contig(a: np.ndarray) -> np.ndarray:
    # np.ascontiguousarray promotes 0-d to 1-d; preserve scalar shape.
    return a.copy() if a.ndim == 0 else np.ascontiguousarray(a)


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as a contiguous host array (bf16 as uint16 bits)."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return _contig(t.view(torch.int16).numpy().view(np.uint16))
    return _contig(t.numpy())


def _to_host(array):
    """(host buffer, wire dtype, was_torch, torch dtype, torch device)."""
    if isinstance(array, torch.Tensor):
        return (_host_array(array), wire_dtype(array.dtype), True,
                array.dtype, array.device)
    arr = _contig(np.asarray(array))
    return arr, wire_dtype(arr.dtype), False, None, None


def _from_host(result, entry: TensorEntry):
    if isinstance(result, torch.Tensor) or not entry.was_torch:
        return result
    arr = np.ascontiguousarray(result)
    if entry.orig_dtype == torch.bfloat16:
        out = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        out = torch.from_numpy(arr.copy())
    return out.to(entry.orig_device)
