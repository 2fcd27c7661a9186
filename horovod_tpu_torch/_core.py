"""ctypes binding over the port's native core (``libhvd_core-<hash>.so``).

Port of ``horovod_tpu/_core.py`` (the reference's HorovodBasics ctypes
facade, horovod/common/basics.py).  The library is the port's own copy of
the C++ negotiation core, ``csrc/core/``, built at first use by
``ops/_build.py:build_core`` into ``horovod_tpu_torch/_build/``.  A failed
build raises with the compiler's output; nothing falls back quietly.
"""

from __future__ import annotations

import ctypes
import json
import threading
from typing import List, Optional, Sequence

import numpy as np

from .exceptions import HorovodInternalError
from .runtime import PROTOCOL_VERSION, CoreBackend, FusedResponse, TensorEntry
from .utils.env import Config, get_int
from .wire import DataType, OpType, ReduceOp, wire_dtype

_LOG_LEVELS = {"trace": 0, "debug": 1, "info": 2, "warning": 3, "error": 4,
               "fatal": 5}
# hvd_init's codec enums: host ring (wire_compression) and device plane
# (qdev), and the device ring schedule (qsched).
_HOST_CODECS = {"none": 0, "bf16": 1, "int8": 2, "int4": 3, "int8g": 4}
_DEVICE_CODECS = {"none": 0, "int8": 1, "int4": 2, "int8g": 3}
_SCHEDULES = {"ring": 0, "bidi": 1, "torus": 2}

_load_lock = threading.Lock()
_lib = None


def load_library() -> ctypes.CDLL:
    """The core library, built on first use and declared."""
    global _lib
    with _load_lock:
        if _lib is None:
            from .ops import _build

            lib = ctypes.CDLL(str(_build.build_core()))
            _declare(lib)
            _lib = lib
        return _lib


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.hvd_init.restype = c.c_int
    lib.hvd_init.argtypes = [
        c.c_int, c.c_int, c.c_int, c.c_int,        # rank size local_rank local_size
        c.c_char_p, c.c_char_p, c.c_int,           # controller addr port
        c.c_double, c.c_longlong, c.c_int, c.c_int,  # cycle fusion cache autotune
        c.c_char_p, c.c_int, c.c_int,              # autotune_log hierarchical wire_comp
        c.c_int,                                   # qdev_comp (-1 = no device plane)
        c.c_int,                                   # qdev_sched (-1 = ring-only plane)
        c.c_int, c.c_char_p, c.c_double,           # metrics metrics_file interval
        c.c_char_p, c.c_int,                       # timeline mark
        c.c_double, c.c_double, c.c_int,           # stall_warn stall_shutdown log
        c.c_int, c.c_int, c.c_char_p,              # flight_on flight_slots postmortem_dir
        c.c_int,                                   # autopilot_port (0 = off)
        c.c_int, c.c_int,                          # step_trace_on step_trace_slots
        c.c_int,                                   # data_plane (-1 = no gspmd mesh)
    ]
    lib.hvd_shutdown.restype = c.c_int
    lib.hvd_is_initialized.restype = c.c_int
    lib.hvd_rank.restype = c.c_int
    lib.hvd_size.restype = c.c_int
    lib.hvd_local_rank.restype = c.c_int
    lib.hvd_local_size.restype = c.c_int
    lib.hvd_enqueue.restype = c.c_longlong
    lib.hvd_enqueue.argtypes = [
        c.c_longlong, c.c_char_p, c.c_int, c.c_int, c.c_int, c.c_longlong,
        c.POINTER(c.c_longlong), c.c_int, c.c_int, c.c_int, c.c_double,
        c.c_double, c.POINTER(c.c_longlong), c.c_int, c.c_int, c.c_char_p,
        c.c_int,
    ]
    lib.hvd_pop_response.restype = c.c_int
    lib.hvd_pop_response.argtypes = [c.c_char_p, c.c_int, c.c_int]
    lib.hvd_allreduce_buffer.restype = c.c_int
    lib.hvd_allreduce_buffer.argtypes = [
        c.c_longlong, c.c_void_p, c.c_longlong, c.c_int, c.c_int, c.c_int]
    lib.hvd_reducescatter_buffer.restype = c.c_int
    lib.hvd_reducescatter_buffer.argtypes = [
        c.c_longlong, c.c_void_p, c.c_longlong, c.c_int, c.c_int, c.c_int,
        c.POINTER(c.c_longlong), c.c_int]
    lib.hvd_allgather_buffer.restype = c.c_int
    lib.hvd_allgather_buffer.argtypes = [
        c.c_longlong, c.c_void_p, c.c_longlong, c.c_int,
        c.POINTER(c.c_void_p), c.POINTER(c.c_longlong),
        c.POINTER(c.c_longlong), c.c_int, c.POINTER(c.c_int)]
    lib.hvd_broadcast_buffer.restype = c.c_int
    lib.hvd_broadcast_buffer.argtypes = [
        c.c_longlong, c.c_void_p, c.c_longlong, c.c_int, c.c_int]
    lib.hvd_alltoall_buffer.restype = c.c_int
    lib.hvd_alltoall_buffer.argtypes = [
        c.c_longlong, c.c_void_p, c.POINTER(c.c_longlong), c.c_int,
        c.c_longlong, c.c_int, c.POINTER(c.c_void_p),
        c.POINTER(c.c_longlong), c.POINTER(c.c_longlong), c.POINTER(c.c_int)]
    lib.hvd_barrier.restype = c.c_int
    lib.hvd_barrier.argtypes = [c.c_longlong, c.c_int]
    lib.hvd_free.argtypes = [c.c_void_p]
    lib.hvd_add_process_set.restype = c.c_int
    lib.hvd_add_process_set.argtypes = [c.POINTER(c.c_int), c.c_int]
    lib.hvd_add_process_set2.restype = c.c_int
    lib.hvd_add_process_set2.argtypes = [
        c.POINTER(c.c_int), c.c_int, c.c_double]
    lib.hvd_remove_process_set.restype = c.c_int
    lib.hvd_remove_process_set.argtypes = [c.c_int]
    lib.hvd_process_set_ranks.restype = c.c_int
    lib.hvd_process_set_ranks.argtypes = [c.c_int, c.POINTER(c.c_int), c.c_int]
    lib.hvd_negotiation_stats.argtypes = [
        c.POINTER(c.c_longlong), c.POINTER(c.c_longlong)]
    lib.hvd_data_plane_stats.argtypes = [
        c.POINTER(c.c_longlong), c.POINTER(c.c_longlong)]
    lib.hvd_data_plane_stats2.argtypes = [
        c.POINTER(c.c_longlong), c.POINTER(c.c_longlong),
        c.POINTER(c.c_longlong), c.POINTER(c.c_longlong)]
    lib.hvd_ctrl_plane_stats.argtypes = [
        c.POINTER(c.c_longlong), c.POINTER(c.c_longlong),
        c.POINTER(c.c_longlong), c.POINTER(c.c_longlong)]
    lib.hvd_start_timeline.argtypes = [c.c_char_p, c.c_int]
    lib.hvd_stop_timeline.argtypes = []
    lib.hvd_metrics_dump.restype = c.c_int
    lib.hvd_metrics_dump.argtypes = [c.c_char_p, c.c_int]
    lib.hvd_last_error.restype = c.c_char_p
    lib.hvd_flight_record.restype = c.c_int
    lib.hvd_flight_record.argtypes = [c.c_char_p, c.c_int]
    lib.hvd_step_trace.restype = c.c_int
    lib.hvd_step_trace.argtypes = [c.c_char_p, c.c_int]
    lib.hvd_fleet_history.restype = c.c_int
    lib.hvd_fleet_history.argtypes = [c.c_char_p, c.c_int]
    lib.hvd_fault_spec_check.restype = c.c_char_p
    lib.hvd_fault_spec_check.argtypes = [c.c_char_p]
    lib.hvd_device_plane_note.restype = None
    lib.hvd_device_plane_note.argtypes = [c.c_longlong, c.c_longlong]
    lib.hvd_device_plane_stats.restype = None
    lib.hvd_device_plane_stats.argtypes = [
        c.POINTER(c.c_longlong), c.POINTER(c.c_longlong)]
    lib.hvd_autotune_qdev.restype = c.c_int
    lib.hvd_autotune_qdev.argtypes = []
    lib.hvd_autotune_qsched.restype = c.c_int
    lib.hvd_autotune_qsched.argtypes = []
    lib.hvd_autotune_plane.restype = c.c_int
    lib.hvd_autotune_plane.argtypes = []
    lib.hvd_migrate_note.restype = None
    lib.hvd_migrate_note.argtypes = [c.c_int, c.c_longlong, c.c_int]
    lib.hvd_elastic_generation_set.restype = None
    lib.hvd_elastic_generation_set.argtypes = [c.c_longlong]
    lib.hvd_gspmd_plane_note.restype = None
    lib.hvd_gspmd_plane_note.argtypes = [
        c.c_longlong, c.c_longlong, c.c_longlong]
    lib.hvd_gspmd_plane_stats.restype = None
    lib.hvd_gspmd_plane_stats.argtypes = [
        c.POINTER(c.c_longlong), c.POINTER(c.c_longlong)]
    lib.hvd_step_trace_note_plane.restype = None
    lib.hvd_step_trace_note_plane.argtypes = [c.c_int]


class NativeCoreError(RuntimeError):
    pass


def check_fault_spec(spec: str) -> str:
    """Validate a ``HOROVOD_FAULT_INJECT`` spec against the core's parser:
    "" when it is well formed, else the message ``hvd.init()`` would fail
    with.  Loads (and on first use builds) the library; starts nothing."""
    msg = load_library().hvd_fault_spec_check(spec.encode())
    return msg.decode() if msg else ""


def _json_call(fn) -> dict:
    """Call a ``(buf, cap) -> n`` dump entry point, growing the buffer while
    it answers -2; {} when it answers 0 (plane off) or -1 (no core)."""
    cap = 1 << 16
    buf = ctypes.create_string_buffer(cap)
    n = fn(buf, cap)
    while n == -2:
        cap *= 4
        buf = ctypes.create_string_buffer(cap)
        n = fn(buf, cap)
    if n <= 0:
        return {}
    return json.loads(buf.raw[:n].decode())


class NativeCore(CoreBackend):
    """The C++ core as a CoreBackend: negotiation, fusion, the response
    cache, stall inspection and the host data plane run natively; Python
    packs buffers and runs the device plane."""

    name = "native"
    # Per-process-set data channels exist in the socket controller, so
    # responses for different sets may run on concurrent executor lanes.
    parallel_lanes = True

    def __init__(self):
        self._lib = load_library()
        self._cfg: Optional[Config] = None
        self._seq_tls = threading.local()
        self._resp_cap = 1 << 16
        self._resp_buf = ctypes.create_string_buffer(self._resp_cap)

    # -- lifecycle ----------------------------------------------------------
    def start(self, cfg: Config) -> None:
        """Start the core for ``cfg``; above one rank its coordinator meets
        the others at ``cfg.rendezvous_addr:cfg.rendezvous_port``."""
        from .ops.collectives import resolve_device_schedule

        self._cfg = cfg
        controller = cfg.controller
        if controller == "auto":
            controller = "socket" if cfg.size > 1 else "local"
        # The device plane's codec comes from config; the schedule arm is
        # pinned (-1) below 4 ranks, where only the plain ring is feasible.
        # The compiler data plane does not exist in the port: pinned.
        qdev = _DEVICE_CODECS.get(cfg.wire_compression_device, 0)
        qsched = _SCHEDULES[resolve_device_schedule(cfg.size,
                                                    cfg.device_schedule)]
        if cfg.size < 4:
            qsched = -1
        plane = -1
        rc = self._lib.hvd_init(
            cfg.rank, cfg.size, cfg.local_rank, cfg.local_size,
            controller.encode(), cfg.rendezvous_addr.encode(),
            cfg.rendezvous_port, cfg.cycle_time_ms,
            cfg.fusion_threshold_bytes, cfg.cache_capacity,
            1 if cfg.autotune else 0,
            (cfg.autotune_log or "").encode(),
            1 if cfg.hierarchical_allreduce else 0,
            _HOST_CODECS.get(cfg.wire_compression, 0),
            qdev, qsched,
            1 if cfg.metrics_enabled else 0,
            (cfg.metrics_file or "").encode(),
            cfg.metrics_interval_s,
            (cfg.timeline_path or "").encode(),
            1 if cfg.timeline_mark_cycles else 0,
            cfg.stall_warning_s if cfg.stall_check_enabled else 0.0,
            cfg.stall_shutdown_s,
            _LOG_LEVELS.get(cfg.log_level, 3),
            1 if cfg.flight_recorder_enabled else 0,
            cfg.flight_recorder_slots,
            (cfg.postmortem_dir or "").encode(),
            cfg.autopilot_port,
            1 if cfg.step_trace_enabled else 0,
            cfg.step_trace_slots,
            plane,
        )
        if rc != 0:
            raise NativeCoreError(
                f"native core init failed (rc={rc}, control protocol "
                f"v{PROTOCOL_VERSION}): {self._last_error()}")
        # The elastic generation a launcher assigned (0 outside elastic
        # jobs) as the hvd_elastic_generation gauge, and the quantized
        # collectives' wire bytes into the metrics registry.
        self._lib.hvd_elastic_generation_set(
            get_int("HOROVOD_ELASTIC_GENERATION", 0))
        from .ops import quantize

        quantize.set_native_byte_sink(self._lib.hvd_device_plane_note)

    def step_trace_note_plane(self, plane: int) -> None:
        """Tag the step-trace ring with the data plane running the steps
        (-1 unknown, 0 eager, 1 gspmd)."""
        self._lib.hvd_step_trace_note_plane(int(plane))

    def shutdown(self) -> None:
        from .ops import quantize

        quantize.set_native_byte_sink(None)
        if self._lib.hvd_is_initialized():
            self._lib.hvd_shutdown()

    def _last_error(self) -> str:
        msg = self._lib.hvd_last_error()
        return msg.decode() if msg else "unknown"

    def rank(self) -> int:
        return self._lib.hvd_rank()

    def size(self) -> int:
        return self._lib.hvd_size()

    # -- control plane ------------------------------------------------------
    def enqueue(self, entry: TensorEntry) -> None:
        shape = (ctypes.c_longlong * max(len(entry.array.shape), 1))(
            *entry.array.shape)
        if entry.splits is not None:
            splits = (ctypes.c_longlong * len(entry.splits))(
                *[int(s) for s in entry.splits])
            nsplits = len(entry.splits)
        else:
            splits = None
            nsplits = 0
        rc = self._lib.hvd_enqueue(
            entry.handle, entry.name.encode(), int(entry.op),
            int(entry.dtype), int(entry.reduce_op), entry.array.nbytes,
            shape, len(entry.array.shape), entry.process_set_id,
            entry.root_rank, entry.prescale_factor, entry.postscale_factor,
            splits, nsplits, 1 if entry.device_tensor is not None else 0,
            entry.group_key.encode(), entry.group_size)
        if rc == -2:
            raise ValueError(f"duplicate in-flight tensor name {entry.name!r}")
        if rc != 0:
            raise NativeCoreError(f"enqueue failed rc={rc}")

    def pop_response(self, timeout: float) -> Optional[FusedResponse]:
        n = self._lib.hvd_pop_response(self._resp_buf, self._resp_cap,
                                       int(timeout * 1000))
        while n == -2:  # buffer too small: the response stays queued; grow
            self._resp_cap *= 4
            self._resp_buf = ctypes.create_string_buffer(self._resp_cap)
            n = self._lib.hvd_pop_response(self._resp_buf, self._resp_cap, 0)
        if n <= 0:
            return None
        obj = json.loads(self._resp_buf.raw[:n].decode())
        return FusedResponse(
            op=OpType(obj["op"]),
            dtype=DataType(obj["dtype"]),
            process_set_id=obj["psid"],
            handles=list(obj["handles"]),
            error=obj["error"] or None,
            counts=obj.get("counts"),
            last_joined=obj.get("last_joined", -1),
            seq=obj.get("seq", -1),
            device=bool(obj.get("device", 0)),
        )

    def set_current_seq(self, seq: int) -> None:
        # thread-local: each executor lane tags its own collective's
        # frames (the C++ side mirrors this with a thread_local).
        self._seq_tls.seq = int(seq)

    @property
    def _current_seq(self) -> int:
        return getattr(self._seq_tls, "seq", -1)

    # -- process sets -------------------------------------------------------
    def add_process_set(self, ranks: Sequence[int],
                        weight: float = 1.0) -> int:
        arr = (ctypes.c_int * len(ranks))(*[int(r) for r in ranks])
        if weight != 1.0:
            psid = self._lib.hvd_add_process_set2(arr, len(ranks),
                                                  float(weight))
        else:
            psid = self._lib.hvd_add_process_set(arr, len(ranks))
        if psid < 0:
            raise NativeCoreError("add_process_set failed")
        return psid

    def remove_process_set(self, process_set_id: int) -> None:
        self._lib.hvd_remove_process_set(process_set_id)

    def process_set_ranks(self, process_set_id: int) -> List[int]:
        cap = max(self.size(), 1)
        out = (ctypes.c_int * cap)()
        n = self._lib.hvd_process_set_ranks(process_set_id, out, cap)
        if n < 0:
            raise ValueError(f"unknown process set id {process_set_id}")
        return [out[i] for i in range(n)]

    # -- host data plane ----------------------------------------------------
    def _check(self, rc: int, what: str) -> None:
        if rc != 0:
            raise HorovodInternalError(
                f"{what} failed (rc={rc}): {self._last_error()}")

    def allreduce_buffer(self, buf: np.ndarray, psid: int,
                         reduce_op: ReduceOp,
                         dtype: Optional[DataType] = None) -> np.ndarray:
        """In place.  ``dtype`` names the elements where the buffer's own
        dtype does not (bf16 crosses as its uint16 bits)."""
        buf = np.ascontiguousarray(buf)
        rc = self._lib.hvd_allreduce_buffer(
            self._current_seq, buf.ctypes.data_as(ctypes.c_void_p), buf.size,
            int(dtype if dtype is not None else wire_dtype(buf.dtype)),
            int(reduce_op), psid)
        self._check(rc, "allreduce")
        return buf

    def reducescatter_buffer(self, buf: np.ndarray, psid: int,
                             reduce_op: ReduceOp, slice_counts,
                             dtype: Optional[DataType] = None) -> np.ndarray:
        """In-place ring reduce-scatter: on return this rank's slice
        (slice_counts[my_pos] elements at its offset) is fully reduced;
        the rest of buf is unspecified."""
        buf = np.ascontiguousarray(buf)
        arr = (ctypes.c_longlong * len(slice_counts))(*slice_counts)
        rc = self._lib.hvd_reducescatter_buffer(
            self._current_seq, buf.ctypes.data_as(ctypes.c_void_p), buf.size,
            int(dtype if dtype is not None else wire_dtype(buf.dtype)),
            int(reduce_op), psid, arr, len(slice_counts))
        self._check(rc, "reducescatter")
        return buf

    def allgather_buffer(self, buf: np.ndarray, psid: int):
        buf = np.ascontiguousarray(buf)
        d0 = buf.shape[0] if buf.ndim else 1
        row_bytes = (buf.nbytes // d0) if d0 > 0 else int(
            np.prod(buf.shape[1:], dtype=np.int64) * buf.itemsize) or buf.itemsize
        out_ptr = ctypes.c_void_p()
        out_len = ctypes.c_longlong()
        cap = max(self.size(), 1)
        counts = (ctypes.c_longlong * cap)()
        n_counts = ctypes.c_int()
        rc = self._lib.hvd_allgather_buffer(
            self._current_seq, buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes,
            psid, ctypes.byref(out_ptr), ctypes.byref(out_len), counts, cap,
            ctypes.byref(n_counts))
        self._check(rc, "allgather")
        try:
            flat = np.empty(out_len.value // buf.itemsize, dtype=buf.dtype)
            if out_len.value:
                ctypes.memmove(flat.ctypes.data, out_ptr, out_len.value)
        finally:
            self._lib.hvd_free(out_ptr)
        rows = flat.size // (row_bytes // buf.itemsize) if row_bytes else 0
        stacked = flat.reshape(rows, -1) if rows else flat.reshape(0, 1)
        row_counts = np.array(
            [counts[i] // row_bytes for i in range(n_counts.value)],
            dtype=np.int64)
        return stacked, row_counts

    def broadcast_buffer(self, buf: np.ndarray, root_rank: int,
                         psid: int) -> np.ndarray:
        buf = np.ascontiguousarray(buf).copy()
        rc = self._lib.hvd_broadcast_buffer(
            self._current_seq, buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes,
            root_rank, psid)
        self._check(rc, "broadcast")
        return buf

    def alltoall_buffer(self, buf: np.ndarray, splits: np.ndarray,
                        psid: int):
        buf = np.ascontiguousarray(buf)
        d0 = buf.shape[0] if buf.ndim else 1
        row_bytes = (buf.nbytes // d0) if d0 > 0 else buf.itemsize
        csplits = (ctypes.c_longlong * len(splits))(*[int(s) for s in splits])
        out_ptr = ctypes.c_void_p()
        out_len = ctypes.c_longlong()
        cap = max(len(splits), 1)
        recv = (ctypes.c_longlong * cap)()
        n_recv = ctypes.c_int()
        rc = self._lib.hvd_alltoall_buffer(
            self._current_seq, buf.ctypes.data_as(ctypes.c_void_p), csplits,
            len(splits), row_bytes, psid, ctypes.byref(out_ptr),
            ctypes.byref(out_len), recv, ctypes.byref(n_recv))
        self._check(rc, "alltoall")
        try:
            flat = np.empty(out_len.value // buf.itemsize, dtype=buf.dtype)
            if out_len.value:
                ctypes.memmove(flat.ctypes.data, out_ptr, out_len.value)
        finally:
            self._lib.hvd_free(out_ptr)
        recv_splits = np.array([recv[i] for i in range(n_recv.value)],
                               dtype=np.int64)
        total_rows = int(recv_splits.sum())
        out = flat.reshape(total_rows, -1) if total_rows else flat.reshape(0, 1)
        return out, recv_splits

    def barrier(self, process_set_id: int) -> None:
        rc = self._lib.hvd_barrier(self._current_seq, process_set_id)
        self._check(rc, "barrier")

    # -- observability ------------------------------------------------------
    def negotiation_stats(self) -> dict:
        """Cumulative negotiation ctrl-channel payload bytes of this rank
        (response-cache hits travel as 16-byte (id, handle) pairs instead
        of full request metadata)."""
        sent = ctypes.c_longlong()
        recv = ctypes.c_longlong()
        self._lib.hvd_negotiation_stats(ctypes.byref(sent),
                                        ctypes.byref(recv))
        return {"ctrl_sent": sent.value, "ctrl_recv": recv.value}

    def ctrl_plane_stats(self) -> dict:
        """Cumulative negotiation frames and payload bytes this rank sent
        and received on the control plane."""
        vals = [ctypes.c_longlong() for _ in range(4)]
        self._lib.hvd_ctrl_plane_stats(*map(ctypes.byref, vals))
        return dict(zip(("ctrl_msgs_sent", "ctrl_msgs_recv",
                         "ctrl_bytes_sent", "ctrl_bytes_recv"),
                        (v.value for v in vals)))

    def data_plane_stats(self) -> dict:
        """Cumulative host-ring bytes this rank sent (on the wire and before
        the host codec), to ranks on this host and across hosts."""
        vals = [ctypes.c_longlong() for _ in range(4)]
        self._lib.hvd_data_plane_stats2(*map(ctypes.byref, vals))
        return dict(zip(("data_sent_local", "data_sent_xhost",
                         "data_raw_local", "data_raw_xhost"),
                        (v.value for v in vals)))

    def metrics(self) -> dict:
        """The metrics registry as a dict: counters, gauges and
        power-of-two-bucket histograms; on the coordinator also the
        cluster view and the straggler report.  Under ``HOROVOD_METRICS``
        off, ``enabled`` is False and the core's counters stay 0."""
        return _json_call(self._lib.hvd_metrics_dump)

    def flight_record(self) -> dict:
        """This rank's flight-recorder ring: ``rank``, ``host``, ``slots``,
        ``dropped``, ``types`` (the event-type legend) and ``events`` as
        ``[ts_us, seq, type, tid, a, b]`` rows, oldest first.  {} when
        ``HOROVOD_FLIGHT_RECORDER=off``."""
        return _json_call(self._lib.hvd_flight_record)

    def step_trace(self) -> dict:
        """This rank's step-trace ring: ``schema``, ``rank``, ``world``,
        ``phases`` and ``steps`` as ``[step, start_us, end_us, <5 phase
        us>]`` rows; rank 0 adds ``fleet``.  {} when
        ``HOROVOD_STEP_TRACE=off``."""
        return _json_call(self._lib.hvd_step_trace)

    def fleet_history(self) -> dict:
        """The coordinator's fleet history and anomaly log
        (``fleethistory-v1``); {} before its first tick, on other ranks, or
        when ``HOROVOD_FLEET_TELEMETRY=off``."""
        return _json_call(self._lib.hvd_fleet_history)

    def start_timeline(self, path: str, mark_cycles: bool) -> None:
        self._lib.hvd_start_timeline(path.encode(), 1 if mark_cycles else 0)

    def stop_timeline(self) -> None:
        self._lib.hvd_stop_timeline()
