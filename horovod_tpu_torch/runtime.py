"""The enqueue -> negotiate -> fuse -> execute spine (Python side).

Port of ``horovod_tpu/runtime.py`` (reference analogs: horovod/common/
operations.cc EnqueueTensorAllreduce / BackgroundThreadLoop /
RunLoopOnce, tensor_queue.cc, global_state.h):

- Framework threads *enqueue* named tensors and receive integer handles.
- A *core backend* (the native C++ library, or the pure-Python core when
  ``HOROVOD_CONTROLLER=python`` or ``HVD_TPU_PURE_PY=1`` asks for it) runs
  the background cycle loop: readiness negotiation across ranks, tensor
  fusion into buckets, the response cache, stall inspection.
- An *executor* pops fused responses from the core and runs the data
  plane: the device plane (``ops.device_plane``: NCCL, or gloo on the CPU)
  for responses negotiated ``device=True``, the core's host ring (TCP/shm)
  otherwise.
- ``synchronize(handle)`` blocks on completion; ``poll(handle)`` checks.

A response list is negotiated to be identical on every rank, including a
per-response ``device`` bit that is the AND of every rank's capability, so
every rank runs the same collective of the same bucket in the same order.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .utils.env import Config
from .utils.logging import get_logger
from .utils.timeline import Timeline
from .wire import DataType, OpType, ReduceOp

log = get_logger()

# Mirror of kProtocolVersion in csrc/core/socket_controller.cc: the two
# move together.
PROTOCOL_VERSION = 12


def compute_ctrl_tree(host_keys, mode: str = "auto", fanout: int = 32,
                      depth: int = 0) -> dict:
    """Pure-Python mirror of the C++ leader-tree topology (protocol v12).

    Mirrors ``SocketController::DecideCtrlTree`` + ``ComputeCtrlTree``:
    ranks are grouped by host key in first-appearance order over rank
    order, the first rank of each host is its leader, and rank 0 (when
    present) is always both the coordinator and its own host's leader.
    When the leader count exceeds ``fanout`` (mirror of
    ``HOROVOD_CTRL_TREE_FANOUT``), leaders are clustered under mid-level
    super-leaders, adding levels until every node's fan-in is at most
    ``fanout``; ``depth`` > 0 (mirror of ``HOROVOD_CONTROL_TREE_DEPTH``)
    forces an exact level count instead.

    ``host_keys`` is either a list (index = rank) or a dict
    ``{rank: key}`` — the dict form models re-election over survivors
    after ranks die (recompute with the dead ranks removed: the next
    rank on a dead leader's host is promoted, and a dead super-leader's
    cluster re-parents to whatever the fresh clustering assigns).

    Returns ``{"on": bool, "leaders": [rank...], "leader_of": {rank:
    leader}, "children_of": {leader: [rank...]}, "parent_of": {leader:
    parent-leader}, "agg_children": {leader: [leader...]}, "depth": int}``.
    ``parent_of`` maps every non-root leader to the node that gathers its
    aggregate (the coordinator or a super-leader); ``agg_children`` is
    the inverse adjacency.  When the engagement rule demotes to flat
    (single host; or "auto" with fewer than 8 ranks), ``on`` is False
    and the topology fields are empty.
    """
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"mode must be auto|on|off, got {mode!r}")
    if isinstance(host_keys, dict):
        items = sorted((int(r), str(k)) for r, k in host_keys.items())
    else:
        items = list(enumerate(str(k) for k in host_keys))
    n = len(items)
    off = {"on": False, "leaders": [], "leader_of": {}, "children_of": {},
           "parent_of": {}, "agg_children": {}, "depth": 0}
    if mode == "off" or n == 0:
        return off
    distinct = {k for _, k in items}
    if len(distinct) < 2:
        return off  # single host: the tree is pure overhead
    if mode == "auto" and n < 8:
        return off
    groups: List[List[int]] = []
    group_of: Dict[str, int] = {}
    for r, k in items:
        if k in group_of:
            groups[group_of[k]].append(r)
        else:
            group_of[k] = len(groups)
            groups.append([r])
    leaders = [g[0] for g in groups]
    leader_of = {r: g[0] for g in groups for r in g}
    children_of = {g[0]: g[1:] for g in groups}
    # Clustering pass (mirror of the C++ loop, including the balanced
    # integer split): `top` is the frontier still parented directly by the
    # root; each pass carves it into ceil(non_root / fanout) clusters and
    # promotes the first leader of each to a super-leader.
    fanout = max(2, int(fanout))
    parent_of: Dict[int, int] = {}
    top = list(leaders)
    root = top[0]
    levels = 1
    while True:
        non_root = len(top) - 1
        grow = (levels < depth - 1 and non_root > 1) if depth > 0 \
            else non_root > fanout
        if not grow:
            break
        n_clusters = (non_root + fanout - 1) // fanout
        nxt = [root]
        for c in range(n_clusters):
            lo = 1 + c * non_root // n_clusters
            hi = 1 + (c + 1) * non_root // n_clusters
            head = top[lo]
            nxt.append(head)
            for i in range(lo + 1, hi):
                parent_of[top[i]] = head
        top = nxt
        levels += 1
    for leader in top[1:]:
        parent_of[leader] = root
    agg_children: Dict[int, List[int]] = {}
    for leader in leaders:
        if leader in parent_of:
            agg_children.setdefault(parent_of[leader], []).append(leader)
    return {"on": True, "leaders": leaders, "leader_of": leader_of,
            "children_of": children_of, "parent_of": parent_of,
            "agg_children": agg_children, "depth": levels + 1}


@dataclasses.dataclass
class TensorEntry:
    """One enqueued collective (reference: TensorTableEntry, tensor_queue.h).

    ``array`` is the host buffer the host plane reads; for an entry the
    device plane adopted it is a zero-memory proxy of the tensor's shape
    and wire dtype, which is all negotiation needs."""

    handle: int
    name: str
    op: OpType
    array: np.ndarray
    dtype: DataType
    reduce_op: ReduceOp = ReduceOp.SUM
    root_rank: int = 0
    splits: Optional[np.ndarray] = None  # alltoall send splits (per-rank rows)
    process_set_id: int = 0
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    # Atomic grouped negotiation (reference: group_table.cc): members of a
    # group (same non-empty key) become ready all-or-nothing and are
    # emitted contiguously.
    group_key: str = ""
    group_size: int = 0
    # completion
    result: Any = None
    recv_splits: Optional[np.ndarray] = None  # alltoall receive splits
    error: Optional[str] = None
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    enqueued_at: float = dataclasses.field(default_factory=time.monotonic)
    # Round trip: a torch tensor handed to the host plane comes back as a
    # torch tensor of its dtype and device; a numpy array as numpy.
    was_torch: bool = False
    orig_dtype: Any = None
    orig_device: Any = None
    # Device-plane input: the tensor on the rank's device (None for host
    # entries), the source of the enqueue-side ``device`` bit.
    device_tensor: Any = None
    # In-place op: the result is written into ``device_tensor`` itself.
    inplace: bool = False
    # CUDA events: recorded on the caller's stream at enqueue (the
    # reference Horovod's ReadyEvent) and on the executor's stream after
    # the result is written.
    ready_event: Any = None
    done_event: Any = None


@dataclasses.dataclass
class FusedResponse:
    """A negotiated, fused unit of work (reference: Response, message.h).

    ``handles`` lists member tensors in the globally agreed order.  All
    ranks produce identical responses for the same cycle."""

    op: OpType
    dtype: DataType
    process_set_id: int
    handles: List[int]
    error: Optional[str] = None
    # Zero-participation metadata (hvd.join): per-member element counts so
    # a joined rank can walk the ring with zeros.
    counts: Optional[List[int]] = None
    last_joined: int = -1
    # Global data-op sequence tagging this response's wire frames.
    seq: int = -1
    # Whether THIS rank was joined when the dispatcher saw this response
    # (stamped in negotiated order, read by whichever lane finalizes it).
    joined_at_dispatch: bool = False
    # Negotiated data plane: True only when EVERY rank announced device
    # capability for every member (the coordinator ANDs the bits).
    device: bool = False


class CoreBackend:
    """Control-plane interface of the native core and the pure-Python core.

    Control plane: start/enqueue/pop_response/shutdown.  Host data plane
    (fused contiguous buffers): the ``*_buffer`` methods, identities in a
    single process, the C++ TCP/shm ring across processes."""

    name = "base"
    # True when responses for DIFFERENT process sets may be finalized on
    # concurrent executor lanes (per-set data channels, NativeCore).
    parallel_lanes = False

    def start(self, cfg: Config) -> None:
        raise NotImplementedError

    def set_current_seq(self, seq: int) -> None:
        """Tag the calling thread's next data-plane ops with ``seq``."""

    def shutdown(self) -> None:
        raise NotImplementedError

    def enqueue(self, entry: TensorEntry) -> None:
        raise NotImplementedError

    def pop_response(self, timeout: float) -> Optional[FusedResponse]:
        raise NotImplementedError

    def rank(self) -> int:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def add_process_set(self, ranks: Sequence[int],
                        weight: float = 1.0) -> int:
        raise NotImplementedError

    def remove_process_set(self, process_set_id: int) -> None:
        raise NotImplementedError

    def process_set_ranks(self, process_set_id: int) -> List[int]:
        raise NotImplementedError

    def allreduce_buffer(self, buf: np.ndarray, process_set_id: int,
                         reduce_op: ReduceOp,
                         dtype: Optional[DataType] = None) -> np.ndarray:
        raise NotImplementedError

    def reducescatter_buffer(self, buf: np.ndarray, process_set_id: int,
                             reduce_op: ReduceOp, slice_counts,
                             dtype: Optional[DataType] = None) -> np.ndarray:
        """On return this rank's slice of ``buf`` is fully reduced; other
        regions are unspecified.  Default: full allreduce."""
        return self.allreduce_buffer(buf, process_set_id, reduce_op, dtype)

    def allgather_buffer(self, buf: np.ndarray, process_set_id: int):
        """Returns (concatenated rows of all ranks, per-rank row counts)."""
        raise NotImplementedError

    def broadcast_buffer(self, buf: np.ndarray, root_rank: int,
                         process_set_id: int) -> np.ndarray:
        raise NotImplementedError

    def alltoall_buffer(self, buf: np.ndarray, splits: np.ndarray,
                        process_set_id: int):
        """Returns (received buffer, received splits)."""
        raise NotImplementedError

    def barrier(self, process_set_id: int) -> None:
        raise NotImplementedError

    def negotiation_stats(self) -> dict:
        """Cumulative negotiation ctrl-channel payload bytes (zero without
        a socket control plane)."""
        return {"ctrl_sent": 0, "ctrl_recv": 0}

    def ctrl_plane_stats(self) -> dict:
        """Cumulative control-plane frames and bytes (zero without a socket
        control plane)."""
        return {"ctrl_msgs_sent": 0, "ctrl_msgs_recv": 0,
                "ctrl_bytes_sent": 0, "ctrl_bytes_recv": 0}

    def metrics(self) -> dict:
        """The metrics registry as a dict; {} without the native one."""
        return {}

    def flight_record(self) -> dict:
        """The flight-recorder ring; {} without the native recorder."""
        return {}

    def step_trace(self) -> dict:
        """The step-trace ring; {} without the native tracer."""
        return {}

    def fleet_history(self) -> dict:
        """The fleet history; {} without the native telemetry plane."""
        return {}

    def step_trace_note_plane(self, plane: int) -> None:
        """Tag the step trace with the data plane running the steps; a
        no-op without the native tracer."""

    def start_timeline(self, path: str, mark_cycles: bool) -> None:
        raise NotImplementedError

    def stop_timeline(self) -> None:
        raise NotImplementedError


class _ProcessSetTable:
    """Shared process-set bookkeeping (reference: process_set.cc ProcessSetTable)."""

    def __init__(self, world_ranks: List[int]):
        self._lock = threading.Lock()
        self._sets: Dict[int, List[int]] = {0: list(world_ranks)}
        self._next_id = 1

    def add(self, ranks: Sequence[int]) -> int:
        ranks = sorted(set(int(r) for r in ranks))
        with self._lock:
            psid = self._next_id
            self._next_id += 1
            self._sets[psid] = ranks
            return psid

    def remove(self, psid: int) -> None:
        if psid == 0:
            raise ValueError("cannot remove the global process set")
        with self._lock:
            self._sets.pop(psid, None)

    def ranks(self, psid: int) -> List[int]:
        with self._lock:
            if psid not in self._sets:
                raise ValueError(f"unknown process set id {psid}")
            return list(self._sets[psid])

    def ids(self) -> List[int]:
        with self._lock:
            return list(self._sets)


class PyLocalCore(CoreBackend):
    """Pure-Python core for single-process mode, taken only when
    ``HOROVOD_CONTROLLER=python`` or ``HVD_TPU_PURE_PY=1`` asks for it.  Runs the same cycle loop: drain the tensor queue
    every ``cycle_time_ms``, fuse allreduces into buckets bounded by
    ``fusion_threshold_bytes``, emit responses in submission order, watch for
    stalls.  Reference analogs: operations.cc RunLoopOnce + controller.cc
    ComputeResponseList with a single rank.
    """

    name = "pylocal"

    def __init__(self):
        self._cfg: Optional[Config] = None
        self._queue: List[TensorEntry] = []
        self._queue_lock = threading.Lock()
        # entries enqueued but not yet covered by an emitted response —
        # the population the stall inspector watches (reference:
        # stall_inspector.cc tracks request-to-response latency per tensor)
        self._awaiting: Dict[int, TensorEntry] = {}
        self._responses: List[FusedResponse] = []
        self._resp_lock = threading.Lock()
        self._resp_cv = threading.Condition(self._resp_lock)
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._psets: Optional[_ProcessSetTable] = None
        self.timeline = Timeline()
        self._last_stall_warn = 0.0
        # Names already reported as stalled: a NEW stall always warns at
        # first detection; only repeats are rate-limited.  Completion
        # clears a name so a later stall of the same tensor warns afresh.
        self._stall_warned: set = set()

    def start(self, cfg: Config) -> None:
        self._cfg = cfg
        self._psets = _ProcessSetTable(list(range(cfg.size)))
        if cfg.timeline_path:
            self.timeline.start(cfg.timeline_path, cfg.timeline_mark_cycles)
        self._thread = threading.Thread(
            target=self._cycle_loop, name="hvd-background", daemon=True
        )
        self._thread.start()

    def shutdown(self) -> None:
        self._shutdown.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.timeline.stop()

    def start_timeline(self, path: str, mark_cycles: bool) -> None:
        self.timeline.start(path, mark_cycles)

    def stop_timeline(self) -> None:
        self.timeline.stop()

    def rank(self) -> int:
        return self._cfg.rank if self._cfg else 0

    def size(self) -> int:
        return self._cfg.size if self._cfg else 1

    def enqueue(self, entry: TensorEntry) -> None:
        self.timeline.begin(entry.name, f"NEGOTIATE_{entry.op.name}")
        with self._queue_lock:
            self._queue.append(entry)
            self._awaiting[entry.handle] = entry

    def pop_response(self, timeout: float) -> Optional[FusedResponse]:
        with self._resp_cv:
            if not self._responses:
                self._resp_cv.wait(timeout)
            if self._responses:
                return self._responses.pop(0)
            return None

    def add_process_set(self, ranks: Sequence[int],
                        weight: float = 1.0) -> int:
        # Single process: there is no coordinator schedule to weight.
        return self._psets.add(ranks)

    def remove_process_set(self, psid: int) -> None:
        self._psets.remove(psid)

    def process_set_ranks(self, psid: int) -> List[int]:
        return self._psets.ranks(psid)

    # Single-rank host data plane: collectives over one rank are identities.
    def allreduce_buffer(self, buf, psid, reduce_op, dtype=None):
        return buf

    def allgather_buffer(self, buf, psid):
        return buf, np.array([buf.shape[0]], dtype=np.int64)

    def broadcast_buffer(self, buf, root_rank, psid):
        return buf

    def alltoall_buffer(self, buf, splits, psid):
        return buf, np.asarray(splits, dtype=np.int64)

    def barrier(self, psid):
        return None

    # -- cycle loop ---------------------------------------------------------
    def _cycle_loop(self) -> None:
        cfg = self._cfg
        period = max(cfg.cycle_time_ms, 0.05) / 1000.0
        while not self._shutdown.is_set():
            time.sleep(period)
            self.timeline.mark_cycle()
            with self._queue_lock:
                pending, self._queue = self._queue, []
            if pending:
                responses = self._compute_responses(pending)
                with self._queue_lock:
                    for r in responses:
                        for h in r.handles:
                            done = self._awaiting.pop(h, None)
                            if done is not None:
                                self._stall_warned.discard(done.name)
                with self._resp_cv:
                    self._responses.extend(responses)
                    self._resp_cv.notify_all()
            self._check_stalls()

    def _compute_responses(self, pending: List[TensorEntry]) -> List[FusedResponse]:
        """Single-rank negotiation: everything enqueued is ready; fuse
        consecutive allreduces of matching (dtype, process set, reduce op)
        up to the fusion threshold — same bucketing rule the native
        controller uses.  Grouped tensors are held until their whole group
        has arrived, then released contiguously at the first member's
        arrival position (group_table.cc all-or-nothing analog — a grouped
        enqueue can race the cycle drain mid-call)."""
        held = getattr(self, "_held_groups", [])
        if not held and not any(e.group_key for e in pending):
            return self._fuse_ready(pending)
        work = held + pending
        gstate: Dict[str, List[int]] = {}
        for i, e in enumerate(work):
            if e.group_key:
                gstate.setdefault(e.group_key, []).append(i)
        still_held: List[TensorEntry] = []
        keyed: List[tuple] = []
        for i, e in enumerate(work):
            if not e.group_key:
                keyed.append(((i, i), e))
            elif len(gstate[e.group_key]) < e.group_size:
                still_held.append(e)
            else:
                keyed.append(((gstate[e.group_key][0], i), e))
        self._held_groups = still_held
        keyed.sort(key=lambda t: t[0])
        return self._fuse_ready([e for _, e in keyed])

    def _fuse_ready(self, pending: List[TensorEntry]) -> List[FusedResponse]:
        responses: List[FusedResponse] = []
        bucket: List[TensorEntry] = []
        bucket_bytes = 0

        def flush() -> None:
            nonlocal bucket, bucket_bytes
            if bucket:
                for e in bucket:
                    self.timeline.end(e.name, f"NEGOTIATE_{e.op.name}")
                responses.append(
                    FusedResponse(
                        op=OpType.ALLREDUCE,
                        dtype=bucket[0].dtype,
                        process_set_id=bucket[0].process_set_id,
                        handles=[e.handle for e in bucket],
                        device=bucket[0].device_tensor is not None,
                    )
                )
                bucket, bucket_bytes = [], 0

        for e in pending:
            if e.op == OpType.ALLREDUCE:
                nbytes = int(e.array.nbytes)
                fusable = (
                    bucket
                    and bucket[0].dtype == e.dtype
                    and bucket[0].process_set_id == e.process_set_id
                    and bucket[0].reduce_op == e.reduce_op
                    and bucket[0].prescale_factor == e.prescale_factor
                    and bucket[0].postscale_factor == e.postscale_factor
                    # device buckets stay pure (one data plane per response)
                    and ((bucket[0].device_tensor is None)
                         == (e.device_tensor is None))
                    and bucket_bytes + nbytes <= self._cfg.fusion_threshold_bytes
                )
                if not fusable:
                    flush()
                bucket.append(e)
                bucket_bytes += nbytes
            else:
                flush()
                self.timeline.end(e.name, f"NEGOTIATE_{e.op.name}")
                responses.append(
                    FusedResponse(
                        op=e.op,
                        dtype=e.dtype,
                        process_set_id=e.process_set_id,
                        handles=[e.handle],
                        # single process: this rank is trivially the last
                        # (and only) joiner
                        last_joined=0 if e.op == OpType.JOIN else -1,
                        device=e.device_tensor is not None,
                    )
                )
        flush()
        return responses

    def _check_stalls(self) -> None:
        cfg = self._cfg
        if not cfg.stall_check_enabled:
            return
        now = time.monotonic()
        # Snapshot + mark under ONE lock hold: a completion between two
        # separate sections could discard a name from _stall_warned only
        # for a stale re-add to suppress its next first-detection warning.
        with self._queue_lock:
            stalled = [e.name for e in self._awaiting.values()
                       if now - e.enqueued_at > cfg.stall_warning_s]
            if not stalled:
                return
            fresh = [n for n in stalled if n not in self._stall_warned]
            # Rate-limit REPEATS only: a tensor stalling for the first
            # time warns immediately even if an unrelated warning just
            # fired (reference: stall_inspector.cc reports per tensor,
            # not per window).
            if not fresh and now - self._last_stall_warn < cfg.stall_warning_s:
                return
            self._last_stall_warn = now
            self._stall_warned.update(stalled)
        log.warning(
            "Stall detected: %d tensor(s) waiting > %.0fs for negotiation: %s",
            len(stalled), cfg.stall_warning_s, ", ".join(stalled[:8]),
        )
