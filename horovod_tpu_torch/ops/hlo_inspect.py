"""Compiled-collective introspection for the gspmd data plane.

Port of ``horovod_tpu/ops/hlo_inspect.py``; it keeps the module's name so
a reader finds it, though there is no HLO here.  The gspmd plane
(``ops/gspmd_plane.py``) builds no collective: DTensor inserts the
all-reduces its pins need, so no enqueue, ring hop or byte counter of the
other planes ever fires.  The plane is visible in one place, the compiled
step.  The port's "compiled module" is the FX graphs AOTAutograd hands
the compiler when ``torch.compile`` compiles the step: forward, backward
and the graphs after each graph break.

Once per abstract-argument signature (never per step), an instrumented
step is compiled through a backend that records those graphs, and every
functional collective in them is inventoried: op kind (the reference's
names: all-reduce, all-gather, reduce-scatter, all-to-all; the
``_coalesced`` forms summed over their outputs; each ``wait_tensor``
skipped, as the reference skips ``-done``), element type, shape, group
size and analytic wire bytes under the ring model the other planes use:

- all-reduce:          ``2 * payload * (g - 1) / g``;
- all-gather / reduce-scatter / all-to-all: ``payload * (g - 1) / g``;
- collective-permute:  ``payload`` (no functional op maps to it).

``payload`` is the logical full-tensor byte count and ``g`` the group
size.  The inventory feeds the native core's gspmd byte counters
(``hvd.metrics()``, ``data_plane_stats()``, a type-16 flight event)
through :func:`set_native_sink`, and the step-trace plane tag.

``HOROVOD_HLO_INSPECT=0`` makes :func:`instrument` return its argument
unchanged.  Enabled, a step whose signature was seen costs one dict
lookup beside the compiled call.  Inspection is gated on the plane the
optimizer marked (:func:`mark_plane`), so an eager-plane step reports an
empty inventory.  XLA's ``cost_analysis`` has no counterpart: ``cost``
stays empty.
"""

from __future__ import annotations

import dataclasses
import operator
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..utils.env import get_bool

# Collective op kinds inventoried (the reference's HLO opcode names).
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "collective-permute", "all-to-all")

# Functional collectives (``torch.ops._c10d_functional``) by kind, as
# AOTAutograd hands them to the compiler (before Inductor's in-place
# rewrites).
_FUNCTIONAL_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# HLO element-type names of torch dtypes, so an inventory reads as the
# reference's does.
_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64",
    torch.complex128: "c128",
}


def enabled() -> bool:
    """The HOROVOD_HLO_INSPECT gate (default on): the live context's
    config when initialized, the environment otherwise."""
    from .. import basics

    if basics.is_initialized():
        return bool(basics._get().cfg.hlo_inspect_enabled)
    return get_bool("HOROVOD_HLO_INSPECT", True)


# ---------------------------------------------------------------------------
# Inventory model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CollectiveOp:
    """One compiler-inserted collective of a compiled step."""

    kind: str            # the reference's opcode name ("all-reduce", ...)
    name: str            # FX node name
    dtype: str           # element type of the first payload output
    shape: str           # result shape(s), printed as HLO prints them
    elements: int        # payload element count (summed over outputs)
    raw_bytes: int       # logical full-tensor bytes exchanged
    group_size: int      # process-group size g
    wire_bytes: int      # analytic ring-model wire bytes
    asynchronous: bool   # a wait_tensor completes it

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TraceInventory:
    """Every collective of one compiled gspmd-plane step."""

    label: str
    world: int
    ops: List[CollectiveOp]
    raw_bytes: int
    wire_bytes: int
    cost: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def collectives(self) -> int:
        return len(self.ops)

    def kind_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for op in self.ops:
            out[op.kind] = out.get(op.kind, 0) + 1
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {"label": self.label, "world": self.world,
                "collectives": self.collectives,
                "kinds": self.kind_counts(),
                "raw_bytes": self.raw_bytes,
                "wire_bytes": self.wire_bytes,
                "cost": dict(self.cost),
                "ops": [op.to_dict() for op in self.ops]}


def ring_wire_bytes(kind: str, raw_bytes: int, group_size: int) -> int:
    """Analytic per-rank wire bytes for one collective of ``raw_bytes``
    logical payload over a group of ``group_size`` (module docstring),
    in exact integer arithmetic, as the reference's."""
    g = max(1, int(group_size))
    raw = int(raw_bytes)
    if g <= 1:
        return 0
    if kind == "all-reduce":
        return (2 * raw * (g - 1)) // g
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return (raw * (g - 1)) // g
    return raw  # collective-permute: one full hop


def _functional_kind(node) -> Optional[str]:
    """The kind of a graph node calling a functional collective, else
    None (``wait_tensor`` and every other op)."""
    if node.op != "call_function":
        return None
    target = node.target
    packet = getattr(target, "overloadpacket", None)
    if packet is None or getattr(packet, "_qualified_op_name", "").split(
            "::")[0] != "_c10d_functional":
        return None
    return _FUNCTIONAL_KINDS.get(packet.__name__)


def _waited(node) -> bool:
    """Whether a ``wait_tensor`` completes the collective (on one of its
    outputs, for a coalesced one)."""
    for user in node.users:
        name = getattr(getattr(user.target, "overloadpacket", None),
                       "__name__", "")
        if name == "wait_tensor" or (user.target is operator.getitem
                                     and _waited(user)):
            return True
    return False


def _group_size(node, default: int) -> int:
    """The size of the process group a functional collective names (its
    last string argument), ``default`` if it names none that resolves."""
    from torch.distributed import distributed_c10d as c10d

    for arg in reversed(list(node.args)):
        if isinstance(arg, str):
            try:
                return c10d._resolve_process_group(arg).size()
            except Exception:
                break
    return max(1, int(default))


def _payload(val) -> Tuple[str, int, int, str]:
    """(dtype, elements, bytes, shape) of a node's output value, summed
    over the outputs of a coalesced collective."""
    vals = list(val) if isinstance(val, (list, tuple)) else [val]
    vals = [v for v in vals if isinstance(v, torch.Tensor)]
    if not vals:
        return "", 0, 0, ""
    shapes = [f"{_DTYPE_NAMES.get(v.dtype, str(v.dtype))}"
              f"[{','.join(str(int(d)) for d in v.shape)}]" for v in vals]
    shape = shapes[0] if len(shapes) == 1 else "(" + ", ".join(shapes) + ")"
    return (_DTYPE_NAMES.get(vals[0].dtype, str(vals[0].dtype)),
            sum(int(v.numel()) for v in vals),
            sum(int(v.numel()) * v.element_size() for v in vals), shape)


def inventory_from_graph(graphs, world: int = 0,
                         label: str = "") -> TraceInventory:
    """Walk FX graphs (GraphModules or Graphs) and inventory every
    functional collective in them.

    Each node's dtype and shape come from ``node.meta["val"]``, its group
    size from its group argument.  A reduce-scatter's payload is its
    output times the group, as the reference counts it.  ``world``
    defaults to the first collective's group size (1 when there is
    none)."""
    ops: List[CollectiveOp] = []
    for g in graphs:
        graph = getattr(g, "graph", g)
        for node in graph.nodes:
            kind = _functional_kind(node)
            if kind is None:
                continue
            dtype, elements, nbytes, shape = _payload(node.meta.get("val"))
            if elements == 0 and nbytes == 0:
                continue
            size = _group_size(node, world or 1)
            raw = nbytes * size if kind == "reduce-scatter" else nbytes
            asynchronous = _waited(node)
            ops.append(CollectiveOp(
                kind=kind, name=node.name, dtype=dtype, shape=shape,
                elements=elements, raw_bytes=raw, group_size=size,
                wire_bytes=ring_wire_bytes(kind, raw, size),
                asynchronous=asynchronous))
    if world <= 0:
        world = ops[0].group_size if ops else 1
    return TraceInventory(
        label=label, world=world, ops=ops,
        raw_bytes=sum(op.raw_bytes for op in ops),
        wire_bytes=sum(op.wire_bytes for op in ops))


# ---------------------------------------------------------------------------
# Counters and the native sink
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_RAW = 0
_WIRE = 0
_OPS = 0
_TRACES = 0
_INVENTORIES: List[TraceInventory] = []
_MAX_INVENTORIES = 32
_NATIVE_SINK: Optional[Callable[[int, int, int], None]] = None


def set_native_sink(fn: Optional[Callable[[int, int, int], None]]) -> None:
    """Forward (ops, raw, wire) of every inspected step to ``fn``: the
    native core's ``hvd_gspmd_plane_note``, so the inventory reaches
    ``hvd.metrics()``, Prometheus and the flight recorder.  None stops
    it."""
    global _NATIVE_SINK
    _NATIVE_SINK = fn


def note_inventory(inv: TraceInventory) -> None:
    """Record one inspected step: the counters here, the bounded ring of
    inventories and the native sink."""
    global _RAW, _WIRE, _OPS, _TRACES
    with _LOCK:
        _RAW += inv.raw_bytes
        _WIRE += inv.wire_bytes
        _OPS += inv.collectives
        _TRACES += 1
        _INVENTORIES.append(inv)
        del _INVENTORIES[:-_MAX_INVENTORIES]
    sink = _NATIVE_SINK
    if sink is not None:
        sink(int(inv.collectives), int(inv.raw_bytes), int(inv.wire_bytes))


def gspmd_byte_counters() -> Tuple[int, int]:
    """(raw, wire) analytic byte totals over every inspected step."""
    with _LOCK:
        return (_RAW, _WIRE)


def counters() -> Dict[str, int]:
    with _LOCK:
        return {"gspmd_collectives_total": _OPS, "gspmd_raw_bytes": _RAW,
                "gspmd_wire_bytes": _WIRE, "gspmd_traces_total": _TRACES}


def inventories() -> List[TraceInventory]:
    """The most recent inspected-step inventories, oldest first."""
    with _LOCK:
        return list(_INVENTORIES)


def reset() -> None:
    """Clear counters, inventories and the plane memo (tests)."""
    global _RAW, _WIRE, _OPS, _TRACES
    with _LOCK:
        _RAW = _WIRE = _OPS = _TRACES = 0
        _INVENTORIES.clear()
    _STEP_PLANE[0] = -2


# ---------------------------------------------------------------------------
# Plane coupling: the optimizer marks steps, instrument() gates on it
# ---------------------------------------------------------------------------

class _Trace:
    """The plane the optimizer marked last (None: not marked).  A plain
    object, not a thread-local: ``torch.compile`` replays an attribute
    store on it after the compiled graph runs."""

    plane: Optional[str] = None


_TRACE = _Trace()
_STEP_PLANE = [-2]  # last plane noted natively; -2 = never
_PLANE_IDS = {"eager": 0, "gspmd": 1}


def _note_step_plane(plane_id: int) -> None:
    if _STEP_PLANE[0] == plane_id:
        return
    _STEP_PLANE[0] = plane_id
    from ..context import HorovodContext

    inst = HorovodContext._instance
    if inst is not None:
        inst.core.step_trace_note_plane(plane_id)


def _note_plane(plane: Optional[str]) -> None:
    pid = _PLANE_IDS.get(plane, -1)
    if pid >= 0:
        _note_step_plane(pid)


def mark_plane(plane: str) -> None:
    """Called by DistributedOptimizer when a step resolves to a plane
    ("eager" / "gspmd"): tags the step (the gate of :func:`instrument`)
    and stamps the step-trace plane tag natively (once per change).
    Inside a compiled step the tag is a replayed attribute store, and
    :func:`instrument` stamps the native tag after the step returns."""
    _TRACE.plane = plane
    if not torch.compiler.is_compiling():
        _note_plane(plane)


def _begin_trace() -> None:
    _TRACE.plane = None


def _end_trace() -> Optional[str]:
    return _TRACE.plane


# ---------------------------------------------------------------------------
# Live inspection of compiled steps
# ---------------------------------------------------------------------------

class _Recorder:
    """A ``torch.compile`` backend that keeps every graph AOTAutograd hands
    the compiler (forward, backward, inference) while recording, then
    compiles it with Inductor, or with ``aot_eager``'s no-op."""

    def __init__(self, inner: str):
        if inner not in ("inductor", "aot_eager"):
            raise ValueError(f"instrument compiles over 'inductor' or "
                             f"'aot_eager', got {inner!r}")
        self.inner = inner
        self.graphs: Optional[list] = None

    def _keep(self, gm) -> None:
        if self.graphs is not None:
            self.graphs.append(gm)

    def __call__(self, gm, example_inputs):
        if self.inner == "inductor":
            from torch._inductor.compile_fx import compile_fx, \
                compile_fx_inner

            def inner_compile(g, *args, **kwargs):
                self._keep(g)
                return compile_fx_inner(g, *args, **kwargs)

            return compile_fx(gm, example_inputs, inner_compile=inner_compile)
        from torch._dynamo.backends.debugging import aot_eager, boxed_nop

        def nop(g, inputs):
            self._keep(g)
            return boxed_nop(g, inputs)

        return aot_eager(gm, example_inputs, fw_compiler=nop, bw_compiler=nop)


def _abstract_signature(args, kwargs) -> tuple:
    from torch.utils._pytree import tree_flatten

    leaves, spec = tree_flatten((args, kwargs))
    sig = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            placements = getattr(leaf, "placements", None)
            sig.append((tuple(leaf.shape), str(leaf.dtype), leaf.device.type,
                        None if placements is None else repr(placements)))
        else:
            sig.append(("py", repr(type(leaf))))
    return (str(spec), tuple(sig))


def instrument(fn, label: Optional[str] = None, backend: str = "inductor"):
    """Compile a train step with collective introspection.

    ``fn`` runs under ``torch.compile`` over ``backend`` ("inductor", or
    "aot_eager" where Inductor's compile time does not pay off, as in
    the CPU tests).  On the first call per abstract-argument signature
    the recorder keeps every graph compiled during that call (forward,
    backward, and each piece around a graph break), and when the
    optimizer marked the step "gspmd" their collectives are inventoried
    into :func:`note_inventory`.  Every later call with the same
    signature is a dict lookup followed by the compiled step.

    With HOROVOD_HLO_INSPECT=0 ``fn`` is returned unchanged."""
    if not enabled():
        return fn
    import functools

    recorder = _Recorder(backend)
    compiled = torch.compile(fn, backend=recorder)
    name = label or getattr(fn, "__name__", "step")
    seen: Dict[tuple, bool] = {}
    lock = threading.Lock()

    def wrapper(*args, **kwargs):
        key = _abstract_signature(args, kwargs)
        with lock:
            first = key not in seen
            seen[key] = True
        if not first:
            out = compiled(*args, **kwargs)
            _note_plane(_TRACE.plane)
            return out
        _begin_trace()
        recorder.graphs = []
        try:
            out = compiled(*args, **kwargs)
        finally:
            graphs, recorder.graphs = recorder.graphs, None
        plane = _end_trace()
        _note_plane(plane)
        if plane == "gspmd":
            note_inventory(inventory_from_graph(graphs, label=name))
        return out

    functools.update_wrapper(wrapper, fn)
    return wrapper
