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

Offline, :func:`write_graphs` saves the recorded graphs' code
(``GraphModule.print_readable``), the counterpart of XLA's
``--xla_dump_to``, and :func:`inventory_from_text` inventories such a file
by the same rules as the walk, so ``horovod_tpu_torch.tools.hlo_report``
reads a compiled step after its run has ended.

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
import os
import re
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


def _group_name(node) -> Optional[str]:
    """The process group a functional collective names: its last string
    argument (None when it has none)."""
    for arg in reversed(list(node.args)):
        if isinstance(arg, str):
            return arg
    return None


def _resolved_size(name: Optional[str]) -> int:
    """The size of the live process group ``name`` (0 when it does not
    resolve)."""
    from torch.distributed import distributed_c10d as c10d

    if name is None:
        return 0
    try:
        return int(c10d._resolve_process_group(name).size())
    except Exception:
        return 0


def _group_size(node, default: int) -> int:
    """The size of the process group a functional collective names,
    ``default`` if it names none that resolves."""
    return _resolved_size(_group_name(node)) or max(1, int(default))


def _group_sizes(graphs) -> Dict[str, int]:
    """The size of each process group the graphs' functional collectives
    name, read while the groups are up."""
    sizes: Dict[str, int] = {}
    for g in graphs:
        for node in getattr(g, "graph", g).nodes:
            if _functional_kind(node) is None:
                continue
            name = _group_name(node)
            size = _resolved_size(name)
            if size:
                sizes[name] = size
    return sizes


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
# Offline: the graphs' printed code
# ---------------------------------------------------------------------------

# One assignment of the printed graph code: ``name[: "annotation"] = rhs``.
_ASSIGN_RE = re.compile(
    r'^\s*(?P<name>[A-Za-z_]\w*)(?:\s*:\s*"(?P<ann>[^"]*)")?\s*=\s*'
    r'(?P<rhs>.*)$')
_FUNCTIONAL_CALL_RE = re.compile(
    r'^torch\.ops\._c10d_functional\.(?P<op>\w+)\.\w+\((?P<args>.*)\)$')
_GETITEM_RE = re.compile(r'^(?P<src>[A-Za-z_]\w*)\[(?P<idx>\d+)\]$')
_ANNOTATION_RE = re.compile(r'^(?P<dtype>\w+)\[(?P<dims>[^\]]*)\]$')
_HEADER_RE = re.compile(r'^#\s*hlo_inspect:.*\bworld=(\d+)', re.M)
_GROUPS_RE = re.compile(r'^#\s*hlo_inspect:.*\bgroups=(\{.*\})\s*$', re.M)
_STRING_RE = re.compile(r'^([\'"])(?P<s>.*)\1$')
# The position of the group-size argument among a functional collective's
# arguments, for those that take one.
_SIZE_ARG = {"all_gather_into_tensor": 1,
             "all_gather_into_tensor_coalesced": 1,
             "reduce_scatter_tensor": 2,
             "reduce_scatter_tensor_coalesced": 2}


def _fx_dtypes() -> Dict[str, torch.dtype]:
    from torch.fx.graph import dtype_abbrs

    return {abbr: dt for dt, abbr in dtype_abbrs.items()}


def _split_args(args: str) -> List[str]:
    """Top-level comma-separated arguments of a printed call."""
    out, depth, cur = [], 0, []
    for ch in args:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        out.append("".join(cur).strip())
    return out


def _annotation_payload(ann: str, fx_dtypes) -> Tuple[str, int, int, str]:
    """(dtype, elements, bytes, shape) of one printed annotation such as
    ``f32[4, 3]``."""
    m = _ANNOTATION_RE.match(ann.strip())
    if m is None or m.group("dtype") not in fx_dtypes:
        raise ValueError(f"unreadable tensor annotation {ann!r}")
    dt = fx_dtypes[m.group("dtype")]
    dims = [d.strip() for d in m.group("dims").split(",") if d.strip()]
    if not all(d.isdigit() for d in dims):
        raise ValueError(f"symbolic shape {ann!r}: the inventory needs "
                         "static shapes")
    n = 1
    for d in dims:
        n *= int(d)
    name = _DTYPE_NAMES.get(dt, str(dt))
    return name, n, n * dt.itemsize, f"{name}[{','.join(dims)}]"


def module_partitions(text: str) -> int:
    """The world a :func:`write_graphs` file states in its header (0 when
    unstated), the counterpart of an HLO module's ``num_partitions``."""
    m = _HEADER_RE.search(text)
    return int(m.group(1)) if m else 0


def _header_groups(text: str) -> Dict[str, int]:
    """The group sizes a :func:`write_graphs` header states (empty when
    unstated)."""
    import json

    m = _GROUPS_RE.search(text)
    return ({str(k): int(v) for k, v in json.loads(m.group(1)).items()}
            if m else {})


def inventory_from_text(text: str, world: int = 0,
                        label: str = "") -> TraceInventory:
    """Inventory every functional collective in printed graph code (the
    text of ``GraphModule.print_readable(print_output=False)``), by the
    rules of :func:`inventory_from_graph`.

    Kind, dtype, shape and bytes come from each call's annotation (a
    ``_coalesced`` call's from the annotations of its ``getitem``
    outputs); a call that a ``wait_tensor`` completes, directly or
    through a ``getitem``, is asynchronous.  The group size is the size
    the :func:`write_graphs` header states for the group the call names
    (its last string argument), else the call's own size argument where
    it has one (all-gather, reduce-scatter) or its split list's length
    (all-to-all), else ``world``.  ``world`` defaults to the header's,
    then to the first collective's group size (1 when there is none)."""
    fx_dtypes = _fx_dtypes()
    groups = _header_groups(text)
    if world <= 0:
        world = module_partitions(text)
    anns: Dict[str, str] = {}
    items: Dict[str, List[Tuple[int, str]]] = {}
    waited: set = set()
    calls: List[Tuple[str, str, List[str]]] = []
    for line in text.splitlines():
        m = _ASSIGN_RE.match(line.split(";")[0].rstrip())
        if m is None:
            continue
        name, rhs = m.group("name"), m.group("rhs").strip()
        if m.group("ann") is not None:
            anns[name] = m.group("ann")
        g = _GETITEM_RE.match(rhs)
        if g is not None:
            items.setdefault(g.group("src"), []).append(
                (int(g.group("idx")), name))
            continue
        c = _FUNCTIONAL_CALL_RE.match(rhs)
        if c is None:
            continue
        args = _split_args(c.group("args"))
        if c.group("op") == "wait_tensor":
            waited.update(args[:1])
        elif c.group("op") in _FUNCTIONAL_KINDS:
            calls.append((name, c.group("op"), args))
    ops: List[CollectiveOp] = []
    for name, op, args in calls:
        kind = _FUNCTIONAL_KINDS[op]
        outs = ([n for _, n in sorted(items.get(name, []))]
                if op.endswith("_coalesced") else [name])
        vals = [_annotation_payload(anns[o], fx_dtypes)
                for o in outs if o in anns]
        if not vals:
            continue
        elements = sum(v[1] for v in vals)
        nbytes = sum(v[2] for v in vals)
        if elements == 0 and nbytes == 0:
            continue
        shape = (vals[0][3] if len(vals) == 1
                 else "(" + ", ".join(v[3] for v in vals) + ")")
        strings = [m.group("s") for m in map(_STRING_RE.match, args) if m]
        size = groups.get(strings[-1], 0) if strings else 0
        if not size and op in _SIZE_ARG and len(args) > _SIZE_ARG[op] \
                and args[_SIZE_ARG[op]].isdigit():
            size = int(args[_SIZE_ARG[op]])
        elif not size and kind == "all-to-all" and len(args) > 1 and \
                args[1].startswith("["):
            size = len(_split_args(args[1][1:-1]))
        size = size or max(1, world)
        raw = nbytes * size if kind == "reduce-scatter" else nbytes
        ops.append(CollectiveOp(
            kind=kind, name=name, dtype=vals[0][0], shape=shape,
            elements=elements, raw_bytes=raw, group_size=size,
            wire_bytes=ring_wire_bytes(kind, raw, size),
            asynchronous=any(o in waited for o in outs)))
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
# (label, world, graphs, group sizes) of each first call per signature,
# oldest first.
_RECORDED: List[Tuple[str, int, list, Dict[str, int]]] = []
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
        _RECORDED.clear()
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
        _record(name, graphs)
        if plane == "gspmd":
            note_inventory(inventory_from_graph(graphs, label=name))
        return out

    functools.update_wrapper(wrapper, fn)
    return wrapper


def _record(label: str, graphs: list) -> None:
    """Keep one first call's graphs, with the world their collectives
    span (Horovod's, else torch.distributed's default group's, 0 when
    neither is up) and the size of each group they name."""
    import torch.distributed as dist

    from .. import basics

    world = (basics.size() if basics.is_initialized()
             else dist.get_world_size() if dist.is_initialized() else 0)
    groups = _group_sizes(graphs)
    with _LOCK:
        _RECORDED.append((label, world, list(graphs), groups))
        del _RECORDED[:-_MAX_INVENTORIES]


def write_graphs(directory: str, label: Optional[str] = None) -> List[str]:
    """Write the code of every graph :func:`instrument` recorded (those of
    ``label`` only, when given) to ``directory``, one
    ``<label>.<n>.py`` file a graph: a header naming the label, the world
    and the size of each group the collectives name, then
    ``GraphModule.print_readable``'s text.  Returns the paths, in
    recording order; :func:`inventory_from_text` reads them back."""
    import json

    with _LOCK:
        recorded = [r for r in _RECORDED if label is None or r[0] == label]
    os.makedirs(directory, exist_ok=True)
    paths, n = [], 0
    for lab, world, graphs, groups in recorded:
        sizes = json.dumps(groups, sort_keys=True, separators=(",", ":"))
        for gm in graphs:
            path = os.path.join(directory, f"{lab}.{n}.py")
            n += 1
            header = (f"# hlo_inspect: label={lab} world={world} "
                      f"groups={sizes}\n")
            with open(path, "w", encoding="utf-8") as f:
                f.write(header + gm.print_readable(print_output=False))
            paths.append(path)
    return paths
