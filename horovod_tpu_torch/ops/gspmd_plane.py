"""The compiler data plane: DTensor gradients pinned replicated.

Port of ``horovod_tpu/ops/gspmd_plane.py``.  Next to the eager plane
(``optimizer.py``'s grad hooks over the negotiated spine), this plane
builds no collective of its own.  Parameters are replicated DTensors
(``torch.distributed.tensor``) on a named ``DeviceMesh``, the batch is a
``Shard(0)`` DTensor, and the loss is the global mean, so backprop leaves
each gradient ``Partial``: the sum over ranks is the global gradient.  The
optimizer then pins every fp32 gradient replicated
(``redistribute(mesh, [Replicate()])``, the counterpart of
``with_sharding_constraint``), and DTensor inserts the all-reduce.  Under
``torch.compile`` that all-reduce is a functional collective
(``_c10d_functional.all_reduce`` + ``wait_tensor``) inside the compiled
step, which Inductor schedules with the optimizer's arithmetic and
``ops/hlo_inspect.py`` inventories.

Demotion contract, as the reference's: a plane request that cannot
compose falls back to the eager plane deterministically and
bit-identically, and every demotion increments a named counter here
(``plane_counters()``).

Demotion reasons:

- ``world1``    -- the mesh has a single rank; there is nothing to reduce.
- ``quantized`` -- a ``device=<codec>`` compression is active: the quantized
                   rings are explicit programs the compiled step cannot
                   schedule, so the optimizer stays eager end to end.
- ``dtype``     -- a non-fp32 leaf (per leaf): it is not pinned and passes
                   through untouched; DTensor reduces it where an op needs
                   its value (the same values, no pin).

The reference's ``no_jax`` reason has no counterpart: DTensor ships with
torch.  ``devices`` arguments take ranks where the reference takes jax
devices, and every mesh spans ranks of the process group ``hvd.init()``
formed, on its device type.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

BATCH_AXIS = "batch"
MODEL_AXIS = "model"

_LOCK = threading.Lock()
_COUNTERS: Dict[str, int] = {}


def _bump(reason: str) -> None:
    with _LOCK:
        _COUNTERS[reason] = _COUNTERS.get(reason, 0) + 1


def note_demotion(reason: str) -> None:
    """Record a demotion decided outside this module (the optimizer's own:
    accumulation, process sets, predivide, ZeRO-1 sharding)."""
    _bump(reason)


def plane_counters() -> Dict[str, int]:
    """Snapshot of the selection and demotion counters: ``gspmd``
    (optimizers that resolved to this plane), ``demote_world1`` /
    ``demote_quantized`` (per optimizer), ``demote_dtype`` (per non-fp32
    leaf, once per optimizer) and the optimizer's own reasons."""
    with _LOCK:
        return dict(_COUNTERS)


def reset_plane_counters() -> None:
    with _LOCK:
        _COUNTERS.clear()


# ---------------------------------------------------------------------------
# Mesh construction
# ---------------------------------------------------------------------------

def _model_factors(n: int) -> Tuple[int, int]:
    """(batch, model) factorization for a 2-D mesh over ``n`` ranks,
    degrading the model axis as ranks run out: 8+ keep 2-way batch and
    give the rest to model, 4+ go 2x2, 2 go 1x2, one collapses to 1x1."""
    if n >= 8:
        return 2, n // 2
    if n >= 4:
        return 2, 2
    if n >= 2:
        return 1, 2
    return 1, 1


def build_gspmd_mesh(devices: Optional[Sequence[int]] = None,
                     model_parallel: bool = False):
    """``DeviceMesh`` for this plane: 1-D ``batch`` over every rank by
    default, or 2-D ``batch`` x ``model``.  ``devices`` lists ranks (the
    reference's jax devices).  The mesh lies on the device type of
    ``hvd.init()``'s device.  The whole world in order is the caller's
    process group (``basics.caller_group``), which this plane's
    collectives then run on; any other list forms groups of its own, so
    every rank must make the same call."""
    from torch.distributed.device_mesh import DeviceMesh

    from .. import basics

    world = basics.size()
    device_type = basics.device().type
    ranks = list(range(world)) if devices is None else [int(r) for r in
                                                        devices]
    if not model_parallel:
        if ranks == list(range(world)):
            return DeviceMesh.from_group(basics.caller_group(), device_type,
                                         mesh_dim_names=(BATCH_AXIS,))
        return DeviceMesh(device_type, ranks, mesh_dim_names=(BATCH_AXIS,))
    b, m = _model_factors(len(ranks))
    grid = torch.tensor(ranks[:b * m], dtype=torch.int).reshape(b, m)
    return DeviceMesh(device_type, grid,
                      mesh_dim_names=(BATCH_AXIS, MODEL_AXIS))


# ---------------------------------------------------------------------------
# Sharding-tree utilities
# ---------------------------------------------------------------------------

def _axis_size(mesh, name: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def batch_pspec(leaf, mesh) -> list:
    """Placements sharding ``leaf``'s leading dim over the batch axis when
    it divides evenly (``Shard(0)`` there, ``Replicate()`` on the other
    axes), replicated otherwise: a dim the axis does not divide is never
    padded."""
    from torch.distributed.tensor import Replicate, Shard

    n = _axis_size(mesh, BATCH_AXIS)
    shape = tuple(getattr(leaf, "shape", ()))
    names = mesh.mesh_dim_names or ()
    if len(shape) >= 1 and n > 1 and shape[0] % n == 0:
        return [Shard(0) if name == BATCH_AXIS else Replicate()
                for name in names]
    return [Replicate()] * mesh.ndim


def tree_pspecs(tree, mesh):
    """A tree of placement lists mirroring ``tree`` (the rule of
    :func:`batch_pspec`)."""
    from torch.utils._pytree import tree_map

    return tree_map(lambda leaf: batch_pspec(leaf, mesh), tree)


def tree_shardings(tree, mesh):
    """``tree`` distributed by the rule of :func:`batch_pspec`: each tensor
    leaf as a DTensor on ``mesh`` (this rank's shard of it), the form a
    compiled step takes its batch in.  Every rank passes the same full
    tensors."""
    from torch.distributed.tensor import distribute_tensor
    from torch.utils._pytree import tree_map

    def one(leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute_tensor(leaf, mesh, batch_pspec(leaf, mesh))

    return tree_map(one, tree)


def replicated_sharding(mesh) -> list:
    """Placements replicating a leaf over the whole mesh: the pin the
    optimizer puts on gradients."""
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


# ---------------------------------------------------------------------------
# The pin
# ---------------------------------------------------------------------------

def constrain_grad_leaf(leaf, mesh, count: bool = True):
    """Pin one gradient replicated over ``mesh``: a ``Partial`` fp32
    DTensor is all-reduced there.  A non-fp32 leaf is not pinned
    (``demote_dtype``, counted unless ``count`` is False) and passes
    through untouched."""
    if getattr(leaf, "dtype", None) != torch.float32:
        if count:
            _bump("demote_dtype")
        return leaf
    return pin_replicated(leaf, mesh)


def pin_replicated(leaf, mesh):
    """``leaf.redistribute(mesh, [Replicate()] * mesh.ndim)`` for a DTensor
    that is ``Partial`` or replicated on each mesh dim, written as the
    functional all-reduces it takes (``torch.compile`` keeps these in the
    step's graph; a ``Partial("avg")`` dim sums, then divides).  Any other
    placement redistributes through DTensor."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial

    if any(not (isinstance(p, Partial) and p.reduce_op in ("sum", "avg"))
           and not p.is_replicate() for p in leaf.placements):
        return leaf.redistribute(mesh, replicated_sharding(mesh))
    local = leaf.to_local()
    for dim, p in enumerate(leaf.placements):
        if isinstance(p, Partial):
            local = funcol.all_reduce(local, "sum", (mesh, dim))
            if p.reduce_op == "avg":
                local = local / mesh.size(dim)
    return DTensor.from_local(local, mesh, replicated_sharding(mesh),
                              run_check=False)


def constrain_grads(grads, mesh):
    """Pin every fp32 leaf of a gradient tree replicated (see
    :func:`constrain_grad_leaf`)."""
    from torch.utils._pytree import tree_map

    return tree_map(lambda leaf: constrain_grad_leaf(leaf, mesh), grads)


# ---------------------------------------------------------------------------
# Plane resolution
# ---------------------------------------------------------------------------

def default_mesh():
    """The mesh the optimizer pins against when the caller passes none:
    the 1-D batch mesh over every rank, or None before ``hvd.init()``
    (a world of one)."""
    from .. import basics

    if not basics.is_initialized():
        return None
    return build_gspmd_mesh()


def data_plane_default() -> str:
    """The configured plane request: the live context's
    ``Config.data_plane`` when initialized, else HOROVOD_DATA_PLANE."""
    from .. import basics
    from ..utils.env import get_data_plane

    if basics.is_initialized():
        return basics._get().cfg.data_plane

    return get_data_plane()


def resolve_plane(request: Optional[str] = None, mesh=None,
                  device_codec: Optional[str] = None,
                  count: bool = True) -> Tuple[str, Any]:
    """Resolve a plane request to ``("eager", None)`` or
    ``("gspmd", mesh)``.

    ``request`` is ``auto`` / ``eager`` / ``gspmd`` (None reads
    HOROVOD_DATA_PLANE).  Demotions are deterministic in the mesh size
    and the codec, so every rank resolves the same way, and each bumps
    its counter.  An explicit ``eager`` is a choice, not a demotion: no
    counter.  ``count=False`` resolves silently (the ``auto`` probe of
    every optimizer construction)."""
    if request is None:
        request = data_plane_default()
    request = (request or "auto").strip().lower()
    bump = _bump if count else (lambda reason: None)
    if request == "eager":
        return "eager", None
    if device_codec is not None and device_codec != "none":
        bump("demote_quantized")
        return "eager", None
    if mesh is None:
        mesh = default_mesh()
    if mesh is None or mesh.size() < 2:
        bump("demote_world1")
        return "eager", None
    bump("gspmd")
    return "gspmd", mesh
