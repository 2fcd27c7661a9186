"""Pipeline parallelism (GPipe) over a mesh axis: port of
``horovod_tpu/parallel/pipeline.py``.

Every pp rank holds one stage's weights; activations hop stage to stage
by ``ppermute`` while microbatches stream through.  The schedule is the
reference's SPMD one: every rank runs ``stage_fn`` at every one of
``n_micro + n_stages - 1`` ticks, rank 0 injects microbatch ``t``
(clamped), the last rank emits at ``t >= n_stages - 1``, and one
``ppermute`` to ``i + 1`` ends each tick (rank 0 receives zeros).  It is
differentiable through the autograd ``ppermute``, so backward runs the
pipeline in reverse.  The stage function must keep its shape.
"""

from __future__ import annotations

from typing import Callable

import torch

from .collectives import (axis_index, axis_size, ensure_varying, ppermute,
                          psum, resolve, tie)


def gpipe(stage_fn: Callable, stage_params, x_microbatches,
          axis_name: str = "pp"):
    """Run ``stage_fn(stage_params, act)`` as a pipeline over the pp axis.

    ``x_microbatches`` is ``[n_micro, mb, ...]``, meaningful on stage 0 and
    taken as replicated (its gradient is summed over the axis).  Returns
    ``[n_micro, mb, ...]``: the last stage's outputs on the last pp rank,
    zeros elsewhere."""
    ax = resolve(axis_name)
    n_stages, idx = ax.size, ax.index
    n_micro = x_microbatches.shape[0]
    fwd_perm = [(i, i + 1) for i in range(n_stages - 1)]
    x_microbatches = ensure_varying(x_microbatches, ax)
    buf = torch.zeros_like(x_microbatches[0])
    outputs = [torch.zeros_like(x_microbatches[0]) for _ in range(n_micro)]
    for t in range(n_micro + n_stages - 1):
        mb = x_microbatches[min(t, n_micro - 1)]
        inp = tie(mb, buf) if idx == 0 else tie(buf, mb)
        out = stage_fn(stage_params, inp)
        # The last stage emits microbatch t - (n_stages - 1) at tick t.
        # Every rank ties each tick's output into the outputs, emitted or
        # not, as the reference's where does: the hops' backward then runs
        # on every rank.
        slot = min(max(t - (n_stages - 1), 0), n_micro - 1)
        if idx == n_stages - 1 and t >= n_stages - 1:
            outputs[slot] = tie(out, outputs[slot])
        else:
            outputs[slot] = tie(outputs[slot], out)
        buf = ppermute(out, ax, fwd_perm)
    return torch.stack(outputs)


def pipeline_stage_params(params_by_stage, axis_name: str = "pp"):
    """This rank's stage weights from a pytree (dict, list, tuple or
    tensor) whose leaves have a leading ``n_stages`` dim."""
    idx = axis_index(axis_name)
    if isinstance(params_by_stage, torch.Tensor):
        return params_by_stage[idx]
    if isinstance(params_by_stage, dict):
        return {k: pipeline_stage_params(v, axis_name)
                for k, v in params_by_stage.items()}
    return type(params_by_stage)(pipeline_stage_params(v, axis_name)
                                 for v in params_by_stage)


def last_stage_value(x, axis_name: str = "pp"):
    """Broadcast the last pp rank's value to all ranks (one psum)."""
    contribution = x if axis_index(axis_name) == axis_size(axis_name) - 1 \
        else tie(torch.zeros_like(x), x)
    return psum(contribution, axis_name)
