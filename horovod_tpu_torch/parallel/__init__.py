"""The sequence, tensor, pipeline and expert parallel layers over named
mesh axes: port of ``horovod_tpu/parallel``.  ``collectives`` holds the
differentiable collectives they are built on."""

from .mesh import (  # noqa: F401
    build_global_mesh,
    build_mesh,
    global_mesh,
    set_global_mesh,
    mesh_axis_name,
    sub_mesh,
)
from .ring_attention import ring_attention, ulysses_attention  # noqa: F401
from .tensor_parallel import (  # noqa: F401
    column_parallel_dense, row_parallel_dense, tp_mlp,
    vocab_parallel_embedding, shard_kernel,
)
from .pipeline import gpipe, pipeline_stage_params, last_stage_value  # noqa: F401
from .moe import switch_moe, moe_ffn, load_balancing_loss  # noqa: F401
