"""horovod_tpu_torch: the PyTorch and CUDA port of horovod_tpu.

``import horovod_tpu_torch as hvd`` gives Horovod's main loop on an NVIDIA
card: ``hvd.init()``, ``hvd.broadcast_parameters``, and a train step whose
gradients ``hvd.DistributedOptimizer`` averages over NCCL, under the names
``horovod_tpu.torch`` uses; with ``device_compression=`` the gradients ride
the quantized ring (``quantized_allreduce``) with error feedback.  The
package imports torch and never jax or the JAX package ``horovod_tpu``,
which stays beside it as the reference.
"""

from __future__ import annotations

__version__ = "0.1.0"

from . import models, ops  # noqa: F401
from .ops import quantize  # noqa: F401
from .basics import (backend, device, init, initialized,  # noqa: F401
                     is_initialized, local_rank, local_size, rank, shutdown,
                     size)
from .compression import Compression  # noqa: F401
from .exceptions import HorovodInternalError  # noqa: F401
from .functions import (allgather_object, broadcast_object,  # noqa: F401
                        broadcast_optimizer_state, broadcast_parameters)
from .mpi_ops import (Adasum, Average, Max, Min, Product, Sum,  # noqa: F401
                      allgather, allgather_async, allreduce, allreduce_,
                      allreduce_async, allreduce_async_, barrier, broadcast,
                      broadcast_, broadcast_async, broadcast_async_, poll,
                      synchronize)
from .ops.collectives import (quantized_allgather,  # noqa: F401
                              quantized_allreduce, quantized_broadcast)
from .optimizer import DistributedOptimizer  # noqa: F401
from .wire import ReduceOp  # noqa: F401
