"""horovod_tpu_torch: the PyTorch and CUDA port of horovod_tpu.

``import horovod_tpu_torch as hvd`` gives Horovod on an NVIDIA card:
``hvd.init()`` starts the port's own copy of the native negotiation core
beside a ``torch.distributed`` process group; every eager collective
(``allreduce``, ``allgather``, ``broadcast``, ``alltoall``,
``reducescatter``, their grouped forms, ``barrier``, ``join``) is enqueued
under a name, negotiated across ranks, fused, and run over NCCL on the
card (the device plane) or over the core's TCP ring for host buffers;
``hvd.DistributedOptimizer`` reduces gradients through the same path, with
``device_compression=`` on the quantized ring with error feedback, or
shards the optimizer's state (``shard_optimizer_states=True``, ZeRO-1);
``hvd.SyncBatchNorm`` normalizes over the global batch, and
``horovod_tpu_torch.models`` holds the model zoo and
``horovod_tpu_torch.parallel`` the sequence (ring, Ulysses), tensor,
pipeline and expert parallel layers over named mesh axes.  ``hvd.metrics()``,
``hvd.flight_record()``, ``hvd.step_trace()``, ``hvd.start_timeline()`` and
``hvd.start_device_trace()`` show what the core and the card did.  The
package imports torch and never jax or the JAX package ``horovod_tpu``,
which stays beside it as the reference.
"""

from __future__ import annotations

__version__ = "0.1.0"

from . import models, ops, parallel  # noqa: F401
from .ops import quantize  # noqa: F401
from .basics import (backend, ccl_built, cross_rank,  # noqa: F401
                     cross_size, cuda_built, ddl_built, device,
                     fleet_history, flight_record, gloo_built, gloo_enabled,
                     init, initialized, is_homogeneous, is_initialized,
                     local_rank, local_size, metrics, metrics_prometheus,
                     mpi_built, mpi_enabled, mpi_threads_supported,
                     native_core_built, nccl_built, num_devices, rank,
                     rocm_built, shutdown, size, start_device_trace,
                     start_timeline, step_trace, stop_device_trace,
                     stop_timeline, tpu_built)
from .compression import Compression  # noqa: F401
from .exceptions import HorovodInternalError  # noqa: F401
from .functions import (allgather_object, broadcast_object,  # noqa: F401
                        broadcast_object_fn, broadcast_optimizer_state,
                        broadcast_parameters)
from .mpi_ops import (Adasum, Average, Max, Min, Product, Sum,  # noqa: F401
                      allgather, allgather_async, allreduce, allreduce_,
                      allreduce_async, allreduce_async_, alltoall,
                      alltoall_async, barrier, broadcast, broadcast_,
                      broadcast_async, broadcast_async_, grouped_allgather,
                      grouped_allgather_async, grouped_allreduce,
                      grouped_allreduce_, grouped_allreduce_async,
                      grouped_allreduce_async_, grouped_reducescatter,
                      grouped_reducescatter_async, join, poll,
                      reducescatter, reducescatter_async, sparse_allreduce,
                      sparse_allreduce_async, sparse_synchronize,
                      synchronize)
from .ops.collectives import (quantized_allgather,  # noqa: F401
                              quantized_allreduce, quantized_alltoall,
                              quantized_broadcast, quantized_reducescatter)
from .optimizer import (DistributedOptimizer,  # noqa: F401
                        clip_by_global_norm)
from .sync_batch_norm import SyncBatchNorm  # noqa: F401
from .process_sets import (ProcessSet, add_process_set,  # noqa: F401
                           global_process_set, remove_process_set)
from .wire import ReduceOp  # noqa: F401
