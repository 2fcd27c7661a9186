"""The repo's tools over the port.

``python -m horovod_tpu_torch.tools.test_matrix`` runs the collective
workload across the configuration matrix, and
``python -m horovod_tpu_torch.tools.hlo_report`` reports the collectives
of a compiled step from its saved graph code, and
``python -m horovod_tpu_torch.tools.bench_negotiation`` measures the
negotiation spine, the codecs and the planes.  They import torch and
launch the port's own launcher, never jax or the JAX package.
"""
