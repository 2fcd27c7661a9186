"""Eager training loop on the device data plane: port of
``examples/jax_eager_device_plane.py``.

Reference analog: horovod examples/pytorch/pytorch_synthetic_benchmark.py,
the eager loop where the framework runs each op and the
DistributedOptimizer's hooks allreduce the gradients.  Here those
gradients stay on the rank's device: each hook enqueues its gradient, the
core negotiates and fuses them, and the negotiated ``device`` bit sends
the bucket through the device plane (``ops/device_plane.py``: NCCL on the
card, gloo on the CPU), so nothing crosses to the host.

The reference's ``MLP`` and data: 512 samples of 28x28x1 and their labels
from ``RandomState(rank)``, the parameters broadcast from rank 0,
``DistributedOptimizer(SGD(lr=0.05), op=Average)``, 10 steps on the
``x[step::10]`` slices.  The run ends by checking that the device plane
served the allreduces.

Run:  python -m horovod_tpu_torch.runner.launch -np 2 \\
          python -m horovod_tpu_torch.examples.eager_device_plane
      (or single-process; ``--device cpu`` runs on the CPU)
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.context import HorovodContext
from horovod_tpu_torch.models import MLP, xent_loss

STEPS = 10


def train(state: Optional[dict] = None) -> torch.nn.Module:
    """The loop on an initialized Horovod; ``state`` (a ``state_dict``)
    replaces rank 0's seeded initial parameters before the broadcast."""
    rank, dev = hvd.rank(), hvd.device()
    rng = np.random.RandomState(rank)
    x = torch.from_numpy(rng.rand(512, 28, 28, 1).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, 10, size=512).astype(np.int64)).to(
        dev)

    torch.manual_seed(0)
    model = MLP().to(dev)
    if state is not None:
        model.load_state_dict(state)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    # Eager DistributedOptimizer: each gradient's hook enqueues it async
    # (the core fuses them into one negotiated bucket) and the device
    # plane reduces the bucket on the device.
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05),
        named_parameters=model.named_parameters(), op=hvd.Average)

    for step in range(STEPS):
        xb, yb = x[step::10], y[step::10]
        opt.zero_grad()
        xent_loss(model(xb), yb).backward()   # gradients stay on the device
        opt.step()
        if step % 5 == 0 and rank == 0:
            with torch.no_grad():
                loss = float(xent_loss(model(xb), yb))
            print(f"step {step}: loss {loss:.4f}")
    return model


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the rank's device (default: its card; 'cpu')")
    args = ap.parse_args(argv)
    hvd.init(device=args.device)
    rank, size = hvd.rank(), hvd.size()
    model = train()
    stats = HorovodContext.instance().device_plane.stats
    if rank == 0:
        print(f"device plane stats: {stats}")
        total = stats["allreduce"] + stats["identity"]
        assert total > 0, "expected the eager loop to ride the device plane"
    print(f"rank {rank}/{size} done")
    hvd.shutdown()
    return {"model": model, "device_plane": dict(stats)}


if __name__ == "__main__":
    main()
