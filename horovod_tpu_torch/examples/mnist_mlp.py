"""MNIST-scale MLP with ``hvd.DistributedOptimizer``: port of
``examples/jax_mnist_mlp.py``, the canonical first Horovod script: init,
shard the data by rank, broadcast the initial weights, wrap the optimizer.

Synthetic MNIST-shaped data (2048 images of 28x28x1 and labels) comes
from a seeded ``torch.Generator``.  The learning rate warms up as the
reference's ``callbacks.warmup_schedule(0.01, warmup_steps=50)``: from a
third of 0.01 to ``size * 0.01`` over 50 steps; each epoch's last loss is
averaged over the ranks, as ``MetricAverageCallback`` does.

Run:  python -m horovod_tpu_torch.examples.mnist_mlp
"""

from __future__ import annotations

import argparse

import torch

from .. import basics, functions, models, mpi_ops
from ..optimizer import DistributedOptimizer
from . import _loop


def warmup_lr(step: int, base_lr: float = 0.01, warmup_steps: int = 50,
              initial_factor: float = 1.0 / 3.0) -> float:
    size = basics.size() if basics.is_initialized() else 1
    start, scaled = base_lr * initial_factor, base_lr * max(size, 1)
    frac = min(max(step / max(warmup_steps, 1), 0.0), 1.0)
    return start + (scaled - start) * frac


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--examples", type=int, default=2048)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    owns = _loop.init()
    device, rank, size = basics.device(), basics.rank(), basics.size()
    gen = torch.Generator().manual_seed(args.seed)
    x = torch.rand(args.examples, 1, 28, 28, generator=gen)
    y = torch.randint(0, 10, (args.examples,), generator=gen)
    shard = args.examples // size
    x = x[rank * shard:(rank + 1) * shard].to(device)
    y = y[rank * shard:(rank + 1) * shard].to(device)
    torch.manual_seed(args.seed + rank)  # each rank its own initial weights
    model = models.MLP().to(device)
    functions.broadcast_parameters(model.state_dict(), root_rank=0)
    sgd = torch.optim.SGD(model.parameters(), lr=warmup_lr(0), momentum=0.9)
    opt = DistributedOptimizer(sgd, named_parameters=model.named_parameters())
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: warmup_lr(step) / warmup_lr(0))
    epoch_losses = []
    for epoch in range(args.epochs):
        for i in range(0, shard, args.batch):
            opt.zero_grad()
            loss = models.xent_loss(model(x[i:i + args.batch]),
                                    y[i:i + args.batch])
            loss.backward()
            opt.step()
            sched.step()
        avg = mpi_ops.allreduce(loss.detach(), name="mnist.loss").item()
        epoch_losses.append(avg)
        if rank == 0:
            print(f"epoch {epoch}: loss={avg:.4f}")
    if owns:
        basics.shutdown()
    return {"epoch_losses": epoch_losses, "model": model}


if __name__ == "__main__":
    main()
