"""Distributed torch training: port of ``examples/torch_mnist.py``.

The reference's pytorch_mnist.py idiom end-to-end: init, shard data by
rank, wrap the optimizer, broadcast initial state, train, average metrics,
with ``import horovod_tpu_torch as hvd``.  The model and each batch lie on
``hvd.device()``, the rank's card unless ``--device cpu``.  Runs on
synthetic MNIST-shaped data so it needs no dataset download:

    python -m horovod_tpu_torch.runner.launch -np 2 \\
        python -m horovod_tpu_torch.examples.torch_mnist [--device cpu]
"""

import argparse

import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(784, 128)
        self.fc2 = torch.nn.Linear(128, 10)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x.flatten(1))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the rank's device (default: its card; 'cpu')")
    args = ap.parse_args(argv)
    hvd.init(build_mesh=False, device=args.device)
    torch.manual_seed(1234)  # same init everywhere; broadcast makes sure
    dev = hvd.device()

    model = Net().to(dev)
    optimizer = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.5),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.fp16)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

    # Synthetic data, sharded by rank.
    g = torch.Generator().manual_seed(hvd.rank())
    images = torch.randn(512, 1, 28, 28, generator=g)
    labels = torch.randint(0, 10, (512,), generator=g)

    model.train()
    losses = []
    for epoch in range(2):
        for i in range(0, len(images), 64):
            x, y = images[i:i + 64].to(dev), labels[i:i + 64].to(dev)
            optimizer.zero_grad()
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            optimizer.step()
        # Metric averaging across ranks, the reference's metric_average().
        avg = hvd.allreduce(loss.detach(), op=hvd.Average,
                            name="loss.epoch")
        losses.append(float(avg))
        if hvd.rank() == 0:
            print(f"epoch {epoch}: avg loss {float(avg):.4f}")

    hvd.shutdown()
    return losses


if __name__ == "__main__":
    main()
