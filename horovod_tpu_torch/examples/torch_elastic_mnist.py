"""Elastic torch training, which survives worker loss and host changes:
port of ``examples/torch_elastic_mnist.py``.

Reference analog: horovod examples/elastic/pytorch_mnist_elastic.py, the
same TorchState + ElasticSampler + @hvd.elastic.run idiom, with
``import horovod_tpu_torch as hvd``.  The model and each batch lie on
``hvd.device()``, the rank's card unless ``--device cpu``.

Run under the port's elastic launcher:
  python -m horovod_tpu_torch.runner.launch -np 2 --min-np 1 \\
      -H localhost:2 python -m horovod_tpu_torch.examples.torch_elastic_mnist
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.elastic import ElasticSampler, TorchState


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the rank's device (default: its card; 'cpu')")
    args = ap.parse_args(argv)
    hvd.init(build_mesh=False, device=args.device)
    dev = hvd.device()

    torch.manual_seed(0)
    model = torch.nn.Sequential(
        torch.nn.Flatten(), torch.nn.Linear(784, 64), torch.nn.ReLU(),
        torch.nn.Linear(64, 10)).to(dev)
    optimizer = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3),
        named_parameters=model.named_parameters())

    # Mid-epoch resume rides the SAMPLER's state, the reference idiom:
    # TorchState snapshots/restores its state_dict alongside the model and
    # optimizer, and sync() unions the processed-index sets across ranks
    # before resharding the remaining samples over the (possibly new)
    # world: nothing repeats, nothing is skipped.
    sampler = ElasticSampler(dataset_size=2048, shuffle=True)
    state = TorchState(model=model, optimizer=optimizer, sampler=sampler,
                       epoch=0)

    rng = np.random.RandomState(0)
    data_x = torch.from_numpy(rng.rand(2048, 28, 28).astype(np.float32))
    data_y = torch.from_numpy(rng.randint(0, 10, 2048).astype(np.int64))

    batch_size = 32

    @hvd.elastic.run
    def train(state):
        # A resume may land at an epoch boundary (zero remaining batches);
        # the epoch-end allreduce must still see a bound, rank-consistent
        # value.
        loss = torch.tensor(0.0, device=dev)
        while state.epoch < 3:
            for b in range(len(sampler) // batch_size):
                rows = np.asarray(sampler.local_indices[
                    b * batch_size:(b + 1) * batch_size])
                optimizer.zero_grad()
                loss = F.cross_entropy(model(data_x[rows].to(dev)),
                                       data_y[rows].to(dev))
                loss.backward()
                optimizer.step()
                sampler.record_batch(b, batch_size)
                if (b + 1) % 16 == 0:
                    # Commit at batch boundaries you are willing to roll
                    # back to (the reference's cadence guidance).
                    state.commit()
            avg = hvd.allreduce(loss.detach(), op=hvd.Average,
                                name=f"loss.{state.epoch}")
            if hvd.rank() == 0:
                print(f"epoch {state.epoch}: loss {float(avg):.4f} "
                      f"(world size {hvd.size()})")
            state.epoch += 1
            sampler.set_epoch(state.epoch)
            state.commit()
        return float(loss.detach())

    final = train(state)
    hvd.shutdown()
    return final


if __name__ == "__main__":
    main()
