"""Uneven-data training with ``hvd.join()``: port of
``examples/jax_uneven_data_join.py``.

Each rank owns a different number of batches, the tail of a sharded
dataset: rank r gets 40 + 15·r batches of 16 rows from
``numpy.random.RandomState(r)``, with targets ``x @ w*``.  Ranks that run
out call ``hvd.join()``; the others keep averaging their gradients through
``DistributedOptimizer``'s grad hooks, a joined rank contributing zeros
(the average still divides by the full size), with no padding and no
dropped data.

Run:  python -m horovod_tpu_torch.runner.launch -np 2 \\
          python -m horovod_tpu_torch.examples.uneven_data_join
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import basics, functions, mpi_ops
from ..optimizer import DistributedOptimizer

W_TRUE = np.array([1.0, -2.0, 0.5, 3.0], np.float32)


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="hvd.init()'s device (default: the rank's card)")
    ap.add_argument("--lr", type=float, default=0.1)
    return ap.parse_args(argv)


def batches(rank: int) -> list:
    """This rank's (x, y) batches, as the reference draws them."""
    rng = np.random.RandomState(rank)
    out = []
    for _ in range(40 + 15 * rank):
        x = rng.randn(16, 4).astype(np.float32)
        out.append((x, x @ W_TRUE))
    return out


def main(argv=None) -> dict:
    args = parse(argv)
    owns = not basics.is_initialized()
    if owns:
        basics.init(device=args.device)
    rank, device = basics.rank(), basics.device()
    data = batches(rank)
    w = torch.nn.Parameter(torch.zeros(4, device=device))
    functions.broadcast_parameters({"w": w}, root_rank=0)
    opt = DistributedOptimizer(torch.optim.SGD([w], lr=args.lr),
                               named_parameters=[("w", w)])
    for i, (x, y) in enumerate(data):
        x, y = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
        opt.zero_grad()
        loss = ((x @ w - y) ** 2).mean()
        loss.backward()
        opt.step()
        if i % 20 == 0:
            print(f"[rank {rank}] batch {i}/{len(data)} "
                  f"loss={loss.item():.4f}", flush=True)
    # Out of data: join.  The other ranks keep training; this rank's
    # executor walks their allreduces with zeros until everyone joins.
    last = mpi_ops.join()
    print(f"[rank {rank}] joined after {len(data)} batches (last rank to "
          f"join: {last})", flush=True)
    final = w.detach().cpu().numpy()
    err = float(np.max(np.abs(final - W_TRUE)))
    print(f"[rank {rank}] final |w - w*|_inf = {err:.4f}", flush=True)
    if owns:
        basics.shutdown()
    return {"w": final, "batches": len(data), "last_joined": last,
            "err": err}


if __name__ == "__main__":
    main()
