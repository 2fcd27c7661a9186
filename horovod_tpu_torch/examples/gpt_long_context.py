"""GPT causal LM with long-context sequence parallelism (ring attention):
port of ``examples/jax_gpt_long_context.py``.

The sequence is sharded over the ``sp`` axis of a ``("dp", "sp")`` mesh;
attention is exact causal ring attention, K and V rotating around the
axis (``--sp-flash``: the flash kernels on each hop); gradients are
averaged over every rank by ``DistributedOptimizer(AdamW(3e-4))`` and the
loss by ``hvd.allreduce``.  ``sp`` falls back to 1 when it does not divide
the world size, as in the reference.

The LM loss shifts targets within each sequence shard, so the one boundary
token between adjacent shards is not predicted, as in the reference.

Run:  python -m horovod_tpu_torch.examples.gpt_long_context --sp 2
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
from typing import Optional

import torch

from .. import basics, functions, models, parallel
from ..optimizer import DistributedOptimizer
from . import _loop


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--sp", type=int, default=2,
                    help="sequence-parallel ways")
    ap.add_argument("--batch-per-dp", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint each block (memory for FLOPs)")
    ap.add_argument("--sp-flash", action="store_true",
                    help="flash kernels per ring-attention hop")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def global_batch(seed: int, batch: int, seq_len: int,
                 vocab: int) -> torch.Tensor:
    """The job's token ids ``[batch, seq_len]``, the same on every rank."""
    gen = torch.Generator().manual_seed(seed + 1)
    return torch.randint(0, vocab, (batch, seq_len), generator=gen)


def setup(argv=None, base: Optional[models.GPTConfig] = None) -> dict:
    """The model, optimizer, this rank's shard of the batch and the
    one-step closure of the run ``argv`` describes, on ``hvd.device()``
    (``hvd.init()`` first).  ``base`` is the configuration the run widens
    (``GPT_TINY`` as in the reference, unless the caller passes another);
    its ``max_seq_len`` becomes ``--seq-len``."""
    args = parse(argv)
    world = basics.size()
    sp = args.sp if world % args.sp == 0 else 1
    dp = world // sp
    mesh = parallel.build_mesh({"dp": dp, "sp": sp})
    cfg = dataclasses.replace(
        base or models.GPT_TINY, sp_axis_name="sp" if sp > 1 else None,
        sp_use_flash=args.sp_flash, max_seq_len=args.seq_len,
        remat=args.remat)
    device = basics.device()
    torch.manual_seed(args.seed)
    model = models.GPT(cfg).to(device)
    functions.broadcast_parameters(model.state_dict(), root_rank=0)
    batch = args.batch_per_dp * dp
    ids = global_batch(args.seed, batch, args.seq_len, cfg.vocab_size)
    rows = mesh.axis("dp").index * args.batch_per_dp
    cols = args.seq_len // sp
    start = mesh.axis("sp").index * cols
    local = ids[rows:rows + args.batch_per_dp,
                start:start + cols].contiguous().to(device)
    opt = DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())

    def step():
        opt.zero_grad()
        with mesh:
            loss = models.lm_loss(model(local), local)
            loss.backward()
        opt.step()
        return loss

    return {"args": args, "config": cfg, "model": model, "optimizer": opt,
            "local_ids": local, "dp": dp, "sp": sp, "step": step}


def main(argv=None) -> dict:
    owns = _loop.init()
    res = setup(argv)
    args = res["args"]
    res.update(_loop.run(res["step"], args.steps))
    batch = args.batch_per_dp * res["dp"]
    tokens = batch * args.seq_len * args.steps * 1e3 / sum(res["step_ms"])
    res.update(tokens_per_sec=tokens,
               step_ms_median=statistics.median(res["step_ms"]))
    if basics.rank() == 0:
        print(f"tokens/sec: {tokens:.0f} (mesh {res['dp']}x{res['sp']} dp "
              f"x sp, seq {args.seq_len}), loss={res['losses'][-1]:.4f}")
    if owns:
        basics.shutdown()
    return res


if __name__ == "__main__":
    main()
