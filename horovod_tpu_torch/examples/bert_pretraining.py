"""BERT pretraining with fp16-compressed gradients: port of
``examples/jax_bert_pretraining.py``.

BERT_TINY, or BERT-Large with ``--large``, on synthetic token ids with the
MLM objective over every position; ``DistributedOptimizer(AdamW(1e-4),
compression=Compression.fp16)`` halves the gradient bytes on the wire, as
the reference's fp16 compression does.  ``--seq-parallel`` shards each
sequence over the ``sp`` axis of a ``("hvd", "sp")`` mesh (sp = 2 when the
world has two ranks or more): non-causal ring attention, with the flash
kernels on each hop under ``--sp-flash``.  The ``sp`` ranks of one ``hvd``
row hold the halves of the same sequences.  An odd world is refused under
``--seq-parallel``: the reference leaves its odd device idle, but here
every rank takes part in the optimizer's averages.

Run:  python -m horovod_tpu_torch.examples.bert_pretraining --large
      [--seq-parallel [--sp-flash]]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import statistics
from typing import Optional

import torch

from .. import basics, models, parallel
from ..compression import Compression
from ..optimizer import DistributedOptimizer
from . import _loop


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--large", action="store_true", help="BERT-Large")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="shard the sequence over an sp axis (ring "
                         "attention)")
    ap.add_argument("--sp-flash", action="store_true",
                    help="flash kernels per ring-attention hop")
    ap.add_argument("--batch-per-chip", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def sp_ways(world: int, seq_parallel: bool) -> int:
    """The ``sp`` axis's size: 2 under ``--seq-parallel`` on two ranks or
    more, else 1.  Raises ValueError on an odd world, alike on every rank
    and before any collective, so no rank is left waiting on another."""
    if not seq_parallel or world < 2:
        return 1
    if world % 2:
        raise ValueError(f"--seq-parallel needs an even world (sp = 2), "
                         f"got {world} ranks")
    return 2


def setup(argv=None, base: Optional[models.BertConfig] = None) -> dict:
    """The model, optimizer, synthetic batch and one-step closure of the
    run ``argv`` describes, on ``hvd.device()`` (``hvd.init()`` first).
    ``base`` replaces the configuration ``--large`` picks (a caller cutting
    BERT-Large's depth, say); ``max_position_embeddings`` still widens to
    ``--seq-len``."""
    args = parse(argv)
    sp = sp_ways(basics.size(), args.seq_parallel)
    device = basics.device()
    mesh, row = None, basics.rank()
    if sp > 1:
        mesh = parallel.build_mesh({"hvd": basics.size() // sp, "sp": sp})
        row = mesh.axis("hvd").index
    if base is None:
        base = models.BERT_LARGE if args.large else models.BERT_TINY
    cfg = dataclasses.replace(
        base, sp_axis_name="sp" if mesh is not None else None,
        sp_use_flash=args.sp_flash, max_position_embeddings=max(
            args.seq_len, base.max_position_embeddings))
    torch.manual_seed(args.seed)
    model = models.BertForPreTraining(cfg).to(device)
    gen = torch.Generator(device=device).manual_seed(args.seed * 1000 + row)
    shape = (args.batch_per_chip, args.seq_len)
    ids = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                        device=device)
    labels = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                           device=device)
    if mesh is not None:  # this rank's part of each sequence
        cols = args.seq_len // sp
        start = mesh.axis("sp").index * cols
        ids = ids[:, start:start + cols].contiguous()
        labels = labels[:, start:start + cols].contiguous()
    weights = torch.ones(ids.shape, device=device)
    opt = DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4),
        named_parameters=model.named_parameters(),
        compression=Compression.fp16)

    def step():
        opt.zero_grad()
        with mesh if mesh is not None else contextlib.nullcontext():
            loss = models.mlm_loss(model(ids), labels, weights)
            loss.backward()
        opt.step()
        return loss

    return {"args": args, "model": model, "optimizer": opt, "step": step}


def main(argv=None) -> dict:
    owns = _loop.init()
    res = setup(argv)
    args = res["args"]
    res.update(_loop.run(res["step"], args.steps))
    per_chip = args.batch_per_chip * args.steps * 1e3 / sum(res["step_ms"])
    res.update(sequences_per_sec_per_chip=per_chip,
               step_ms_median=statistics.median(res["step_ms"]))
    if basics.rank() == 0:
        print(f"sequences/sec: {per_chip * basics.size():.1f} "
              f"({per_chip:.1f}/chip), loss={res['losses'][-1]:.4f}")
    if owns:
        basics.shutdown()
    return res


if __name__ == "__main__":
    main()
