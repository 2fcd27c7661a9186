"""BERT pretraining with fp16-compressed gradients: port of
``examples/jax_bert_pretraining.py``.

BERT_TINY, or BERT-Large with ``--large``, on synthetic token ids with the
MLM objective over every position; ``DistributedOptimizer(AdamW(1e-4),
compression=Compression.fp16)`` halves the gradient bytes on the wire, as
the reference's fp16 compression does.  The reference's sequence-parallel
options (``--seq-parallel``, ``--sp-flash``: ring attention) wait for the
port's parallel layers.

Run:  python -m horovod_tpu_torch.examples.bert_pretraining --large
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics

import torch

from .. import basics, models
from ..compression import Compression
from ..optimizer import DistributedOptimizer
from . import _loop


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--large", action="store_true", help="BERT-Large")
    ap.add_argument("--batch-per-chip", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def setup(argv=None) -> dict:
    """The model, optimizer, synthetic batch and one-step closure of the
    run ``argv`` describes, on ``hvd.device()`` (``hvd.init()`` first)."""
    args = parse(argv)
    device = basics.device()
    base = models.BERT_LARGE if args.large else models.BERT_TINY
    cfg = dataclasses.replace(base, max_position_embeddings=max(
        args.seq_len, base.max_position_embeddings))
    torch.manual_seed(args.seed)
    model = models.BertForPreTraining(cfg).to(device)
    gen = torch.Generator(device=device).manual_seed(
        args.seed * 1000 + basics.rank())
    shape = (args.batch_per_chip, args.seq_len)
    ids = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                        device=device)
    labels = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                           device=device)
    weights = torch.ones(shape, device=device)
    opt = DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4),
        named_parameters=model.named_parameters(),
        compression=Compression.fp16)

    def step():
        opt.zero_grad()
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
