"""Synthetic-data CNN benchmark: port of ``examples/jax_cnn_benchmark.py``.

Horovod's published numbers come from synthetic-data training of
ResNet-50/101, Inception V3 and VGG-16 under DistributedOptimizer; this is
that harness on the card: pick a model, measure images/s per card.
BatchNorm is synced over the ranks (the reference's ``bn_axis_name``),
the optimizer is SGD with momentum 0.9 at lr 0.01, activations are bf16
unless ``--fp32``, and ``--shard-optimizer`` shards its state (ZeRO-1).

Run:  python -m horovod_tpu_torch.examples.cnn_benchmark --model resnet50
"""

from __future__ import annotations

import argparse
import statistics

import torch

from .. import basics, models
from ..optimizer import DistributedOptimizer
from . import _loop

MODELS = {
    "resnet50": (lambda dt: models.ResNet50(dtype=dt, bn_sync=True), 224),
    "resnet101": (lambda dt: models.ResNet101(dtype=dt, bn_sync=True), 224),
    "inception3": (lambda dt: models.InceptionV3(dtype=dt, bn_sync=True),
                   299),
    "vgg16": (lambda dt: models.VGG16(dtype=dt), 224),
    "resnet_tiny": (lambda dt: models.ResNetTiny(num_classes=100,
                                                 bn_sync=True), 32),
}


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=sorted(MODELS), default="resnet50")
    ap.add_argument("--batch-per-chip", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--shard-optimizer", action="store_true",
                    help="ZeRO-1 optimizer-state sharding over the ranks "
                         "(fp32 master weights)")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def setup(argv=None) -> dict:
    """The model, optimizer, synthetic batch and one-step closure of the
    run ``argv`` describes, on ``hvd.device()`` (``hvd.init()`` first)."""
    args = parse(argv)
    device = basics.device()
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    build, hw = MODELS[args.model]
    torch.manual_seed(args.seed)
    model = build(dtype).to(device)
    gen = torch.Generator(device=device).manual_seed(
        args.seed * 1000 + basics.rank())
    images = torch.randn(args.batch_per_chip, 3, hw, hw, generator=gen,
                         device=device).contiguous(
        memory_format=torch.channels_last)
    num_classes = model.head.out_features
    labels = torch.randint(0, num_classes, (args.batch_per_chip,),
                           generator=gen, device=device)
    opt = DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        named_parameters=model.named_parameters(),
        shard_optimizer_states=args.shard_optimizer)
    model.train()

    def step():
        opt.zero_grad()
        loss = models.xent_loss(model(images), labels)
        loss.backward()
        opt.step()
        return loss

    return {"args": args, "model": model, "optimizer": opt, "step": step,
            "images": images, "labels": labels}


def main(argv=None) -> dict:
    owns = _loop.init()
    res = setup(argv)
    args = res["args"]
    res.update(_loop.run(res["step"], args.steps))
    # As the reference: the timed steps' images over their whole time.
    per_chip = args.batch_per_chip * args.steps * 1e3 / sum(res["step_ms"])
    res.update(images_per_sec_per_chip=per_chip,
               step_ms_median=statistics.median(res["step_ms"]))
    if basics.rank() == 0:
        n = basics.size()
        print(f"{args.model}: {per_chip * n:.1f} images/sec "
              f"({per_chip:.1f}/chip), loss={res['losses'][-1]:.4f}")
    if owns:
        basics.shutdown()
    return res


if __name__ == "__main__":
    main()
