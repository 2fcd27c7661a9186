"""Convergence with the device codecs and error feedback, at np=2 on gloo:
the port's counterpart of ``tests/single/test_convergence_ef.py``.

The int8 block codec rounds every gradient entry to the nearest multiple
of ``max|block| / 127``; a coordinate whose gradient stays below half that
step quantizes to zero on every step and never trains, unless error
feedback carries the rounding error forward.  As in the reference:

- on a quadratic whose block scale is pinned by one "leader" coordinate
  per 256-element block (a linear term of gradient 1), the port's
  ``DistributedOptimizer(device_compression=codec)`` reaches the fp32
  solution (within 2x of its error for int8 at lr 0.45, 4x for int4 at lr
  0.2), while the same ring without error feedback
  (``hvd.quantized_allreduce`` averaging the raw gradients) stalls at
  least 10x above fp32 and 5x above error feedback;
- an MLP classifier and ResNetTiny (frozen BatchNorm statistics) trained
  with int8 and error feedback land within 5% and 10% of the fp32 loss.

The reference runs eight devices in one program; here two processes each
hold one rank's data.  The step counts and learning rates are the
reference's.
"""

import os
import socket

import numpy as np
import pytest
import torch

WORLD = 2
JOIN_TIMEOUT_S = 120
MIN_BYTES = 4096
BLOCK = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _quadratic():
    n = 2048
    h = np.tile(np.logspace(-2, 0, BLOCK), n // BLOCK)
    leader = np.zeros(n, bool)
    leader[::BLOCK] = True
    h[leader] = 0.0
    return h, leader


def _quad_err(w):
    h, _ = _quadratic()
    return float(np.sum(h * (np.asarray(w, np.float64) - 1.0) ** 2))


def _train_quadratic(hvd, codec, arm, lr, steps):
    """SGD on the pinned-scale quadratic; ``arm`` is "fp32", "ef" or
    "noef"."""
    h_np, leader = _quadratic()
    h = torch.from_numpy(h_np.astype(np.float32))
    lead = torch.from_numpy(leader.astype(np.float32))
    w = torch.nn.Parameter(torch.zeros(h.numel()))
    sgd = torch.optim.SGD([w], lr=lr)
    opt = sgd if arm == "noef" else hvd.DistributedOptimizer(
        sgd, named_parameters=[(f"quad.{codec}.{arm}", w)],
        device_compression=codec if arm == "ef" else "none")
    ones = torch.ones(h.numel())
    for _ in range(steps):
        opt.zero_grad()
        loss = (h * (w - 1.0) ** 2).sum() * ones.mean() + (lead * w).sum()
        loss.backward()
        if arm == "noef":
            w.grad.copy_(hvd.quantized_allreduce(
                w.grad, op=hvd.Average, min_bytes=MIN_BYTES, codec=codec))
        opt.step()
    residual = None
    if arm == "ef":
        residual = opt.state[w]["ef_residual"].clone()
    return w.detach().clone(), residual


def _mlp_run(hvd, rank, codec):
    from horovod_tpu_torch import models
    from horovod_tpu_torch.ops import quantize

    rng = np.random.RandomState(0)
    batch, dim, classes = 16, 64, 10
    x_np = rng.randn(WORLD, batch, dim).astype(np.float32)
    y_np = rng.randint(0, classes, size=(WORLD, batch))
    torch.manual_seed(1)
    model = models.MLP(dim, (128, 64, classes))
    full_x = torch.from_numpy(x_np.reshape(-1, dim))
    full_y = torch.from_numpy(y_np.reshape(-1))
    with torch.no_grad():
        loss_init = models.xent_loss(model(full_x), full_y).item()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.3),
        named_parameters=[(f"mlp.{codec}.{n}", p)
                          for n, p in model.named_parameters()],
        device_compression=codec)
    quantize.reset_device_byte_counters()
    x, y = torch.from_numpy(x_np[rank]), torch.from_numpy(y_np[rank])
    for _ in range(40):
        opt.zero_grad()
        models.xent_loss(model(x), y).backward()
        opt.step()
    with torch.no_grad():
        loss = models.xent_loss(model(full_x), full_y).item()
    return {"init": loss_init, "loss": loss,
            "bytes": quantize.device_byte_counters()}


def _resnet_run(hvd, rank, codec):
    from horovod_tpu_torch import models

    rng = np.random.RandomState(2)
    batch, side, classes = 4, 16, 10
    x_np = rng.randn(WORLD, batch, 3, side, side).astype(np.float32)
    y_np = rng.randint(0, classes, size=(WORLD, batch))
    torch.manual_seed(3)
    model = models.ResNetTiny(num_classes=classes)
    # Frozen (initial) BatchNorm statistics: the objective is deterministic
    # and the test is about error feedback, not BatchNorm schedules.
    model.eval()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05),
        named_parameters=[(f"resnet.{codec}.{n}", p)
                          for n, p in model.named_parameters()],
        device_compression=codec)
    x, y = torch.from_numpy(x_np), torch.from_numpy(y_np)
    for _ in range(12):
        opt.zero_grad()
        models.xent_loss(model(x[rank]), y[rank]).backward()
        opt.step()
    with torch.no_grad():
        return float(np.mean([models.xent_loss(model(x[r]), y[r]).item()
                              for r in range(WORLD)]))


def _worker(rank, port, outdir):
    torch.set_num_threads(1)
    for var in [v for v in os.environ if v.startswith("HOROVOD_")]:
        del os.environ[var]
    os.environ.update(
        HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(WORLD),
        HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(WORLD),
        HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
        HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
        HOROVOD_GLOO_TIMEOUT_SECONDS="60", HOROVOD_SHM_DISABLE="1",
        HOROVOD_WIRE_COMPRESSION_MIN_BYTES=str(MIN_BYTES))
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    res = {}
    for codec, lr in (("int8", 0.45), ("int4", 0.2)):
        for arm in ("fp32", "ef", "noef"):
            res[(codec, arm)] = _train_quadratic(hvd, codec, arm, lr, 300)
    for codec in ("none", "int8"):
        res[("mlp", codec)] = _mlp_run(hvd, rank, codec)
        res[("resnet", codec)] = _resnet_run(hvd, rank, codec)
    hvd.shutdown()
    torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("ef")
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    peer = ctx.Process(target=_worker, args=(1, port, str(outdir)))
    peer.start()
    saved = dict(os.environ)
    try:
        _worker(0, port, str(outdir))
    finally:
        os.environ.clear()
        os.environ.update(saved)
        peer.join(JOIN_TIMEOUT_S)
        if peer.is_alive():
            peer.kill()
            peer.join(10)
            pytest.fail(f"rank 1 did not finish in {JOIN_TIMEOUT_S} s")
    assert peer.exitcode == 0
    return [torch.load(outdir / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.mark.parametrize("codec,ef_bound", [("int8", 2.0), ("int4", 4.0)])
def test_quadratic_ef_matches_fp32_and_noef_stalls(ranks, codec, ef_bound):
    for r in ranks:
        e_fp32 = _quad_err(r[(codec, "fp32")][0])
        e_ef = _quad_err(r[(codec, "ef")][0])
        e_noef = _quad_err(r[(codec, "noef")][0])
        assert e_ef <= ef_bound * e_fp32, (e_ef, e_fp32)
        assert e_noef >= 10.0 * e_fp32, (e_noef, e_fp32)
        assert e_noef >= 5.0 * e_ef, (e_noef, e_ef)
        residual = r[(codec, "ef")][1]
        assert residual.shape == (2048,) and torch.any(residual != 0)
    for arm in ("fp32", "ef", "noef"):     # the ranks agree to the bit
        assert torch.equal(ranks[0][(codec, arm)][0],
                           ranks[1][(codec, arm)][0])


def test_mlp_int8_ef_tracks_fp32(ranks):
    for r in ranks:
        fp32, ef = r[("mlp", "none")], r[("mlp", "int8")]
        assert fp32["bytes"] == (0, 0)     # the fp32 arm never quantizes
        raw, enc = ef["bytes"]
        assert raw > 0 and enc < raw       # the int8 arm rode the ring
        assert fp32["loss"] < 0.5 * fp32["init"]
        assert abs(ef["loss"] - fp32["loss"]) <= 0.05 * fp32["loss"], \
            (ef["loss"], fp32["loss"])


def test_resnet_tiny_int8_ef_tracks_fp32(ranks):
    for r in ranks:
        fp32, ef = r[("resnet", "none")], r[("resnet", "int8")]
        assert abs(ef - fp32) <= 0.10 * max(fp32, 1e-3), (ef, fp32)
