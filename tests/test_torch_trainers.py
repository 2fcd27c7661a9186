"""The ported trainers (``horovod_tpu_torch.examples``) at a small size on
the CPU: one world-1 process after ``hvd.init(device="cpu")`` runs each
``main(argv)`` as ``chip_smoke.py`` runs them on the card, and ZeRO-1
beside the replicated optimizer on the same seed.  The sequence-parallel
trainers at two ranks are ``tests/test_torch_ring_attention.py``'s models
and ``chip_smoke.py``'s ``parallel`` phase."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = """
import json, sys, torch
torch.set_num_threads(1)
sys.path.insert(0, REPO_DIR)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.examples import bert_pretraining, cnn_benchmark, \\
    gpt_long_context, mnist_mlp
hvd.init(device="cpu")
out = {}
cnn = ["--model", "resnet_tiny", "--batch-per-chip", "8", "--steps", "3"]
rep = cnn_benchmark.main(cnn)
zero = cnn_benchmark.main(cnn + ["--shard-optimizer"])
out["cnn_losses"] = rep["losses"]
out["cnn_rate"] = rep["images_per_sec_per_chip"]
out["zero_equal"] = all(
    torch.equal(p, q) for p, q in zip(rep["model"].parameters(),
                                      zero["model"].parameters()))
out["zero_bytes"] = zero["optimizer"].shard_bytes()
out["param_bytes"] = sum(p.numel() * 4 for p in rep["model"].parameters())
out["rep_state"] = sum(v.numel() * v.element_size()
                       for st in rep["optimizer"].state.values()
                       for v in st.values() if torch.is_tensor(v))
bert = bert_pretraining.main(["--batch-per-chip", "2", "--seq-len", "16",
                              "--steps", "3"])
out["bert_losses"] = bert["losses"]
out["bert_rate"] = bert["sequences_per_sec_per_chip"]
out["mnist"] = mnist_mlp.main(["--examples", "256"])["epoch_losses"]
gpt = gpt_long_context.main(["--seq-len", "32", "--steps", "3", "--remat"])
out["gpt_losses"], out["gpt_sp"] = gpt["losses"], [gpt["dp"], gpt["sp"]]
out["gpt_sp_axis"] = gpt["config"].sp_axis_name
hvd.shutdown()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def run():
    env = dict(os.environ)
    for var in [v for v in env if v.startswith("HOROVOD_")]:
        del env[var]
    env["HOROVOD_SHM_DISABLE"] = "1"
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT.replace("REPO_DIR", repr(str(REPO)))],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    return json.loads(lines[-1]), lines[:-1]


def test_cnn_benchmark_trains_and_prints_the_reference_line(run):
    res, lines = run
    losses = res["cnn_losses"]
    assert len(losses) == 3 and all(map(lambda v: v == v, losses))
    assert losses[-1] < losses[0]
    assert res["cnn_rate"] > 0
    assert any(line.startswith("resnet_tiny: ") and "images/sec" in line
               and "/chip), loss=" in line for line in lines)


def test_cnn_benchmark_shard_optimizer_is_the_replicated_run(run):
    """SGD with momentum on fp32 parameters at world 1: the sharded run's
    parameters are the replicated run's, to the bit; one rank holds the
    whole momentum and an fp32 master copy of every parameter."""
    res, _ = run
    assert res["zero_equal"]
    assert res["zero_bytes"] == {"state": res["rep_state"],
                                 "master": res["param_bytes"]}


def test_bert_pretraining_trains(run):
    res, lines = run
    losses = res["bert_losses"]
    assert losses[-1] < losses[0] and res["bert_rate"] > 0
    assert any(line.startswith("sequences/sec: ") for line in lines)


def test_mnist_mlp_trains(run):
    res, lines = run
    assert len(res["mnist"]) == 2 and res["mnist"][-1] == res["mnist"][-1]
    assert [line.split(":")[0] for line in lines
            if line.startswith("epoch")] == ["epoch 0", "epoch 1"]


def test_gpt_long_context_takes_one_way_at_world_one(run):
    """``--sp 2`` does not divide a world of one: the mesh is 1 x 1, as in
    the reference, and the model runs unsharded (``--remat`` on)."""
    res, lines = run
    assert res["gpt_sp"] == [1, 1] and res["gpt_sp_axis"] is None
    assert res["gpt_losses"][-1] < res["gpt_losses"][0]
    assert any(line.startswith("tokens/sec: ") and "(mesh 1x1 dp x sp, "
               "seq 32)" in line for line in lines)


@pytest.mark.parametrize("world,seq_parallel,sp", [
    (1, True, 1), (2, True, 2), (4, True, 2), (4, False, 1)])
def test_bert_pretraining_sp_ways(world, seq_parallel, sp):
    from horovod_tpu_torch.examples import bert_pretraining

    assert bert_pretraining.sp_ways(world, seq_parallel) == sp


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_bert_seq_parallel_refuses_an_odd_world(monkeypatch, rank):
    """At np=3 each rank refuses ``--seq-parallel`` with the same
    ValueError before it builds a mesh or touches its device, so no rank
    goes on to a collective that another never joins (the reference
    leaves the odd device idle instead)."""
    from horovod_tpu_torch import basics, parallel
    from horovod_tpu_torch.examples import bert_pretraining

    def collective(*args, **kwargs):
        raise AssertionError("reached past the refusal")

    monkeypatch.setattr(basics, "size", lambda: 3)
    monkeypatch.setattr(basics, "rank", lambda: rank)
    monkeypatch.setattr(basics, "device", collective)
    monkeypatch.setattr(parallel, "build_mesh", collective)
    with pytest.raises(ValueError, match="even world .* got 3 ranks"):
        bert_pretraining.setup(["--seq-parallel", "--sp-flash"])
