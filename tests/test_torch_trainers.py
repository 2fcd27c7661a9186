"""The ported trainers (``horovod_tpu_torch.examples``) at a small size on
the CPU: one world-1 process after ``hvd.init(device="cpu")`` runs each
``main(argv)`` as ``chip_smoke.py`` runs them on the card, and ZeRO-1
beside the replicated optimizer on the same seed."""

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
    mnist_mlp
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
