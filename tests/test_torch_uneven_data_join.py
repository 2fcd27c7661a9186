"""``horovod_tpu_torch/examples/uneven_data_join.py`` against the JAX
package's ``examples/jax_uneven_data_join.py`` at np=2 on the CPU.

Two port ranks run the example's ``main`` and two reference ranks run the
reference example's loop (its data, its ``DistributedOptimizer(optax.sgd(
0.1))`` updates outside ``jit`` on the host ring, ``hvd.join()``), each
pair with its own native core; the libraries never share a process.  Rank
0 holds 40 batches and joins while rank 1 takes 15 more steps, averaging
with rank 0's zeros through the port's grad hooks.  Each rank's final
weights are held against the reference rank's within 1e-5: the two
frameworks sum a batch's 16 rows in another order (fp32), nothing else.
"""

import os
import socket
import subprocess

import numpy as np
import pytest
import torch

WORLD = 2
JOIN_TIMEOUT_S = 120
TOL = 1e-5


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(rank, port):
    for var in [v for v in os.environ if v.startswith("HOROVOD_")]:
        del os.environ[var]
    os.environ.update(
        HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(WORLD),
        HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(WORLD),
        HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
        HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
        HOROVOD_GLOO_TIMEOUT_SECONDS="60", HOROVOD_SHM_DISABLE="1")


def _port_worker(rank, port, outdir):
    torch.set_num_threads(1)
    _env(rank, port)
    from horovod_tpu_torch.examples import uneven_data_join

    res = uneven_data_join.main(["--device", "cpu"])
    np.save(os.path.join(outdir, f"port{rank}.npy"), res["w"])
    with open(os.path.join(outdir, f"port{rank}.txt"), "w") as f:
        f.write(f"{res['batches']} {res['last_joined']}")


def _reference_worker(rank, port, outdir):
    """The loop of ``examples/jax_uneven_data_join.py``, saving the final
    weights."""
    _env(rank, port)
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    import optax

    import horovod_tpu as hvd

    hvd.init(build_mesh=False)
    rng = np.random.RandomState(rank)
    w_true = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    batches = []
    for _ in range(40 + 15 * rank):
        x = rng.randn(16, 4).astype(np.float32)
        batches.append((x, x @ w_true))
    params = {"w": jnp.zeros(4)}
    tx = hvd.DistributedOptimizer(optax.sgd(0.1))
    opt_state = tx.init(params)
    params = hvd.broadcast_parameters(params, root_rank=0)

    @jax.jit
    def grads_fn(p, x, y):
        return jax.value_and_grad(
            lambda q: jnp.mean((x @ q["w"] - y) ** 2))(p)

    for x, y in batches:
        _, grads = grads_fn(params, jnp.asarray(x), jnp.asarray(y))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    last = hvd.join()
    np.save(os.path.join(outdir, f"reference{rank}.npy"),
            np.asarray(params["w"]))
    with open(os.path.join(outdir, f"reference{rank}.txt"), "w") as f:
        f.write(f"{len(batches)} {last}")
    hvd.shutdown()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import multiprocessing.forkserver

    from horovod_tpu_torch.ops import _build

    outdir = tmp_path_factory.mktemp("join")
    _build.build_core()
    cpp = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "horovod_tpu", "cpp")
    subprocess.run(["make", "-s"], cwd=cpp, check=True, capture_output=True)
    fork = torch.multiprocessing.get_context("forkserver")
    fork.set_forkserver_preload(["torch", "horovod_tpu_torch"])
    spawn = torch.multiprocessing.get_context("spawn")
    port, ref_port = _free_port(), _free_port()
    procs = [fork.Process(target=_port_worker, args=(r, port, str(outdir)))
             for r in range(WORLD)]
    procs += [spawn.Process(target=_reference_worker,
                            args=(r, ref_port, str(outdir)))
              for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
        multiprocessing.forkserver._forkserver._stop()
    assert not alive, f"{len(alive)} worker(s) did not finish in " \
                      f"{JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * len(procs)

    def read(kind, r):
        with open(outdir / f"{kind}{r}.txt") as f:
            n, last = f.read().split()
        return np.load(outdir / f"{kind}{r}.npy"), int(n), int(last)

    return {kind: [read(kind, r) for r in range(WORLD)]
            for kind in ("port", "reference")}


def test_ranks_hold_uneven_shards_and_rank1_joins_last(runs):
    for kind in ("port", "reference"):
        assert [(n, last) for _, n, last in runs[kind]] == [(40, 1),
                                                            (55, 1)], kind


@pytest.mark.parametrize("rank", range(WORLD))
def test_final_weights_match_the_reference(runs, rank):
    got, want = runs["port"][rank][0], runs["reference"][rank][0]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_rank1_trained_on_after_rank0_joined(runs):
    """Rank 1's 15 steps after the join moved its weights on from where
    both ranks stood when rank 0 stopped."""
    w0, w1 = runs["port"][0][0], runs["port"][1][0]
    assert np.max(np.abs(w1 - w0)) > 1e-4
    w_true = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    assert np.max(np.abs(w1 - w_true)) < np.max(np.abs(w0 - w_true))
