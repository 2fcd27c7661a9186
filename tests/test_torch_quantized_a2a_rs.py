"""The port's quantized alltoall and reducescatter against the JAX package's,
bit for bit, at np=2 and np=4 over gloo on the CPU.

One job per world size, every rank a process forked from a fork server that
has torch and the port loaded already (the test process starts no rank);
each job's rank 0 picks its rendezvous port just before its ``hvd.init``
(``tests/test_torch_spine.py``'s ``_phase_port``), so the two jobs never
meet on one port.
Each rank runs ``hvd.quantized_alltoall`` and ``hvd.quantized_reducescatter``
(Sum and Average) for the three codecs on the same seeded numpy inputs,
then the demotions: fp16 and a tensor under the byte floor take the plain
collective (held against ``device_plane.plain_alltoall`` /
``plain_reducescatter`` on the same ranks, bitwise); a dim 0 the world does
not divide, a 0-d tensor and the Min op raise ``ValueError``.

The reference is ``horovod_tpu.ops.collectives.quantized_alltoall`` and
``quantized_reducescatter`` in ``shard_map`` over the conftest's CPU mesh,
compiled in a thread of the test process while the ranks run, as its
codec's documentation says it computes (algsimp off, optimization level 0;
ROADMAP Queue 3).  Its Average is its Sum ring's result divided by the
world size, exact at 2 and 4, so Average is held against Sum / world.
Where the JAX functions reach a Pallas kernel they run the jnp version of
its arithmetic, as the JAX package does off the TPU.  Its plain alltoall
and reducescatter refuse a dim 0 the world does not divide with a
ValueError, as the port's do.  Every comparison is bitwise; the byte counters are exact.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_spine import _phase_port

WORLDS = (2, 4)
JOIN_TIMEOUT_S = 120
CODECS = ("int8", "int4", "int8g")
ROWS, COLS = 8, 600          # 4800 fp32 a rank; a chunk of 1200 at np=4
MIN_BYTES = 4096
REFERENCE_COMPILE = {"xla_backend_optimization_level": 0,
                     "xla_disable_hlo_passes": "algsimp"}


def _inputs(world):
    rng = np.random.default_rng(23 + world)
    x = rng.standard_normal((world, ROWS, COLS)).astype(np.float32)
    x[:, 1, :256] *= 1e3          # a loud block beside quiet ones
    x[0, 5, :] = 0.0              # all-zero blocks on one rank
    return x


def _worker(rank, world, outdir):
    port = _phase_port(outdir, rank, f"np{world}")
    os.environ.update(
        HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(world),
        HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(world),
        HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
        HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
        HOROVOD_GLOO_TIMEOUT_SECONDS="60", HOROVOD_SHM_DISABLE="1")
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import quantize as qz
    from horovod_tpu_torch.ops.collectives import _caller_ring
    from horovod_tpu_torch.ops.device_plane import (plain_alltoall,
                                                    plain_reducescatter)

    hvd.init(device="cpu")
    x = torch.from_numpy(_inputs(world)[rank])
    res = {}
    qz.reset_device_byte_counters()
    for codec in CODECS:
        res[f"a2a/{codec}"] = hvd.quantized_alltoall(
            x, min_bytes=MIN_BYTES, codec=codec)
        for op in ("Sum", "Average"):
            res[f"rs/{codec}/{op}"] = hvd.quantized_reducescatter(
                x, op=getattr(hvd, op), min_bytes=MIN_BYTES, codec=codec)
    res["bytes"] = qz.device_byte_counters()
    ring = _caller_ring()
    half, small = x.half(), x[:, :100].contiguous()
    res["demote/a2a/fp16"] = (hvd.quantized_alltoall(half, MIN_BYTES),
                              plain_alltoall(half, ring))
    res["demote/a2a/small"] = (hvd.quantized_alltoall(small, MIN_BYTES),
                               plain_alltoall(small, ring))
    res["demote/rs/fp16"] = (
        hvd.quantized_reducescatter(half, hvd.Sum, MIN_BYTES),
        plain_reducescatter(half, hvd.Sum, ring))
    res["demote/rs/small"] = (
        hvd.quantized_reducescatter(small, hvd.Average, MIN_BYTES),
        plain_reducescatter(small, hvd.Average, ring))
    res["demote/bytes"] = qz.device_byte_counters()
    errors = {
        "a2a/odd_rows": lambda: hvd.quantized_alltoall(x[:world + 1]),
        "rs/odd_rows": lambda: hvd.quantized_reducescatter(x[:world + 1]),
        "a2a/scalar": lambda: hvd.quantized_alltoall(torch.tensor(1.0)),
        "rs/scalar": lambda: hvd.quantized_reducescatter(torch.tensor(1.0)),
        "rs/min": lambda: hvd.quantized_reducescatter(x, op=hvd.Min),
    }
    for key, call in errors.items():
        try:
            call()
            res[f"error/{key}"] = "no error"
        except ValueError as exc:
            res[f"error/{key}"] = str(exc)
    hvd.shutdown()
    torch.save(res, os.path.join(outdir, f"np{world}.rank{rank}.pt"))


def _smap(fn, n, world, x):
    """``fn`` (n outputs) in shard_map over ``world`` devices, compiled as
    REFERENCE_COMPILE says, applied to ``x``'s per-device rows."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu.ops.collectives import shard_map

    mesh = Mesh(np.asarray(jax.devices()[:world]), ("hvd",))
    sm = shard_map(lambda xl: tuple(o[None] for o in fn(xl[0])), mesh=mesh,
                   in_specs=(P("hvd"),), out_specs=(P("hvd"),) * n,
                   check_vma=False)
    return jax.jit(sm).lower(x).compile(REFERENCE_COMPILE)(x)


def _jax_side():
    import jax.numpy as jnp

    import horovod_tpu.ops.collectives as jcl
    from horovod_tpu.wire import ReduceOp as JReduceOp

    out = {}
    for world in WORLDS:
        def both(x):
            return tuple(
                [jcl.quantized_alltoall(x, "hvd", min_bytes=MIN_BYTES,
                                        codec=c) for c in CODECS]
                + [jcl.quantized_reducescatter(
                    x, "hvd", op=JReduceOp.SUM, min_bytes=MIN_BYTES,
                    codec=c) for c in CODECS])

        res = _smap(both, 2 * len(CODECS), world,
                   jnp.asarray(_inputs(world)))
        for i, codec in enumerate(CODECS):
            out[f"{world}/a2a/{codec}"] = np.asarray(res[i])
            out[f"{world}/rs/{codec}/Sum"] = np.asarray(res[3 + i])
            out[f"{world}/rs/{codec}/Average"] = \
                np.asarray(res[3 + i]) / np.float32(world)
        # A dim 0 the world does not divide: the plain collectives refuse.
        odd = jnp.zeros((world, world + 1, COLS), jnp.float32)
        for kind, fn in (("a2a", jcl.quantized_alltoall),
                         ("rs", jcl.quantized_reducescatter)):
            try:
                _smap(lambda x, fn=fn: (fn(x, "hvd", min_bytes=MIN_BYTES),),
                      1, world, odd)
                out[f"{world}/error/{kind}/odd_rows"] = "no error"
            except Exception as exc:  # noqa: BLE001 - the refusal is held
                out[f"{world}/error/{kind}/odd_rows"] = type(exc).__name__
    return out


@pytest.fixture(scope="module")
def reference():
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(1)
    future = pool.submit(_jax_side)
    try:
        yield future
    finally:
        pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference):
    import multiprocessing.forkserver

    outdir = tmp_path_factory.mktemp("a2a_rs")
    ctx = torch.multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "horovod_tpu_torch"])
    procs = [ctx.Process(target=_worker, args=(r, world, str(outdir)))
             for world in WORLDS for r in range(world)]
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
    assert not alive, f"{len(alive)} rank(s) did not finish in " \
                      f"{JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    return {world: [torch.load(outdir / f"np{world}.rank{r}.pt")
                    for r in range(world)] for world in WORLDS}


def _assert_bitwise(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (what, got.dtype, want.dtype, got.shape, want.shape)
    bits = np.dtype(f"u{got.dtype.itemsize}")
    diff = np.flatnonzero(got.view(bits) != want.view(bits))
    assert diff.size == 0, (f"{what}: {diff.size} elements differ, first "
                            f"at {diff[:5]}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("codec", CODECS)
def test_quantized_alltoall_matches_jax_bitwise(ranks, reference, world,
                                                codec):
    want = reference.result()[f"{world}/a2a/{codec}"]
    for r in range(world):
        _assert_bitwise(ranks[world][r][f"a2a/{codec}"], want[r],
                        f"np{world} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("op", ("Sum", "Average"))
def test_quantized_reducescatter_matches_jax_bitwise(ranks, reference, world,
                                                     codec, op):
    want = reference.result()[f"{world}/rs/{codec}/{op}"]
    for r in range(world):
        _assert_bitwise(ranks[world][r][f"rs/{codec}/{op}"], want[r],
                        f"np{world} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
def test_byte_counters_follow_the_formula(ranks, world):
    """(world-1)·c·4 raw and (world-1)·encoded_nbytes(c) encoded bytes per
    call, c the chunk a rank sends per destination or hop; a demoted call
    counts nothing."""
    from horovod_tpu_torch.ops import quantize as qz

    c = ROWS * COLS // world
    raw = enc = 0
    for codec in CODECS:
        raw += 3 * (world - 1) * c * 4          # alltoall, Sum, Average
        enc += 3 * (world - 1) * qz.encoded_nbytes(c, codec)
    for r in ranks[world]:
        assert tuple(r["bytes"]) == (raw, enc)
        assert tuple(r["demote/bytes"]) == (raw, enc)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ("a2a/fp16", "a2a/small", "rs/fp16",
                                  "rs/small"))
def test_ineligible_input_is_the_plain_collective(ranks, world, case):
    for r in ranks[world]:
        got, plain = r[f"demote/{case}"]
        _assert_bitwise(got, plain, f"np{world} {case}")


@pytest.mark.parametrize("world", WORLDS)
def test_refusals_match_the_reference(ranks, reference, world):
    for r in ranks[world]:
        for kind in ("a2a", "rs"):
            assert "divisible" in r[f"error/{kind}/odd_rows"]
            assert "divisible" in r[f"error/{kind}/scalar"]
            assert reference.result()[f"{world}/error/{kind}/odd_rows"] == \
                "ValueError"
        assert "Sum and Average" in r["error/rs/min"]
