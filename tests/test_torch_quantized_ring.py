"""The port's quantized collectives and error-feedback optimizer against the
JAX package, bit for bit, at np=4 over gloo on the CPU.

One four-rank job runs per module: rank 0 in the test process, ranks 1-3 in
processes forked from a fork server that has torch loaded already (each
rank would otherwise pay for importing torch and what its optimizer pulls
in, about 4 s of CPU).  Each rank saves
what it computed; the tests hold it against the JAX functions run in
``shard_map`` over four devices of the conftest's CPU mesh, on the same
numpy inputs.  The JAX side is traced and compiled in a thread while the
ranks run.  Where the JAX functions reach a Pallas kernel they run the
jnp version of its arithmetic, as the JAX package does off the TPU
(``tests/test_torch_quantize.py`` holds that against the Pallas
interpreter).

Bitwise: codes, scales, collective results, reduced gradients of the
quantized leaves and the residuals.  The parameters after SGD within 1e-6
relative: torch's SGD adds ``-lr * g`` in one fused step where optax
multiplies and then adds.

The JAX side is imported inside the functions that use it: the peer ranks
import this module to find their worker, and need only torch.
"""

import os
import socket

import numpy as np
import pytest
import torch

WORLD = 4
JOIN_TIMEOUT_S = 120
# One byte above the negotiated device plane's smallest bucket (1024 fp32,
# ops/device_plane.py:bucket_len), whose codec floor is judged on the
# padded bucket as in the reference: a bucket of the small leaves below
# stays under the floor and takes the plain collective.
MIN_BYTES = 4097
LENGTH = 2 * 4096 + 37           # ragged: two int8g groups and a short block
CODECS = ("int8", "int4", "int8g")
SCHEDULES = ("ring", "bidi", "torus")
OPS = ("sum", "average")
GATHER_SHAPE = (5, 300)          # 1500 fp32 = 6000 bytes per rank
EF_SHAPES = {"w": (40, 70), "b": (7,)}   # w quantizes, b is below MIN_BYTES
EF_STEPS = 3
LR = 0.1
# Configuration both sides read: the demotion floor, and the ring schedule
# the error-feedback optimizer and the auto-dispatch take.
ENV = {"HOROVOD_WIRE_COMPRESSION_MIN_BYTES": str(MIN_BYTES),
       "HOROVOD_DEVICE_SCHEDULE": "ring"}
# The reference's programs are compiled as its codec's documentation says
# they compute (horovod_tpu/ops/quantize.py:40-43): correctly rounded
# divides and no fused multiply-add.  XLA's algebraic simplifier turns the
# scale's divide by the constant 127 (or 7) into a multiply by its rounded
# reciprocal, and XLA's CPU backend above optimization level 0 contracts
# the ring's decode-and-add into an fma; both are off here.  ROADMAP Queue
# 3 logs them, and tests/test_torch_quantize.py pins them.
REFERENCE_COMPILE = {"xla_backend_optimization_level": 0,
                     "xla_disable_hlo_passes": "algsimp"}


def _inputs():
    """Every rank's inputs, from one numpy generator."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((WORLD, LENGTH)).astype(np.float32)
    x[:, 100:356] *= 1e3          # a loud block beside quiet ones
    x[1, 4096:4352] = 0.0         # an all-zero block on one rank
    return {
        "x": x,
        "gather": rng.standard_normal((WORLD,) + GATHER_SHAPE).astype(
            np.float32),
        "ef_params": {k: rng.standard_normal(s).astype(np.float32)
                      for k, s in EF_SHAPES.items()},
        "ef_grads": {k: rng.standard_normal((WORLD, EF_STEPS) + s).astype(
            np.float32) for k, s in EF_SHAPES.items()},
    }


def _worker(rank, port, outdir):
    os.environ.update(
        HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(WORLD),
        HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(WORLD),
        HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
        HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
        HOROVOD_GLOO_TIMEOUT_SECONDS="60", **ENV,
        # The native core's host ring over TCP: no /dev/shm region, which
        # tests of the JAX package running meanwhile look for.
        HOROVOD_SHM_DISABLE="1")
    # A device codec for the auto-dispatch cases below; every other call
    # names its codec or demotes.  hvd.init() reads it once.
    os.environ["HOROVOD_WIRE_COMPRESSION"] = "device=int8"
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import collectives as col
    from horovod_tpu_torch.ops import quantize as qz

    inp = _inputs()
    hvd.init(device="cpu")
    res = {}
    x = torch.from_numpy(inp["x"][rank])
    qz.reset_device_byte_counters()
    for codec in CODECS:
        for sched in SCHEDULES:
            for op in OPS:
                res[f"ar/{codec}/{sched}/{op}"] = hvd.quantized_allreduce(
                    x, op=hvd.Sum if op == "sum" else hvd.Average,
                    codec=codec, schedule=sched)
    res["bytes"] = qz.device_byte_counters()
    g = torch.from_numpy(inp["gather"][rank])
    for codec in CODECS:
        res[f"ag/{codec}"] = hvd.quantized_allgather(g, codec=codec)
        res[f"bc/{codec}"] = hvd.quantized_broadcast(g, root_rank=2,
                                                     codec=codec)
    # Demotion: half precision and tensors under MIN_BYTES take the plain
    # collectives (held against the plain collective itself, the device
    # plane's executor, which the device codec does not reach).
    from horovod_tpu_torch.ops.device_plane import bucket_len, plain_allreduce

    def plain(t, op):
        return plain_allreduce(t.reshape(-1).clone(), op,
                               col._caller_ring()).reshape(t.shape)

    small = x[:MIN_BYTES // 4 - 1]
    res["demote/fp16"] = (hvd.quantized_allreduce(x.half()),
                          plain(x.half(), hvd.Sum))
    res["demote/small"] = (hvd.quantized_allreduce(small, op=hvd.Average),
                           plain(small, hvd.Average))
    res["demote/ragged_gather"] = hvd.quantized_allgather(g[:rank + 1])
    res["plain/small_sum"] = plain(small, hvd.Sum)
    # The negotiated entry points under the device codec: an fp32 allreduce
    # bucket at or above the floor rides the quantized ring, padded to its
    # bucket length; allgather and broadcast are exact.
    res["auto/allreduce"] = hvd.allreduce(x, op=hvd.Sum)
    res["auto/allgather"] = hvd.allgather(g)
    res["auto/broadcast"] = hvd.broadcast(g, root_rank=2)
    res["auto/small"] = hvd.allreduce(small, op=hvd.Sum)
    res["auto/bucket_len"] = bucket_len(LENGTH)
    # Error feedback: SGD on a linear loss sum(p * G[rank, step]), so each
    # rank's gradient is exactly its G.
    for codec in CODECS:
        params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                  for k, v in inp["ef_params"].items()}
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(params.values(), lr=LR),
            named_parameters=params.items(), device_compression=codec)
        steps = []
        for t in range(EF_STEPS):
            opt.zero_grad()
            loss = sum((p * torch.from_numpy(inp["ef_grads"][k][rank, t])
                        ).sum() for k, p in params.items())
            loss.backward()
            opt.step()
            steps.append({
                "grad": {k: p.grad.clone() for k, p in params.items()},
                "residual": {k: opt.state[p].get("ef_residual")
                             for k, p in params.items()},
                "param": {k: p.detach().clone() for k, p in params.items()}})
        res[f"ef/{codec}"] = steps
        res[f"ef_state_keys/{codec}"] = sorted(
            opt.state_dict()["state"][0].keys())
    hvd.shutdown()
    torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference):
    import multiprocessing.forkserver

    outdir = tmp_path_factory.mktemp("np4")
    ctx = torch.multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "torch._dynamo", "horovod_tpu_torch"])
    port = _free_port()
    peers = [ctx.Process(target=_worker, args=(r, port, str(outdir)))
             for r in range(1, WORLD)]
    for p in peers:
        p.start()
    saved = dict(os.environ)
    threads = torch.get_num_threads()
    try:
        _worker(0, port, str(outdir))
    finally:
        # Key by key, and only what rank 0 changed: the reference's thread
        # reads ENV meanwhile.
        for key in set(os.environ) | set(saved):
            if key not in saved:
                del os.environ[key]
            elif os.environ.get(key) != saved[key]:
                os.environ[key] = saved[key]
        torch.set_num_threads(threads)
        for p in peers:
            p.join(JOIN_TIMEOUT_S)
        alive = [p for p in peers if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
        multiprocessing.forkserver._forkserver._stop()
        if alive:
            pytest.fail(f"{len(alive)} peer rank(s) did not finish in "
                        f"{JOIN_TIMEOUT_S} s")
    assert [p.exitcode for p in peers] == [0] * (WORLD - 1)
    return [torch.load(outdir / f"rank{r}.pt") for r in range(WORLD)]


def _smap(fn, in_specs, out_specs, *args, check_vma=False):
    """``fn`` in shard_map over WORLD devices, compiled as REFERENCE_COMPILE
    says, applied to ``args``."""
    import jax
    from jax.sharding import Mesh

    from horovod_tpu.ops.collectives import shard_map

    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("hvd",))
    sm = shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_vma=check_vma)
    return jax.jit(sm).lower(*args).compile(REFERENCE_COMPILE)(*args)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.dtype(f"u{a.dtype.itemsize}"))


def _assert_bitwise(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    diff = np.flatnonzero(_bits(got) != _bits(want))
    assert diff.size == 0, (f"{what}: {diff.size} elements differ, first at "
                            f"{diff[:5]}: {got.reshape(-1)[diff[:5]]} vs "
                            f"{want.reshape(-1)[diff[:5]]}")


def _collectives_reference():
    """The JAX package's collectives on the workers' inputs, in one program
    per collective kind.  The reference's Average is its Sum ring's result
    divided by the world size (``out / world``,
    horovod_tpu/ops/collectives.py:820), exact at world 4, so the Average
    cases are held against the Sum ring's result / 4 and each ring is
    compiled once."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import horovod_tpu.ops.collectives as jcl
    from horovod_tpu.wire import ReduceOp as JReduceOp

    inp = _inputs()

    def allreduces(xl):
        return tuple(jcl.quantized_allreduce(
            xl.reshape(-1), "hvd", op=JReduceOp.SUM, min_bytes=MIN_BYTES,
            codec=codec, schedule=sched)[None]
            for codec in CODECS for sched in SCHEDULES)

    sums = _smap(allreduces, (P("hvd"),),
                 (P("hvd"),) * (len(CODECS) * len(SCHEDULES)),
                 jnp.asarray(inp["x"]))
    out = {}
    for (codec, sched), total in zip(
            [(c, s) for c in CODECS for s in SCHEDULES], sums):
        total = np.asarray(total)
        out[f"ar/{codec}/{sched}/sum"] = total
        out[f"ar/{codec}/{sched}/average"] = total / np.float32(WORLD)

    def gathers(gl):
        g = gl[0]
        res = []
        for codec in CODECS:
            res.append(jcl.quantized_allgather(
                g, "hvd", min_bytes=MIN_BYTES, codec=codec)[None])
            res.append(jcl.quantized_broadcast(
                g, 2, "hvd", min_bytes=MIN_BYTES, codec=codec)[None])
        return tuple(res)

    ga = _smap(gathers, (P("hvd"),), (P("hvd"),) * (2 * len(CODECS)),
               jnp.asarray(inp["gather"]))
    for i, codec in enumerate(CODECS):
        out[f"ag/{codec}"], out[f"bc/{codec}"] = ga[2 * i], ga[2 * i + 1]

    # The device plane's fused bucket: the input zero-padded to its bucket
    # length (LENGTH -> 10240), through the reference device plane's ring.
    padded = np.zeros((WORLD, 10240), np.float32)
    padded[:, :LENGTH] = inp["x"]
    out["bucket/int8"] = _smap(
        lambda xl: jcl._quantized_ring_allreduce_sum(
            xl[0], "hvd", None, "int8", "ring")[None],
        (P("hvd"),), P("hvd"), jnp.asarray(padded))
    return out


def _jax_side():
    out = _collectives_reference()
    out.update(_ef_steps())
    out["ef_vma/int8"] = _ef_with_vma_tracking()
    return out


@pytest.fixture(scope="module")
def reference():
    """A future of every JAX-side result, computed in a thread from the
    moment the module's first test asks (the ranks fixture asks for it
    before it starts the ranks).  The reference reads its demotion floor
    and ring schedule at trace time, from the live context when one is
    initialized, else from the environment: both are set as ENV."""
    from concurrent.futures import ThreadPoolExecutor

    from horovod_tpu.context import HorovodContext

    saved_env = {k: os.environ.get(k) for k in ENV}
    os.environ.update(ENV)
    cfg = (HorovodContext.instance().cfg if HorovodContext.initialized()
           else None)
    fields = {"wire_compression_min_bytes": MIN_BYTES,
              "device_schedule": "ring"}
    saved_cfg = {k: getattr(cfg, k, None) for k in fields}
    for k, v in fields.items():
        if cfg is not None:
            setattr(cfg, k, v)
    pool = ThreadPoolExecutor(1)
    future = pool.submit(_jax_side)
    try:
        yield future
    finally:
        pool.shutdown(wait=True)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if cfg is not None:
            for k, v in saved_cfg.items():
                setattr(cfg, k, v)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("op", OPS)
def test_quantized_allreduce_matches_jax_bitwise(ranks, reference, codec,
                                                 schedule, op):
    key = f"ar/{codec}/{schedule}/{op}"
    want = np.asarray(reference.result()[key])
    for r in range(WORLD):
        _assert_bitwise(ranks[r][key], want[r], f"{key} rank {r}")
        _assert_bitwise(ranks[r][key], want[0], f"{key} rank {r} vs rank 0")


def test_quantized_allreduce_bytes(ranks):
    from horovod_tpu_torch.ops import quantize as qz

    want = [0, 0]
    for codec in CODECS:
        for sched in SCHEDULES:
            raw, enc = qz.ring_bytes(LENGTH, WORLD, codec, sched)
            want[0] += 2 * raw   # Sum and Average
            want[1] += 2 * enc
    for r in ranks:
        assert tuple(r["bytes"]) == tuple(want)


@pytest.mark.parametrize("codec", CODECS)
def test_quantized_allgather_and_broadcast_match_jax(ranks, reference, codec):
    for kind in ("ag", "bc"):
        key = f"{kind}/{codec}"
        want = np.asarray(reference.result()[key])
        for r in range(WORLD):
            _assert_bitwise(ranks[r][key], want[r], f"{key} rank {r}")
            _assert_bitwise(ranks[r][key], want[0], f"{key} rank {r} vs 0")


def test_demotion_is_the_plain_collective(ranks):
    inp = _inputs()
    for r in ranks:
        for key in ("demote/fp16", "demote/small"):
            got, plain = r[key]
            assert got.dtype == plain.dtype
            _assert_bitwise(got, plain.numpy(), key)
    # Unequal dim 0 takes the plain ragged allgather.
    want = np.concatenate([inp["gather"][q][:q + 1] for q in range(WORLD)])
    for r in ranks:
        _assert_bitwise(r["demote/ragged_gather"], want, "ragged gather")


def test_auto_dispatch_under_device_codec(ranks, reference):
    """hvd.allreduce under HOROVOD_WIRE_COMPRESSION=device=int8 is the
    negotiated device plane's quantized ring on the bucket zero-padded to
    its length, bit for bit the reference device plane's; under the floor
    the plain Sum runs; allgather and broadcast are exact."""
    inp = _inputs()
    bucket = np.asarray(reference.result()["bucket/int8"])
    for rank, r in enumerate(ranks):
        assert r["auto/bucket_len"] == bucket.shape[1]
        # The configured schedule (ENV) is ring.
        _assert_bitwise(r["auto/allreduce"], bucket[rank][:LENGTH],
                        "auto allreduce")
        _assert_bitwise(r["auto/allgather"],
                        inp["gather"].reshape((-1,) + GATHER_SHAPE[1:]),
                        "auto allgather")
        _assert_bitwise(r["auto/broadcast"], inp["gather"][2],
                        "auto broadcast")
        _assert_bitwise(r["auto/small"], r["plain/small_sum"].numpy(),
                        "auto small")


def _record_sgd(lr):
    """optax SGD whose state keeps the gradients it was handed, so the
    reference's reduced gradients can be read back."""
    import jax
    import jax.numpy as jnp
    import optax

    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(lambda g: -lr * g, grads), grads

    return optax.GradientTransformation(init, update)


def _ef_steps():
    """EF_STEPS steps of the reference's DistributedOptimizer(optax SGD,
    device_compression=codec) for each codec, in one program with a
    ``lax.scan`` over the steps: per codec and step the reduced gradients,
    the residuals and the parameters, each with a leading device axis."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    import horovod_tpu.ops.collectives as jcl
    from horovod_tpu.optimizer import DistributedOptimizer

    inp = _inputs()

    def steps(tx, params, grads):
        def step(carry, g):
            params, state = carry
            upd, state = tx.update(g, state, params)
            params = optax.apply_updates(params, upd)
            out = jax.tree_util.tree_map(
                lambda a: jcl.ensure_varying(a, "hvd")[None],
                (state.inner_state, state.residual, params))
            return (params, state), out

        return jax.lax.scan(step, (params, tx.init(params)), grads)[1]

    def run(params, grads):
        local = {k: v[0] for k, v in grads.items()}
        return tuple(steps(DistributedOptimizer(
            _record_sgd(LR), device_compression=codec, axis_name="hvd"),
            params, local) for codec in CODECS)

    params = {k: jnp.asarray(v) for k, v in inp["ef_params"].items()}
    grads = {k: jnp.asarray(v) for k, v in inp["ef_grads"].items()}
    stacked = _smap(run, (P(), P("hvd")), P(None, "hvd"), params, grads)
    return {f"ef/{codec}": [jax.tree_util.tree_map(
        lambda a: np.asarray(a[t]), by_codec) for t in range(EF_STEPS)]
        for codec, by_codec in zip(CODECS, stacked)}


@pytest.mark.parametrize("codec", CODECS)
def test_error_feedback_steps_match_jax(ranks, reference, codec):
    """Three steps of DistributedOptimizer(SGD, device_compression=codec)
    against the reference's (optax SGD), each rank's gradient injected
    exactly.  ``check_vma=False`` as in tests/single/test_optimizer.py
    (ROADMAP Queue 3)."""
    steps = reference.result()[f"ef/{codec}"]
    for t, (jgrad, jres, jparam) in enumerate(steps):
        for r in range(WORLD):
            got = ranks[r][f"ef/{codec}"][t]
            what = f"{codec} step {t} rank {r}"
            _assert_bitwise(got["grad"]["w"], jgrad["w"][r], what + " grad")
            np.testing.assert_allclose(got["grad"]["b"], jgrad["b"][r],
                                       rtol=1e-6, atol=1e-7)
            _assert_bitwise(got["residual"]["w"], jres["w"][r],
                            what + " residual")
            assert got["residual"]["b"] is None  # demoted: zero residual
            assert not np.any(np.asarray(jres["b"][r]))
            for k in EF_SHAPES:
                np.testing.assert_allclose(got["param"][k], jparam[k][r],
                                           rtol=1e-6, atol=1e-7)
    assert "ef_residual" in ranks[0][f"ef_state_keys/{codec}"]


def _ef_with_vma_tracking():
    """One step of the reference's int8 error feedback with vma tracking on
    (jax's default) and the gradient from AD of a replicated parameter:
    the reduced gradient of "w" on device 0."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import horovod_tpu.ops.collectives as jcl
    from horovod_tpu.optimizer import DistributedOptimizer

    inp = _inputs()
    tx = DistributedOptimizer(_record_sgd(LR), device_compression="int8",
                              axis_name="hvd")

    def step(params, grads):
        local = {k: v[0, 0] for k, v in grads.items()}
        g = jax.grad(lambda p: sum(jnp.sum(p[k] * local[k]) for k in p))(
            params)
        _, state = tx.update(g, tx.init(params), params)
        return jcl.ensure_varying(state.inner_state["w"], "hvd")[None]

    params = {k: jnp.asarray(v) for k, v in inp["ef_params"].items()}
    grads = {k: jnp.asarray(v) for k, v in inp["ef_grads"].items()}
    return np.asarray(_smap(step, (P(), P("hvd")), P("hvd"), params, grads,
                            check_vma=True))[0]


def test_reference_ef_under_vma_tracking_is_world_times_the_mean(ranks,
                                                                 reference):
    """Pins ROADMAP Queue 3 for the error-feedback branch.  With vma
    tracking on (``check_vma=True``, jax's default), AD of a replicated
    parameter hands ``reduce_grads_ef`` a gradient already summed over the
    axis; the tree is all-invariant, so its ``varying`` test passes every
    leaf and the quantized ring sums the sum again: after Average the
    reduced gradient is world x the mean the port computes (the port
    matches the reference with tracking off bitwise, above)."""
    reduced = reference.result()["ef_vma/int8"]
    port = ranks[0]["ef/int8"][0]["grad"]["w"].numpy()
    ratio = np.linalg.norm(reduced) / np.linalg.norm(port)
    assert abs(ratio - WORLD) < 0.02 * WORLD, ratio
    np.testing.assert_allclose(reduced / WORLD, port, atol=0.05)
