"""The negotiated eager spine of the port against the JAX package's, at np=2
on the CPU.

Four worker processes run at once: two ranks of the port
(``horovod_tpu_torch``, ``init(device="cpu")``) and two ranks of the
reference (``horovod_tpu``'s eager API with numpy inputs, and its torch
binding's DistributedOptimizer), each pair with its own native core, fed
the same seeded numpy inputs.  The two libraries never share a process.
Each rank saves what it computed; the tests compare the files.

- The eager cases (every allreduce op, pre/postscale, Adasum, grouped ops,
  ragged allgather, broadcast, alltoall with received splits,
  reducescatter with the reference's extra-row split, barrier, process
  sets, join, duplicate-name deferral, a shape mismatch) run through the
  port twice: numpy arrays ride the host ring, CPU tensors the device
  plane (gloo here).  Both must equal the reference bit for bit.
- bf16 and fp16 tensors scaled on the device plane (a one-member set,
  a fused allreduce, a reducescatter), bitwise against the reference
  device plane's arithmetic ``x * jnp.asarray(f, dtype)``: the factor
  rounded to the tensor's dtype first.
- A fused fp32 bucket under ``HOROVOD_WIRE_COMPRESSION=device=<codec>``
  for int8, int4 and int8g against the reference's
  ``_quantized_ring_allreduce_sum`` over two devices of the conftest's CPU
  mesh on the same zero-padded bucket, compiled as its codec's
  documentation says it computes (ROADMAP Queue 3): bitwise.
- The host ring's C++ wire codec (``HOROVOD_WIRE_COMPRESSION=int8`` on a
  ring whose every hop crosses hosts, ``HOROVOD_HIER_FAKE_HOSTS=2``)
  against the port's ``ops/quantize.py`` ring on the same bytes: bitwise.
- Two AdamW steps of a tiny GPT through the port's negotiated
  DistributedOptimizer (plain, ``num_groups=2``, ``groups=``) against
  ``horovod_tpu/torch/optimizer.py`` on the same weights and batches,
  within 1e-6 (both reduce the same fp32 gradients by a sum of two and a
  halving, so they agree to the bit in practice; the tolerance leaves room
  for the backward's summation order), and a step mixing error-feedback
  leaves with negotiated ones.

The JAX side of the codec parity is computed in a thread of the test
process while the workers run.  Both native cores are built before the
workers start; each worker starts without the ``HOROVOD_*`` settings of
the process that spawned it, and takes each rendezvous port from rank 0
just before the ``hvd.init`` that uses it.
"""

import os
import socket
import subprocess
import time

import numpy as np
import pytest
import torch

WORLD = 2
JOIN_TIMEOUT_S = 120
CODECS = ("int8", "int4", "int8g")
BUCKET = (3000, 2500, 37)       # one fused bucket: 5537 -> 6144 padded
BUCKET_LEN = 6144
HOST_CODEC_LEN = 3000           # even: the C++ ring's chunks are the port's
OPT_TOL = 1e-6
REFERENCE_COMPILE = {"xla_backend_optimization_level": 0,
                     "xla_disable_hlo_passes": "algsimp"}
OPS = ("Average", "Sum", "Min", "Max", "Product", "Adasum")


def _inputs():
    rng = np.random.default_rng(11)
    return {
        "x": rng.standard_normal((WORLD, 5, 7)).astype(np.float32),
        "y": rng.standard_normal((WORLD, 9)).astype(np.float32),
        "i": rng.integers(-50, 50, (WORLD, 6)).astype(np.int32),
        "rows": rng.standard_normal((WORLD, 2, 3)).astype(np.float32),
        "a2a": rng.standard_normal((WORLD, 3, 2)).astype(np.float32),
        "rs": rng.standard_normal((WORLD, 5, 3)).astype(np.float32),
        "bucket": [rng.standard_normal((WORLD, n)).astype(np.float32)
                   for n in BUCKET],
        "host_codec": rng.standard_normal(
            (WORLD, HOST_CODEC_LEN)).astype(np.float32),
        "ids": rng.integers(0, 128, (WORLD, 2, 16)).astype(np.int64),
    }


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, (tuple, list)):
        return type(v)(_np(x) for x in v)
    return np.asarray(v)


def _eager_cases(hvd, to, rank, tag):
    """The same calls for both packages; ``to`` turns a numpy input into
    what the call takes.  Returns name -> numpy result."""
    inp = _inputs()
    x = to(inp["x"][rank])
    out = {}
    for op in OPS:
        out[f"allreduce/{op}"] = hvd.allreduce(x, op=getattr(hvd, op),
                                               name=f"{tag}.ar.{op}")
    out["allreduce/sum_scaled"] = hvd.allreduce(
        x, op=hvd.Sum, prescale_factor=2.5, postscale_factor=0.3,
        name=f"{tag}.ar.sum_scaled")
    out["allreduce/avg_scaled"] = hvd.allreduce(
        x, prescale_factor=3.0, postscale_factor=0.5,
        name=f"{tag}.ar.avg_scaled")
    out["allreduce/f64"] = hvd.allreduce(
        to(inp["x"][rank].astype(np.float64)), op=hvd.Sum,
        name=f"{tag}.ar.f64")
    out["allreduce/i32"] = hvd.allreduce(to(inp["i"][rank]), op=hvd.Sum,
                                         name=f"{tag}.ar.i32")
    out["grouped"] = hvd.grouped_allreduce(
        [x, to(inp["y"][rank])], op=hvd.Sum, name=f"{tag}.grouped")
    out["grouped_unnamed"] = hvd.grouped_allreduce(
        [to(inp["y"][rank]), x], op=hvd.Average)
    out["allgather"] = hvd.allgather(to(inp["rows"][rank][:rank + 1]),
                                     name=f"{tag}.ag")
    out["grouped_allgather"] = hvd.grouped_allgather(
        [x, to(inp["rows"][rank][:2 - rank])], name=f"{tag}.gag")
    out["broadcast"] = hvd.broadcast(x, root_rank=1, name=f"{tag}.bc")
    out["alltoall"] = hvd.alltoall(to(inp["a2a"][rank]),
                                   splits=[1, 2] if rank == 0 else [3, 0],
                                   name=f"{tag}.a2a")
    out["alltoall_even"] = hvd.alltoall(to(inp["rows"][rank]),
                                        name=f"{tag}.a2a_even")
    out["reducescatter/even"] = hvd.reducescatter(
        to(inp["rs"][rank][:4]), op=hvd.Sum, name=f"{tag}.rs_even")
    out["reducescatter/odd"] = hvd.reducescatter(
        to(inp["rs"][rank]), name=f"{tag}.rs_odd")
    out["reducescatter/scaled"] = hvd.reducescatter(
        to(inp["rs"][rank][:4]), op=hvd.Sum, prescale_factor=0.5,
        postscale_factor=3.0, name=f"{tag}.rs_scaled")
    hvd.barrier()
    # Duplicate names: the second instance waits for the first.
    h1 = hvd.allreduce_async(x, op=hvd.Sum, name=f"{tag}.dup")
    h2 = hvd.allreduce_async(to(inp["x"][rank] * 2), op=hvd.Sum,
                             name=f"{tag}.dup")
    out["dup"] = [hvd.synchronize(h1), hvd.synchronize(h2)]
    return {k: _np(v) for k, v in out.items()}


def _set_cases(hvd, to, rank, tag, sets):
    """Collectives on process sets (registered by the caller, in the same
    order on every rank): each rank's singleton set, then both ranks."""
    x = to(_inputs()["x"][rank])
    own, both = sets[rank], sets[2]
    return {
        "set/own": _np(hvd.allreduce(x, op=hvd.Sum, process_set=own,
                                     name=f"{tag}.own{rank}")),
        "set/both": _np(hvd.allreduce(x, op=hvd.Max, process_set=both,
                                      name=f"{tag}.both")),
        "set/both_ag": _np(hvd.allgather(x, process_set=both,
                                         name=f"{tag}.both_ag")),
    }


def _join_cases(hvd, to, rank, tag):
    """Rank 1 joins first; rank 0's Sum then runs with rank 1's zeros."""
    out = {}
    if rank == 0:
        out["joined_sum"] = _np(hvd.allreduce(
            to(_inputs()["x"][0]), op=hvd.Sum, name=f"{tag}.joined"))
    out["join"] = hvd.join()
    return out


SCALE_FACTORS = (0.3, 0.1, 1 / 3, 2.5)
SCALE_DTYPES = ("bfloat16", "float16")


def _scale_cases(hvd, rank, sets):
    """16-bit tensors scaled on the device plane, each factor as prescale
    with the next one as postscale: through a one-member set (the identity
    path, no transfer), a fused two-member Sum and a Sum reducescatter.
    Results are returned as fp32 (exact for 16-bit values)."""
    inp = _inputs()
    out = {}
    for dt in SCALE_DTYPES:
        cast = getattr(torch, dt)
        x = torch.from_numpy(inp["x"][rank]).to(cast)
        y = torch.from_numpy(inp["y"][rank]).to(cast)
        rs = torch.from_numpy(inp["rs"][rank][:4]).to(cast)
        for i, pre in enumerate(SCALE_FACTORS):
            post = SCALE_FACTORS[(i + 1) % len(SCALE_FACTORS)]
            kw = dict(op=hvd.Sum, prescale_factor=pre, postscale_factor=post)
            tag = f"{dt}.{i}"
            got = {
                "own": hvd.allreduce(x, process_set=sets[rank],
                                     name=f"scale.own{rank}.{tag}", **kw),
                "fused": hvd.grouped_allreduce([x, y],
                                               name=f"scale.fused.{tag}",
                                               **kw),
                "rs": hvd.reducescatter(rs, name=f"scale.rs.{tag}", **kw)}
            out[(dt, i)] = {k: _np([t.float() for t in v]
                                   if isinstance(v, list) else v.float())
                            for k, v in got.items()}
    return out


def _mismatch(hvd, to, rank):
    """A shape that differs across ranks under one name: both raise."""
    try:
        hvd.allreduce(to(np.ones(3 + rank, np.float32)), name="mismatch")
    except Exception as exc:  # the error is the result
        return f"{type(exc).__name__}: {exc}"
    return "no error"


def _opt_variants(params):
    names = [n for n, _ in params]
    half = len(names) // 2
    by_name = dict(params)
    return {"plain": {}, "num_groups": {"num_groups": 2},
            "groups": {"groups": [[by_name[n] for n in names[:half]],
                                  [by_name[n] for n in names[half:]]]}}


def _gpt_steps(rank, make_optimizer):
    """Two AdamW steps of a tiny GPT on this rank's batches; returns the
    parameters after each step."""
    from horovod_tpu_torch import models

    cfg = models.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                           num_heads=4, max_seq_len=32, use_flash=True,
                           dtype=torch.float32)
    ids = torch.from_numpy(_inputs()["ids"][rank])
    out = {}
    torch.manual_seed(0)
    model = models.GPT(cfg)
    base = {k: v.clone() for k, v in model.state_dict().items()}
    for variant, kwargs in _opt_variants(
            list(model.named_parameters())).items():
        model.load_state_dict(base)
        opt = make_optimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-3, eps=1e-6,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters(), **kwargs)
        steps = []
        for _ in range(2):
            opt.zero_grad()
            models.lm_loss(model(ids), ids).backward()
            opt.step()
            steps.append({n: p.detach().clone().numpy()
                          for n, p in model.named_parameters()})
        out[variant] = steps
    return out


def _env(rank, port, **extra):
    # A pytest worker's environment carries whatever earlier test files in
    # that process left in it; a worker of this file starts from none of
    # their HOROVOD_* settings.
    for var in [v for v in os.environ if v.startswith("HOROVOD_")]:
        del os.environ[var]
    os.environ.update(
        HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(WORLD),
        HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(WORLD),
        HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
        HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
        HOROVOD_GLOO_TIMEOUT_SECONDS="60",
        # The host ring over TCP: no /dev/shm region, which tests of the
        # JAX package running meanwhile look for.
        HOROVOD_SHM_DISABLE="1", **extra)


def _port_worker(rank, outdir):
    torch.set_num_threads(1)
    _env(rank, _phase_port(outdir, rank, "port"))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.context import HorovodContext
    from horovod_tpu_torch.ops.device_plane import bucket_len

    res = {}
    hvd.init(device="cpu")
    res["host"] = _eager_cases(hvd, np.asarray, rank, "h")
    # Names of their own: the response cache replays a name's negotiated
    # plane, and the host pass above negotiated the host ring.
    res["device"] = _eager_cases(hvd, torch.from_numpy, rank, "d")
    sets = [hvd.add_process_set([0]), hvd.add_process_set([1]),
            hvd.add_process_set([0, 1])]
    res["host"].update(_set_cases(hvd, np.asarray, rank, "h", sets))
    res["device"].update(_set_cases(hvd, torch.from_numpy, rank, "d", sets))
    res["scale16"] = _scale_cases(hvd, rank, sets)
    res["mismatch"] = _mismatch(hvd, torch.from_numpy, rank)
    res["opt"] = _gpt_steps(rank, hvd.DistributedOptimizer)
    res["ef_mix"] = _ef_mix(hvd, rank)
    res["device_stats"] = dict(HorovodContext.instance().device_plane.stats)
    res["device"].update(_join_cases(hvd, torch.from_numpy, rank, "d"))
    res["host"].update(_join_cases(hvd, np.asarray, rank, "h"))
    res["join_stats"] = dict(HorovodContext.instance().device_plane.stats)
    hvd.shutdown()

    inp = _inputs()
    for codec in CODECS:
        _env(rank, _phase_port(outdir, rank, codec),
             HOROVOD_WIRE_COMPRESSION=f"device={codec}",
             HOROVOD_WIRE_COMPRESSION_MIN_BYTES="4096")
        hvd.init(device="cpu")
        members = [torch.from_numpy(b[rank]) for b in inp["bucket"]]
        res[f"bucket/{codec}"] = _np(hvd.grouped_allreduce(
            members, op=hvd.Sum, name="bucket"))
        plane = HorovodContext.instance().device_plane
        res[f"bucket_log/{codec}"] = list(plane.bucket_log)
        res[f"bucket_len/{codec}"] = bucket_len(sum(BUCKET))
        hvd.shutdown()

    _env(rank, _phase_port(outdir, rank, "host_codec"),
         HOROVOD_WIRE_COMPRESSION="int8",
         HOROVOD_HIER_FAKE_HOSTS=str(WORLD),
         HOROVOD_WIRE_COMPRESSION_MIN_BYTES="1")
    hvd.init(device="cpu")
    res["host_codec"] = _np(hvd.allreduce(inp["host_codec"][rank],
                                          op=hvd.Sum, name="host_codec"))
    res["host_codec_bytes"] = HorovodContext.instance().core.data_plane_stats()
    hvd.shutdown()
    torch.save(res, os.path.join(outdir, f"port{rank}.pt"))


def _ef_mix(hvd, rank):
    """One step of error feedback (a 20000-element leaf, past the 64 KiB
    floor) beside negotiated leaves (the small ones): the EF ring runs on
    the caller's thread and group while the executor runs the others."""
    torch.manual_seed(1)
    model = torch.nn.Sequential(torch.nn.Linear(200, 100),
                                torch.nn.Linear(100, 3))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(), device_compression="int8")
    x = torch.from_numpy(np.random.default_rng(rank).standard_normal(
        (4, 200)).astype(np.float32))
    # The local gradients come from a pass of their own: after backward()
    # the hooks' in-place allreduces may already be writing into p.grad.
    names, params = zip(*model.named_parameters())
    local = dict(zip(names, torch.autograd.grad(model(x).pow(2).sum(),
                                                params)))
    model(x).pow(2).sum().backward()
    opt.synchronize()
    return {"local": {n: g.numpy() for n, g in local.items()},
            "reduced": {n: p.grad.numpy().copy()
                        for n, p in model.named_parameters()},
            "ef": sorted(model[0].weight is p for p in opt._ef_residuals)}


def _reference_worker(rank, outdir):
    torch.set_num_threads(1)
    _env(rank, _phase_port(outdir, rank, "reference"), JAX_PLATFORMS="cpu")
    import horovod_tpu as hvd
    from horovod_tpu.torch import DistributedOptimizer

    hvd.init(build_mesh=False)
    res = {"host": _eager_cases(hvd, np.asarray, rank, "h")}
    sets = [hvd.add_process_set([0]), hvd.add_process_set([1]),
            hvd.add_process_set([0, 1])]
    res["host"].update(_set_cases(hvd, np.asarray, rank, "h", sets))
    res["mismatch"] = _mismatch(hvd, np.asarray, rank)
    res["opt"] = _gpt_steps(rank, DistributedOptimizer)
    res["host"].update(_join_cases(hvd, np.asarray, rank, "h"))
    hvd.shutdown()
    torch.save(res, os.path.join(outdir, f"reference{rank}.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _phase_port(outdir, rank, phase):
    """The rendezvous port of one ``hvd.init``: rank 0 picks a free port
    just before its init and hands it to rank 1 through a file.  A port
    picked when the module started would wait tens of seconds for its init
    under load, while this process's own gloo connections and other test
    processes take ephemeral ports from the same range."""
    path = os.path.join(outdir, f"{phase}.rendezvous_port")
    if rank == 0:
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            f.write(str(_free_port()))
        os.replace(tmp, path)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not os.path.exists(path):
        assert time.monotonic() < deadline, f"no port for {phase}"
        time.sleep(0.01)
    with open(path) as f:
        return int(f.read())


def _build_cores():
    """Both native cores, built before the workers start, so the workers'
    time limit counts their own work and not a first build (tens of
    seconds, more beside other test processes)."""
    from horovod_tpu_torch.ops import _build

    _build.build_core()
    cpp = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "horovod_tpu", "cpp")
    subprocess.run(["make", "-s"], cwd=cpp, check=True, capture_output=True)


def _codec_reference():
    """The reference device plane's ring on each rank's zero-padded
    bucket, per codec, over two devices of the CPU mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    import horovod_tpu.ops.collectives as jcl
    from horovod_tpu.ops.collectives import shard_map

    padded = np.zeros((WORLD, BUCKET_LEN), np.float32)
    padded[:, :sum(BUCKET)] = np.concatenate(_inputs()["bucket"], axis=1)
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("hvd",))

    def rings(xl):
        return tuple(jcl._quantized_ring_allreduce_sum(
            xl[0], "hvd", None, codec, "ring")[None] for codec in CODECS)

    fn = jax.jit(shard_map(rings, mesh=mesh, in_specs=(P("hvd"),),
                           out_specs=(P("hvd"),) * len(CODECS),
                           check_vma=False))
    x = jnp.asarray(padded)
    outs = fn.lower(x).compile(REFERENCE_COMPILE)(x)
    return {codec: np.asarray(o) for codec, o in zip(CODECS, outs)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor

    outdir = tmp_path_factory.mktemp("spine")
    _build_cores()
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_port_worker, args=(r, str(outdir)))
             for r in range(WORLD)]
    procs += [ctx.Process(target=_reference_worker, args=(r, str(outdir)))
              for r in range(WORLD)]
    with ThreadPoolExecutor(1) as pool:
        codec_ref = pool.submit(_codec_reference)
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
        assert not alive, f"{len(alive)} worker(s) did not finish in " \
                          f"{JOIN_TIMEOUT_S} s"
        assert [p.exitcode for p in procs] == [0] * len(procs)
        return {
            "port": [torch.load(outdir / f"port{r}.pt", weights_only=False)
                     for r in range(WORLD)],
            "reference": [torch.load(outdir / f"reference{r}.pt",
                                     weights_only=False)
                          for r in range(WORLD)],
            "codec": codec_ref.result(),
        }


def _bits(a):
    a = np.asarray(a)
    return a.view(np.dtype(f"u{a.dtype.itemsize}")) \
        if a.dtype.kind == "f" else a


def _assert_same(got, want, what):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (what, got.dtype, want.dtype, got.shape, want.shape)
    assert np.array_equal(_bits(got), _bits(want)), (what, got, want)


CASES = [
    *(f"allreduce/{op}" for op in OPS), "allreduce/sum_scaled",
    "allreduce/avg_scaled", "allreduce/f64", "allreduce/i32", "grouped",
    "grouped_unnamed", "allgather", "grouped_allgather", "broadcast",
    "alltoall", "alltoall_even", "reducescatter/even", "reducescatter/odd",
    "reducescatter/scaled", "dup", "set/own", "set/both", "set/both_ag",
    "join"]


@pytest.mark.parametrize("plane", ["host", "device"])
@pytest.mark.parametrize("case", CASES)
def test_eager_case_matches_reference_bitwise(runs, plane, case):
    for rank in range(WORLD):
        got = runs["port"][rank][plane]
        want = runs["reference"][rank]["host"]
        _assert_same(got[case], want[case], f"{plane} {case} rank {rank}")


def test_join_zero_participation_matches_reference(runs):
    for plane in ("host", "device"):
        _assert_same(runs["port"][0][plane]["joined_sum"],
                     runs["reference"][0]["host"]["joined_sum"], plane)
    # Rank 1 contributed zeros: rank 0's Sum is its own input.
    _assert_same(runs["port"][0]["device"]["joined_sum"], _inputs()["x"][0],
                 "joined sum")
    # Rank 0's device tensor was demoted by negotiation to the host ring.
    assert runs["port"][0]["join_stats"]["host_fallback"] == 1
    assert runs["port"][1]["join_stats"]["host_fallback"] == 0


@pytest.mark.parametrize("dtype", SCALE_DTYPES)
def test_device_plane_rounds_16bit_scale_factors(runs, dtype):
    """The reference's device plane multiplies by ``jnp.asarray(f, dtype)``
    (``horovod_tpu/ops/device_plane.py``: ``_scale``, ``_pack``,
    ``_unpack``, the reducescatter program); the port must give the same
    bits, on the identity path and across the gloo group."""
    import jax.numpy as jnp

    dt = getattr(jnp, dtype)
    inp = _inputs()

    def times(a, f):
        return a * jnp.asarray(f, dt)

    for i, pre in enumerate(SCALE_FACTORS):
        post = SCALE_FACTORS[(i + 1) % len(SCALE_FACTORS)]
        xs = [times(jnp.asarray(inp["x"][r], dt), pre) for r in range(WORLD)]
        ys = [times(jnp.asarray(inp["y"][r], dt), pre) for r in range(WORLD)]
        rs = times(jnp.asarray(inp["rs"][0][:4], dt), pre) + \
            times(jnp.asarray(inp["rs"][1][:4], dt), pre)
        fused = [times(xs[0] + xs[1], post), times(ys[0] + ys[1], post)]
        for rank in range(WORLD):
            got = runs["port"][rank]["scale16"][(dtype, i)]
            want = {"own": times(xs[rank], post),
                    "fused": fused,
                    "rs": times(rs, post)[2 * rank:2 * rank + 2]}
            for key, w in want.items():
                w = ([np.asarray(a, np.float32) for a in w]
                     if isinstance(w, list) else np.asarray(w, np.float32))
                _assert_same(got[key], w, f"{dtype} {pre} {key} rank {rank}")


def test_device_plane_served_the_device_cases(runs):
    for rank in range(WORLD):
        stats = runs["port"][rank]["device_stats"]
        for key in ("allreduce", "broadcast", "allgather", "alltoall",
                    "reducescatter", "identity"):
            assert stats[key] > 0, (rank, key, stats)
        assert stats["host_fallback"] == 0
        assert stats["quantized"] == 0


def test_shape_mismatch_raises_the_reference_error(runs):
    for rank in range(WORLD):
        got = runs["port"][rank]["mismatch"]
        assert got == runs["reference"][rank]["mismatch"]
        assert got.startswith("HorovodInternalError: Mismatched")


@pytest.mark.parametrize("codec", CODECS)
def test_device_codec_bucket_matches_reference_ring(runs, codec):
    want = runs["codec"][codec]
    for rank in range(WORLD):
        r = runs["port"][rank]
        assert r[f"bucket_len/{codec}"] == BUCKET_LEN
        (entry,) = r[f"bucket_log/{codec}"]
        assert entry["numels"] == list(BUCKET) and entry["codec"] == codec
        assert entry["length"] == BUCKET_LEN and entry["k"] == WORLD
        off = 0
        for i, n in enumerate(BUCKET):
            _assert_same(r[f"bucket/{codec}"][i], want[rank][off:off + n],
                         f"{codec} member {i} rank {rank}")
            off += n


def test_host_wire_codec_matches_port_quantize(runs):
    """The C++ ring's int8 codec (wire_codec.h) through the port's core is
    the port's ring over ops/quantize.py, run here as two threads."""
    import threading

    from horovod_tpu_torch.ops import collectives as col

    xs = [torch.from_numpy(a) for a in _inputs()["host_codec"]]
    box = (threading.Condition(), {})
    want = [None] * WORLD

    class ThreadRing:
        def __init__(self, rank):
            self.rank, self.size = rank, WORLD

        def exchange(self, tensors, dst, src):
            cond, mail = box
            with cond:
                mail.setdefault((self.rank, dst), []).append(list(tensors))
                cond.notify_all()
                while not mail.get((src, self.rank)):
                    cond.wait()
                return mail[(src, self.rank)].pop(0)

    def run(r):
        want[r] = col._ring_allreduce_sum(ThreadRing(r), xs[r], "int8")

    threads = [threading.Thread(target=run, args=(r,)) for r in range(WORLD)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    for rank in range(WORLD):
        r = runs["port"][rank]
        _assert_same(r["host_codec"], want[0].numpy(), f"rank {rank}")
        sent = r["host_codec_bytes"]
        assert 0 < sent["data_sent_xhost"] < sent["data_raw_xhost"] / 3


@pytest.mark.parametrize("variant", ["plain", "num_groups", "groups"])
def test_optimizer_matches_reference_torch_binding(runs, variant):
    for rank in range(WORLD):
        got = runs["port"][rank]["opt"][variant]
        want = runs["reference"][rank]["opt"][variant]
        for step, (g, w) in enumerate(zip(got, want)):
            for name in w:
                np.testing.assert_allclose(
                    g[name], w[name], rtol=OPT_TOL, atol=OPT_TOL,
                    err_msg=f"{variant} step {step} {name} rank {rank}")
    for step in range(2):  # the ranks agree to the bit
        for name, p in runs["port"][0]["opt"][variant][step].items():
            _assert_same(p, runs["port"][1]["opt"][variant][step][name], name)


def test_error_feedback_beside_negotiated_leaves(runs):
    mixes = [runs["port"][r]["ef_mix"] for r in range(WORLD)]
    for name, g in mixes[0]["reduced"].items():
        _assert_same(g, mixes[1]["reduced"][name], name)
        if name != "0.weight":  # negotiated: the plain mean
            want = (mixes[0]["local"][name] + mixes[1]["local"][name]) / 2
            _assert_same(g, want.astype(np.float32), name)
    assert mixes[0]["ef"] == [True]
    w = mixes[0]["reduced"]["0.weight"]
    exact = (mixes[0]["local"]["0.weight"] + mixes[1]["local"]["0.weight"]) / 2
    assert not np.array_equal(w, exact)
    np.testing.assert_allclose(w, exact, atol=0.05 * np.abs(exact).max())
