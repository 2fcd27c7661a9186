"""What ``chip_smoke.py`` computes without a card: the device time of one
call from a profiler trace of many calls, which may have lost events, the
step breakdown's categories, the parallel phase's expected launches and
replay loss, and the elastic and fleet phases' checks of what their
workers, the driver and the cockpit recorded."""

import json

import pytest
import torch

import chip_smoke


@pytest.mark.parametrize("lost", [0, 3])
def test_per_call_ms_counts_each_kernel_by_its_launches_per_call(lost):
    """Two kernels a call, the second launched twice; 20 calls with
    ``lost`` events of the first missing from the trace.  The time of one
    call stays the sum of each kernel's mean times its launches a call,
    where the plain sum over the trace would fall short."""
    per_kernel = {"a": ((20 - lost) * 0.05, 20 - lost), "b": (40 * 0.1, 40)}
    ms, events_lost = chip_smoke.per_call_ms(per_kernel, 20)
    assert ms == pytest.approx(0.05 + 2 * 0.1)
    assert events_lost == lost


class _Span:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


class _Event:
    def __init__(self, name, start, end, annotation=False, cuda=True):
        import torch

        self.name, self.time_range = name, _Span(start, end)
        self.is_user_annotation = annotation
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)


class _Trace:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_categorize_puts_kernels_inside_batch_norm_ranges_in_their_own():
    """The step breakdown of the CNN and BERT phases: kernels inside a
    ``batch_norm.*`` range on the device timeline are BatchNorm's, the rest
    go by name; a range on the host timeline counts for nothing."""
    trace = _Trace([
        _Event("batch_norm.forward", 100, 200, annotation=True),
        _Event("batch_norm.backward", 500, 600, annotation=True, cuda=False),
        _Event("vectorized_elementwise_kernel<mul>", 110, 130),
        _Event("reduce_kernel<sum>", 150, 190),
        _Event("sm90_xmma_fprop_implicit_gemm_bf16", 0, 90),
        _Event("sm90_xmma_wgrad_implicit_gemm_bf16", 300, 400),
        _Event("multi_tensor_apply_kernel<SGD>", 700, 710),
        _Event("nvjet_hsh_128x256", 800, 840),
        _Event("vectorized_elementwise_kernel<relu>", 510, 530),
    ])
    got = chip_smoke.categorize(trace)
    assert got["annotated_ranges"] == 1
    cats = got["by_category_ms"]
    assert cats == pytest.approx({
        "batch_norm": 0.06, "convolution": 0.19, "optimizer": 0.01,
        "gemm": 0.04, "elementwise_and_other": 0.02})


@pytest.mark.parametrize("losses,falling,ok", [
    ([2.0, 1.5], True, True), ([2.0, 2.5], True, False),
    ([2.0, 2.5], False, True), ([2.0, float("nan")], False, False)])
def test_check_losses(losses, falling, ok):
    if ok:
        chip_smoke.check_losses("m", losses, falling)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_losses("m", losses, falling)


def test_trainer_report_sets_busy_time_against_the_median_step():
    res = {"losses": [3.0, 2.0], "step_ms": [12.0, 10.0],
           "step_ms_median": 10.0}
    rep = chip_smoke.trainer_report(res, 64, {"device_ms": 8.0})
    assert rep["breakdown"]["idle_share"] == pytest.approx(0.2)
    assert rep["median_step_ms"] == 10.0 and rep["batch"] == 64


_DUMP = {"rank": 0, "counters": {"responses_total": 3},
         "gauges": {"elastic_generation": 1},
         "histograms": {"negotiation_wait_us": {"buckets": [1, 2],
                                                "sum_us": 5, "count": 3}}}


def test_prometheus_families_counts_help_and_type_per_family():
    from horovod_tpu_torch.utils.metrics import render_prometheus

    fams = chip_smoke.prometheus_families(render_prometheus(_DUMP))
    assert fams == {"hvd_responses_total": [1, 1],
                    "hvd_elastic_generation": [1, 1],
                    "hvd_negotiation_wait_us": [1, 1]}


@pytest.mark.parametrize("text", [
    'hvd_x_total{rank="0"} 1\n',                          # no metadata
    "# HELP hvd_x x\n# TYPE hvd_x gauge\n# TYPE hvd_x gauge\nhvd_x 1\n",
    "# HELP hvd_x x\n# TYPE hvd_x gauge\nhvd_x{rank=0} 1\n",  # bad label
])
def test_prometheus_families_refuses_malformed_text(text):
    with pytest.raises(AssertionError):
        chip_smoke.prometheus_families(text)


def test_step_trace_phase_sums_takes_the_rows_of_the_window():
    trace = {"phases": chip_smoke.STEP_PHASES, "steps": [
        [0, 90, 99, 1, 1, 1, 1, 1, 0],
        [1, 100, 110, 2, 0, 3, 0, 5, 0],
        [2, 110, 130, 4, 1, 0, 0, 6, 0],
        [3, 131, 140, 9, 9, 9, 9, 9, 0]]}
    got = chip_smoke.step_trace_phase_sums(trace, 100, 130)
    assert got == {"rows": 2, "phase_us": {
        "negotiation_wait": 6, "fusion": 1, "ring": 3, "fence": 0,
        "idle": 11}}


@pytest.mark.parametrize("kind,codec,want", [
    ("alltoall", "int8", {"quant_int8": 2, "quant_int4": 0, "dequant": 2}),
    ("alltoall", "int4", {"quant_int8": 0, "quant_int4": 2, "dequant": 2}),
    ("reducescatter", "int8g",
     {"quant_int8": 1, "quant_int4": 0, "dequant": 1}),
])
def test_extras_launches_follow_the_schedule(kind, codec, want):
    assert chip_smoke.extras_launches(kind, codec) == want


def test_extras_bytes_count_one_chunk_a_peer():
    from horovod_tpu_torch.ops import quantize as qz

    c = chip_smoke.A2A_ROWS * chip_smoke.A2A_COLS // 2
    assert chip_smoke.extras_bytes("int4") == (c * 4,
                                               qz.encoded_nbytes(c, "int4"))
    # 25.2 MB a rank: the MoE dispatch of one 8 x 1024 batch at width 768.
    assert 2 * c * 4 == 25_165_824


class _LoopbackRing:
    """A ring exchange that hands each rank its own tensors back: the hop
    pattern of one rank of a ring, without peers."""

    wire = torch.device("cpu")

    def exchange(self, tensors, dst, src):
        return [t.clone() for t in tensors]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_launches_counts_the_hops_a_rank_computes(monkeypatch, world,
                                                       causal):
    """``ring_launches`` (one layer) is the number of flash chunks
    ``ring_attention`` computes on each rank: the diagonal and the past
    chunks when causal, every chunk otherwise; each chunk's backward runs
    K5 and K6 once."""
    import importlib

    from horovod_tpu_torch.parallel import mesh

    # The package exports the function under the module's name.
    ra = importlib.import_module("horovod_tpu_torch.parallel.ring_attention")

    for rank in range(world):
        chunks = []

        def counting(*args, **kwargs):
            chunks.append(kwargs["causal"])
            return real(*args, **kwargs)

        real = ra.flash_attention_with_lse
        monkeypatch.setattr(ra, "flash_attention_with_lse", counting)
        axis = mesh.Axis.__new__(mesh.Axis)
        axis.name, axis.ranks, axis.size, axis.index = \
            "sp", list(range(world)), world, rank
        axis.ring = _LoopbackRing()
        q, k, v = (torch.randn(1, 4, 2, 8, requires_grad=True)
                   for _ in range(3))
        ra.ring_attention(q, k, v, axis, causal=causal, use_flash=True,
                          block_size=2).sum().backward()
        monkeypatch.undo()
        assert len(chunks) == chip_smoke.ring_launches(rank, world, 1,
                                                       causal)
        assert chunks.count(True) == (1 if causal else 0)  # the diagonal


def test_split_loss_skips_each_shard_boundary_token():
    """The replay's loss: each shard's own next-token loss, averaged over
    the shards, which leaves out the token at every shard boundary."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import lm_loss

    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(2, 8, 11, generator=gen)
    ids = torch.randint(0, 11, (2, 8), generator=gen)
    per_shard = [F.cross_entropy(logits[:, i:i + 3].reshape(-1, 11),
                                 ids[:, i + 1:i + 4].reshape(-1))
                 for i in (0, 4)]
    got = chip_smoke.split_loss(lm_loss, logits, ids, 2)
    torch.testing.assert_close(got, (per_shard[0] + per_shard[1]) / 2)
    assert not torch.isclose(got, lm_loss(logits, ids))
    torch.testing.assert_close(chip_smoke.split_loss(lm_loss, logits, ids, 1),
                               lm_loss(logits, ids))


def test_watch_times_each_staging_and_restores_the_functions():
    """The parallel phase's ``_Watch`` adds each wrapped call's seconds to
    its own total, records K5's lse cotangents, and puts the wrapped
    functions back on exit."""
    import types

    def dq(q, k, v, dout, out, lse, dlse, *rest):
        return "dq"

    fa = types.SimpleNamespace(flash_bwd_dq_cuda=dq)
    pcol = types.SimpleNamespace(_send_recv=lambda *a: "sent")
    dp = types.SimpleNamespace(plain_allreduce=lambda *a: "reduced")
    originals = (fa.flash_bwd_dq_cuda, pcol._send_recv, dp.plain_allreduce)
    with chip_smoke._Watch(fa, pcol, dp) as watch:
        assert pcol._send_recv(1, 2) == "sent"
        assert dp.plain_allreduce(1) == "reduced"
        assert fa.flash_bwd_dq_cuda(*[None] * 6, torch.tensor([-2.0, 1.0]),
                                    None) == "dq"
        sync = watch.timed(lambda: "synced", "sync_wait_s")
        assert sync() == "synced"
        assert watch.dlse == [2.0]
        assert min(watch.exchange_s, watch.allreduce_s,
                   watch.sync_wait_s) > 0
        watch.reset()
        assert (watch.dlse, watch.exchange_s, watch.allreduce_s,
                watch.sync_wait_s) == ([], 0.0, 0.0, 0.0)
    assert (fa.flash_bwd_dq_cuda, pcol._send_recv,
            dp.plain_allreduce) == originals


def test_driver_generations_reads_the_verbose_log():
    log = ("elastic driver: generation 0 formed with 2 worker(s)\n"
           "elastic driver: worker localhost:1:ab exited rc=-9\n"
           "elastic driver: could not reach min_np=2 within 60s\n"
           "elastic driver: generation 1 formed with 2 worker(s)\n")
    assert chip_smoke.driver_generations(log) == [(0, 2), (1, 2)]
    assert chip_smoke.driver_generations("") == []


@pytest.mark.parametrize("layers,steps,world,per", [
    (12, 4, 2, 96), (3, 4, 2, 24), (12, 1, 1, 12)])
def test_elastic_expected_launches(layers, steps, world, per):
    """Each rank launches K4-K6 once a layer a completed step, in either
    generation; no codec kernel runs on the elastic path."""
    want = chip_smoke.elastic_expected_launches(layers, steps, world)
    assert want == {"flash_fwd": per, "flash_bwd_dq": per,
                    "flash_bwd_dkv": per, "quant_int8": 0, "quant_int4": 0,
                    "dequant": 0}


def _elastic_events(layers=12, resume_mode="replica", respawn_digest="d1",
                    bad_launch=None):
    """The events of a killed elastic run of 4 steps as the workers write
    them: pids 10 (survivor), 11 (killed in step ``ELASTIC_KILL_STEP``)
    and 12 (respawned)."""
    kill = chip_smoke.ELASTIC_KILL_STEP
    t = [0.0]

    def ev(event, pid, gen, rank, **kw):
        t[0] += 1.0
        return {"event": event, "pid": pid, "time": t[0], "generation": gen,
                "rank": rank, "size": 2, **kw}

    launches = chip_smoke.elastic_expected_launches(layers, 1, 1)
    out = []
    for pid, rank in ((10, 0), (11, 1)):
        out.append(ev("resume", pid, 0, rank, mode="cold", cut=None,
                      commits=0, step=0, own_digest=None, params="p0"))
    for step in range(kill):
        for pid, rank in ((10, 0), (11, 1)):
            out.append(ev("step", pid, 0, rank, step=step, loss=10.0 - step,
                          launches=dict(launches), step_s=1.0, commit_s=2.0,
                          commits=step + 1, replication={
                              "commits": step + 1, "bytes": 5,
                              "seconds": 0.5},
                          own_digest=(f"d{rank}" if step == kill - 1
                                      else "old"),
                          params=f"p{step + 1}"))
    out.append(ev("resume", 10, 1, 0, mode=resume_mode, cut=kill,
                  commits=kill, step=kill, own_digest="d0",
                  params=f"p{kill}"))
    out.append(ev("resume", 12, 1, 1, mode=resume_mode, cut=kill,
                  commits=kill, step=kill,
                  own_digest=respawn_digest, params=f"p{kill}"))
    for step in range(kill, 4):
        for pid, rank in ((10, 0), (12, 1)):
            got = dict(launches)
            if bad_launch and step == 3 and rank == 1:
                got[bad_launch] += 1
            out.append(ev("step", pid, 1, rank, step=step, loss=8.0,
                          launches=got, step_s=1.0, commit_s=2.0,
                          commits=step + 1, replication=None,
                          own_digest=f"e{rank}", params=f"p{step + 1}"))
    for pid, rank in ((10, 0), (12, 1)):
        out.append(ev("final", pid, 1, rank, params="p4",
                      launches=dict(launches), peak_mem_gb=20.0))
    return out


def test_check_elastic_accepts_a_faithful_recovery():
    rep = chip_smoke.check_elastic(_elastic_events(), [(0, 2), (1, 2)], 12,
                                   killed=True)
    assert rep["launches"] == {"flash_fwd": 96, "flash_bwd_dq": 96,
                               "flash_bwd_dkv": 96, "quant_int8": 0,
                               "quant_int4": 0, "dequant": 0}
    assert rep["resume"][0] == {"mode": "replica",
                                "cut": chip_smoke.ELASTIC_KILL_STEP,
                                "survivor": True, "digest": "d0"}
    assert rep["resume"][1]["survivor"] is False
    assert len(rep["replications"]) == 8
    assert rep["peak_mem_gb"] == {0: 20.0, 1: 20.0}


@pytest.mark.parametrize("change,match", [
    ({"resume_mode": "cold"}, "resumed by modes"),
    ({"resume_mode": "fallback"}, "resumed by modes"),
    ({"respawn_digest": "other"}, "another digest"),
    ({"bad_launch": "flash_bwd_dq"}, "launches"),
    ({"bad_launch": "quant_int8"}, "launches"),
    ({"gens": [(0, 2), (1, 1)]}, "generations"),
    ({"gens": [(0, 2), (1, 2), (2, 2)]}, "generations")])
def test_check_elastic_refuses_a_wrong_recovery(change, match):
    gens = change.pop("gens", [(0, 2), (1, 2)])
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_elastic(_elastic_events(**change), gens, 12,
                                 killed=True)


def test_same_tree_is_bitwise():
    a = {"model": {"w": torch.tensor([0.0, 1.0])}, "step": torch.tensor(3.0),
         "groups": [{"lr": 0.1}]}
    b = {"model": {"w": torch.tensor([-0.0, 1.0])}, "step": torch.tensor(3.0),
         "groups": [{"lr": 0.1}]}
    assert chip_smoke.same_tree(a, a)
    assert not chip_smoke.same_tree(a, b)  # -0.0 == 0.0, but not its bits
    assert not chip_smoke.same_tree(a, {**a, "step": 3.0})


def test_checkpoint_roundtrip_restores_only_after_every_shard_exists(
        tmp_path, monkeypatch):
    """Rank 0 of two: its own shard is written when its save returns, the
    peer's only once the peer has passed the barrier.  Restoring before
    that finds the step incomplete and returns nothing."""
    import types

    from horovod_tpu_torch import checkpoint

    monkeypatch.setattr(checkpoint.ShardedCheckpointer, "_world",
                        lambda self: (0, 2))
    ckpt_dir = str(tmp_path / "ckpt")

    def barrier():
        peer = checkpoint.ShardedCheckpointer(ckpt_dir, async_write=False)
        path = peer._shard_path(3, 1)
        with open(path, "wb") as f:
            f.write(open(peer._shard_path(3, 0), "rb").read())

    hvd = types.SimpleNamespace(checkpoint=checkpoint, rank=lambda: 0,
                                barrier=barrier)
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    model(torch.randn(2, 4)).sum().backward()
    opt.step()
    got = chip_smoke.checkpoint_roundtrip(hvd, model, opt, 3, str(tmp_path))
    assert got["bitwise"] and got["bytes"] > 0


@pytest.mark.parametrize("size", [1, 2, 3])
def test_fleet_lr_is_the_ports_warmup_schedule(monkeypatch, size):
    """The phase's written-out rate equals ``hvd.callbacks``' schedule at
    every step and world size the fleet job visits."""
    from horovod_tpu_torch import basics, callbacks

    monkeypatch.setattr(basics, "is_initialized", lambda: True)
    monkeypatch.setattr(basics, "size", lambda: size)
    sched = callbacks.warmup_schedule(chip_smoke.FLEET_LR,
                                      chip_smoke.FLEET_WARMUP)
    for step in range(3 * chip_smoke.FLEET_WARMUP):
        assert chip_smoke.fleet_lr(step, size) == sched(step)


class _Watch:
    def __init__(self):
        self.ports = {4242}
        self.snapshots = {g: {
            "port": 4242, "hvd_top_rc": 0, "hvd_top_lines": 9,
            "state": {"schema": "cockpit-state-v1", "elastic_generation": g},
            "metrics": "# HELP hvd_cycles_total c\n# TYPE hvd_cycles_total "
                       "counter\nhvd_cycles_total{rank=\"0\"} 3\n",
            "history": {}} for g in range(3)}
        self.flagged_at = {0: (3.0, "straggler report: rank 2 (host "
                                    "localhost): negotiation lag")}
        self.steps_tagged = {0: {"eager"}, 1: {"eager"}, 2: {"eager"}}
        self.sse = [(4.0, {"type": "step", "step": 0}),
                    (5.0, {"type": "autopilot", "action": "evict",
                           "rank": 2})]
        self.sse_connects = 3
        self.errors = []


_FLEET_ERR = ("elastic driver: generation 0 formed with 3 worker(s)\n"
              "elastic driver: autopilot evicted host localhost (straggler "
              "for 2 consecutive report windows; re-admitted in 40s)\n"
              "elastic driver: generation 1 formed with 2 worker(s)\n"
              "elastic driver: generation 2 formed with 3 worker(s)\n")
_FLEET_JOURNAL = [{"ts": 5.0, "action": "evict", "rank": 2,
                   "detail": "host localhost: straggler"},
                  {"ts": 45.0, "action": "readmit", "rank": -1,
                   "detail": "blacklist expired for host localhost"}]


def _fleet_events(layers=2):
    """A faithful fleet run as the workers write it: one step at world 3,
    an epoch of 3 batches at world 2, an epoch of 2 at world 3."""
    launches = chip_smoke.elastic_expected_launches(layers, 1, 1)
    out, t = [], [0.0]

    def ev(event, gen, rank, size, **kw):
        t[0] += 1.0
        out.append({"event": event, "pid": 10 + rank + 5 * (gen == 2),
                    "time": t[0], "generation": gen, "rank": rank,
                    "size": size, **kw})

    plan = [(0, 3, [0]), (1, 2, [1, 2, 3]), (2, 3, [4, 5])]
    for gen, size, steps in plan:
        for r in range(size):
            ev("resume", gen, r, size, prefetch_threads=0,
               cockpit_port="4242" if r == 0 else None)
        for i, step in enumerate(steps):
            for r in range(size):
                ev("step", gen, r, size, step=step, epoch=gen, batch=i,
                   lr=chip_smoke.fleet_lr(step, size), local_loss=10.0,
                   on_card=True, launches=dict(launches), step_s=2.0)
                ev("commit", gen, r, size, step=step, commit_s=0.5,
                   loss=10.0)
        if gen:
            for r in range(size):
                ev("epoch", gen, r, size, epoch=gen, batches=len(steps),
                   length=chip_smoke.FLEET_SEQS // size //
                   chip_smoke.FLEET_BATCH)
    for r in range(3):
        ev("final", 2, r, 3, params="p", step=6, launches={},
           peak_mem_gb=5.7)
    return out


def test_check_fleet_accepts_a_faithful_run():
    rep = chip_smoke.check_fleet(_fleet_events(), _FLEET_ERR, _FLEET_JOURNAL,
                                 [(1, 2), (3, -1)], _Watch(), 2)
    assert rep["generations"] == [(0, 3), (1, 2), (2, 3)]
    assert rep["launches"]["flash_fwd"] == 2 * (3 + 2 * 3 + 2 * 3)
    assert rep["launches"]["quant_int8"] == 0
    assert rep["flagged_to_evict_s"] == 2.0
    assert rep["epochs"] == [(1, 2, 3), (1, 2, 3), (2, 3, 2), (2, 3, 2),
                             (2, 3, 2)]


def _spoil(what, events, journal, flights, watch):
    steps = [e for e in events if e["event"] == "step"]
    if what == "lr":
        steps[-1]["lr"] *= 1.0 + 1e-9
    elif what == "host_batch":
        steps[3]["on_card"] = False
    elif what == "launch":
        steps[0]["launches"]["dequant"] = 1
    elif what == "epoch":
        next(e for e in events if e["event"] == "epoch")["batches"] = 2
    elif what == "prefetch":
        next(e for e in events if e["event"] == "resume")[
            "prefetch_threads"] = 1
    elif what == "params":
        [e for e in events if e["event"] == "final"][1]["params"] = "q"
    elif what == "journal":
        journal[0]["rank"] = 1
    elif what == "flight":
        flights.clear()
    elif what == "ports":
        watch.ports.add(4343)
    elif what == "sse":
        watch.sse.pop()
    elif what == "straggler":
        watch.flagged_at.clear()


@pytest.mark.parametrize("what,match", [
    ("lr", "lr"), ("host_batch", "not on the card"), ("launch", "launches"),
    ("epoch", "batches vs length"), ("prefetch", "prefetch thread"),
    ("params", "final parameters"), ("journal", "journal"),
    ("flight", "flight dumps"), ("ports", "ports"), ("sse", "SSE"),
    ("straggler", "named rank 2")])
def test_check_fleet_refuses_a_wrong_run(what, match):
    events, journal = _fleet_events(), [dict(r) for r in _FLEET_JOURNAL]
    flights, watch = [(1, 2)], _Watch()
    _spoil(what, events, journal, flights, watch)
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_fleet(events, _FLEET_ERR, journal, flights, watch,
                               2)


def test_read_flight_autopilot(tmp_path):
    for rank, rows in ((0, [[1, 0, 13, 0, 1, 2], [2, 1, 7, 0, 5, 5]]),
                       (1, [[3, 0, 13, 0, 3, -1]])):
        (tmp_path / f"flight.{rank}.json").write_text(json.dumps(
            {"types": {"7": "tensor", "13": "autopilot"}, "events": rows}))
    (tmp_path / "postmortem.json").write_text("{}")
    assert chip_smoke.read_flight_autopilot(str(tmp_path)) == \
        [(1, 2), (3, -1)]


def test_ef_leaves_at_gpt_small_width():
    """The error-feedback leaves (fp32 weights of at least 64 KiB) of GPT
    at GPT_SMALL's width, counted on a model built on the meta device: 51
    at 12 blocks, 11 at the integrations' 2."""
    import dataclasses

    from horovod_tpu_torch.models import GPT, GPT_SMALL

    for layers in (12, chip_smoke.RAY_LAYERS):
        with torch.device("meta"):
            model = GPT(dataclasses.replace(GPT_SMALL, num_layers=layers))
        eligible = [n for n, p in model.named_parameters()
                    if p.dtype == torch.float32 and p.numel() * 4 >= 1 << 16]
        assert len(eligible) == chip_smoke.ef_leaves(layers)
    assert chip_smoke.ef_leaves(12) == chip_smoke.EF_LEAVES == 51
    assert chip_smoke.ef_launches_per_step(2) == {
        "quant_int8": 33, "quant_int4": 0, "dequant": 44, "flash_fwd": 2,
        "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    ring = chip_smoke.expected_launches("allreduce", "int8", "ring", 0)
    per_leaf = chip_smoke.ef_launches_per_step(0)
    assert per_leaf["quant_int8"] == 3 * (ring["quant_int8"] + 1)
    assert per_leaf["dequant"] == 3 * (ring["dequant"] + 1)


def _loss_log(steps, layers):
    """What ``CountedLoss`` notes over ``steps`` steps whose launches are
    exact: each call after the step's forward."""
    counts = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                            "quant_int8", "quant_int4", "dequant"), 0)
    log = []
    for step in range(steps):
        counts["flash_fwd"] += layers
        log.append((float(step), dict(counts)))
        counts["flash_bwd_dq"] += layers
        counts["flash_bwd_dkv"] += layers
    return log, counts


@pytest.mark.parametrize("layers", [12, 2])
def test_estimator_launches_per_interval(layers):
    log, final = _loss_log(chip_smoke.INT_STEPS, layers)
    per = chip_smoke.estimator_launches(log, final)
    chip_smoke.check_estimator_launches(per, layers, chip_smoke.INT_STEPS)
    assert [p["flash_fwd"] for p in per] == [layers, layers, 0]
    assert [p["flash_bwd_dkv"] for p in per] == [0, layers, layers]
    assert final["flash_fwd"] == chip_smoke.INT_STEPS * layers


@pytest.mark.parametrize("change,match", [
    ("extra_forward", "interval 1"), ("codec", "interval 0"),
    ("missing_step", "loss calls")])
def test_estimator_launches_refuse_a_wrong_run(change, match):
    log, final = _loss_log(chip_smoke.INT_STEPS, 12)
    if change == "extra_forward":
        for _, counts in log[1:]:
            counts["flash_fwd"] += 1
        final["flash_fwd"] += 1
    elif change == "codec":
        for _, counts in log:
            counts["quant_int8"] += 3
        final["quant_int8"] += 3
    else:
        log = log[:-1]
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_estimator_launches(
            chip_smoke.estimator_launches(log, final), 12,
            chip_smoke.INT_STEPS)


def test_integration_launches_reads_every_part():
    res = {"estimator_world1": {"launches": {"flash_fwd": 24}},
           "estimator_spark": {"ranks": [{"launches": {"flash_fwd": 24}},
                                         {"launches": {"flash_fwd": 24}}]},
           "ray_executor": [{"launches": {"flash_fwd": 4}},
                            {"launches": {"flash_fwd": 4}}],
           "elastic_ray": [{"launches": {"flash_fwd": 4}},
                           {"launches": {"flash_fwd": 4}}]}
    assert chip_smoke.integration_launches(res, "flash_fwd") == {
        "estimator_world1": 24, "estimator_spark": [24, 24],
        "ray_executor": [4, 4], "elastic_ray": [4, 4]}


def test_wire_digest_is_the_state_digest(tmp_path):
    """The spark part compares the ranks' wire-valued states by digest; a
    bf16 entry rides as tagged bits and digests as its tensor."""
    model = torch.nn.Linear(3, 2).to(torch.bfloat16)
    from horovod_tpu_torch.spark.estimator import _state_to_wire

    wire = _state_to_wire(model.state_dict())
    assert chip_smoke.wire_digest(wire) == chip_smoke.state_digest(model)
    with torch.no_grad():
        model.bias[0] += 1
    assert chip_smoke.wire_digest(wire) != chip_smoke.state_digest(model)


# ---------------------------------------------------------------------------
# The compiled-plane phase's checks, rehearsed at GPT_TINY
# ---------------------------------------------------------------------------

def _plane_report():
    """One rank's faithful report of the ``compiled_plane`` phase at
    GPT_TINY: a pin a parameter, each an all-reduce of its fp32 bytes."""
    from horovod_tpu_torch.models import GPT, GPT_TINY
    from horovod_tpu_torch.ops import hlo_inspect as hi

    sizes = [p.numel() * 4 for p in GPT(GPT_TINY).parameters()]
    raw = sum(sizes)
    wire = sum(hi.ring_wire_bytes("all-reduce", n, 2) for n in sizes)
    per_step = {"flash_fwd": GPT_TINY.num_layers,
                "flash_bwd_dq": GPT_TINY.num_layers,
                "flash_bwd_dkv": GPT_TINY.num_layers,
                "quant_int8": 0, "quant_int4": 0, "dequant": 0}
    compiled = {
        "launches": [dict(per_step) for _ in range(chip_smoke.PLANE_STEPS)],
        "inventories": [{"label": "step", "world": 2,
                         "collectives": len(sizes),
                         "kinds": {"all-reduce": len(sizes)},
                         "raw_bytes": raw, "wire_bytes": wire, "cost": {}}],
        "param_bytes": raw, "ring_wire_bytes": wire,
        "gspmd_raw": raw, "gspmd_wire": wire,
        "plane_counters": {"gspmd": 1}, "plane_tags": [1, 1, 1],
        "losses": [6.3, 6.1, 5.9]}
    return {"rank": 0, "compiled": compiled,
            "eager": {"losses": [6.3001, 6.1, 5.9]},
            "vs_eager": {"max_abs": 1e-3, "update_rel": 0.05}}


def test_check_plane_accepts_a_faithful_run():
    from horovod_tpu_torch.models import GPT_TINY

    chip_smoke.check_plane(_plane_report(), GPT_TINY.num_layers)


def _set(rep, path, value):
    *keys, last = path
    for k in keys:
        rep = rep[k]
    rep[last] = value


@pytest.mark.parametrize("path,value,match", [
    (("compiled", "launches", 1, "flash_bwd_dq"), 1, "launches"),
    (("compiled", "launches", 0, "quant_int8"), 1, "launches"),
    (("compiled", "inventories", 1), {}, "inventories"),
    (("compiled", "inventories", 0, "kinds"), {"all-reduce": 30,
                                               "all-gather": 1}, "kinds"),
    (("compiled", "inventories", 0, "raw_bytes"), None, "inventory bytes"),
    (("compiled", "gspmd_wire"), 0, "data_plane_stats"),
    (("compiled", "plane_counters"), {"gspmd": 1, "demote_dtype": 1},
     "plane counters"),
    (("compiled", "plane_tags"), [1, 0], "plane tags"),
    (("compiled", "plane_tags"), [], "plane tags"),
    (("eager", "losses", 0), 6.5, "first losses"),
    (("vs_eager", "update_rel"), 0.3, "eager replay"),
    (("vs_eager", "update_rel"), 0.13, "eager replay")])
def test_check_plane_refuses_a_wrong_run(path, value, match):
    from horovod_tpu_torch.models import GPT_TINY

    rep = _plane_report()
    if path == ("compiled", "inventories", 1):
        rep["compiled"]["inventories"].append(value)
    elif value is None:  # the loss's token count reduced beside the grads
        rep["compiled"]["inventories"][0]["raw_bytes"] += 4
    else:
        _set(rep, path, value)
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_plane(rep, GPT_TINY.num_layers)


def test_plane_compare_measures_the_update_difference():
    init = {"a": torch.zeros(4), "b": torch.ones(2)}
    eager = {"a": torch.tensor([1.0, -1.0, 1.0, -1.0]),
             "b": torch.tensor([2.0, 2.0])}
    got = chip_smoke.plane_compare(eager, eager, init)
    assert got == {"max_abs": 0.0, "update_rel": 0.0}
    compiled = {"a": eager["a"].clone(), "b": eager["b"].clone()}
    compiled["a"][0] = 0.0  # one sign-like update lost
    got = chip_smoke.plane_compare(compiled, eager, init)
    assert got["max_abs"] == 1.0
    assert got["update_rel"] == pytest.approx((1.0 / 6.0) ** 0.5)


def test_plane_update_rtol_lies_between_the_sound_and_faulted_readings():
    """``PLANE_UPDATE_RTOL`` passes the sound run's reading on the card and
    refuses each planted fault's with room on both sides; the largest
    element difference, under Adam's bound either way, limits nothing."""
    readings = chip_smoke.PLANE_UPDATE_READINGS
    faults = [v for k, v in readings.items() if k != "sound"]
    assert set(readings) == {"sound", "dup_shard", "unreduced_embeddings"}
    assert 2 * readings["sound"] < chip_smoke.PLANE_UPDATE_RTOL
    assert chip_smoke.PLANE_UPDATE_RTOL < min(faults) / 2
    from horovod_tpu_torch.models import GPT_TINY

    rep = _plane_report()
    rep["vs_eager"]["max_abs"] = 1.0
    chip_smoke.check_plane(rep, GPT_TINY.num_layers)


def test_planted_duplicate_shard_gives_rank1_rank0s_sequences(monkeypatch):
    """``chip_plane_faults.py``'s ``dup_shard``: the compiled run of every
    rank sees rank 1's half of each batch replaced by rank 0's, and the
    other arguments pass through."""
    import chip_plane_faults

    seen = []
    monkeypatch.setattr(chip_smoke, "plane_compiled",
                        lambda *args: seen.append(args) or "report")
    chip_plane_faults.plant("dup_shard")
    tokens = chip_smoke.plane_tokens(0)
    assert chip_smoke.plane_compiled("hvd", "fa", "qz", 0, 1,
                                     tokens) == "report"
    (args,) = seen
    per = chip_smoke.PLANE_BATCH // 2
    assert args[:5] == ("hvd", "fa", "qz", 0, 1)
    assert torch.equal(args[5][:, per:], tokens[:, :per])
    assert torch.equal(args[5][:, :per], tokens[:, :per])
    with pytest.raises(ValueError, match="unknown fault"):
        chip_plane_faults.plant("no_such_fault")


# ---------------------------------------------------------------------------
# The bench_tools phase
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule,quant,deq", [("bidi", 8, 14),
                                                ("ring", 4, 7)])
@pytest.mark.parametrize("codec", ["int8", "int4", "int8g"])
def test_bench_launches_at_world_4(schedule, quant, deq, codec):
    """One quantized allreduce at world 4: world encodes and 2*world-1
    decodes a ring, bidi two rings, on every rank."""
    key = "quant_int4" if codec == "int4" else "quant_int8"
    for rank in range(chip_smoke.BENCH_NP):
        got = chip_smoke.expected_launches("allreduce", codec, schedule,
                                           rank, world=chip_smoke.BENCH_NP)
        assert got[key] == quant and got["dequant"] == deq
        assert sum(got.values()) == quant + deq


@pytest.mark.parametrize("schedule", ["ring", "bidi", "torus"])
@pytest.mark.parametrize("codec", ["int8", "int4", "int8g"])
def test_bench_codec_ratio_is_the_references(schedule, codec):
    """The phase's encoded-to-raw ratio at 4 MiB over 4 ranks: the
    reference's recorded ratio on every schedule (torus at 4 is 2 x 2)."""
    assert chip_smoke.bench_codec_ratio(codec, schedule) == \
        chip_smoke.CODEC_RATIOS[codec]


def test_micro_lines_reads_the_launchers_rank_prefix():
    text = ("[0]<stdout>: allreduce           123.4 MiB/s (jit plane, "
            "size=2)\n[0]<stderr>: warning\n"
            "broadcast             7.0 MiB/s (eager plane, size=1)\n"
            "[1]<stdout>: other line\n")
    assert chip_smoke.micro_lines(text) == {
        "allreduce": (123.4, "jit", 2), "broadcast": (7.0, "eager", 1)}


def _bench_lines():
    idle = {"quant_int8": 0, "quant_int4": 0, "dequant": 0}
    want = [chip_smoke.expected_launches("allreduce", "int8", "bidi", r,
                                         world=4) for r in range(4)]
    return [
        {"config": "cache_on", "shared_card": True},
        {"config": "cache_off", "shared_card": True},
        {"config": "fusion_off", "shared_card": True},
        {"metric": "negotiation_cache_speedup",
         "announce_bytes_ratio_on_vs_off": 0.27, "shared_card": True},
        {"config": "device_none", "device_raw_bytes_per_step": 0,
         "launches": [idle] * 4, "shared_card": True},
        {"config": "device_int8_bidi", "launches": want,
         "shared_card": True},
        {"metric": "device_codec", "device_encoded_vs_raw_ratio": 0.254,
         "max_abs_err": 0.01, "max_abs_err_bound": 0.02,
         "shared_card": True}]


def test_check_bench_negotiation_accepts_a_faithful_run():
    out = chip_smoke.check_bench_negotiation(_bench_lines())
    assert out["launches"][0] == {"quant_int8": 8, "quant_int4": 0,
                                  "dequant": 14}


@pytest.mark.parametrize("index,key,value,match", [
    (3, "announce_bytes_ratio_on_vs_off", 0.6, "announce ratio"),
    (4, "device_raw_bytes_per_step", 96, "baseline"),
    (5, "launches", [{"quant_int8": 8, "quant_int4": 0, "dequant": 13}] * 4,
     "K1-K3 launches"),
    (6, "device_encoded_vs_raw_ratio", 0.129, "ratio"),
    (6, "max_abs_err", 0.03, "error"),
    (0, "shared_card", False, "does not say so"),
])
def test_check_bench_negotiation_refuses_a_wrong_run(index, key, value,
                                                     match):
    lines = _bench_lines()
    lines[index][key] = value
    with pytest.raises(AssertionError, match=match):
        chip_smoke.check_bench_negotiation(lines)
