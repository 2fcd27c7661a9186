"""What ``chip_smoke.py`` computes without a card: the device time of one
call from a profiler trace of many calls, which may have lost events, the
step breakdown's categories, and the parallel phase's expected launches
and replay loss."""

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
