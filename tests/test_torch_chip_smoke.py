"""What ``chip_smoke.py`` computes without a card: the device time of one
call from a profiler trace of many calls, which may have lost events."""

import pytest

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
