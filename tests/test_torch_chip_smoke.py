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
