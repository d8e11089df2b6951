"""The measurement helpers of the PyTorch port that need no card."""

import pytest

from ssd_tensorflow_tpu_torch.timing import per_call_ms


@pytest.mark.parametrize("kernels,want", [
    ([("k", 3.5, 1.0)], 3.5),                          # one launch per call, all recorded
    ([("k", 3.5 * 4 / 5, 4 / 5)], 3.5),                # one of five records dropped
    ([("a", 6.0, 3.0), ("b", 0.5, 1.0)], 6.5),         # three launches per call, and another kernel
    ([("a", 2.0 * 29 / 10, 29 / 10)], 6.0),            # one of thirty records dropped
])
def test_per_call_ms_counts_mean_launch_times_launches_per_call(kernels, want):
    assert per_call_ms(kernels) == pytest.approx(want)
