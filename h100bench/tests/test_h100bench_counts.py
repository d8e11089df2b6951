"""The benchmark's own operation and byte counts: one convolution counted
by hand, the vgg512 totals, and the stem's bound."""

import h100bench_cases  # noqa: F401  (puts the benchmark on the path)
import pytest

from benchlib import counts, registry

INT8 = registry.config("ssd512-vgg16-int8")
BF16 = registry.config("ssd512-vgg16-bf16")


def test_one_conv_by_hand():
    conv2_1 = next(c for c in counts.conv_shapes(BF16, 64) if c["name"] == "conv2_1")
    # 64 images, 256x256 outputs, 128 filters of 3x3x64, two operations a multiply-add
    ops = 2 * 64 * 256 * 256 * 128 * 3 * 3 * 64
    assert counts.conv_ops(conv2_1) == ops
    nbytes = 64 * 256 * 256 * 64 * 2 + 3 * 3 * 64 * 128 * 2 + 64 * 256 * 256 * 128 * 2
    assert counts.conv_bytes(conv2_1, "bfloat16") == nbytes
    assert counts.conv_bound_s(conv2_1, "bfloat16") == pytest.approx(
        max(ops / 989e12, nbytes / 3.35e12))
    assert counts.conv_bytes(conv2_1, "int8") == nbytes - 3 * 3 * 64 * 128


def test_vgg512_totals():
    assert counts.forward_ops(BF16) == pytest.approx(180.415358976e9)
    conv1_1 = 2 * 512 * 512 * 64 * 27
    assert counts.train_ops(BF16) == pytest.approx(3 * 180.415358976e9 - conv1_1)
    assert len(counts.conv_shapes(INT8, 1)) == 32  # 13 trunk, conv6, conv7, 10 extras, 7 heads
    assert sum(c["ho"] * c["wo"] * c["cout"] // (INT8["model"]["num_classes"] + 5)
               for c in counts.conv_shapes(INT8, 1)
               if c["name"].startswith("classifier")) == INT8["preset"]["num_anchors"]


def test_stem_bound_matches_the_kernel_table():
    # PERF.md's kernel table, row 3: 1.3093 ms at batch 64 (operations)
    assert counts.stem_bound_s(BF16, 64) * 1e3 == pytest.approx(1.3093, abs=1e-4)


def test_peaks_of_the_precisions():
    assert counts.PEAK_OPS[INT8["precision"]] == 1979e12
    assert counts.PEAK_OPS[BF16["precision"]] == 989e12
