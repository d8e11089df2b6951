"""The benchmark's own operation and byte counts: one convolution counted
by hand, grouped convolutions, the vgg512 and resnet320 totals, and the
stem's bound."""

import h100bench_cases  # noqa: F401  (puts the benchmark on the path)
import pytest

from benchlib import counts, registry

INT8 = registry.config("ssd512-vgg16-int8")
BF16 = registry.config("ssd512-vgg16-bf16")
RESNET = registry.config("ssd320-resnet34gn-int8")


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


def _conv(groups, cin=64, cout=64):
    return dict(name="g", b=2, hin=10, win=10, cin=cin, ho=5, wo=5, cout=cout, k=3,
                groups=groups, reads_image=False)


@pytest.mark.parametrize("groups", [1, 32, 64])
def test_grouped_convolutions(groups):
    """``2 * B * Ho * Wo * cout * k * k * cin / groups`` operations and a
    ``k * k * cin / groups * cout`` filter: groups 1 is a full conv, 32 a
    ResNeXt-style grouped one, 64 (= cin) depthwise."""
    c = _conv(groups)
    per_group = 64 // groups
    assert counts.conv_ops(c) == 2 * 2 * 5 * 5 * 64 * 3 * 3 * per_group
    assert counts.conv_bytes(c, "int8") == (2 * 10 * 10 * 64 * 2 + 3 * 3 * per_group * 64
                                            + 2 * 5 * 5 * 64 * 2)
    assert counts.conv_ops(_conv(64)) * 64 == counts.conv_ops(_conv(1))


def test_resnet320_totals():
    convs = counts.conv_shapes(RESNET, 1)
    # stem, 16 blocks of two convs, 3 projections, 3 extra pairs, 6 heads
    assert len(convs) == 1 + 32 + 3 + 6 + 6
    assert [c["name"] for c in convs if c["reads_image"]] == ["stem_conv"]
    assert (convs[0]["k"], convs[0]["hin"], convs[0]["ho"]) == (7, 320, 160)
    assert sum(c["ho"] * c["wo"] * c["cout"] // (RESNET["model"]["num_classes"] + 5)
               for c in convs if c["name"].startswith("classifier")) == \
        RESNET["preset"]["num_anchors"]
    assert counts.forward_ops(RESNET) == pytest.approx(17.725860864e9)
    stem = 2 * 160 * 160 * 64 * 7 * 7 * 3
    assert counts.train_ops(RESNET) == pytest.approx(3 * 17.725860864e9 - stem)
