"""The yardstick's arithmetic against hand counts and against the
reference's own operations."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.lib import flops
from benchmark.reference import model as ref


def test_conv_counts_at_the_table_shape():
    # [16,640,640,64] -> 64: 2 * 16 * 640^2 * 64 * 64 * 9 = 483.2 GFLOP.
    assert flops.conv_flops(16, 640, 640, 64, 64) == pytest.approx(
        483.18e9, rel=1e-4)
    # One pass: 3.36 GB at 3.35 TB/s (bytes) over 0.976 ms (operations).
    assert flops.conv_bound(16, 640, 640, 64, 64, 1) == (
        pytest.approx(1.0016e-3, rel=1e-3), "bytes")
    # Three passes: 3 x 483.2 GFLOP at 495 TFLOP/s.
    assert flops.conv_bound(16, 640, 640, 64, 64, 3) == (
        pytest.approx(2.928e-3, rel=1e-3), "operations")
    b, kind = flops.launch_bound_s(
        "conv3x3_implicit_gemm", [[16, 640, 640, 64], [3, 3, 64, 64], [64],
                                  []], 1)
    assert kind == "bytes" and b == pytest.approx(1.0016e-3, rel=1e-3)


def test_small_o_and_wgrad_and_norm_bounds():
    # PERF.md row 3l: [16,80,80,512] -> 32 bytes-bound at 0.0667 ms.
    assert flops.conv_bound(16, 80, 80, 512, 32, 1) == (
        pytest.approx(0.0667e-3, rel=2e-2), "bytes")
    # Row 5: a step's wgrad at 955 GFLOP x 3 passes is 5.79 ms of ops;
    # one [4,256,256,64] -> 64 launch: 2 * 4 * 256^2 * 64^2 * 9 * 3 / 495T.
    assert flops.wgrad_bound(4, 256, 256, 64, 64, 3) == (
        pytest.approx(3 * 2 * 4 * 256 * 256 * 64 * 64 * 9 / 495e12,
                      rel=1e-9), "operations")
    # norm_affine_clamp on [16,640,640,64] fp32: read and write 1.68 GB.
    b, kind = flops.launch_bound_s(
        "norm_affine_clamp", [[16, 640, 640, 64], [1, 1, 1, 64]] * 1, 1)
    assert kind == "bytes"
    assert b == pytest.approx(2 * 16 * 640 * 640 * 64 * 4 / 3.35e12,
                              rel=1e-5)


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.fixture(scope="module")
def net():
    gen = torch.Generator().manual_seed(0)

    def conv(kh, cin, cout, bias=True):
        p = {"w": torch.randn((kh, kh, cin, cout), generator=gen) * 0.05}
        if bias:
            p["b"] = torch.zeros(cout)
        return p

    vgg = {n: conv(3, ci, co) for n, ci, co, _ in flops.VGG}
    fb = {"down": conv(3, 512, 32), "up": conv(3, 32, 512),
          "p1": {"down": conv(3, 512, 32),
                 "fc": {"w": torch.randn(64, 1024, generator=gen) * 0.01,
                        "b": torch.zeros(1024)}}}
    fb["p2"] = fb["p1"]
    dec = {f"filter{i}": fb for i in (1, 2, 3)}
    for name, ci, co in flops.RES_BLOCKS:
        dec[name] = {"conv1": conv(3, ci, co), "conv2": conv(3, co, co),
                     "shortcut": conv(1, ci, co, bias=False)}
    dec["out"] = conv(3, 64, 3)
    return {"encoder": vgg, "encoder_style": vgg, "decoder": dec}


@pytest.mark.parametrize("per_frame", [False, True])
def test_model_flops_match_the_reference(net, per_frame):
    h, w = 64, 128
    x = torch.randn(2, h, w, 3)
    style = ref.encode_style(net, torch.randn(1, 32, 32, 3))
    if per_frame:
        got = _counted(lambda: ref.decode(net["decoder"],
                                          ref.encode_content(net, x), style))
        # Each call also pools the 4 x 4 style map through the six
        # predictors' down convs: per call, not per frame.
        got -= 6 * flops.conv_flops(1, 4, 4, 512, 32)
    else:
        stats = ref.collect_stats(net["decoder"], ref.encode_content(net, x),
                                  style)
        got = _counted(lambda: ref.decode_global(
            net["decoder"], ref.encode_content(net, x), style, *stats))
    assert got == pytest.approx(2 * flops.stylize_flops(h, w, per_frame),
                                rel=1e-9)


def test_vgg_flops_match_the_reference(net):
    x = torch.randn(1, 40, 56, 3)
    assert _counted(lambda: ref.vgg(net["encoder"], x)) == pytest.approx(
        flops.vgg_flops(40, 56), rel=1e-9)
