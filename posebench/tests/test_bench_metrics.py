"""The metric arithmetic: the analytic GEMM count against the FLOP
counter, the frozen work functions against the port's, the trace
arithmetic and the readers."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from articulated_pose_tpu_torch import roofline
from posebench import harness
from posebench.metrics import flops, work
from posebench.reference.model import ANCSH
from posebench.tests.tiny_cells import TINY_BACKBONE
from posebench import tracing

REFERENCE_WIDTHS = dict(
    sa_npoints=[512, 128], sa_radii=[0.2, 0.4], sa_nsamples=[64, 64],
    sa_mlps=[[64, 64, 128], [128, 128, 256]], global_mlp=[256, 512, 1024],
    fp_mlps=[[256, 256], [256, 128], [128, 128, 128]], head_width=128)


@pytest.mark.parametrize("B,N", [(1, 128), (3, 256)])
def test_gemm_flops_match_the_counter(B, N):
    model = ANCSH(3, TINY_BACKBONE).eval()
    P = torch.rand(B, N, 3, generator=torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(P)
    assert counter.get_total_flops() == flops.forward_flops(
        TINY_BACKBONE, 3, B, N)


def test_reference_widths_count():
    # SA1: 2048 x ... per cloud: 32768 rows of 3->64->64->128
    per = dict(flops.layer_flops(REFERENCE_WIDTHS, 3, 1, 2048))
    assert per["sa1"] == 2 * 512 * 64 * (3 * 64 + 64 * 64 + 64 * 128)
    assert per["sa_global"] == 2 * 128 * (259 * 256 + 256 * 512 + 512 * 1024)
    assert 2.7e9 < flops.forward_flops(REFERENCE_WIDTHS, 3, 1, 2048) < 2.9e9


def test_work_functions_are_the_ports():
    assert work.fps2_work(4, 2048, 512, 128) == work.Work(
        *roofline.fps2_work(4, 2048, 512, 128).__dict__.values())
    for packed, name in ((False, "ball_query_group"),
                         (True, "ball_query_group_packed")):
        for emit in (False, True):
            ours = work.ball_query_work(packed, 4, 2048, 512, 64, emit, 9999)
            theirs = roofline.ball_query_work(name, 4, 2048, 512, 64, emit,
                                              9999)
            assert (ours.flops, ours.bytes) == (theirs.flops, theirs.bytes)
    ours, theirs = work.three_nn_work(4, 2048, 512), \
        roofline.three_nn_work(4, 2048, 512)
    assert (ours.flops, ours.bytes) == (theirs.flops, theirs.bytes)
    idx = torch.tensor([[[0, 3, 5], [1, 1, 1]]])
    cnt = torch.tensor([[3, 1]])
    assert work.scanned_points(idx, cnt, 10) == \
        roofline.scanned_points(idx, cnt, 10)
    floor = work.Work(67e12, 0.0).floor_us()
    assert floor == pytest.approx(1e6)


def test_union_and_breakdown():
    assert tracing.union_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert tracing.union_us([]) == 0
    window = {"events": [("a", 10, 20), ("b", 20, 25), ("a", 40, 50)],
              "spans": [("bench.call", 0, 60), ("bench.read", 26, 39)],
              "lo_us": 0, "hi_us": 60, "iters": 2,
              "window_us": 60, "busy_us": 25}
    bd = tracing.breakdown(window)
    assert bd["device_ops"] == [["a", 20e-6], ["b", 5e-6]]
    assert bd["idle_gaps"][0] == ["bench.read", 15e-6]
    assert [g[1] for g in bd["idle_gaps"]] == [15e-6, 10e-6, 10e-6]
    assert tracing.busy_per_iter_ms(window) == pytest.approx(0.0125)
    assert tracing.kernel_time_us(window, ("a",)) == 20


def test_readers_read_only_their_kind():
    window = {"events": [("fps_kernel<4,16,4>", 0, 30),
                         ("elementwise", 30, 90)],
              "busy_us": 90, "window_us": 100, "iters": 2}
    serve = {"kind": "serve", "window": window, "forward": window,
             "fit": window, "clouds_per_s": 1000.0,
             "forward_flops_per_cloud": 2.8e9, "peak_flops": 989e12,
             "kernel_floor_us": 3.0}
    train = {"kind": "train", "window": window, "datagen": window,
             "steps": 4, "clouds_per_s": 700.0,
             "train_flops_per_cloud": 7.7e9, "peak_flops": 67e12}
    read = {n: harness.load_metric(n).read for n in (
        "serve.idle_share", "serve.forward_device_ms", "serve.mfu",
        "serve.fit_device_ms", "serve.fit_device_ops",
        "serve.kernel_roofline", "train.idle_share", "train.step_device_ms",
        "train.datagen_device_ms", "train.mfu")}
    assert read["serve.idle_share"](serve) == pytest.approx(10.0)
    assert read["serve.forward_device_ms"](serve) == pytest.approx(0.045)
    assert read["serve.fit_device_ops"](serve) == 1
    assert read["serve.mfu"](serve) == pytest.approx(100 * 2.8e12 / 989e12)
    assert read["serve.kernel_roofline"](serve) == pytest.approx(10.0)
    assert read["train.step_device_ms"](train) == pytest.approx(0.0225)
    assert read["train.mfu"](train) == pytest.approx(100 * 7.7e9 * 700
                                                     / 67e12)
    for name in ("serve.idle_share", "serve.kernel_roofline", "serve.mfu"):
        assert read[name](train) is None
    for name in ("train.idle_share", "train.step_device_ms", "train.mfu"):
        assert read[name](serve) is None
