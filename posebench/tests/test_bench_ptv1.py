"""The Point Transformer cell (`drivers/serve_ptv1_offline.py`) at tiny
widths on the CPU: a sound run reads `correct`, and a run with a fault
planted in the port's backbone reads it false under the cell's committed
limits; the cell's metric readers and work counts."""

import copy
import time

import pytest
import torch

from posebench import harness
from posebench.metrics import flops_ptv1, work, work_knn

PTV1 = "serve_ptv1_b16_n8192"


def tiny_ptv1(**traffic) -> harness.Cell:
    """The cell with the port's tiny Point Transformer (its preset
    `PT_TINY_WIDTHS`) and a small traffic."""
    from articulated_pose_tpu_torch.models.point_transformer import \
        PT_TINY_WIDTHS

    cell = harness.find_cell(PTV1)
    cfg = copy.deepcopy(cell.config)
    cfg["point_transformer"] = dict(
        {k: list(v) for k, v in PT_TINY_WIDTHS.items()}, stride=4, share=8)
    cfg["network"]["backbone_preset"] = "tiny"
    cell.config = cfg
    cell.traffic = dict(cell.traffic, **dict(dict(batch=4, points=256, pool=4,
                                                  ring=2), **traffic))
    cell.workload = copy.deepcopy(cell.workload)
    cell.workload["run"]["bn_clouds"] = 8
    return cell


def run(cell):
    return harness.load_driver(cell.driver).run(
        cell, seed=21, seconds=0.2, trace=False,
        t_start=time.perf_counter(), device="cpu")


def failed(outcome):
    return [c.name for c in outcome.checks if not c.ok]


def shifted_neighbours(real):
    """Each point's neighbour set one place down the list: the nearest
    (the point itself) left out and the (k+1)-th taken in."""
    return lambda k, xyz, q: real(k + 1, xyz, q)[..., 1:]


def channel_softmax(real):
    """The attention's softmax over the channels, not the neighbours."""
    return lambda a: torch.softmax(a.float(), dim=-1)


def squared_distance_weights(real):
    """The transition up's weights from the squared distance, as
    PointNet++ takes them, not the distance."""
    def weights(dist2):
        w = 1.0 / (dist2 + 1e-8)
        return w / w.sum(dim=-1, keepdim=True)
    return weights


class TF32Products(torch.overrides.TorchFunctionMode):
    """Every float32 matrix product with its inputs rounded to TF32 (10
    mantissa bits, to nearest), as the card's tensor cores take them
    when TF32 is on: the CPU has no TF32 of its own."""

    PRODUCTS = {torch.matmul, torch.bmm, torch.einsum, torch.Tensor.matmul,
                torch.Tensor.bmm, torch.Tensor.__matmul__,
                torch.Tensor.__rmatmul__}

    @staticmethod
    def rounded(t):
        if not (isinstance(t, torch.Tensor) and t.dtype == torch.float32):
            return t
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.PRODUCTS:
            args = tuple(self.rounded(a) for a in args)
        return func(*args, **(kwargs or {}))


def tf32_fit(real):
    """The served fit with its products in TF32, one precision below the
    float32 fit the configuration states."""
    def fit(*args, **kwargs):
        with TF32Products():
            return real(*args, **kwargs)
    return fit


def test_sound_ptv1_run_is_correct():
    out = run(tiny_ptv1())
    assert failed(out) == []
    assert out.attempted > 0


@pytest.mark.parametrize("name,fault", [
    ("neighbours", shifted_neighbours),
    ("neighbour_softmax", channel_softmax),
    ("interp_weights", squared_distance_weights)])
def test_broken_backbone_run_is_not_correct(monkeypatch, name, fault):
    from articulated_pose_tpu_torch.models import point_transformer
    monkeypatch.setattr(point_transformer, name,
                        fault(getattr(point_transformer, name)))
    assert "heads_ratio" in failed(run(tiny_ptv1()))


def test_a_tf32_fit_is_not_correct(monkeypatch):
    """The port's fit run in TF32 on its own heads: the heads pass, the
    fit's poses fall outside `fit_gap`."""
    from articulated_pose_tpu_torch import serving
    monkeypatch.setattr(serving, "fit_frame_batch",
                        tf32_fit(serving.fit_frame_batch))
    assert failed(run(tiny_ptv1())) == ["fit_gap"]


WIDTHS = {"planes": [32, 64, 128, 256, 512], "blocks": [1, 2, 3, 5, 2],
          "nsample": [8, 16, 16, 16, 16], "stride": 4, "share": 8}


def test_the_cell_searches_its_nine_shapes():
    assert work_knn.searches(WIDTHS, 8192) == [
        (8192, 8192, 8), (2048, 8192, 16), (2048, 2048, 16),
        (512, 2048, 16), (512, 512, 16), (128, 512, 16), (128, 128, 16),
        (32, 128, 16), (32, 32, 16)]
    assert work_knn.forward_pairs(WIDTHS, 1, 8192) == 89_478_144


def test_the_cells_fps_and_three_nn_floors():
    """The floors `serve.kernel_roofline` reads in the cell: four FPS
    launches, n -> n/4 from 8192, and four 3-NN launches, each level's
    points against the next coarser level's."""
    levels = [(8192, 2048), (2048, 512), (512, 128), (128, 32)]
    want = sum(work_knn.fps_work(16, n, m).floor_us()
               + work.three_nn_work(16, n, m).floor_us() for n, m in levels)
    assert work_knn.point_kernels_floor_us(WIDTHS, 16, 8192) == pytest.approx(
        want, rel=1e-12)
    # 16 clouds x 2047 picks x 8192 points x 10 FLOPs at 67 TFLOP/s
    assert work_knn.fps_work(16, 8192, 2048).floor_us() == pytest.approx(
        16 * 2047 * 8192 * 10 / 67e12 * 1e6)


def test_the_port_counts_what_the_work_functions_count():
    """The backbone's knn_pairs counter against work_knn at tiny widths,
    and the FLOP count of the published widths."""
    from articulated_pose_tpu_torch.config import NetworkConfig
    from articulated_pose_tpu_torch.models.ancsh import build_model

    cell = tiny_ptv1()
    model = build_model(NetworkConfig(**cell.config["network"]))
    with torch.no_grad():
        model(torch.rand(2, 256, 3))
    assert model.backbone.knn_pairs == work_knn.forward_pairs(
        cell.config["point_transformer"], 2, 256)
    total = flops_ptv1.forward_flops(WIDTHS, 3, 1, 8192)
    assert 3.3e9 < total < 3.5e9


def test_the_cells_metric_readers():
    load = harness.load_metric
    trace = {"stage_ms": [{"ptv1.e1.knn": 0.5, "ptv1.e1.b1.attn": 2.0,
                           "ptv1.d1.b1.attn": 1.0, "forward": 3.0},
                          {"ptv1.e1.b1.attn": 4.0, "forward": 1.0},
                          {"ptv1.e1.b1.attn": 5.0}],
             "grouped_bytes": 32e6, "batch": 16,
             "knn_floor_us": 50.0, "kernel_floor_us": 30.0,
             "window": {"events": [("void knn_kernel<8, 1>", 0.0, 100.0),
                                   ("three_nn_kernel", 100.0, 300.0),
                                   ("void fps_kernel<1, 16>", 300.0, 400.0)]}}
    assert load("ptv1.attention_device_ms").read(trace) == 4.0
    assert load("ptv1.grouped_mb").read(trace) == 2.0
    assert load("ptv1.knn_roofline").read(trace) == 50.0
    # the FPS and 3-NN events, not the k-NN kernel's
    assert load("serve.kernel_roofline").read(trace) == 10.0
    # a parent with none of the program's instruments reads nothing
    bare = {"stage_ms": [{"forward": 3.0}], "grouped_bytes": None,
            "batch": 16, "window": {"events": []}}
    for name in ("ptv1.attention_device_ms", "ptv1.grouped_mb",
                 "ptv1.knn_roofline"):
        assert load(name).read(bare) is None
