"""The MinkUNet cell (`drivers/serve_minkunet_offline.py`) at tiny widths
on the CPU: a sound run reads `correct`, and a run with a fault planted
in the port's backbone reads it false under the cell's committed
limits; the cell's metric readers and work counts."""

import copy
import dataclasses
import time

import numpy as np
import pytest
import torch

from posebench import harness
from posebench.metrics import flops_minkunet, work_minkunet

CELL = "serve_minkunet_b16_n8192"
WIDTHS = {"planes": [32, 64, 128, 256, 256, 128, 96, 96],
          "layers": [2, 3, 4, 6, 2, 2, 2, 2], "init_dim": 32}


def tiny_cell(**traffic) -> harness.Cell:
    """The cell with the port's tiny MinkUNet (`MINK_TINY_WIDTHS`) and a
    small traffic."""
    from articulated_pose_tpu_torch.models.minkunet import (MINK_TINY_WIDTHS,
                                                            MinkUNetSpec)

    cell = harness.find_cell(CELL)
    cfg = copy.deepcopy(cell.config)
    spec = MinkUNetSpec(**MINK_TINY_WIDTHS)
    cfg["minkunet"] = {
        f.name: (list(v) if isinstance(v := getattr(spec, f.name), tuple)
                 else v)
        for f in dataclasses.fields(spec) if f.name != "dropout_rate"}
    cfg["network"]["backbone_preset"] = "tiny"
    cell.config = cfg
    cell.traffic = dict(cell.traffic, **dict(dict(batch=3, points=256, pool=4,
                                                  ring=2), **traffic))
    cell.workload = copy.deepcopy(cell.workload)
    cell.workload["run"]["bn_clouds"] = 8
    return cell


def run(cell):
    return harness.load_driver(cell.driver).run(
        cell, seed=2 ** 31 + 27, seconds=0.2, trace=False,
        t_start=time.perf_counter(), device="cpu")


def failed(outcome):
    return [c.name for c in outcome.checks if not c.ok]


def mirrored_offsets(real):
    """Each neighbour read at the opposite offset."""
    return lambda grid, batch, depth, k: (
        lambda m: (m[0].flip(1), m[1]))(real(grid, batch, depth, k))


def merged_clouds(real):
    """Clusters counted as if the batch were one cloud (the cloud's bits
    dropped from the keys)."""
    def clusters(keys, batch_bits, B):
        return real(keys & ((1 << batch_bits) - 1), batch_bits, B)
    return clusters


def test_sound_minkunet_run_is_correct():
    out = run(tiny_cell())
    assert failed(out) == []
    assert out.attempted > 0


@pytest.mark.parametrize("name,fault,check", [
    ("neighbour_map", mirrored_offsets, "heads_ratio"),
    ("clusters", merged_clouds, "structure_gap")])
def test_broken_backbone_run_is_not_correct(monkeypatch, name, fault, check):
    from articulated_pose_tpu_torch.models import minkunet
    monkeypatch.setattr(minkunet, name, fault(getattr(minkunet, name)))
    assert check in failed(run(tiny_cell(points=512)))


def test_mirrored_child_slots_are_not_correct(monkeypatch):
    """The strided and transposed convolutions reading each child's slot
    mirrored (δ → 7 − δ)."""
    from articulated_pose_tpu_torch.models import minkunet

    real = minkunet.MinkUNetBackbone.plan

    def plan(self, X):
        p = real(self, X)
        for st in p.strides[1:]:
            st.children = st.children.flip(1)
            st.slot = st.slot // 8 * 8 + 7 - st.slot % 8
        return p
    monkeypatch.setattr(minkunet.MinkUNetBackbone, "plan", plan)
    assert "heads_ratio" in failed(run(tiny_cell(points=512)))


def test_the_published_widths_work():
    """62 convolutions, 46 of them 3³ submanifold; with every 3³ offset
    and every stem offset present at the cell's mean voxel counts the
    convolutions hold ~0.98 TFLOP a batch of 16."""
    n = [122_600, 89_000, 36_100, 9_300, 2_100]
    convs = work_minkunet.convolutions(WIDTHS, dict(
        level_points=n, conv_pairs=[27 * v for v in n],
        stem_pairs=125 * n[0]))
    assert len(convs) == 62
    assert sum(c.taps == 27 for c in convs) == 46
    assert sum(c.taps == 8 for c in convs) == 8
    assert sum(c.taps == 1 for c in convs) == 7
    total = sum(2 * c.pairs * c.cin * c.cout for c in convs)
    assert 0.9e12 < total < 1.1e12
    # the widest gather: d4.b0.c1 reads 128 channels at stride 1
    c = next(c for c in convs if c.name == "d4.b0.c1")
    assert (c.cin, c.cout, c.rows_in) == (128, 96, n[0])
    # a floor is the larger of its FLOPs and its bytes
    assert work_minkunet.conv_floor_us(c) == pytest.approx(
        1e6 * 2 * c.pairs * 128 * 96 / 989e12)
    up = next(c for c in convs if c.name == "up1")
    assert (up.cin, up.cout, up.rows_in, up.rows_out) == (256, 256, n[4],
                                                          n[3])
    assert work_minkunet.forward_floor_us(WIDTHS, dict(
        level_points=n, conv_pairs=[27 * v for v in n],
        stem_pairs=125 * n[0])) > 1e3


def test_the_port_counts_what_the_work_counts():
    """The counters of a tiny forward feed the work and FLOP counts with
    every stride the reference defines."""
    from articulated_pose_tpu_torch.config import NetworkConfig
    from articulated_pose_tpu_torch.models.ancsh import build_model

    cell = tiny_cell()
    model = build_model(NetworkConfig(**cell.config["network"]))
    with torch.no_grad():
        model(torch.rand(2, 256, 3) - 0.5)
    bb = model.backbone
    counters = {k: getattr(bb, k) for k in ("level_points", "conv_pairs",
                                            "stem_pairs")}
    assert len(counters["level_points"]) == 5 and bb.host_syncs == 2
    widths = cell.config["minkunet"]
    assert flops_minkunet.forward_flops(widths, 3, counters, 512) > 0
    assert work_minkunet.forward_floor_us(widths, counters) > 0


def test_the_cells_metric_readers():
    load = harness.load_metric
    spans = [{"minkunet.stem": 1.0, "minkunet.s1.map": 0.5,
              "minkunet.e1.b0.c1": 2.0, "minkunet.e2.b0.proj": 0.5,
              "minkunet.down1": 0.5, "minkunet.up4": 0.5,
              "minkunet.grid": 9.0},
             {"minkunet.e1.b0.c2": 3.0},
             {"minkunet.d1.b1.c1": 6.0, "minkunet.s2.map": 1.0}]
    trace = {"minkunet_span_ms": spans, "minkunet_host_syncs": 2,
             "minkunet_conv_floor_us": [1000.0, 500.0, 500.0]}
    assert load("minkunet.conv_device_ms").read(trace) == 5.0
    assert load("minkunet.host_syncs").read(trace) == 2
    # 2 ms of floors over 13.5 ms inside the convolutions' spans
    assert load("minkunet.conv_roofline").read(trace) == pytest.approx(
        100 * 2.0 / 13.5)
    # a parent without the backbone's spans and counters reads nothing
    bare = {"window": {"events": []}}
    for name in ("minkunet.conv_device_ms", "minkunet.conv_roofline",
                 "minkunet.host_syncs"):
        assert load(name).read(bare) is None
    assert np.isfinite(load("minkunet.conv_roofline").read(trace))
