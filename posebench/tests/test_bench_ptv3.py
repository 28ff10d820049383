"""The Point Transformer V3 cell (`drivers/serve_ptv3_offline.py`) at tiny
widths on the CPU: a sound run reads `correct`, and a run with a fault
planted in the port's backbone reads it false under the cell's committed
limits; the cell's metric readers and work counts."""

import copy
import dataclasses
import time

import numpy as np
import pytest
import torch

from posebench import harness
from posebench.metrics import flops_ptv3, work_ptv3

PTV3 = "serve_ptv3_b16_n8192"


def tiny_ptv3(**traffic) -> harness.Cell:
    """The cell with the port's tiny PTv3 (`PTV3_TINY_WIDTHS`) and a
    small traffic."""
    from articulated_pose_tpu_torch.models.point_transformer_v3 import (
        PTV3_TINY_WIDTHS, PointTransformerV3Spec)

    cell = harness.find_cell(PTV3)
    cfg = copy.deepcopy(cell.config)
    spec = PointTransformerV3Spec(**PTV3_TINY_WIDTHS)
    cfg["point_transformer_v3"] = {
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
        cell, seed=2 ** 31 + 21, seconds=0.2, trace=False,
        t_start=time.perf_counter(), device="cpu")


def failed(outcome):
    return [c.name for c in outcome.checks if not c.ok]


def swapped_orders(real):
    """z and hilbert-trans trade places in the canonical list."""
    return lambda *args: real(*args)[[3, 1, 2, 0]]


def uncopied_tail(real):
    """The last short patch padded with the cloud's first points, not the
    tail of the patch before it."""
    def layout(counts, K, device):
        p = real(counts, K, device)
        pad = p.pad.clone()
        off = pad_off = 0
        for n in counts:
            n_pad = -(-n // K) * K if n > K else n
            pad[pad_off + n:pad_off + n_pad] = off + torch.arange(n_pad - n)
            off, pad_off = off + n, pad_off + n_pad
        slots = p.slots.clone()
        if p.mask is None:
            slots = pad.view(slots.shape)
        else:
            slots[p.mask.view(slots.shape)] = pad
        return dataclasses.replace(p, pad=pad, slots=slots)
    return layout


def mirrored_offsets(real):
    """Each neighbour read at the opposite offset."""
    return lambda grid, batch, depth, k: (
        lambda m: (m[0].flip(1), m[1]))(real(grid, batch, depth, k))


def test_sound_ptv3_run_is_correct():
    out = run(tiny_ptv3())
    assert failed(out) == []
    assert out.attempted > 0


@pytest.mark.parametrize("name,fault,check", [
    ("serial_codes", swapped_orders, "structure_gap"),
    ("patch_layout", uncopied_tail, "structure_gap"),
    ("neighbour_map", mirrored_offsets, "heads_ratio")])
def test_broken_backbone_run_is_not_correct(monkeypatch, name, fault, check):
    from articulated_pose_tpu_torch.models import point_transformer_v3
    monkeypatch.setattr(point_transformer_v3, name,
                        fault(getattr(point_transformer_v3, name)))
    assert check in failed(run(tiny_ptv3(points=512)))


WIDTHS = {"enc_channels": [32, 64, 128, 256, 512],
          "enc_depths": [2, 2, 2, 6, 2], "enc_heads": [2, 4, 8, 16, 32],
          "dec_channels": [64, 64, 128, 256], "dec_depths": [2, 2, 2, 2],
          "dec_heads": [4, 4, 8, 16], "patch_size": 1024,
          "stride": [2, 2, 2, 2], "mlp_ratio": 4}


def test_the_published_widths_flops():
    """The FLOPs a cloud at the mean level counts of the cell's clouds:
    ~18 GFLOP in Linear layers and ~20 in attention, and with every
    xCPE offset present ~37.6 more."""
    n = [7682, 5608, 2274, 583, 134]
    seqs = [[1024] * 8, [1024] * 6, [1024] * 3, [583], [134]]
    linear = flops_ptv3.forward_flops(
        WIDTHS, 3, dict(level_points=n, sequences=[[]] * 5,
                        cpe_pairs=[0] * 5, stem_pairs=0), 0)
    assert 17e9 < linear < 21e9
    attn = flops_ptv3.forward_flops(
        WIDTHS, 3, dict(level_points=[0] * 5, sequences=seqs,
                        cpe_pairs=[0] * 5, stem_pairs=0), 0)
    assert 19e9 < attn < 23e9
    cpe = flops_ptv3.forward_flops(
        WIDTHS, 3, dict(level_points=[0] * 5, sequences=[[]] * 5,
                        cpe_pairs=[27 * v for v in n], stem_pairs=0), 0)
    assert 35e9 < cpe < 40e9


def test_the_attention_floor():
    # a 1024-point patch at C=32: 4·L²·C FLOPs at 989 TFLOP/s bind
    assert work_ptv3.sequence_floor_us(1024, 32) == pytest.approx(
        4 * 1024 ** 2 * 32 / 989e12 * 1e6)
    # level 4's encoder only (no decoder level 4): 2 blocks at C=512
    got = work_ptv3.attention_floor_us(WIDTHS, [[], [], [], [], [134]])
    assert got == pytest.approx(2 * work_ptv3.sequence_floor_us(134, 512))


def test_the_port_counts_what_the_flops_count():
    """The counters of a tiny forward feed `flops_ptv3` with every level
    and sequence the reference defines."""
    from articulated_pose_tpu_torch.config import NetworkConfig
    from articulated_pose_tpu_torch.models.ancsh import build_model

    cell = tiny_ptv3()
    model = build_model(NetworkConfig(**cell.config["network"]))
    with torch.no_grad():
        model(torch.rand(2, 256, 3) - 0.5)
    bb = model.backbone
    counters = {k: getattr(bb, k) for k in ("level_points", "sequences",
                                            "cpe_pairs", "stem_pairs")}
    assert sum(map(len, counters["sequences"])) > len(counters["sequences"])
    assert flops_ptv3.forward_flops(cell.config["point_transformer_v3"], 3,
                                    counters, 512) > 0


def test_the_cells_metric_readers():
    load = harness.load_metric
    spans = [{"ptv3.e0.b0.attn": 2.0, "ptv3.d0.b1.attn": 1.0,
              "ptv3.e0.b0.cpe": 4.0, "ptv3.e0.nbr": 0.5, "ptv3.stem": 0.5,
              "ptv3.e0.b0.mlp": 9.0},
             {"ptv3.e0.b0.attn": 5.0, "ptv3.e1.b0.cpe": 2.0},
             {"ptv3.e1.b0.attn": 4.0, "ptv3.e1.b1.cpe": 1.0}]
    trace = {"ptv3_span_ms": spans, "host_syncs": 11,
             "attention_floor_us": 50.0,
             "window": {"events": [
                 ("pytorch_flash::flash_fwd_kernel<...>", 0.0, 150.0),
                 ("fmha_cutlassF_bf16_aligned_64x64_rf_sm80", 150.0, 200.0),
                 ("void joint_fit_kernel<3>", 200.0, 900.0)]}}
    assert load("ptv3.attention_device_ms").read(trace) == 4.0
    assert load("ptv3.cpe_device_ms").read(trace) == 2.0
    assert load("ptv3.host_syncs").read(trace) == 11
    assert load("ptv3.attention_roofline").read(trace) == 25.0
    # a parent without the backbone's spans and counters reads nothing
    bare = {"window": {"events": []}}
    for name in ("ptv3.attention_device_ms", "ptv3.cpe_device_ms",
                 "ptv3.host_syncs", "ptv3.attention_roofline"):
        assert load(name).read(bare) is None
    assert np.isfinite(load("ptv3.attention_roofline").read(trace))
