"""The benchmark's cells at tiny widths, for the CPU tests."""

from __future__ import annotations

import copy

from posebench import harness

TINY_BACKBONE = dict(sa_npoints=[64, 32], sa_radii=[0.2, 0.4],
                     sa_nsamples=[16, 16], sa_mlps=[[16, 16], [16, 32]],
                     global_mlp=[32, 64], fp_mlps=[[32], [32], [16, 16]],
                     head_width=16)


def tiny(name: str, **traffic) -> harness.Cell:
    """Cell `name` of BENCHMARK.json with the port's tiny backbone and
    the traffic's keys replaced by `traffic` (a training cell's
    num_points and batch_size go to its network)."""
    cell = harness.find_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["backbone"] = TINY_BACKBONE
    cfg["network"]["backbone_preset"] = "tiny"
    for k in ("num_points", "batch_size"):
        if k in traffic:
            cfg["network"][k] = traffic.pop(k)
    cell.config = cfg
    cell.traffic = dict(cell.traffic, **traffic)
    return cell


def serve_b64(**kw) -> harness.Cell:
    return tiny("serve_b64_offline", **dict(dict(batch=2, points=256, pool=4,
                                                 ring=2), **kw))


def train_b32(**kw) -> harness.Cell:
    return tiny("train_fused_b32", **dict(dict(num_points=256, batch_size=2,
                                               steps_per_call=2,
                                               log_every=4), **kw))
