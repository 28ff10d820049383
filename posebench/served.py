"""The served configurations: the program under test
(`articulated_pose_tpu_torch.serving.PosePredictor`), the inputs the
harness hands it, and the reference's judgement of what it returned.

The judgement covers the forward and the fit, each on its own.  The
forward's heads are held against the reference's float32 forward of
the same clouds and state dict.  The fit is a RANSAC over the heads, so
a rounding of the heads changes which points vote; the reference's fit
therefore runs on the heads the program returned, with the same draws,
and its part poses and part counts are held against the program's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from posebench import compare, harness
from posebench.reference import precision
from posebench.reference.model import ANCSH
from posebench.reference.pipeline import (PoseDraws, PoseFitConfig,
                                          fit_frame_batch)

POSE_KEYS = ("W", "nocs_per_point", "joint_axis_per_point", "index_per_point")


def fit_kwargs(config: Dict) -> Dict:
    kw = dict(config["pose_fit"])
    kw["joint_types"] = tuple(kw["joint_types"])
    return kw


def reference_model(config: Dict, device, matmul: str = "f32") -> ANCSH:
    net = config["network"]
    return ANCSH(net["n_max_parts"], config["backbone"],
                 packed=net["ball_query_packed"],
                 dropout_rate=net.get("dropout_rate", 0.5), matmul=matmul
                 ).to(device)


def state_dict(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of this run, drawn on the device from the seed."""
    with torch.device("meta"):
        template = reference_model(config, "meta")
    return harness.weights_from_seed(template,
                                     harness.sub_seed(seed, "weights"),
                                     config["init"], device)


def draws(config: Dict, batch: int, seed: int, device) -> PoseDraws:
    """RANSAC draws of one batch, from a generator on `device` seeded
    `seed` (the predictor's own draws are `seed` = the configuration's
    seed)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return PoseDraws.sample(batch, PoseFitConfig(**fit_kwargs(config)), g,
                            device)


def program(config: Dict, sd: Dict[str, torch.Tensor], device):
    """The PosePredictor of the configuration, serving `sd`."""
    from articulated_pose_tpu_torch.config import NetworkConfig
    from articulated_pose_tpu_torch.pose.pipeline import \
        PoseFitConfig as PortFitConfig
    from articulated_pose_tpu_torch.serving import PosePredictor

    return PosePredictor(NetworkConfig(**config["network"]), state_dict=sd,
                         pose_cfg=PortFitConfig(**fit_kwargs(config)),
                         device=device)


def port_draws(d: PoseDraws):
    """The harness's draws as the port's PoseDraws (the same tensors)."""
    from articulated_pose_tpu_torch.pose.pipeline import \
        PoseDraws as PortDraws
    return PortDraws(part=d.part, joint=d.joint)


class Reservoir:
    """k items drawn uniformly from a stream of unknown length, by the
    seeded generator `rng` (reservoir sampling)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k = k
        self.rng = rng
        self.items: List[Tuple[int, object]] = []

    def offer(self, index: int, item) -> None:
        if len(self.items) < self.k:
            self.items.append((index, item))
            return
        j = int(self.rng.integers(0, index + 1))
        if j < self.k:
            self.items[j] = (index, item)


@torch.no_grad()
def reference_heads(model: ANCSH, clouds: np.ndarray, device,
                    block: int) -> Dict[str, np.ndarray]:
    """The reference's eval forward of (B, N, 3) clouds, `block` clouds
    at a time."""
    model.eval()
    parts = []
    with precision(False):
        for lo in range(0, len(clouds), block):
            P = torch.as_tensor(clouds[lo:lo + block], device=device)
            parts.append({k: v.cpu().numpy() for k, v in model(P).items()})
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


@torch.no_grad()
def reference_fit(config: Dict, heads: Dict[str, np.ndarray],
                  clouds: np.ndarray, d: PoseDraws, device, block: int,
                  tf32: bool = False) -> Dict[str, np.ndarray]:
    """The reference's fit of heads (B, N, ...) with draws `d`, `block`
    clouds at a time: nonlinear R, s, t and the part counts."""
    cfg = PoseFitConfig(**fit_kwargs(config))
    out = []
    with precision(tf32):
        for lo in range(0, len(clouds), block):
            sl = slice(lo, lo + block)
            pred = {k: torch.as_tensor(heads[k][sl], device=device)
                    for k in POSE_KEYS}
            P = torch.as_tensor(clouds[sl], device=device)
            f = fit_frame_batch(pred, P, PoseDraws(d.part[sl], d.joint[sl]),
                                cfg)
            out.append({"R": f["nonlinear_R"], "s": f["nonlinear_s"],
                        "t": f["nonlinear_t"], "counts": f["part_counts"]})
    return {k: np.concatenate([o[k].cpu().numpy() for o in out])
            for k in out[0]}


def judge(config: Dict, models: Tuple[ANCSH, ANCSH], clouds: np.ndarray,
          d: PoseDraws, heads: Dict[str, np.ndarray],
          fits: Dict[str, np.ndarray], device, block: int
          ) -> Dict[str, float]:
    """The numbers of one served batch: `heads` are what the timed path
    computed for the (B, N, 3) `clouds` with draws `d`, and `fits` (R,
    s, t, counts) the answers it returned for the first n <= B of them.

    `models` are the reference in float32 and in the rounding of a bf16
    trunk.  The heads' gap from the float32 forward is read cloud by
    cloud, in units of the bf16 reference's own gap of that cloud: how
    far a set of random weights lets rounding move the heads differs
    from seed to seed and from cloud to cloud, for the program and a
    lower precision alike, and the ratio leaves that out
    (`compare.heads_ratio`).

    The forward runs `block` clouds at a time; the fit runs the whole
    batch at once, as the program does: a batched product may take
    other kernels at another batch count, and a RANSAC vote turns their
    rounding into another pose."""
    f32, bf16 = models
    ref = reference_heads(f32, clouds, device, block)
    lower = reference_heads(bf16, clouds, device, block)
    ref_fit = reference_fit(config, heads, clouds, d, device, len(clouds))
    n = len(fits["R"])
    ref_fit = {k: v[:n] for k, v in ref_fit.items()}
    return {"heads_ratio": compare.heads_ratio(heads, ref, lower),
            "fit_gap": compare.fit_gap(fits, ref_fit),
            "counts_gap": compare.counts_gap(fits["counts"],
                                             ref_fit["counts"])}


def judges(config: Dict, sd: Dict[str, torch.Tensor], device
           ) -> Tuple[ANCSH, ANCSH]:
    """The reference in float32 and in bf16 rounding, holding `sd`."""
    out = []
    for matmul in ("f32", "bf16"):
        m = reference_model(config, device, matmul)
        m.load_state_dict(sd)
        out.append(m)
    return tuple(out)


def worst(numbers: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(n[k] for n in numbers) for k in numbers[0]}


def result_arrays(res) -> Tuple[Dict, Dict]:
    """(heads, fits) of a PoseResult."""
    heads = {k: res.raw[k] for k in compare.HEADS}
    fits = {"R": res.R, "s": res.scale, "t": res.t, "counts": res.part_counts}
    return heads, fits
