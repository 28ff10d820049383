"""The programs that the timing and accuracy tools run, and their
`--device` rule: bench.py's model and fit, the pose heads the JAX
timing scripts fit alone, and the f32 train step's state and batch.
`roofline`, `profile_train_stages` and the tools of `ab/` build from
here."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

TRAIN_CATEGORY = "eyeglasses"


def resolve_device(name: str, tool: str) -> torch.device:
    """`--device` as a torch.device; a card that is not there raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{tool}: device {device} is not available; pass "
                           "--device cpu to run on the CPU")
    return device


def bench_model(device: torch.device, spec=None,
                dtype: torch.dtype = torch.bfloat16):
    """bench.py's model (bench.py:103-118): ANCSH at K=3, mixed, joint
    heads, bf16 trunk, the packed kernel ball query, eval mode, weights
    from seed 0; `spec` gives other widths (the tests' tiny ones), and
    `dtype` another trunk precision with the same weights."""
    import dataclasses

    from articulated_pose_tpu_torch.models.ancsh import ANCSHModel
    from articulated_pose_tpu_torch.models.layers import init_weights
    from articulated_pose_tpu_torch.models.pointnet2 import BackboneSpec

    model = ANCSHModel(n_max_parts=3, mixed=True, pred_joint=True,
                       dtype=dtype,
                       backbone_spec=dataclasses.replace(
                           spec or BackboneSpec(), ball_query_impl="pallas",
                           ball_query_packed=True))
    model = init_weights(model, torch.Generator().manual_seed(0))
    return model.to(device).eval()


def bench_pose_config(**knobs):
    """bench.py's fit: K=3, two revolute joints, niter 128/64, the RANSAC
    hypotheses in one chunk (bench.py:116-118); `knobs` override."""
    from articulated_pose_tpu_torch.pose.pipeline import PoseFitConfig

    kw = dict(n_parts=3, niter_part=128, niter_joint=64,
              joint_types=("revolute", "revolute"), ransac_chunk=None)
    kw.update(knobs)
    return PoseFitConfig(**kw)


def random_predictions(rng: np.random.RandomState, B: int, N: int, K: int,
                       device: torch.device) -> Dict[str, torch.Tensor]:
    """The pose heads the JAX timing scripts fit when they time the fit
    alone: uniform [0, 1) W (B, N, K), NOCS (B, N, 3K), joint axis
    (B, N, 3) and joint index (B, N, K), drawn from `rng` in that
    order."""
    def t(*shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(
            device)

    return {"W": t(B, N, K), "nocs_per_point": t(B, N, 3 * K),
            "joint_axis_per_point": t(B, N, 3), "index_per_point": t(B, N, K)}


def train_setup(batch: int, points: int, dev: torch.device, spec=None,
                category: str = TRAIN_CATEGORY):
    """The f32 train step's state and one batch: the category's model at
    the reference widths (`spec` for others), weights from seed 0, and a
    batch of its on-card generator (seed 1, as the e2e recipe's) drawn
    from a generator seeded 5.  Returns (state, batch, the on-card
    generator)."""
    from articulated_pose_tpu_torch.config import NetworkConfig
    from articulated_pose_tpu_torch.data.device_synthetic import \
        DeviceSynthetic
    from articulated_pose_tpu_torch.data.synthetic import \
        SyntheticArticulated
    from articulated_pose_tpu_torch.models.ancsh import build_model
    from articulated_pose_tpu_torch.registry import get_category
    from articulated_pose_tpu_torch.train.state import TrainState

    cat = get_category(category)
    cfg = NetworkConfig(n_max_parts=cat.n_parts, num_points=points,
                        batch_size=batch, val_interval=0,
                        snapshot_interval=0)
    state = TrainState(build_model(cfg, torch.Generator().manual_seed(0),
                                   device=dev, spec=spec), cfg)
    dg = DeviceSynthetic(SyntheticArticulated(
        n_parts=cat.n_parts, points_per_part=500,
        joint_types=tuple(cat.joint_types), seed=1), num_points=points,
        noise=0.005, device=dev)
    batch0, _ = dg.sample_batch(torch.Generator(device=dev).manual_seed(5),
                                batch)
    return state, batch0, dg
