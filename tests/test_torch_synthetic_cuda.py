"""The on-device synthetic generator and the fused train step, on the card.

Every test here needs an NVIDIA GPU (the fused step launches the CUDA
kernels, built by nvcc at first use) and skips without one.  Run them on
a GPU host with

    python -m pytest --noconftest tests/test_torch_synthetic_cuda.py -q

(`--noconftest` because tests/conftest.py imports jax, which a GPU host
need not have; this file imports none of it.)

`DeviceSynthetic` on the card against the same generator on the CPU with
one set of draws (made on the card, moved to the CPU): every label equal,
P and the GT poses within 1e-5.  A fused step at the e2e recipe's shape
(B=32, N=1024, reference widths) launches B1 `fps2` once, B3
`ball_query_group` twice and B4 `three_nn` twice a step.
"""

import pytest
import torch

from articulated_pose_tpu_torch import e2e
from articulated_pose_tpu_torch.data.device_synthetic import \
    make_fused_synthetic_train_step
from articulated_pose_tpu_torch.models.ancsh import build_model
from articulated_pose_tpu_torch.ops.kernels import (launch_counts,
                                                    reset_launch_counts)
from articulated_pose_tpu_torch.train.state import TrainState

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def setup(category, seed, device, *extra):
    args = e2e.parse_args(["--category", category, "--seed", str(seed),
                           *extra])
    K, joint_types = e2e.category_setup(args)
    return args, K, e2e.synthetic(args, K, joint_types, device)


@pytest.mark.parametrize("category,seed", [("laptop", 2), ("eyeglasses", 1),
                                           ("drawer", 3)])
@pytest.mark.parametrize("full_rotation", [False, True])
def test_card_frames_match_cpu(dev, category, seed, full_rotation):
    extra = ["--full-rotation"] if full_rotation else []
    args, K, card = setup(category, seed, dev, *extra)
    _, _, host = setup(category, seed, "cpu", *extra)
    draws = card.draw(torch.Generator(device=dev).manual_seed(seed), 32)
    got, got_gt = card.frames(draws)
    want, want_gt = host.frames(draws.to("cpu"))
    assert set(got) == set(want)
    for k in want:
        g = got[k].cpu()
        assert g.shape == want[k].shape and g.dtype == want[k].dtype, k
        if k == "P":
            assert (g - want[k]).abs().max().item() <= TOL
        else:
            assert torch.equal(g, want[k]), k
    for k in want_gt:
        assert (got_gt[k].cpu() - want_gt[k]).abs().max().item() <= TOL, k


def test_fused_step_launches_the_kernels(dev):
    args, K, dg = setup("laptop", 2, dev)
    cfg = e2e.train_config(args, K)
    state = TrainState(build_model(cfg, torch.Generator().manual_seed(0),
                                   device=dev), cfg)
    fused = make_fused_synthetic_train_step(cfg, dg, args.batch,
                                            steps_per_call=2)
    fused(state, 0)                       # builds the kernels
    reset_launch_counts()
    metrics = fused(state, 2)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    assert counts == {"fps2": 2, "ball_query_group": 4, "three_nn": 4}
    assert int(state.step) == 4
    assert bool(metrics["grads_finite"])
    assert torch.isfinite(metrics["total_loss"])
