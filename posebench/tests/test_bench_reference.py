"""The benchmark's frozen reference against the port's CPU path at tiny
widths: the forward (exact and packed ball query, eval and train mode),
the pose fit, the train step and the on-card generator's draw."""

import numpy as np
import pytest
import torch

from articulated_pose_tpu_torch.config import NetworkConfig
from articulated_pose_tpu_torch.data import device_synthetic as port_synth
from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated
from articulated_pose_tpu_torch.models.ancsh import build_model
from articulated_pose_tpu_torch.pose import pipeline as port_pipeline
from posebench import harness
from posebench.drivers import train_fused
from posebench.reference import pipeline as ref_pipeline
from posebench.reference import synthetic as ref_synth
from posebench.reference.model import ANCSH
from posebench.tests.tiny_cells import TINY_BACKBONE, train_b32

CPU = torch.device("cpu")


def models(packed: bool):
    cfg = NetworkConfig(n_max_parts=3, backbone_preset="tiny",
                        ball_query_packed=packed)
    port = build_model(cfg, device=CPU)
    ref = ANCSH(3, TINY_BACKBONE, packed=packed)
    sd = harness.weights_from_seed(ref, 3, "he", CPU)
    port.load_state_dict(sd)
    ref.load_state_dict(sd)
    return port, ref


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_port(packed, train):
    port, ref = models(packed)
    P = torch.rand(2, 256, 3, generator=torch.Generator().manual_seed(1))
    port.train(train)
    ref.train(train)
    out_p = port(P, generator=torch.Generator().manual_seed(9))
    out_r = ref(P, generator=torch.Generator().manual_seed(9))
    assert set(out_r) <= set(out_p)
    for k, v in out_r.items():
        torch.testing.assert_close(v, out_p[k], rtol=1e-5, atol=1e-6)
    if train:
        for (name, a), b in zip(port.named_buffers(), ref.buffers()):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6,
                                       msg=name)


def test_fit_matches_port():
    g = np.random.RandomState(4)
    B, N, K = 3, 256, 3
    pred = {"W": g.rand(B, N, K), "nocs_per_point": g.rand(B, N, 3 * K),
            "joint_axis_per_point": g.rand(B, N, 3),
            "index_per_point": g.rand(B, N, K)}
    pred = {k: torch.as_tensor(v, dtype=torch.float32)
            for k, v in pred.items()}
    P = torch.as_tensor(g.rand(B, N, 3), dtype=torch.float32)
    kw = dict(n_parts=K, niter_part=32, niter_joint=16,
              joint_types=("revolute", "revolute"), ransac_chunk=None)
    gen = torch.Generator().manual_seed(2)
    d = ref_pipeline.PoseDraws.sample(B, ref_pipeline.PoseFitConfig(**kw),
                                      gen)
    ref = ref_pipeline.fit_frame_batch(pred, P, d,
                                       ref_pipeline.PoseFitConfig(**kw))
    port = port_pipeline.fit_frame_batch(
        pred, P, port_pipeline.PoseDraws(d.part, d.joint),
        port_pipeline.PoseFitConfig(**kw))
    assert set(ref) == set(port)
    for k in ref:
        torch.testing.assert_close(ref[k], port[k], rtol=0, atol=0)


def test_generator_matches_port():
    kw = dict(n_parts=3, points_per_part=100,
              joint_types=("revolute", "revolute"), seed=5,
              full_rotation=False)
    port = port_synth.DeviceSynthetic(SyntheticArticulated(**kw),
                                      num_points=128, device="cpu")
    ref = ref_synth.DeviceSynthetic(ref_synth.SyntheticArticulated(**kw),
                                    num_points=128, device="cpu")
    seed = port_synth.data_seed(7, 3)
    assert seed == ref_synth.data_seed(7, 3)
    sp, gp = port.sample_batch(torch.Generator().manual_seed(seed), 4)
    sr, gr = ref.sample_batch(torch.Generator().manual_seed(seed), 4)
    for k in sp:
        torch.testing.assert_close(sp[k], sr[k], rtol=0, atol=0)
    for k in gp:
        torch.testing.assert_close(gp[k], gr[k], rtol=0, atol=0)


def test_train_steps_match_port():
    """Three fused steps of the port against the reference's three, from
    one state dict: on the CPU the two agree bit for bit."""
    cell = train_b32()
    sd = train_fused.state_dict(cell.config, 11, CPU)
    state, fused, _ = train_fused.program(cell.config, 11, sd, CPU)
    trainer = train_fused.reference_trainer(cell.config, 11, sd, CPU)
    params0 = [sd[n].clone() for n in trainer.names]
    assert trainer.names == state.names
    losses = []
    for step in range(train_fused.CHECKED_STEPS):
        losses.append(float(fused(state, step)["total_loss"]))
        if step == 0:
            grads = [m / (1.0 - train_fused.B1) for m in state.opt.mu]
    prog = {"losses": losses, "grads": grads,
            "params": [p.detach().clone() for p in state.params]}
    ref = train_fused.reference_steps(trainer)
    numbers = train_fused.numbers(prog, ref, params0)
    assert numbers == {"loss_gap": 0.0, "grad_gap": 0.0, "update_gap": 0.0}
    assert all(a != b for a, b in zip(ref["losses"], ref["losses"][1:]))
