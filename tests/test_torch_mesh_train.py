"""The sharded train step (`parallel/mesh.py::shard_train_setup`) on the
CPU, against the port's single-rank step and JAX's single-device step.

The ranks are processes of a gloo world started by
`parallel/launch.py::run_ranks`, each on the CPU, each world under the
helper's own time limit.  The batches come from the JAX generator's
NumPy path, dropout off (C6), at the tiny widths (B=8, N=128); the
data=2,model=2 world takes a tiny backbone whose global SA conv1 and
first FP stage are 256 wide, so that `state_shardings` splits both.

Bounds (`launch.BOUNDS`, JAX's own for its sharded step,
tests/test_train.py), each step against the single-rank step from the
world's own state before it, with the same routing (`train/routing.py`:
the data ranks reduce the batch statistics in another order, so a ReLU
input or a max-pool tie within rounding of its threshold may route the
other way): the loss rtol 1e-5, the grad norm rtol 1e-4, the new
batch-norm statistics 1e-4 of each one's largest entry, and each
parameter's gradient within 1e-4 of its leaf's largest entry beyond
1e-7.  A dense bias ahead of a batch norm has gradient 0 exactly; its
rounding noise is held to the same share of its layer's weight
gradient.  Against JAX, one step from JAX's state with JAX's ReLU masks
imposed on every rank's rows.  A mesh of one device is `train_step` bit
for bit, over three steps with dropout on.
"""

import copy
import time

import numpy as np
import optax
import pytest
import torch

from articulated_pose_tpu_torch import config
from articulated_pose_tpu_torch.models.ancsh import build_model
from articulated_pose_tpu_torch.models.pointnet2 import (TINY_WIDTHS,
                                                         BackboneSpec)
from articulated_pose_tpu_torch.parallel.launch import (
    BOUNDS, TrainJob, heatmap_target, run_ranks, single_rank_deviations,
    train_job)
from articulated_pose_tpu_torch.parallel.mesh import (make_mesh,
                                                      shard_train_setup)
from articulated_pose_tpu_torch.train.routing import (HEATMAP,
                                                      capture_routing,
                                                      grad_deviations,
                                                      impose_routing,
                                                      pre_bn_biases)
from articulated_pose_tpu_torch.train.state import (TrainState,
                                                    dropout_generator,
                                                    forward_loss, to_device,
                                                    train_step)
from test_torch_train import (CFG_KW, frames, jax_relu_masks,  # noqa: F401
                              jax_running_stats, jax_side, port_leaves,
                              port_state)

B, N = 8, 128
CFG = config.NetworkConfig(backbone_preset="tiny", batch_size=B,
                           num_points=N, dropout_rate=0.0)
WIDE = BackboneSpec(**dict(TINY_WIDTHS, global_mlp=(32, 256),
                           fp_mlps=((256,), (32,), (16, 16))))
# each world's own limit, well inside the suite's
WORLD_SECONDS = 120.0


def tiny_model(spec=None, seed=0):
    model = build_model(CFG, torch.Generator().manual_seed(seed), spec=spec)
    model.joint_net.dropout_rate = 0.0
    return model


def check_grads(got, want, zero, bound=1e-4):
    for _, name, err, scale in grad_deviations(got, want, zero):
        if name in zero:
            assert torch.as_tensor(got[name]).abs().max() <= bound * scale, \
                name
            continue
        assert err <= bound * scale + 1e-7, (name, err, scale)


def check_stats(got, want):
    """Each running statistic within 1e-4 of its largest entry."""
    for k, v in want.items():
        if "running" not in k:
            continue
        v = np.asarray(v)
        np.testing.assert_allclose(np.asarray(got[k]), v, rtol=1e-4,
                                   atol=1e-4 * np.abs(v).max(), err_msg=k)


def run_world(spec, model, batches, state=None, routing=None, cfg=CFG):
    devices = ["cpu"] * int(np.prod([int(p.split("=")[1])
                                     for p in spec.split(",")]))
    job = TrainJob(mesh=spec, devices=devices, config=cfg, model=model,
                   batches=batches, state=state, routing=routing,
                   capture=routing is None)
    t0 = time.monotonic()
    out = run_ranks(train_job, job, devices, timeout=WORLD_SECONDS)
    assert time.monotonic() - t0 < WORLD_SECONDS
    # every rank ends with the same gathered state and metrics
    for r in out[1:]:
        assert r["metrics"] == out[0]["metrics"]
        for key in ("model", "mu", "nu"):
            for k, v in out[0]["state"][key].items():
                assert torch.equal(r["state"][key][k], v), (key, k)
    return job, out


def test_imposed_heatmap_signs_take_the_records_gradient():
    """The L2 loss's |h - h_gt|: where the record's residual sign differs
    from the model's own, the heatmap's gradient takes the record's sign;
    the loss and every other point's gradient stay."""
    model = tiny_model(seed=3)
    batch = to_device(frames(B, seed=7, num_points=N), "cpu")
    gt = heatmap_target(model, batch, slice(None), "cpu")

    def run(record=None):
        st = TrainState(copy.deepcopy(model), CFG)
        own = {}
        handles = capture_routing(st.model, own, gt)
        if record is not None:
            handles += impose_routing(st.model, record, gt)
        total, _, pred = forward_loss(st, batch, train=True)
        grad, = torch.autograd.grad(total, pred["heatmap_per_point"])
        for h in handles:
            h.remove()
        return total.item(), grad[..., 0], own[HEATMAP]

    loss, grad, above = run()
    assert torch.equal(above, (pred_heatmap(model, batch) > gt))
    live = ((batch["joint_cls_mask"] > 0) & (grad != 0)).nonzero()[:6]
    assert len(live) == 6
    flip = torch.zeros_like(above)
    flip[live[:, 0], live[:, 1]] = True
    loss2, grad2, _ = run({HEATMAP: above ^ flip})
    assert loss2 == pytest.approx(loss, rel=1e-6)
    assert torch.equal(grad2[flip], -grad[flip])
    assert torch.equal(grad2[~flip], grad[~flip])
    # the record's own signs change nothing
    loss3, grad3, _ = run({HEATMAP: above})
    assert loss3 == loss and torch.equal(grad3, grad)


def pred_heatmap(model, batch):
    st = TrainState(copy.deepcopy(model), CFG)
    with torch.no_grad():
        return forward_loss(st, batch, train=True)[2][
            "heatmap_per_point"][..., 0]


def test_one_device_mesh_is_train_step_bit_for_bit():
    """Three steps with dropout on (rate 0.5 and the joint head's), the
    masks from (seed, step), in both."""
    cfg = config.NetworkConfig(backbone_preset="tiny", batch_size=B,
                               num_points=N)
    model = build_model(cfg, torch.Generator().manual_seed(1))
    a = TrainState(copy.deepcopy(model), cfg)
    b = TrainState(copy.deepcopy(model), cfg)
    step, b, sharding = shard_train_setup(
        b, make_mesh("data=1", devices=["cpu"]))
    assert sharding.shards == 1 and step.sharded == []
    gen = torch.Generator()
    for s in range(3):
        batch = frames(B, seed=s, num_points=N)
        want = train_step(a, batch, dropout_generator(gen, cfg.seed, s))
        got = step(b, batch)
        assert want.keys() == got.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (s, k)
    sa, sb = a.state_dict(), step.state_dict(b)
    for key in ("model", "mu", "nu"):
        for k, v in sa[key].items():
            assert torch.equal(sb[key][k], v), (key, k)
    assert torch.equal(sa["count"], sb["count"])
    assert torch.equal(sa["step"], sb["step"])


@pytest.mark.parametrize("spec,widths", [("data=2", None),
                                         ("data=2,model=2", WIDE)],
                         ids=["data2", "data2_model2"])
def test_sharded_step_matches_single_rank_step(spec, widths):
    """Two steps, each against the single-rank step from the world's
    state before it."""
    model = tiny_model(widths)
    batches = [frames(B, seed=5 + s, num_points=N) for s in range(2)]
    job, out = run_world(spec, model, batches)
    for s, dev in enumerate(single_rank_deviations(job, out, "cpu")):
        for k, bound in BOUNDS.items():
            assert dev[k] <= bound, (s, k, dev)
        assert out[0]["metrics"][s]["grads_finite"] == 1.0
    # the gathered state has the unsharded layout
    unsharded = TrainState(copy.deepcopy(model), CFG).state_dict()
    for key in ("model", "mu", "nu"):
        assert {k: v.shape for k, v in out[0]["state"][key].items()} == \
            {k: v.shape for k, v in unsharded[key].items()}, key
    assert int(out[0]["state"]["count"]) == int(out[0]["state"]["step"]) == 2
    if widths is None:
        assert all(r["sharded"] == {} for r in out)
    else:
        # each model rank holds half the rows of the two wide weights
        for r in out:
            assert r["sharded"] == {
                "backbone.sa_global.mlp.conv1.dense.weight": [128, 32],
                "backbone.fp1.mlp.conv0.dense.weight": [128, 288]}


def test_sharded_step_matches_jax_single_device_step(jax_side):
    """data=2 on JAX's own initial state and batch (test_torch_train's,
    B=4, N=64), JAX's ReLU masks imposed on each rank's rows, against
    JAX's single-device step; JAX's sharded step equals that step by
    JAX's own test (tests/test_train.py)."""
    (total, (_, new_bs, _)), jgrads = jax_side["grads"](
        jax_side["state0"], jax_side["batch"])
    st = port_state(jax_side["state0"])
    _, out = run_world("data=2", st.model, [jax_side["batch"]],
                       state=st.state_dict(),
                       routing=[jax_relu_masks(jax_side)],
                       cfg=config.NetworkConfig(**CFG_KW))
    got = out[0]["metrics"][0]
    np.testing.assert_allclose(got["total_loss"], float(total), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["grad_norm"],
                               float(optax.global_norm(jgrads)), rtol=1e-4)
    check_grads(out[0]["grads"][0], port_leaves(jgrads),
                pre_bn_biases(st.model))
    check_stats(out[0]["state"]["model"], jax_running_stats(new_bs))


def test_run_ranks_kills_a_world_past_its_time_limit():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish within 5"):
        run_ranks(time.sleep, 600, ["cpu", "cpu"], timeout=5.0)
    assert time.monotonic() - t0 < 30
