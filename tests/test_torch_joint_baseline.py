"""The direct joint-regression baseline in the port against the JAX
package's, on the CPU: the eval forward from converted Flax params,
`direct_joint_loss`, one train step with dropout off, `evaluate()`, and
the trainer's mechanics (fit, checkpoint, run_joint_baseline)."""

import json

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from articulated_pose_tpu.config import bn_momentum_schedule as jbn_momentum
from articulated_pose_tpu.config import load_config as jload_config
from articulated_pose_tpu.data.batcher import BatchIterator as JBatchIterator
from articulated_pose_tpu.data.synthetic import \
    SyntheticArticulated as JSynthetic
from articulated_pose_tpu.models import joint_regression as jreg
from articulated_pose_tpu.train.joint_baseline import \
    JointBaselineTrainer as JTrainer
from articulated_pose_tpu_torch import convert
from articulated_pose_tpu_torch.config import load_config
from articulated_pose_tpu_torch.data.batcher import BatchIterator
from articulated_pose_tpu_torch.models import joint_regression as reg
from articulated_pose_tpu_torch.train import joint_baseline as jb
from articulated_pose_tpu_torch.train.routing import (grad_deviations,
                                                      pre_bn_biases)

B, N, K = 4, 128, 3


@pytest.fixture(scope="module")
def setup():
    """Frames of the synthetic generator, JAX's initial variables and the
    port's model carrying them."""
    gen = JSynthetic(n_parts=K, points_per_part=100, seed=0)
    batch, _ = gen.batch(np.random.RandomState(0), B, num_points=N)
    model = jreg.DirectJointRegression(n_max_parts=K)
    variables = jax.device_get(model.init(jax.random.PRNGKey(0),
                                          jnp.asarray(batch["P"])))
    port = reg.DirectJointRegression(n_max_parts=K)
    port.load_state_dict(convert.joint_regression_state_dict_from_flax(
        variables["params"], variables["batch_stats"]))
    return batch, model, variables, port.eval()


def flat_outputs(pred):
    return [np.asarray(x) for jp in pred["joint_params"] for x in jp]


def test_converted_state_dict_is_the_models(setup):
    _, _, variables, port = setup
    sd = convert.joint_regression_state_dict_from_flax(
        variables["params"], variables["batch_stats"])
    assert set(sd) == set(reg.DirectJointRegression(n_max_parts=K)
                          .state_dict())


def test_eval_forward_matches_jax(setup):
    batch, model, variables, port = setup
    want = model.apply(variables, jnp.asarray(batch["P"]))
    with torch.no_grad():
        got = port(torch.tensor(batch["P"]))
    assert len(got["joint_params"]) == K - 1
    for g, w in zip(flat_outputs({"joint_params": [
            [x.numpy() for x in jp] for jp in got["joint_params"]]}),
            flat_outputs(want)):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("line_space", ["orthogonal", "plucker"])
def test_direct_joint_loss_matches_jax(line_space):
    rng = np.random.RandomState(1)
    pred = {"joint_params": [
        tuple(rng.randn(B, d).astype(np.float32)
              for d in ((3, 3, 1) if line_space == "orthogonal" else (3, 3)))
        for _ in range(K - 1)]}
    gt = rng.randn(B, K, 7).astype(np.float32)
    got = reg.direct_joint_loss(
        {"joint_params": [tuple(map(torch.tensor, jp))
                          for jp in pred["joint_params"]]},
        torch.tensor(gt), line_space)
    want = jreg.direct_joint_loss(
        {"joint_params": [tuple(map(jnp.asarray, jp))
                          for jp in pred["joint_params"]]},
        jnp.asarray(gt), line_space)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)


def test_train_step_matches_jax(setup, monkeypatch, tmp_path):
    """One train step with dropout off: the loss to rtol 1e-5, and each
    parameter's gradient within 0.1 of its largest entry on the port's
    own ReLU and max-pool routing (C6's rule, tests/test_torch_train.py;
    a dense bias ahead of a batch norm is held to its weight's scale)."""
    batch, model, variables, _ = setup
    cfg = load_config(category="eyeglasses", batch_size=B, num_points=N,
                      n_max_parts=K)
    # JAX's model hard-wires dropout 0.5: make its Dropout the identity
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, *a, **k: x)
    step = 3
    bn_mom = jbn_momentum(step, B, cfg.bn_decay_step)

    def loss_fn(p):
        out, _ = model.apply({"params": p,
                              "batch_stats": variables["batch_stats"]},
                             jnp.asarray(batch["P"]), train=True,
                             bn_momentum=bn_mom,
                             mutable=["batch_stats"])
        parts = jreg.direct_joint_loss(out, jnp.asarray(
            batch["joint_params_gt"]))
        return sum(jnp.mean(v) for v in parts.values())

    want_loss, want_grads = jax.value_and_grad(loss_fn)(variables["params"])
    want_grads = convert.joint_regression_state_dict_from_flax(
        jax.device_get(want_grads), {})

    tr = jb.JointBaselineTrainer(cfg, str(tmp_path), device="cpu")
    tr.model.load_state_dict(convert.joint_regression_state_dict_from_flax(
        variables["params"], variables["batch_stats"]))
    tr.model.backbone.dropout_rate = 0.0
    tr.step = step
    loss, means, grads = tr.loss_and_grads(
        {k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert set(means) == {"axis_loss", "orth_loss", "dist_loss"}
    names = [n for n, _ in tr.model.named_parameters()]
    assert set(names) == set(want_grads)
    got = dict(zip(names, (g.numpy() for g in grads)))
    zero = pre_bn_biases(tr.model)
    for _, name, err, scale in grad_deviations(got, want_grads, zero):
        if name in zero:
            # a dense bias ahead of a batch norm has gradient 0: both are
            # rounding noise, of the layer's weight gradient's scale
            assert np.abs(got[name]).max() <= 0.1 * scale, name
            assert np.abs(want_grads[name].numpy()).max() <= 0.1 * scale
            continue
        assert err <= 0.1 * scale + 1e-7, (name, err, scale)


def frames(n, seed):
    gen = JSynthetic(n_parts=K, points_per_part=100, seed=0)
    rng = np.random.RandomState(seed)
    return [gen.frame(rng, num_points=N, n_max_parts=K)[0] for _ in range(n)]


def test_evaluate_matches_jax(setup, tmp_path):
    batch, _, variables, _ = setup
    data = frames(6, seed=4)
    cfg = load_config(category="eyeglasses", batch_size=B, num_points=N,
                      n_max_parts=K)
    jcfg = jload_config(None, category="eyeglasses", batch_size=B,
                        num_points=N, n_max_parts=K)
    jtr = JTrainer(jcfg, str(tmp_path / "jax"))
    jtr.params, jtr.batch_stats = variables["params"], variables["batch_stats"]
    want = jtr.evaluate(JBatchIterator(6, lambda i: data[i], B, shuffle=False,
                                       drop_last=False))
    tr = jb.JointBaselineTrainer(cfg, str(tmp_path / "port"), device="cpu")
    tr.model.load_state_dict(convert.joint_regression_state_dict_from_flax(
        variables["params"], variables["batch_stats"]))
    got = tr.evaluate(BatchIterator(6, lambda i: data[i], B, shuffle=False,
                                    drop_last=False))
    assert set(got) == set(want)
    assert got["n_joints_evaluated"] == want["n_joints_evaluated"] > 0
    for k in ("joint_axis_err_deg", "joint_offset_err"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)


def fixed_batch_loss(model, batches):
    """The training loss summed over fixed batches, with batch norm on
    each batch's statistics and dropout off; momentum 1 leaves the
    running statistics as they are."""
    rate, model.backbone.dropout_rate = model.backbone.dropout_rate, 0.0
    model.train()
    try:
        with torch.no_grad():
            return sum(float(sum(v.mean() for v in reg.direct_joint_loss(
                model(b["P"], bn_momentum=1.0),
                b["joint_params_gt"]).values())) for b in batches)
    finally:
        model.backbone.dropout_rate = rate


def test_trainer_fits_checkpoints_and_reports(tmp_path):
    """12 steps of fit lower the training loss, read on the same two
    batches before and after (each step's own loss is another batch's,
    under its own dropout); then the checkpoint and the report."""
    cfg = load_config(category="eyeglasses", batch_size=2, num_points=N,
                      n_max_parts=K)
    data = frames(4, seed=5)
    fixed = [{k: torch.as_tensor(v) for k, v in b.items()}
             for b in BatchIterator(4, lambda i: data[i], 2, shuffle=False)]
    it = BatchIterator(4, lambda i: data[i], 2, seed=0)
    tr = jb.JointBaselineTrainer(cfg, str(tmp_path), device="cpu")
    before = fixed_batch_loss(tr.model, fixed)
    tr.fit(it, max_steps=1)
    assert tr.step == 1
    last = tr.fit(it, max_steps=12)
    assert tr.step == 12 and fixed_batch_loss(tr.model, fixed) < before
    assert set(last) == {"total_loss", "axis_loss", "orth_loss", "dist_loss"}
    tr2 = jb.JointBaselineTrainer(cfg, str(tmp_path), device="cpu")
    assert tr2.maybe_restore() == 12
    for a, b in zip(tr.model.state_dict().values(),
                    tr2.model.state_dict().values()):
        assert torch.equal(a, b)
    assert int(tr2.opt.count) == 0           # Adam starts afresh, as JAX's
    out = jb.run_joint_baseline(cfg, str(tmp_path), test_it=it, device="cpu")
    assert out["resumed_step"] == 12
    saved = json.load(open(tmp_path / "joint_baseline_eval.json"))
    assert set(saved) == {"joint_axis_err_deg", "joint_offset_err",
                          "n_joints_evaluated"}
    assert all(out[k] == v for k, v in saved.items())


def test_needs_a_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        jb.JointBaselineTrainer(load_config(), str(tmp_path))
