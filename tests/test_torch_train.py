"""The port's training path against the JAX package's, on the CPU.

Both packages start from the same Flax-initialised variables (carried
into the port by `convert.state_dict_from_flax`, and the optimizer state
by `convert.train_state_from_optax`) and see the same numpy batch: the
tiny backbone preset, B=4, N=64 (tests/test_train.py's sizes).  The JAX
model runs its XLA ops, the port the kernels' plain versions.  Dropout
is off in both: `dropout_rate=0` in both configs, and the joint head's
fixed 0.5 (JAX's ancsh.py:131 passes no rate) is turned off by a Flax
method interceptor on the JAX side and by `joint_net.dropout_rate` on
the port's; the two packages' random streams differ anyway (ROADMAP C2).

Tolerances:
- each loss term and the `collect_losses` totals, on the same pred and
  gt arrays: rtol 1e-5;
- one train step: the loss rtol 1e-5; every parameter's gradient
  max|g_port - g_jax| <= 1e-4 * max|g_jax| + 1e-7, leaf by leaf, with
  JAX's ReLU masks imposed, and <= 0.1 * max|g_jax| + 1e-7 on the port's
  own, where at most 1e-4 of the ReLU choices differ from JAX's;
  grad_norm rtol 1e-5; the new running statistics rtol 1e-5 (momentum
  0.5 at step 0, so a wrong convention shows);
- Adam fed JAX's own gradients, at count 0 and from a carried optax
  state at count 3: parameters and moments rtol 1e-6, atol 1e-8;
- three train steps: the losses within 1e-3 relative;
- the finite guard: parameters, moments and count bit for bit as they
  were, the running statistics rtol 1e-5 to JAX's;
- the schedules: equal.
"""

import json

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax
from flax import traverse_util

from articulated_pose_tpu import config as jconfig
from articulated_pose_tpu import losses as jlosses
from articulated_pose_tpu.data.synthetic import \
    SyntheticArticulated as JaxSynthetic
from articulated_pose_tpu.models.ancsh import build_model as jax_build_model
from articulated_pose_tpu.models.layers import PointConv as JaxPointConv
from articulated_pose_tpu.models.layers import \
    ScheduledBatchNorm as JaxBatchNorm
from articulated_pose_tpu.train import state as jstate
from articulated_pose_tpu_torch import config, losses
from articulated_pose_tpu_torch.convert import (state_dict_from_flax,
                                                train_state_from_optax)
from articulated_pose_tpu_torch.data.batcher import BatchIterator
from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated
from articulated_pose_tpu_torch.models.ancsh import ANCSHModel, build_model
from articulated_pose_tpu_torch.models.layers import (ScheduledBatchNorm,
                                                      dropout)
from articulated_pose_tpu_torch.models.pointnet2 import BackboneSpec
from articulated_pose_tpu_torch.serving import PosePredictor
from articulated_pose_tpu_torch.train.routing import (capture_routing,
                                                      count_flips,
                                                      grad_deviations,
                                                      impose_routing,
                                                      pre_bn_biases)
from articulated_pose_tpu_torch.train.state import (TrainState,
                                                    dropout_generator,
                                                    eval_step, global_norm,
                                                    loss_and_grads, to_device,
                                                    train_step)
from articulated_pose_tpu_torch.train.trainer import Checkpointer, Trainer

B, N = 4, 64
CFG_KW = dict(backbone_preset="tiny", batch_size=B, num_points=N,
              dropout_rate=0.0)
DEV = torch.device("cpu")
# one step on the port's own ReLU routing against JAX's: the share of
# ReLU choices allowed to differ, and the gradient bound a leaf relative
# to its largest entry (measured: 1 choice of 331776, 2.4e-2)
FLIP_LIMIT = 1e-4
OWN_ROUTING_BOUND = 0.1


def no_dropout(next_fun, args, kwargs, context):
    """Flax interceptor: every nn.Dropout is the identity."""
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def frames(n, seed=0, num_points=N, nocs_type="AC"):
    """n labelled frames of the JAX generator's NumPy path, stacked."""
    gen = JaxSynthetic(n_parts=3, points_per_part=100, seed=0)
    rng = np.random.RandomState(seed)
    fs = [gen.frame(rng, num_points=num_points, nocs_type=nocs_type,
                    use_native=False)[0] for _ in range(n)]
    return {k: np.stack([f[k] for f in fs]) for k in fs[0]}


def flat_train_state(s):
    """A JAX TrainState flattened as train_state_from_optax reads it."""
    adam = s.opt_state.inner_state[0]
    tree = {"params": s.params, "batch_stats": s.batch_stats, "mu": adam.mu,
            "nu": adam.nu, "count": adam.count, "step": s.step}
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree, sep="/").items()}


def port_leaves(flax_tree):
    """A Flax params tree as {port parameter name: numpy array}."""
    flat = traverse_util.flatten_dict(jax.device_get(flax_tree), sep="/")
    return {k: v.numpy() for k, v in state_dict_from_flax(
        {"params/" + k: np.asarray(v) for k, v in flat.items()}).items()}


def port_state(jax_state, cfg_kw=CFG_KW):
    """The port's TrainState holding the JAX state's variables."""
    model = build_model(config.NetworkConfig(**cfg_kw))
    model.joint_net.dropout_rate = 0.0
    st = TrainState(model, config.NetworkConfig(**cfg_kw))
    st.load_state_dict(train_state_from_optax(flat_train_state(jax_state)))
    return st


def running_stats(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if "running" in k}


def jax_running_stats(batch_stats):
    flat = traverse_util.flatten_dict(jax.device_get(batch_stats), sep="/")
    return {k: v.numpy() for k, v in state_dict_from_flax(
        {"batch_stats/" + k: np.asarray(v) for k, v in flat.items()}).items()}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model, its initial state, a batch, and its compiled
    value-and-grad and train step (each compiled once, dropout off)."""
    cfg = jconfig.NetworkConfig(**CFG_KW)
    model = jax_build_model(cfg)
    batch = frames(B)
    state0 = jstate.create_train_state(model, cfg, jax.random.PRNGKey(0),
                                       batch["P"])
    vg = jax.jit(lambda p, bs, b: jax.value_and_grad(
        jstate._forward_loss, has_aux=True)(
            p, bs, model.apply, b, cfg, train=True,
            rng=jax.random.PRNGKey(0), step=0))
    step = jstate.make_train_step(cfg, donate=False)

    def grads(state, b):
        with fnn.intercept_methods(no_dropout):
            return vg(state.params, state.batch_stats, b)

    def train(state, b):
        with fnn.intercept_methods(no_dropout):
            return step(state, b, jax.random.PRNGKey(0))

    return dict(cfg=cfg, batch=batch, state0=state0, grads=grads,
                train=train)


# ------------------------------------------------------------ schedules
@pytest.mark.parametrize("step", [0, 1, 12499, 12500, 12501, 10**6])
def test_schedules_match_jax(step):
    # 200000 samples / B=16: the first decay boundary is step 12500
    want_bn = np.asarray(jconfig.bn_momentum_schedule(step, 16, 200_000))
    want_lr = np.asarray(jconfig.lr_schedule(jnp.int32(step), 16, 1e-3,
                                             200_000, 0.7))
    got_bn = config.bn_momentum_schedule(step, 16, 200_000)
    got_lr = config.lr_schedule(torch.tensor(step, dtype=torch.int32), 16,
                                1e-3, 200_000, 0.7)
    assert got_bn.dtype == got_lr.dtype == torch.float32
    assert got_bn.numpy() == want_bn
    assert got_lr.numpy() == want_lr


# --------------------------------------------------------------- losses
def random_pred_gt(seed, K=3, mixed=True, joint=True):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.rand(*s).astype(np.float32)  # noqa: E731
    soft = lambda x: np.exp(x) / np.exp(x).sum(-1, keepdims=True)  # noqa: E731
    cls = rng.randint(-1, K, size=(B, N)).astype(np.float32)
    mask = np.zeros((B, N, K), np.float32)
    ok = cls >= 0
    mask[ok, cls[ok].astype(int)] = 1.0
    pred = {"W": soft(f(B, N, K) * 4), "nocs_per_point": f(B, N, 3 * K),
            "confi_per_point": 0.05 + 0.9 * f(B, N, 1)}
    gt = {"nocs_gt": f(B, N, 3), "cls_gt": cls, "mask_array": mask}
    if mixed:
        pred["gocs_per_point"] = f(B, N, 3 * K)
        gt["nocs_gt_g"] = f(B, N, 3)
    if joint:
        pred.update({"heatmap_per_point": f(B, N, 1),
                     "unitvec_per_point": 2 * f(B, N, 3) - 1,
                     "joint_axis_per_point": 2 * f(B, N, 3) - 1,
                     "index_per_point": soft(f(B, N, K) * 4)})
        gt.update({"heatmap_gt": f(B, N), "unitvec_gt": 2 * f(B, N, 3) - 1,
                   "orient_gt": 2 * f(B, N, 3) - 1,
                   "joint_cls_gt": rng.randint(-1, K, (B, N)).astype(
                       np.float32),
                   "joint_cls_mask": (f(B, N) > 0.5).astype(np.float32),
                   "joint_params_gt": f(B, K, 7)})
    return pred, gt


def t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


@pytest.mark.parametrize("type_l", ["L2", "Soft_L1", "L1"])
@pytest.mark.parametrize("self_supervise", [False, True])
@pytest.mark.parametrize("multi_head", [True, False])
def test_nocs_loss_matches_jax(type_l, self_supervise, multi_head):
    pred, gt = random_pred_gt(1)
    nocs = pred["nocs_per_point"] if multi_head else \
        pred["nocs_per_point"][..., :3]
    kw = dict(num_parts=3, type_l=type_l, multi_head=multi_head,
              self_supervise=self_supervise)
    want = jlosses.compute_nocs_loss(
        nocs, gt["nocs_gt"], pred["confi_per_point"],
        mask_array=gt["mask_array"], **kw)
    got = losses.compute_nocs_loss(
        torch.from_numpy(nocs), torch.from_numpy(gt["nocs_gt"]),
        torch.from_numpy(pred["confi_per_point"]),
        mask_array=torch.from_numpy(gt["mask_array"]), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("type_l", ["L2", "Soft_L1", "L1"])
@pytest.mark.parametrize("key,gt_key", [("heatmap_per_point", "heatmap_gt"),
                                        ("unitvec_per_point", "unitvec_gt")])
def test_vect_loss_matches_jax(type_l, key, gt_key):
    pred, gt = random_pred_gt(2)
    conf = gt["joint_cls_mask"]
    want = jlosses.compute_vect_loss(pred[key], gt[gt_key], confidence=conf,
                                     type_l=type_l)
    got = losses.compute_vect_loss(
        torch.from_numpy(pred[key]), torch.from_numpy(gt[gt_key]),
        confidence=torch.from_numpy(conf), type_l=type_l)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_miou_loss_matches_jax_with_ignored_labels():
    pred, gt = random_pred_gt(3)
    labels = gt["cls_gt"].astype(np.int32)
    assert (labels == -1).any()
    want = jlosses.compute_miou_loss(pred["W"], labels)
    got = losses.compute_miou_loss(torch.from_numpy(pred["W"]),
                                   torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_smooth_l1_matches_jax():
    d = np.random.RandomState(4).rand(B, N).astype(np.float32) * 0.3
    np.testing.assert_allclose(
        losses.smooth_l1_diff(torch.from_numpy(d)).numpy(),
        np.asarray(jlosses.smooth_l1_diff(d)), rtol=1e-5)


@pytest.mark.parametrize("nocs_type", ["ancsh", "npcs"])
@pytest.mark.parametrize("type_l", ["L2", "Soft_L1"])
def test_collect_losses_matches_jax(nocs_type, type_l):
    mixed = nocs_type == "ancsh"
    pred, gt = random_pred_gt(5, mixed=mixed, joint=mixed)
    jcfg = jconfig.load_config(None, nocs_type=nocs_type,
                               coord_regress_loss=type_l)
    pcfg = config.load_config(None, nocs_type=nocs_type,
                              coord_regress_loss=type_l)
    jgt = jstate._gt_from_batch({k: jnp.asarray(v) for k, v in gt.items()})
    want_total, want = jlosses.collect_losses(
        jlosses.compute_all_losses(pred, jgt, jcfg), jcfg)
    from articulated_pose_tpu_torch.train.state import gt_from_batch
    got_total, got = losses.collect_losses(
        losses.compute_all_losses(t(pred), gt_from_batch(t(gt)), pcfg), pcfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got_total.numpy(), np.asarray(want_total),
                               rtol=1e-5)


def test_hungarian_matching_matches_jax():
    cost = np.random.RandomState(6).rand(3, 4, 4)
    n = np.array([4, 2, 3])
    np.testing.assert_array_equal(losses.hungarian_matching(cost, n),
                                  jlosses.hungarian_matching(cost, n))


# -------------------------------------------------------- layers in train
@pytest.mark.parametrize("shape", [(B, N, 8), (B, 16, 8, 8)])
def test_train_batch_norm_matches_jax(shape):
    """Normalised by the batch's biased variance over every axis but the
    last; running stats moved by m * ra + (1 - m) * batch."""
    rng = np.random.RandomState(7)
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    C = shape[-1]
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.uniform(-0.2, 0.2, C).astype(np.float32)
    mean0 = rng.uniform(-0.2, 0.2, C).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, C).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, new = JaxBatchNorm().apply(variables, x, train=True,
                                     momentum=jnp.float32(0.7),
                                     mutable=["batch_stats"])
    bn = ScheduledBatchNorm(C).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    got = bn(torch.from_numpy(x), torch.tensor(0.7))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new["batch_stats"]["var"]),
                               rtol=1e-5)


class TestDropout:
    def test_output_is_the_redrawn_mask(self):
        x = torch.randn(8, 64, 16)
        g = torch.Generator().manual_seed(11)
        clone = torch.Generator()
        clone.set_state(g.get_state())
        got = dropout(x, 0.3, True, g)
        keep = torch.rand(x.shape, generator=clone) < 0.7
        assert torch.equal(got, torch.where(keep, x / 0.7, 0.0))

    def test_keep_rate(self):
        n = 200_000
        got = dropout(torch.ones(n), 0.5, True,
                      torch.Generator().manual_seed(12))
        kept = (got != 0).float().mean().item()
        assert abs(kept - 0.5) < 4 * np.sqrt(0.25 / n)
        assert torch.all((got == 0) | (got == 2.0))

    def test_eval_and_rate_zero_are_the_identity(self):
        x = torch.randn(4, 32, 8)
        assert dropout(x, 0.5, False, None) is x
        assert dropout(x, 0.0, True, None) is x

    def test_model_train_mode_draws_masks_eval_does_not(self):
        model = build_model(config.NetworkConfig(backbone_preset="tiny"),
                            torch.Generator().manual_seed(0))
        P = torch.from_numpy(frames(2)["P"])
        model.eval()
        with torch.no_grad():
            a, b = model(P)["W"], model(P)["W"]
        assert torch.equal(a, b)
        model.train()
        with torch.no_grad():
            c = model(P, generator=torch.Generator().manual_seed(1))["W"]
            d = model(P, generator=torch.Generator().manual_seed(2))["W"]
        assert not torch.equal(c, d)


# ------------------------------------------------------ one step vs JAX
def jax_relu_masks(jax_side):
    """{port PointConv name: JAX's ReLU mask} of the first train forward."""
    s = jax_side["state0"]
    model = jax_build_model(jax_side["cfg"])
    with fnn.intercept_methods(no_dropout):
        _, out = model.apply(
            {"params": s.params, "batch_stats": s.batch_stats},
            jax_side["batch"]["P"], train=True, bn_momentum=0.5,
            capture_intermediates=lambda mdl, method: isinstance(
                mdl, JaxPointConv),
            mutable=["intermediates", "batch_stats"])
    flat = traverse_util.flatten_dict(out["intermediates"], sep="/")
    return {k[:-len("/__call__")].replace("/", "."): np.asarray(v[0]) > 0
            for k, v in flat.items() if k.endswith("/__call__")}


def test_one_step_loss_grads_and_bn_stats(jax_side):
    """One step's loss, gradients, grad norm and new running statistics.

    The gradients are compared with JAX's ReLU masks imposed on the port
    (`train.routing`): in training mode the two packages' forwards differ
    by up to ~1e-4 (JAX's CPU reductions of the batch statistics carry
    ~1e-6 relative rounding, the port's ~4e-8), so a pre-activation that
    close to 0 takes the other side of the ReLU in one package, and at
    these sizes that moves one position of a few hundred, 1e-2 of a
    leaf.  With the masks imposed the per-leaf bound is 1e-4 *
    max|g_jax| + 1e-7.  On the port's own routing, at most FLIP_LIMIT of
    the ReLU choices may differ from JAX's, and each leaf is held to
    OWN_ROUTING_BOUND * max|g_jax| + 1e-7.  A dense bias ahead of a batch
    norm has gradient 0 exactly and both packages return rounding noise:
    it is held to the same factor of its layer's weight gradient.
    """
    (total, (summ, new_bs, _)), jgrads = jax_side["grads"](
        jax_side["state0"], jax_side["batch"])
    batch = to_device(jax_side["batch"], DEV)
    st = port_state(jax_side["state0"])
    ptotal, psumm, _ = loss_and_grads(st, batch)
    np.testing.assert_allclose(ptotal.item(), float(total), rtol=1e-5)
    for k in summ:
        np.testing.assert_allclose(psumm[k].item(), float(summ[k]),
                                   rtol=1e-5, err_msg=k)
    got_bs = running_stats(st.model)
    for k, v in jax_running_stats(new_bs).items():
        # per statistic, relative to its largest entry (a mean near 0
        # keeps JAX's absolute rounding)
        np.testing.assert_allclose(got_bs[k].numpy(), v, rtol=1e-5,
                                   atol=1e-5 * np.abs(v).max(), err_msg=k)

    st = port_state(jax_side["state0"])
    jax_masks = jax_relu_masks(jax_side)
    own = {}
    handles = capture_routing(st.model, own)
    _, _, free = loss_and_grads(st, batch)
    for h in handles:
        h.remove()
    st = port_state(jax_side["state0"])
    handles = impose_routing(st.model, jax_masks)
    _, _, pgrads = loss_and_grads(st, batch)
    for h in handles:
        h.remove()
    want = port_leaves(jgrads)
    assert set(want) == set(st.names)
    zero = pre_bn_biases(st.model)
    flipped, total = count_flips(own, jax_masks)
    assert total > 0 and flipped <= FLIP_LIMIT * total, (flipped, total)
    for grads, bound in ((pgrads, 1e-4), (free, OWN_ROUTING_BOUND)):
        got = dict(zip(st.names, (g.numpy() for g in grads)))
        for _, name, err, scale in grad_deviations(got, want, zero):
            if name in zero:
                # rounding noise on both sides, of the layer's weight's scale
                assert np.abs(got[name]).max() <= bound * scale, name
                assert np.abs(want[name]).max() <= bound * scale, name
                continue
            assert err <= bound * scale + 1e-7, (name, err, bound)
    np.testing.assert_allclose(global_norm(pgrads).item(),
                               float(optax.global_norm(jgrads)), rtol=1e-5)


@pytest.mark.parametrize("steps_before", [0, 3])
def test_adam_update_matches_optax(jax_side, steps_before):
    """JAX's own gradients through both optimizers, from the initial
    state (count 0) and from a state JAX trained 3 steps (count 3)."""
    state = jax_side["state0"]
    for _ in range(steps_before):
        state, _ = jax_side["train"](state, jax_side["batch"])
    _, jgrads = jax_side["grads"](state, jax_side["batch"])
    updates, new_opt = state.tx.update(jgrads, state.opt_state, state.params)
    new_params = optax.apply_updates(state.params, updates)
    adam = new_opt.inner_state[0]
    assert int(adam.count) == steps_before + 1

    st = port_state(state)
    assert int(st.opt.count) == steps_before
    g = port_leaves(jgrads)
    finite = st.tx.apply(st.params, [torch.from_numpy(g[n]) for n in st.names],
                         st.opt)
    assert bool(finite) and int(st.opt.count) == steps_before + 1
    for got, want in ((st.params, port_leaves(new_params)),
                      (st.opt.mu, port_leaves(adam.mu)),
                      (st.opt.nu, port_leaves(adam.nu))):
        for name, p in zip(st.names, got):
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       rtol=1e-6, atol=1e-8, err_msg=name)


def test_adam_reads_the_rate_at_its_count_after_a_skipped_update(
        jax_side):
    """With the rate decaying every step (decay_step = B samples), a
    rejected update leaves optax's count, so the next update uses the
    first rate, not the second: the port's Adam equals optax's through a
    NaN update and a finite one."""
    cfg_kw = dict(CFG_KW, decay_step=B)
    jcfg = jconfig.NetworkConfig(**cfg_kw)
    tx = jstate.make_optimizer(jcfg)
    state = jax_side["state0"]
    params, opt = state.params, tx.init(state.params)
    _, jgrads = jax_side["grads"](state, jax_side["batch"])
    bad = jax.tree.map(lambda g: g * jnp.nan, jgrads)
    st = port_state(state, cfg_kw)
    for grads in (bad, jgrads):
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        g = port_leaves(grads)
        st.tx.apply(st.params, [torch.from_numpy(g[n]) for n in st.names],
                    st.opt)
    assert int(opt.inner_state[0].count) == int(st.opt.count) == 1
    want = port_leaves(params)
    for name, p in zip(st.names, st.params):
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   rtol=1e-6, atol=1e-8, err_msg=name)


def test_three_steps_track_jax(jax_side):
    state = jax_side["state0"]
    st = port_state(state)
    for i in range(3):
        state, m = jax_side["train"](state, jax_side["batch"])
        pm = train_step(st, jax_side["batch"])
        np.testing.assert_allclose(pm["total_loss"].item(),
                                   float(m["total_loss"]), rtol=1e-3,
                                   err_msg=f"step {i}")
    assert int(st.step) == int(state.step) == 3


def test_finite_guard_matches_jax(jax_side):
    """A NaN label after one good step (so the moments and the count are
    not zero): nothing of the optimizer moves, `step` does, and the
    batch-norm statistics of the forward are kept, as in JAX."""
    bad = dict(jax_side["batch"])
    bad["nocs_gt"] = bad["nocs_gt"] * np.nan
    state1, _ = jax_side["train"](jax_side["state0"], jax_side["batch"])
    state, m = jax_side["train"](state1, bad)
    st = port_state(state1)
    before = {k: [t.clone() for t in ts] for k, ts in
              (("params", st.params), ("mu", st.opt.mu), ("nu", st.opt.nu))}
    count = st.opt.count.clone()
    pm = train_step(st, bad)
    assert not bool(m["grads_finite"]) and not bool(pm["grads_finite"])
    for k, ts in (("params", st.params), ("mu", st.opt.mu),
                  ("nu", st.opt.nu)):
        for a, b in zip(before[k], ts):
            assert torch.equal(a, b), k
    assert torch.equal(st.opt.count, count) and int(count) == 1
    assert int(st.step) == int(state.step) == 2
    got_bs = running_stats(st.model)
    for k, v in jax_running_stats(state.batch_stats).items():
        np.testing.assert_allclose(got_bs[k].numpy(), v, rtol=1e-5,
                                   atol=1e-5 * np.abs(v).max(), err_msg=k)


def test_train_state_from_optax_round_trip(jax_side):
    flat = flat_train_state(jax_side["state0"])
    sd = train_state_from_optax(flat)
    st = port_state(jax_side["state0"])
    assert set(sd["mu"]) == set(sd["nu"]) == set(st.names)
    assert set(sd["model"]) == set(st.model.state_dict())
    with pytest.raises(KeyError, match="unexpected"):
        train_state_from_optax({**flat, "opt/x": np.zeros(2)})


# ------------------------------------------------ the port's own training
TINY = BackboneSpec(
    sa_npoints=(32, 16), sa_radii=(0.25, 0.5), sa_nsamples=(8, 8),
    sa_mlps=((16, 16), (16, 32)), global_mlp=(32, 64),
    fp_mlps=((32,), (32,), (16, 16)), head_width=16)


def tiny_setup(batch=8, num_points=N, mixed=True, seed=0):
    """tests/test_train.py's tiny_setup: its TINY backbone, seeded weights,
    dropout on."""
    cfg = config.NetworkConfig(
        num_points=num_points, batch_size=batch,
        nocs_type="ancsh" if mixed else "npcs", pred_joint=mixed,
        pred_joint_ind=mixed, decay_step=10**9, bn_decay_step=10**9,
        val_interval=0, snapshot_interval=0)
    model = ANCSHModel(n_max_parts=3, mixed=mixed, pred_joint=mixed,
                       backbone_spec=TINY)
    from articulated_pose_tpu_torch.models.layers import init_weights
    init_weights(model, torch.Generator().manual_seed(seed))
    gen = SyntheticArticulated(n_parts=3, points_per_part=100, seed=0)
    data, _ = gen.batch(np.random.RandomState(0), batch, num_points=num_points,
                        nocs_type="AC" if mixed else "A")
    return cfg, model, data


class TestPortTraining:
    def test_loss_decreases(self):
        cfg, model, batch = tiny_setup()
        st = TrainState(model, cfg)
        g = torch.Generator()
        dropout_generator(g, cfg.seed, 0)
        first = train_step(st, batch, g)["total_loss"].item()
        for i in range(1, 31):
            dropout_generator(g, cfg.seed, i)
            last = train_step(st, batch, g)["total_loss"].item()
        assert np.isfinite(first) and np.isfinite(last)
        assert last < first * 0.8, (first, last)

    def test_npcs_mode(self):
        cfg, model, batch = tiny_setup(mixed=False)
        m = train_step(TrainState(model, cfg), batch,
                       torch.Generator().manual_seed(0))
        assert "total_gocs_loss" not in m
        assert np.isfinite(m["total_loss"].item())

    def test_eval_step_deterministic(self):
        cfg, model, batch = tiny_setup(batch=2, num_points=32)
        st = TrainState(model, cfg)
        p1, m1 = eval_step(st, batch)
        p2, m2 = eval_step(st, batch)
        assert torch.equal(p1["W"], p2["W"])
        assert m1["total_loss"].item() == m2["total_loss"].item()
        assert int(st.step) == 0

    def test_fit_and_checkpoint_resume(self, tmp_path):
        cfg, model, _ = tiny_setup(batch=4)
        cfg = cfg.replace(snapshot_interval=5)
        gen = SyntheticArticulated(n_parts=3, points_per_part=100, seed=0)
        samples = [gen.frame(np.random.RandomState(i), num_points=N)[0]
                   for i in range(8)]
        data = BatchIterator(8, lambda i: samples[i], batch_size=4, seed=0)
        tr = Trainer(model, cfg, work_dir=str(tmp_path), device="cpu")
        out = tr.fit(data, max_steps=5, log_every=1)
        assert np.isfinite(out["total_loss"]) and out["grads_finite"] == 1.0
        assert tr.ckpt.latest_step() == 5
        lines = (tmp_path / "log" / "train.jsonl").read_text().splitlines()
        assert [json.loads(ln)["step"] for ln in lines] == [1, 2, 3, 4, 5]

        _, model2, _ = tiny_setup(batch=4, seed=1)
        tr2 = Trainer(model2, cfg, work_dir=str(tmp_path), device="cpu")
        assert tr2.maybe_restore() == 5
        for a, b in zip(tr.state.state_dict()["model"].values(),
                        tr2.state.state_dict()["model"].values()):
            assert torch.equal(a, b)
        assert int(tr2.state.opt.count) == 5
        # it continues from the saved step
        tr2.fit(data, max_steps=7, log_every=1)
        assert int(tr2.state.step) == 7 and tr2.ckpt.latest_step() == 7

    @pytest.mark.parametrize("stop", [dict(max_steps=4),
                                      dict(n_epochs=2)])
    def test_fit_saves_each_step_once(self, tmp_path, stop):
        """A snapshot step that is also the last is saved once."""
        cfg, model, _ = tiny_setup(batch=4)
        cfg = cfg.replace(snapshot_interval=2)
        gen = SyntheticArticulated(n_parts=3, points_per_part=100, seed=0)
        samples = [gen.frame(np.random.RandomState(i), num_points=N)[0]
                   for i in range(8)]
        data = BatchIterator(8, lambda i: samples[i], batch_size=4, seed=0)
        tr = Trainer(model, cfg, work_dir=str(tmp_path), device="cpu")
        saved, save = [], tr.ckpt.save
        tr.ckpt.save = lambda step, state: (saved.append(step),
                                            save(step, state))
        tr.fit(data, **stop)
        assert saved == [2, 4] and tr.ckpt.latest_step() == 4

    def test_checkpointer_keeps_three(self, tmp_path):
        cfg, model, _ = tiny_setup(batch=2)
        st = TrainState(model, cfg)
        ck = Checkpointer(str(tmp_path / "model"))
        for step in (1, 2, 3, 4, 5):
            ck.save(step, st)
        assert sorted(p.name for p in (tmp_path / "model").iterdir()) == [
            "ckpt_3.pt", "ckpt_4.pt", "ckpt_5.pt"]
        assert ck.latest_step() == 5

    def test_validate_averages_over_frames(self, tmp_path):
        cfg, model, _ = tiny_setup(batch=4)
        gen = SyntheticArticulated(n_parts=3, points_per_part=100, seed=0)
        samples = [gen.frame(np.random.RandomState(i), num_points=N)[0]
                   for i in range(6)]
        data = BatchIterator(6, lambda i: samples[i], batch_size=4, seed=0,
                             shuffle=False, drop_last=False)
        tr = Trainer(model, cfg, work_dir=str(tmp_path), device="cpu")
        vm = tr.validate(data)
        # the two batches (4 and 2 frames) weighted by their sizes
        stack = lambda idx: {k: np.stack([samples[i][k] for i in idx])  # noqa
                             for k in samples[0]}
        _, a = eval_step(tr.state, stack(range(4)))
        _, b = eval_step(tr.state, stack(range(4, 6)))
        for k in a:
            np.testing.assert_allclose(
                vm[k], (4 * a[k].item() + 2 * b[k].item()) / 6, rtol=1e-6)
        # with save_predictions: the same metrics, and one h5 a frame in
        # the reference schema that reads back as the eval step's output
        from articulated_pose_tpu_torch.utils.prediction_io import \
            load_prediction

        vs = tr.validate(data, save_predictions=True)
        assert vs == vm
        out = tmp_path / "val_pred" / "step0"
        assert sorted(p.name for p in out.iterdir()) == [
            f"frame_{i}.h5" for i in range(6)]
        pred, _ = eval_step(tr.state, stack(range(4, 6)))
        got = load_prediction(str(out / "frame_5.h5"))
        np.testing.assert_array_equal(got["instance_per_point"],
                                      pred["W"][1].numpy())
        np.testing.assert_array_equal(got["nocs_per_point"],
                                      pred["nocs_per_point"][1].numpy())
        np.testing.assert_array_equal(got["P"], samples[5]["P"])
        np.testing.assert_array_equal(got["cls_gt"], samples[5]["cls_gt"])

    def test_predictor_serves_the_trainers_checkpoint(self, tmp_path):
        cfg = config.NetworkConfig(backbone_preset="tiny", batch_size=2,
                                   num_points=N, snapshot_interval=0,
                                   val_interval=0)
        model = build_model(cfg, torch.Generator().manual_seed(0))
        data = frames(4)
        it = BatchIterator(4, lambda i: {k: v[i] for k, v in data.items()},
                           batch_size=2, seed=0)
        with pytest.raises(FileNotFoundError):
            PosePredictor(cfg, work_dir=str(tmp_path), device="cpu")
        tr = Trainer(model, cfg, work_dir=str(tmp_path), device="cpu")
        tr.fit(it, max_steps=2)
        pred = PosePredictor(cfg, work_dir=str(tmp_path), device="cpu")
        want = tr.predict({k: v[:2] for k, v in data.items()})
        out = pred(data["P"][:2])
        np.testing.assert_array_equal(out.raw["W"], want["W"])
        assert out.R.shape == (2, 3, 3, 3) and np.isfinite(out.R).all()

    def test_trainer_needs_a_card_by_default(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg, model, _ = tiny_setup(batch=2)
        with pytest.raises(RuntimeError, match="not available"):
            Trainer(model, cfg, work_dir="unused")
