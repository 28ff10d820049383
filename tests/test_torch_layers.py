"""`models/layers.py::PointConv`'s batch norm folded into its Linear.

In eval mode a PointConv with a batch norm and no column shard folds the
norm's running statistics, scale and shift into its Linear on every
call.  These tests hold the folded layer to the unfolded formula (Linear
in the compute dtype, then the norm in f32, then the cast), training
mode and column-sharded layers to the unfolded path bit for bit, and
show that the fold follows the parameters from call to call and passes
gradients to them.  `ANCSHModel.folded_bn_layers` counts the layers
that fold in the model's current mode; the joint head's fc3_0 and fc3_1
never fold.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from articulated_pose_tpu_torch.config import NetworkConfig
from articulated_pose_tpu_torch.models.ancsh import build_model
from articulated_pose_tpu_torch.models.layers import PointConv
from articulated_pose_tpu_torch.parallel.collectives import ColumnShard

DTYPES = [torch.float32, torch.bfloat16]
# max |folded - unfolded| over max |unfolded|: f32 rounds the same sums in
# another order; bf16 rounds W' where the unfolded path rounds x @ W + b
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _conv(dtype, seed=0, cin=24, cout=40, relu=True):
    """A PointConv with non-trivial weights and batch-norm state."""
    g = torch.Generator().manual_seed(seed)
    conv = PointConv(cin, cout, relu=relu, dtype=dtype)
    with torch.no_grad():
        conv.dense.weight.uniform_(-0.4, 0.4, generator=g)
        conv.dense.bias.uniform_(-0.2, 0.2, generator=g)
        conv.bn.weight.uniform_(0.5, 1.5, generator=g)
        conv.bn.bias.uniform_(-0.3, 0.3, generator=g)
        conv.bn.running_mean.uniform_(-0.5, 0.5, generator=g)
        conv.bn.running_var.uniform_(0.3, 2.5, generator=g)
    return conv


def _x(seed=1, shape=(2, 50, 24)):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g) * 2 - 1


def _unfolded(conv, x):
    """The eval-mode layer with the norm apart: Linear in the compute
    dtype, (y - mean) * rsqrt(var + eps) * scale + shift in f32, cast to
    the output dtype, ReLU."""
    dt, bn = conv.dtype, conv.bn
    y = F.linear(x.to(dt), conv.dense.weight.to(dt), conv.dense.bias.to(dt))
    inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    y = ((y.float() - bn.running_mean) * inv + bn.bias).to(conv.out_dtype)
    return F.relu(y) if conv.relu else y


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("relu", [True, False])
def test_eval_fold_matches_the_unfolded_formula(dtype, relu):
    conv = _conv(dtype, relu=relu).eval()
    x = _x()
    with torch.no_grad():
        got = conv(x)
        want = _unfolded(conv, x)
    assert conv.folded
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    assert _rel(got, want) <= REL_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_training_mode_is_the_unfolded_path_bit_for_bit(dtype):
    """Training mode normalises with the batch's statistics and moves the
    running ones, exactly as the Linear followed by the norm does."""
    conv = _conv(dtype).train()
    twin = _conv(dtype).train()
    x = _x()
    m = torch.tensor(0.7)
    got = conv(x, m)
    dt = twin.dtype
    y = F.linear(x.to(dt), twin.dense.weight.to(dt), twin.dense.bias.to(dt))
    want = F.relu(twin.bn(y, m))
    assert not conv.folded
    assert torch.equal(got, want)
    assert torch.equal(conv.bn.running_mean, twin.bn.running_mean)
    assert torch.equal(conv.bn.running_var, twin.bn.running_var)
    assert not torch.equal(conv.bn.running_mean, _conv(dtype).bn.running_mean)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("leaf", ["bn.running_var", "dense.weight",
                                  "bn.running_mean", "bn.bias"])
def test_the_fold_follows_the_parameters(dtype, leaf):
    """Nothing folded is kept: an in-place change to a parameter or a
    statistic after one call changes the next call's output, which again
    matches the unfolded formula."""
    conv = _conv(dtype).eval()
    x = _x()
    with torch.no_grad():
        first = conv(x)
        t = dict(conv.named_parameters(), **dict(conv.named_buffers()))[leaf]
        t.mul_(1.7).add_(0.05)
        second = conv(x)
        want = _unfolded(conv, x)
    assert not torch.equal(first, second)
    assert _rel(second, want) <= REL_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_eval_gradients_reach_the_linear_and_the_norm(dtype):
    """In eval mode with grad on, the folded layer's gradients reach
    dense.weight, dense.bias, bn.weight and bn.bias; in f32 they match
    the unfolded formula's."""
    conv = _conv(dtype).eval()
    x = _x()
    conv(x).float().square().sum().backward()
    got = {n: p.grad.clone() for n, p in conv.named_parameters()}
    assert set(got) == {"dense.weight", "dense.bias", "bn.weight", "bn.bias"}
    for n, g in got.items():
        assert torch.isfinite(g).all() and g.abs().max() > 0, n
    conv.zero_grad()
    _unfolded(conv, x).float().square().sum().backward()
    tol = 1e-4 if dtype == torch.float32 else 6e-2
    for n, p in conv.named_parameters():
        assert _rel(got[n], p.grad) <= tol, n


def _served_config(**kw):
    return NetworkConfig(backbone_preset="reference", n_max_parts=3,
                         use_pallas=True, ball_query_packed=True, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_served_network_folds_17_norms_in_eval_and_none_in_training(
        dtype):
    """The reference PointNet++ network folds SA1 3, SA2 3, the global
    SA 3, FP 2 + 2 + 3 and fc1; the joint head's fc3_0 and fc3_1 keep
    their norms apart."""
    model = build_model(_served_config(compute_dtype=dtype),
                        torch.Generator().manual_seed(0)).train()
    assert model.folded_bn_layers == 0
    model.eval()
    assert model.folded_bn_layers == 17
    folded = sorted(n for n, m in model.named_modules()
                    if isinstance(m, PointConv) and m.folded)
    assert not [n for n in folded if n.startswith("joint_net")]
    assert "backbone.fc1" in folded
    with torch.no_grad():
        model(_x(2, (1, 64, 3)).abs())
    assert model.folded_bn_layers == 17
    model.train()
    model(_x(3, (2, 64, 3)).abs(), bn_momentum=0.9,
          generator=torch.Generator().manual_seed(1))
    assert model.folded_bn_layers == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_joint_heads_norms_stay_apart_in_eval(dtype):
    """In eval mode the joint head's fc3_0 and fc3_1 run the Linear, then
    the norm, bit for bit the unfolded path, whatever the backbone."""
    model = build_model(_served_config(
        compute_dtype="float32" if dtype == torch.float32 else "bfloat16"),
        torch.Generator().manual_seed(0)).eval()
    for conv in (model.joint_net.fc3_0, model.joint_net.fc3_1):
        assert conv.bn is not None and not conv.fold_bn and not conv.folded
        with torch.no_grad():
            conv.bn.running_mean.uniform_(-0.5, 0.5)
            conv.bn.running_var.uniform_(0.3, 2.5)
            x = _x(7, (2, 50, conv.dense.in_features))
            got = conv(x)
            dt = conv.dtype
            y = F.linear(x.to(dt), conv.dense.weight.to(dt),
                         conv.dense.bias.to(dt))
            want = F.relu(conv.bn(y))
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_point_transformer_folds_nothing(dtype):
    """The Point Transformer's backbone norms are not PointConvs, and its
    joint head's fc3_0 and fc3_1 keep theirs apart (fold_bn=False)."""
    from articulated_pose_tpu_torch.models import point_transformer as pt

    spec = pt.PointTransformerSpec(planes=(16, 16, 32), blocks=(1, 2, 1),
                                   nsample=(8, 16, 16), stride=4, share=8)
    model = build_model(NetworkConfig(backbone="point_transformer",
                                      n_max_parts=3, compute_dtype=dtype),
                        torch.Generator().manual_seed(0), spec=spec)
    with torch.no_grad():
        model(_x(2, (1, 256, 3)).abs())
    assert model.folded_bn_layers == 0
    head = model.joint_net
    assert not head.fc3_0.fold_bn and not head.fc3_1.fold_bn
    assert not head.fc3_0.folded and not head.fc3_1.folded


@pytest.mark.parametrize("dtype", DTYPES)
def test_eval_forward_of_the_served_network_matches_the_unfolded_one(dtype):
    """The whole reference network in eval mode, with non-trivial
    batch-norm state, against the same network with every PointConv
    forced to run its norm apart: every head within 1e-4 (f32) or 2e-2
    (bf16; heads bounded to [-1, 1]) of the unfolded network's."""
    cfg = _served_config(compute_dtype="float32" if dtype == torch.float32
                         else "bfloat16")
    model = build_model(cfg, torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, PointConv) and m.bn is not None:
                m.bn.weight.uniform_(0.5, 1.5, generator=g)
                m.bn.bias.uniform_(-0.2, 0.2, generator=g)
                m.bn.running_mean.uniform_(-0.2, 0.2, generator=g)
                m.bn.running_var.uniform_(0.5, 2.0, generator=g)
    x = _x(6, (2, 128, 3)).abs()
    with torch.no_grad():
        got = model(x)
        convs = [m for m in model.modules() if isinstance(m, PointConv)]
        plain = {}
        for m in convs:
            plain[m] = m.forward
            m.forward = (lambda x, bn_momentum=0.9, m=m: _unfolded(m, x)
                         if m.bn is not None else plain[m](x, bn_momentum))
        try:
            want = model(x)
        finally:
            for m in convs:
                del m.forward
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=atol, err_msg=k)


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo world of one rank in this process (a file rendezvous), for
    a real ColumnShard; torn down after the test."""
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
    yield dist.group.WORLD
    if made:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_column_sharded_layer_is_not_folded(dtype, world_of_one):
    """With `columns` set, the eval-mode layer runs the sharded Linear and
    then the norm, bit for bit the unfolded path."""
    conv = _conv(dtype).eval()
    conv.columns = ColumnShard(world_of_one, 0, 1)
    x = _x()
    with torch.no_grad():
        got = conv(x)
        dt = conv.dtype
        y = conv.columns.linear(x.to(dt), conv.dense.weight.to(dt),
                                conv.dense.bias.to(dt))
        want = F.relu(conv.bn(y))
    assert not conv.folded
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_layer_without_a_norm_is_unchanged(dtype):
    conv = PointConv(24, 7, use_bn=False, relu=False, dtype=dtype).eval()
    x = _x()
    with torch.no_grad():
        got = conv(x)
        want = F.linear(x.to(dtype), conv.dense.weight.to(dtype),
                        conv.dense.bias.to(dtype))
    assert not conv.folded
    assert torch.equal(got, want)
