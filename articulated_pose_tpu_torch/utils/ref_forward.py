"""NumPy reference forward of the ANCSH graph, by TF variable names: a
copy of `articulated_pose_tpu/utils/ref_forward.py`.

An independent inference-mode implementation of the reference network
(reference: pointnet_plusplus/architectures.py:56-95
`build_pointnet2_shared`, pointnet_plusplus/utils/pointnet_util.py:29-236
SA/FP modules, lib/architecture.py:86-208 heads) that consumes a
checkpoint dict {tf_variable_name: array} directly: no name mapping, no
PyTorch.  The same weights run through this graph and through the port's
model (via utils/tf_ckpt.load_reference_weights) must produce the same
outputs; any head wiring, batch-norm semantics (fused inference with the
tf.contrib 1e-3 epsilon, tf_util.py:508), activation or stage-order
divergence shows up as an output mismatch.  It runs in float64 on the
host; the grouping indices come from ops/numpy_ref.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from articulated_pose_tpu_torch.ops import numpy_ref as O

BN_EPS = 1e-3  # tf.nn.batch_normalization epsilon in tf_util.py:508


def _conv(v: Dict[str, np.ndarray], scope: str, x: np.ndarray, *,
          bn: bool = True, relu: bool = True) -> np.ndarray:
    """tf_util.conv1d/conv2d as a pointwise matmul (+fused BN inference).

    x (..., Cin); kernels stored (1, Cin, Cout) or (1, 1, Cin, Cout).
    """
    W = np.asarray(v[scope + "/weights"])
    W = W.reshape(W.shape[-2], W.shape[-1])
    y = x @ W + np.asarray(v[scope + "/biases"])
    if bn:
        gamma = np.asarray(v[scope + "/bn/gamma"])
        beta = np.asarray(v[scope + "/bn/beta"])
        mean = np.asarray(v[scope + "/bn/moving_mean"])
        var = np.asarray(v[scope + "/bn/moving_variance"])
        y = gamma * (y - mean) / np.sqrt(var + BN_EPS) + beta
    if relu:
        y = np.maximum(y, 0.0)
    return y


def _sa_module(v, scope: str, xyz, points, *, npoint, radius, nsample, mlp,
               group_all: bool):
    """pointnet_sa_module (pointnet_util.py:94-161), max pooling."""
    if group_all:
        new_xyz = np.zeros((xyz.shape[0], 1, 3), xyz.dtype)
        grouped = xyz[:, None, :, :]
        if points is not None:
            grouped = np.concatenate([grouped, points[:, None]], axis=-1)
    else:
        fps_idx = O.farthest_point_sample(npoint, xyz)
        new_xyz = O.gather_point(xyz, fps_idx)
        idx, _ = O.query_ball_point(radius, nsample, xyz, new_xyz)
        grouped_xyz = O.group_point(xyz, idx) - new_xyz[:, :, None, :]
        if points is not None:
            grouped = np.concatenate(
                [grouped_xyz, O.group_point(points, idx)], axis=-1)
        else:
            grouped = grouped_xyz
    for i in range(len(mlp)):
        grouped = _conv(v, f"{scope}/conv{i}", grouped)
    return new_xyz, grouped.max(axis=2)


def _fp_module(v, scope: str, xyz1, xyz2, points1, points2, mlp):
    """pointnet_fp_module (pointnet_util.py:206-236)."""
    dist, idx = O.three_nn(xyz1, xyz2)
    dist = np.maximum(dist, 1e-10)
    w = (1.0 / dist)
    w = w / w.sum(axis=2, keepdims=True)
    interp = O.three_interpolate(points2, idx, w)
    x = (np.concatenate([interp, points1], axis=2)
         if points1 is not None else interp)
    for i in range(len(mlp)):
        x = _conv(v, f"{scope}/conv_{i}", x)
    return x


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _softmax(x):
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def reference_forward(variables: Dict[str, np.ndarray], P: np.ndarray, *,
                      n_max_parts: int = 3, mixed: bool = True,
                      early_split_nocs: bool = True,
                      scope: str = "SPFN") -> Dict[str, np.ndarray]:
    """Inference forward of get_per_point_model_new (lib/architecture.py
    :86-161) + joint_est_model (:195-208).  P (B, N, 3) float."""
    P = np.asarray(P, np.float64)
    est = f"{scope}/est_net"
    l0_xyz, l0_points = P, None

    l1_xyz, l1_points = _sa_module(v=variables, scope=f"{est}/layer1",
                                   xyz=l0_xyz, points=l0_points, npoint=512,
                                   radius=0.2, nsample=64, mlp=[64, 64, 128],
                                   group_all=False)
    l2_xyz, l2_points = _sa_module(v=variables, scope=f"{est}/layer2",
                                   xyz=l1_xyz, points=l1_points, npoint=128,
                                   radius=0.4, nsample=64,
                                   mlp=[128, 128, 256], group_all=False)
    l3_xyz, l3_points = _sa_module(v=variables, scope=f"{est}/layer3",
                                   xyz=l2_xyz, points=l2_points, npoint=None,
                                   radius=None, nsample=None,
                                   mlp=[256, 512, 1024], group_all=True)

    l2_points = _fp_module(variables, f"{est}/fa_layer1", l2_xyz, l3_xyz,
                           l2_points, l3_points, [256, 256])
    l1_points = _fp_module(variables, f"{est}/fa_layer2", l1_xyz, l2_xyz,
                           l1_points, l2_points, [256, 128])
    skip = (l0_xyz if l0_points is None
            else np.concatenate([l0_xyz, l0_points], axis=-1))
    l0_points = _fp_module(variables, f"{est}/fa_layer3", l0_xyz, l1_xyz,
                           skip, l1_points, [128, 128, 128])

    net = _conv(variables, f"{est}/fc1", l0_points)  # dropout: identity at inference

    K = n_max_parts
    out_dims = [K, 3 * K] + ([K, 3 * K] if mixed else []) + [1]
    heads = []
    for idx, d in enumerate(out_dims):
        x = net
        if early_split_nocs and idx == 1:
            x = _conv(variables, f"{scope}/nocs_net/fc11_{idx}", x,
                      bn=False, relu=False)
        heads.append(_conv(variables, f"{scope}/nocs_net/fc2_{idx}", x,
                           bn=False, relu=False))

    if mixed:
        w_l, nocs_l, scale_l, trans_l, confi_l = heads
        scale = _sigmoid(scale_l)
        trans = np.tanh(trans_l)
    else:
        w_l, nocs_l, confi_l = heads

    # joint head (lib/architecture.py:195-208)
    x = net
    for j in range(2):
        x = _conv(variables, f"{scope}/joint_net/fc3_{j}", x)
    joint_axis = np.tanh(_conv(variables, f"{scope}/joint_net/fc4_0", x,
                               bn=False, relu=False))
    unitvec = np.tanh(_conv(variables, f"{scope}/joint_net/fc4_1", x,
                            bn=False, relu=False))
    heatmap = _sigmoid(_conv(variables, f"{scope}/joint_net/fc4_2", x,
                             bn=False, relu=False))
    joint_cls = _softmax(_conv(variables, f"{scope}/joint_net/fc4_3", x,
                               bn=False, relu=False))

    pred = {
        "W": _softmax(w_l),
        "nocs_per_point": _sigmoid(nocs_l),
        "confi_per_point": _sigmoid(confi_l),
        "joint_axis_per_point": joint_axis,
        "unitvec_per_point": unitvec,
        "heatmap_per_point": heatmap,
        "index_per_point": joint_cls,
    }
    if mixed:
        # interleaved K -> 3K scale tiling (lib/architecture.py:155-158)
        scale_tiled = np.repeat(scale, 3, axis=-1)
        pred["gocs_per_point"] = pred["nocs_per_point"] * scale_tiled + trans
        pred["global_scale"] = scale
        pred["global_translation"] = trans
    return pred


def synth_reference_checkpoint(rng: Optional[np.random.RandomState] = None,
                               *, n_max_parts: int = 3, mixed: bool = True,
                               early_split_nocs: bool = True,
                               scope: str = "SPFN") -> Dict[str, np.ndarray]:
    """Deterministic synthetic checkpoint covering every reference scope
    the name map handles (utils/tf_ckpt._RULES) with the exact variable
    shapes of the reference graph: the fixture of the parity tests and of
    `chip_smoke.py`.
    """
    rng = rng or np.random.RandomState(0)
    v: Dict[str, np.ndarray] = {}

    def conv(scope_name, cin, cout, bn=True):
        v[scope_name + "/weights"] = rng.randn(1, 1, cin, cout).astype(
            np.float32) / np.sqrt(cin)
        v[scope_name + "/biases"] = 0.05 * rng.randn(cout).astype(np.float32)
        if bn:
            v[scope_name + "/bn/gamma"] = (
                1.0 + 0.1 * rng.randn(cout)).astype(np.float32)
            v[scope_name + "/bn/beta"] = 0.1 * rng.randn(cout).astype(np.float32)
            v[scope_name + "/bn/moving_mean"] = 0.2 * rng.randn(cout).astype(
                np.float32)
            v[scope_name + "/bn/moving_variance"] = (
                0.5 + rng.rand(cout)).astype(np.float32)

    est = f"{scope}/est_net"
    for i, (cin, cout) in enumerate([(3, 64), (64, 64), (64, 128)]):
        conv(f"{est}/layer1/conv{i}", cin, cout)
    for i, (cin, cout) in enumerate([(3 + 128, 128), (128, 128), (128, 256)]):
        conv(f"{est}/layer2/conv{i}", cin, cout)
    for i, (cin, cout) in enumerate([(3 + 256, 256), (256, 512), (512, 1024)]):
        conv(f"{est}/layer3/conv{i}", cin, cout)
    for i, (cin, cout) in enumerate([(256 + 1024, 256), (256, 256)]):
        conv(f"{est}/fa_layer1/conv_{i}", cin, cout)
    for i, (cin, cout) in enumerate([(128 + 256, 256), (256, 128)]):
        conv(f"{est}/fa_layer2/conv_{i}", cin, cout)
    for i, (cin, cout) in enumerate([(3 + 128, 128), (128, 128), (128, 128)]):
        conv(f"{est}/fa_layer3/conv_{i}", cin, cout)
    conv(f"{est}/fc1", 128, 128)

    K = n_max_parts
    out_dims = [K, 3 * K] + ([K, 3 * K] if mixed else []) + [1]
    for idx, d in enumerate(out_dims):
        cin = 128
        if early_split_nocs and idx == 1:
            conv(f"{scope}/nocs_net/fc11_{idx}", 128, 128, bn=False)
        conv(f"{scope}/nocs_net/fc2_{idx}", cin, d, bn=False)
    for j in range(2):
        conv(f"{scope}/joint_net/fc3_{j}", 128, 128)
    for j, d in enumerate([3, 3, 1, K]):
        conv(f"{scope}/joint_net/fc4_{j}", 128, d, bn=False)
    return v
