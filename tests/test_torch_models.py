"""The port's ANCSH model against the Flax model on the same weights.

Weights are seeded random values on the Flax model's own variable tree,
every leaf random (so the weight bridge is exercised on each one),
carried into the port by `convert.state_dict_from_flax`.
Both packages run on the CPU: the JAX model through its XLA ops, the
port through the kernels' plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from articulated_pose_tpu.config import NetworkConfig as JaxConfig
from articulated_pose_tpu.models.ancsh import build_model as jax_build_model
from articulated_pose_tpu_torch.config import NetworkConfig
from articulated_pose_tpu_torch.convert import (load_flax_npz,
                                                state_dict_from_flax)
from articulated_pose_tpu_torch.models.ancsh import build_model

N_POINTS = 256


def flax_variables(cfg_kw, seed=0, model=None, channels=3):
    """Random variables of the tiny-preset Flax model (or of `model`, on
    clouds of `channels` channels), flattened to "/"-joined keys: the
    tree comes from Flax (`eval_shape` of its init), the values from
    numpy: Xavier-uniform kernels, random biases and batch-norm
    scales/statistics."""
    if model is None:
        model = jax_build_model(JaxConfig(backbone_preset="tiny", **cfg_kw))
    x = jax.ShapeDtypeStruct((1, N_POINTS, channels), jnp.float32)
    shapes = jax.eval_shape(lambda p: model.init(jax.random.PRNGKey(0), p,
                                                 train=False), x)
    rng = np.random.RandomState(seed)
    flat = {}
    for k, v in traverse_util.flatten_dict(shapes, sep="/").items():
        if k.endswith("/kernel"):
            b = np.sqrt(6.0 / sum(v.shape))
            arr = rng.uniform(-b, b, v.shape)
        elif k.endswith("/var"):
            arr = rng.uniform(0.5, 2.0, v.shape)
        elif k.endswith("/scale"):
            arr = rng.uniform(0.5, 1.5, v.shape)
        else:                                   # biases and BN means
            arr = rng.uniform(-0.2, 0.2, v.shape)
        flat[k] = arr.astype(np.float32)
    return flat


def unflatten(flat):
    return traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def run_both(cfg_kw, dtype="float32", seed=0):
    flat = flax_variables(cfg_kw, seed)
    jmodel = jax_build_model(JaxConfig(backbone_preset="tiny",
                                       compute_dtype=dtype, **cfg_kw))
    P = np.random.RandomState(seed + 1).rand(2, N_POINTS, 3).astype(np.float32)
    want = jax.device_get(jmodel.apply(unflatten(flat), jnp.asarray(P),
                                       train=False))
    model = build_model(NetworkConfig(backbone_preset="tiny",
                                      compute_dtype=dtype, **cfg_kw))
    model.load_state_dict(state_dict_from_flax(flat))
    with torch.no_grad():
        got = model(torch.from_numpy(P))
    return {k: v.numpy() for k, v in got.items()}, want


class TestWeightBridge:
    def test_round_trip(self, tmp_path):
        flat = flax_variables({})
        sd = state_dict_from_flax(flat)
        model = build_model(NetworkConfig(backbone_preset="tiny"))
        # every port parameter and buffer is covered, and nothing else
        assert set(sd) == set(model.state_dict())
        model.load_state_dict(sd)
        back = {}
        for name, t in model.state_dict().items():
            path, leaf = name.rsplit(".", 2)[0], ".".join(name.rsplit(".", 2)[1:])
            col, fl = {"dense.weight": ("params", "dense/kernel"),
                       "dense.bias": ("params", "dense/bias"),
                       "bn.weight": ("params", "bn/scale"),
                       "bn.bias": ("params", "bn/bias"),
                       "bn.running_mean": ("batch_stats", "bn/mean"),
                       "bn.running_var": ("batch_stats", "bn/var")}[leaf]
            arr = t.numpy().T if leaf == "dense.weight" else t.numpy()
            back[f"{col}/{path.replace('.', '/')}/{fl}"] = arr
        assert set(back) == set(flat)
        for k in flat:
            np.testing.assert_array_equal(back[k], flat[k])
        # the npz route a JAX-free host uses
        np.savez(tmp_path / "w.npz", **flat)
        for k, v in load_flax_npz(str(tmp_path / "w.npz")).items():
            assert torch.equal(v, sd[k])

    def test_unknown_variable_raises(self):
        with pytest.raises(KeyError, match="unexpected"):
            state_dict_from_flax({"params/x/dense/other": np.zeros(2)})


class TestForwardParity:
    @pytest.mark.parametrize("cfg_kw", [
        {},                                                  # ANCSH, K=3
        {"n_max_parts": 2, "nocs_type": "npcs", "pred_joint": False},
        {"n_max_parts": 4, "early_split_nocs": False},
    ])
    def test_f32_every_output(self, cfg_kw):
        got, want = run_both(cfg_kw)
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            # same weights, same neighbourhoods: only matmul summation
            # order differs between the two CPU backends
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                       err_msg=k)

    def test_bf16_trunk(self):
        got, want = run_both({}, dtype="bfloat16")
        for k in want:
            assert got[k].dtype == np.float32 and np.isfinite(got[k]).all()
            # bf16 keeps 8 mantissa bits and the two frameworks round at
            # different places (bias add, interpolation sums): 2e-2 on
            # outputs bounded to [-1, 1] / [0, 1]
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-2,
                                       err_msg=k)
