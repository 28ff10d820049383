"""A JAX training run carried into the port by
scripts/export_jax_checkpoint.py.

A JAX Trainer takes two steps of the tiny preset (`--backbone tiny`)
into tmp_path, snapshotting each; the script, run in process through
its `main(argv)`, restores the newest (or `--step`) Orbax snapshot and
writes the npz files the port reads.  `convert.load_flax_npz` gives the
port's model JAX's forward (atol 1e-4: tests/test_torch_models.py's
bound, only the CPU backends' matmul summation orders differ);
`convert.train_state_from_optax` gives a port TrainState equal leaf by
leaf to JAX's; and `PosePredictor(ckpt_path=...)` serves a `torch.save`
of the state_dict on the CPU.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from articulated_pose_tpu.config import load_config as jax_load_config
from articulated_pose_tpu.data.batcher import BatchIterator
from articulated_pose_tpu.data.synthetic import SyntheticArticulated
from articulated_pose_tpu.models.ancsh import build_model as jax_build_model
from articulated_pose_tpu.train.trainer import Trainer as JaxTrainer
from articulated_pose_tpu_torch.config import NetworkConfig
from articulated_pose_tpu_torch.convert import (load_flax_npz,
                                                state_dict_from_flax,
                                                train_state_from_optax)
from articulated_pose_tpu_torch.models.ancsh import build_model
from articulated_pose_tpu_torch.serving import PosePredictor
from articulated_pose_tpu_torch.train.state import TrainState

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, N = 4, 128
# the run's flags, as `main.py train` and the export script read them
RUN_FLAGS = ["--item", "eyeglasses", "--backbone", "tiny"]
CFG_KW = dict(category="eyeglasses", nocs_type="ancsh", n_max_parts=3,
              backbone_preset="tiny", num_points=N, batch_size=B,
              snapshot_interval=1, val_interval=0)


def export_script():
    spec = importlib.util.spec_from_file_location(
        "export_jax_checkpoint", ROOT / "scripts" / "export_jax_checkpoint.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A two-step JAX run and its exports: newest and --step 1."""
    work = tmp_path_factory.mktemp("jax_run")
    cfg = jax_load_config(None, **CFG_KW)
    model = jax_build_model(cfg)
    gen = SyntheticArticulated(n_parts=3, points_per_part=100, seed=0)
    frames = [gen.frame(np.random.RandomState(i), num_points=N)[0]
              for i in range(B)]
    data = BatchIterator(B, lambda i: frames[i], batch_size=B, seed=0)
    example = {k: np.stack([f[k] for f in frames]) for k in frames[0]}
    trainer = JaxTrainer(model, cfg, example_batch=example, work_dir=str(work))
    states = {}
    for step in (1, 2):
        trainer.fit(data, max_steps=step, log_every=1)
        states[step] = jax.device_get(trainer.state)
    script = export_script()
    out = {}
    for step, extra in ((2, []), (1, ["--step", "1"])):
        model_npz = str(work / f"model_{step}.npz")
        state_npz = str(work / f"state_{step}.npz")
        assert script.main(["--work_dir", str(work), "--out", model_npz,
                            "--train_state", state_npz, *RUN_FLAGS,
                            *extra]) == 0
        out[step] = (model_npz, state_npz)
    return dict(work=work, model=model, states=states, out=out, cfg=cfg)


def flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(tree), sep="/").items()}


def port_config(**kw):
    return NetworkConfig(**{**CFG_KW, **kw})


@pytest.mark.parametrize("step", [1, 2])
def test_export_writes_the_snapshot(run, step):
    model_npz, state_npz = run["out"][step]
    want = run["states"][step]
    with np.load(model_npz) as f:
        got = {k: f[k] for k in f.files}
    expect = {**flat({"params": want.params}),
              **flat({"batch_stats": want.batch_stats})}
    assert set(got) == set(expect)
    for k in expect:
        np.testing.assert_array_equal(got[k], expect[k], err_msg=k)
    with np.load(state_npz) as f:
        assert int(f["step"]) == step
        assert set(f.files) - set(got) == (
            {"count", "step"} | {f"mu/{k[len('params/'):]}" for k in got
                                 if k.startswith("params/")}
            | {f"nu/{k[len('params/'):]}" for k in got
               if k.startswith("params/")})


@pytest.mark.parametrize("step", [1, 2])
def test_loaded_forward_equals_jax(run, step):
    model_npz, _ = run["out"][step]
    state = run["states"][step]
    P = np.random.RandomState(5).rand(2, N, 3).astype(np.float32)
    want = jax.device_get(run["model"].apply(
        {"params": state.params, "batch_stats": state.batch_stats},
        jnp.asarray(P), train=False))
    model = build_model(port_config())
    model.load_state_dict(load_flax_npz(model_npz))
    with torch.no_grad():
        got = model(torch.from_numpy(P))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("step", [1, 2])
def test_train_state_equals_jax_leaf_by_leaf(run, step):
    _, state_npz = run["out"][step]
    want = run["states"][step]
    with np.load(state_npz) as f:
        sd = train_state_from_optax({k: f[k] for k in f.files})
    st = TrainState(build_model(port_config()), port_config())
    st.load_state_dict(sd)
    adam = want.opt_state.inner_state[0]
    for name, tree in (("model", {"params": want.params,
                                  "batch_stats": want.batch_stats}),
                       ("mu", {"params": adam.mu}),
                       ("nu", {"params": adam.nu})):
        expect = state_dict_from_flax(flat(tree))
        held = (st.model.state_dict() if name == "model"
                else dict(zip(st.names, getattr(st.opt, name))))
        assert set(held) == set(expect), name
        for k, v in expect.items():
            assert torch.equal(held[k], v), (name, k)
    assert int(st.opt.count) == int(adam.count) == step
    assert int(st.step) == int(want.step) == step


def test_predictor_serves_the_export_on_the_cpu(run, tmp_path):
    model_npz, _ = run["out"][2]
    path = tmp_path / "eyeglasses.pt"
    torch.save(load_flax_npz(model_npz), path)
    cfg = port_config(ransac_niter_part=16, ransac_niter_joint=8)
    pred = PosePredictor(cfg, ckpt_path=str(path), device="cpu")
    out = pred(np.random.RandomState(6).rand(B, N, 3).astype(np.float32))
    assert out.R.shape == (B, 3, 3, 3) and out.segmentation.shape == (B, N)
    assert all(np.isfinite(x).all() for x in (out.R, out.scale, out.t))


def test_no_snapshot_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no Orbax snapshot"):
        export_script().main(["--work_dir", str(tmp_path), "--out",
                              str(tmp_path / "m.npz"), *RUN_FLAGS])
