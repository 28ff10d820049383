"""The train-step stage profiler (`profile_train_stages.py`) against
scripts/profile_train_stages.py and the JAX package's loss, on the CPU.

- The five stages, their labels and their order are the JAX script's
  (read from its source).
- `fwd+loss (no grad)` reads JAX's `_forward_loss`
  (articulated_pose_tpu/train/state.py:64) on a converted state and the
  same batch: rtol 1e-5, tests/test_torch_train.py's bound for one
  step's loss (tiny preset, B=4, N=64, dropout off in both).
- `grad+update (fixed batch)` called n times equals n calls of
  `train_step` with the trainer's dropout generators; `fused step`
  called n times equals `make_fused_synthetic_train_step` for steps 0 to
  n - 1; `data gen` draws what `DeviceSynthetic.sample_batch` draws from
  the same seeds.  Bit for bit.
- On the CPU the device columns are None.
"""

import copy
import pathlib
import re

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from articulated_pose_tpu import config as jconfig
from articulated_pose_tpu.models.ancsh import build_model as jax_build_model
from articulated_pose_tpu.train import state as jstate
from articulated_pose_tpu_torch import profile_train_stages as pts
from articulated_pose_tpu_torch import programs
from articulated_pose_tpu_torch.data.device_synthetic import (
    data_seed, make_fused_synthetic_train_step)
from articulated_pose_tpu_torch.models.pointnet2 import (TINY_WIDTHS,
                                                         BackboneSpec)
from articulated_pose_tpu_torch.train.state import (dropout_generator,
                                                    to_device, train_step)
from test_torch_train import CFG_KW, B, frames, no_dropout, port_state

SCRIPT = pathlib.Path(__file__).resolve().parents[1] / "scripts" / \
    "profile_train_stages.py"
TINY = BackboneSpec(**TINY_WIDTHS)
CPU = torch.device("cpu")


def jax_script_labels():
    """The JAX script's stage labels in the order it reports them: the
    `report("...")` calls and the names of its (name, fn) list."""
    src = SCRIPT.read_text()
    found = [(m.start(), m.group(1)) for m in
             re.finditer(r'report\("([^"]+)"', src)]
    found += [(m.start(), m.group(1)) for m in
              re.finditer(r'\("([^"]+)",\s*lambda', src)]
    return [label for _, label in sorted(found)]


def test_stages_labels_and_order_are_the_jax_scripts():
    assert list(pts.STAGES) == jax_script_labels()
    assert len(pts.STAGES) == 5


def test_fwd_loss_reads_jax_forward_loss():
    cfg = jconfig.NetworkConfig(**CFG_KW)
    model = jax_build_model(cfg)
    batch = frames(B)
    jstate0 = jstate.create_train_state(model, cfg, jax.random.PRNGKey(0),
                                        batch["P"])
    with fnn.intercept_methods(no_dropout):
        total, _ = jstate._forward_loss(
            jstate0.params, jstate0.batch_stats, jstate0.apply_fn, batch,
            cfg, train=True, rng=jax.random.PRNGKey(0), step=0)
    state = port_state(jstate0)
    fns = pts.stage_fns(state, to_device(batch, CPU))
    got = fns["fwd+loss (no grad)"]()
    assert not got.requires_grad
    np.testing.assert_allclose(got.item(), float(total), rtol=1e-5)


@pytest.fixture
def setup():
    """Two equal f32 train states at tiny widths, a batch and the
    generator of the e2e recipe, all on the CPU."""
    state, batch, dg = programs.train_setup(2, 128, CPU, TINY)
    return state, copy.deepcopy(state), batch, dg


def _equal_states(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    for key in ("model", "mu", "nu"):
        for k in sa[key]:
            assert torch.equal(sa[key][k], sb[key][k]), (key, k)
    assert torch.equal(sa["count"], sb["count"])
    assert torch.equal(sa["step"], sb["step"])


def test_grad_update_is_n_train_steps(setup):
    state, twin, batch, dg = setup
    fn = pts.stage_fns(state, batch, dg)["grad+update (fixed batch)"]
    n = 3
    for _ in range(n):
        fn()
    drop = torch.Generator()
    for i in range(n):
        train_step(twin, batch, dropout_generator(drop, twin.config.seed, i))
    _equal_states(state, twin)
    assert int(state.step) == n


def test_fused_step_is_make_fused_synthetic_train_step(setup):
    state, twin, batch, dg = setup
    fn = pts.stage_fns(state, batch, dg)["fused step (e2e program)"]
    fused = make_fused_synthetic_train_step(twin.config, dg, 2)
    for i in range(2):
        fn()
        fused(twin, i)
    _equal_states(state, twin)


def test_data_gen_draws_the_generators_batches(setup):
    state, _, batch, dg = setup
    fn = pts.stage_fns(state, batch, dg)["data gen"]
    for i in range(2):
        got, _ = fn()
        want, _ = dg.sample_batch(torch.Generator().manual_seed(
            data_seed(pts.DATA_SEED, i)), 2)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_without_a_generator_the_fixed_batch_stages_only(setup):
    state, _, batch, _ = setup
    assert list(pts.stage_fns(state, batch)) == list(pts.STAGES[1:4])


def test_cpu_run_leaves_the_device_columns_empty(capsys):
    rows = pts.run(batch=2, points=128, iters=1, device="cpu", spec=TINY)
    assert [r["stage"] for r in rows] == list(pts.STAGES)
    for r in rows:
        assert r["device_ms"] is None and r["device_ops"] is None
        assert r["idle_share"] is None and r["wall_ms"] > 0
    assert "not measured" in capsys.readouterr().out


def test_without_a_card_it_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="profile_train_stages: device "
                       "cuda is not available"):
        pts.main([])
