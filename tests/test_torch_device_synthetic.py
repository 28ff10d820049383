"""The port's on-device synthetic generator against the JAX package's, on
the CPU.

`DeviceSynthetic.frames(draws)` must give what JAX's `_frame` gives under
`jax.vmap` for draws rebuilt from JAX's own keys (split as `_frame` and
`_camera` split them, the permutation's first N entries as `sel`): every
gathered label equal (float64 NumPy constants cast once), P and the GT
poses within 1e-5 (f32 sin, cos and sums round apart).  Then JAX's own
invariants (tests/test_device_synthetic.py) on the port's draws, and the
fused train step at a tiny width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from articulated_pose_tpu.data.device_synthetic import \
    DeviceSynthetic as JaxDeviceSynthetic
from articulated_pose_tpu.data.synthetic import \
    SyntheticArticulated as JaxSynthetic
from articulated_pose_tpu_torch.config import NetworkConfig
from articulated_pose_tpu_torch.data import device_synthetic as ds
from articulated_pose_tpu_torch.data.synthetic import SyntheticArticulated
from articulated_pose_tpu_torch.models.ancsh import build_model
from articulated_pose_tpu_torch.models.pointnet2 import BackboneSpec
from articulated_pose_tpu_torch.train.state import TrainState

TOL = 1e-5
TINY = BackboneSpec(sa_npoints=(32, 16), sa_radii=(0.25, 0.5),
                    sa_nsamples=(8, 8), sa_mlps=((16,), (16,)),
                    global_mlp=(32,), fp_mlps=((16,), (16,), (16,)),
                    head_width=16)

# (generator kwargs, num_points, noise): revolute, a 2-part cloud shorter
# than num_points (tiled), prismatic, full_rotation
CASES = {
    "revolute": (dict(n_parts=3, points_per_part=200, seed=0,
                      full_rotation=False), 256, 0.005),
    "tiled": (dict(n_parts=2, points_per_part=100, seed=1,
                   full_rotation=False), 256, 0.005),
    "prismatic": (dict(n_parts=4, points_per_part=80, seed=3,
                       joint_types=["prismatic"] * 3,
                       full_rotation=False), 256, 0.0),
    "full_rotation": (dict(n_parts=3, points_per_part=150, seed=2,
                           joint_types=["revolute", "prismatic"],
                           full_rotation=True), 256, 0.01),
}


def jax_draws(jd, keys, N: int) -> ds.SynthDraws:
    """The draws `_frame` makes from each of `keys`, as SynthDraws."""
    st, s, rot, t, noise, sel = [], [], [], [], [], []
    for k in keys:
        kstate, kcam, knoise, kperm = jax.random.split(k, 4)
        st.append(jax.random.uniform(kstate, (max(jd.n_joints, 1),),
                                     minval=-1.2, maxval=1.2))
        ks, kr, kt = jax.random.split(kcam, 3)
        s.append(jax.random.uniform(ks, (), minval=0.8, maxval=1.2))
        if jd.full_rotation:
            rot.append(jax.random.normal(kr, (4,)))
        else:
            ky, kp = jax.random.split(kr)
            rot.append(jnp.stack([
                jax.random.uniform(ky, (), minval=0.0, maxval=2 * jnp.pi),
                jax.random.uniform(kp, (), minval=jnp.radians(-75.0),
                                   maxval=jnp.radians(-15.0))]))
        t.append(jax.random.uniform(kt, (3,), minval=-0.5, maxval=0.5))
        noise.append(jax.random.normal(knoise, (jd.n_total, 3)))
        sel.append(jax.random.permutation(kperm, jd.n_total)[:N])

    def tensor(xs):
        return torch.from_numpy(np.array(jnp.stack(xs)))

    return ds.SynthDraws(states=tensor(st), s=tensor(s), rot=tensor(rot),
                         t=tensor(t),
                         noise=tensor(noise) if jd.noise > 0 else None,
                         sel=tensor(sel).long())


def make_pair(case):
    kw, N, noise = CASES[case]
    got = ds.DeviceSynthetic(SyntheticArticulated(**kw), num_points=N,
                             noise=noise, device="cpu")
    want = JaxDeviceSynthetic(JaxSynthetic(**kw), num_points=N, noise=noise)
    return got, want


@pytest.mark.parametrize("case", sorted(CASES))
def test_frames_match_jax(case):
    dg, jd = make_pair(case)
    assert dg.n_total == jd.n_total
    keys = jax.random.split(jax.random.PRNGKey(7), 4)
    got, got_gt = dg.frames(jax_draws(jd, keys, dg.num_points))
    want, want_gt = jax.device_get(jax.vmap(jd._frame)(keys))
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k == "P":
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    for k in ("R", "s", "t"):
        np.testing.assert_allclose(got_gt[k].numpy(), np.asarray(want_gt[k]),
                                   rtol=0, atol=TOL, err_msg=k)


def test_tiled_cloud_selects_from_every_copy():
    dg, _ = make_pair("tiled")
    assert dg.n_total == 400 and dg.n_total > dg.num_points
    draws = dg.draw(torch.Generator().manual_seed(0), 3)
    assert draws.sel.dtype == torch.int64
    assert draws.sel.shape == (3, dg.num_points)
    for row in draws.sel:
        assert len(torch.unique(row)) == dg.num_points        # distinct
        assert (row >= 200).any() and (row < 200).any()       # both copies


@pytest.fixture(scope="module")
def dev_gen():
    gen = SyntheticArticulated(n_parts=3, points_per_part=200, seed=0,
                               full_rotation=False)
    return gen, ds.DeviceSynthetic(gen, num_points=256, noise=0.0,
                                   device="cpu")


class TestDeviceSynthetic:
    """tests/test_device_synthetic.py's invariants, on the port."""

    def test_batch_shapes(self, dev_gen):
        _, dg = dev_gen
        batch, gt = dg.sample_batch(torch.Generator().manual_seed(0), 4)
        assert batch["P"].shape == (4, 256, 3)
        assert batch["nocs_gt"].shape == (4, 256, 3)
        assert batch["mask_array"].shape == (4, 256, 3)
        assert batch["joint_params_gt"].shape == (4, 3, 7)
        assert gt["R"].shape == (4, 3, 3, 3)
        assert torch.isfinite(batch["P"]).all()

    def test_gt_pose_invariant(self, dev_gen):
        """P == s_j R_j nocs_j + t_j for every part, noiselessly."""
        _, dg = dev_gen
        batch, gt = dg.sample_batch(torch.Generator().manual_seed(1), 3)
        batch = {k: v.numpy() for k, v in batch.items()}
        gt = {k: v.numpy() for k, v in gt.items()}
        for i in range(3):
            cls = batch["cls_gt"][i].astype(int)
            for j in range(3):
                sel = cls == j
                assert sel.sum() > 5
                fitted = (gt["s"][i, j] * batch["nocs_gt"][i][sel]
                          @ gt["R"][i, j].T + gt["t"][i, j])
                np.testing.assert_allclose(fitted, batch["P"][i][sel],
                                           atol=2e-4)

    def test_label_ranges_match_host_generator(self, dev_gen):
        gen, dg = dev_gen
        batch, _ = dg.sample_batch(torch.Generator().manual_seed(2), 2)
        batch = {k: v.numpy() for k, v in batch.items()}
        hm = batch["heatmap_gt"]
        assert ((hm >= 0) & (hm <= 1)).all()
        assoc = batch["joint_cls_mask"] > 0
        assert assoc.sum() > 0
        norms = np.linalg.norm(batch["unitvec_gt"][assoc], axis=-1)
        np.testing.assert_allclose(norms, 1.0, atol=1e-3)
        np.testing.assert_array_equal(
            np.argmax(batch["mask_array"], -1), batch["cls_gt"].astype(int))
        # static joint params equal the host generator's
        host_sample, _ = gen.frame(np.random.RandomState(0), num_points=256)
        np.testing.assert_allclose(batch["joint_params_gt"][0],
                                   host_sample["joint_params_gt"], atol=1e-5)

    def test_rotations_are_orthonormal(self, dev_gen):
        _, dg = dev_gen
        _, gt = dg.sample_batch(torch.Generator().manual_seed(3), 2)
        R = gt["R"].numpy().reshape(-1, 3, 3)
        np.testing.assert_allclose(R @ np.transpose(R, (0, 2, 1)),
                                   np.broadcast_to(np.eye(3), R.shape),
                                   atol=1e-5)

    def test_draw_ranges(self, dev_gen):
        _, dg = dev_gen
        d = dg.draw(torch.Generator().manual_seed(4), 64)
        assert d.noise is None                      # noise 0: no draw
        assert ((d.states >= -1.2) & (d.states <= 1.2)).all()
        assert ((d.s >= 0.8) & (d.s <= 1.2)).all()
        yaw, pitch = d.rot.unbind(-1)
        assert ((yaw >= 0) & (yaw < 2 * np.pi)).all()
        lo, hi = ds.PITCH_RANGE
        assert ((pitch >= lo - 1e-6) & (pitch <= hi + 1e-6)).all()
        assert ((d.t >= -0.5) & (d.t <= 0.5)).all()

    def test_needs_a_card_by_default(self, dev_gen, monkeypatch):
        gen, _ = dev_gen
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="not available"):
            ds.DeviceSynthetic(gen, num_points=256)


class TestFusedStep:
    @pytest.fixture
    def setup(self, dev_gen):
        _, dg = dev_gen
        cfg = NetworkConfig(n_max_parts=3, num_points=256, batch_size=2,
                            decay_step=10**9, bn_decay_step=10**9)
        model = build_model(cfg, torch.Generator().manual_seed(0),
                            device="cpu", spec=TINY)
        return cfg, dg, TrainState(model, cfg)

    def test_two_calls_advance_step_by_two(self, setup):
        cfg, dg, state = setup
        step = ds.make_fused_synthetic_train_step(cfg, dg, 2)
        m1 = step(state, 0)
        m2 = step(state, 1)
        assert int(state.step) == 2
        assert int(state.opt.count) == 2
        for m in (m1, m2):
            assert bool(m["grads_finite"])
            assert np.isfinite(float(m["total_loss"]))

    def test_window_runs_steps_per_call(self, setup):
        cfg, dg, state = setup
        step = ds.make_fused_synthetic_train_step(cfg, dg, 2,
                                                  steps_per_call=3)
        step(state, 0)
        assert int(state.step) == 3

    def test_reseeding_reproduces_the_batch(self, setup):
        """A step's batch is a function of (seed, step): what a resumed run
        draws at step s is what an uninterrupted one drew there."""
        cfg, dg, state = setup
        seen = []
        orig = ds.train_step

        def spy(st, batch, generator=None):
            seen.append({k: v.clone() for k, v in batch.items()})
            return orig(st, batch, generator)

        ds.train_step = spy
        try:
            step = ds.make_fused_synthetic_train_step(cfg, dg, 2, seed=5)
            step(state, 0)
            step(state, 1)
            step(state, 1)            # step 1 again, as after a resume
        finally:
            ds.train_step = orig
        gen = torch.Generator()
        for i, s in enumerate((0, 1, 1)):
            gen.manual_seed(ds.data_seed(5, s))
            want, _ = dg.sample_batch(gen, 2)
            for k in want:
                assert torch.equal(seen[i][k], want[k]), (s, k)
        assert not torch.equal(seen[0]["P"], seen[1]["P"])
        assert ds.data_seed(5, 1) != ds.data_seed(6, 1)
