"""The port's serving slice against the JAX package's, on the CPU.

The whole served path (ANCSH forward + pose fit) runs in both packages
on the same weights and the same RANSAC draws; the config and category
registry are held against the JAX ones.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from articulated_pose_tpu import config as jconfig
from articulated_pose_tpu import registry as jregistry
from articulated_pose_tpu.data.synthetic import SyntheticArticulated
from articulated_pose_tpu.pose.pipeline import PoseFitConfig as JaxPoseFitConfig
from articulated_pose_tpu.serving import PosePredictor as JaxPosePredictor
from articulated_pose_tpu_torch import config, registry
from articulated_pose_tpu_torch.convert import state_dict_from_flax
from articulated_pose_tpu_torch.serving import PosePredictor, serve_clouds
from test_torch_models import flax_variables, unflatten
from test_torch_pose import jax_draws, port_cfg

N_POINTS = 128
CATEGORY = "laptop"                        # K=2, one revolute joint


def tiny_setup(batch_size=2):
    kw = dict(category=CATEGORY, n_max_parts=2, num_points=N_POINTS,
              batch_size=batch_size, backbone_preset="tiny", seed=3)
    jcfg = JaxPoseFitConfig(n_parts=2, niter_part=32, niter_joint=8,
                            lm_iters_hypo=4, lm_iters_refit=4,
                            ransac_chunk=None, joint_types=("revolute",))
    flat = flax_variables({"n_max_parts": 2})
    return kw, jcfg, flat


def clouds(n, seed=0):
    gen = SyntheticArticulated(n_parts=2, points_per_part=100, seed=seed)
    batch, _ = gen.batch(np.random.RandomState(seed), n,
                         num_points=N_POINTS)
    return batch["P"].astype(np.float32)


class TestServedSlice:
    def test_port_predictor_matches_jax_predictor(self):
        kw, jcfg, flat = tiny_setup()
        variables = unflatten(flat)
        jpred = JaxPosePredictor(jconfig.NetworkConfig(**kw),
                                 params=variables["params"],
                                 batch_stats=variables["batch_stats"],
                                 pose_cfg=jcfg)
        cfg = config.NetworkConfig(**kw)
        pcfg = port_cfg(jcfg)
        pred = PosePredictor(cfg, state_dict=state_dict_from_flax(flat),
                             pose_cfg=pcfg, device="cpu")
        P = clouds(2)
        want = jpred(P)
        got = pred(P, draws=jax_draws(jax.random.PRNGKey(cfg.seed), 2, pcfg))
        for k in want.raw:
            np.testing.assert_allclose(got.raw[k], want.raw[k], rtol=0,
                                       atol=1e-4, err_msg=k)
        np.testing.assert_array_equal(got.segmentation, want.segmentation)
        np.testing.assert_array_equal(got.part_counts, want.part_counts)
        # the pose stage's own parity tolerances; random weights give
        # poses far from unit scale (|t| ~ 40), so t is bounded relatively
        np.testing.assert_allclose(got.R, want.R, rtol=0, atol=1e-3)
        np.testing.assert_allclose(got.scale, want.scale, rtol=1e-4)
        np.testing.assert_allclose(got.t, want.t, rtol=1e-4, atol=1e-4)

    def test_serve_clouds_pads_and_trims(self):
        kw, jcfg, flat = tiny_setup()
        pred = PosePredictor(config.NetworkConfig(**kw),
                             state_dict=state_dict_from_flax(flat),
                             pose_cfg=port_cfg(jcfg), device="cpu")
        P = clouds(5, seed=1)
        out = serve_clouds(pred, P, batch_size=2)
        assert out["R"].shape == (5, 2, 3, 3)
        assert out["s"].shape == (5, 2) and out["t"].shape == (5, 2, 3)
        assert out["seg"].shape == (5, N_POINTS)
        assert (out["part_counts"].sum(-1) == N_POINTS).all()
        # the padded last batch repeats its last cloud; the answer for
        # that cloud is what a full batch of it gives
        last = pred(np.stack([P[4], P[4]]))
        np.testing.assert_array_equal(out["R"][4], last.R[0])
        np.testing.assert_array_equal(out["seg"][4], last.segmentation[0])
        first = pred(P[:2])
        np.testing.assert_array_equal(out["R"][:2], first.R)
        # draws are reseeded on every call: the same cloud, the same poses
        np.testing.assert_array_equal(pred(P[:2]).R, first.R)
        with pytest.raises(ValueError, match="clouds"):
            serve_clouds(pred, P[:0], batch_size=2)

    def test_serve_clouds_drops_each_batch_before_the_next(self):
        """serve_clouds copies a batch's answers out and lets its result
        go before the next call, so a stream never holds more than one
        result's host memory; its answers are the results' rows."""
        import weakref

        from articulated_pose_tpu_torch.serving import PoseResult

        alive, results = [], []
        rng = np.random.default_rng(0)

        def predictor(chunk):
            assert not any(ref() is not None for ref in alive)
            B = len(chunk)
            res = PoseResult(
                R=rng.random((B, 2, 3, 3)), scale=rng.random((B, 2)),
                t=rng.random((B, 2, 3)),
                segmentation=rng.integers(0, 2, (B, N_POINTS)),
                part_counts=rng.integers(0, 9, (B, 2)), raw={})
            alive.append(weakref.ref(res.R))
            results.append({"R": res.R.copy(), "seg": res.segmentation.copy()})
            return res

        out = serve_clouds(predictor, clouds(5, seed=1), batch_size=2)
        assert len(results) == 3
        np.testing.assert_array_equal(
            out["R"], np.concatenate([r["R"] for r in results])[:5])
        np.testing.assert_array_equal(
            out["seg"], np.concatenate([r["seg"] for r in results])[:5])

    def test_weights_from_a_saved_state_dict(self, tmp_path):
        kw, jcfg, flat = tiny_setup()
        sd = state_dict_from_flax(flat)
        torch.save(sd, tmp_path / "model.pt")
        a = PosePredictor(config.NetworkConfig(**kw), state_dict=sd,
                          pose_cfg=port_cfg(jcfg), device="cpu")
        b = PosePredictor(config.NetworkConfig(**kw),
                          ckpt_path=str(tmp_path / "model.pt"),
                          pose_cfg=port_cfg(jcfg), device="cpu")
        P = clouds(2)
        np.testing.assert_array_equal(a(P).R, b(P).R)
        with pytest.raises(ValueError, match="exactly one"):
            PosePredictor(config.NetworkConfig(**kw))

    def test_a_dropped_predictor_is_freed_without_gc(self):
        """A predictor holds no reference to itself: when its last
        reference goes, it and its programs (on the card, their graphs)
        are freed at once, with no garbage collection."""
        import gc
        import weakref

        kw, jcfg, flat = tiny_setup()
        collecting = gc.isenabled()
        gc.disable()
        try:
            pred = PosePredictor(config.NetworkConfig(**kw),
                                 state_dict=state_dict_from_flax(flat),
                                 pose_cfg=port_cfg(jcfg), device="cpu")
            pred(clouds(2))
            refs = [weakref.ref(pred), weakref.ref(pred._programs[0])]
            del pred
            assert [ref() for ref in refs] == [None, None]
        finally:
            if collecting:
                gc.enable()

    def test_serves_on_the_card_by_default(self):
        # the default device is the card; without one it raises, naming
        # the device, rather than serving on the CPU
        kw, _, flat = tiny_setup()
        sd = state_dict_from_flax(flat)
        if torch.cuda.is_available():
            pred = PosePredictor(config.NetworkConfig(**kw), state_dict=sd)
            assert pred.device.type == "cuda"
            assert next(pred.model.parameters()).is_cuda
        else:
            with pytest.raises(RuntimeError, match="device cuda"):
                PosePredictor(config.NetworkConfig(**kw), state_dict=sd)


class TestConfigAndRegistry:
    @pytest.mark.parametrize("name", ["eyeglasses", "oven", "laptop",
                                      "washing_machine", "drawer"])
    def test_categories_match_jax(self, name):
        got, want = registry.get_category(name), jregistry.get_category(name)
        assert got.n_parts == want.n_parts
        assert tuple(got.joint_types) == tuple(want.joint_types)
        assert got.dataset_name == want.dataset_name
        assert set(registry.DATASETS) == set(jregistry.DATASETS)

    def test_defaults_match_jax(self):
        ours, theirs = config.NetworkConfig(), jconfig.NetworkConfig()
        for f in dataclasses.fields(ours):
            if f.name in config.PORT_FIELDS:    # the port's own keys
                continue
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
        assert ours.backbone == "pointnet2"     # JAX's only backbone
        assert ours.is_mixed and not ours.replace(nocs_type="npcs").is_mixed
        assert ours.category_spec.n_parts == 3

    def test_load_config_reads_a_jax_config_file(self, tmp_path):
        path = tmp_path / "cfg.yml"
        path.write_text("category: drawer\nn_max_parts: 4\nnocs_type: npcs\n"
                        "lm_iters: 7\ncompute_dtype: bfloat16\n")
        cfg = config.load_config(str(path), seed=5)
        want = jconfig.load_config(str(path), seed=5)
        for f in dataclasses.fields(cfg):
            if f.name not in config.PORT_FIELDS:
                assert getattr(cfg, f.name) == getattr(want, f.name), f.name
        assert cfg.pred_joint is False

    @pytest.mark.parametrize("field,value", [
        ("head_compute_dtype", "float32"), ("pool_compute_dtype", "float32"),
        ("act_compute_dtype", "float32"), ("f32_stages", ("sa1",))])
    def test_unported_policy_knobs_raise(self, field, value):
        # the mixed-precision knobs are ported: the value is taken, and
        # only a value the JAX package would refuse raises
        assert getattr(config.NetworkConfig(**{field: value}), field) == value
        bad = ("sa9",) if field == "f32_stages" else "float16"
        with pytest.raises(ValueError, match=field):
            config.NetworkConfig(**{field: bad})
