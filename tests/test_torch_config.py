"""The port's config loader against the JAX package's, on the CPU.

`load_config` reads the JAX package's config files without PyYAML (the
card host has none) and refuses the keys JAX refuses.  Each file is
read by both packages; the port's reader runs with `yaml` blocked.
"""

import dataclasses
import math
import pathlib
import sys

import pytest
import yaml

from articulated_pose_tpu import config as jconfig
from articulated_pose_tpu_torch import config

CFG = pathlib.Path(__file__).resolve().parents[1] / "cfg"
# the port's fields but its own (PORT_FIELDS, which JAX's config lacks)
SHARED = [f.name for f in dataclasses.fields(config.NetworkConfig)
          if f.name not in config.PORT_FIELDS]


@pytest.fixture
def no_yaml(monkeypatch):
    """`import yaml` raises ImportError while the test runs."""
    monkeypatch.setitem(sys.modules, "yaml", None)


def _same(port, jax_cfg):
    for name in SHARED:
        assert getattr(port, name) == getattr(jax_cfg, name), name


def test_jax_fields_match_the_jax_dataclass():
    assert config.JAX_FIELDS == tuple(
        f.name for f in dataclasses.fields(jconfig.NetworkConfig))
    assert set(SHARED) <= set(config.JAX_FIELDS)
    assert not set(config.PORT_FIELDS) & set(config.JAX_FIELDS)


def test_the_port_only_key_is_the_ports_alone(tmp_path, no_yaml):
    """`backbone` is read by the port; the JAX package refuses it."""
    path = tmp_path / "cfg.yml"
    path.write_text("backbone: point_transformer\n")
    assert config.load_config(str(path)).backbone == "point_transformer"
    assert config.load_config().backbone == "pointnet2"
    sys.modules.pop("yaml")
    with pytest.raises(ValueError, match="unknown config keys"):
        jconfig.load_config(str(path))


@pytest.mark.parametrize("name", ["network_config.yml",
                                  "network_config_real.yml"])
def test_reads_the_repo_configs_without_yaml(name, monkeypatch):
    want = jconfig.load_config(str(CFG / name))
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError):
        import yaml as _  # noqa: F401
    _same(config.load_config(str(CFG / name)), want)


@pytest.mark.parametrize("stages", [
    "f32_stages: [sa1, 'fc1']\n",
    "f32_stages:\n  - sa1\n  - fc1   # pinned\n",
    "f32_stages:\n- sa1\n- \"fc1\"\n",
])
def test_f32_stages_flow_and_block_lists(stages, tmp_path, monkeypatch):
    path = tmp_path / "cfg.yml"
    path.write_text("# bf16 trunk, SA1 pinned\ncompute_dtype: bfloat16\n\n"
                    + stages + "lm_iters: 7\n")
    want = jconfig.load_config(str(path))
    monkeypatch.setitem(sys.modules, "yaml", None)
    got = config.load_config(str(path))
    _same(got, want)
    assert got.f32_stages == ("sa1", "fc1")


@pytest.mark.parametrize("text,where", [
    ("ball_query_pakced: true\n", "file"),
    ("compute_dtyp: bfloat16\n", "file"),
    ("", "override"),
])
def test_a_misspelt_key_raises_in_both_packages(text, where, tmp_path):
    path = tmp_path / "cfg.yml"
    path.write_text("category: laptop\n" + text)
    extra = {"ball_query_pakced": True} if where == "override" else {}
    for load in (config.load_config, jconfig.load_config):
        with pytest.raises(ValueError, match="unknown config keys"):
            load(str(path), **extra)


@pytest.mark.parametrize("key,value", [("lm_iters", 7), ("thres_r", 0.3),
                                       ("nn_name", "ancsh"),
                                       ("mesh_shape", None)])
def test_jax_only_keys_are_accepted(key, value, tmp_path, no_yaml):
    """A key of JAX's config is accepted; the port takes its value where
    it reads the field (thres_r, since the command line reads it) and
    ignores it elsewhere."""
    path = tmp_path / "cfg.yml"
    path.write_text(f"{key}: {'null' if value is None else value}\n")
    want = (config.NetworkConfig(**{key: value}) if key in SHARED
            else config.NetworkConfig())
    assert config.load_config(str(path)) == want
    assert config.load_config(**{key: value}) == want


def test_npcs_preset_is_kept(no_yaml):
    assert config.load_config(nocs_type="npcs").pred_joint is False


# scalars as PyYAML resolves them, but `1e-3`, which it reads as a string
@pytest.mark.parametrize("text", [
    "a: 16", "a: -5", "a: +3", "a: 1_000", "a: 0", "a: 0.001", "a: 1.5e-3",
    "a: .5", "a: 2.", "a: .inf", "a: -.inf", "a: true", "a: False",
    "a: yes", "a: off", "a: null", "a: ~", "a:", "a: eyeglasses",
    "a: \"bfloat16\"", "a: 'it''s'", "a: two words", "a: x  # comment",
    "a: 'a # not a comment'", "a: []", "a: [1, b, 'c, d', 2.5]",
    "a:\n  - 1\n  - x", "a: data/dir", "a: L2",
])
def test_scalars_read_as_yaml_reads_them(text, no_yaml):
    want = yaml.safe_load(text)
    assert config.read_flat_yaml(text) == want


def test_exponent_without_a_point_is_a_float(no_yaml):
    assert config.read_flat_yaml("lr: 1e-3\n") == {"lr": 1e-3}
    assert math.isnan(config.read_flat_yaml("a: .nan")["a"])


@pytest.mark.parametrize("text", [
    "a:\n  b: 1\n",                 # nested mapping
    "a: {b: 1}\n",                  # flow mapping
    "a: [[1, 2]]\n",                # nested list
    "a: &anchor 1\n", "a: *alias\n", "a: !!str 1\n",
    "a: |\n  text\n",               # block scalar
    "a: 0123\n", "a: 0x1f\n", "a: 1:30\n", "a: 2024-01-01\n",
    "a: 1\na: 2\n",                 # repeated key
    "- item\n",                     # a list, not a mapping
    "  a: 1\n", "a: 'open\n", "a: b: c\n", "a: \"x\\ty\"\n", "just text\n",
])
def test_what_it_cannot_read_raises(text, no_yaml):
    with pytest.raises(ValueError):
        config.read_flat_yaml(text)
