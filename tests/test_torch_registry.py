"""The port's category registry against the JAX package's, field by field,
on the CPU; `load_categories_yaml` with and without PyYAML."""

import dataclasses
import sys

import pytest

from articulated_pose_tpu import registry as jregistry
from articulated_pose_tpu_torch import registry

FIELDS = [f.name for f in dataclasses.fields(jregistry.CategorySpec)]


def test_fields_are_jaxs():
    assert FIELDS == [f.name for f in dataclasses.fields(registry.CategorySpec)]
    assert set(registry.DATASETS) == set(jregistry.DATASETS)


@pytest.mark.parametrize("name", sorted(jregistry.DATASETS))
def test_every_field_of_every_category(name):
    got, want = registry.get_category(name), jregistry.get_category(name)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.n_parts == want.n_parts == len(want.parts_map)


def test_unknown_category_message():
    with pytest.raises(KeyError) as got:
        registry.get_category("nonexistent")
    with pytest.raises(KeyError) as want:
        jregistry.get_category("nonexistent")
    assert str(got.value) == str(want.value)


YAML = """\
toaster:
  dataset_name: shape2motion
  parts_map: [[0], [1, 2]]
  num_parts: 2
  test_list: ["0001"]
  joint_types: [prismatic]
"""


def test_load_categories_yaml(tmp_path, monkeypatch):
    path = tmp_path / "cats.yml"
    path.write_text(YAML)
    for reg in (registry, jregistry):
        monkeypatch.setattr(reg, "DATASETS", dict(reg.DATASETS))
        reg.load_categories_yaml(str(path))
    got, want = registry.get_category("toaster"), jregistry.get_category(
        "toaster")
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.parts_map == ((0,), (1, 2)) and got.n_parts == 2
    # the registry needs no PyYAML; reading a YAML file does
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError):
        registry.load_categories_yaml(str(path))
    registry.register_category(registry.CategorySpec(name="kettle"))
    assert registry.get_category("kettle").num_parts == 2
