"""Dataset / category registry: a copy of `articulated_pose_tpu/registry.py`.

A typed replacement for the reference's hardcoded Python registry
(reference: global_info.py:14-193).  Each category carries its part
grouping (``parts_map``), unseen-instance test split, SAPIEN-style
per-instance part reordering (``spec_map``), and joint types.

Unlike the reference, the registry is plain data (dataclasses) and can be
extended from YAML files at runtime instead of editing code.  PyYAML is
imported by `load_categories_yaml` only, so the registry itself needs
none (a GPU host may lack it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class CategorySpec:
    """Per-category dataset specification.

    Mirrors the fields of the reference ``DatasetInfo`` namedtuple
    (reference: global_info.py:7-11) that the pipeline actually consumes.
    """

    name: str
    dataset_name: str = "shape2motion"           # 'shape2motion' | 'sapien' | 'BMVC15'
    parts_map: Sequence[Sequence[int]] = ((0,), (1,))
    num_parts: int = 2
    num_object: int = 0
    train_size: int = 0
    test_size: int = 0
    # instance ids held out entirely (the "unseen" split)
    test_list: Sequence[str] = ()
    # explicit training instances (None = all non-test instances)
    train_list: Optional[Sequence[str]] = None
    # instance ids with special handling
    spec_list: Sequence[str] = ()
    # SAPIEN-style per-instance part reordering (reference: lib/dataset.py:693-699)
    spec_map: Optional[Dict[str, List[int]]] = None
    # 'revolute' | 'prismatic' | 'fixed' per joint (joint j connects part j to its parent)
    joint_types: Sequence[str] = ("revolute",)
    exp: str = ""
    baseline: str = ""
    joint_baseline: str = ""
    style: str = "new"

    @property
    def n_parts(self) -> int:
        return len(self.parts_map)


# The five categories shipped by the reference (reference: global_info.py:14-181).
DATASETS: Dict[str, CategorySpec] = {
    "eyeglasses": CategorySpec(
        name="eyeglasses",
        dataset_name="shape2motion",
        num_object=24,
        parts_map=((0,), (1,), (2,)),
        num_parts=3,
        train_size=13000,
        test_size=3480,
        test_list=("0007", "0016", "0036"),
        spec_list=("0006",),
        joint_types=("revolute", "revolute"),
        exp="3.9",
        baseline="3.91",
        joint_baseline="5.0",
    ),
    "oven": CategorySpec(
        name="oven",
        dataset_name="shape2motion",
        num_object=42,
        parts_map=((0,), (1,)),
        num_parts=2,
        train_size=25000,
        test_size=5480,
        test_list=("0003", "0016", "0029"),
        spec_list=("0006", "0015", "0035", "0038"),
        joint_types=("revolute",),
        exp="3.0",
        baseline="3.01",
        joint_baseline="5.2",
        style="old",
    ),
    "laptop": CategorySpec(
        name="laptop",
        dataset_name="shape2motion",
        num_object=86,
        parts_map=((0,), (1,)),
        num_parts=2,
        train_size=67603,
        test_size=5036,
        test_list=("0004", "0008", "0069"),
        spec_list=("0003", "0006", "0041", "0080", "0081"),
        joint_types=("revolute",),
        exp="3.6",
        baseline="3.61",
        joint_baseline="5.1",
        style="new",
    ),
    "washing_machine": CategorySpec(
        name="washing_machine",
        dataset_name="shape2motion",
        num_object=62,
        parts_map=((0,), (1,)),
        num_parts=2,
        train_size=43000,
        test_size=3480,
        test_list=("0003", "0029"),
        spec_list=("0001", "0002", "0006", "0007", "0010",
                   "0027", "0031", "0040", "0050", "0009",
                   "0029", "0038", "0039", "0041", "0046",
                   "0052", "0058"),
        joint_types=("revolute",),
        exp="3.1",
        baseline="3.11",
        joint_baseline="5.3",
        style="old",
    ),
    "drawer": CategorySpec(
        name="drawer",
        dataset_name="sapien",
        num_object=1,
        parts_map=((0,), (1,), (2,), (3,)),
        num_parts=4,
        train_size=13000,
        test_size=3480,
        test_list=("46123", "45841", "46440"),
        train_list=(
            "40453", "44962", "45132", "45290", "46130", "46334", "46462",
            "46537", "46544", "46641", "47178", "47183", "47296", "47233",
            "48010", "48253", "48517", "48740", "48876", "46230", "44853",
            "45135", "45427", "45756", "46653", "46879", "47438", "47711",
            "48491"),
        spec_list=(),
        spec_map={ins: [3, 0, 1, 2] for ins in (
            "40453", "44962", "45132", "45290", "46123", "46130", "46334",
            "46440", "46462", "46537", "46544", "46641", "47178", "47183",
            "47296", "47233", "48010", "48253", "48517", "48740", "48876",
            "46230")} | {
            "44853": [3, 1, 2, 0], "45135": [3, 1, 0, 2],
            "45427": [3, 2, 0, 1], "45756": [3, 1, 2, 0],
            "45841": [0, 1, 2, 3], "46653": [0, 1, 2, 3],
            "46879": [3, 1, 2, 0], "47438": [3, 2, 1, 0],
            "47711": [0, 1, 2, 3], "48491": [0, 1, 2, 3]},
        # 3 prismatic drawers on the base; joint j attaches part j
        # (reference: lib/dataset.py:627-639 — the base's own 'fixed'
        # world joint is not a part-to-part joint)
        joint_types=("prismatic", "prismatic", "prismatic"),
        exp="3.3",
        baseline="3.31",
        joint_baseline="5.4",
    ),
    # BMVC15 real-depth categories (reference: global_info.py:86-153)
    "Laptop": CategorySpec(
        name="Laptop", dataset_name="BMVC15", num_object=1,
        parts_map=((0,), (1,)), num_parts=2,
        train_size=13000, test_size=3480,
        train_list=("0001",), test_list=("0006",),
        joint_types=("revolute",),
    ),
    "Cabinet": CategorySpec(
        name="Cabinet", dataset_name="BMVC15", num_object=1,
        # (001)base + (002)drawer + (000)door
        parts_map=((0,), (1,), (2,)), num_parts=3,
        train_size=13000, test_size=3480,
        train_list=("0001",), test_list=("0006",),
        spec_map={"0001": [1, 2, 0], "0006": [1, 2, 0]},
        joint_types=("prismatic", "revolute"),
    ),
    "Cupboard": CategorySpec(
        name="Cupboard", dataset_name="BMVC15", num_object=1,
        parts_map=((0,), (1,)), num_parts=2,
        train_size=13000, test_size=3480,
        train_list=("0001",), test_list=("0006",),
        spec_map={"0001": [0, 1], "0006": [0, 1]},
        joint_types=("prismatic",),
    ),
    "Train": CategorySpec(
        name="Train", dataset_name="BMVC15", num_object=1,
        parts_map=((0,), (1,), (2,), (3,)), num_parts=4,
        train_size=13000, test_size=3480,
        train_list=("0001",), test_list=("0006",),
        spec_map={"0001": [0, 1, 2, 3], "0006": [0, 1, 2, 3]},
        joint_types=("revolute", "revolute", "revolute"),
    ),
}


def get_category(name: str) -> CategorySpec:
    try:
        return DATASETS[name]
    except KeyError:
        raise KeyError(
            f"unknown category {name!r}; known: {sorted(DATASETS)} "
            "(register new ones with register_category / load_categories_yaml)"
        ) from None


def register_category(spec: CategorySpec) -> None:
    DATASETS[spec.name] = spec


def load_categories_yaml(path: str) -> None:
    """Extend the registry from a YAML file of {name: {field: value}}.
    Needs PyYAML: ImportError without it."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    for name, fields in raw.items():
        fields = dict(fields or {})
        fields.setdefault("name", name)
        if "parts_map" in fields:
            fields["parts_map"] = tuple(tuple(g) for g in fields["parts_map"])
        register_category(CategorySpec(**fields))
