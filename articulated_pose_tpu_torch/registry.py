"""Category registry: the part count and joint types serving reads.

Port of `articulated_pose_tpu/registry.py` (the five reference
categories and the BMVC15 real-depth ones), reduced to the fields the
forward + pose-fit path consumes.  Dataset split lists stay in the JAX
package until the data and eval modules are ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence


@dataclasses.dataclass(frozen=True)
class CategorySpec:
    name: str
    dataset_name: str
    parts_map: Sequence[Sequence[int]]
    # 'revolute' | 'prismatic' per joint (joint j connects part j to part 0)
    joint_types: Sequence[str]

    @property
    def n_parts(self) -> int:
        return len(self.parts_map)


def _spec(name, dataset_name, n_parts, joint_types):
    return CategorySpec(name=name, dataset_name=dataset_name,
                        parts_map=tuple((j,) for j in range(n_parts)),
                        joint_types=tuple(joint_types))


DATASETS: Dict[str, CategorySpec] = {
    "eyeglasses": _spec("eyeglasses", "shape2motion", 3,
                        ("revolute", "revolute")),
    "oven": _spec("oven", "shape2motion", 2, ("revolute",)),
    "laptop": _spec("laptop", "shape2motion", 2, ("revolute",)),
    "washing_machine": _spec("washing_machine", "shape2motion", 2,
                             ("revolute",)),
    "drawer": _spec("drawer", "sapien", 4,
                    ("prismatic", "prismatic", "prismatic")),
    "Laptop": _spec("Laptop", "BMVC15", 2, ("revolute",)),
    "Cabinet": _spec("Cabinet", "BMVC15", 3, ("prismatic", "revolute")),
    "Cupboard": _spec("Cupboard", "BMVC15", 2, ("prismatic",)),
    "Train": _spec("Train", "BMVC15", 4,
                   ("revolute", "revolute", "revolute")),
}


def get_category(name: str) -> CategorySpec:
    try:
        return DATASETS[name]
    except KeyError:
        raise KeyError(f"unknown category {name!r}; known: "
                       f"{sorted(DATASETS)}") from None
