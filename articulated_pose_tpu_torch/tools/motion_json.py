"""Shape2Motion motion-JSON parsing and URDF generation: a copy of
`articulated_pose_tpu/tools/motion_json.py` on the port's `JointSpec`.

Equivalent of the reference's offline URDF generator (reference:
tools/json2urdf.py:53-222): traverses the motion-annotation tree
(nested dicts with `dof_name`, `center`, `direction`, `motion_type`,
`children`), flattens it to links + joints with chain-accumulated joint
positions, and can emit `syn.urdf` plus per-part `syn_p{i}.urdf`
variants (mass-zero base) for physics renderers.

It also converts directly to the port's JointSpec list so the
training pipeline needs no URDF round-trip at all.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import xml.dom.minidom
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from articulated_pose_tpu_torch.data.labeling import JointSpec


@dataclasses.dataclass
class MotionLink:
    name: str
    center: np.ndarray
    direction: Optional[np.ndarray]
    motion_type: Optional[str]
    parent: Optional[str]
    obj_file: Optional[str] = None


@dataclasses.dataclass
class MotionModel:
    links: List[MotionLink]          # [0] is the root
    joints: List[JointSpec]          # joint i attaches links[i+1]

    @property
    def n_parts(self) -> int:
        return len(self.links)


def _traverse(d: Dict, parent: Optional[str], out: List[MotionLink]):
    center = np.asarray(d.get("center", [0.0, 0.0, 0.0]), np.float64)
    direction = d.get("direction")
    out.append(MotionLink(
        name=d["dof_name"],
        center=center,
        direction=None if direction is None else np.asarray(direction, np.float64),
        motion_type=d.get("motion_type"),
        parent=parent,
    ))
    for child in d.get("children") or []:
        _traverse(child, d["dof_name"], out)


def parse_motion_json(path_or_dict) -> MotionModel:
    """Parse a motion JSON tree into links + framework JointSpecs.

    Joint position = chain-accumulated child center (the reference walks
    ancestors subtracting centers, tools/json2urdf.py:117-135 — in world
    frame that telescopes to the child's own center); axis = `direction`;
    type: 'rotation' → revolute, else prismatic.
    """
    if isinstance(path_or_dict, (str, os.PathLike)):
        with open(path_or_dict) as f:
            raw = json.load(f)
    else:
        raw = path_or_dict
    links: List[MotionLink] = []
    _traverse(raw, None, links)
    name_to_idx = {l.name: i for i, l in enumerate(links)}
    joints = []
    for i, l in enumerate(links[1:], start=1):
        jtype = "revolute" if l.motion_type == "rotation" else "prismatic"
        axis = l.direction if l.direction is not None else np.array([0.0, 0, 1])
        joints.append(JointSpec(
            position=l.center.copy(), axis=np.asarray(axis, np.float64),
            parent=name_to_idx[l.parent], child=i, jtype=jtype))
    return MotionModel(links=links, joints=joints)


def write_urdf(model: MotionModel, save_dir: str, obj_dir: str = ".",
               per_part: bool = True) -> List[str]:
    """Emit syn.urdf (+ per-part syn_p{i}.urdf) in the reference's schema:
    link names base_link/1/2/..., joint names '<parent>_j_<child>', link
    visual origins at -center (tools/json2urdf.py:139-222)."""
    os.makedirs(save_dir, exist_ok=True)
    n = model.n_parts
    names = ["base_link"] + [str(i) for i in range(1, n)]
    root = ET.Element("robot", name="block")

    link_elems = []
    for i in range(n):
        link = ET.Element("link", name=names[i])
        visual = ET.SubElement(link, "visual")
        off = -model.links[i].center if i > 0 else np.zeros(3)
        ET.SubElement(visual, "origin", rpy="0.0 0.0 0.0",
                      xyz=f"{off[0]} {off[1]} {off[2]}")
        geometry = ET.SubElement(visual, "geometry")
        obj = model.links[i].obj_file or (
            f"{obj_dir}/part_objs/{'none_motion' if i == 0 else model.links[i].name}.obj")
        ET.SubElement(geometry, "mesh", filename=obj)
        inertial = ET.SubElement(link, "inertial")
        ET.SubElement(inertial, "origin", rpy="0 0 0", xyz="0 0 0")
        mass = "0.0" if i == 0 else "3.0"
        inertia = "0.0" if i == 0 else "100"
        ET.SubElement(inertial, "mass", value=mass)
        ET.SubElement(inertial, "inertia", ixx=inertia, ixy=inertia,
                      ixz=inertia, iyy=inertia, iyz=inertia, izz=inertia)
        link_elems.append(link)
    root.extend(link_elems)

    joint_elems = []
    for j, spec in enumerate(model.joints):
        je = ET.Element("joint", name=f"{spec.parent}_j_{spec.child}",
                        type=spec.jtype)
        ET.SubElement(je, "parent", link=names[spec.parent])
        ET.SubElement(je, "child", link=names[spec.child])
        p = spec.position
        ET.SubElement(je, "origin", xyz=f"{p[0]} {p[1]} {p[2]}", rpy="0 0 0")
        a = spec.axis
        ET.SubElement(je, "axis", xyz=f"{a[0]} {a[1]} {a[2]}")
        if spec.jtype == "revolute":
            ET.SubElement(je, "limit", effort="1.0", lower="-3.1415",
                          upper="3.1415", velocity="1000")
        joint_elems.append(je)
    root.extend(joint_elems)

    def pretty(elem) -> str:
        return xml.dom.minidom.parseString(ET.tostring(elem)).toprettyxml()

    paths = [os.path.join(save_dir, "syn.urdf")]
    with open(paths[0], "w") as f:
        f.write(pretty(root))

    if per_part:
        # per-part URDFs keep only one link's visual (json2urdf.py:200-222)
        for i in range(n):
            part = copy.deepcopy(root)
            for link in part.findall("link"):
                if link.attrib["name"] != names[i]:
                    for visual in link.findall("visual"):
                        link.remove(visual)
            p = os.path.join(save_dir, f"syn_p{i}.urdf")
            with open(p, "w") as f:
                f.write(pretty(part))
            paths.append(p)
    return paths
