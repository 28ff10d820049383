"""URDF parsing → joint specs + normalization info: a copy of
`articulated_pose_tpu/tools/urdf.py` on the port's `JointSpec`/`NormInfo`.

Equivalent of the reference's URDF readers (reference:
lib/data_utils.py:353-413 `get_urdf` for shape2motion `syn.urdf`,
:230-350 `get_urdf_mobility` for SAPIEN `mobility.urdf`) plus the mesh
normalization-factor computation (`get_model_pts`/`get_all_objs`,
lib/data_utils.py:447-575: per-part and global corner boxes with
1/diagonal factors).

No trimesh dependency: OBJ vertices are read with a minimal parser.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence

import numpy as np

from articulated_pose_tpu_torch.data.labeling import JointSpec, NormInfo


def load_obj_vertices(path: str) -> np.ndarray:
    """Minimal OBJ reader: vertex positions only."""
    verts = []
    with open(path, errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return np.asarray(verts, np.float64)


def parse_urdf(path: str) -> Dict:
    """Parse a syn.urdf/mobility.urdf into the reference's dict schema:
    {'link': {'xyz', 'rpy'}, 'joint': {'xyz', 'rpy', 'axis', 'type',
    'parent', 'child'}, 'obj_name', 'num_links'}.

    Link/joint indices: 'base_link' (or the first link) is 0; named links
    are parsed as ints when possible, else enumerated in document order.
    """
    tree = ET.parse(path)
    root = tree.getroot()

    link_names = []
    for link in root.iter("link"):
        link_names.append(link.attrib["name"])

    def link_index(name: str) -> int:
        if name in ("base_link", "base"):
            return 0
        try:
            return int(name)
        except ValueError:
            return link_names.index(name)

    n = len(link_names)
    link_xyz: List = [None] * n
    link_rpy: List = [None] * n
    obj_name: List = [None] * n
    for link in root.iter("link"):
        i = link_index(link.attrib["name"])
        objs, xyzs, rpys = [], [], []
        for visual in link.iter("visual"):
            for origin in visual.iter("origin"):
                xyzs.append([float(x) for x in origin.attrib.get(
                    "xyz", "0 0 0").split()])
                rpys.append([float(x) for x in origin.attrib.get(
                    "rpy", "0 0 0").split()])
            for mesh in visual.iter("mesh"):
                objs.append(mesh.attrib["filename"])
        link_xyz[i] = xyzs if len(xyzs) != 1 else xyzs[0]
        link_rpy[i] = rpys if len(rpys) != 1 else rpys[0]
        obj_name[i] = objs if len(objs) != 1 else (objs[0] if objs else None)

    joint_fields = {k: [None] * n for k in
                    ("xyz", "rpy", "axis", "type", "parent", "child")}
    for joint in root.iter("joint"):
        child_el = joint.find("child")
        parent_el = joint.find("parent")
        ci = link_index(child_el.attrib["link"])
        joint_fields["type"][ci] = joint.attrib["type"]
        joint_fields["parent"][ci] = link_index(parent_el.attrib["link"])
        joint_fields["child"][ci] = ci
        for origin in joint.iter("origin"):
            joint_fields["xyz"][ci] = [float(x) for x in
                                       origin.attrib.get("xyz", "0 0 0").split()]
            joint_fields["rpy"][ci] = [float(x) for x in
                                       origin.attrib.get("rpy", "0 0 0").split()]
        for axis in joint.iter("axis"):
            joint_fields["axis"][ci] = [float(x) for x in
                                        axis.attrib["xyz"].split()]

    return {
        "link": {"xyz": link_xyz, "rpy": link_rpy},
        "joint": joint_fields,
        "obj_name": obj_name,
        "num_links": n,
    }


def urdf_to_joint_specs(urdf: Dict) -> List[JointSpec]:
    """Framework JointSpecs from a parsed URDF.

    Joint position convention matches the reference labeling: the joint
    line passes through -link_origin_xyz of the child (the child's mesh
    center in the canonical frame — lib/dataset.py:500 uses
    joint_P0 = -joint_xyz[j]).
    """
    n = urdf["num_links"]
    specs = []
    link_xyz = urdf["link"]["xyz"]
    for ci in range(1, n):
        jt = urdf["joint"]["type"][ci]
        if jt is None:
            continue
        axis = urdf["joint"]["axis"][ci] or [0.0, 0.0, 1.0]
        lx = link_xyz[ci]
        if lx is None:
            lx = urdf["joint"]["xyz"][ci] or [0.0, 0.0, 0.0]
            pos = np.asarray(lx, np.float64)
        else:
            if isinstance(lx[0], (list, tuple)):
                lx = lx[0]
            pos = -np.asarray(lx, np.float64)
        jtype = {"revolute": "revolute", "continuous": "revolute",
                 "prismatic": "prismatic"}.get(jt, "fixed")
        # part ids equal link ids (base_link = part 0)
        specs.append(JointSpec(
            position=pos, axis=np.asarray(axis, np.float64),
            parent=urdf["joint"]["parent"][ci] or 0, child=ci, jtype=jtype))
    return specs


def norm_info_from_objs(obj_paths: Sequence[Optional[str]],
                        offsets: Optional[Sequence] = None) -> NormInfo:
    """Per-part + global corner boxes and 1/diagonal factors from part
    meshes (lib/data_utils.py:447-575)."""
    parts = []
    for i, p in enumerate(obj_paths):
        paths = p if isinstance(p, (list, tuple)) else [p]
        verts = np.concatenate([load_obj_vertices(q) for q in paths if q], 0)
        if offsets is not None and offsets[i] is not None:
            verts = verts + np.asarray(offsets[i], np.float64).reshape(1, 3)
        parts.append(verts)
    return NormInfo.from_parts(parts)
