"""SAPIEN URDF cleanup + procedural synthetic-URDF generation: a copy of
`articulated_pose_tpu/tools/urdf_gen.py`; the files it writes equal the
JAX package's byte for byte.

Closes the drawer data-generation chain (json/mobility -> per-part URDFs
-> render -> preprocess):

- `modify_urdf` rebuilds the reference's mobility.urdf cleanup
  (reference: tools/urdf_modify.py:30-95): one loadable URDF per link
  where every OTHER link loses its visual+collision geometry, the kept
  link drops collision, every link gains an inertial block, and the
  `base` link gets zero mass/inertia so physics pins it.
- `generate_synthetic_urdf` rebuilds the stick/block generator
  (reference: tools/xml_parser_patch_stick.py:35-161 — the _cylinder
  variant is byte-identical): a stack of `parts_num` box links of random
  normalized heights joined by x-axis revolute joints, written as
  `syn.urdf` plus per-part `syn_p{i}.urdf` visual-only variants.
  Randomness comes from an explicit np.random.RandomState instead of
  the reference's global `random`/`randint`.
"""

from __future__ import annotations

import copy
import os
import xml.dom.minidom
import xml.etree.ElementTree as ET
from typing import List, Optional
from xml.etree.ElementTree import Element, SubElement, XML, tostring

import numpy as np

_INERTIAL = ('<inertial><origin rpy="0 0 0" xyz="0 0 0"/>'
             '<mass value="{m}"/><inertia ixx="{v}" ixy="{v}" ixz="{v}" '
             'iyy="{v}" iyz="0" izz="{v}"/></inertial>')


def _write_pretty(root: Element, path: str) -> None:
    pretty = xml.dom.minidom.parseString(tostring(root)).toprettyxml()
    with open(path, "w") as f:
        f.write(pretty)


def _zero_inertia(inertial: Element) -> None:
    for mass in inertial.iter("mass"):
        mass.set("value", "0.0")
    for inertia in inertial.iter("inertia"):
        for k in ("ixx", "ixy", "ixz", "iyy", "iyz", "izz"):
            inertia.set(k, "0.0")


def modify_urdf(urdf_dir: str, urdf_name: str = "mobility.urdf",
                out_prefix: str = "syn_p") -> List[str]:
    """Split `<urdf_dir>/mobility.urdf` into per-link loadable URDFs.

    Returns the written paths (`<urdf_dir>/<out_prefix>{i}.urdf`, one per
    link, in document link order).  Mirrors tools/urdf_modify.py:30-95.
    """
    urdf_file = os.path.join(urdf_dir, urdf_name)
    tree = ET.parse(urdf_file)
    root = tree.getroot()
    links_name = [link.attrib["name"] for link in root.findall("link")]
    written = []
    for i, name in enumerate(links_name):
        member = copy.deepcopy(root)
        for link in member.findall("link"):
            if link.attrib["name"] != name:
                for visual in link.findall("visual"):
                    link.remove(visual)
                for collision in link.findall("collision"):
                    link.remove(collision)
            else:
                for collision in link.findall("collision"):
                    link.remove(collision)
            if not link.findall("inertial"):
                inertial = SubElement(link, "inertial")
                inertial.extend(XML(_INERTIAL.format(m="3.0", v="0.9")))
                if link.attrib["name"] == "base":
                    _zero_inertia(inertial)
        path = os.path.join(urdf_dir, f"{out_prefix}{i}.urdf")
        _write_pretty(member, path)
        written.append(path)
    return written


def generate_synthetic_urdf(parts_num: int, save_dir: str,
                            rng: Optional[np.random.RandomState] = None
                            ) -> List[str]:
    """Procedural articulated block model -> URDF set.

    Writes `<save_dir>/syn.urdf` (full model) and one visual-only
    `syn_p{i}.urdf` per link; returns all written paths.  Geometry
    follows xml_parser_patch_stick.py: box links 2 x 1.5 wide with
    random heights normalized to total 0.3 (descending), x-axis revolute
    joints with the reference's origin offsets, shuffled material
    palette, and a joint-visual cylinder on every non-base link.
    """
    rng = rng or np.random.RandomState(0)
    num = parts_num
    root = Element("robot", name="block")
    links_name = ["base_link"] + [str(i + 1) for i in range(num)]
    links_w = [2, 1.5]
    links_h = rng.rand(num)
    links_h = links_h / links_h.sum() * 0.3
    links_h[::-1].sort()                       # descending, as reference

    colors_val = ["0 0 0.8", "1 1 1", "1 1 0", "1 0 1", "0 1 1",
                  "1 0 0", "0 1 0", "0 0 1"]
    colors_name = ["blue", "white", "yellow", "magenta", "cyan",
                   "red", "green", "bluep"]
    for cname, cval in zip(colors_name, colors_val):
        mat = SubElement(root, "material", name=cname)
        SubElement(mat, "color", rgba=f"{cval} 1")
    material_lib = list(colors_name)
    rng.shuffle(material_lib)

    children = [Element("link", name=links_name[i]) for i in range(num)]
    joints = [Element("joint", name=f"{i}_j_{i + 1}", type="revolute")
              for i in range(num - 1)]

    for i in range(num):
        box = f"{links_w[0]} {links_w[1]} {links_h[i]}"
        if i == 0:
            visual = SubElement(children[i], "visual")
            SubElement(visual, "origin", rpy="0.0 0 0", xyz="0 0 0")
            geometry = SubElement(visual, "geometry")
            SubElement(geometry, "box", size=box)
            SubElement(visual, "material", name=material_lib[i])
        else:
            vis_link = Element("visual")
            SubElement(vis_link, "origin", rpy="0.0 0 0",
                       xyz=f"0 {links_w[1] / 2} 0")
            geometry = SubElement(vis_link, "geometry")
            SubElement(geometry, "box", size=box)
            SubElement(vis_link, "material", name=material_lib[i])
            # joint-axis visual cylinder (reference :95-99)
            vis_joint = Element("visual")
            SubElement(vis_joint, "origin", rpy="0.0 1.5707 0", xyz="0 0 0")
            geo_joint = SubElement(vis_joint, "geometry")
            SubElement(geo_joint, "cylinder", length=str(links_w[0]),
                       radius=str(links_h[i] / 4))
            SubElement(vis_joint, "material", name=material_lib[i])
            children[i].extend([vis_link, vis_joint])

        inertial = SubElement(children[i], "inertial")
        inertial.extend(XML(_INERTIAL.format(m="1.0", v="0.9")))
        if i == 0:
            _zero_inertia(inertial)

    for i in range(num - 1):
        SubElement(joints[i], "parent", link=links_name[i])
        SubElement(joints[i], "child", link=links_name[i + 1])
        xyz = (f"0 {links_w[1] / 2} {links_h[i] / 2}" if i == 0
               else f"0 {links_w[1]} {links_h[i]}")
        SubElement(joints[i], "origin", xyz=xyz, rpy="0 0 0")
        SubElement(joints[i], "axis", xyz="1 0 0")
        SubElement(joints[i], "limit", effort="1000.0", lower="-3.14",
                   upper="3.14", velocity="0.5")

    root.extend(children)
    root.extend(joints)
    os.makedirs(save_dir, exist_ok=True)
    paths = [os.path.join(save_dir, "syn.urdf")]
    _write_pretty(root, paths[0])

    # per-part visual-only variants (reference :148-160)
    for i in range(num):
        member = copy.deepcopy(root)
        for link in member.findall("link"):
            if link.attrib["name"] != links_name[i]:
                for visual in link.findall("visual"):
                    link.remove(visual)
        path = os.path.join(save_dir, f"syn_p{i}.urdf")
        _write_pretty(member, path)
        paths.append(path)
    return paths
