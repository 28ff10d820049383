"""Asset tools: Shape2Motion JSON and SAPIEN URDFs to joint specs, the
depth-render preprocessor and the (optional) PyBullet renderer; a copy of
`articulated_pose_tpu/tools/`."""

from articulated_pose_tpu_torch.tools.motion_json import MotionModel, parse_motion_json, write_urdf
from articulated_pose_tpu_torch.tools.urdf import load_obj_vertices, parse_urdf, urdf_to_joint_specs

__all__ = [
    "MotionModel",
    "load_obj_vertices",
    "parse_motion_json",
    "parse_urdf",
    "urdf_to_joint_specs",
    "write_urdf",
]
