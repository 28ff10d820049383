"""Hand-written CUDA kernels of the serving path, with their plain versions.

Importing this package builds nothing: a kernel is compiled (nvcc) and
loaded the first time a CUDA tensor reaches its wrapper
(`fps.fps2`, `ball_query.ball_query_group`, `three_nn.three_nn`).
"""

from articulated_pose_tpu_torch.ops.kernels import ball_query, fps, three_nn

# every kernel of the serving path, by name
KERNELS = {m.KERNEL.name: m.KERNEL for m in (fps, ball_query, three_nn)}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


__all__ = ["KERNELS", "ball_query", "fps", "three_nn", "launch_counts",
           "reset_launch_counts"]
