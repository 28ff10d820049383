"""Hand-written CUDA kernels of the port's paths, with their plain versions.

Importing this package builds nothing: a kernel is compiled (nvcc) and
loaded the first time a CUDA tensor reaches its wrapper
(`fps.fps2`, `fps.fps`, `ball_query.ball_query_group`,
`ball_query.ball_query_group_packed`, `ball_query.ball_query_idx`,
`ball_query.ball_query_point`, `ball_query.ball_query_point_grouped`,
`ball_query.ball_query_group_bucket`, `three_nn.three_nn`,
`three_nn.three_nn_stream`, `three_nn.three_nn_packed`, `knn.knn`,
`joint_fit.joint_fit`, `vector_attention.vector_attention`).  Each entry
but `knn`, `joint_fit` and `vector_attention` replaces one TPU kernel
(`knn` replaces a `lax.top_k`, for the Point Transformer backbone;
`joint_fit` the pose fit's joint stage, XLA ops in the JAX package;
`vector_attention` the Point Transformer's attention layer, which the
JAX package does not have), and each counts its own launches, also
where two entries launch the same CUDA function.
"""

from articulated_pose_tpu_torch.ops.kernels import (ball_query, fps,
                                                    joint_fit, knn, three_nn,
                                                    vector_attention)

# every kernel, by name
KERNELS = {k.name: k for k in (fps.KERNEL, fps.SINGLE_KERNEL,
                                ball_query.KERNEL, ball_query.PACKED_KERNEL,
                                ball_query.IDX_KERNEL,
                                ball_query.POINT_KERNEL,
                                ball_query.POINT_GROUPED_KERNEL,
                                ball_query.BUCKET_KERNEL, three_nn.KERNEL,
                                three_nn.STREAM_KERNEL,
                                three_nn.PACKED_KERNEL, knn.KERNEL,
                                joint_fit.KERNEL, vector_attention.KERNEL)}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


__all__ = ["KERNELS", "ball_query", "fps", "joint_fit", "knn", "three_nn",
           "vector_attention", "launch_counts", "reset_launch_counts"]
