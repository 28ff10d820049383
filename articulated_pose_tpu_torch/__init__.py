"""PyTorch / CUDA port of articulated_pose_tpu for NVIDIA Hopper GPUs.

The JAX package (`articulated_pose_tpu`) is the reference; every module
here mirrors its counterpart there and is held against it by the
`tests/test_torch_*.py` parity tests.  The point-cloud kernels (two-
and single-level FPS; the ball query in its exact, packed, index-only
and bucket tiers; exact and packed-key 3-NN), one entry for each TPU
kernel of the JAX package, are hand-written CUDA C++ under `csrc/`,
built with nvcc at first use and bound with ctypes (`ops/kernels/`).
A CPU tensor takes each kernel's plain PyTorch version; a CUDA tensor
takes the kernel.  `profile_stages` times the flagship forward, its
kernels and the pose fit's sub-stages on the card.  `train` trains the
model (`main.py train`'s path) from the host data feed of `data/`.
`main` (`python -m articulated_pose_tpu_torch`) is the command line:
`main.py`'s commands and flags, on the card by default.  `utils/tf_ckpt`
loads the reference's TF1 checkpoints (`utils/tf_bundle`, no
TensorFlow), held to the float64 TF graph of `utils/ref_forward`;
`tools/` turns assets and depth renders into frames.

This package imports torch and numpy only: never jax, flax or the JAX
package, so it runs on a GPU host that has none of them.
"""

import torch

# Distance and RANSAC-scoring matmuls must stay full f32: TF32 keeps
# ~3 decimal digits and flips radius / inlier decisions near the
# boundary (the reference runs these contractions at Precision.HIGHEST).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from articulated_pose_tpu_torch.config import NetworkConfig  # noqa: E402
from articulated_pose_tpu_torch.registry import CategorySpec, get_category  # noqa: E402

__all__ = ["NetworkConfig", "CategorySpec", "get_category"]
