"""The benchmark's plain reference: the ANCSH forward, the pose fit, the
float32 train step and the on-card generator's draws in plain PyTorch,
frozen copies of the port's plain code.  It imports nothing of the port
(`articulated_pose_tpu_torch`) and nothing of JAX, and takes no weight,
table or draw that the program made: the harness hands both sides the
same inputs and state dict, and the reference draws again from the
seeds what the program drew.

`precision(tf32)` sets whether float32 products may run as TF32: off
for the reference, on for the control of a float32 configuration.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
