"""The accuracy-decision tools: counterparts of the JAX package's
`scripts/ab_*.py` and `scripts/diag_*.py` that measure accuracy, not
time.  Their readings chose the configuration that the package serves
and trains.  Each is runnable as `python -m
articulated_pose_tpu_torch.ab.<name>` with the JAX script's flags,
defaults, arms, tags and printed table, plus `--device` (the card by
default; without one it raises unless given `cpu`):

- `oracle`: the noisy-oracle predictions (GT labels with NOCS jitter,
  segmentation flips and axis jitter; NumPy, bit-equal to
  ab_ransac_strength.py's) and the pose scorer;
- `ransac_strength`: pose-fit accuracy against RANSAC strength on those
  predictions (ab_ransac_strength.py);
- `restore_eval`: restore a checkpoint, one eval batch, seg acc and
  prediction statistics (diag_restore_eval.py);
- `pose_knobs_trained`: the fit's knobs on a trained model's
  predictions, each arm timed on the card (ab_pose_knobs_trained.py);
- `packed_eval`: the exact against the packed ball query on the same
  weights, frames and fit draws (ab_packed_eval.py);
- `bf16_grads`: per-module gradient cosine and norm ratio of the bf16
  policies against f32 (diag_bf16_grads.py), under JAX's module names;
- `eval_scale`: the `eval` command under cProfile on an HDF5 fixture
  (profile_eval_scale.py); it needs h5py, so it runs on the CPU.

A checkpoint is the port's own (a `Trainer` or `e2e.py` work dir) or an
npz written by `scripts/export_jax_checkpoint.py` (`restore_eval.
restore_state`).  Like the JAX scripts, the tools draw their frames from
`SyntheticArticulated`'s default cameras (uniform SO(3)): a checkpoint
they read should have been trained on them (`e2e.py --full-rotation`,
or `pose_knobs_trained --train-steps`).
"""
