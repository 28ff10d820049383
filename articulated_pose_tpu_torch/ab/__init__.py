"""The A/B tools: counterparts of the JAX package's `scripts/ab_*.py`
and `scripts/diag_*.py`.  The accuracy tools' readings chose the
configuration that the package serves and trains; the timing A/Bs time
bench.py's program on the card.  Each is runnable as `python -m
articulated_pose_tpu_torch.ab.<name>` with the JAX script's flags,
defaults, arms, tags and printed table, plus `--device` (the card by
default; without one it raises unless given `cpu`).  The accuracy
tools:

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

The timing A/Bs (their device columns "not measured" on the CPU):

- `overlap`: forward only, fit only, forward -> fit in series, and
  forward(i) beside fit(i - 1) on a second CUDA stream (ab_overlap.py);
- `batch`: forward + fit at several batch sizes in one process
  (ab_batch.py);
- `batch_joints`: the per-joint loop against `batch_joints=True`
  (ab_batch_joints.py).
"""
