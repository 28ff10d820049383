"""Training loop with checkpoints, validation and metrics: counterpart of
`articulated_pose_tpu/train/trainer.py`.

Per-step metrics to a JSONL file, validation every `val_interval` steps,
a snapshot every `snapshot_interval` steps keeping the newest three, and
resume from the newest.  Checkpoints are `torch.save` files of
`TrainState.state_dict()` under `<work_dir>/model/`; the model's part of
one is what `PosePredictor(work_dir=...)` serves.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Callable, Dict, Iterable, List, Optional

import torch

from articulated_pose_tpu_torch.config import NetworkConfig
from articulated_pose_tpu_torch.data.batcher import device_prefetch
from articulated_pose_tpu_torch.train.state import (TrainState,
                                                    dropout_generator,
                                                    make_eval_step,
                                                    make_train_step)

CKPT_NAME = re.compile(r"ckpt_(\d+)\.pt")


class MetricLogger:
    """JSONL metrics stream, one {"step": ..., name: value} line a call
    (trainer.py:31-50)."""

    def __init__(self, log_dir: str, name: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self._f = open(self.path, "a")

    def log(self, step: int, metrics: Dict):
        rec = {"step": int(step)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                pass
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def checkpoint_steps(model_dir: str) -> List[int]:
    """The steps of the checkpoints in `model_dir`, ascending ([] when
    there is none or no directory)."""
    if not os.path.isdir(model_dir):
        return []
    return sorted(int(m.group(1)) for m in map(CKPT_NAME.fullmatch,
                                               os.listdir(model_dir)) if m)


def checkpoint_path(model_dir: str, step: int) -> str:
    return os.path.join(model_dir, f"ckpt_{step}.pt")


class Checkpointer:
    """`torch.save` snapshots keeping the newest `n_keep` (the reference's
    Saver(max_to_keep=3), trainer.py:53-103).  A snapshot is written to
    a temporary file and renamed over its name, so a crash mid-write
    leaves the older ones whole."""

    def __init__(self, model_dir: str, n_keep: int = 3):
        self.model_dir = os.path.abspath(model_dir)
        self.n_keep = n_keep
        os.makedirs(self.model_dir, exist_ok=True)

    def save(self, step: int, state: TrainState):
        payload = _to_cpu(state.state_dict())
        path = checkpoint_path(self.model_dir, step)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in checkpoint_steps(self.model_dir)[:-self.n_keep]:
            os.remove(checkpoint_path(self.model_dir, old))

    def latest_step(self) -> Optional[int]:
        steps = checkpoint_steps(self.model_dir)
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> TrainState:
        """Load snapshot `step` (the newest by default) into `state`; with
        none, `state` is returned as it is."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return state
        payload = torch.load(checkpoint_path(self.model_dir, step),
                             map_location=state.device, weights_only=True)
        return state.load_state_dict(payload)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


class Trainer:
    """Drives train and validation steps on one device.

    `train_data` / `val_datas` are reusable iterables of batched numpy
    dicts (e.g. `data.batcher.BatchIterator`).  It trains on the card
    unless `device` names another one; without a card the default
    raises rather than training on the CPU.  Its train and eval steps
    are `make_train_step` / `make_eval_step`'s, captured on the card
    (trainer.py:124-125).
    """

    def __init__(self, model: torch.nn.Module, config: NetworkConfig,
                 work_dir: Optional[str] = None, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Trainer: device {device} is not available; "
                               "pass device='cpu' to train on the CPU")
        self.config = config
        self.device = device
        self.model = model.to(device)
        self.work_dir = work_dir or os.path.join(config.experiment_dir,
                                                 config.nn_name)
        self.state = TrainState(self.model, config)
        self.train_step = make_train_step(config)
        self.eval_step = make_eval_step(config)
        self.generator = torch.Generator(device=device)
        self.ckpt = Checkpointer(os.path.join(self.work_dir, "model"))
        self.logger = MetricLogger(os.path.join(self.work_dir, "log"), "train")
        self.val_loggers: Dict[int, MetricLogger] = {}

    def maybe_restore(self) -> int:
        self.state = self.ckpt.restore(self.state)
        return int(self.state.step)

    def fit(self, train_data: Iterable, val_datas: Iterable = (),
            n_epochs: Optional[int] = None, max_steps: Optional[int] = None,
            log_every: int = 50,
            on_validation: Optional[Callable] = None) -> Dict[str, float]:
        """Train until `n_epochs` (config.n_epochs by default) or
        `max_steps`; returns the last logged metrics and `elapsed_s`.
        The host reads the device only on the steps it logs, validates
        or snapshots (trainer.py:139-179)."""
        cfg = self.config
        n_epochs = n_epochs if n_epochs is not None else cfg.n_epochs
        start = time.time()
        last_metrics: Dict[str, float] = {}
        step = int(self.state.step)
        saved = None

        def finish():
            if saved != step:
                self.ckpt.save(step, self.state)
            last_metrics["elapsed_s"] = time.time() - start
            return last_metrics

        for _ in range(n_epochs):
            for batch in device_prefetch(train_data, size=2,
                                         device=self.device):
                dropout_generator(self.generator, cfg.seed, step)
                metrics = self.train_step(self.state, batch, self.generator)
                step += 1
                if step % log_every == 0 or step == 1:
                    last_metrics = {k: float(v) for k, v in metrics.items()}
                    self.logger.log(step, last_metrics)
                if cfg.val_interval and step % cfg.val_interval == 0:
                    for i, vd in enumerate(val_datas):
                        vm = self.validate(vd)
                        self.val_loggers.setdefault(
                            i, MetricLogger(os.path.join(self.work_dir, "log"),
                                            f"val{i + 1}")).log(step, vm)
                        if on_validation:
                            on_validation(i, step, vm)
                if cfg.snapshot_interval and step % cfg.snapshot_interval == 0:
                    self.ckpt.save(step, self.state)
                    saved = step
                if max_steps is not None and step >= max_steps:
                    return finish()
        return finish()

    def validate(self, val_data: Iterable,
                 save_predictions: bool = False) -> Dict[str, float]:
        """Metrics averaged over a validation set's frames, each batch
        weighted by its size (trainer.py:181-212).  With
        `save_predictions`, one prediction h5 a frame (the reference
        schema, `utils/prediction_io.py`; named by the set's `basenames`
        where it has them) goes into val_pred/step<N>/, and only the
        newest `config.val_prediction_n_keep` step directories stay."""
        sums: Dict[str, torch.Tensor] = {}
        n = 0
        save_dir = None
        basenames = list(getattr(val_data, "basenames", []))
        if save_predictions:
            from articulated_pose_tpu_torch.utils.prediction_io import \
                save_batch_predictions

            save_dir = os.path.join(self.work_dir, "val_pred",
                                    f"step{int(self.state.step)}")
        for batch in device_prefetch(val_data, size=2, device=self.device):
            pred, metrics = self.eval_step(self.state, batch)
            bs = batch["P"].shape[0]
            if save_dir is not None:
                names = (basenames[n:n + bs] if len(basenames) >= n + bs
                         else [f"frame_{n + i}" for i in range(bs)])
                save_batch_predictions(_to_numpy(pred), _to_numpy(batch),
                                       names, save_dir)
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v * bs
            n += bs
        if save_dir is not None:
            self._gc_val_predictions()
        return {k: float(v) / max(n, 1) for k, v in sums.items()}

    def _gc_val_predictions(self):
        """Keep only the newest val_prediction_n_keep step directories
        (-1 keeps all; trainer.py:202-220)."""
        import shutil

        n_keep = self.config.val_prediction_n_keep
        root = os.path.join(self.work_dir, "val_pred")
        if n_keep == -1 or not os.path.isdir(root):
            return
        dirs = sorted((int(m.group(1)), d) for d in os.listdir(root)
                      if (m := re.fullmatch(r"step(\d+)", d))
                      and os.path.isdir(os.path.join(root, d)))
        for _, d in dirs[:-n_keep] if n_keep else dirs:
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)

    def predict(self, batch: Dict) -> Dict:
        """The eval-mode predictions of one batch, as numpy."""
        pred, _ = self.eval_step(self.state, batch)
        return _to_numpy(pred)


def _to_numpy(tensors: Dict[str, torch.Tensor]) -> Dict:
    return {k: v.cpu().numpy() for k, v in tensors.items()}
