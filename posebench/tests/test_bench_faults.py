"""A run with the timed path broken underneath comes out not correct:
the rest of a run, at tiny widths on the CPU (no look for a card), with
each fault a cell can have planted in the program it drives, held to the
cell's committed limits."""

import time

import numpy as np
import pytest
import torch

from posebench import harness, served
from posebench.drivers import train_fused
from posebench.tests.tiny_cells import serve_b64, train_b32


def run(cell):
    return harness.load_driver(cell.driver).run(
        cell, seed=21, seconds=0.2, trace=False,
        t_start=time.perf_counter(), device="cpu")


def failed(outcome):
    return [c.name for c in outcome.checks if not c.ok]


class HalfServed:
    """Answers the first half of each batch and copies those answers to
    the rest: half of the batch left out."""

    def __init__(self, predictor):
        self.p = predictor

    def __call__(self, clouds, draws=None):
        half = len(clouds) // 2
        clouds = np.concatenate([clouds[:half], clouds[:len(clouds) - half]])
        return self.p(clouds, draws=draws)


class OneCloudWrong:
    """The batch's first cloud answered as if it were the second: one
    wrong cloud, heads and poses, in the batch."""

    def __init__(self, predictor):
        self.p = predictor

    def __call__(self, clouds, draws=None):
        clouds = clouds.copy()
        clouds[0] = clouds[1]
        return self.p(clouds, draws=draws)


class PointsWrong:
    """A fifth of the points of every cloud answered with the heads of
    the same points of the next cloud."""

    def __init__(self, predictor):
        self.p = predictor

    def __call__(self, clouds, draws=None):
        res = self.p(clouds, draws=draws)
        for v in res.raw.values():
            v[:, ::5] = np.roll(v, 1, axis=0)[:, ::5]
        return res


class AlteredAnswer:
    """One part pose of one cloud altered where it is produced."""

    def __init__(self, predictor):
        self.p = predictor

    def __call__(self, clouds, draws=None):
        res = self.p(clouds, draws=draws)
        res.R[0, 1] = -res.R[0, 1]
        return res


def test_sound_serve_run_is_correct():
    assert failed(run(serve_b64())) == []


@pytest.mark.parametrize("fault,caught,batch", [
    (HalfServed, "heads_ratio", 2), (AlteredAnswer, "fit_gap", 2),
    (OneCloudWrong, "heads_ratio", 64), (PointsWrong, "heads_ratio", 8)])
def test_broken_serve_run_is_not_correct(monkeypatch, fault, caught, batch):
    real = served.program
    monkeypatch.setattr(served, "program",
                        lambda *a, **k: fault(real(*a, **k)))
    assert caught in failed(run(serve_b64(batch=batch)))


def test_sound_train_run_is_correct():
    assert failed(run(train_b32())) == []


def test_train_step_that_leaves_its_state_unchanged(monkeypatch):
    real = train_fused.program

    def program(*a, **k):
        state, fused, dg = real(*a, **k)

        def unchanged(st, step):
            keep = [t.clone() for t in st.params + st.opt.mu + st.opt.nu]
            metrics = fused(st, step)
            with torch.no_grad():
                for t, k_ in zip(st.params + st.opt.mu + st.opt.nu, keep):
                    t.copy_(k_)
            return metrics
        return state, unchanged, dg

    monkeypatch.setattr(train_fused, "program", program)
    out = run(train_b32())
    assert {"grad_gap", "update_gap"} <= set(failed(out))
    assert dict((c.name, c.value) for c in out.checks)["update_gap"] == \
        pytest.approx(1.0)


def test_train_step_on_half_the_batch(monkeypatch):
    from articulated_pose_tpu_torch.data.device_synthetic import \
        make_fused_synthetic_train_step
    real = train_fused.program

    def program(config, seed, sd, device):
        state, _, dg = real(config, seed, sd, device)
        half = make_fused_synthetic_train_step(
            state.config, dg, state.config.batch_size // 2, steps_per_call=1,
            seed=train_fused.seeds(seed)["data"])
        return state, half, dg

    monkeypatch.setattr(train_fused, "program", program)
    assert "loss_gap" in failed(run(train_b32(batch_size=4)))


def _stale_batches(fused):
    """The window's steps all draw step 3's batch and masks: a reseed
    that stops taking effect."""
    def step_fn(st, step):
        return fused(st, min(step, train_fused.CHECKED_STEPS))
    return step_fn


def _nan_loss(fused):
    """A window step whose loss reads NaN."""
    def step_fn(st, step):
        metrics = fused(st, step)
        if step > train_fused.CHECKED_STEPS:
            metrics = dict(metrics, total_loss=torch.tensor(float("nan")))
        return metrics
    return step_fn


@pytest.mark.parametrize("fault", [_stale_batches, _nan_loss])
def test_train_window_that_goes_wrong_after_set_up(monkeypatch, fault):
    real = train_fused.program

    def program(*a, **k):
        state, fused, dg = real(*a, **k)
        return state, fault(fused), dg

    monkeypatch.setattr(train_fused, "program", program)
    assert failed(run(train_b32())) == ["late_loss_gap"]
